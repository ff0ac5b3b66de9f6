"""Tensor-parallel layers, the vocab-parallel loss, the model-parallel
random key and activation recompute at tensor-parallel size 1."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    checkpoint,
    model_parallel_rng_key,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "linear", "vocab_parallel_cross_entropy",
           "checkpoint", "model_parallel_rng_key"]
