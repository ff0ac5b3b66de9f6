"""Models (counterpart of ``apex_tpu.models``): the GPT serving path."""

from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
)

__all__ = ["GPTModel", "TransformerConfig", "ParallelAttention",
           "ParallelMLP", "ParallelTransformer", "ParallelTransformerLayer"]
