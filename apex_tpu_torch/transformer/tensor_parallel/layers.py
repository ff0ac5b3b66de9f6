"""Tensor-parallel layers at tensor-parallel size 1.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py``'s
``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` with the world size fixed at 1 (sharding comes
with a later slice). Weights are ``[out, in]`` as in the JAX package; the
products are plain ``torch.matmul`` in the activation dtype (XLA did them
outside any Pallas kernel), with the bias added after the product.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "linear"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in ``x``'s dtype (amp O2 rule: the weight
    is cast to the activation dtype) — the JAX package's
    ``linear_with_grad_accumulation_and_async_allreduce`` at tp=1."""
    out = torch.matmul(x, weight.t().to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 *, params_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.weight = nn.Parameter(torch.empty(
            (output_size, input_size), dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class ColumnParallelLinear(_Linear):
    """Linear with weight ``[out, in]``, split along ``out`` under tensor
    parallelism (tp=1 here)."""


class RowParallelLinear(_Linear):
    """Linear with weight ``[out, in]``, split along ``in`` under tensor
    parallelism (tp=1 here)."""


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``[vocab, hidden]`` (vocab-sharded under tensor
    parallelism; tp=1 here)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 params_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), dtype=params_dtype,
            device=device))

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.weight[token_ids]
