"""Fused normalization modules over :mod:`apex_tpu_torch.ops.layer_norm`.

Counterparts of ``apex_tpu/normalization/fused_layer_norm.py``'s
``FusedLayerNorm`` and ``FusedRMSNorm`` (and the Megatron mixed-dtype
variants, whose output keeps the activation dtype). Parameters are named
``weight`` / ``bias`` as in the transformer's parameter tree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]

Shape = Union[int, Sequence[int]]


def _shape(s: Shape):
    return (s,) if isinstance(s, int) else tuple(s)


class FusedLayerNorm(nn.Module):
    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *,
                 params_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.normalized_shape = _shape(normalized_shape)
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=params_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=params_dtype, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``out_dtype=None`` keeps promote semantics (bf16 x with fp32
        params gives fp32)."""
        if self.weight is None:
            return fused_layer_norm(x, self.normalized_shape, self.eps,
                                    out_dtype=out_dtype)
        return fused_layer_norm_affine(x, self.weight, self.bias,
                                       self.normalized_shape, self.eps,
                                       out_dtype=out_dtype)


class FusedRMSNorm(nn.Module):
    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *,
                 params_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.normalized_shape = _shape(normalized_shape)
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(
            self.normalized_shape, dtype=params_dtype, device=device))
            if elementwise_affine else None)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.weight is None:
            return fused_rms_norm(x, self.normalized_shape, self.eps,
                                  out_dtype=out_dtype)
        return fused_rms_norm_affine(x, self.weight, self.normalized_shape,
                                     self.eps, out_dtype=out_dtype)


class MixedFusedLayerNorm(FusedLayerNorm):
    """fp32 params with half activations; output in the activation dtype."""

    def forward(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        return super().forward(x, out_dtype=x.dtype)


class MixedFusedRMSNorm(FusedRMSNorm):
    def forward(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        return super().forward(x, out_dtype=x.dtype)
