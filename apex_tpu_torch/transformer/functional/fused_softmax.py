"""Fused scale + mask + softmax dispatcher.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``:
:class:`FusedScaleMaskSoftmax` picks the fused kernels
(:mod:`apex_tpu_torch.ops.softmax`, Kernels G and H on the card) or the
unfused plain PyTorch softmax with the same ``is_kernel_available``
predicate. The kernels take any row length and dtype the port supports, so
the predicate only routes the causal type with an explicit mask or
non-square scores to the unfused path, which applies causal AND the mask.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.softmax import (
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax", "scaled_softmax",
           "scaled_masked_softmax", "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax"]


class FusedScaleMaskSoftmax:
    """Fused operation: scaling + mask + softmax.

    Args:
      input_in_fp16 / input_in_bf16: declared input dtype; with
        ``softmax_in_fp32`` the unfused path upcasts and casts back.
      attn_mask_type: :class:`AttnMaskType` (padding or causal).
      scaled_masked_softmax_fusion: use the fused kernels (else the unfused
        plain softmax).
      mask_func: mask application for the unfused path,
        ``mask_func(scores, mask)``.
      softmax_in_fp32: compute the unfused softmax in fp32 (the fused
        kernels always do).
      scale: optional logit scale factor; requires ``softmax_in_fp32``.
    """

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active at "
                               "the same time.")
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def is_kernel_available(self, mask: Optional[torch.Tensor], b: int,
                            np_: int, sq: int, sk: int) -> bool:
        """The fused causal kernel takes no mask and needs square scores;
        everything else fuses when fusion is asked for."""
        if not self.scaled_masked_softmax_fusion:
            return False
        if self.attn_mask_type == AttnMaskType.causal and (
                sq != sk or mask is not None):
            return False
        return True

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expected scores (b, np, sq, sk), got "
                             f"{tuple(x.shape)}")
        b, np_, sq, sk = x.shape
        if self.is_kernel_available(mask, b, np_, sq, sk):
            return self.forward_fused_softmax(x, mask)
        return self.forward_torch_softmax(x, mask)

    def forward_fused_softmax(self, x: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            b, np_, sq, sk = x.shape
            out = scaled_upper_triang_masked_softmax(x.reshape(-1, sq, sk),
                                                     scale)
            return out.reshape(x.shape)
        return scaled_masked_softmax(x, mask, scale)

    def forward_torch_softmax(self, x: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The unfused path, plain PyTorch in the JAX package too: causal
        with the ``sk - sq`` offset and the mask both fill with -10000."""
        orig_dtype = x.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            x = x.float()
        if self.scale is not None:
            x = x * self.scale
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = x.shape[-2], x.shape[-1]
            causal = torch.ones((sq, sk), dtype=torch.bool,
                                device=x.device).tril(sk - sq)
            x = torch.where(causal, x, -10000.0)
        if mask is not None:
            x = (self.mask_func(x, mask) if self.mask_func is not None
                 else torch.where(mask, -10000.0, x))
        probs = torch.softmax(x, dim=-1)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig_dtype)
        return probs
