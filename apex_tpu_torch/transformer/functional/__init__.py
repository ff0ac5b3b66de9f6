"""Functional wrappers over the fused kernels (counterpart of
``apex_tpu.transformer.functional``): the fused scale + mask + softmax
dispatcher and the rotary embedding wrappers."""

from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = ["FusedScaleMaskSoftmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd", "fused_apply_rotary_pos_emb_2d"]
