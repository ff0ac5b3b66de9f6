"""Rotary position embedding wrappers under the reference's public names
(counterpart of ``apex_tpu/transformer/functional/fused_rope.py``)."""

from apex_tpu_torch.ops.rope import (
    fused_rope,
    fused_rope_2d,
    fused_rope_cached,
    fused_rope_thd,
)

__all__ = [
    "fused_apply_rotary_pos_emb",
    "fused_apply_rotary_pos_emb_cached",
    "fused_apply_rotary_pos_emb_thd",
    "fused_apply_rotary_pos_emb_2d",
]

fused_apply_rotary_pos_emb = fused_rope
fused_apply_rotary_pos_emb_cached = fused_rope_cached
fused_apply_rotary_pos_emb_thd = fused_rope_thd
fused_apply_rotary_pos_emb_2d = fused_rope_2d
