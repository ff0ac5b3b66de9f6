"""Kernel-backed ops: a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor runs the plain PyTorch version
(:mod:`apex_tpu_torch.ops._support`)."""

from apex_tpu_torch.ops._support import LAUNCHES, reset_launches
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.conv_fused import conv1x1_bn_act, conv3x3_bn_act
from apex_tpu_torch.ops.cross_entropy import softmax_cross_entropy_loss
from apex_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    paged_pages_for,
)
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)
from apex_tpu_torch.ops.rope import (
    fused_rope,
    fused_rope_2d,
    fused_rope_cached,
    fused_rope_thd,
    rope_freqs,
)
from apex_tpu_torch.ops.ring_attention import ring_attention
from apex_tpu_torch.ops.softmax import (
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "fused_paged_decode_attention", "paged_pages_for",
           "fused_layer_norm", "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "fused_rope", "fused_rope_cached",
           "fused_rope_thd", "fused_rope_2d", "rope_freqs",
           "softmax_cross_entropy_loss",
           "scaled_softmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "conv1x1_bn_act",
           "conv3x3_bn_act", "ring_attention"]
