"""Functional wrappers over the fused kernels (counterpart of
``apex_tpu.transformer.functional``): the fused scale + mask + softmax
dispatcher so far."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = ["FusedScaleMaskSoftmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax"]
