"""Fused softmax cross entropy at the reference's import path (counterpart
of ``apex_tpu/contrib/xentropy``): re-exports
:mod:`apex_tpu_torch.ops.cross_entropy`."""

from apex_tpu_torch.ops.cross_entropy import (
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]
