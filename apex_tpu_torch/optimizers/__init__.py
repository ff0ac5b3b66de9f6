"""Fused optimizers (counterpart of ``apex_tpu.optimizers``): FusedAdam,
FusedAdamW, FusedLAMB and FusedSGD so far."""

from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedOptimizer", "FusedAdam", "FusedAdamW", "FusedLAMB",
           "FusedSGD"]
