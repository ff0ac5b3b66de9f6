"""Fused optimizers (counterpart of ``apex_tpu.optimizers``): FusedAdam,
FusedAdamW and FusedLAMB so far."""

from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedOptimizer", "FusedAdam", "FusedAdamW", "FusedLAMB"]
