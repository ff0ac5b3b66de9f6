"""Fused optimizers (counterpart of ``apex_tpu.optimizers``): FusedAdam
and FusedAdamW so far."""

from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW

__all__ = ["FusedOptimizer", "FusedAdam", "FusedAdamW"]
