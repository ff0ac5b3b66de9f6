"""Fused optimizers (counterpart of ``apex_tpu.optimizers``): FusedAdam,
FusedAdamW, FusedLAMB, FusedMixedPrecisionLamb, FusedSGD, FusedNovoGrad
and FusedAdagrad. The ZeRO-sharded ``DistributedFusedAdam`` /
``DistributedFusedLAMB`` come with data parallelism."""

from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamW
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedOptimizer", "FusedAdam", "FusedAdamW", "FusedLAMB",
           "FusedMixedPrecisionLamb", "FusedSGD", "FusedNovoGrad",
           "FusedAdagrad"]
