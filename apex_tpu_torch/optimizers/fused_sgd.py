"""FusedSGD with momentum, dampening, nesterov and weight-decay variants.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (the semantics of
``apex.optimizers.FusedSGD``): the first step sets the momentum buffer to
the update direction ``d_p`` itself, ``wd_after_momentum`` adds the weight
decay after the momentum instead of before it, and the base class supplies
master weights and the ``grad_scale`` / ``found_inf`` flow. Whether a step
is the first is decided on the device (``torch.where`` on the step count),
never by reading the count on the host.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, Mask

__all__ = ["FusedSGD"]


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 master_weights: bool = False, weight_decay_mask: Mask = None):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay),
                         master_weights, weight_decay_mask)
        self.momentum = momentum
        self.dampening = dampening
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def _init_slots(self, p32):
        if self.momentum == 0.0:
            return {}
        return {"momentum_buffer": torch.zeros_like(p32)}

    def _update(self, g32, p32, slots, t, lr, wd, group):
        mom = self.momentum
        d_p = g32
        if wd != 0.0 and not self.wd_after_momentum:
            d_p = d_p + wd * p32
        new_slots = {}
        if mom != 0.0:
            buf = torch.where(t == 1, d_p, mom * slots["momentum_buffer"]
                              + (1.0 - self.dampening) * d_p)
            d_p = d_p + mom * buf if self.nesterov else buf
            new_slots["momentum_buffer"] = buf
        if wd != 0.0 and self.wd_after_momentum:
            d_p = d_p + wd * p32
        return p32 - lr * d_p, new_slots
