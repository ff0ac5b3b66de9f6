"""FusedSGD with momentum, dampening, nesterov and weight-decay variants.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (the semantics of
``apex.optimizers.FusedSGD``): the first step sets the momentum buffer to
the update direction ``d_p`` itself, ``wd_after_momentum`` adds the weight
decay after the momentum instead of before it, and the base class supplies
master weights and the ``grad_scale`` / ``found_inf`` flow. Whether a step
is the first is decided on the device (``torch.where`` on the step count),
never by reading the count on the host. On the card a list of parameters
is one ``multi_tensor_sgd`` kernel call
(:mod:`apex_tpu_torch.ops.multi_tensor`), which reads each tensor's own
step count.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import multi_tensor as mt
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
        new_p, buf = mt.sgd_update(
            g32, p32, slots.get("momentum_buffer"), t, lr, wd, self.momentum,
            self.dampening, self.nesterov, self.wd_after_momentum)
        return new_p, ({} if buf is None else {"momentum_buffer": buf})

    def _multi_tensor_update(self, group, params, wd, grad_scale, found_inf,
                             key):
        slots = ("momentum_buffer",) if self.momentum != 0.0 else ()
        grads, steps, bufs, masters = self._lists(params, *slots)
        mt.multi_tensor_sgd(
            grads, params, bufs[0] if bufs else None, steps, masters,
            lr=group["lr"], weight_decay=wd, momentum=self.momentum,
            dampening=self.dampening, nesterov=self.nesterov,
            wd_after_momentum=self.wd_after_momentum, grad_scale=grad_scale,
            found_inf=found_inf, cache=self._cache(key))
