"""FusedAdam / AdamW.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` (the hyperparameters
of ``apex.optimizers.FusedAdam``): ``adam_w_mode`` picks decoupled weight
decay (AdamW) or L2 added to the grad, ``bias_correction`` toggles the
``1 / (1 - beta ** t)`` factors, computed in fp32 from the step count.
The base class supplies master weights and the ``grad_scale`` /
``found_inf`` flow, which never syncs with the host. On the card a list of
parameters is one ``multi_tensor_adam`` kernel call
(:mod:`apex_tpu_torch.ops.multi_tensor`); on the CPU each parameter runs
:func:`~apex_tpu_torch.ops.multi_tensor.adam_update`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers.base import FusedOptimizer, Mask

__all__ = ["FusedAdam", "FusedAdamW"]


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, master_weights: bool = False,
                 weight_decay_mask: Mask = None):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=betas, eps=eps,
                                      weight_decay=weight_decay),
                         master_weights, weight_decay_mask)
        self.adam_w_mode = adam_w_mode

    def _init_slots(self, p32):
        return {"exp_avg": torch.zeros_like(p32),
                "exp_avg_sq": torch.zeros_like(p32)}

    def _update(self, g32, p32, slots, t, lr, wd, group):
        new_p, m, v = mt.adam_update(
            g32, p32, slots["exp_avg"], slots["exp_avg_sq"], t, lr, wd,
            group["betas"], group["eps"], self.adam_w_mode,
            group["bias_correction"])
        return new_p, {"exp_avg": m, "exp_avg_sq": v}

    def _multi_tensor_update(self, group, params, wd, grad_scale, found_inf,
                             key):
        grads, steps, (m, v), masters = self._lists(params, "exp_avg",
                                                    "exp_avg_sq")
        mt.multi_tensor_adam(
            grads, params, m, v, steps, masters, lr=group["lr"],
            weight_decay=wd, betas=group["betas"], eps=group["eps"],
            adam_w_mode=self.adam_w_mode,
            bias_correction=group["bias_correction"], grad_scale=grad_scale,
            found_inf=found_inf, cache=self._cache(key))


def FusedAdamW(params, lr: float = 1e-3, **kw) -> FusedAdam:
    kw.setdefault("adam_w_mode", True)
    return FusedAdam(params, lr=lr, **kw)
