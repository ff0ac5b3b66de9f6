"""FusedAdam / AdamW.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` (the hyperparameters
of ``apex.optimizers.FusedAdam``): ``adam_w_mode`` picks decoupled weight
decay (AdamW) or L2 added to the grad, ``bias_correction`` toggles the
``1 / (1 - beta ** t)`` factors, computed in fp32 from the step count.
The base class supplies master weights and the ``grad_scale`` /
``found_inf`` flow, which never syncs with the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
        b1, b2 = group["betas"]
        bc1 = 1.0 - b1 ** t if group["bias_correction"] else 1.0
        bc2 = 1.0 - b2 ** t if group["bias_correction"] else 1.0
        if not self.adam_w_mode and wd != 0.0:
            g32 = g32 + wd * p32
        m = b1 * slots["exp_avg"] + (1.0 - b1) * g32
        v = b2 * slots["exp_avg_sq"] + (1.0 - b2) * g32 * g32
        update = (m / bc1) / (torch.sqrt(v / bc2) + group["eps"])
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p32
        return p32 - lr * update, {"exp_avg": m, "exp_avg_sq": v}


def FusedAdamW(params, lr: float = 1e-3, **kw) -> FusedAdam:
    kw.setdefault("adam_w_mode", True)
    return FusedAdam(params, lr=lr, **kw)
