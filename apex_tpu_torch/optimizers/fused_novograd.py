"""FusedNovoGrad — per-tensor second-moment norms.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (the semantics of
``apex.optimizers.FusedNovoGrad``): the second moment is a scalar per
tensor (the gradient's norm), with ``reg_inside_moment``,
``grad_averaging``, ``norm_type`` (0 = inf, 2 = L2) and ``init_zero``. It
has no multi-tensor kernel yet: per-parameter torch ops on the CPU and on
the card alike. The base class supplies master weights, the decay mask and
the ``grad_scale`` / ``found_inf`` flow.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, Mask

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = False,
                 amsgrad: bool = False, reg_inside_moment: bool = False,
                 norm_type: int = 2, init_zero: bool = False,
                 master_weights: bool = False,
                 weight_decay_mask: Mask = None):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant")
        if norm_type not in (0, 2):
            raise RuntimeError(f"FusedNovoGrad only supports l2/inf norm "
                               f"now, got {norm_type}")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=betas, eps=eps,
                                      weight_decay=weight_decay),
                         master_weights, weight_decay_mask)
        self.grad_averaging = grad_averaging
        self.reg_inside_moment = reg_inside_moment
        self.norm_type = norm_type
        self.init_zero = init_zero

    def _init_slots(self, p32):
        return {"exp_avg": torch.zeros_like(p32),
                "exp_avg_sq": torch.zeros((), dtype=torch.float32,
                                          device=p32.device)}

    def _update(self, g32, p32, slots, t, lr, wd, group):
        b1, b2 = group["betas"]
        bc1 = 1.0 - b1 ** t if group["bias_correction"] else 1.0
        bc2 = 1.0 - b2 ** t if group["bias_correction"] else 1.0
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0
        g = g32
        if wd != 0.0 and self.reg_inside_moment:
            g = g + wd * p32
        if self.norm_type == 2:
            gnorm = torch.sqrt(torch.sum(g * g))
            stat = gnorm * gnorm
        else:
            stat = torch.max(torch.abs(g))
        ema = b2 * slots["exp_avg_sq"] + (1.0 - b2) * stat
        # first step: v <- stat, unless init_zero keeps the EMA form
        v = ema if self.init_zero else torch.where(t == 1, stat, ema)
        vhat = v / bc2
        denom = (torch.sqrt(vhat) if self.norm_type == 2 else vhat) + \
            group["eps"]
        scaled = g / denom
        if wd != 0.0 and not self.reg_inside_moment:
            scaled = scaled + wd * p32
        m = b1 * slots["exp_avg"] + beta3 * scaled
        return p32 - lr * (m / bc1), {"exp_avg": m, "exp_avg_sq": v}
