"""FusedAdagrad.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py`` (the semantics of
``apex.optimizers.FusedAdagrad``): ``h += g²; p -= lr * g / (sqrt(h) +
eps)``, with decoupled weight decay under ``adagrad_w_mode``. It has no
multi-tensor kernel yet: per-parameter torch ops on the CPU and on the
card alike.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, Mask

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 master_weights: bool = False, weight_decay_mask: Mask = None):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay),
                         master_weights, weight_decay_mask)
        self.adagrad_w_mode = adagrad_w_mode

    def _init_slots(self, p32):
        return {"sum": torch.zeros_like(p32)}

    def _update(self, g32, p32, slots, t, lr, wd, group):
        g = g32
        if not self.adagrad_w_mode and wd != 0.0:
            g = g + wd * p32
        h = slots["sum"] + g * g
        update = g / (torch.sqrt(h) + group["eps"])
        if self.adagrad_w_mode and wd != 0.0:
            update = update + wd * p32
        return p32 - lr * update, {"sum": h}
