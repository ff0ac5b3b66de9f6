"""FusedLAMB — NVLAMB with global grad-norm pre-scaling.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py`` (the semantics of
``apex.optimizers.FusedLAMB``), plain PyTorch as the JAX update is ``jnp``
tree math:

- phase 1, once a step (:meth:`FusedLAMB._begin_step`): the global fp32 L2
  norm over every gradient, and the clip factor ``gnorm / max_grad_norm``
  where the norm exceeds ``max_grad_norm > 0`` (else 1), kept on the device;
- phase 2, per tensor: the Adam-style moments of the clipped gradient
  (``grad_averaging`` scales the new gradient by ``1 - beta1``), the
  decoupled (``adam_w_mode``) or L2 weight decay, and the trust-ratio step
  ``p -= lr * (||p|| / ||update||) * update``. The ratio applies only where
  the tensor's decay is non-zero or ``always_adapt`` is set, is 1 where
  either norm is 0, and is capped at 1 with ``trust_clip``.

A "tensor" of the trust ratio is one parameter, as in apex. The JAX
package stacks each transformer parameter over the layers into one
``[L, ...]`` leaf, so its ratio spans the stack: the two steps agree where
each stack holds one layer.

The base class supplies ``weight_decay_mask``, master weights and the
``grad_scale`` / ``found_inf`` flow; none of it syncs with the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.optimizers.base import FusedOptimizer, Mask

__all__ = ["FusedLAMB"]


class FusedLAMB(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, trust_clip: bool = False,
                 always_adapt: bool = False, master_weights: bool = False,
                 weight_decay_mask: Mask = None):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=betas, eps=eps,
                                      weight_decay=weight_decay),
                         master_weights, weight_decay_mask)
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.trust_clip = trust_clip
        self.always_adapt = always_adapt
        self._clip = 1.0

    def _init_slots(self, p32):
        return {"exp_avg": torch.zeros_like(p32),
                "exp_avg_sq": torch.zeros_like(p32)}

    def _begin_step(self, todo):
        self._clip = 1.0
        if todo and self.max_grad_norm > 0.0:
            gnorm = torch.stack([g.square().sum()
                                 for _, _, g in todo]).sum().sqrt()
            self._clip = torch.where(gnorm > self.max_grad_norm,
                                     gnorm / self.max_grad_norm,
                                     torch.ones_like(gnorm))

    def _update(self, g32, p32, slots, t, lr, wd, group):
        b1, b2 = group["betas"]
        bc1 = 1.0 - b1 ** t if group["bias_correction"] else 1.0
        bc2 = 1.0 - b2 ** t if group["bias_correction"] else 1.0
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0
        g = g32 / self._clip
        if not self.adam_w_mode and wd != 0.0:
            g = g + wd * p32
        m = b1 * slots["exp_avg"] + beta3 * g
        v = b2 * slots["exp_avg_sq"] + (1.0 - b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + group["eps"])
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p32
        ratio = 1.0
        if wd != 0.0 or self.always_adapt:
            w_norm = torch.sqrt(torch.sum(p32 * p32))
            u_norm = torch.sqrt(torch.sum(update * update))
            ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                                torch.ones_like(w_norm))
            if self.trust_clip:
                ratio = torch.clamp_max(ratio, 1.0)
        return p32 - lr * ratio * update, {"exp_avg": m, "exp_avg_sq": v}
