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
``grad_scale`` / ``found_inf`` flow; none of it syncs with the host. On the
card phase 1 is one ``multi_tensor_l2norm`` over every gradient, and each
list of parameters one ``multi_tensor_lamb`` call (moments and update into
an fp32 buffer kept per list, the per-tensor norms of p and of the update,
then the trust-ratio step; :mod:`apex_tpu_torch.ops.multi_tensor`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
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
        self._gnorm = None
        #: the fp32 update buffers of each kernel list (by list key)
        self._updates = {}

    def _init_slots(self, p32):
        return {"exp_avg": torch.zeros_like(p32),
                "exp_avg_sq": torch.zeros_like(p32)}

    def _begin_step(self, todo):
        self._clip = 1.0
        if todo and self.max_grad_norm > 0.0:
            gnorm, _ = mt.l2norm_plain([g for _, _, g in todo])
            self._clip = mt.lamb_clip(gnorm, self.max_grad_norm)

    def _update(self, g32, p32, slots, t, lr, wd, group):
        new_p, m, v, _ = mt.lamb_update(
            g32, p32, slots["exp_avg"], slots["exp_avg_sq"], t, lr, wd,
            self._clip, group["betas"], group["eps"], self.adam_w_mode,
            group["bias_correction"], self.grad_averaging,
            wd != 0.0 or self.always_adapt, self.trust_clip)
        return new_p, {"exp_avg": m, "exp_avg_sq": v}

    def _begin_multi_tensor(self, params, grad_scale):
        self._gnorm = None
        if self.max_grad_norm > 0.0:
            self._gnorm, _ = mt.multi_tensor_l2norm(
                [p.grad for p in params], grad_scale=grad_scale,
                cache=self._cache("grads"))

    def _multi_tensor_update(self, group, params, wd, grad_scale, found_inf,
                             key):
        grads, steps, (m, v), masters = self._lists(params, "exp_avg",
                                                    "exp_avg_sq")
        updates = self._updates.get(key)
        if updates is None or [u.shape for u in updates] != \
                [p.shape for p in params]:
            updates = [torch.empty_like(x) for x in m]
            self._updates[key] = updates
        mt.multi_tensor_lamb(
            grads, params, m, v, updates, steps, masters, lr=group["lr"],
            weight_decay=wd, betas=group["betas"], eps=group["eps"],
            adam_w_mode=self.adam_w_mode,
            bias_correction=group["bias_correction"],
            grad_averaging=self.grad_averaging, gnorm=self._gnorm,
            max_grad_norm=self.max_grad_norm, trust_clip=self.trust_clip,
            always_adapt=self.always_adapt, grad_scale=grad_scale,
            found_inf=found_inf, cache=self._cache(key))
