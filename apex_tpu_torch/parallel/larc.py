"""LARC — Layer-wise Adaptive Rate Clipping/Scaling.

Counterpart of ``apex_tpu/parallel/larc.py`` (the semantics of
``apex.parallel.LARC``): it wraps an optimizer, and before the inner step
rescales each parameter's gradient by the local learning rate

    local_lr = trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)

as ``min(local_lr / lr, 1)`` with ``clip=True`` (clipping) or ``local_lr``
(scaling), 1 where either norm is 0. Weight decay is folded into the
adapted gradient (``g + wd * p`` before the scaling), so the inner
optimizer's groups step with ``weight_decay`` 0, restored afterwards even
when the step raises. ``lr`` and ``weight_decay`` are each group's. The
norms are fp32 (``multi_tensor_l2norm``'s per-tensor mode: the kernel on
the card), the rest torch ops; the gradients are rescaled in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["LARC"]


class LARC:
    def __init__(self, optimizer: torch.optim.Optimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.inner = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self._tables: Dict[Any, mt.TableCache] = {}

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _norms(self, key, tensors):
        cache = self._tables.setdefault(key, mt.TableCache())
        return mt.multi_tensor_l2norm(tensors, per_tensor=True,
                                      cache=cache)[1]

    @torch.no_grad()
    def _adapt(self) -> None:
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            wd, lr = group.get("weight_decay", 0.0), group["lr"]
            pn = self._norms(("p", gi), params)
            gn = self._norms(("g", gi), [p.grad for p in params])
            local_lr = self.trust_coefficient * pn / (gn + wd * pn + self.eps)
            ok = (pn > 0) & (gn > 0)
            if self.clip:
                scale = torch.where(ok, torch.clamp_max(local_lr / lr, 1.0),
                                    1.0)
            else:
                scale = torch.where(ok, local_lr, 1.0)
            for i, p in enumerate(params):
                g = p.grad
                g.copy_(((g.float() + wd * p.float()) * scale[i]).to(g.dtype))

    def step(self, closure=None, **kw):
        """Adapt every gradient, then the inner step with its groups'
        weight decay zeroed (``kw``: ``grad_scale``, ``found_inf``)."""
        self._adapt()
        saved = [g.get("weight_decay", 0.0) for g in self.param_groups]
        for g in self.param_groups:
            g["weight_decay"] = 0.0
        try:
            return self.inner.step(closure, **kw)
        finally:
            for g, wd in zip(self.param_groups, saved):
                g["weight_decay"] = wd
