"""Shared machinery for the fused optimizers.

Counterpart of ``apex_tpu/optimizers/base.py`` in the PyTorch idiom: a
:class:`torch.optim.Optimizer` whose ``step`` updates the parameters in
place, with the JAX package's step semantics. The update is plain PyTorch
(the JAX one is ``jnp`` tree math, no Pallas kernel):

- every update is fp32 math on fp32 copies of the grads and parameters;
- each parameter's state keeps an int32 step count on its device, and the
  bias correction reads it as fp32;
- ``master_weights=True`` keeps an fp32 copy of each parameter in its
  state and writes the parameter back in its own dtype (amp O2);
- ``grad_scale`` unscales the grads inside the step, and ``found_inf`` (a
  device tensor) turns the whole update into a no-op on the device — no
  host sync, as in the reference's capturable mode;
- ``weight_decay_mask`` (a callable ``param -> bool``) drops weight decay
  where it is False, as the JAX mask pytree does (torch's own idiom, a
  param group with ``weight_decay=0``, works too). The rate is each
  group's ``lr``, which a scheduler sets;
- :meth:`FusedOptimizer._begin_step` sees every parameter and its fp32
  (unscaled) gradient once before the per-parameter updates, for what the
  JAX ``_update`` computes over the whole gradient tree (LAMB's global
  norm). The step holds those fp32 gradients together: for fp32 grads
  without ``grad_scale`` they are the grads themselves, otherwise one fp32
  copy each.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["FusedOptimizer"]

Mask = Optional[Callable[[torch.Tensor], bool]]


class FusedOptimizer(torch.optim.Optimizer):
    """Base: subclasses implement :meth:`_init_slots` and :meth:`_update`
    over fp32 tensors."""

    def __init__(self, params, defaults: Dict[str, Any],
                 master_weights: bool = False,
                 weight_decay_mask: Mask = None):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.weight_decay_mask = weight_decay_mask

    # -- subclass API -----------------------------------------------------
    def _init_slots(self, p32: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _update(self, g32: torch.Tensor, p32: torch.Tensor,
                slots: Dict[str, torch.Tensor], t: torch.Tensor, lr,
                wd: float, group: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(new fp32 param, new slots)`` for one parameter at step ``t``
        (fp32, counted from 1)."""
        raise NotImplementedError

    def _begin_step(self, todo: List[Tuple[Dict[str, Any], torch.Tensor,
                                           torch.Tensor]]) -> None:
        """Called once a step, before the first :meth:`_update`, with
        ``(param group, parameter, fp32 unscaled gradient)`` for every
        parameter that has a gradient."""

    # -- helpers ----------------------------------------------------------
    def _decay(self, group: Dict[str, Any], p: torch.Tensor) -> float:
        wd = group.get("weight_decay", 0.0)
        mask = self.weight_decay_mask
        if mask is None or wd == 0.0:
            return wd
        return wd if mask(p) else 0.0

    def _state(self, p: torch.Tensor) -> Dict[str, Any]:
        st = self.state[p]
        if not st:
            p32 = p.detach().float()
            st["step"] = torch.zeros((), dtype=torch.int32, device=p.device)
            st.update(self._init_slots(p32))
            if self.master_weights:
                # a distinct buffer even when p is already fp32
                st["master"] = p32.clone()
        return st

    # -- public API -------------------------------------------------------
    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *,
             grad_scale: Optional[torch.Tensor] = None,
             found_inf: Optional[torch.Tensor] = None):
        """One update of every parameter that has a grad."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        skip = None if found_inf is None else found_inf.to(torch.bool)
        todo = []
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g32 = p.grad.float()
                if grad_scale is not None:
                    g32 = g32 * (1.0 / grad_scale)
                todo.append((group, p, g32))
        self._begin_step(todo)
        for group, p, g32 in todo:
            st = self._state(p)
            step = st["step"] + 1
            p32 = st["master"] if self.master_weights else p.float()
            slot_names = [k for k in st if k not in ("step", "master")]
            slots = {k: st[k] for k in slot_names}
            new_p, new_slots = self._update(
                g32, p32, slots, step.float(), group["lr"],
                self._decay(group, p), group)
            if skip is not None:
                new_p = torch.where(skip, p32, new_p)
                new_slots = {k: torch.where(skip, slots[k], v)
                             for k, v in new_slots.items()}
                step = torch.where(skip, st["step"], step)
            for k, v in new_slots.items():
                st[k].copy_(v)
            st["step"].copy_(step)
            if self.master_weights:
                st["master"].copy_(new_p)
            p.copy_(new_p.to(p.dtype))
        return loss
