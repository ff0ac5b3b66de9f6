"""Shared machinery for the fused optimizers.

Counterpart of ``apex_tpu/optimizers/base.py`` in the PyTorch idiom: a
:class:`torch.optim.Optimizer` whose ``step`` updates the parameters in
place, with the JAX package's step semantics:

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
  group's ``lr``, which a scheduler sets (a number, or a 0-dim tensor on
  the parameters' device).

Parameters on the CPU take the plain version, one parameter at a time:
the subclass's :meth:`FusedOptimizer._update` (the JAX update is ``jnp``
tree math, no Pallas kernel). :meth:`FusedOptimizer._begin_step` sees
every parameter and its fp32 (unscaled) gradient once before the
per-parameter updates, for what the JAX ``_update`` computes over the
whole gradient tree (LAMB's global norm).

Parameters on a CUDA device go to the multi-tensor kernels
(:mod:`apex_tpu_torch.ops.multi_tensor`) where the subclass has them
(:meth:`FusedOptimizer._multi_tensor_update`): each param group's
parameters with a grad are gathered into lists keyed by parameter dtype,
grad dtype and decay or not, and each list is one kernel call over a
table of pointers kept per list. Subclasses without kernels (NovoGrad,
Adagrad) run the per-parameter torch ops on the card too. The state is the
same on both devices: per parameter, ``step``, the slots and ``master``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["FusedOptimizer"]

Mask = Optional[Callable[[torch.Tensor], bool]]


class FusedOptimizer(torch.optim.Optimizer):
    """Base: subclasses implement :meth:`_init_slots` and :meth:`_update`
    over fp32 tensors, and may implement :meth:`_multi_tensor_update`."""

    def __init__(self, params, defaults: Dict[str, Any],
                 master_weights: bool = False,
                 weight_decay_mask: Mask = None):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.weight_decay_mask = weight_decay_mask
        #: a table cache per kernel list (see :meth:`_step_multi_tensor`)
        self._tables: Dict[Any, mt.TableCache] = {}

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

    #: ``_multi_tensor_update(group, params, wd, grad_scale, found_inf,
    #: key)``: one kernel call over ``params`` (one list: a group, one
    #: parameter and grad dtype, one decay; ``key`` names it, for
    #: :meth:`_cache`), their state made; None where the subclass has no
    #: kernel
    _multi_tensor_update: Optional[Callable[..., None]] = None

    def _begin_multi_tensor(self, params: List[torch.Tensor],
                            grad_scale: Optional[torch.Tensor]) -> None:
        """The card's :meth:`_begin_step`, with every parameter that has a
        gradient (across groups)."""

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

    def _cache(self, key) -> mt.TableCache:
        """The pointer tables of the list ``key``, kept across steps."""
        return self._tables.setdefault(key, mt.TableCache())

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
        todo = [(gi, group, p) for gi, group in enumerate(self.param_groups)
                for p in group["params"] if p.grad is not None]
        if not todo:
            return loss
        if self._multi_tensor_update is None or _support.is_cpu(
                *(p for _, _, p in todo)):
            self._step_per_parameter(todo, grad_scale, found_inf)
        else:
            self._step_multi_tensor(todo, grad_scale, found_inf)
        return loss

    @torch.no_grad()
    def _step_per_parameter(self, todo, grad_scale, found_inf) -> None:
        """The plain version: the subclass's torch ops, a parameter at a
        time (``todo``: ``(group index, group, parameter)`` with a grad)."""
        skip = None if found_inf is None else found_inf.to(torch.bool)
        todo = [(group, p, mt.unscaled_fp32(p.grad, grad_scale))
                for _, group, p in todo]
        self._begin_step(todo)
        for group, p, g32 in todo:
            st = self._state(p)
            step = st["step"] + 1
            master = st["master"] if self.master_weights else None
            p32 = p.float() if master is None else master
            slots = {k: v for k, v in st.items() if k not in ("step",
                                                               "master")}
            new_p, new_slots = self._update(
                g32, p32, slots, step.float(), group["lr"],
                self._decay(group, p), group)
            mt.commit(p, p32, st["step"], step, master, slots, new_p,
                      new_slots, skip)

    def _step_multi_tensor(self, todo, grad_scale, found_inf) -> None:
        """The card: one kernel call a list."""
        lists: Dict[Any, Tuple[Dict[str, Any], float, list]] = {}
        for gi, group, p in todo:
            self._state(p)
            wd = self._decay(group, p)
            key = (gi, p.dtype, p.grad.dtype, wd != 0.0)
            lists.setdefault(key, (group, wd, []))[2].append(p)
        self._begin_multi_tensor([p for _, _, p in todo], grad_scale)
        for key, (group, wd, params) in lists.items():
            self._multi_tensor_update(group, params, wd, grad_scale,
                                      found_inf, key)

    def _lists(self, params: List[torch.Tensor], *slots: str):
        """``(grads, steps, [slot lists...], masters or None)`` of
        ``params``' state."""
        states = [self.state[p] for p in params]
        return ([p.grad for p in params], [st["step"] for st in states],
                [[st[k] for st in states] for k in slots],
                [st["master"] for st in states] if self.master_weights
                else None)
