"""Dynamic loss scaling with its state on the device.

Counterpart of ``apex_tpu/amp/scaler.py`` (the semantics of apex's
``LossScaler`` and the hysteresis rule of its capturable path):

- an overflow consumes one hysteresis credit; when the credits are spent
  the scale is divided by ``scale_factor`` (floored at ``min_loss_scale``)
  and the growth tracker resets;
- ``scale_window`` finite steps in a row grow the scale by
  ``scale_factor`` (capped at ``max_loss_scale``) and refill the credits.

The state is 0-dim tensors on the device, and :meth:`LossScaler.update`
is torch ops on them: no step reads the host. :meth:`LossScaler.unscale`
unscales the gradients in place and reports the overflow as a device
bool: the ``multi_tensor_scale`` kernel on the card
(:mod:`apex_tpu_torch.ops.multi_tensor`), its plain version on the CPU.
:meth:`LossScaler.state_dict` is the only read on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.utils.tree import tree_leaves

__all__ = ["LossScaler", "LossScalerState", "all_finite"]


def all_finite(tree: Any) -> torch.Tensor:
    """Whether every element of every tensor of ``tree`` is finite, as a
    device bool."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


@dataclasses.dataclass
class LossScalerState:
    loss_scale: torch.Tensor          # f32 scalar
    growth_tracker: torch.Tensor      # i32 scalar — consecutive finite steps
    hysteresis_tracker: torch.Tensor  # i32 scalar — overflow credits left
    unskipped: torch.Tensor           # i32 scalar — steps since last skip


class LossScaler:
    """Static or dynamic loss scaler.

    ``LossScaler("dynamic")`` is the reference default (init 2**16, factor
    2, window 2000); ``LossScaler(128.0)`` a static scale. Each
    scaler keeps the pointer table of the gradients it unscales.
    """

    def __init__(self, loss_scale: Any = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24, hysteresis: int = 1):
        self.dynamic = loss_scale == "dynamic"
        self._init_scale = float(init_scale if self.dynamic else loss_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_loss_scale = (float(min_loss_scale)
                               if min_loss_scale is not None else 1.0)
        self.max_loss_scale = float(max_loss_scale)
        self.hysteresis = int(hysteresis)
        self._table = mt.TableCache()

    # -- state ------------------------------------------------------------
    def init(self, device=None) -> LossScalerState:
        """The initial state on ``device`` (the card unless asked for the
        CPU)."""
        dev = _support.resolve_device(device)
        return LossScalerState(
            loss_scale=torch.tensor(self._init_scale, dtype=torch.float32,
                                    device=dev),
            growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
            hysteresis_tracker=torch.tensor(self.hysteresis,
                                            dtype=torch.int32, device=dev),
            unskipped=torch.zeros((), dtype=torch.int32, device=dev))

    # -- per-step ops ------------------------------------------------------
    def scale(self, loss: torch.Tensor,
              state: LossScalerState) -> torch.Tensor:
        """``amp.scale_loss``: the loss in fp32 times the scale."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Any, state: LossScalerState
                ) -> Tuple[Any, torch.Tensor]:
        """Unscale every gradient of the tree ``grads`` in place and report
        an overflow: ``(grads, found_inf)``. A non-finite gradient element
        becomes 0, so the optimizer's math stays finite; the step is
        skipped through ``found_inf``. Tensors of bf16, fp16 or fp32."""
        leaves = tree_leaves(grads)
        found = mt.multi_tensor_scale(leaves, state.loss_scale,
                                      cache=self._table)
        return grads, found

    def update(self, state: LossScalerState,
               found_inf: torch.Tensor) -> LossScalerState:
        """The next state after a step whose overflow flag is
        ``found_inf``."""
        found = found_inf.to(torch.bool)
        zero = torch.zeros_like(state.unskipped)
        unskipped = torch.where(found, zero, state.unskipped + 1)
        if not self.dynamic:
            return LossScalerState(state.loss_scale, state.growth_tracker,
                                   state.hysteresis_tracker, unskipped)
        hyst = torch.where(found, state.hysteresis_tracker - 1,
                           state.hysteresis_tracker)
        do_backoff = found & (hyst <= 0)
        scale = torch.where(
            do_backoff,
            torch.clamp_min(state.loss_scale / self.scale_factor,
                            self.min_loss_scale),
            state.loss_scale)
        growth = torch.where(found, zero, state.growth_tracker + 1)
        do_growth = growth >= self.scale_window
        scale = torch.where(
            do_growth,
            torch.clamp_max(scale * self.scale_factor, self.max_loss_scale),
            scale)
        growth = torch.where(do_growth, zero, growth)
        hyst = torch.where(do_backoff | do_growth,
                           torch.full_like(hyst, self.hysteresis), hyst)
        return LossScalerState(scale, growth, hyst, unskipped)

    # -- persistence ---------------------------------------------------------
    def state_dict(self, state: LossScalerState) -> dict:
        return {"loss_scale": float(state.loss_scale),
                "growth_tracker": int(state.growth_tracker),
                "hysteresis_tracker": int(state.hysteresis_tracker),
                "unskipped": int(state.unskipped)}

    def load_state_dict(self, d: dict, device=None) -> LossScalerState:
        dev = _support.resolve_device(device)
        return LossScalerState(
            loss_scale=torch.tensor(d["loss_scale"], dtype=torch.float32,
                                    device=dev),
            growth_tracker=torch.tensor(d.get("growth_tracker", 0),
                                        dtype=torch.int32, device=dev),
            hysteresis_tracker=torch.tensor(
                d.get("hysteresis_tracker", self.hysteresis),
                dtype=torch.int32, device=dev),
            unskipped=torch.tensor(d.get("unskipped", 0), dtype=torch.int32,
                                   device=dev))
