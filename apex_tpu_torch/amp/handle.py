"""The loss-scaling flow.

Counterpart of ``apex_tpu/amp/handle.py``. apex's ``with
amp.scale_loss(loss, optimizer)`` scales, backprops, unscales, checks the
overflow and patches ``optimizer.step`` into a no-op on overflow. The
port's flow, with every value on the device:

    loss = model(batch)
    amp.scale_loss(loss, state).backward()
    grads, found_inf = scaler.unscale([p.grad for p in params], state)
    optimizer.step(found_inf=found_inf)          # a no-op on overflow
    state = scaler.update(state, found_inf)

or ``unscale_and_update`` for the middle and last lines, and
``apply_if_finite`` for a step written as a function of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.utils.tree import tree_map

__all__ = ["scale_loss", "unscale_and_update", "apply_if_finite"]


def scale_loss(loss: torch.Tensor,
               scaler_state: LossScalerState) -> torch.Tensor:
    return loss.float() * scaler_state.loss_scale


def unscale_and_update(grads: Any, scaler: LossScaler,
                       scaler_state: LossScalerState
                       ) -> Tuple[Any, torch.Tensor, LossScalerState]:
    """Unscale the grads in place, detect the overflow, and advance the
    scaler's state."""
    grads, found_inf = scaler.unscale(grads, scaler_state)
    return grads, found_inf, scaler.update(scaler_state, found_inf)


def apply_if_finite(found_inf: torch.Tensor, step_fn: Callable,
                    *trees: Any) -> Any:
    """``step_fn(*trees)``, kept only where the grads were finite: each
    tensor of the result is selected on the device against the input's
    (apex's patched ``optimizer.step``, with no host sync)."""
    new_trees = step_fn(*trees)
    skip = found_inf.to(torch.bool)

    def select(new, old):
        return tree_map(lambda n, o: torch.where(skip, o, n), new, old)

    if len(trees) == 1:
        return select(new_trees, trees[0])
    return tuple(select(n, o) for n, o in zip(new_trees, trees))
