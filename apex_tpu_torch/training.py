"""Train-step builder for one device.

Counterpart of ``apex_tpu/training.py``'s ``make_train_step`` without the
mesh: the step runs the loss forward, the backward, and one optimizer
update, all on the device of the model's parameters. The returned loss is
the one computed before the update (as the JAX step returns it) and stays
on the device: reading it is the caller's host sync. A parameter the loss
does not reach (BERT's binary head under an LM-only loss) gets a zero
gradient, as ``jax.value_and_grad`` gives it, so the optimizer still
updates it (weight decay, LAMB's trust ratio). Data-parallel and sharded
steps (the JAX mesh and specs) come with the data-parallel slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable[[Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer
                    ) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``.

    Args:
      loss_fn: ``loss_fn(batch) -> scalar tensor`` over the parameters
        that ``optimizer`` updates (for a GPT,
        ``lambda b: model(b["tokens"], b["labels"])``).
      optimizer: e.g. :class:`~apex_tpu_torch.optimizers.FusedAdam`.
    """

    def step(batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    return step
