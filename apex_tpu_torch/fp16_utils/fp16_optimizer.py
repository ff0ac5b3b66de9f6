"""The legacy ``FP16_Optimizer`` wrapper.

Counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py`` in apex's torch
form: it takes an optimizer built over the model's (half) parameters,
gives it fp32 master copies to update instead, and keeps a loss scaler
whose state stays on the device. A step copies the model's grads to the
masters in fp32, unscales them, runs the inner step with ``found_inf``
(a no-op on overflow, decided on the device), advances the scaler, and
copies the masters back into the model's dtype:

    opt = FP16_Optimizer(FusedSGD(model.parameters(), lr=0.1),
                         dynamic_loss_scale=True)
    opt.scale_loss(loss).backward()
    opt.step()
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from apex_tpu_torch.amp.scaler import LossScaler

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    def __init__(self, init_optimizer: torch.optim.Optimizer,
                 static_loss_scale: Any = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None):
        self.optimizer = init_optimizer
        self.model_params: List[torch.Tensor] = []
        self.master_params: List[torch.Tensor] = []
        for group in init_optimizer.param_groups:
            masters = [p.detach().to(torch.float32, copy=True)
                       .requires_grad_(p.requires_grad)
                       for p in group["params"]]
            self.model_params.extend(group["params"])
            self.master_params.extend(masters)
            group["params"] = masters
        if dynamic_loss_scale:
            self.scaler = LossScaler("dynamic", **(dynamic_loss_args or {}))
        else:
            self.scaler = LossScaler(static_loss_scale)
        device = (self.model_params[0].device if self.model_params
                  else None)
        self.scaler_state = self.scaler.init(device)

    @property
    def loss_scale(self) -> torch.Tensor:
        return self.scaler_state.loss_scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.scaler.scale(loss, self.scaler_state)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.model_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One step from the model's (scaled) grads; returns
        ``found_inf``."""
        for m, p in zip(self.master_params, self.model_params):
            m.grad = (None if p.grad is None
                      else p.grad.detach().to(torch.float32, copy=True))
        grads = [m.grad for m in self.master_params if m.grad is not None]
        _, found_inf = self.scaler.unscale(grads, self.scaler_state)
        self.optimizer.step(found_inf=found_inf)
        self.scaler_state = self.scaler.update(self.scaler_state, found_inf)
        for m, p in zip(self.master_params, self.model_params):
            p.copy_(m)
        return found_inf
