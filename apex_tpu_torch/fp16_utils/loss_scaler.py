"""Legacy loss scalers (counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``): aliases of
:class:`apex_tpu_torch.amp.LossScaler`."""

from __future__ import annotations

from apex_tpu_torch.amp.scaler import LossScaler as _ModernScaler

__all__ = ["LossScaler", "DynamicLossScaler"]


class LossScaler(_ModernScaler):
    """A static scale."""

    def __init__(self, scale: float = 1.0):
        super().__init__(loss_scale=scale)


class DynamicLossScaler(_ModernScaler):
    """A dynamic scale (factor 2, window 1000)."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000):
        super().__init__("dynamic", init_scale=init_scale,
                         scale_factor=scale_factor, scale_window=scale_window)
