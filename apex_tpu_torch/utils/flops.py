"""Model FLOP counts and the card's peak rate for MFU (counterpart of
``apex_tpu/utils/flops.py``).

Two FLOPs per multiply-add, the convention of the peak rates they are
divided by (989 TFLOP/s bf16 on an H100 counts an FMA as two).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["peak_flops_per_chip", "transformer_train_flops",
           "resnet50_train_flops"]

#: dense bf16 peak FLOP/s by device name (NVIDIA data sheets, no
#: sparsity); MFU is model-FLOPs utilization against this number
_PEAK_FLOPS = {"H100": 989e12}


def peak_flops_per_chip(device: Union[str, torch.device, int, None] = None
                        ) -> Optional[float]:
    """bf16 peak FLOP/s of a card (default: the current one), or None
    where there is no card or its name is not in the table."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    elif torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


def transformer_train_flops(n_params: int, tokens: int, num_layers: int,
                            hidden: int, seq: int, causal: bool) -> float:
    """Model FLOPs for one training step over ``tokens`` tokens: the
    standard ``6N`` matmul term plus the attention score/value term
    ``12 * L * s * d`` per token (halved for causal masking)."""
    attn = 12 * num_layers * seq * hidden * (0.5 if causal else 1.0)
    return float(tokens) * (6.0 * n_params + attn)

#: torchvision's profile of ResNet-50 at 224 px: multiply-adds per image
_RN50_MACS_224 = 4.09e9


def resnet50_train_flops(images: int, image_size: int) -> float:
    """Model FLOPs of one ResNet-50 training step: 4.09 G multiply-adds a
    224 px image forward, scaled by area, two FLOPs each, and three
    passes (the backward costs two forwards): ``6 * 4.09e9`` an image.

    The JAX package's copy (``apex_tpu/utils/flops.py:53-56``) multiplies
    4.09e9 by 3: it reads torchvision's multiply-add count as FLOPs and so
    halves the MFU. The 1x1 and stride-1 3x3 convolutions alone make 1.86
    TFLOP of a 256-image forward at two FLOPs a multiply-add, above its
    1.05 T for the whole step's forward."""
    return images * 6.0 * _RN50_MACS_224 * (image_size / 224.0) ** 2
