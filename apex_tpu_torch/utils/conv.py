"""Shared NHWC convolution helpers for the vision models.

Counterpart of ``apex_tpu/utils/conv.py``: activations are NHWC and
weights HWIO, as in the JAX package. The convolution itself is cuDNN's
(``F.conv2d``), as the JAX package leaves it to XLA outside any Pallas
kernel: the input goes in as ``x.permute(0, 3, 1, 2)``, a channels-last
view of the NHWC tensor, and the result is permuted back, so no copy
changes the layout.

Every convolution and pool here pads as JAX's ``"SAME"``, the only
padding the models use. It is asymmetric: the output has ``ceil(in /
stride)`` positions and the ``total = max((out - 1) stride + k - in, 0)``
padding splits as ``total // 2`` before and the rest after (the 7x7/2 stem
on 224 pads (2, 3), a 3x3/2 on 56 pads (0, 1)). ``F.conv2d`` pads
symmetrically, so the padding is applied here with ``F.pad``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["conv_nhwc", "he_init", "same_pads", "max_pool_nhwc"]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of JAX's SAME for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    """Pads NHWC ``x`` as JAX's SAME does for a ``kh x kw`` window."""
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    if not any(ph) and not any(pw):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def conv_nhwc(x, w, stride: int = 1):
    """``x``: [N, H, W, Cin]; ``w``: [kh, kw, Cin, Cout] -> [N, H', W',
    Cout] in x's dtype, SAME-padded."""
    x = _pad_same(x, w.shape[0], w.shape[1], stride)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x, k: int, stride: int):
    """Max over ``k x k`` windows of NHWC ``x``, SAME-padded with ``-inf``
    (``lax.reduce_window(x, -inf, max, ..., "SAME")``)."""
    x = _pad_same(x, k, k, stride, value=-math.inf)
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def he_init(shape, generator: Optional[torch.Generator] = None,
            device=None):
    """Kaiming-normal for HWIO conv weights (fan_in = kh kw Cin), drawn on
    the CPU from ``generator`` (the same seed gives the same weights on any
    device)."""
    fan_in = shape[0] * shape[1] * shape[2]
    draw = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (draw * (2.0 / fan_in) ** 0.5).to(device=device)
