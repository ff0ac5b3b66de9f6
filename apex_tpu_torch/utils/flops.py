"""Model FLOP counts for MFU (counterpart of ``apex_tpu/utils/flops.py``).

Two FLOPs per multiply-add, the convention of the peak rates they are
divided by (989 TFLOP/s bf16 on an H100 counts an FMA as two).
"""

from __future__ import annotations

__all__ = ["resnet50_train_flops"]

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
