"""Transformer building blocks (counterpart of ``apex_tpu.transformer``)."""

from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
