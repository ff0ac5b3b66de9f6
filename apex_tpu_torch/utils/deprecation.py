"""Deprecation machinery (capability of ``apex/__init__.py:46-67``;
counterpart of ``apex_tpu/utils/deprecation.py``)."""

from __future__ import annotations

import warnings

import torch.distributed as dist

__all__ = ["DeprecatedFeatureWarning", "deprecated_warning"]


class DeprecatedFeatureWarning(FutureWarning):
    pass


_seen: set = set()


def _rank() -> int:
    """This process's rank, or 0 where ``torch.distributed`` is not
    initialised (the JAX package reads ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def deprecated_warning(msg: str) -> None:
    """Warn once per unique message, on rank 0 only."""
    if msg in _seen:
        return
    _seen.add(msg)
    if _rank() == 0:
        warnings.warn(msg, DeprecatedFeatureWarning, stacklevel=2)
