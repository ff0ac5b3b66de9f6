"""Model-parallel random keys and activation recompute at tensor-parallel
size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``. The
JAX package derives every dropout mask from explicit ``jax.random`` keys;
the port's keys are :mod:`apex_tpu_torch.utils.prng` keys (threefry as
integer torch math, bitwise ``jax.random``'s). With one tensor-parallel
rank the model-parallel key is the key itself, as the JAX function returns
it outside ``shard_map``. Because no mask reads a global generator,
:func:`checkpoint` recomputes the same masks in the backward with no RNG
state saved or restored.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils.checkpoint

__all__ = ["model_parallel_rng_key", "checkpoint"]


def model_parallel_rng_key(key: torch.Tensor) -> torch.Tensor:
    """The key a tensor-parallel rank draws its model-parallel masks from:
    ``key`` itself at tensor-parallel size 1 (the JAX function folds the
    rank in only inside ``shard_map``)."""
    return key


def checkpoint(fn: Callable[..., Any], *args, **kwargs) -> Any:
    """Activation recompute (``jax.checkpoint``): ``fn(*args, **kwargs)``
    whose activations are recomputed in the backward
    (``torch.utils.checkpoint`` without reentrancy)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kwargs)
