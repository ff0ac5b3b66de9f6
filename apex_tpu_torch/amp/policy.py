"""Precision policies applied at function boundaries.

Counterpart of ``apex_tpu/amp/policy.py``: in place of apex's per-op cast
lists and monkey-patching, an explicit policy object (param, compute and
output dtypes) casts the tensors of a tree at a function's boundary, and
the ``half_function`` / ``float_function`` / ``promote_function`` wrappers
and their ``register_*`` forms reproduce apex's registration API.
:func:`disable_casts` suspends every wrapper of this module, through a
``contextvars`` flag, so a disable in one thread or task never leaks into
another.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Callable

import torch

from apex_tpu_torch.utils.tree import tree_cast, tree_leaves

__all__ = ["Policy", "disable_casts", "half_function", "float_function",
           "promote_function", "register_half_function",
           "register_float_function", "register_promote_function",
           "master_params"]

_casts_enabled = contextvars.ContextVar("apex_tpu_torch_amp_casts_enabled",
                                        default=True)


@contextlib.contextmanager
def disable_casts():
    """Suspend every policy and decorator cast inside the context
    (``amp.disable_casts``); the casts come back on exit."""
    token = _casts_enabled.set(False)
    try:
        yield
    finally:
        _casts_enabled.reset(token)


@dataclasses.dataclass(frozen=True)
class Policy:
    """``Policy(param_dtype, compute_dtype, output_dtype)``; bf16 is the
    default half type, fp16 the one dynamic loss scaling exists for."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_param(self, tree):
        """Cast a tree (or an ``nn.Module``'s parameters, in place)."""
        return tree_cast(tree, self.param_dtype)

    def cast_to_compute(self, tree):
        return tree_cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return tree_cast(tree, self.output_dtype)

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` with its inputs cast to the compute dtype and its outputs
        to the output dtype."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _casts_enabled.get():
                return fn(*args, **kwargs)
            out = fn(*self.cast_to_compute(args),
                     **self.cast_to_compute(kwargs))
            return self.cast_to_output(out)

        return wrapped

    @staticmethod
    def from_names(names: str) -> "Policy":
        """Parse ``"params=float32,compute=bfloat16,output=float32"`` or
        the short form ``"p=f32,c=bf16,o=f32"``."""
        mapping = {"f32": torch.float32, "float32": torch.float32,
                   "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                   "f16": torch.float16, "float16": torch.float16}
        fields = {"p": "param_dtype", "params": "param_dtype",
                  "c": "compute_dtype", "compute": "compute_dtype",
                  "o": "output_dtype", "output": "output_dtype"}
        kw = {}
        for part in names.split(","):
            k, v = part.split("=")
            kw[fields[k.strip()]] = mapping[v.strip()]
        return Policy(**kw)


def _cast_fn(fn: Callable, dtype) -> Callable:
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _casts_enabled.get():
            return fn(*args, **kwargs)
        return fn(*tree_cast(args, dtype), **tree_cast(kwargs, dtype))

    return wrapped


def half_function(fn: Callable, dtype=torch.bfloat16) -> Callable:
    """Always run ``fn`` in half precision."""
    return _cast_fn(fn, dtype)


def float_function(fn: Callable) -> Callable:
    """Always run ``fn`` in fp32."""
    return _cast_fn(fn, torch.float32)


def promote_function(fn: Callable) -> Callable:
    """Run ``fn`` in the widest floating dtype among its tensor
    arguments."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _casts_enabled.get():
            return fn(*args, **kwargs)
        dtypes = [x.dtype for x in tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor) and x.is_floating_point()]
        if not dtypes:
            return fn(*args, **kwargs)
        target = functools.reduce(torch.promote_types, dtypes)
        return fn(*tree_cast(args, target), **tree_cast(kwargs, target))

    return wrapped


def register_half_function(module, name: str, dtype=torch.bfloat16) -> None:
    """Rebind ``module.name`` to its half-cast wrapper, in place (for a
    third-party function that cannot be decorated where it is defined)."""
    setattr(module, name, half_function(getattr(module, name), dtype))


def register_float_function(module, name: str) -> None:
    setattr(module, name, float_function(getattr(module, name)))


def register_promote_function(module, name: str) -> None:
    setattr(module, name, promote_function(getattr(module, name)))


def master_params(optimizer) -> list:
    """The fp32 master copies an optimizer keeps (``master_weights=True``
    / O2: each parameter's ``master`` state, made at its first step; an
    ``FP16_Optimizer``'s master list), else ``[]``."""
    masters = getattr(optimizer, "master_params", None)
    if masters is not None:
        return list(masters)
    return [optimizer.state[p]["master"] for group in optimizer.param_groups
            for p in group["params"] if "master" in optimizer.state.get(p, {})]
