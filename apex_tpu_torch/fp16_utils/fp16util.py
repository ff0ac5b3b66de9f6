"""Manual master-weight mixed-precision utilities.

Counterpart of ``apex_tpu/fp16_utils/fp16util.py`` (apex's
``fp16util.py``): casting a network's floating parameters, keeping
normalization parameters in fp32 by a path predicate
(``BN_convert_float``), and the fp32 master copies. The functions take a
tree of tensors (nested dicts, lists, tuples) as the JAX package does;
:func:`convert_network` and :func:`network_to_half` also take an
``nn.Module``, whose parameters they cast in place (paths are the
parameter names split at the dots).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_cast, tree_map, tree_map_with_path

__all__ = ["convert_network", "network_to_half", "prep_param_lists",
           "model_grads_to_master_grads", "master_params_to_model_params"]

_NORM_NAMES = ("batchnorm", "bn", "layernorm", "ln", "norm")


def _default_keep_fp32(path: Tuple, leaf) -> bool:
    """Keep batchnorm/layernorm scale and bias in fp32 by path name."""
    names = "/".join(str(p) for p in path).lower()
    return any(k in names for k in _NORM_NAMES)


def convert_network(params: Any, dtype=torch.bfloat16,
                    keep_fp32: Optional[Callable[[Tuple, Any], bool]]
                    = _default_keep_fp32) -> Any:
    """Cast floating tensors to ``dtype``, those ``keep_fp32(path, tensor)``
    names to fp32; other leaves as they are."""

    def cast(path, x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        if keep_fp32 is not None and keep_fp32(path, x):
            return x.to(torch.float32)
        return x.to(dtype)

    if isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            p.data = cast(tuple(name.split(".")), p.data)
        return params
    return tree_map_with_path(cast, params)


def network_to_half(params: Any, dtype=torch.bfloat16) -> Any:
    """Cast every floating tensor."""
    return tree_cast(params, dtype)


def prep_param_lists(params: Any) -> Tuple[Any, Any]:
    """``(model params, fp32 master copy)``."""
    return params, tree_map(
        lambda x: x.detach().to(torch.float32, copy=True)
        if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
        params)


def model_grads_to_master_grads(model_grads: Any) -> Any:
    return tree_cast(model_grads, torch.float32)


def master_params_to_model_params(master_params: Any,
                                  model_params: Any) -> Any:
    """The fp32 master values cast into the model params' dtypes."""
    return tree_map(lambda m, p: m.to(p.dtype), master_params, model_params)
