"""Parameter conversion between the JAX package's model trees and the port.

The caller hands over apex_tpu's parameter pytree already turned into
numpy (``jax.tree.map(np.asarray, params)``), so the port never sees a
JAX array. :func:`params_from_jax` maps it onto the ``state_dict`` keys of
:class:`~apex_tpu_torch.models.GPTModel`,
:class:`~apex_tpu_torch.models.BertModel` or
:class:`~apex_tpu_torch.models.EncoderDecoderModel`:

- the stacked ``params[stack]["layers"]`` leaves ``[L, ...]`` (``stack``
  is ``transformer``, ``encoder`` or ``decoder``) split into the per-layer
  modules ``{stack}.layers.{i}.…``;
- every other leaf maps one to one, its path joined with dots
  (``embedding/word_embeddings/weight`` — the tied LM head —
  ``embedding/position_embeddings``, ``lm_head/dense/bias``,
  ``binary_head/pooler/weight``, ``transformer/final_layernorm/…``);
- weights stay ``[out, in]``, as both packages keep them;
- a ResNet's stages are **lists** of block dicts (``layer1: [{...}, ...]``):
  ``layer1/0/conv1`` maps to ``layer1.0.conv1``, and its conv weights stay
  HWIO (the layout the fused kernels read), its fc kernel ``[in,
  classes]``.

:func:`params_to_jax` is the inverse (numpy leaves, layers restacked,
lists rebuilt; bf16 leaves come back widened to float32, which is exact),
and :func:`grads_to_jax` lays a model's ``.grad`` tensors out the same way,
so they compare leaf by leaf with the JAX gradient tree.
:func:`state_from_jax` / :func:`state_to_jax` do the same for a ResNet's
batch-norm running statistics (the JAX ``state`` tree, the port's
buffers). :func:`adapter_from_jax` / :func:`adapter_to_jax` carry a LoRA
adapter's factor tree (``{target: {"A": [L, in, r], "B": [L, r, out]}}``,
the same layout in both packages, or a stacked ``[n_jobs, L, ...]`` one)
across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "grads_to_jax",
           "load_jax_params", "state_from_jax", "state_to_jax",
           "adapter_from_jax", "adapter_to_jax"]


def _stacked(path) -> bool:
    """``{stack}/layers/…``: a leaf stacked over the layers."""
    return len(path) > 2 and path[1] == "layers"


def _to_tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:           # numpy has no bf16: widen, exactly
        t = t.float()
    return t.numpy()


def _walk(tree, prefix=()):
    """``(path, leaf)`` over nested mappings and lists (a list's entries
    are keyed by their index)."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for key, value in items:
        path = prefix + (str(key),)
        if isinstance(value, (Mapping, list, tuple)):
            yield from _walk(value, path)
        else:
            yield path, value


def _lists(tree):
    """Turn every dict whose keys are all indices back into a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """apex_tpu model params (numpy leaves) -> the port model's state dict
    of CPU tensors in the leaves' dtypes."""
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        if _stacked(path):
            stacked = _to_tensor(leaf)
            for i in range(stacked.shape[0]):
                key = ".".join(path[:2] + (str(i),) + path[2:])
                state[key] = stacked[i].clone()
        else:
            state[".".join(path)] = _to_tensor(leaf)
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a nested dict of numpy
    leaves with the per-layer tensors restacked to ``[L, ...]``."""
    tree: Dict[str, Any] = {}
    layers: Dict[tuple, Dict[int, np.ndarray]] = {}
    for key, tensor in state.items():
        path = tuple(key.split("."))
        if _stacked(path):
            leaf = path[:2] + path[3:]
            layers.setdefault(leaf, {})[int(path[2])] = _to_numpy(tensor)
            continue
        _put(tree, path, _to_numpy(tensor))
    for leaf, per_layer in layers.items():
        _put(tree, leaf, np.stack([per_layer[i] for i in sorted(per_layer)]))
    return _lists(tree)


def grads_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's parameter grads as the JAX gradient tree (numpy leaves,
    per-layer grads restacked). A parameter without a grad gives zeros.
    The tied word embedding is one parameter, so its leaf holds the sum
    of the lookup's and the LM head's gradients, as in JAX."""
    return params_to_jax({
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in model.named_parameters()})


def _put(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def state_from_jax(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ResNet's JAX batch-norm state (numpy leaves: ``stem/bn/mean``,
    ``layer1/0/bn1/var``, ...) -> the port's buffer keys
    (``stem.bn.mean``, ``layer1.0.bn1.var``, ...)."""
    return {".".join(path): _to_tensor(leaf) for path, leaf in _walk(state)}


def state_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's buffers as the JAX state tree (numpy leaves, stages as
    lists)."""
    tree: Dict[str, Any] = {}
    for name, buf in model.named_buffers():
        _put(tree, tuple(name.split(".")), _to_numpy(buf))
    return _lists(tree)


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any],
                    state: Mapping[str, Any] = None):
    """Copy apex_tpu model params (numpy leaves) into ``model`` in place,
    cast to each parameter's dtype and device; every parameter key must
    match. ``state`` (a ResNet's batch-norm state tree) loads the buffers
    too, every one of them. Returns the model."""
    values = params_from_jax(tree)
    if state is not None:
        values.update(state_from_jax(state))
    missing, unexpected = model.load_state_dict(values, strict=False)
    buffers = {name for name, _ in model.named_buffers()}
    missing = [k for k in missing if state is not None or k not in buffers]
    if missing or unexpected:
        # the error load_state_dict(strict=True) raises
        raise RuntimeError(f"load_jax_params: missing keys {missing}, "
                           f"unexpected keys {unexpected}")
    return model


def adapter_from_jax(factors: Mapping[str, Any]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter's factor tree (numpy leaves) -> the port's, CPU
    tensors in the leaves' dtypes (:meth:`AdapterStore.load` moves them to
    the bank's device)."""
    return {t: {k: _to_tensor(v) for k, v in f.items()}
            for t, f in factors.items()}


def adapter_to_jax(factors: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`adapter_from_jax`: numpy leaves."""
    return {t: {k: _to_numpy(v) for k, v in f.items()}
            for t, f in factors.items()}
