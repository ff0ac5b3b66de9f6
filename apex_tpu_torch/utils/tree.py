"""Trees of tensors: flatten, unflatten, map, cast and the global norm.

Counterpart of ``apex_tpu/utils/tree.py`` and of the parts of
``jax.tree_util`` the port's amp and multi-tensor modules need. A tree is
a nested dict, list or tuple (namedtuples included); ``None`` is an empty
subtree; anything else is a leaf. Dicts flatten in sorted key order, as
``jax.tree_util`` does, so a flat layout (``flatten_by_dtype``'s buckets)
is the JAX package's. :func:`tree_cast` also takes an ``nn.Module``, whose
floating parameters it casts in place (the port's parameters live in
modules).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "tree_map_with_path", "tree_cast", "global_norm"]


def _children(node) -> Tuple[str, Any, list]:
    """``(kind, aux, [(key, child), ...])`` of a node, or kind "leaf"."""
    if node is None:
        return "none", None, []
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [(k, node[k]) for k in keys]
    if isinstance(node, tuple):
        return "tuple", type(node), list(enumerate(node))
    if isinstance(node, list):
        return "list", None, list(enumerate(node))
    return "leaf", None, []


def _flatten(node, path, out) -> tuple:
    kind, aux, kids = _children(node)
    if kind == "leaf":
        out.append((path, node))
        return ("leaf",)
    return (kind, aux, tuple(_flatten(c, path + (k,), out)
                             for k, c in kids))


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``, leaves in ``jax.tree_util`` order."""
    out: list = []
    treedef = _flatten(tree, (), out)
    return [leaf for _, leaf in out], treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        kids = [build(c) for c in d[2]]
        if kind == "dict":
            return dict(zip(d[1], kids))
        if kind == "list":
            return kids
        cls = d[1]
        return cls(*kids) if hasattr(cls, "_fields") else cls(kids)

    return build(treedef)


def tree_map(f: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [f(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(f: Callable, tree) -> Any:
    """``f(path, leaf)`` over the leaves; a path is the tuple of dict keys
    and sequence indices from the root."""
    out: list = []
    treedef = _flatten(tree, (), out)
    return tree_unflatten(treedef, [f(p, x) for p, x in out])


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tree_cast(tree: Any, dtype) -> Any:
    """Cast every floating-point tensor of ``tree`` to ``dtype`` (None: the
    tree as it is). An ``nn.Module``'s floating parameters are cast in
    place, and the module returned."""
    if dtype is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        for p in tree.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return tree
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def global_norm(tree: Any) -> torch.Tensor:
    """L2 norm over all leaves, accumulated in fp32: the
    ``multi_tensor_l2norm`` kernel on the card, its plain version on the
    CPU."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return multi_tensor_l2norm(leaves)[0]
