"""Batched whole-list elementwise dispatch over flat per-dtype buckets.

Counterpart of ``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``, the
same API: each tensor list is flattened into one 1-D buffer per dtype
(padded to a multiple of ``CHUNK``), ``op`` runs once over the flat
buffers, and the results are split back into tensors of the original
shapes. The layouts (sorted dict keys, offsets, padding) are the JAX
package's, so a flat buffer here holds what the JAX one holds.

The port's optimizers do not go through these flat copies: on the card
they run the pointer-table kernels of
:mod:`apex_tpu_torch.ops.multi_tensor`, which read the tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["CHUNK", "BucketMeta", "flatten_by_dtype", "unflatten_by_dtype",
           "MultiTensorApply", "multi_tensor_applier"]

#: bucket granularity (the JAX package's (8, 128) tile of fp32)
CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class BucketMeta:
    """Shapes/sizes needed to split a flat bucket back into tensors."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtype: Any
    padded_size: int

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes)])


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` as the JAX package names it: ``"float32"``."""
    return str(dtype).replace("torch.", "")


def _flatten_list(tensors: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, BucketMeta]:
    shapes = tuple(tuple(t.shape) for t in tensors)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    total = sum(sizes)
    padded = ((total + CHUNK - 1) // CHUNK) * CHUNK
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if padded != total:
        flat = torch.nn.functional.pad(flat, (0, padded - total))
    return flat, BucketMeta(shapes, sizes, tensors[0].dtype, padded)


def _unflatten_list(flat: torch.Tensor, meta: BucketMeta
                    ) -> List[torch.Tensor]:
    out, off = [], 0
    for shape, size in zip(meta.shapes, meta.sizes):
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out


def flatten_by_dtype(tree: Any) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, BucketMeta], Any]:
    """Flatten a tree into one 1-D buffer per distinct tensor dtype:
    ``(buffers, metas, aux)``, keyed by the dtype's name."""
    leaves, treedef = tree_flatten(tree)
    groups: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(_dtype_name(leaf.dtype), []).append(i)
    buffers, metas = {}, {}
    for key, idxs in groups.items():
        buffers[key], metas[key] = _flatten_list([leaves[i] for i in idxs])
    index_map = {key: tuple(idxs) for key, idxs in groups.items()}
    return buffers, metas, (treedef, index_map, len(leaves))


def unflatten_by_dtype(buffers: Dict[str, torch.Tensor],
                       metas: Dict[str, BucketMeta], aux: Any) -> Any:
    treedef, index_map, n_leaves = aux
    leaves: List[Any] = [None] * n_leaves
    for key, flat in buffers.items():
        for leaf, i in zip(_unflatten_list(flat, metas[key]),
                           index_map[key]):
            leaves[i] = leaf
    return tree_unflatten(treedef, leaves)


class MultiTensorApply:
    """``multi_tensor_applier(op, tensor_lists, *args)``: ``op`` receives
    one flat 1-D buffer per tensor list (all lists flattened with the same
    layout) plus ``*args`` and returns the updated buffers; the result is
    one list of tensors per returned buffer, in the first list's shapes."""

    def __init__(self, chunk_size: int = CHUNK):
        self.chunk_size = chunk_size

    def __call__(self, op: Callable[..., Any],
                 tensor_lists: Sequence[Sequence[torch.Tensor]],
                 *args) -> List[List[torch.Tensor]]:
        flats, meta = [], None
        for lst in tensor_lists:
            flat, m = _flatten_list(list(lst))
            flats.append(flat)
            meta = meta or m
        outs = op(*flats, *args)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        return [_unflatten_list(out, dataclasses.replace(meta,
                                                         dtype=out.dtype))
                for out in outs]


multi_tensor_applier = MultiTensorApply()
