"""Sharded checkpoint save/restore, in the JAX package's on-disk format.

Counterpart of ``apex_tpu/checkpoint/sharded.py``. A step directory the
port writes is byte for byte the one the JAX package writes for the same
tree, and each package reads and verifies the other's
(:mod:`apex_tpu_torch.checkpoint.manifest` is the shared protocol):

- **leaf paths and order** are ``jax.tree_util``'s: dict keys sorted,
  list and tuple entries by index, a namedtuple's fields in order and a
  dataclass's fields sorted (the order of JAX's registered dataclasses,
  the amp ``LossScalerState`` among them); a path is ``keystr``'s
  string (``['params']['w']``, ``['l'][0]``, ``['scaler'].loss_scale``)
  and leaf ``i`` of that order writes ``leaf{i:04d}_s00.npy``;
- **each shard is an ``.npy`` file** as ``np.save`` writes it. numpy has
  no bfloat16, so a bf16 leaf is written as its 16-bit patterns under the
  header the JAX package's ``ml_dtypes`` array gets (``'descr': '<V2'``)
  and read back by reinterpreting those bits; its manifest dtype is
  ``"bfloat16"``. Leaves with no sharding record ``"spec": null`` and
  ``"mesh": null``, as the JAX package's single-device leaves do;
- **a snapshot copies** every leaf to host memory: on the card one
  device-to-host copy per leaf and then one synchronize, on the CPU a
  clone (``Tensor.numpy()`` would alias the storage, and the optimizers
  update parameters and slots in place, so the next step would write
  over an in-flight async write). :meth:`ShardedCheckpointManager.snapshot`
  is the only part of a save that blocks the training loop;
- **restore writes in place, after verifying everything**: every shard
  of the step is read into host memory and checked (sha256, shape, and
  coverage of the region) before any template tensor is written, and
  then each is ``copy_``'d into. A corrupt step raises
  :class:`~apex_tpu_torch.checkpoint.manifest.CheckpointCorruptionError`
  with the live state untouched, and
  :class:`~apex_tpu_torch.checkpoint.RetryingCheckpointManager` falls
  back to an older step. A step the JAX package wrote over a mesh
  restores whole: each leaf is assembled from the saved shards that
  cover it, as the JAX ``_restore_leaf`` assembles a region.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import threading
from io import BytesIO
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format

from apex_tpu_torch.checkpoint.manifest import (
    FORMAT_NAME,
    CheckpointCorruptionError,
    list_step_dirs,
    load_manifest,
    read_commit,
    sha256_bytes,
    validate_step_dir,
    write_commit,
    write_manifest,
)

__all__ = ["ShardedCheckpointManager", "HostSnapshot",
           "CheckpointCorruptionError", "tree_items", "npy_bytes"]


# -- the tree walk: jax.tree_util's order and keystr paths -----------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(path piece, child), ...]`` of a container, None for a leaf."""
    if node is None:
        return []                      # an empty subtree, as in JAX
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{n}", getattr(node, n))
                for n in sorted(f.name for f in dataclasses.fields(node))]
    return None


def tree_items(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` over ``tree`` in ``jax.tree_util``'s flatten
    order, each path the ``jax.tree_util.keystr`` string of the leaf."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for piece, child in kids:
        out += tree_items(child, prefix + piece)
    return out


def _tensor_items(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """:func:`tree_items` of a tree whose every leaf is a tensor (what a
    snapshot copies and a restore writes into)."""
    items = tree_items(tree)
    for key, leaf in items:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{key}: a checkpointed leaf must be a tensor, "
                            f"got {type(leaf).__name__}")
    return items


# -- .npy bytes, bf16 included ---------------------------------------------

_BF16 = "bfloat16"


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return _BF16
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype holding a manifest dtype's elements: bf16 as its
    16-bit patterns."""
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def _npy_header(arr: np.ndarray, dtype_name: str) -> bytes:
    """The header ``np.save`` writes for ``arr`` (C order); a bf16 leaf's
    is the one ``ml_dtypes``' bfloat16 array gets."""
    d = npy_format.header_data_from_array_1_0(arr)
    if dtype_name == _BF16:
        d["descr"] = "<V2"
    buf = BytesIO()
    npy_format.write_array_header_1_0(buf, d)
    return buf.getvalue()


def npy_bytes(arr: np.ndarray, dtype_name: str) -> Tuple[bytes, memoryview]:
    """``(header, data)`` of one shard's ``.npy`` file, the bytes
    ``np.save`` writes for it; ``arr`` holds a bf16 leaf's 16-bit
    patterns where ``dtype_name`` is ``"bfloat16"``."""
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    data = memoryview(arr.reshape(-1).view(np.uint8))
    return _npy_header(arr, dtype_name), data


def _parse_npy(data: bytes, dtype_name: str) -> np.ndarray:
    """One ``.npy`` file's array, without copying its data; a bf16 leaf
    (``'<V2'`` or ``'|V2'``) comes back as its int16 patterns."""
    bio = BytesIO(data)
    version = npy_format.read_magic(bio)
    if version == (1, 0):
        shape, fortran, dtype = npy_format.read_array_header_1_0(bio)
    else:
        shape, fortran, dtype = npy_format.read_array_header_2_0(bio)
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=bio.tell())
    arr = (arr.reshape(shape[::-1]).transpose() if fortran
           else arr.reshape(shape))
    if dtype_name == _BF16 and arr.dtype.kind == "V" \
            and arr.dtype.itemsize == 2:
        arr = arr.view(np.int16)
    return arr


def _bounds(index: Tuple[slice, ...], shape: Sequence[int]
            ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Concrete (start, stop) per dim from a region's slice tuple."""
    start, stop = [], []
    for sl, dim in zip(index, shape):
        start.append(0 if sl.start is None else int(sl.start))
        stop.append(int(dim) if sl.stop is None else int(sl.stop))
    return tuple(start), tuple(stop)


class HostSnapshot:
    """Host copy of one train-state tree, shard-structured: the only part
    of a save that blocks the step loop. Leaves are listed in
    :func:`tree_items` order with per-shard host arrays and bounds;
    serialization and checksums happen later, on the writer."""

    __slots__ = ("leaves", "nbytes")

    def __init__(self, leaves: List[dict], nbytes: int):
        self.leaves = leaves
        self.nbytes = nbytes


class ShardedCheckpointManager:
    """Step-addressed sharded checkpoints under one root directory.

    API of the JAX package's manager (``save``/``restore``/
    ``restore_step``/``all_steps``/``delete``/…), so
    :class:`~apex_tpu_torch.checkpoint.RetryingCheckpointManager` and
    :func:`apex_tpu_torch.resilience.run_training` drive either format;
    with the two-phase :meth:`snapshot`/:meth:`write_snapshot` split
    (async saves), :meth:`uncommitted_steps`/:meth:`cleanup_partial`
    (interrupted-save debris), and :meth:`verify_step` (deep fsck of one
    step). Every leaf writes one shard: the port's tensors live on one
    device (process groups come with the parallelism slice).
    """

    #: RetryingCheckpointManager keys on this to run writes on its
    #: background writer instead of inline
    supports_async = True

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, fsync: bool = True):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        self.fsync = bool(fsync)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()  # serializes directory mutation

    # -- step listing ------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Committed steps, ascending. Commit = a readable ``COMMIT``
        marker; anything else is invisible debris (see
        :meth:`uncommitted_steps`)."""
        steps = []
        for step, name in list_step_dirs(self.directory).items():
            if read_commit(os.path.join(self.directory, name)) is not None:
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def uncommitted_steps(self) -> List[int]:
        """Integer-named child directories with no commit marker — the
        debris a killed or failed save leaves behind."""
        out = []
        for step, name in list_step_dirs(self.directory).items():
            if read_commit(os.path.join(self.directory, name)) is None:
                out.append(step)
        return sorted(out)

    def cleanup_partial(self, *, exclude: Sequence[int] = ()) -> List[int]:
        """Remove uncommitted step directories (``exclude`` protects
        steps a writer is mid-save on). Returns the steps removed."""
        removed = []
        skip = {int(s) for s in exclude}
        with self._lock:
            for step in self.uncommitted_steps():
                if step in skip:
                    continue
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
                removed.append(step)
        return removed

    def should_save(self, step: int, *, force: bool = False) -> bool:
        if force:
            return True
        if self.save_interval_steps > 1 and step % self.save_interval_steps:
            return False
        return True

    # -- save: snapshot (critical path) + write (background-safe) ----------
    def snapshot(self, state: Any) -> HostSnapshot:
        """Copy every leaf to host memory — the ONLY part of a save the
        train loop must block on: one device-to-host copy per CUDA leaf,
        then one synchronize; a clone per CPU leaf."""
        pending: List[Tuple[dict, torch.Tensor]] = []
        devices = set()
        for key, leaf in _tensor_items(state):
            t = leaf.detach()
            if t.device.type == "cuda":
                devices.add(t.device)
                host = t.to("cpu", non_blocking=True)
            else:
                host = t.clone()
            pending.append(({"path": key, "shape": tuple(t.shape),
                             "dtype": _dtype_name(t), "spec": None,
                             "mesh": None}, host))
        for dev in devices:
            torch.cuda.synchronize(dev)
        leaves: List[dict] = []
        nbytes = 0
        for rec, host in pending:
            host = host.contiguous()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            host = host.numpy()
            shape = rec["shape"]
            rec["shards"] = [{"start": tuple(0 for _ in shape),
                              "stop": shape, "data": host}]
            nbytes += host.nbytes
            leaves.append(rec)
        return HostSnapshot(leaves, nbytes)

    def write_snapshot(self, step: int, snap: HostSnapshot, *,
                       force: bool = False) -> None:
        """Serialize + fsync + checksum a :class:`HostSnapshot` into the
        step directory and commit it. Safe to call from a background
        writer thread (touches only host memory and the filesystem).
        An existing committed step is replaced only under ``force`` —
        the retry/emergency semantics."""
        step = int(step)
        step_dir = self._step_dir(step)
        with self._lock:
            if os.path.isdir(step_dir):
                if not force and read_commit(step_dir) is not None:
                    raise FileExistsError(
                        f"step {step} already committed at {step_dir} "
                        f"(pass force=True to replace)")
                shutil.rmtree(step_dir, ignore_errors=True)
            os.makedirs(step_dir, exist_ok=True)
        manifest_leaves: Dict[str, dict] = {}
        for i, leaf in enumerate(snap.leaves):
            entries = []
            for j, shard in enumerate(leaf["shards"]):
                fname = f"leaf{i:04d}_s{j:02d}.npy"
                header, data = npy_bytes(shard["data"], leaf["dtype"])
                digest = hashlib.sha256(header)
                digest.update(data)
                with open(os.path.join(step_dir, fname), "wb") as f:
                    f.write(header)
                    f.write(data)
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
                entries.append({
                    "file": fname,
                    "index": j,
                    "start": list(shard["start"]),
                    "stop": list(shard["stop"]),
                    "bytes": len(header) + data.nbytes,
                    "sha256": digest.hexdigest(),
                })
            manifest_leaves[leaf["path"]] = {
                "shape": list(leaf["shape"]),
                "dtype": leaf["dtype"],
                "spec": leaf["spec"],
                "mesh": leaf["mesh"],
                "shards": entries,
            }
        manifest = {"format": FORMAT_NAME, "step": step,
                    "leaves": manifest_leaves}
        sha = write_manifest(step_dir, manifest, fsync=self.fsync)
        write_commit(step_dir, sha, step, fsync=self.fsync)
        self._prune()

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Synchronous save: snapshot + write + commit. Returns False when
        gated by ``save_interval_steps``; see
        :class:`RetryingCheckpointManager` for the async composition."""
        if not self.should_save(step, force=force):
            return False
        self.write_snapshot(step, self.snapshot(state), force=force)
        return True

    def _prune(self) -> None:
        if self.max_to_keep <= 0:
            return
        steps = self.all_steps()
        with self._lock:
            for step in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, template: Any) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore_step(step, template)

    def restore_step(self, step: int, template: Any) -> Any:
        """Write a committed step into the tensors of ``template`` in
        place and return ``template``. Every shard of the step is read
        and verified first (sha256 against the manifest, shape, coverage
        of each leaf); a corrupt step raises with no template tensor
        written. A leaf saved in many shards (the JAX package over a
        mesh) is assembled whole from the shards that cover it."""
        step_dir = self._step_dir(int(step))
        manifest = load_manifest(step_dir)
        leaves = manifest["leaves"]
        items = _tensor_items(template)
        for key, leaf in items:
            if key not in leaves:
                raise ValueError(
                    f"checkpoint step {step} has no leaf {key} — the "
                    f"template's pytree structure differs from the "
                    f"saved state")
        host = [self._load_leaf(step_dir, key, leaves[key], leaf)
                for key, leaf in items]
        # every shard verified: only now is the live state written
        with torch.no_grad():
            for (key, leaf), (arr, name) in zip(items, host):
                src = torch.from_numpy(arr)
                leaf.copy_(src.view(torch.bfloat16) if name == _BF16
                           else src)
        return template

    def _load_leaf(self, step_dir: str, key: str, entry: dict,
                   template_leaf: Any) -> Tuple[np.ndarray, str]:
        """``(host array, manifest dtype)`` of one leaf, every shard it
        reads verified; a bf16 leaf's array holds its 16-bit patterns."""
        shape = tuple(entry["shape"])
        t_shape = tuple(template_leaf.shape)
        if t_shape != shape:
            raise ValueError(
                f"{key}: checkpoint global shape {shape} != template "
                f"shape {t_shape} (elastic restore re-shards, it does "
                f"not reshape)")
        name = entry["dtype"]
        dtype = _storage_dtype(name)
        cache: Dict[str, np.ndarray] = {}

        def load_shard(shard: dict) -> np.ndarray:
            fname = shard["file"]
            if fname not in cache:
                fpath = os.path.join(step_dir, fname)
                try:
                    with open(fpath, "rb") as f:
                        data = f.read()
                except OSError as e:
                    raise CheckpointCorruptionError(
                        f"{key}: shard {fname} unreadable: {e}") from e
                if sha256_bytes(data) != shard.get("sha256"):
                    raise CheckpointCorruptionError(
                        f"{key}: shard {fname} sha256 mismatch "
                        f"(bit rot / torn write)")
                arr = _parse_npy(data, name)
                want = (tuple(shard["stop"][d] - shard["start"][d]
                              for d in range(len(shape)))
                        if shape else ())
                if tuple(arr.shape) != want:
                    raise CheckpointCorruptionError(
                        f"{key}: shard {fname} has shape {arr.shape}, "
                        f"manifest says {want}")
                cache[fname] = arr
            return cache[fname]

        def region(index: Tuple[slice, ...]) -> np.ndarray:
            """Assemble one region from intersecting saved shards — the
            save-time tiling need not align with it."""
            start, stop = _bounds(tuple(index), shape)
            out = np.empty(tuple(b - a for a, b in zip(start, stop)),
                           dtype=dtype)
            filled = 0
            for shard in entry["shards"]:
                s_start, s_stop = shard["start"], shard["stop"]
                lo = tuple(max(a, b) for a, b in zip(start, s_start))
                hi = tuple(min(a, b) for a, b in zip(stop, s_stop))
                if any(a >= b for a, b in zip(lo, hi)):
                    continue  # no overlap with this saved shard
                block = load_shard(shard)
                src = tuple(slice(a - o, b - o)
                            for a, b, o in zip(lo, hi, s_start))
                dst = tuple(slice(a - o, b - o)
                            for a, b, o in zip(lo, hi, start))
                out[dst] = block[src]
                filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
            if filled < int(np.prod(out.shape)):
                raise CheckpointCorruptionError(
                    f"{key}: saved shards cover only {filled} of "
                    f"{int(np.prod(out.shape))} elements of the "
                    f"requested region (manifest damaged?)")
            return out

        return region(tuple(slice(0, d) for d in shape)), name

    # -- maintenance -------------------------------------------------------
    def verify_step(self, step: int, *, deep: bool = True) -> None:
        """Deep fsck of one committed step; raises
        :class:`CheckpointCorruptionError` listing every problem."""
        problems = validate_step_dir(self._step_dir(int(step)), deep=deep)
        if problems:
            raise CheckpointCorruptionError(
                f"step {step}: " + "; ".join(problems))

    def delete(self, step: int) -> None:
        step_dir = self._step_dir(int(step))
        if not os.path.isdir(step_dir):
            raise FileNotFoundError(step_dir)
        with self._lock:
            shutil.rmtree(step_dir, ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Writes here are synchronous; asynchrony (and its drain) lives
        in :class:`RetryingCheckpointManager`."""

    def close(self) -> None:
        pass
