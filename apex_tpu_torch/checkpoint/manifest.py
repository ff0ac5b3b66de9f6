"""Sharded-checkpoint manifest + commit protocol (pure stdlib).

A copy of ``apex_tpu/checkpoint/manifest.py``, kept in the port so it
never imports the JAX package. The on-disk format is the same in both
packages, so its name (:data:`FORMAT_NAME`) is too: a step one package
writes, the other reads and verifies.

One committed step of the sharded format
(:class:`apex_tpu_torch.checkpoint.ShardedCheckpointManager`) is a
directory::

    <root>/<step>/
        leaf0000_s00.npy     # one file per (param-path, global-shard-index)
        leaf0000_s01.npy
        ...
        manifest.json        # global shapes, dtypes, sharding specs,
                             # per-shard start/stop offsets + sha256
        COMMIT               # {"manifest_sha256": ...} — written LAST,
                             # via atomic rename

The commit marker is the atomicity boundary: a writer killed at any
point before the final ``os.replace`` leaves a directory without
``COMMIT``, which every reader (``all_steps``, ``restore_latest``, the
``verify`` CLI) treats as invisible debris, never as a step. The marker
records the manifest's own sha256, so a manifest torn *after* commit
(bit rot, partial overwrite) is also detected — validation walks
commit -> manifest checksum -> per-shard checksums.

This module is deliberately torch-free: the ``python -m
apex_tpu_torch.checkpoint verify`` fsck and the restore-side validation
share these helpers, and the former must run on a machine far from any
accelerator.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional

__all__ = [
    "MANIFEST_NAME",
    "COMMIT_NAME",
    "FORMAT_NAME",
    "CheckpointCorruptionError",
    "sha256_bytes",
    "sha256_file",
    "atomic_write_bytes",
    "write_manifest",
    "write_commit",
    "read_commit",
    "load_manifest",
    "validate_step_dir",
    "list_step_dirs",
]

MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT"
FORMAT_NAME = "apex_tpu.sharded_checkpoint.v1"


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint step failed integrity validation: torn or
    checksum-mismatched manifest, or a missing/garbled shard file. The
    restore path treats it like any other corruption — fall back to the
    next-older committed step."""


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` via a same-directory temp file +
    ``os.replace`` so a reader never observes a half-written file; fsync
    the file (and containing directory) so a committed marker survives a
    host crash, not just a process kill."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_manifest(step_dir: str, manifest: dict, *,
                   fsync: bool = True) -> str:
    """Serialize + atomically write ``manifest.json``; returns its sha256
    (what the commit marker will pin)."""
    data = json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8")
    atomic_write_bytes(os.path.join(step_dir, MANIFEST_NAME), data,
                       fsync=fsync)
    return sha256_bytes(data)


def write_commit(step_dir: str, manifest_sha256: str, step: int, *,
                 fsync: bool = True) -> None:
    """The LAST write of a save: once this atomic rename lands, the step
    is visible; before it, the directory is invisible debris."""
    data = json.dumps({"format": FORMAT_NAME, "step": int(step),
                       "manifest_sha256": manifest_sha256}).encode("utf-8")
    atomic_write_bytes(os.path.join(step_dir, COMMIT_NAME), data,
                       fsync=fsync)


def read_commit(step_dir: str) -> Optional[dict]:
    """The parsed commit marker, or None when absent/unparseable (an
    uncommitted or garbled directory — never adopted as a step)."""
    try:
        with open(os.path.join(step_dir, COMMIT_NAME), "rb") as f:
            marker = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    return marker if isinstance(marker, dict) else None


def load_manifest(step_dir: str, *, verify_commit: bool = True) -> dict:
    """Load + validate ``manifest.json`` of a committed step. With
    ``verify_commit`` the manifest bytes must hash to the sha256 the
    commit marker pinned — a torn/garbled manifest (even one damaged
    after commit) raises :class:`CheckpointCorruptionError`."""
    marker = read_commit(step_dir)
    if verify_commit and marker is None:
        raise CheckpointCorruptionError(
            f"{step_dir}: no readable commit marker (uncommitted or "
            f"garbled step)")
    path = os.path.join(step_dir, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorruptionError(
            f"{step_dir}: manifest unreadable: {e}") from e
    if verify_commit and marker is not None:
        want = marker.get("manifest_sha256")
        got = sha256_bytes(data)
        if want != got:
            raise CheckpointCorruptionError(
                f"{step_dir}: manifest sha256 {got[:12]}… does not match "
                f"commit marker {str(want)[:12]}… (torn manifest)")
    try:
        manifest = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorruptionError(
            f"{step_dir}: manifest is not valid JSON: {e}") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise CheckpointCorruptionError(
            f"{step_dir}: manifest has no 'leaves' table")
    return manifest


def validate_step_dir(step_dir: str, *, deep: bool = True) -> List[str]:
    """fsck one step directory; returns the list of problems (empty ⇒
    healthy). ``deep`` re-hashes every shard file against its manifest
    checksum; without it only presence + size are checked."""
    problems: List[str] = []
    if read_commit(step_dir) is None:
        return [f"no commit marker ({COMMIT_NAME} missing or garbled)"]
    try:
        manifest = load_manifest(step_dir)
    except CheckpointCorruptionError as e:
        return [str(e)]
    for path_key, leaf in sorted(manifest.get("leaves", {}).items()):
        for shard in leaf.get("shards", []):
            fname = shard.get("file", "?")
            fpath = os.path.join(step_dir, fname)
            if not os.path.isfile(fpath):
                problems.append(f"{path_key}: shard {fname} missing")
                continue
            size = os.path.getsize(fpath)
            if size != shard.get("bytes"):
                problems.append(
                    f"{path_key}: shard {fname} is {size} bytes, manifest "
                    f"says {shard.get('bytes')} (truncated?)")
                continue
            if deep and sha256_file(fpath) != shard.get("sha256"):
                problems.append(
                    f"{path_key}: shard {fname} sha256 mismatch "
                    f"(bit rot / torn write)")
    return problems


def list_step_dirs(root: str) -> Dict[int, str]:
    """``{step: dirname}`` for every integer-named child of ``root`` —
    committed or not; callers split on :func:`read_commit`."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        full = os.path.join(root, name)
        if os.path.isdir(full):
            try:
                out[int(name)] = name
            except ValueError:
                continue
    return out
