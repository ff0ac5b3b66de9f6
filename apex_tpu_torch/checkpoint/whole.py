"""Whole-state checkpoints on ``torch.save``.

Counterpart of ``apex_tpu/checkpoint/_orbax.py``, with its API
(:func:`save_checkpoint`, :func:`load_checkpoint`,
:class:`CheckpointManager`). The JAX package writes this format with
orbax; the port writes the whole state tree, moved to the CPU, with
``torch.save`` into one ``state.pt`` a step. ``ResilienceConfig.
checkpoint_format="orbax"`` selects it in both packages, so one config
means the same thing in either; the files are each package's own.

A step is written into an uncommitted ``<step>.orbax-checkpoint-tmp-<n>``
directory and committed by one ``os.replace`` onto ``<step>``, so a save
killed midway leaves debris that :meth:`CheckpointManager.
uncommitted_steps` lists and :meth:`CheckpointManager.cleanup_partial`
removes, as orbax's do. A restore reads the file with
``torch.load(weights_only=True)``, checks every leaf against the
template (present, same shape), and only then copies each into the
template's tensors in place.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch

from apex_tpu_torch.checkpoint.sharded import _tensor_items

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "CheckpointManager",
]

STATE_FILE = "state.pt"
_TMP_MARK = ".orbax-checkpoint-tmp"


def _payload(state: Any) -> dict:
    """``{"leaves": {path: CPU tensor}}`` in :func:`tree_items` order."""
    return {"leaves": {key: leaf.detach().to("cpu", copy=True)
                       for key, leaf in _tensor_items(state)}}


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path: str, state: Any) -> None:
    """Write ``state`` as the directory ``path``: into a temporary
    sibling first, committed by ``os.replace``."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=f"{name}{_TMP_MARK}-")
    try:
        target = os.path.join(tmp, STATE_FILE)
        with open(target, "wb") as f:
            torch.save(_payload(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read(path: str, template: Optional[Any]) -> Any:
    """The leaves of the step at ``path``; with ``template``, copied into
    its tensors in place once every leaf is checked."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    leaves: Dict[str, torch.Tensor] = payload["leaves"]
    if template is None:
        return leaves
    items = _tensor_items(template)
    for key, leaf in items:
        got = leaves.get(key)
        if got is None:
            raise ValueError(f"{path} has no leaf {key} — the template's "
                             f"structure differs from the saved state")
        if tuple(got.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(got.shape)} "
                             f"!= template shape {tuple(leaf.shape)}")
    with torch.no_grad():
        for key, leaf in items:
            leaf.copy_(leaves[key])
    return template


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Write ``state`` (a tree of tensors) to the directory ``path``; an
    existing one is replaced only under ``force``."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f"{path} exists (pass force=True to "
                                  f"replace it)")
        shutil.rmtree(path)
    _write(path, state)


def load_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Restore a checkpoint. With ``template`` (a tree of tensors) each
    leaf is copied into the template's tensor in place and the template
    returned; without it, ``{path: CPU tensor}`` keyed as
    ``jax.tree_util.keystr`` names the leaves."""
    return _read(os.path.abspath(os.fspath(path)), template)


class CheckpointManager:
    """Rotating step-indexed whole-state checkpoints with resume.

    ``save(step, state)`` / ``restore(template) -> (step, state) | None``;
    keeps the newest ``max_to_keep``.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """``force=True`` bypasses ``save_interval_steps`` gating — the
        emergency-save path. An existing step raises, as orbax's does."""
        if (not force and self.save_interval_steps > 1
                and step % self.save_interval_steps):
            return False
        path = self._step_dir(step)
        if os.path.exists(path):
            raise FileExistsError(f"step {step} already exists at {path}")
        _write(path, state)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Committed checkpoint steps, ascending: a step directory exists
        only once its ``os.replace`` landed."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return steps
        for name in names:
            if os.path.isdir(os.path.join(self.directory, name)):
                try:
                    steps.append(int(name))
                except ValueError:
                    continue
        return sorted(steps)

    def restore(self, template: Any):
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore_step(step, template)

    def restore_step(self, step: int, template: Any) -> Any:
        return _read(self._step_dir(step), template)

    def delete(self, step: int) -> None:
        path = self._step_dir(step)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        shutil.rmtree(path)

    def uncommitted_steps(self) -> List[int]:
        """Steps with leftover uncommitted write directories
        (``<step>.orbax-checkpoint-tmp-*`` debris of interrupted
        saves)."""
        return sorted(self._partial_dirs())

    def cleanup_partial(self, *, exclude=()) -> List[int]:
        """Delete uncommitted write directories; returns the steps whose
        debris was removed. Call only when no save is in flight."""
        skip = {int(s) for s in exclude}
        removed = []
        for step, name in sorted(self._partial_dirs().items()):
            if step in skip:
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
            removed.append(step)
        return removed

    def _partial_dirs(self) -> dict:
        out = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            head, sep, _ = name.partition(_TMP_MARK)
            if sep and os.path.isdir(os.path.join(self.directory, name)):
                try:
                    out[int(head)] = name
                except ValueError:
                    continue
        return out

    def wait_until_finished(self) -> None:
        """Saves here are synchronous."""

    def close(self) -> None:
        pass
