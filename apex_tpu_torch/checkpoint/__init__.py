"""Checkpoint / resume.

Counterpart of ``apex_tpu/checkpoint/``. Two on-disk formats behind one
manager protocol:

- :class:`CheckpointManager` — whole-state checkpoints, one
  ``torch.save`` file a step (``save_checkpoint``/``load_checkpoint``
  for one-shot paths), :mod:`apex_tpu_torch.checkpoint.whole`; the JAX
  package's counterpart is orbax-backed.
- :class:`ShardedCheckpointManager` — the sharded format of
  :mod:`apex_tpu_torch.checkpoint.sharded`, byte for byte the JAX
  package's: per-shard ``.npy`` files addressed by (param-path,
  global-shard-index), a JSON manifest with global shapes/specs/per-shard
  sha256, and a COMMIT marker written last via atomic rename. Saves
  split into ``snapshot`` (blocking device->host) and ``write_snapshot``
  (background-safe); restore verifies a whole step, then writes the
  template's tensors in place.

:class:`RetryingCheckpointManager` wraps either with retries,
corruption fallback, partial-directory cleanup, and — for the sharded
format — an async background writer (:mod:`apex_tpu_torch.checkpoint.
retry`). ``python -m apex_tpu_torch.checkpoint verify <dir>`` is the
offline fsck (:mod:`apex_tpu_torch.checkpoint.verify`).
"""

from apex_tpu_torch.checkpoint.manifest import (
    COMMIT_NAME,
    FORMAT_NAME,
    MANIFEST_NAME,
    CheckpointCorruptionError,
)
from apex_tpu_torch.checkpoint.retry import (
    CheckpointSaveError,
    RetryingCheckpointManager,
)
from apex_tpu_torch.checkpoint.sharded import (
    HostSnapshot,
    ShardedCheckpointManager,
)
from apex_tpu_torch.checkpoint.verify import StepReport, verify_directory
from apex_tpu_torch.checkpoint.whole import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "CheckpointManager",
    "ShardedCheckpointManager",
    "HostSnapshot",
    "RetryingCheckpointManager",
    "CheckpointSaveError",
    "CheckpointCorruptionError",
    "StepReport",
    "verify_directory",
    "MANIFEST_NAME",
    "COMMIT_NAME",
    "FORMAT_NAME",
]
