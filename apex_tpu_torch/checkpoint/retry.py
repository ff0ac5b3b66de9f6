"""Fault-tolerant, async-capable wrapper over a checkpoint manager.

Counterpart of ``apex_tpu/checkpoint/retry.py``, with its semantics.
:class:`RetryingCheckpointManager` wraps either the whole-state
:class:`~apex_tpu_torch.checkpoint.CheckpointManager` (``torch.save``) or
the :class:`~apex_tpu_torch.checkpoint.ShardedCheckpointManager`:

- ``save`` retries with exponential backoff — flaky storage must not
  kill a training run over a transient error;
- with a manager that ``supports_async`` (the sharded format's two-phase
  ``snapshot``/``write_snapshot`` split), a periodic save blocks the
  caller **only for the device->host snapshot**; serialization + fsync +
  checksum — and the whole retry loop around them — run on a single
  background writer thread (``ckpt-writer``). A forced (emergency) save
  first quiesces the writer deterministically: ``drain_on_force=True``
  waits for in-flight writes to commit, ``False`` abandons queued ones
  (the running write still completes — commit is atomic either way,
  never torn);
- ``restore_latest`` / ``restore_before`` treat a failed restore as a
  corrupt checkpoint and fall back to the next-older step (optionally
  deleting the corrupt one so it is never picked again); integrity
  failures the sharded format *detects* (checksum mismatch, torn
  manifest — :class:`CheckpointCorruptionError`) are counted separately
  as ``verify_failures``. The sharded restore verifies a whole step
  before it writes the live tensors, so a fallback starts from an
  untouched state;
- partial/uncommitted step directories left by failed or interrupted
  saves are swept (``manager.cleanup_partial``) after failed attempts
  and before every restore, so debris never accumulates and is never
  adopted as a step.

``before_save`` is a hook called as ``before_save(step)`` at the top of
every save *attempt* (on the writer thread for async saves); raising
from it fails that attempt. It exists for deterministic fault injection
(:class:`apex_tpu_torch.testing_faults.FaultInjector`) but any callable
works.

``telemetry`` counts every incident class; attach an
:class:`apex_tpu_torch.observability.MetricsRegistry` as ``metrics`` and
the same sites increment ``ckpt_<key>`` registry counters and emit
structured events, which ``python -m apex_tpu_torch.monitor`` reconciles
key-for-key (:data:`apex_tpu_torch.observability.report.
CHECKPOINT_INCIDENT_COUNTERS`).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

from apex_tpu_torch.checkpoint.manifest import CheckpointCorruptionError
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["RetryingCheckpointManager", "CheckpointSaveError"]


class CheckpointSaveError(RuntimeError):
    """A checkpoint save failed after exhausting its retry budget."""


class RetryingCheckpointManager:
    def __init__(self, manager, *, max_retries: int = 3,
                 backoff_base: float = 0.5, backoff_max: float = 8.0,
                 delete_corrupt: bool = True,
                 before_save: Optional[Callable[[int], None]] = None,
                 async_writes: bool = True, drain_on_force: bool = True,
                 metrics: Optional[Any] = None):
        self.manager = manager
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.delete_corrupt = bool(delete_corrupt)
        self.before_save = before_save
        self.drain_on_force = bool(drain_on_force)
        self.metrics = metrics
        self._async = bool(async_writes) and bool(
            getattr(manager, "supports_async", False))
        self._writer: Optional[ThreadPoolExecutor] = None
        self._futures: List[Tuple[int, Future]] = []
        self._futures_lock = threading.Lock()
        # the writer thread and the caller both count incidents
        self._telemetry_lock = threading.Lock()
        self.telemetry = {"save_attempts": 0, "save_retries": 0,
                          "save_failures": 0, "saves_abandoned": 0,
                          "restore_fallbacks": 0, "deleted_corrupt": 0,
                          "verify_failures": 0, "partials_cleaned": 0}

    # -- telemetry plumbing: one incident, two ledgers (+ the event) -------
    def _tick(self, key: str, n: int = 1) -> None:
        with self._telemetry_lock:
            self.telemetry[key] += n
        if self.metrics is not None:
            self.metrics.inc("ckpt_" + key, n)

    def _event(self, name: str, *, level: str = "warning",
               **fields) -> None:
        log_event(get_logger(__name__), name, level=level, **fields)
        if self.metrics is not None:
            self.metrics.event(name, **fields)

    def _observe(self, name: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value)

    # -- partial-directory sweep -------------------------------------------
    def _sweep_partials(self) -> None:
        """Remove uncommitted step directories (failed/interrupted-save
        debris). In-flight async steps are excluded — their directories
        are mid-write, not debris."""
        cleanup = getattr(self.manager, "cleanup_partial", None)
        if cleanup is None:
            return
        with self._futures_lock:
            inflight = [s for s, f in self._futures if not f.done()]
        try:
            removed = cleanup(exclude=inflight)
        except Exception:  # noqa: BLE001 — sweep must never mask the save
            return
        for step in removed:
            self._tick("partials_cleaned")
            self._event("checkpoint_partial_cleaned", step=step)

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Any, *, force: bool = False,
             raise_on_failure: bool = False) -> bool:
        """Save with retries. Returns True once a save is committed (sync
        path) or accepted by the background writer (async path), False
        when the step was gated by ``save_interval_steps`` or (with
        ``raise_on_failure=False``) every retry failed — a failed
        periodic save is logged and counted, not fatal; the caller keeps
        training and the next interval tries again.

        A ``force=True`` (emergency / rollback re-save) first quiesces
        the async writer per ``drain_on_force``, then writes
        synchronously — its outcome must be known before the caller
        exits."""
        if force:
            self.drain(abandon=not self.drain_on_force)
        if self._async and not force and not raise_on_failure:
            if not self.manager.should_save(step, force=False):
                return False
            t0 = time.monotonic()
            snap = self.manager.snapshot(state)
            self._observe("ckpt_snapshot_blocked_s", time.monotonic() - t0)
            if self._writer is None:
                self._writer = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            fut = self._writer.submit(self._attempts, step,
                                      lambda frc: self.manager.
                                      write_snapshot(step, snap, force=frc))
            with self._futures_lock:
                self._futures = [(s, f) for s, f in self._futures
                                 if not f.done()] + [(step, fut)]
            return True
        return self._attempts(step, self._sync_write(step, state, force),
                              raise_on_failure=raise_on_failure)

    def _sync_write(self, step: int, state: Any,
                    force: bool) -> Callable[[bool], Any]:
        def write(effective_force: bool):
            if effective_force:
                # the whole-state manager's force= only bypasses interval
                # gating — an existing step still raises. A forced
                # save (emergency, retry, re-save after rollback)
                # replaces it.
                try:
                    if step in self.manager.all_steps():
                        self.manager.delete(step)
                except Exception:  # noqa: BLE001
                    pass
            saved = self.manager.save(step, state, force=effective_force)
            # surface async write errors here, inside the retry loop
            self.manager.wait_until_finished()
            return saved
        return write

    def _attempts(self, step: int,
                  write: Callable[[bool], Any], *,
                  force: bool = True,
                  raise_on_failure: bool = False) -> bool:
        """The retry loop — shared verbatim between the sync path (caller
        thread) and the async path (background writer), so backoff,
        telemetry, and the injection hook behave identically."""
        delay = self.backoff_base
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            self._tick("save_attempts")
            try:
                if self.before_save is not None:
                    self.before_save(step)
                t0 = time.monotonic()
                result = write(force or attempt > 0)
                self._observe("ckpt_write_s", time.monotonic() - t0)
                return bool(result)
            except Exception as e:  # noqa: BLE001 — storage errors vary
                last_err = e
                self._sweep_partials()
                if attempt < self.max_retries:
                    self._tick("save_retries")
                    self._event("checkpoint_save_retry", step=step,
                                attempt=attempt, error=repr(e))
                    if delay > 0:
                        time.sleep(min(delay, self.backoff_max))
                    delay *= 2.0
        self._tick("save_failures")
        self._event("checkpoint_save_failed", step=step,
                    retries=self.max_retries, error=repr(last_err),
                    level="error")
        if raise_on_failure:
            raise CheckpointSaveError(
                f"checkpoint save at step {step} failed after "
                f"{self.max_retries} retries") from last_err
        return False

    # -- async writer lifecycle --------------------------------------------
    def drain(self, *, abandon: bool = False) -> None:
        """Quiesce the background writer deterministically. Default:
        block until every enqueued write has committed or exhausted its
        retries. ``abandon=True`` cancels writes still in the queue
        (counted as ``saves_abandoned``) and waits only for the one
        already running — whose commit stays atomic, so the step set
        after either mode is torn-free."""
        with self._futures_lock:
            futures = list(self._futures)
            self._futures = []
        remaining: List[Tuple[int, Future]] = []
        # cancel pass first: waiting on the running write before
        # cancelling would let the queue drain into the worker behind
        # our back, and nothing would be left to abandon
        for step, fut in futures:
            if abandon and fut.cancel():
                self._tick("saves_abandoned")
                self._event("checkpoint_save_abandoned", step=step)
            else:
                remaining.append((step, fut))
        for step, fut in remaining:
            try:
                fut.result()
            except Exception:  # noqa: BLE001 — counted inside _attempts
                pass

    @property
    def pending_saves(self) -> List[int]:
        """Steps currently enqueued on (or running in) the writer."""
        with self._futures_lock:
            return [s for s, f in self._futures if not f.done()]

    # -- restore -----------------------------------------------------------
    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any]]:
        """Restore the newest readable checkpoint, walking older on
        corruption. Returns ``(step, state)`` or None when nothing is
        restorable."""
        return self.restore_before(None, template)

    def restore_before(self, step_exclusive: Optional[int],
                       template: Any) -> Optional[Tuple[int, Any]]:
        """Like :meth:`restore_latest` but only considers steps strictly
        below ``step_exclusive`` — the rollback path's "newest checkpoint
        from before the poisoned window". Drains the async writer first
        (a pending save must either commit or fail before the step set
        is read) and sweeps uncommitted debris so it is never adopted."""
        self.drain()
        self.manager.wait_until_finished()
        self._sweep_partials()
        steps = self.manager.all_steps()
        if step_exclusive is not None:
            steps = [s for s in steps if s < step_exclusive]
        for step in reversed(steps):
            try:
                return step, self.manager.restore_step(step, template)
            except Exception as e:  # noqa: BLE001 — corruption is varied
                if isinstance(e, CheckpointCorruptionError):
                    # detected by the integrity layer (checksum / torn
                    # manifest), not just an unreadable blob
                    self._tick("verify_failures")
                    self._event("checkpoint_verify_failed", step=step,
                                error=str(e), level="error")
                self._tick("restore_fallbacks")
                self._event("checkpoint_restore_fallback", step=step,
                            error=repr(e))
                if self.delete_corrupt:
                    try:
                        self.manager.delete(step)
                        self._tick("deleted_corrupt")
                        self._event("checkpoint_deleted_corrupt",
                                    step=step)
                    except Exception:  # noqa: BLE001
                        pass  # unreadable AND undeletable: just skip it
        return None

    # -- lifecycle ---------------------------------------------------------
    def wait_until_finished(self) -> None:
        self.drain()
        self.manager.wait_until_finished()

    def close(self) -> None:
        self.drain()
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None
        self.manager.close()
