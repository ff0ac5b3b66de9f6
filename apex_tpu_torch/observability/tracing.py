"""Span tracing + on-demand profiler capture (counterpart of
``apex_tpu/observability/tracing.py``).

Two pieces on top of :mod:`apex_tpu_torch.utils.profiling`:

- :func:`span` — a named scope that *also* records its host-side wall
  duration into a registry histogram (``span/<name>_s``). The scope is an
  NVTX range and a ``torch.profiler`` scope underneath, so one annotation
  shows up both in the profiler timeline and in the run's own metrics.
- :class:`ProfilerCapture` — windowed ``torch.profiler`` trace capture a
  training driver can drive: start every N steps and stop
  ``capture_steps`` later, and/or start on a watchdog incident — so when
  a run goes sideways there is a trace of the bad window without having
  profiled the whole run.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from apex_tpu_torch.utils.logging import get_logger, log_event
from apex_tpu_torch.utils.profiling import nvtx_range, profiler_start, profiler_stop

__all__ = ["span", "ProfilerCapture"]


def span(name: str, registry):
    """``with span("fwd", reg):`` — :func:`~apex_tpu_torch.utils.profiling.
    nvtx_range` with the registry wired in: the enclosed host wall time
    is observed into the ``span/<name>_s`` histogram."""
    return nvtx_range(name, registry=registry)


class ProfilerCapture:
    """Start/stop ``torch.profiler`` traces on a schedule or on demand.

    The driver calls :meth:`on_step` after every completed step and
    :meth:`on_incident` when the watchdog fires; each capture lands in
    its own subdirectory ``<log_dir>/step<N>_<reason>`` (TensorBoard-
    readable).

    Args:
      log_dir: root directory for capture subdirectories.
      every_n_steps: start a capture when ``step % N == 0`` (None: only
        on demand/incident).
      capture_steps: steps per capture window before auto-stop.
      capture_on_incident: start a capture from :meth:`on_incident`.
      max_captures: total capture budget for the run (trace files are
        big; an unhealthy run must not fill the disk).
      registry: optional — capture start/stop emit registry events and a
        ``profiler_captures`` counter.
      start_fn / stop_fn: injectable trace hooks (default
        ``torch.profiler`` via :mod:`apex_tpu_torch.utils.profiling`);
        tests substitute stubs.
    """

    def __init__(self, log_dir: str, *, every_n_steps: Optional[int] = None,
                 capture_steps: int = 2, capture_on_incident: bool = True,
                 max_captures: int = 4, registry=None,
                 start_fn: Callable[[str], None] = profiler_start,
                 stop_fn: Callable[[], None] = profiler_stop,
                 logger=None):
        self.log_dir = os.fspath(log_dir)
        self.every_n_steps = every_n_steps
        self.capture_steps = int(capture_steps)
        self.capture_on_incident = capture_on_incident
        self.max_captures = int(max_captures)
        self.registry = registry
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._log = logger or get_logger(__name__)
        self.captures = 0
        self.active = False
        self._stop_at: Optional[int] = None

    def on_step(self, step: int) -> None:
        """Advance the schedule at completed step ``step`` (1-based)."""
        if self.active:
            if self._stop_at is not None and step >= self._stop_at:
                self.stop(step)
        elif (self.every_n_steps
                and step % self.every_n_steps == 0):
            self.start(step, reason="interval")

    def on_incident(self, reason: str, step: int) -> None:
        """Watchdog hook: capture the aftermath of an incident."""
        if self.capture_on_incident and not self.active:
            self.start(step, reason=reason)

    def start(self, step: int, reason: str = "manual") -> bool:
        """Begin a capture window; returns False when already active or
        the capture budget is spent."""
        if self.active or self.captures >= self.max_captures:
            return False
        target = os.path.join(self.log_dir, f"step{step}_{reason}")
        self._start_fn(target)
        self.active = True
        self.captures += 1
        self._stop_at = step + self.capture_steps
        log_event(self._log, "profiler_capture_start", step=step,
                  reason=reason, dir=target, level="info")
        if self.registry is not None:
            self.registry.inc("profiler_captures")
            self.registry.event("profiler_capture_start", step=step,
                                reason=reason, dir=target)
        return True

    def stop(self, step: Optional[int] = None) -> None:
        if not self.active:
            return
        self._stop_fn()
        self.active = False
        self._stop_at = None
        log_event(self._log, "profiler_capture_stop",
                  step=("?" if step is None else step), level="info")
        if self.registry is not None:
            self.registry.event("profiler_capture_stop",
                                step=(-1 if step is None else int(step)))
