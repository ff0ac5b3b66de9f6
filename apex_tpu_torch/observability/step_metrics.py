"""Per-step training metrics: wall time, throughput, MFU, memory
(counterpart of ``apex_tpu/observability/step_metrics.py``).

:class:`StepMetrics` feeds a
:class:`~apex_tpu_torch.observability.registry.MetricsRegistry` from a
training loop (the JAX package's resilience driver attaches it; the
port's driver comes with ROADMAP §1 item 5). It splits each step's
telemetry across the two moments the driver actually has the data:

- ``begin_step()`` / ``end_step(step)`` bracket the step call on the
  host. The wall interval is dispatch time plus whatever the device made
  the host wait for — in steady state (the dispatch queue full, which is
  how a healthy run behaves) it converges to true device step time
  without ever forcing a sync. Throughput (``tokens_per_s``) and MFU
  follow from the knobs below; the cards' ``torch.cuda.memory_stats``
  gauges refresh every ``memory_interval_steps``.
- ``record_polled(step, loss=..., ...)`` lands later, at the driver's
  watchdog poll boundary, when loss/grad-norm/skipped/loss-scale come
  back from the device in a batch. It joins them with the buffered wall
  timing and emits one ``kind="step"`` record per step to the sinks.

MFU = ``model_flops_per_step / step_time / peak_flops`` — model FLOPs
from :mod:`apex_tpu_torch.utils.flops`, peak from its card table (989
TFLOP/s bf16 on an H100) unless overridden (pass ``peak_flops``
explicitly on the CPU or unlisted hardware).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from apex_tpu_torch.utils.flops import peak_flops_per_chip
from apex_tpu_torch.utils.profiling import device_memory_stats

__all__ = ["StepTimer", "StepMetrics"]


class StepTimer:
    """Context manager timing one block into a histogram:
    ``with StepTimer(reg, "data_wait_s"): batch = next(it)``."""

    def __init__(self, registry, name: str,
                 clock: Callable[[], float] = time.perf_counter):
        self._registry = registry
        self.name = name
        self._clock = clock
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self.elapsed = self._clock() - self._t0
        self._registry.observe(self.name, self.elapsed)
        return False


class StepMetrics:
    """Feeds a registry with per-step timing/throughput/MFU/memory.

    Args:
      registry: the :class:`MetricsRegistry` to emit into.
      tokens_per_step: global tokens consumed per step — enables
        ``tokens_per_s``.
      model_flops_per_step: model FLOPs per step (see
        :mod:`apex_tpu_torch.utils.flops`) — enables ``model_tflops`` and,
        with a known peak, ``mfu``.
      peak_flops: per-card peak FLOP/s; defaults to the card table
        (None on the CPU — MFU then stays unset).
      memory_interval_steps: refresh the cards' memory gauges every N
        steps (0 disables; without a card nothing is emitted).
      clock: injectable monotonic clock, for deterministic tests.
    """

    def __init__(self, registry, *, tokens_per_step: Optional[int] = None,
                 model_flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 memory_interval_steps: int = 50,
                 clock: Callable[[], float] = time.perf_counter):
        self.registry = registry
        self.tokens_per_step = tokens_per_step
        self.model_flops_per_step = model_flops_per_step
        self.peak_flops = (peak_flops if peak_flops is not None
                           else peak_flops_per_chip())
        self.memory_interval_steps = int(memory_interval_steps)
        self._clock = clock
        self._t0: Optional[float] = None
        # wall timings buffered until the poll boundary delivers the
        # device-side values for the same step; bounded by the driver's
        # poll interval (entries are popped in record_polled)
        self._pending: Dict[int, dict] = {}

    # -- step-loop side ----------------------------------------------------

    def begin_step(self) -> None:
        self._t0 = self._clock()

    def end_step(self, step: int) -> None:
        """Record the wall interval for ``step`` (1-based, the value after
        the driver increments). No device sync happens here."""
        if self._t0 is None:
            return
        dt = self._clock() - self._t0
        self._t0 = None
        reg = self.registry
        reg.observe("step_time_s", dt)
        timing = {"step_time_s": dt}
        if dt > 0 and self.tokens_per_step:
            tps = self.tokens_per_step / dt
            reg.observe("tokens_per_s", tps)
            reg.set_gauge("tokens_per_s", tps)
            timing["tokens_per_s"] = tps
        if dt > 0 and self.model_flops_per_step:
            tflops = self.model_flops_per_step / dt / 1e12
            reg.set_gauge("model_tflops", tflops)
            timing["model_tflops"] = tflops
            if self.peak_flops:
                mfu = self.model_flops_per_step / dt / self.peak_flops
                reg.observe("mfu", mfu)
                reg.set_gauge("mfu", mfu)
                timing["mfu"] = mfu
        self._pending[step] = timing
        if (self.memory_interval_steps
                and step % self.memory_interval_steps == 0):
            self.record_memory()

    def record_memory(self) -> None:
        """Gauge ``memory/device<i>/<stat>`` from each card's
        ``torch.cuda.memory_stats`` (a host-side query, not a sync); a
        no-op without a card."""
        if not torch.cuda.is_available():
            return
        for i in range(torch.cuda.device_count()):
            stats = device_memory_stats(i)
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"):
                if key in stats:
                    self.registry.set_gauge(f"memory/device{i}/{key}",
                                            stats[key])

    # -- poll-boundary side ------------------------------------------------

    def record_polled(self, step: int, *, loss: Optional[float] = None,
                      grad_norm: Optional[float] = None,
                      skipped: bool = False,
                      loss_scale: Optional[float] = None) -> dict:
        """Join device-side values for ``step`` with its buffered wall
        timing and emit the per-step record. Returns the record."""
        record = {"kind": "step", "step": int(step),
                  **self._pending.pop(step, {})}
        reg = self.registry
        if loss is not None:
            record["loss"] = float(loss)
            reg.set_gauge("loss", float(loss))
            if not skipped and loss == loss:  # finite-ish: NaN != NaN
                reg.observe("loss", float(loss))
        if grad_norm is not None:
            record["grad_norm"] = float(grad_norm)
            if not skipped and grad_norm == grad_norm:
                reg.observe("grad_norm", float(grad_norm))
        if loss_scale is not None:
            record["loss_scale"] = float(loss_scale)
            reg.set_gauge("loss_scale", float(loss_scale))
        record["skipped"] = bool(skipped)
        reg.emit_step(record)
        return record
