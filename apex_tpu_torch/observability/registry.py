"""The metrics registry: counters, gauges, bounded histograms, sinks.

The hub of :mod:`apex_tpu_torch.observability`. Producers (the resilience
driver's step loop, the retrace watchdog, span timers — some on other
threads) call :meth:`MetricsRegistry.inc` / :meth:`set_gauge` /
:meth:`observe` / :meth:`event`; consumers are pluggable sinks
(:mod:`apex_tpu_torch.observability.sinks`) that receive a stream of plain-dict
records:

- ``{"kind": "event", "event": <name>, "seq": n, "ts": <monotonic>,
  "wall": <epoch>, ...fields}`` — one per incident, emitted immediately;
- ``{"kind": "step", "step": i, ...}`` — one per training step
  (:class:`~apex_tpu_torch.observability.step_metrics.StepMetrics` builds these);
- ``{"kind": "counters"|"gauges"|"histograms", "wall": ...,
  "values": {...}}`` — full snapshots, emitted on :meth:`flush`.

Everything is host-side Python — nothing here touches a device, so it
is safe to call from watchdog threads and from inside the step loop. Histograms keep running aggregates
(count/sum/min/max) exactly plus a **bounded** ring buffer of recent
values for percentiles, so registry memory does not grow with step count.

A single re-entrant lock serializes state mutation *and* sink writes:
sinks need not be thread-safe, and a snapshot never interleaves with a
half-applied update. Like ``log_event``, every event carries a strictly
increasing ``seq`` plus monotonic ``ts`` and epoch ``wall`` stamps so
incidents totally order and correlate across hosts.

Copied from ``apex_tpu/observability/registry.py`` (stdlib only), so the
port never imports the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = ["MetricsRegistry", "HistogramSnapshot", "percentile"]


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile of ``values`` (need not be sorted).
    ``p`` in [0, 100]. Raises ValueError on an empty list."""
    if not values:
        raise ValueError("percentile of empty sequence")
    ordered = sorted(values)
    if p <= 0:
        return ordered[0]
    if p >= 100:
        return ordered[-1]
    # nearest-rank: smallest value with at least p% of the mass at or below
    rank = max(1, -(-int(p * len(ordered)) // 100))  # ceil(p*n/100)
    return ordered[rank - 1]


class HistogramSnapshot:
    """Immutable view of a histogram: exact running aggregates plus
    percentiles over the bounded ring of recent observations."""

    __slots__ = ("name", "count", "sum", "min", "max", "_recent")

    def __init__(self, name: str, count: int, total: float,
                 lo: float, hi: float, recent: List[float]):
        self.name = name
        self.count = count
        self.sum = total
        self.min = lo
        self.max = hi
        self._recent = recent

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def recent(self) -> List[float]:
        """The bounded window of recent observations (a copy) — what
        percentiles are computed over, and what
        :func:`~apex_tpu_torch.observability.fleet_metrics.merge_histograms`
        concatenates when combining per-replica snapshots."""
        return list(self._recent)

    def percentile(self, p: float) -> float:
        return percentile(self._recent, p)

    def as_dict(self) -> dict:
        d = {"count": self.count, "sum": self.sum,
             "min": self.min, "max": self.max, "mean": self.mean}
        if self._recent:
            d["p50"] = self.percentile(50)
            d["p95"] = self.percentile(95)
        return d


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "ring")

    def __init__(self, bound: int):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # percentiles come from a bounded window of recent values: memory
        # is O(bound) no matter how many steps a run observes
        self.ring: deque = deque(maxlen=bound)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.ring.append(value)

    def snapshot(self, name: str) -> HistogramSnapshot:
        return HistogramSnapshot(name, self.count, self.total,
                                 self.min, self.max, list(self.ring))


class MetricsRegistry:
    """Thread-safe counters/gauges/histograms with pluggable sinks.

    Args:
      sinks: initial sinks (see :mod:`apex_tpu_torch.observability.sinks`);
        more can be attached with :meth:`add_sink`.
      histogram_bound: ring-buffer size per histogram — the memory bound
        behind percentile estimates.
    """

    def __init__(self, sinks: Iterable = (), *, histogram_bound: int = 1024):
        self._lock = threading.RLock()
        self._sinks = list(sinks)
        self._histogram_bound = int(histogram_bound)
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}
        self._seq = 0

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    # -- producers ---------------------------------------------------------

    def declare_counters(self, *names: str) -> None:
        """Zero-initialize counters so snapshots carry every expected key
        even when an incident type never fires during the run."""
        with self._lock:
            for n in names:
                self._counters.setdefault(n, 0)

    def inc(self, name: str, n: int = 1) -> int:
        """Increment (and implicitly declare) a counter; returns the new
        value."""
        with self._lock:
            value = self._counters.get(name, 0) + int(n)
            self._counters[name] = value
            return value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the named bounded histogram."""
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = _Histogram(
                    self._histogram_bound)
            hist.observe(float(value))

    def event(self, name: str, **fields) -> dict:
        """Emit one incident record to every sink, stamped with
        ``seq``/``ts``/``wall`` (mirrors ``log_event``'s stamps so JSONL
        events and log lines correlate). Returns the record."""
        with self._lock:
            self._seq += 1
            record = {"kind": "event", "event": name, "seq": self._seq,
                      "ts": time.monotonic(), "wall": time.time(),
                      **fields}
            self._write(record)
            return record

    def emit_record(self, record: dict) -> None:
        """Forward one pre-built record to the sinks — the generic form
        behind :meth:`emit_step`; serving uses it for its per-request
        ``kind="request"`` rows."""
        with self._lock:
            self._write(record)

    def emit_step(self, record: dict) -> None:
        """Forward one per-step record (``kind="step"``) to the sinks."""
        self.emit_record(record)

    # -- consumers ---------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histogram(self, name: str) -> Optional[HistogramSnapshot]:
        with self._lock:
            hist = self._histograms.get(name)
            return None if hist is None else hist.snapshot(name)

    def histograms(self) -> Dict[str, HistogramSnapshot]:
        with self._lock:
            return {n: h.snapshot(n) for n, h in self._histograms.items()}

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        """Write counter/gauge/histogram snapshots to every sink and flush
        the sinks. Call at poll boundaries and at end of run — the final
        counters snapshot is what ``python -m apex_tpu_torch.monitor`` reconciles
        against ``TrainingResult.telemetry``."""
        with self._lock:
            wall = time.time()
            self._write({"kind": "counters", "wall": wall,
                         "values": dict(self._counters)})
            self._write({"kind": "gauges", "wall": wall,
                         "values": dict(self._gauges)})
            self._write({"kind": "histograms", "wall": wall,
                         "values": {n: h.snapshot(n).as_dict()
                                    for n, h in self._histograms.items()}})
            for sink in self._sinks:
                sink.flush()

    def close(self) -> None:
        """Flush, then close every attached sink."""
        with self._lock:
            self.flush()
            for sink in self._sinks:
                sink.close()

    def _write(self, record: dict) -> None:
        for sink in self._sinks:
            sink.write(record)
