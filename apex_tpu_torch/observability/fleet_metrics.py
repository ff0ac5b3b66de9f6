"""Fleet telemetry plane: per-replica registry views + one merged
snapshot with live autoscaler signals.

A :class:`~apex_tpu_torch.serving.fleet.ReplicaFleet` shares ONE
:class:`~apex_tpu_torch.observability.MetricsRegistry` across its replicas,
which keeps the JSONL stream totally ordered and the global counters
reconcilable — but erases *which replica* a counter increment or
histogram observation came from. This module adds the split without
changing the global view:

- :class:`ReplicaRegistry` — the registry each replica's supervisor/
  engine is handed. Every producer call (``inc`` / ``set_gauge`` /
  ``observe`` / ``declare_counters``) lands on BOTH the replica-local
  state and the shared parent; record/event emission and ``flush`` are
  parent-only (one stream, one ``seq`` order, one final snapshot —
  byte-identical logs to the pre-split fleet).
- :class:`FleetMetrics` — the polled view over a fleet: merged
  counters/gauges/histograms (:func:`merge_histograms`),
  :meth:`FleetMetrics.signals` (goodput window, queue depth, p99
  TTFT/TPOT, slot and kv-page occupancy, per-adapter share — the exact
  dict the autoscaler consumes), and
  :meth:`FleetMetrics.write_prometheus` (the merged view in Prometheus
  textfile format, gauges labeled ``{replica="i"}``).

Everything here is host-side stdlib: polling the plane never touches a
device, a trace, or the decode program.
Copied from ``apex_tpu/observability/fleet_metrics.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, Optional

from apex_tpu_torch.observability.registry import (
    HistogramSnapshot,
    MetricsRegistry,
)
from apex_tpu_torch.observability.sinks import PrometheusTextfileSink

__all__ = ["ReplicaRegistry", "FleetMetrics", "merge_histograms"]

#: mirrors ``apex_tpu_torch.serving.FINISH_*`` as literals (this module must
#: import without torch/serving, same convention as slo.py)
_OK_REASONS = ("eos", "length")
_TERMINAL_REASONS = ("eos", "length", "cancelled", "timeout",
                     "rejected", "error")

_ADAPTER_COUNTER = re.compile(r"^adapter(\d+)_requests$")


class ReplicaRegistry(MetricsRegistry):
    """A per-replica view over a shared fleet registry.

    Producer calls update the local state AND forward to ``parent``;
    event/record emission, sink attachment, and flush/close delegate to
    the parent outright (single JSONL stream with the parent's ``seq``
    stamps; snapshots always render the PARENT's global state). Local
    ``counters()``/``gauges()``/``histograms()`` therefore read this
    replica's share — what :class:`FleetMetrics` merges.

    A view survives engine rebuilds (the fleet reuses it per replica
    id), so replica-local counters are cumulative over the replica's
    whole slot in the fleet, like the parent's.
    """

    def __init__(self, parent: MetricsRegistry, replica_id: int):
        super().__init__(sinks=(),
                         histogram_bound=parent._histogram_bound)
        self.parent = parent
        self.replica_id = replica_id

    def add_sink(self, sink) -> None:
        self.parent.add_sink(sink)

    def declare_counters(self, *names: str) -> None:
        super().declare_counters(*names)
        self.parent.declare_counters(*names)

    def inc(self, name: str, n: int = 1) -> int:
        super().inc(name, n)
        return self.parent.inc(name, n)

    def set_gauge(self, name: str, value: float) -> None:
        super().set_gauge(name, value)
        self.parent.set_gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        super().observe(name, value)
        self.parent.observe(name, value)

    def event(self, name: str, **fields) -> dict:
        return self.parent.event(name, **fields)

    def emit_record(self, record: dict) -> None:
        self.parent.emit_record(record)

    def flush(self) -> None:
        self.parent.flush()

    def close(self) -> None:
        self.parent.close()


def merge_histograms(snaps: Iterable[HistogramSnapshot],
                     name: str) -> HistogramSnapshot:
    """Combine per-replica snapshots of the same histogram: exact
    aggregates add (count/sum) or extremize (min/max); the percentile
    windows concatenate — so a merged p99 sees every replica's recent
    observations, not just the loudest replica's."""
    count, total = 0, 0.0
    lo, hi = float("inf"), float("-inf")
    recent: List[float] = []
    for s in snaps:
        count += s.count
        total += s.sum
        lo = min(lo, s.min)
        hi = max(hi, s.max)
        recent.extend(s.recent)
    return HistogramSnapshot(name, count, total, lo, hi, recent)


class FleetMetrics:
    """Polled telemetry view over a ``ReplicaFleet`` (duck-typed: any
    object with ``metrics``, ``replica_metrics``, ``replicas``,
    ``dispatch_set()`` and ``inflight_count``).

    :meth:`signals` is the autoscaler interface: a flat dict of live
    load signals recomputed on every poll, with a *windowed* goodput
    (terminal outcomes since the previous poll) so a scale-up decision
    reacts to what is happening now, not the run-lifetime average.
    """

    def __init__(self, fleet):
        self.fleet = fleet
        self._window_ok = 0         # terminal counts at the last poll
        self._window_terminal = 0
        self._window_ts = time.monotonic()   # when the window opened

    # -- merged views ------------------------------------------------------

    def replica_counters(self) -> Dict[int, Dict[str, int]]:
        """Per-LIVE-replica counter split: retired replica ids never
        appear here (or in :meth:`labeled_gauges`) — a scale-down removes
        the id from every per-replica view, it does not leave a ghost."""
        return {rid: reg.counters()
                for rid, reg in sorted(self.fleet.replica_metrics.items())}

    def _all_registries(self) -> Iterable[MetricsRegistry]:
        """Live AND retired replica views — what the merged (fleet-total)
        folds read, so scaling a replica away never un-counts the work it
        did: merged counters keep equaling the parent's for every
        replica-incremented key."""
        regs = list(self.fleet.replica_metrics.values())
        regs.extend(getattr(self.fleet, "retired_replica_metrics",
                            {}).values())
        return regs

    def merged_counters(self) -> Dict[str, int]:
        """Sum of the replica-local counters (retired replicas
        included). For every counter a replica increments this equals
        the parent's value; parent-only keys (``fleet_dispatches``,
        ``requests_shed_fleet``, ...) are absent here — the difference
        IS the fleet-level contribution."""
        merged: Dict[str, int] = {}
        for reg in self._all_registries():
            for name, value in reg.counters().items():
                merged[name] = merged.get(name, 0) + value
        return merged

    def merged_histograms(self) -> Dict[str, HistogramSnapshot]:
        per_replica: Dict[str, List[HistogramSnapshot]] = {}
        for reg in self._all_registries():
            for name, snap in reg.histograms().items():
                per_replica.setdefault(name, []).append(snap)
        return {name: merge_histograms(snaps, name)
                for name, snaps in sorted(per_replica.items())}

    def labeled_gauges(self) -> Dict[str, float]:
        """Per-replica gauges under Prometheus-style labels
        (``kv_pages_free{replica="1"}``) plus the parent's unlabeled
        (fleet-level / last-writer) gauges."""
        gauges: Dict[str, float] = dict(self.fleet.metrics.gauges())
        for rid, reg in sorted(self.fleet.replica_metrics.items()):
            for name, value in reg.gauges().items():
                gauges[f'{name}{{replica="{rid}"}}'] = value
        return gauges

    def labeled_histograms(self) -> Dict[str, HistogramSnapshot]:
        """The merged (fleet-wide, unlabeled) histograms plus each LIVE
        replica's own under ``name{replica="i"}`` labels — same labeling
        convention as :meth:`labeled_gauges`, so the Prometheus export
        carries both the fleet summary and the per-replica split of the
        same family (a drifting replica is visible next to the merged
        p99 that hides it)."""
        hists: Dict[str, HistogramSnapshot] = dict(
            self.merged_histograms())
        for rid, reg in sorted(self.fleet.replica_metrics.items()):
            for name, snap in reg.histograms().items():
                hists[f'{name}{{replica="{rid}"}}'] = snap
        return hists

    def snapshot(self) -> dict:
        """One merged, JSON-ready view: global counters (the parent's —
        replica sums plus fleet-level keys), the per-replica counter
        split, labeled gauges, and merged histogram summaries."""
        return {
            "counters": self.fleet.metrics.counters(),
            "replica_counters": {
                str(rid): c
                for rid, c in self.replica_counters().items()},
            "gauges": self.labeled_gauges(),
            "histograms": {name: snap.as_dict()
                           for name, snap
                           in self.merged_histograms().items()},
        }

    # -- the autoscaler interface -----------------------------------------

    def signals(self) -> dict:
        """The live signal dict the SLO-driven autoscaler polls
        (ROADMAP: train->serve loop). Derived entirely from the merged
        counters/histograms plus live queue/slot state — every value is
        recomputable from :meth:`snapshot`, which the acceptance test
        reconciles."""
        fleet = self.fleet
        counters = fleet.metrics.counters()
        hists = self.merged_histograms()
        ok = sum(counters.get(f"requests_{r}", 0) for r in _OK_REASONS)
        terminal = sum(counters.get(f"requests_{r}", 0)
                       for r in _TERMINAL_REASONS)
        window_ok = ok - self._window_ok
        window_terminal = terminal - self._window_terminal
        self._window_ok, self._window_terminal = ok, terminal
        now = time.monotonic()
        window_s = now - self._window_ts
        self._window_ts = now

        def _p99(name: str) -> Optional[float]:
            snap = hists.get(name)
            if snap is None or not snap.recent:
                return None
            return snap.percentile(99)

        replicas = list(fleet.replicas)
        # supervisor.queued_count folds in its restart backlog, so a
        # replica mid-restart still reports its waiting work
        queue_depth = sum(r.supervisor.queued_count for r in replicas)
        queue_depth += len(getattr(fleet, "_backlog", ()))
        # token-weighted backlog: the same prompt-token sum the
        # supervisor's admission surcharge prices, so the autoscaler can
        # tell a queue of long prompts from the same depth of short ones
        queued_tokens = sum(
            getattr(r.supervisor, "queued_prompt_tokens", 0)
            for r in replicas)
        active_slots = sum(r.supervisor.active_count for r in replicas)
        total_slots = len(replicas) * fleet.config.max_slots
        pages_in_use = pages_total = 0.0
        for reg in fleet.replica_metrics.values():
            gauges = reg.gauges()
            if "kv_pages_in_use" in gauges:
                pages_in_use += gauges["kv_pages_in_use"]
                pages_total += (gauges["kv_pages_in_use"]
                                + gauges.get("kv_pages_free", 0.0))
        adapter_requests = {
            f"adapter{m.group(1)}": value
            for name, value in counters.items()
            if (m := _ADAPTER_COUNTER.match(name)) and value}
        adapter_total = sum(adapter_requests.values())
        return {
            "replicas_total": len(replicas),
            "replicas_dispatchable": len(fleet.dispatch_set()),
            "inflight": fleet.inflight_count,
            "queue_depth": queue_depth,
            "queued_tokens": queued_tokens,
            "requests_submitted": counters.get("requests_submitted", 0),
            "requests_ok": ok,
            "requests_terminal": terminal,
            "goodput": ok / terminal if terminal else None,
            # an idle window is 0.0, never None/NaN: "nothing completed"
            # must rate-normalize cleanly in the autoscaler (which guards
            # on window_terminal before treating 0.0 as degradation)
            "goodput_window": (window_ok / window_terminal
                               if window_terminal else 0.0),
            "window_ok": window_ok,
            "window_terminal": window_terminal,
            "window_s": window_s,
            "ttft_p99_s": _p99("request_ttft_s"),
            "tpot_p99_s": _p99("request_tpot_s"),
            # speculative-decoding health over the recent window (None
            # when no engine speculates — absence, not a zero rate)
            "spec_accept_rate": (
                (lambda s: sum(s.recent) / len(s.recent)
                 if s is not None and s.recent else None)(
                     hists.get("spec_accept_rate"))),
            "slot_occupancy": (active_slots / total_slots
                               if total_slots else None),
            "kv_page_occupancy": (pages_in_use / pages_total
                                  if pages_total else None),
            # share of adapter-attributed arrivals per bank row — base
            # traffic has no per-adapter counter and is excluded from
            # the denominator
            "adapter_share": {
                name: value / adapter_total
                for name, value in sorted(adapter_requests.items())},
        }

    # -- export ------------------------------------------------------------

    def write_prometheus(self, path: str) -> None:
        """Render the merged view to ``path`` in Prometheus textfile
        format (atomic replace): global counters as ``_total``, labeled
        per-replica + fleet gauges, and histograms as label-aware
        summary families — the merged (unlabeled) series next to each
        replica's ``{replica="i"}`` split."""
        sink = PrometheusTextfileSink(path)
        wall = time.time()
        snap = self.snapshot()
        sink.write({"kind": "counters", "wall": wall,
                    "values": snap["counters"]})
        sink.write({"kind": "gauges", "wall": wall,
                    "values": snap["gauges"]})
        sink.write({"kind": "histograms", "wall": wall,
                    "values": {name: h.as_dict() for name, h
                               in self.labeled_histograms().items()}})
        sink.flush()
