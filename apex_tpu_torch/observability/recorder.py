"""Flight recorder: bounded rings of recent telemetry + incident
postmortem bundles.

The observability plane (registry -> sinks -> monitor) can say *that*
an incident happened — counters and event streams reconcile key-for-key
— but by the time a counter moves, the surrounding evidence (the last
few hundred events, the signal trajectory, each replica's slot/page
state, the in-flight request cursors) is gone. The
:class:`FlightRecorder` keeps exactly that evidence, always, at
near-zero cost: it is a registry **sink** (attach it with
``registry.add_sink``) holding three bounded ``deque`` rings — recent
``kind="event"`` records, recent ``kind="gauge_snapshot"`` samples, and
recent typed records (requests, spans, autoscale/deploy decisions,
anomalies). Memory is O(capacity) no matter how long the run is.

When an **incident-class** event flows through the sink — any event
named in :data:`TRIGGER_EVENTS`: quarantines, engine restarts, breaker
opens, deploy rollbacks, retraces, sentinel anomalies — the recorder
:meth:`dump`\\ s a self-contained JSON postmortem bundle: the trigger
record, the full ring contents, a per-replica engine digest (slot
table, PagePool stats, in-flight request cursors), the last signals
snapshot, the live counter totals, and a config fingerprint. The
bundle lands next to the run log (``bundle_dir``) and is rendered by
``python -m apex_tpu_torch.monitor bundle <path>``. ``max_bundles`` (default
1) latches the dump — the FIRST incident is the evidence worth
keeping; later incidents are usually its consequences.

The dump emits a ``bundle_dumped`` event co-sited with a
``bundles_dumped`` counter increment and a ``kind="bundle"`` record, so
the monitor's bundle section reconciles key-for-key like every other
incident class. ``bundle_dumped`` is deliberately NOT a trigger.

:data:`TRIGGER_EVENTS` is built **by construction** from the monitor's
``*_INCIDENT_COUNTERS`` maps (plus the recorder-only extras below), and
the APX013 lint rule re-checks the inclusion tree-wide: an incident
class the monitor reconciles but the recorder would sleep through is a
lint error, not a 3 a.m. surprise.

Wall stamps go through the serving clock seam
(:mod:`apex_tpu_torch.serving.clock`, imported lazily to keep this module
stdlib-importable), so bundles are deterministic under
``VirtualClock``. Everything here is host-side and defensive: a dump
failure degrades to a logged error — telemetry must never take the
serving path down.

Copied from ``apex_tpu/observability/recorder.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

from apex_tpu_torch.observability.report import (
    CHECKPOINT_INCIDENT_COUNTERS,
    FLEET_INCIDENT_COUNTERS,
    SENTINEL_INCIDENT_COUNTERS,
    SERVING_INCIDENT_COUNTERS,
)
from apex_tpu_torch.utils.logging import get_logger

__all__ = ["FlightRecorder", "TRIGGER_EVENTS", "RECORDER_TRIGGER_EXTRAS"]

_LOG = get_logger(__name__)

#: incident-class triggers that have no ``*_INCIDENT_COUNTERS`` entry:
#: ``retrace`` is deliberately outside the strict one-inc-per-event
#: mapping (a batched cache-size jump can cover several compiles), yet a
#: serving recompile is exactly the incident a bundle should survive.
RECORDER_TRIGGER_EXTRAS = frozenset({"retrace"})

#: every event name that triggers a postmortem dump — the union of the
#: monitor's incident maps (kept in lockstep by APX013 and its lock
#: test) plus :data:`RECORDER_TRIGGER_EXTRAS`. ``bundle_dumped`` must
#: never appear here: a dump must not trigger a dump.
TRIGGER_EVENTS = frozenset(
    set(SERVING_INCIDENT_COUNTERS)
    | set(FLEET_INCIDENT_COUNTERS)
    | set(CHECKPOINT_INCIDENT_COUNTERS)
    | set(SENTINEL_INCIDENT_COUNTERS)
    | RECORDER_TRIGGER_EXTRAS)

#: flush-snapshot kinds — retained last-wins, never ring-buffered (one
#: snapshot can be large; the ring holds the *stream*, not the state)
_SNAPSHOT_KINDS = ("counters", "gauges", "histograms")

_CLOCK = None


def _wall() -> float:
    """Epoch stamp through the serving clock seam — imported lazily so
    this module stays importable without torch (the monitor reads
    bundles on hosts far from the card that wrote them)."""
    global _CLOCK
    if _CLOCK is None:
        from apex_tpu_torch.serving import clock as _CLOCK  # noqa: F811
    return _CLOCK.wall()


def _safe(fn, default=None):
    """Evaluate a digest thunk defensively: postmortem evidence is
    best-effort by contract — a half-torn engine mid-incident must not
    make the dump itself raise."""
    try:
        return fn()
    except Exception:
        return default


class FlightRecorder:
    """Bounded-ring telemetry recorder + incident bundle dumper.

    Args:
      events_capacity / records_capacity / gauges_capacity: ring sizes
        (``deque(maxlen=...)``) for event records, typed records, and
        ``kind="gauge_snapshot"`` samples respectively.
      max_bundles: dump latch — at most this many bundles per recorder
        lifetime (default 1: the first incident is the postmortem).
      bundle_dir: where bundle files land (created on demand); ``None``
        keeps bundles in memory only (:attr:`bundles`).
      bundle_prefix: filename stem — bundles are named
        ``<prefix>-bundle-<n>.json`` (deterministic: no timestamp).
      triggers: override :data:`TRIGGER_EVENTS` (tests; production code
        should extend the incident maps instead so APX013 sees it).

    Use: ``registry.add_sink(recorder)`` then
    ``recorder.attach(fleet_or_supervisor, registry)``. The registry's
    re-entrant lock makes the in-``write`` dump safe: the recorder reads
    registry state and emits the bundle record from the same thread that
    holds the lock.
    """

    def __init__(self, *, events_capacity: int = 256,
                 records_capacity: int = 256,
                 gauges_capacity: int = 64,
                 max_bundles: int = 1,
                 bundle_dir: Optional[str] = None,
                 bundle_prefix: str = "flight",
                 triggers: Optional[frozenset] = None):
        for knob, value in (("events_capacity", events_capacity),
                            ("records_capacity", records_capacity),
                            ("gauges_capacity", gauges_capacity)):
            if value < 1:
                raise ValueError(f"{knob} must be >= 1, got {value}")
        if max_bundles < 0:
            raise ValueError(
                f"max_bundles must be >= 0, got {max_bundles}")
        self.events: deque = deque(maxlen=int(events_capacity))
        self.records: deque = deque(maxlen=int(records_capacity))
        self.gauge_snapshots: deque = deque(maxlen=int(gauges_capacity))
        self.max_bundles = int(max_bundles)
        self.bundle_dir = bundle_dir
        self.bundle_prefix = bundle_prefix
        self.triggers = (TRIGGER_EVENTS if triggers is None
                         else frozenset(triggers))
        #: dumped bundle dicts, in order (bounded by ``max_bundles``)
        self.bundles: List[dict] = []
        #: file paths of dumped bundles (empty when ``bundle_dir=None``)
        self.bundle_paths: List[str] = []
        self._target: Any = None
        self._registry: Any = None
        self._last_signals: Optional[dict] = None
        self._last_snapshots: Dict[str, dict] = {}
        self._dumping = False

    def attach(self, target, registry=None) -> "FlightRecorder":
        """Point the recorder at the serving object whose state a dump
        digests (a ``ReplicaFleet`` or an ``EngineSupervisor``) and the
        registry it reconciles through. Returns ``self`` for chaining."""
        self._target = target
        self._registry = registry
        if registry is not None:
            registry.declare_counters("bundles_dumped")
        return self

    # -- the sink protocol -------------------------------------------------

    def write(self, record: dict) -> None:
        kind = record.get("kind")
        if kind == "event":
            self.events.append(record)
            if (record.get("event") in self.triggers
                    and not self._dumping
                    and len(self.bundles) < self.max_bundles):
                self.dump(record)
        elif kind == "gauge_snapshot":
            self.gauge_snapshots.append(record)
            if isinstance(record.get("signals"), dict):
                self._last_signals = record["signals"]
        elif kind == "signals":
            if isinstance(record.get("values"), dict):
                self._last_signals = record["values"]
        elif kind in _SNAPSHOT_KINDS:
            self._last_snapshots[kind] = record.get("values", {})
        else:
            self.records.append(record)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # -- the dump ----------------------------------------------------------

    def dump(self, trigger: Optional[dict] = None) -> Optional[dict]:
        """Write one self-contained postmortem bundle. Called
        automatically from :meth:`write` on a trigger event; callable
        directly (``trigger=None``) for an on-demand snapshot. Never
        raises — a failed dump is a logged error, not an outage."""
        self._dumping = True
        try:
            bundle = self._build_bundle(trigger)
            self.bundles.append(bundle)
            path = None
            if self.bundle_dir is not None:
                path = os.path.join(
                    self.bundle_dir,
                    f"{self.bundle_prefix}-bundle-"
                    f"{len(self.bundles)}.json")
                os.makedirs(self.bundle_dir, exist_ok=True)
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(bundle, f, indent=2, sort_keys=True,
                              default=str)
                    f.write("\n")
                bundle["path"] = path
                self.bundle_paths.append(path)
            if self._registry is not None:
                # one counter increment co-sited with its event and the
                # typed record — the reconcile contract every other
                # incident class already follows
                self._registry.inc("bundles_dumped")
                trigger_name = (trigger or {}).get("event")
                self._registry.event("bundle_dumped",
                                     trigger=trigger_name, path=path)
                self._registry.emit_record({
                    "kind": "bundle", "bundle_seq": len(self.bundles),
                    "trigger": trigger_name, "path": path,
                    "events": len(bundle.get("events", ())),
                    "wall": bundle.get("wall")})
            return bundle
        except Exception:
            _LOG.exception("flight recorder dump failed")
            return None
        finally:
            self._dumping = False

    def _build_bundle(self, trigger: Optional[dict]) -> dict:
        counters = None
        if self._registry is not None:
            counters = _safe(self._registry.counters)
        if counters is None:
            counters = self._last_snapshots.get("counters", {})
        return {
            "schema": 1,
            "kind": "flight_bundle",
            "wall": _wall(),
            "trigger": dict(trigger) if trigger else None,
            "capacities": {
                "events": self.events.maxlen,
                "records": self.records.maxlen,
                "gauge_snapshots": self.gauge_snapshots.maxlen},
            "events": [dict(r) for r in self.events],
            "records": [dict(r) for r in self.records],
            "gauge_snapshots": [dict(r) for r in self.gauge_snapshots],
            "signals": self._last_signals,
            "counters": counters,
            "replicas": _safe(lambda: _target_digest(self._target), []),
            "config": _safe(lambda: _config_fingerprint(self._target)),
        }


# -- digests ---------------------------------------------------------------


def _target_digest(target) -> List[dict]:
    """Per-replica engine digests of a fleet (or the single digest of a
    bare supervisor). Every field is best-effort: a replica mid-rebuild
    digests to whatever is still reachable."""
    if target is None:
        return []
    if hasattr(target, "replicas"):
        out = []
        for replica in list(target.replicas):
            d = _replica_digest(replica.supervisor)
            d["replica_id"] = _safe(lambda r=replica: r.replica_id)
            d["state"] = _safe(lambda r=replica: r.state)
            d["dispatches"] = _safe(lambda r=replica: r.dispatches)
            out.append(d)
        return out
    return [_replica_digest(target)]


def _replica_digest(sup) -> dict:
    """One supervised engine's postmortem digest: breaker/restart
    state, queue/slot cursors, the slot table and PagePool stats, and
    every in-flight request's position."""
    d = {
        "breaker": _safe(lambda: sup.breaker_state),
        "restarts": _safe(lambda: sup.restarts),
        "queued": _safe(lambda: sup.queued_count),
        "active": _safe(lambda: sup.active_count),
        "inflight": _safe(lambda: sup.inflight_count),
        "queued_prompt_tokens": _safe(
            lambda: sup.queued_prompt_tokens),
        "service_estimate_s": _safe(lambda: sup.service_estimate_s),
    }
    engine = getattr(sup, "engine", None)
    if engine is None:
        return d
    d["compiles"] = {
        "prefill": _safe(lambda: engine.prefill_compiles),
        "decode": _safe(lambda: engine.decode_compiles),
        "chunk": _safe(lambda: engine.chunk_compiles),
        "decode_retraces": _safe(lambda: engine.decode_retraces),
    }
    slots = getattr(engine, "slots", None)
    if slots is not None:
        d["slots"] = {
            "free": _safe(lambda: slots.free_count),
            "active": _safe(lambda: slots.active_count),
            "occupancy": _safe(lambda: slots.occupancy),
        }
    pages = getattr(engine, "pages", None)
    if pages is not None:
        d["pages"] = {
            "free": _safe(lambda: pages.free_count),
            "in_use": _safe(lambda: pages.in_use_count),
            "owned": _safe(lambda: pages.owned_count),
            "reclaimable": _safe(lambda: pages.reclaimable_count),
            "interned": _safe(lambda: pages.interned_count),
            "occupancy": _safe(lambda: pages.occupancy),
            "evictions": _safe(lambda: pages.evictions),
        }
    d["requests"] = _safe(lambda: [
        {"request_id": _safe(lambda r=req: r.request_id),
         "trace_id": _safe(lambda r=req: r.trace_id),
         "adapter_id": _safe(
             lambda r=req: r.sampling.adapter_id),
         "generated": len(tokens),
         "submit_ts": submit_ts}
        for req, tokens, submit_ts in engine.inflight()], [])
    return d


def _config_fingerprint(target) -> Optional[dict]:
    """A JSON-able identity card for the serving configuration under
    incident — enough to answer "was the postmortem's fleet built like
    production's?" without shipping weights."""
    if target is None:
        return None
    import dataclasses
    import hashlib

    def _cfg(obj) -> Optional[dict]:
        if obj is None:
            return None
        if dataclasses.is_dataclass(obj):
            out = {}
            for f in dataclasses.fields(obj):
                value = getattr(obj, f.name, None)
                if dataclasses.is_dataclass(value):
                    value = _cfg(value)
                elif not isinstance(value, (int, float, str, bool,
                                            type(None))):
                    value = str(value)
                out[f.name] = value
            return out
        return {"repr": str(obj)}

    card = {
        "engine": _cfg(getattr(target, "config", None)),
        "supervisor": _cfg(getattr(target, "supervisor_config", None)
                           or getattr(target, "_config", None)),
        "fleet": _cfg(getattr(target, "fleet", None)),
    }
    blob = json.dumps(card, sort_keys=True, default=str)
    card["fingerprint"] = hashlib.sha256(
        blob.encode("utf-8")).hexdigest()[:16]
    return card
