"""Run reports from JSONL metric logs — the ``apex_tpu_torch.monitor`` backend.

Reads the record stream a :class:`~apex_tpu_torch.observability.sinks.JsonlSink`
wrote during a run and folds it into one report dict / text page:

- **counter totals** — the last ``kind="counters"`` snapshot. For a run
  driven by :func:`apex_tpu_torch.resilience.run_training` these reconcile
  *exactly* with ``TrainingResult.telemetry`` (the driver increments both
  from the same sites and flushes a final snapshot on exit).
- **step statistics** — p50/p95/mean step time, tokens/s, MFU over the
  per-step records, plus a trajectory (windowed means) so throughput
  regressions over the run are visible at a glance.
- **incident timeline** — every ``kind="event"`` record (skips,
  rollbacks, retraces, preemptions, resumes, captures) in ``seq`` order.
- **serving requests** — the ``kind="request"`` rows a
  :class:`~apex_tpu_torch.serving.InferenceEngine` emits per terminal request:
  count and finish-reason split (these reconcile exactly with the
  engine's ``requests_*`` counters), plus queue/prefill/decode/total
  latency quantiles and per-request tokens/s.
- **serving incidents** — the supervisor/quarantine event stream
  (engine restarts, recovered requests, quarantined slots, breaker
  transitions, shed requests): per-type counts that reconcile
  key-for-key with the registry counters
  (:data:`SERVING_INCIDENT_COUNTERS` names the mapping; the tier-1
  serving-resilience tests assert it).
- **checkpoint incidents** — the retrying checkpoint manager's event
  stream (save retries/failures, restore fallbacks, checksum verify
  failures, partial-dir cleanups, abandoned async writes): per-type
  counts reconciling key-for-key with the ``ckpt_*`` counters
  (:data:`CHECKPOINT_INCIDENT_COUNTERS`), plus snapshot-blocked-time
  and write-duration histogram summaries.
- **SLO verdict** — when the log carries a ``kind="scenario"`` record
  with a declared ``"slo"`` section (what the loadtest runner embeds),
  or when the caller passes a spec (``--slo spec.json``), the report
  scores the run with :mod:`apex_tpu_torch.observability.slo`: per-objective
  measured-vs-threshold lines and an overall PASS/FAIL.

Readers are defensive by contract: run logs outlive the writers that
produced them, so records missing newer fields (a pre-TTFT request row,
a step row without ``step``) must degrade to "no data" — never raise.

Pure stdlib on purpose: no torch import, so the CLI works on a laptop far
away from the card that wrote the log.

Copied from ``apex_tpu/observability/report.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from apex_tpu_torch.observability.registry import percentile
from apex_tpu_torch.observability.slo import (
    SLOSpec,
    evaluate_slos,
    measure_slo_metrics,
)
from apex_tpu_torch.observability.trace import (
    build_timelines,
    check_span_conservation,
    format_timeline,
)

__all__ = ["read_records", "build_report", "render_report", "main",
           "SERVING_INCIDENT_COUNTERS", "SERVING_SHED_COUNTERS",
           "FLEET_INCIDENT_COUNTERS", "CHECKPOINT_INCIDENT_COUNTERS",
           "DEPLOY_ACTION_COUNTERS", "AUTOSCALE_ACTION_COUNTERS",
           "SENTINEL_INCIDENT_COUNTERS", "render_bundle"]

#: number of windows in the throughput/MFU trajectory
_TRAJECTORY_WINDOWS = 5

#: serving incident event -> registry counter: each event in the stream
#: is counted by exactly one increment of its counter at the same site,
#: so the report's per-type event counts reconcile key-for-key with the
#: final counter snapshot
SERVING_INCIDENT_COUNTERS = {
    "engine_restart": "engine_restarts",
    "tick_failure": "tick_failures",
    "slot_quarantined": "slots_quarantined",
    "request_recovered": "requests_recovered",
    "breaker_open": "breaker_opens",
    "breaker_half_open": "breaker_half_opens",
    "breaker_closed": "breaker_closes",
    # priority preemption (PR 20): a park and its token-exact resume
    # are each one event + one counter increment at the same site
    "request_preempted": "requests_preempted",
    "request_resumed": "requests_resumed",
}

#: ``request_shed`` events carry a ``reason`` field; each reason maps to
#: its own counter
SERVING_SHED_COUNTERS = {
    "breaker": "requests_shed_breaker",
    "deadline": "requests_shed_deadline",
    "fleet": "requests_shed_fleet",
    "pages_exhausted": "requests_shed_pages",
    "unknown_adapter": "requests_shed_adapter",
    "quota": "requests_shed_quota",
}

#: fleet incident event -> registry counter — same one-increment-per-
#: event contract as :data:`SERVING_INCIDENT_COUNTERS`, so the monitor's
#: fleet section reconciles key-for-key with the counter snapshot
FLEET_INCIDENT_COUNTERS = {
    "replica_drain": "replica_drains",
    "replica_rebuild": "replica_rebuilds",
    "request_migrated": "requests_migrated",
    # autoscaling + continuous deployment (PR 16)
    "replica_scale_up": "replica_scale_ups",
    "replica_scale_down": "replica_scale_downs",
    "deploy_start": "deploys_started",
    "deploy_complete": "deploys_completed",
    "deploy_rollback": "deploys_rolled_back",
    "deploy_rejected": "deploys_rejected",
    "canary_promoted": "canary_promotions",
    # brownout ladder + per-tenant quotas (PR 20)
    "brownout_escalate": "brownouts_escalated",
    "brownout_recover": "brownouts_recovered",
    "request_quota_deferred": "requests_deferred_quota",
}

#: ``kind="deploy"`` record action -> registry counter — each typed
#: deploy record is emitted at the same site as its counter increment
#: and event, so the monitor's deployments section reconciles
#: key-for-key with both the counter snapshot and the event timeline
DEPLOY_ACTION_COUNTERS = {
    "start": "deploys_started",
    "canary_pass": "canary_promotions",
    "rollback": "deploys_rolled_back",
    "complete": "deploys_completed",
    "rejected": "deploys_rejected",
}

#: ``kind="autoscale"`` record action -> registry counter (same
#: co-emission contract as :data:`DEPLOY_ACTION_COUNTERS`)
AUTOSCALE_ACTION_COUNTERS = {
    "scale_up": "replica_scale_ups",
    "scale_down": "replica_scale_downs",
}

#: checkpoint incident event -> registry counter, the
#: :class:`apex_tpu_torch.checkpoint.RetryingCheckpointManager` event stream.
#: Each event is emitted at the same site its counter (and the
#: ``ckpt_``-prefixed ``TrainingResult.telemetry`` entry) increments, so
#: the checkpoints section reconciles key-for-key with the snapshot.
CHECKPOINT_INCIDENT_COUNTERS = {
    "checkpoint_save_retry": "ckpt_save_retries",
    "checkpoint_save_failed": "ckpt_save_failures",
    "checkpoint_save_abandoned": "ckpt_saves_abandoned",
    "checkpoint_restore_fallback": "ckpt_restore_fallbacks",
    "checkpoint_verify_failed": "ckpt_verify_failures",
    "checkpoint_deleted_corrupt": "ckpt_deleted_corrupt",
    "checkpoint_partial_cleaned": "ckpt_partials_cleaned",
}

#: drift-sentinel incident event -> registry counter — the
#: :class:`apex_tpu_torch.observability.sentinel.DriftSentinel` fires each
#: ``anomaly`` event co-sited with one ``anomalies_total`` increment
#: (plus a per-signal ``anomalies_<signal>`` split), so the monitor's
#: anomalies section reconciles key-for-key with the counter snapshot.
#: Every key here is, by APX013, a flight-recorder trigger. Note the
#: recorder's own ``bundle_dumped`` event is deliberately NOT an
#: incident counter key: a dump must never trigger another dump.
SENTINEL_INCIDENT_COUNTERS = {
    "anomaly": "anomalies_total",
}


def read_records(path: str) -> List[dict]:
    """Parse a JSONL metric log; malformed lines are skipped (a run
    killed mid-write leaves a torn last line — the report must still
    build)."""
    records = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _stats(values: List[float]) -> Optional[dict]:
    values = [v for v in values if v == v]  # drop NaN
    if not values:
        return None
    return {"count": len(values), "mean": sum(values) / len(values),
            "min": min(values), "max": max(values),
            "p50": percentile(values, 50), "p95": percentile(values, 95)}


def _trajectory(steps: List[dict], key: str) -> List[dict]:
    """Windowed means of ``key`` over the step records, in step order —
    a coarse trend line (is throughput decaying? did MFU recover after
    the rollback?)."""
    pts = [(r["step"], r[key]) for r in steps
           if "step" in r and key in r and r[key] == r[key]]
    if not pts:
        return []
    pts.sort()
    n = max(1, (len(pts) + _TRAJECTORY_WINDOWS - 1) // _TRAJECTORY_WINDOWS)
    out = []
    for i in range(0, len(pts), n):
        window = pts[i:i + n]
        out.append({"from_step": window[0][0], "to_step": window[-1][0],
                    "mean": sum(v for _, v in window) / len(window)})
    return out


def _request_summary(requests: List[dict]) -> Optional[dict]:
    """Fold ``kind="request"`` serving rows into the report's requests
    section. ``by_finish_reason`` counts reconcile with the engine's
    ``requests_<reason>`` counters — same increment sites. Every field
    read is guarded: rows written by an older engine (no ``ttft_s`` /
    ``tpot_s``) fold into "no data" for those stats, never a KeyError."""
    if not requests:
        return None
    by_reason: Dict[str, int] = {}
    by_priority: Dict[str, int] = {}
    for r in requests:
        reason = str(r.get("finish_reason", "?"))
        by_reason[reason] = by_reason.get(reason, 0) + 1
        # priority class split (PR 20) — only rows that declare a class
        # count, so a pre-priority log folds to an empty dict and the
        # renderer skips the line entirely
        prio = r.get("priority")
        if prio is not None:
            by_priority[str(prio)] = by_priority.get(str(prio), 0) + 1

    def _field(key):
        return _stats([r[key] for r in requests
                       if isinstance(r.get(key), (int, float))])

    return {
        "count": len(requests),
        "by_finish_reason": by_reason,
        "by_priority": by_priority,
        "new_tokens": sum(int(r.get("new_tokens", 0)) for r in requests),
        "queue_s": _field("queue_s"),
        "prefill_s": _field("prefill_s"),
        "decode_s": _field("decode_s"),
        "total_s": _field("total_s"),
        "ttft_s": _field("ttft_s"),
        "tpot_s": _field("tpot_s"),
        "tokens_per_s": _field("tokens_per_s"),
        # chunked-prefill audit: sum of per-request prefill_chunks,
        # reconciling with the prefill_chunks counter (rows written by
        # pre-chunking engines simply contribute 0)
        "prefill_chunks": sum(int(r.get("prefill_chunks", 0))
                              for r in requests),
    }


def _serving_incidents(events: List[dict]) -> Optional[dict]:
    """Fold supervisor/quarantine incident events into per-type counts
    (plus the shed split by reason) — the monitor's serving-incidents
    section, reconciling with :data:`SERVING_INCIDENT_COUNTERS`."""
    counts: Dict[str, int] = {}
    shed: Dict[str, int] = {}
    for e in events:
        name = e.get("event")
        if name in SERVING_INCIDENT_COUNTERS:
            counts[name] = counts.get(name, 0) + 1
        elif name == "retrace":
            # RetraceWatchdog mirror — surfaced in the incident counts
            # but kept OUT of the strict one-inc-per-event mapping: a
            # single event can cover a batched _cache_size jump, so the
            # ``retraces`` counter may run ahead of the event count.
            counts[name] = counts.get(name, 0) + 1
        elif name == "request_shed":
            reason = str(e.get("reason", "?"))
            shed[reason] = shed.get(reason, 0) + 1
    if not counts and not shed:
        return None
    return {"counts": counts, "shed_by_reason": shed}


def _fleet_section(requests: List[dict], events: List[dict],
                   counters: Dict[str, int]) -> Optional[dict]:
    """Fold fleet telemetry into the monitor's fleet section: terminal
    requests grouped by the ``replica_id`` that retired them, dispatch
    counters (``fleet_dispatches`` and its per-replica split — the split
    sums to the total by construction), and drain/rebuild/migration
    incident counts reconciling with :data:`FLEET_INCIDENT_COUNTERS`.
    ``None`` when the log carries no fleet signal (a single-engine run,
    or a pre-fleet log whose request rows have no ``replica_id``)."""
    by_replica: Dict[str, int] = {}
    for r in requests:
        rid = r.get("replica_id")
        if isinstance(rid, int):
            by_replica[str(rid)] = by_replica.get(str(rid), 0) + 1
    counts: Dict[str, int] = {}
    for e in events:
        name = e.get("event")
        if name in FLEET_INCIDENT_COUNTERS:
            counts[name] = counts.get(name, 0) + 1
    dispatch = {name: n for name, n in counters.items()
                if name == "fleet_dispatches"
                or (name.startswith("replica")
                    and name.endswith("_dispatches"))}
    if not by_replica and not counts and not dispatch:
        return None
    return {"requests_by_replica": by_replica, "counts": counts,
            "dispatches": dispatch}


def _adapter_section(requests: List[dict], events: List[dict],
                     counters: Dict[str, int]) -> Optional[dict]:
    """Fold multi-LoRA telemetry into the monitor's adapters section:
    admissions grouped by ``adapter_id`` from the engine's
    ``adapter_request`` event stream (each event is one increment of the
    matching ``adapter<ix>_requests`` counter at the same site, so the
    two views reconcile key-for-key), terminal requests grouped by the
    ``adapter_id`` their result rows carry, and sheds from the
    ``requests_shed_adapter`` counter. ``None`` when the log carries no
    adapter signal (a base-model run, or a pre-LoRA log)."""
    admitted: Dict[str, int] = {}
    by_index: Dict[str, int] = {}
    for e in events:
        if e.get("event") != "adapter_request":
            continue
        aid = str(e.get("adapter_id", "?"))
        admitted[aid] = admitted.get(aid, 0) + 1
        ix = e.get("adapter_ix")
        if isinstance(ix, int):
            by_index[str(ix)] = by_index.get(str(ix), 0) + 1
    finished: Dict[str, int] = {}
    for r in requests:
        aid = r.get("adapter_id")
        if isinstance(aid, str):
            finished[aid] = finished.get(aid, 0) + 1
    adapter_counters = {name: n for name, n in counters.items()
                        if name.startswith("adapter")
                        and name.endswith("_requests") and n}
    shed = counters.get("requests_shed_adapter", 0)
    if not admitted and not finished and not adapter_counters and not shed:
        return None
    return {"admitted_by_adapter": admitted,
            "admitted_by_index": by_index,
            "finished_by_adapter": finished,
            "counters": adapter_counters,
            "shed_unknown": shed}


def _span_section(records: List[dict]) -> Optional[dict]:
    """Fold ``kind="span"`` rows into the monitor's tracing section:
    per-span-name counts (reconciling key-for-key with the ``spans_*``
    counters — same emission sites), the number of distinct traced
    requests, and the span-conservation verdict
    (:func:`~apex_tpu_torch.observability.trace.check_span_conservation`).
    ``None`` for a pre-tracing log with no span rows — readers must
    tolerate logs written before trace ids existed."""
    spans = [r for r in records if r.get("kind") == "span"]
    if not spans:
        return None
    by_name: Dict[str, int] = {}
    traced = set()
    for s in spans:
        name = str(s.get("span", "?"))
        by_name[name] = by_name.get(name, 0) + 1
        traced.add(s.get("request_id"))
    return {"count": len(spans), "by_name": by_name,
            "traced_requests": len(traced),
            "violations": check_span_conservation(records)}


def _signals_section(records: List[dict]) -> Optional[dict]:
    """The last ``kind="signals"`` record's values — the fleet
    autoscaler poll the loadtest runner stamps before close. ``None``
    for single-engine runs and pre-fleet-telemetry logs."""
    signals = None
    for r in records:           # later wins, like the counter snapshots
        if r.get("kind") == "signals" and isinstance(
                r.get("values"), dict):
            signals = r["values"]
    return signals


def _autoscale_section(records: List[dict],
                       counters: Dict[str, int]) -> Optional[dict]:
    """Fold ``kind="autoscale"`` decision records into the monitor's
    autoscale section: per-action counts (reconciling key-for-key with
    :data:`AUTOSCALE_ACTION_COUNTERS` — same emission sites), the final
    replica count after the last decision, and the full decision
    timeline. ``None`` for a fixed-size or pre-autoscaler log."""
    rows = [r for r in records if r.get("kind") == "autoscale"]
    if not rows:
        return None
    by_action: Dict[str, int] = {}
    for r in rows:
        action = str(r.get("action", "?"))
        by_action[action] = by_action.get(action, 0) + 1
    return {
        "count": len(rows),
        "by_action": by_action,
        "counters": {c: counters.get(c, 0)
                     for c in sorted(set(AUTOSCALE_ACTION_COUNTERS.values()))},
        "final_replicas": rows[-1].get("n_replicas"),
        "decisions": [{k: r.get(k) for k in
                       ("action", "replica_id", "reason", "n_replicas",
                        "wall") if k in r} for r in rows],
    }


def _brownout_section(records: List[dict],
                      counters: Dict[str, int]) -> Optional[dict]:
    """Fold ``kind="brownout"`` ladder-transition records into the
    monitor's brownout section: per-action counts (reconciling
    key-for-key with the ``brownouts_escalated``/``brownouts_recovered``
    counters — same emission sites), the final rung after the last
    transition, and the transition timeline. ``None`` for a pre-brownout
    log or a run that never left rung 0 — the back-compat fixtures must
    render without this section."""
    rows = [r for r in records if r.get("kind") == "brownout"]
    if not rows:
        return None
    by_action: Dict[str, int] = {}
    for r in rows:
        action = str(r.get("action", "?"))
        by_action[action] = by_action.get(action, 0) + 1
    return {
        "count": len(rows),
        "by_action": by_action,
        "counters": {c: counters.get(c, 0)
                     for c in ("brownouts_escalated",
                               "brownouts_recovered")},
        "final_rung": rows[-1].get("rung"),
        "final_rung_name": rows[-1].get("rung_name"),
        "transitions": [{k: r.get(k) for k in
                         ("action", "rung", "rung_name", "pressure",
                          "parked", "wall") if k in r} for r in rows],
    }


def _deploy_section(records: List[dict],
                    counters: Dict[str, int]) -> Optional[dict]:
    """Fold ``kind="deploy"`` records into the monitor's deployments
    section: per-action counts (reconciling key-for-key with
    :data:`DEPLOY_ACTION_COUNTERS`), the action timeline, and the last
    canary score observed (the one that promoted or rolled back).
    ``None`` for a log with no deployment activity."""
    rows = [r for r in records if r.get("kind") == "deploy"]
    if not rows:
        return None
    by_action: Dict[str, int] = {}
    for r in rows:
        action = str(r.get("action", "?"))
        by_action[action] = by_action.get(action, 0) + 1
    last_score = None
    for r in rows:              # later wins — the decisive window
        if isinstance(r.get("score"), dict):
            last_score = r["score"]
    return {
        "count": len(rows),
        "by_action": by_action,
        "counters": {c: counters.get(c, 0)
                     for c in sorted(set(DEPLOY_ACTION_COUNTERS.values()))},
        "timeline": [{k: r.get(k) for k in
                      ("action", "target", "replica_id", "reason", "wall")
                      if k in r} for r in rows],
        "last_score": last_score,
    }


def _checkpoint_section(events: List[dict], counters: Dict[str, int],
                        histograms: Dict[str, dict]) -> Optional[dict]:
    """Fold checkpoint telemetry into the monitor's checkpoints section:
    per-type incident counts (reconciling with
    :data:`CHECKPOINT_INCIDENT_COUNTERS`), the save-volume counters
    (``ckpt_save_attempts``), and the snapshot-blocked / write-duration
    histogram summaries. ``None`` when the log carries no checkpoint
    signal (a run without a checkpoint manager, or a pre-sharded log)."""
    counts: Dict[str, int] = {}
    for e in events:
        name = e.get("event")
        if name in CHECKPOINT_INCIDENT_COUNTERS:
            counts[name] = counts.get(name, 0) + 1
    ckpt_counters = {name: n for name, n in counters.items()
                     if name.startswith("ckpt_")}
    timings = {name: h for name, h in histograms.items()
               if name in ("ckpt_snapshot_blocked_s", "ckpt_write_s")}
    if not counts and not ckpt_counters and not timings:
        return None
    return {"counts": counts, "counters": ckpt_counters,
            "timings": timings}


def _anomaly_section(records: List[dict],
                     counters: Dict[str, int]) -> Optional[dict]:
    """Fold drift-sentinel ``kind="anomaly"`` records into the
    monitor's anomalies section: per-signal counts (reconciling
    key-for-key with the ``anomalies_<signal>`` counters and the total
    with :data:`SENTINEL_INCIDENT_COUNTERS` — same emission sites) and
    the anomaly timeline. ``None`` for a pre-sentinel log, or a
    sentinel run that stayed healthy (counters present but zero still
    renders, so a clean sentinel run is visible as clean)."""
    rows = [r for r in records if r.get("kind") == "anomaly"]
    sentinel_counters = {name: n for name, n in counters.items()
                         if name == "anomalies_total"
                         or name.startswith("anomalies_")}
    if not rows and not sentinel_counters:
        return None
    by_signal: Dict[str, int] = {}
    for r in rows:
        sig = str(r.get("signal", "?"))
        by_signal[sig] = by_signal.get(sig, 0) + 1
    return {
        "count": len(rows),
        "by_signal": by_signal,
        "counters": sentinel_counters,
        "timeline": [{k: r.get(k) for k in
                      ("signal", "value", "baseline", "z", "wall")
                      if k in r} for r in rows],
    }


def _bundle_section(records: List[dict],
                    counters: Dict[str, int]) -> Optional[dict]:
    """Fold flight-recorder ``kind="bundle"`` records into the
    monitor's bundles section: one row per postmortem dump (trigger,
    file path, ring size at dump time), reconciling key-for-key with
    the ``bundles_dumped`` counter — the recorder emits record, event
    and increment from the same site. ``None`` for a pre-recorder log
    or a recorder run that never dumped (a zero counter still renders:
    "armed, nothing fired" is a result)."""
    rows = [r for r in records if r.get("kind") == "bundle"]
    dumped = counters.get("bundles_dumped")
    if not rows and dumped is None:
        return None
    return {
        "count": len(rows),
        "counter": 0 if dumped is None else dumped,
        "dumps": [{k: r.get(k) for k in
                   ("bundle_seq", "trigger", "path", "events", "wall")
                   if k in r} for r in rows],
    }


def _gauge_trajectory(records: List[dict]) -> List[dict]:
    """The ``kind="gauge_snapshot"`` samples the drift sentinel stamps
    every N polls — the live occupancy/queue trajectory ``--follow``
    renders between terminal-request rows. Empty for pre-sentinel logs
    (readers must tolerate their absence, like every other section)."""
    out = []
    for r in records:
        if r.get("kind") != "gauge_snapshot":
            continue
        sig = r.get("signals")
        if isinstance(sig, dict):
            out.append({"wall": r.get("wall"), **sig})
    return out


def build_report(path: str,
                 slo_spec: Optional[Dict[str, float]] = None) -> dict:
    """Fold one JSONL metric log into a report dict.

    ``slo_spec`` (``{metric: threshold}``, see
    :data:`apex_tpu_torch.observability.slo.SLO_METRICS`) scores the run's SLO
    verdict; when omitted, the spec embedded in the log's
    ``kind="scenario"`` record (if any) is used — a loadtest run log
    scores itself."""
    records = read_records(path)
    steps = [r for r in records if r.get("kind") == "step"]
    events = [r for r in records if r.get("kind") == "event"]
    requests = [r for r in records if r.get("kind") == "request"]
    scenario = None
    for r in records:       # later wins, like the counter snapshots
        if r.get("kind") == "scenario":
            scenario = r
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    histograms: Dict[str, dict] = {}
    for r in records:  # later snapshots win: the last one is end-of-run
        if r.get("kind") == "counters":
            counters = dict(r.get("values", {}))
        elif r.get("kind") == "gauges":
            gauges = dict(r.get("values", {}))
        elif r.get("kind") == "histograms":
            histograms = dict(r.get("values", {}))

    losses = [r["loss"] for r in steps
              if "loss" in r and not r.get("skipped")
              and r["loss"] == r["loss"]]
    report = {
        "path": path,
        "records": len(records),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "steps_recorded": len(steps),
        "skipped_steps": sum(1 for r in steps if r.get("skipped")),
        "step_time_s": _stats([r["step_time_s"] for r in steps
                               if "step_time_s" in r]),
        "tokens_per_s": _stats([r["tokens_per_s"] for r in steps
                                if "tokens_per_s" in r]),
        "mfu": _stats([r["mfu"] for r in steps if "mfu" in r]),
        "loss": ({"first": losses[0], "last": losses[-1],
                  "min": min(losses)} if losses else None),
        "throughput_trajectory": _trajectory(steps, "tokens_per_s"),
        "mfu_trajectory": _trajectory(steps, "mfu"),
        "requests": _request_summary(requests),
        "serving_incidents": _serving_incidents(events),
        "fleet": _fleet_section(requests, events, counters),
        "adapters": _adapter_section(requests, events, counters),
        "spans": _span_section(records),
        "signals": _signals_section(records),
        "autoscale": _autoscale_section(records, counters),
        "brownout": _brownout_section(records, counters),
        "deploys": _deploy_section(records, counters),
        # per-tenant SLO attribution, only when the run carried adapter
        # traffic (a base-only or pre-LoRA log renders no tenant table)
        "slo_by_adapter": (
            measure_slo_metrics(records, by_adapter=True)
            if any(isinstance(r.get("adapter_id"), str) for r in requests)
            else None),
        "checkpoints": _checkpoint_section(events, counters, histograms),
        "anomalies": _anomaly_section(records, counters),
        "bundles": _bundle_section(records, counters),
        "gauge_trajectory": _gauge_trajectory(records),
        "timeline": sorted(events, key=lambda e: e.get("seq", 0)),
        "scenario": ({k: scenario[k] for k in ("name", "seed")
                      if k in scenario} if scenario else None),
        "slo": None,
    }
    spec = slo_spec
    if spec is None and scenario is not None and \
            isinstance(scenario.get("slo"), dict):
        spec = scenario["slo"]
    if spec:
        report["slo"] = evaluate_slos(records,
                                      SLOSpec.from_dict(spec)).as_dict()
    return report


def _fmt(value: float, unit: str = "") -> str:
    if value is None:
        return "-"
    if abs(value) >= 1000:
        return f"{value:,.0f}{unit}"
    return f"{value:.4g}{unit}"


def _render_stat_line(label: str, stats: Optional[dict],
                      unit: str = "") -> str:
    if not stats:
        return f"  {label:<14} (no data)"
    return (f"  {label:<14} p50={_fmt(stats['p50'], unit)} "
            f"p95={_fmt(stats['p95'], unit)} mean={_fmt(stats['mean'], unit)} "
            f"max={_fmt(stats['max'], unit)} n={stats['count']}")


def render_report(report: dict) -> str:
    lines = [f"== apex_tpu_torch run report: {report['path']} ==",
             f"records: {report['records']}  "
             f"step records: {report['steps_recorded']}  "
             f"skipped: {report['skipped_steps']}",
             "",
             "counters:"]
    if report["counters"]:
        lines += [f"  {k} = {v}" for k, v in sorted(
            report["counters"].items())]
    else:
        lines.append("  (none — was the registry flushed?)")
    lines += ["", "step statistics:",
              _render_stat_line("step time", report["step_time_s"], "s"),
              _render_stat_line("tokens/s", report["tokens_per_s"]),
              _render_stat_line("mfu", report["mfu"])]
    if report["loss"]:
        lo = report["loss"]
        lines.append(f"  {'loss':<14} first={_fmt(lo['first'])} "
                     f"last={_fmt(lo['last'])} min={_fmt(lo['min'])}")
    req = report.get("requests")
    if req:
        reasons = " ".join(f"{k}={v}" for k, v in sorted(
            req["by_finish_reason"].items()))
        lines += ["", f"serving requests ({req['count']}, "
                      f"{req['new_tokens']} tokens generated):",
                  f"  finish: {reasons}"]
        if req.get("by_priority"):
            split = " ".join(f"{k}={v}" for k, v in sorted(
                req["by_priority"].items()))
            lines.append(f"  priority: {split}")
        lines += [_render_stat_line("queue", req["queue_s"], "s"),
                  _render_stat_line("prefill", req["prefill_s"], "s"),
                  _render_stat_line("decode", req["decode_s"], "s"),
                  _render_stat_line("total", req["total_s"], "s"),
                  _render_stat_line("ttft", req.get("ttft_s"), "s"),
                  _render_stat_line("tpot", req.get("tpot_s"), "s"),
                  _render_stat_line("tokens/s", req["tokens_per_s"])]
    gauges = report.get("gauges") or {}
    if "kv_pages_in_use" in gauges or "kv_pages_free" in gauges:
        # paged-KV engine state at the final snapshot, reconciled like
        # the slot metrics: in_use + free == n_pages by the PagePool
        # invariant, and occupancy is the per-tick mapped fraction
        if not req:
            lines += ["", "serving kv cache:"]
        occ = (report.get("histograms") or {}).get("kv_page_occupancy")
        line = (f"  kv pages: in_use={int(gauges.get('kv_pages_in_use', 0))}"
                f" free={int(gauges.get('kv_pages_free', 0))}")
        if isinstance(occ, dict) and occ.get("count"):
            line += (f"  occupancy mean={_fmt(occ.get('mean'))} "
                     f"max={_fmt(occ.get('max'))} n={occ['count']}")
        lines.append(line)
        counters = report.get("counters") or {}
        hits = counters.get("prefix_hits", 0)
        misses = counters.get("prefix_misses", 0)
        if hits or misses:
            # prefix-cache effectiveness, derived from the same counters
            # the engine reconciles against prefills (hits + misses ==
            # paged prefills when prefix_cache is on)
            rate = hits / (hits + misses)
            lines.append(
                f"  prefix cache: hits={hits} misses={misses} "
                f"hit_rate={rate:.1%} "
                f"pages_shared={counters.get('prefix_pages_shared', 0)} "
                f"evictions={counters.get('prefix_evictions', 0)}")
        if "kv_bytes_per_step" in gauges:
            # decode-roofline denominator at the final snapshot — the
            # dtype- and page-aware stream size int8 KV shrinks
            lines.append(
                f"  kv bytes/step (final): "
                f"{int(gauges['kv_bytes_per_step']):,}")
        proposed = counters.get("draft_tokens_proposed", 0)
        if proposed:
            # speculative decoding: accepted/proposed is the fleet-wide
            # acceptance rate, reconciling key-for-key with the
            # spec_accept_rate histogram's per-step observations
            accepted = counters.get("draft_tokens_accepted", 0)
            line = (f"  speculation: proposed={proposed} "
                    f"accepted={accepted} "
                    f"accept_rate={accepted / proposed:.1%}")
            acc = (report.get("histograms") or {}).get("spec_accept_rate")
            if isinstance(acc, dict) and acc.get("count"):
                line += (f" per-step mean={_fmt(acc.get('mean'))} "
                         f"n={acc['count']}")
            lines.append(line)
    chunk_counters = report.get("counters") or {}
    chunks = chunk_counters.get("prefill_chunks", 0)
    if chunks:
        # chunked prefill (both layouts — rendered outside the paged-KV
        # block): the chunk-program counter reconciles with the sum of
        # per-request prefill_chunks record fields, and the
        # prefill_tokens_per_tick histogram shows how full the
        # per-tick token budget actually ran
        line = f"  chunked prefill: chunks={chunks}"
        if req is not None:
            line += f" per-request sum={req.get('prefill_chunks', 0)}"
        tpt = (report.get("histograms") or {}).get("prefill_tokens_per_tick")
        if isinstance(tpt, dict) and tpt.get("count"):
            line += (f"  tokens/tick mean={_fmt(tpt.get('mean'))} "
                     f"max={_fmt(tpt.get('max'))} n={tpt['count']}")
        if not req and "kv_pages_in_use" not in gauges:
            lines += ["", "serving kv cache:"]
        lines.append(line)
    slo = report.get("slo")
    if slo:
        verdict = "PASS" if slo["ok"] else "FAIL"
        n_fail = sum(1 for o in slo["objectives"] if not o["ok"])
        head = (f"slo verdict: {verdict} "
                f"({len(slo['objectives'])} objectives"
                + (f", {n_fail} violated)" if n_fail else ")"))
        lines += ["", head]
        for o in slo["objectives"]:
            cmp_ = "<=" if o["direction"] == "max" else ">="
            measured = ("(no data)" if o["measured"] is None
                        else _fmt(o["measured"]))
            lines.append(
                f"  {'ok ' if o['ok'] else 'VIOLATED':<9}"
                f"{o['name']:<16} measured={measured:<10} "
                f"{cmp_} {_fmt(o['threshold'])}")
    fleet = report.get("fleet")
    if fleet:
        lines += ["", "fleet:"]
        if fleet["dispatches"]:
            total = fleet["dispatches"].get("fleet_dispatches", 0)
            split = " ".join(
                f"{k}={v}" for k, v in sorted(fleet["dispatches"].items())
                if k != "fleet_dispatches")
            lines.append(f"  dispatches: {total}"
                         + (f" ({split})" if split else ""))
        if fleet["requests_by_replica"]:
            split = " ".join(f"replica{k}={v}" for k, v in sorted(
                fleet["requests_by_replica"].items()))
            lines.append(f"  requests by replica: {split}")
        lines += [f"  {name} = {n}"
                  for name, n in sorted(fleet["counts"].items())]
    signals = report.get("signals")
    if signals:
        def _sig(key):
            return _fmt(signals.get(key)) \
                if signals.get(key) is not None else "-"

        lines += ["", "fleet signals (autoscaler):",
                  f"  replicas: {signals.get('replicas_total', '?')} total "
                  f"{signals.get('replicas_dispatchable', '?')} "
                  f"dispatchable  inflight={signals.get('inflight', '?')} "
                  f"queue_depth={signals.get('queue_depth', '?')}"
                  + (f" queued_tokens={signals['queued_tokens']}"
                     if signals.get("queued_tokens") is not None else ""),
                  f"  goodput: window={_sig('goodput_window')} "
                  f"({signals.get('window_ok', 0)}/"
                  f"{signals.get('window_terminal', 0)}"
                  + (f" over {_fmt(signals['window_s'], 's')}"
                     if signals.get("window_s") is not None else "")
                  + ") "
                  f"cumulative={_sig('goodput')} "
                  f"({signals.get('requests_ok', 0)}/"
                  f"{signals.get('requests_terminal', 0)})",
                  f"  latency: ttft_p99={_sig('ttft_p99_s')}s "
                  f"tpot_p99={_sig('tpot_p99_s')}s",
                  f"  occupancy: slots={_sig('slot_occupancy')} "
                  f"kv_pages={_sig('kv_page_occupancy')}"]
        share = signals.get("adapter_share") or {}
        if share:
            split = " ".join(f"{k}={_fmt(v)}"
                             for k, v in sorted(share.items()))
            lines.append(f"  adapter share: {split}")
    autoscale = report.get("autoscale")
    if autoscale:
        split = " ".join(f"{k}={v}"
                         for k, v in sorted(autoscale["by_action"].items()))
        final = autoscale.get("final_replicas")
        lines += ["", f"autoscale decisions ({autoscale['count']}):",
                  f"  {split}"
                  + (f"  final_replicas={final}" if final is not None
                     else "")]
        for d in autoscale["decisions"][:10]:
            wall = d.get("wall")
            stamp = f"[wall={wall:.3f}] " if isinstance(
                wall, (int, float)) else ""
            lines.append(
                f"  {stamp}{d.get('action', '?')} "
                f"replica={d.get('replica_id', '?')} "
                f"reason={d.get('reason', '?')} "
                f"-> n={d.get('n_replicas', '?')}")
        if len(autoscale["decisions"]) > 10:
            lines.append(
                f"  ... {len(autoscale['decisions']) - 10} more")
    brownout = report.get("brownout")
    if brownout:
        split = " ".join(f"{k}={v}"
                         for k, v in sorted(brownout["by_action"].items()))
        final = brownout.get("final_rung_name")
        lines += ["", f"brownout ladder ({brownout['count']} transitions):",
                  f"  {split}"
                  + (f"  final_rung={final}" if final is not None else "")]
        for t in brownout["transitions"][:10]:
            wall = t.get("wall")
            stamp = f"[wall={wall:.3f}] " if isinstance(
                wall, (int, float)) else ""
            lines.append(
                f"  {stamp}{t.get('action', '?')} "
                f"-> rung {t.get('rung', '?')} "
                f"({t.get('rung_name', '?')}) "
                f"pressure={_fmt(t.get('pressure'))} "
                f"parked={t.get('parked', 0)}")
        if len(brownout["transitions"]) > 10:
            lines.append(
                f"  ... {len(brownout['transitions']) - 10} more")
    deploys = report.get("deploys")
    if deploys:
        split = " ".join(f"{k}={v}"
                         for k, v in sorted(deploys["by_action"].items()))
        lines += ["", f"deployments ({deploys['count']} records):",
                  f"  {split}"]
        for d in deploys["timeline"][:12]:
            wall = d.get("wall")
            stamp = f"[wall={wall:.3f}] " if isinstance(
                wall, (int, float)) else ""
            extra = " ".join(
                f"{k}={d[k]}" for k in ("replica_id", "reason")
                if d.get(k) is not None)
            lines.append(f"  {stamp}{d.get('action', '?')} "
                         f"{d.get('target', '?')}"
                         + (f" {extra}" if extra else ""))
        score = deploys.get("last_score")
        if isinstance(score, dict):
            lines.append(
                f"  last canary score: "
                f"{'PASS' if score.get('pass') else 'FAIL'} "
                f"requests={score.get('requests', '?')} "
                f"errors={score.get('errors', '?')} "
                f"error_rate={_fmt(score.get('error_rate'))} "
                f"ttft_p99={_fmt(score.get('canary_ttft_p99_s'), 's')} "
                f"vs incumbent "
                f"{_fmt(score.get('incumbent_ttft_p99_s'), 's')}")
    by_adapter = report.get("slo_by_adapter")
    if by_adapter:
        lines += ["", "per-tenant slo (by adapter_id):",
                  f"  {'tenant':<10}{'reqs':>6}{'ttft_p99':>10}"
                  f"{'tpot_p99':>10}{'goodput':>9}"]
        for aid, m in sorted(by_adapter.items()):
            lines.append(
                f"  {aid:<10}{m.get('requests', 0):>6}"
                f"{_fmt(m.get('ttft_p99_s'), 's'):>10}"
                f"{_fmt(m.get('tpot_p99_s'), 's'):>10}"
                f"{_fmt(m.get('goodput')):>9}")
    spans = report.get("spans")
    if spans:
        split = " ".join(f"{k}={v}"
                         for k, v in sorted(spans["by_name"].items()))
        verdict = ("OK" if not spans["violations"]
                   else f"{len(spans['violations'])} VIOLATION(S)")
        lines += ["", f"request tracing ({spans['count']} spans over "
                      f"{spans['traced_requests']} requests):",
                  f"  {split}",
                  f"  span conservation: {verdict}"]
        lines += [f"    {v}" for v in spans["violations"][:10]]
    adapters = report.get("adapters")
    if adapters:
        lines += ["", "adapters (multi-LoRA):"]
        if adapters["admitted_by_adapter"]:
            split = " ".join(f"{k}={v}" for k, v in sorted(
                adapters["admitted_by_adapter"].items()))
            lines.append(f"  admitted by adapter: {split}")
        if adapters["finished_by_adapter"]:
            split = " ".join(f"{k}={v}" for k, v in sorted(
                adapters["finished_by_adapter"].items()))
            lines.append(f"  finished by adapter: {split}")
        lines += [f"  {name} = {n}"
                  for name, n in sorted(adapters["counters"].items())]
        if adapters["shed_unknown"]:
            lines.append(
                f"  shed (unknown adapter) = {adapters['shed_unknown']}")
    ckpt = report.get("checkpoints")
    if ckpt:
        lines += ["", "checkpoints:"]
        attempts = ckpt["counters"].get("ckpt_save_attempts")
        if attempts is not None:
            lines.append(f"  save attempts: {attempts}")
        lines += [f"  {name} = {n}"
                  for name, n in sorted(ckpt["counts"].items())]
        for name, label in (("ckpt_snapshot_blocked_s", "snapshot block"),
                            ("ckpt_write_s", "write")):
            h = ckpt["timings"].get(name)
            if isinstance(h, dict) and h.get("count"):
                lines.append(
                    f"  {label:<14} n={h['count']} "
                    f"mean={_fmt(h.get('mean'), 's')} "
                    f"max={_fmt(h.get('max'), 's')}"
                    + (f" p95={_fmt(h['p95'], 's')}"
                       if "p95" in h else ""))
    inc = report.get("serving_incidents")
    if inc:
        total = sum(inc["counts"].values()) + \
            sum(inc["shed_by_reason"].values())
        lines += ["", f"serving incidents ({total}):"]
        lines += [f"  {name} = {n}"
                  for name, n in sorted(inc["counts"].items())]
        if inc["shed_by_reason"]:
            split = " ".join(f"{k}={v}" for k, v in sorted(
                inc["shed_by_reason"].items()))
            lines.append(f"  request_shed: {split}")
    anomalies = report.get("anomalies")
    if anomalies:
        split = " ".join(f"{k}={v}" for k, v in sorted(
            anomalies["by_signal"].items())) or "(none fired)"
        lines += ["", f"drift anomalies ({anomalies['count']}):",
                  f"  {split}"]
        lines += [f"  {name} = {n}" for name, n in sorted(
            anomalies["counters"].items())]
        for a in anomalies["timeline"][:10]:
            wall = a.get("wall")
            stamp = f"[wall={wall:.3f}] " if isinstance(
                wall, (int, float)) else ""
            lines.append(
                f"  {stamp}{a.get('signal', '?')} "
                f"value={_fmt(a.get('value'))} "
                f"baseline={_fmt(a.get('baseline'))} "
                f"z={_fmt(a.get('z'))}")
        if len(anomalies["timeline"]) > 10:
            lines.append(
                f"  ... {len(anomalies['timeline']) - 10} more")
    bundles = report.get("bundles")
    if bundles:
        lines += ["", f"postmortem bundles ({bundles['count']} dumped, "
                      f"bundles_dumped = {bundles['counter']}):"]
        if not bundles["dumps"]:
            lines.append("  (recorder armed — nothing fired)")
        for b in bundles["dumps"]:
            wall = b.get("wall")
            stamp = f"[wall={wall:.3f}] " if isinstance(
                wall, (int, float)) else ""
            lines.append(
                f"  {stamp}#{b.get('bundle_seq', '?')} "
                f"trigger={b.get('trigger', '?')} "
                f"events={b.get('events', '?')}"
                + (f" -> {b['path']}" if b.get("path") else ""))
    gauge_traj = report.get("gauge_trajectory")
    if gauge_traj:
        lines += ["", f"signal trajectory ({len(gauge_traj)} "
                      "gauge snapshots):"]
        for key_, label in (("queue_depth", "queue depth"),
                            ("slot_occupancy", "slot occupancy"),
                            ("ttft_p99_s", "ttft p99 (s)"),
                            ("goodput_window", "windowed goodput")):
            pts = [g.get(key_) for g in gauge_traj]
            if not any(isinstance(p, (int, float)) for p in pts):
                continue
            shown = pts[-8:]
            arrow = " -> ".join(
                _fmt(p) if isinstance(p, (int, float)) else "-"
                for p in shown)
            prefix = "... " if len(pts) > len(shown) else ""
            lines.append(f"  {label:<18} {prefix}{arrow}")
    for key, label in (("throughput_trajectory", "tokens/s trajectory"),
                       ("mfu_trajectory", "mfu trajectory")):
        traj = report[key]
        if traj:
            arrow = " -> ".join(_fmt(w["mean"]) for w in traj)
            lines += ["", f"{label} (steps "
                          f"{traj[0]['from_step']}..{traj[-1]['to_step']}):",
                      f"  {arrow}"]
    lines += ["", f"incident timeline ({len(report['timeline'])} events):"]
    if not report["timeline"]:
        lines.append("  (clean run — no incidents)")
    for ev in report["timeline"]:
        extra = " ".join(
            f"{k}={v}" for k, v in sorted(ev.items())
            if k not in ("kind", "event", "seq", "ts", "wall"))
        lines.append(f"  [seq={ev.get('seq', '?')} "
                     f"wall={ev.get('wall', 0):.3f}] "
                     f"{ev.get('event', '?')} {extra}".rstrip())
    return "\n".join(lines)


def _print_trace(path: str, request_id: int) -> int:
    """``--trace``: print one request's span timeline. Exit 0 when the
    request has spans in the log, 2 when it does not (unknown id, or a
    pre-tracing log)."""
    records = read_records(path)
    timelines = build_timelines(records)
    if request_id not in timelines:
        print(f"apex_tpu_torch.monitor: no spans for request {request_id} "
              f"in {path}", file=sys.stderr)
        return 2
    result = None
    for r in records:
        if r.get("kind") == "request" and \
                r.get("request_id") == request_id:
            result = r
    print(format_timeline(request_id, timelines[request_id], result))
    return 0


def _follow(path: str, *, spec: Optional[Dict[str, float]], as_json: bool,
            poll_s: float, max_polls: Optional[int]) -> int:
    """``--follow``: tail a growing run log, re-rendering the report
    whenever the file grows (size change is the signal — JSONL is
    append-only). ``max_polls`` bounds the loop for tests; the default
    ``None`` polls until interrupted."""
    last_size = -1
    polls = 0
    try:
        while max_polls is None or polls < max_polls:
            polls += 1
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1       # not written yet: keep polling
            if size != last_size and size >= 0:
                last_size = size
                report = build_report(path, slo_spec=spec)
                if as_json:
                    print(json.dumps(report, indent=2, default=str))
                else:
                    stamp = time.strftime("%H:%M:%S")
                    print(f"\n--- follow poll {polls} [{stamp}] ---")
                    print(render_report(report))
                sys.stdout.flush()
            if max_polls is None or polls < max_polls:
                time.sleep(poll_s)
    except KeyboardInterrupt:
        pass
    return 0


#: timeline rows printed either side of the trigger in the bundle view
_BUNDLE_TIMELINE_CONTEXT = 8


def render_bundle(bundle: dict) -> str:
    """Render a flight-recorder postmortem bundle as a text page: the
    trigger, a timeline window around it (ring events + typed records
    merged in ``seq`` order, trigger marked), the signal trajectories
    from the gauge-snapshot ring, per-replica engine digests, and a
    suspect attribution (the trigger's replica if it names one, else
    the digest that looks least healthy). Defensive like every reader
    here: bundles outlive the recorders that wrote them."""
    trigger = bundle.get("trigger") or {}
    lines = [f"== apex_tpu_torch postmortem bundle "
             f"(schema {bundle.get('schema', '?')}) ==",
             f"wall: {bundle.get('wall', '?')}  "
             f"trigger: {trigger.get('event', '(manual dump)')}"]
    caps = bundle.get("capacities") or {}
    if caps:
        lines.append(
            "rings: " + " ".join(f"{k}={v}" for k, v in sorted(
                caps.items())))
    cfg = bundle.get("config") or {}
    if cfg.get("fingerprint"):
        lines.append(f"config fingerprint: {cfg['fingerprint']}")

    # -- timeline window around the trigger (events + typed records) --
    rows = [dict(r) for r in (bundle.get("events") or [])]
    rows += [dict(r) for r in (bundle.get("records") or [])]
    rows.sort(key=lambda r: r.get("seq", 0))
    trig_ix = None
    if trigger:
        for i, r in enumerate(rows):
            if r.get("seq") == trigger.get("seq") and \
                    r.get("event") == trigger.get("event"):
                trig_ix = i
    lo = 0 if trig_ix is None else max(
        0, trig_ix - _BUNDLE_TIMELINE_CONTEXT)
    hi = len(rows) if trig_ix is None else min(
        len(rows), trig_ix + _BUNDLE_TIMELINE_CONTEXT + 1)
    lines += ["", f"timeline around trigger "
                  f"({len(rows)} ring records, showing {hi - lo}):"]
    if lo > 0:
        lines.append(f"  ... {lo} earlier")
    for i in range(lo, hi):
        r = rows[i]
        mark = ">>" if i == trig_ix else "  "
        label = r.get("event") or r.get("kind", "?")
        extra = " ".join(
            f"{k}={_fmt(v) if isinstance(v, float) else v}"
            for k, v in sorted(r.items())
            if k not in ("kind", "event", "seq", "ts", "wall")
            and not isinstance(v, (dict, list)))
        lines.append(f"{mark}[seq={r.get('seq', '?')} "
                     f"wall={r.get('wall', 0):.3f}] {label} "
                     f"{extra}".rstrip())
    if hi < len(rows):
        lines.append(f"  ... {len(rows) - hi} later")

    # -- signal trajectories from the gauge-snapshot ring --
    snaps = [r.get("signals") for r in
             (bundle.get("gauge_snapshots") or [])
             if isinstance(r.get("signals"), dict)]
    if snaps:
        lines += ["", f"signal trajectories ({len(snaps)} snapshots):"]
        keys = sorted({k for s in snaps for k in s})
        for key in keys:
            pts = [s.get(key) for s in snaps]
            if not any(isinstance(p, (int, float)) for p in pts):
                continue
            arrow = " -> ".join(
                _fmt(p) if isinstance(p, (int, float)) else "-"
                for p in pts[-8:])
            lines.append(f"  {key:<18} {arrow}")
    last = bundle.get("signals")
    if isinstance(last, dict):
        lines += ["", "last signals snapshot:"]
        lines.append("  " + " ".join(
            f"{k}={_fmt(v) if isinstance(v, float) else v}"
            for k, v in sorted(last.items())
            if not isinstance(v, (dict, list))))

    # -- per-replica digests + suspect attribution --
    replicas = bundle.get("replicas") or []
    suspect = None
    suspect_why = None
    if isinstance(trigger.get("replica_id"), int):
        suspect = trigger["replica_id"]
        suspect_why = "named by trigger"
    if replicas:
        lines += ["", f"replica digests ({len(replicas)}):"]
    for d in replicas:
        rid = d.get("replica_id")
        head = (f"  replica {rid}" if rid is not None else "  engine")
        head += (f" [{d['state']}]" if d.get("state") else "")
        breaker = d.get("breaker")
        unhealthy = (breaker not in (None, "closed")
                     or (d.get("restarts") or 0) > 0)
        if suspect is None and unhealthy and rid is not None:
            suspect = rid
            suspect_why = (f"breaker={breaker}" if breaker != "closed"
                           else f"restarts={d.get('restarts')}")
        lines.append(
            head + f": breaker={breaker} restarts={d.get('restarts')} "
            f"queued={d.get('queued')} active={d.get('active')} "
            f"inflight={d.get('inflight')}")
        slots = d.get("slots")
        if isinstance(slots, dict):
            lines.append(
                f"    slots: free={slots.get('free')} "
                f"active={slots.get('active')} "
                f"occupancy={_fmt(slots.get('occupancy'))}")
        pages = d.get("pages")
        if isinstance(pages, dict):
            lines.append(
                f"    pages: free={pages.get('free')} "
                f"in_use={pages.get('in_use')} "
                f"interned={pages.get('interned')} "
                f"occupancy={_fmt(pages.get('occupancy'))} "
                f"evictions={pages.get('evictions')}")
        comp = d.get("compiles")
        if isinstance(comp, dict):
            lines.append(
                f"    compiles: prefill={comp.get('prefill')} "
                f"decode={comp.get('decode')} "
                f"chunk={comp.get('chunk')} "
                f"retraces={comp.get('decode_retraces')}")
        for r in (d.get("requests") or [])[:8]:
            lines.append(
                f"    inflight request {r.get('request_id', '?')}: "
                f"generated={r.get('generated', '?')} "
                f"submit_ts={_fmt(r.get('submit_ts'))}"
                + (f" adapter={r['adapter_id']}"
                   if r.get("adapter_id") else ""))
    lines += ["", "suspect: "
              + (f"replica {suspect} ({suspect_why})"
                 if suspect is not None
                 else "(none — no replica named or unhealthy)")]
    return "\n".join(lines)


def _bundle_main(argv: List[str]) -> int:
    """``python -m apex_tpu_torch.monitor bundle <path> [--json]``."""
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.monitor bundle",
        description="Render a flight-recorder postmortem bundle "
                    "(the *-bundle-N.json files a FlightRecorder dumps "
                    "next to the run log).")
    parser.add_argument("path", help="path to a bundle .json file")
    parser.add_argument("--json", action="store_true",
                        help="print the raw bundle JSON instead of the "
                             "rendered page")
    args = parser.parse_args(argv)
    try:
        with open(args.path, "r", encoding="utf-8") as f:
            bundle = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"apex_tpu_torch.monitor: cannot read bundle {args.path}: "
              f"{exc}", file=sys.stderr)
        return 2
    if not isinstance(bundle, dict):
        print(f"apex_tpu_torch.monitor: {args.path} is not a bundle object",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(bundle, indent=2, sort_keys=True, default=str))
    else:
        print(render_bundle(bundle))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "bundle":
        return _bundle_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.monitor",
        description="Print a run report from a JSONL metric log written "
                    "by apex_tpu_torch.observability's JsonlSink.")
    parser.add_argument("path", help="path to the run's .jsonl metric log")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON instead of text")
    parser.add_argument("--slo", metavar="SPEC.json", default=None,
                        help="score the run against this SLO spec "
                             "({metric: threshold} JSON) instead of the "
                             "one embedded in the log's scenario record")
    parser.add_argument("--trace", metavar="REQUEST_ID", type=int,
                        default=None,
                        help="print one request's span timeline instead "
                             "of the full report (exit 2 if the log has "
                             "no spans for it)")
    parser.add_argument("--follow", action="store_true",
                        help="tail a growing log: re-render the report "
                             "each time the file grows, until "
                             "interrupted (or --max-polls)")
    parser.add_argument("--poll-s", type=float, default=2.0,
                        help="--follow poll interval in seconds "
                             "(default: 2)")
    parser.add_argument("--max-polls", type=int, default=None,
                        help="--follow: stop after N polls (default: "
                             "poll until interrupted)")
    args = parser.parse_args(argv)
    spec = None
    if args.slo is not None:
        try:
            with open(args.slo, "r", encoding="utf-8") as f:
                spec = json.load(f)
        except (OSError, ValueError) as exc:
            print(f"apex_tpu_torch.monitor: cannot read SLO spec {args.slo}: "
                  f"{exc}", file=sys.stderr)
            return 2
    if args.trace is not None:
        try:
            return _print_trace(args.path, args.trace)
        except OSError as exc:
            print(f"apex_tpu_torch.monitor: cannot read {args.path}: {exc}",
                  file=sys.stderr)
            return 2
    if args.follow:
        return _follow(args.path, spec=spec, as_json=args.json,
                       poll_s=args.poll_s, max_polls=args.max_polls)
    try:
        report = build_report(args.path, slo_spec=spec)
    except OSError as exc:
        print(f"apex_tpu_torch.monitor: cannot read {args.path}: {exc}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render_report(report))
    return 0
