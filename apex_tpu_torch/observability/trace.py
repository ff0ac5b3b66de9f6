"""Request-level tracing: typed spans over the serving request lifecycle.

Every :class:`~apex_tpu_torch.serving.Request` is minted with a ``trace_id``
at construction; the serving tier (scheduler admission through engine
prefill/decode, supervisor restarts, fleet migration) stamps typed
spans into the :class:`~apex_tpu_torch.observability.MetricsRegistry` as
``kind="span"`` JSONL rows, one timeline per request:

- **phase spans** (:data:`PHASE_SPANS` — ``queued``, ``prefill``,
  ``decode``, ``shed``) are disjoint and contiguous; their durations sum
  to the request's measured ``total_s``. They are emitted together at
  the request's single terminal choke point (the engine/supervisor/
  fleet ``_finish``-style retirement that also writes the
  ``kind="request"`` record), from the *same* timestamps that produce
  ``queue_s``/``prefill_s``/``decode_s`` — so conservation holds by
  construction and exactly-once holds under supervisor restarts (a dead
  engine incarnation emits neither a record nor spans).
- **mark spans** (:data:`MARK_SPANS` — ``spec_verify``, ``migration``,
  ``quarantine``, ``preempt``, ``resume``) annotate the timeline
  (speculation totals, a migration handoff, a quarantine scrub, a
  priority preemption park and its later resume) and are excluded from
  the conservation sum — they overlap the phases they explain.

Every span increments a ``spans_<name>`` counter, so the final counters
snapshot reconciles key-for-key with the span rows in the log —
:func:`check_span_conservation` asserts both invariants and is wired
into ``python -m apex_tpu_torch.loadtest --check``.

Pure stdlib on purpose: the monitor/gate read path stays torch-free.

Copied from ``apex_tpu/observability/trace.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence

__all__ = [
    "SPAN_QUEUED", "SPAN_PREFILL", "SPAN_DECODE", "SPAN_SHED",
    "SPAN_SPEC_VERIFY", "SPAN_MIGRATION", "SPAN_QUARANTINE",
    "SPAN_PREEMPT", "SPAN_RESUME",
    "PHASE_SPANS", "MARK_SPANS", "SPAN_COUNTER_PREFIX",
    "new_trace_id", "emit_span", "emit_request_spans",
    "build_timelines", "format_timeline", "check_span_conservation",
]

#: phase spans: disjoint, contiguous, sum == the request's ``total_s``
SPAN_QUEUED = "queued"
SPAN_PREFILL = "prefill"
SPAN_DECODE = "decode"
SPAN_SHED = "shed"
PHASE_SPANS = (SPAN_QUEUED, SPAN_PREFILL, SPAN_DECODE, SPAN_SHED)

#: mark spans: overlapping annotations, excluded from the conservation sum.
#: ``preempt`` is a zero-width mark the engine stamps when it parks a
#: running slot for a higher class; ``resume`` is its zero-width partner
#: the supervisor stamps when the parked request's continuation is
#: resubmitted — both carry the request's ORIGINAL trace_id, so a
#: preempted request's timeline reads queued/prefill/decode with the
#: park/resume gap annotated, and conservation stays exact (the terminal
#: record is emitted by the finishing incarnation from its own clock).
SPAN_SPEC_VERIFY = "spec_verify"
SPAN_MIGRATION = "migration"
SPAN_QUARANTINE = "quarantine"
SPAN_PREEMPT = "preempt"
SPAN_RESUME = "resume"
MARK_SPANS = (SPAN_SPEC_VERIFY, SPAN_MIGRATION, SPAN_QUARANTINE,
              SPAN_PREEMPT, SPAN_RESUME)

#: every emitted span increments ``f"{SPAN_COUNTER_PREFIX}{name}"``
SPAN_COUNTER_PREFIX = "spans_"


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id. Unlike ``request_id`` (a process-
    local monotonic int), a trace id survives supervisor restarts and
    fleet migration verbatim — continuations are built with the original
    request's trace id — and is unique across processes, so merged fleet
    logs never collide."""
    return uuid.uuid4().hex[:16]


def emit_span(registry, name: str, *, trace_id: str, request_id: int,
              start_s: float, end_s: float, wall: float,
              replica_id: Optional[int] = None,
              detail: Optional[str] = None, **fields) -> dict:
    """Stamp one span row into ``registry`` (and bump its
    ``spans_<name>`` counter). ``start_s``/``end_s`` are on the
    process-monotonic clock — the same clock as the request timestamps
    the terminal record's durations are computed from."""
    record = {
        "kind": "span", "span": name, "trace_id": trace_id,
        "request_id": request_id, "start_s": start_s, "end_s": end_s,
        "duration_s": end_s - start_s, "wall": wall,
    }
    if replica_id is not None:
        record["replica_id"] = replica_id
    if detail is not None:
        record["detail"] = detail
    record.update(fields)
    registry.inc(SPAN_COUNTER_PREFIX + name)
    registry.emit_record(record)
    return record


def emit_request_spans(registry, *, trace_id: str, request_id: int,
                       submit_ts: float, now: float, wall: float,
                       prefill_start: float = 0.0,
                       prefill_end: float = 0.0,
                       replica_id: Optional[int] = None,
                       prefill_segments: Sequence[float] = (),
                       detail: Optional[str] = None) -> List[dict]:
    """Emit the request's phase-span timeline at its terminal choke
    point, from the same timestamps that produced the terminal record's
    ``queue_s``/``prefill_s``/``decode_s`` decomposition:

    - a request that reached prefill gets the full
      ``queued -> prefill -> decode`` trio;
    - a request shed before prefill gets a single span: ``shed`` when a
      shed ``detail`` is given (queue_full/deadline_expired/...), else
      ``queued`` (cancelled or expired while waiting).

    ``prefill_segments`` are the INTERIOR chunk-boundary timestamps of a
    chunked prefill (docs/serving.md#chunked-prefill): the prefill phase
    is then emitted as one span per chunk — contiguous by construction,
    covering exactly ``[prefill_start, prefill_end]``, so the
    conservation invariants (gap-free, sum == ``total_s``) hold
    unchanged while the timeline shows every chunk the tick budget
    carved. Empty for a monolithic prefill (one span, the pre-chunking
    timeline bit-for-bit).
    """
    if prefill_start:
        spans = [
            emit_span(registry, SPAN_QUEUED, trace_id=trace_id,
                      request_id=request_id, start_s=submit_ts,
                      end_s=prefill_start, wall=wall,
                      replica_id=replica_id),
        ]
        bounds = [prefill_start, *prefill_segments, prefill_end]
        for seg, (seg_start, seg_end) in enumerate(
                zip(bounds, bounds[1:])):
            spans.append(emit_span(
                registry, SPAN_PREFILL, trace_id=trace_id,
                request_id=request_id, start_s=seg_start, end_s=seg_end,
                wall=wall, replica_id=replica_id,
                **({"chunk": seg} if len(bounds) > 2 else {})))
        spans.append(
            emit_span(registry, SPAN_DECODE, trace_id=trace_id,
                      request_id=request_id, start_s=prefill_end,
                      end_s=now, wall=wall, replica_id=replica_id))
        return spans
    name = SPAN_SHED if detail is not None else SPAN_QUEUED
    return [emit_span(registry, name, trace_id=trace_id,
                      request_id=request_id, start_s=submit_ts,
                      end_s=now, wall=wall, replica_id=replica_id,
                      detail=detail)]


# -- read path (monitor / gate) -------------------------------------------

def build_timelines(records: Sequence[dict]) -> Dict[int, List[dict]]:
    """Group ``kind="span"`` rows by ``request_id``, each timeline
    sorted by ``start_s`` (phase spans before marks at equal starts, so
    a rendered timeline reads causally)."""
    timelines: Dict[int, List[dict]] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        timelines.setdefault(rec.get("request_id"), []).append(rec)
    for spans in timelines.values():
        spans.sort(key=lambda s: (s.get("start_s", 0.0),
                                  s.get("span") in MARK_SPANS))
    return timelines


def format_timeline(request_id: int, spans: Sequence[dict],
                    result: Optional[dict] = None) -> str:
    """Human rendering of one request's span timeline (the monitor's
    ``--trace`` output). Offsets are relative to the first span start."""
    if not spans:
        return f"request {request_id}: no spans recorded"
    t0 = min(s.get("start_s", 0.0) for s in spans)
    lines = [f"request {request_id}  trace_id="
             f"{spans[0].get('trace_id', '?')}"]
    if result is not None:
        lines[0] += (f"  finish={result.get('finish_reason', '?')}"
                     f"  total={result.get('total_s', 0.0):.4f}s")
    for s in spans:
        start = s.get("start_s", 0.0) - t0
        dur = s.get("duration_s", 0.0)
        mark = " (mark)" if s.get("span") in MARK_SPANS else ""
        extra = ""
        if s.get("detail"):
            extra += f"  detail={s['detail']}"
        if s.get("replica_id") is not None:
            extra += f"  replica={s['replica_id']}"
        for key in ("chunk", "proposed", "accepted", "from_replica",
                    "tokens_carried", "tokens_parked", "priority"):
            if key in s:
                extra += f"  {key}={s[key]}"
        lines.append(f"  +{start:9.4f}s  {s.get('span', '?'):<11}"
                     f" {dur:9.4f}s{mark}{extra}")
    phases = [s for s in spans if s.get("span") in PHASE_SPANS]
    lines.append(f"  span sum: "
                 f"{sum(s.get('duration_s', 0.0) for s in phases):.4f}s"
                 f" over {len(phases)} phase span(s)")
    return "\n".join(lines)


def check_span_conservation(records: Sequence[dict], *,
                            rel_tol: float = 0.02,
                            abs_tol: float = 0.002) -> List[str]:
    """Validate the tracing invariants over a record stream; returns a
    list of human-readable violations (empty == conserved).

    For every terminal ``kind="request"`` row that carries a
    ``trace_id`` (pre-tracing logs are vacuously conserved):

    1. the request has at least one phase span, all stamped with the
       request's own trace id;
    2. phase spans are disjoint and gap-free: sorted by start, each
       begins where the previous ended (within ``abs_tol``);
    3. phase durations sum to the record's ``total_s`` within
       ``rel_tol * total_s + abs_tol``.

    Additionally the last ``kind="counters"`` snapshot's ``spans_*``
    entries must reconcile key-for-key with the span rows in the
    stream.
    """
    violations: List[str] = []
    timelines = build_timelines(records)
    counters: Optional[dict] = None
    for rec in records:
        if rec.get("kind") == "counters":
            counters = rec.get("values", {})
    for rec in records:
        if rec.get("kind") != "request" or not rec.get("trace_id"):
            continue
        rid = rec.get("request_id")
        trace_id = rec["trace_id"]
        spans = timelines.get(rid, [])
        phases = [s for s in spans if s.get("span") in PHASE_SPANS]
        if not phases:
            violations.append(
                f"request {rid}: terminal record has trace_id "
                f"{trace_id} but no phase spans")
            continue
        for s in spans:
            if s.get("trace_id") != trace_id:
                violations.append(
                    f"request {rid}: span {s.get('span')!r} trace_id "
                    f"{s.get('trace_id')} != record trace_id {trace_id}")
        for prev, nxt in zip(phases, phases[1:]):
            gap = abs(nxt.get("start_s", 0.0) - prev.get("end_s", 0.0))
            if gap > abs_tol:
                violations.append(
                    f"request {rid}: {gap:.6f}s gap between "
                    f"{prev.get('span')!r} and {nxt.get('span')!r}")
        total = rec.get("total_s", 0.0)
        span_sum = sum(s.get("duration_s", 0.0) for s in phases)
        tol = rel_tol * abs(total) + abs_tol
        if abs(span_sum - total) > tol:
            violations.append(
                f"request {rid}: phase span sum {span_sum:.6f}s != "
                f"total_s {total:.6f}s (tol {tol:.6f}s)")
    # counter reconciliation: spans_* in the final snapshot vs the rows
    if counters is not None:
        by_name: Dict[str, int] = {}
        for spans in timelines.values():
            for s in spans:
                name = s.get("span")
                by_name[name] = by_name.get(name, 0) + 1
        names = set(by_name) | {
            k[len(SPAN_COUNTER_PREFIX):] for k in counters
            if k.startswith(SPAN_COUNTER_PREFIX)}
        for name in sorted(names):
            counted = counters.get(SPAN_COUNTER_PREFIX + name, 0)
            seen = by_name.get(name, 0)
            if counted != seen:
                violations.append(
                    f"span counter {SPAN_COUNTER_PREFIX}{name}="
                    f"{counted} but {seen} span row(s) in the log")
    return violations
