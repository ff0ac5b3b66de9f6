"""Request trace ids and span rows.

From ``apex_tpu/observability/trace.py``, the port copies what its serving
tier uses: :func:`new_trace_id` (every request is stamped with one) and
:func:`emit_span` with the span names the supervisor stamps — ``decode``
and ``shed`` phase spans over a request it retires itself, and the
zero-width ``resume`` mark when a preempted request's continuation is
resubmitted. The engine's own phase timeline (``emit_request_spans``)
comes with the rest of the observability port.
"""

from __future__ import annotations

import uuid
from typing import Optional

__all__ = ["SPAN_DECODE", "SPAN_SHED", "SPAN_RESUME", "SPAN_COUNTER_PREFIX",
           "new_trace_id", "emit_span"]

#: phase spans (disjoint, contiguous, sum == the request's ``total_s``)
SPAN_DECODE = "decode"
SPAN_SHED = "shed"
#: mark span (an overlapping, zero-width annotation)
SPAN_RESUME = "resume"

#: every emitted span increments ``f"{SPAN_COUNTER_PREFIX}{name}"``
SPAN_COUNTER_PREFIX = "spans_"


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id, unique across processes."""
    return uuid.uuid4().hex[:16]


def emit_span(registry, name: str, *, trace_id: str, request_id: int,
              start_s: float, end_s: float, wall: float,
              replica_id: Optional[int] = None,
              detail: Optional[str] = None, **fields) -> dict:
    """Stamp one ``kind="span"`` row into ``registry`` (and bump its
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
