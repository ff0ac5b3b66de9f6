"""apex_tpu_torch.observability — metrics, tracing and run reports
(counterpart of ``apex_tpu.observability``).

- :class:`MetricsRegistry` — thread-safe counters, gauges and
  bounded-memory histograms with pluggable sinks (:class:`JsonlSink`,
  :class:`PrometheusTextfileSink`, :class:`InMemorySink`).
- :class:`StepMetrics` / :class:`StepTimer` — per-step wall time,
  tokens/s and MFU against the card's peak
  (:mod:`apex_tpu_torch.utils.flops`), plus ``torch.cuda`` memory gauges.
- :func:`span` / :class:`ProfilerCapture` — named scopes (NVTX and
  ``torch.profiler``) that also record host durations, and windowed
  ``torch.profiler`` captures.
- :func:`build_report` / :func:`render_report` — fold a run's JSONL log
  into the report ``python -m apex_tpu_torch.monitor`` prints.
- :class:`SLOSpec` / :func:`evaluate_slos` — declared service-level
  objectives scored from the run log; ``python -m apex_tpu_torch.loadtest
  --check`` gates on them.
- :mod:`~apex_tpu_torch.observability.trace` — request-level span
  timelines whose phase durations sum to each request's latency
  (:func:`check_span_conservation`).
- :class:`FleetMetrics` / :class:`ReplicaRegistry`
  (:mod:`~apex_tpu_torch.observability.fleet_metrics`) — per-replica
  metric views merged into one fleet snapshot plus the polled
  ``signals()`` dict (goodput window, queue depth, p99 TTFT/TPOT,
  occupancy, per-adapter share) that feeds the autoscaler, the brownout
  ladder and the drift sentinel.
- :class:`FlightRecorder` — bounded rings of recent telemetry that dump a
  postmortem bundle on an incident-class event.
- :class:`DriftSentinel` / :class:`SentinelConfig`
  (:mod:`~apex_tpu_torch.observability.sentinel`) — online EWMA + robust
  z-score drift detection over ``FleetMetrics.signals()``, emitting typed
  ``kind="anomaly"`` records with paired ``anomalies_*`` counters from the
  fleet tick.
"""

from apex_tpu_torch.observability.registry import (
    HistogramSnapshot,
    MetricsRegistry,
    percentile,
)
from apex_tpu_torch.observability.sinks import (
    InMemorySink,
    JsonlSink,
    PrometheusTextfileSink,
)
from apex_tpu_torch.observability.step_metrics import StepMetrics, StepTimer
from apex_tpu_torch.observability.tracing import ProfilerCapture, span
from apex_tpu_torch.observability.report import (
    build_report,
    read_records,
    render_report,
)
from apex_tpu_torch.observability.slo import (
    SLO_METRICS,
    SLOObjective,
    SLOReport,
    SLOSpec,
    evaluate_slos,
    measure_slo_metrics,
)
from apex_tpu_torch.observability.trace import (
    MARK_SPANS,
    PHASE_SPANS,
    build_timelines,
    check_span_conservation,
    emit_request_spans,
    emit_span,
    format_timeline,
    new_trace_id,
)
from apex_tpu_torch.observability.fleet_metrics import (
    FleetMetrics,
    ReplicaRegistry,
    merge_histograms,
)
from apex_tpu_torch.observability.recorder import (
    TRIGGER_EVENTS,
    FlightRecorder,
)
from apex_tpu_torch.observability.sentinel import (
    DriftSentinel,
    SentinelConfig,
)

__all__ = [
    "MetricsRegistry",
    "HistogramSnapshot",
    "percentile",
    "InMemorySink",
    "JsonlSink",
    "PrometheusTextfileSink",
    "StepMetrics",
    "StepTimer",
    "ProfilerCapture",
    "span",
    "build_report",
    "read_records",
    "render_report",
    "SLO_METRICS",
    "SLOSpec",
    "SLOObjective",
    "SLOReport",
    "evaluate_slos",
    "measure_slo_metrics",
    "PHASE_SPANS",
    "MARK_SPANS",
    "new_trace_id",
    "emit_request_spans",
    "emit_span",
    "build_timelines",
    "format_timeline",
    "check_span_conservation",
    "FleetMetrics",
    "ReplicaRegistry",
    "merge_histograms",
    "FlightRecorder",
    "TRIGGER_EVENTS",
    "DriftSentinel",
    "SentinelConfig",
]
