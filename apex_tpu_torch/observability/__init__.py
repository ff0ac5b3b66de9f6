"""Serving telemetry (the part of ``apex_tpu.observability`` the engine
uses)."""

from apex_tpu_torch.observability.registry import (
    HistogramSnapshot,
    MetricsRegistry,
    percentile,
)
from apex_tpu_torch.observability.trace import emit_span, new_trace_id

__all__ = ["HistogramSnapshot", "MetricsRegistry", "percentile",
           "emit_span", "new_trace_id"]
