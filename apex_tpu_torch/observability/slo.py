"""SLO specs and run-log scoring — the measurable half of the serving
claims.

PRs 4–5 built a serving tier whose latency, goodput-under-shedding, and
crash-recovery behavior were asserted anecdotally (an example run, a
benchmark row). This module turns those claims into declared
**service-level objectives** evaluated from the same ``kind="request"``
/ ``kind="event"`` JSONL stream the engine already emits:

- :data:`SLO_METRICS` names every scoreable metric and its direction
  (is a bigger number better or worse?);
- :func:`measure_slo_metrics` folds a record list into measured values
  (p50/p99 TTFT and TPOT, p99 request latency, goodput, error-budget
  fraction, recovery time from a disruption to the first post-recovery
  completion);
- :class:`SLOSpec` declares thresholds (usually embedded in a loadtest
  scenario's ``"slo"`` section and echoed into the run log as the
  ``kind="scenario"`` record, so a log scores itself);
- :func:`evaluate_slos` produces the per-objective PASS/FAIL verdict the
  monitor renders and ``python -m apex_tpu_torch.loadtest --check`` gates on.

Pure stdlib on purpose, like :mod:`~apex_tpu_torch.observability.report`: the
verdict must be computable wherever the log file can be copied — no torch,
no serving imports (finish reasons are mirrored as string literals).

Copied from ``apex_tpu/observability/slo.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from apex_tpu_torch.observability.registry import percentile

__all__ = ["SLO_METRICS", "OK_FINISH_REASONS", "SLOSpec", "SLOObjective",
           "SLOReport", "measure_slo_metrics", "evaluate_slos"]

#: finish reasons that count as successfully served work (mirrors
#: ``apex_tpu_torch.serving.FINISH_EOS``/``FINISH_LENGTH`` — string literals
#: here so the scorer stays importable without torch)
OK_FINISH_REASONS = ("eos", "length")

#: every scoreable metric: name -> (direction, description). Direction
#: ``"max"`` means the spec value is an upper bound (latencies, error
#: budget — smaller is better); ``"min"`` means a lower bound (goodput).
#: The regression gate reuses the same table: a "max" metric regresses
#: by growing, a "min" metric by shrinking.
SLO_METRICS: Dict[str, tuple] = {
    "ttft_p50_s": ("max", "p50 time to first token (submit -> token #1)"),
    "ttft_p99_s": ("max", "p99 time to first token"),
    "tpot_p50_s": ("max", "p50 time per output token (inter-token mean)"),
    "tpot_p99_s": ("max", "p99 time per output token"),
    "latency_p99_s": ("max", "p99 total latency over completed requests"),
    "goodput": ("min", "fraction of submitted requests finishing "
                       "eos/length (completions per unit of offered "
                       "load — what shedding is supposed to protect)"),
    "goodput_interactive": ("min", "goodput over interactive-class "
                                   "requests only (what the brownout "
                                   "ladder and preemption protect); "
                                   "None when the log has no "
                                   "priority-stamped interactive rows"),
    "error_budget": ("max", "fraction of submitted requests finishing "
                            "error (quarantine, retry exhaustion)"),
    "recovery_s": ("max", "worst gap from a disruption (engine_restart "
                          "or breaker_open) to the first post-recovery "
                          "completion; inf when service never recovered"),
}


def measure_slo_metrics(records: List[dict], *, by_adapter: bool = False):
    """Fold a record list (:func:`~apex_tpu_torch.observability.report.\
read_records` output) into measured values for every
    :data:`SLO_METRICS` key. ``None`` marks a metric the log cannot
    support (no requests, no disruptions, no TTFT-stamped records — e.g.
    a pre-TTFT run log); an objective declared against a ``None`` metric
    FAILS rather than silently passing.

    With ``by_adapter=True`` the same fold runs once per tenant instead:
    the return value is ``{adapter_id: metrics_dict}`` over the
    ``adapter_id`` stamped on each request record (``"base"`` for
    un-adapted traffic), each inner dict extended with a ``"requests"``
    count. Events are withheld from the per-tenant folds — a disruption
    is fleet-wide, so ``recovery_s`` stays a whole-run metric and reads
    ``None`` per tenant. Per-tenant dicts are attribution output, NOT
    baseline payloads: they must never be merged into the flat metrics
    dict that :class:`SLOSpec`/the regression gate consume.
    """
    if by_adapter:
        groups: Dict[str, List[dict]] = {}
        for r in records:
            if r.get("kind") == "request":
                groups.setdefault(str(r.get("adapter_id", "base")),
                                  []).append(r)
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for adapter_id, rows in sorted(groups.items()):
            metrics = measure_slo_metrics(rows)
            metrics["requests"] = len(rows)
            out[adapter_id] = metrics
        return out
    requests = [r for r in records if r.get("kind") == "request"]
    ok = [r for r in requests
          if r.get("finish_reason") in OK_FINISH_REASONS]
    errors = [r for r in requests if r.get("finish_reason") == "error"]

    def _vals(rows, key):
        return [float(r[key]) for r in rows
                if isinstance(r.get(key), (int, float))]

    def _pct(values, p):
        return percentile(values, p) if values else None

    ttfts = _vals(requests, "ttft_s")
    tpots = _vals(requests, "tpot_s")
    latencies = _vals(ok, "total_s")

    # per-class goodput: only rows that DECLARE the class count (a
    # pre-priority log measures None, so old logs never fail the new
    # objective unless a scenario explicitly declares it)
    interactive = [r for r in requests
                   if r.get("priority") == "interactive"]
    interactive_ok = [r for r in interactive
                      if r.get("finish_reason") in OK_FINISH_REASONS]

    metrics: Dict[str, Optional[float]] = {
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "tpot_p50_s": _pct(tpots, 50),
        "tpot_p99_s": _pct(tpots, 99),
        "latency_p99_s": _pct(latencies, 99),
        "goodput": len(ok) / len(requests) if requests else None,
        "goodput_interactive": (len(interactive_ok) / len(interactive)
                                if interactive else None),
        "error_budget": len(errors) / len(requests) if requests else None,
    }

    # recovery time: for each disruption, the gap to the FIRST successful
    # completion that lands after it (wall-clock correlated — the same
    # stamps log_event/registry events carry). A disruption with no
    # later completion means the run never recovered: inf, which fails
    # any finite bound.
    disruptions = [float(r["wall"]) for r in records
                   if r.get("kind") == "event"
                   and r.get("event") in ("engine_restart", "breaker_open")
                   and isinstance(r.get("wall"), (int, float))]
    completions = sorted(float(r["wall"]) for r in ok
                         if isinstance(r.get("wall"), (int, float)))
    if disruptions:
        gaps = []
        for d in disruptions:
            later = [c for c in completions if c > d]
            gaps.append(later[0] - d if later else float("inf"))
        metrics["recovery_s"] = max(gaps)
    else:
        metrics["recovery_s"] = None
    return metrics


@dataclass(frozen=True)
class SLOSpec:
    """Declared objectives: ``{metric_name: threshold}`` over
    :data:`SLO_METRICS` keys. Direction comes from the table — a
    ``"max"`` metric must measure at or below its threshold, a ``"min"``
    metric at or above."""

    objectives: Dict[str, float]

    def __post_init__(self):
        for name, value in self.objectives.items():
            if name not in SLO_METRICS:
                raise ValueError(
                    f"unknown SLO metric {name!r}; known: "
                    f"{sorted(SLO_METRICS)}")
            if not isinstance(value, (int, float)) or value != value:
                raise ValueError(
                    f"SLO threshold for {name!r} must be a number, "
                    f"got {value!r}")

    @classmethod
    def from_dict(cls, data: Dict[str, float]) -> "SLOSpec":
        return cls(objectives=dict(data))

    def to_dict(self) -> Dict[str, float]:
        return dict(self.objectives)


@dataclass(frozen=True)
class SLOObjective:
    """One scored objective: the threshold, what the log measured, and
    the verdict. ``measured is None`` (metric unsupported by the log)
    fails — a gate must not go green on missing data."""

    name: str
    direction: str
    threshold: float
    measured: Optional[float]
    ok: bool

    def as_dict(self) -> dict:
        return {"name": self.name, "direction": self.direction,
                "threshold": self.threshold, "measured": self.measured,
                "ok": self.ok}


@dataclass(frozen=True)
class SLOReport:
    """The full verdict: every declared objective scored, plus the
    complete measured-metrics dict (also the regression-gate baseline
    payload — ``python -m apex_tpu_torch.loadtest --update-baseline`` commits
    exactly these values)."""

    objectives: List[SLOObjective]
    metrics: Dict[str, Optional[float]]

    @property
    def ok(self) -> bool:
        return all(o.ok for o in self.objectives)

    @property
    def failures(self) -> List[SLOObjective]:
        return [o for o in self.objectives if not o.ok]

    def as_dict(self) -> dict:
        return {"ok": self.ok,
                "objectives": [o.as_dict() for o in self.objectives],
                "metrics": dict(self.metrics)}


def evaluate_slos(records: List[dict], spec: SLOSpec) -> SLOReport:
    """Score ``records`` against ``spec``. Deterministic in the record
    list; objectives are reported in the spec's declaration order."""
    metrics = measure_slo_metrics(records)
    objectives = []
    for name, threshold in spec.objectives.items():
        direction = SLO_METRICS[name][0]
        measured = metrics.get(name)
        if measured is None:
            ok = False      # no data never passes a declared objective
        elif direction == "max":
            ok = measured <= threshold
        else:
            ok = measured >= threshold
        objectives.append(SLOObjective(
            name=name, direction=direction, threshold=float(threshold),
            measured=measured, ok=ok))
    return SLOReport(objectives=objectives, metrics=metrics)
