"""The SLO regression gate: committed baseline, tolerance, verdict.

The second half of "make the serving claims measurable": a scenario run
that *passes its SLOs* can still be a regression — p99 TTFT doubling
from 5 ms to 10 ms is invisible to a 50 ms objective. The gate compares
the run's measured metrics against a **committed baseline**
(``SLO_BASELINE_TORCH.json``, one entry per scenario name, written by
``python -m apex_tpu_torch.loadtest --update-baseline``; the JAX
package's ``SLO_BASELINE.json`` holds that package's own numbers) and fails when any
metric moved the wrong way by more than the scenario's relative
``tolerance``:

- ``"max"``-direction metrics (latencies, error budget, recovery time —
  smaller is better) regress when
  ``measured > baseline * (1 + tolerance)``;
- ``"min"``-direction metrics (goodput) regress when
  ``measured < baseline * (1 - tolerance)``;
- a baselined metric the current run cannot measure at all (e.g.
  ``recovery_s`` with no disruption in the log) is a regression too —
  the scenario stopped exercising what the baseline recorded.

Improvements never fail the gate; re-commit them with
``--update-baseline`` so the bar ratchets. Wall-clock metrics are noisy
across machines — pick the tolerance for the machine class that runs
the gate (the committed scenarios use generous tolerances for shared
CI; tighten on dedicated hardware).

Pure stdlib, like the scorer: gating an existing log never imports torch.

Copied from ``apex_tpu/loadtest/gate.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from apex_tpu_torch.observability.slo import SLO_METRICS

__all__ = ["DEFAULT_BASELINE", "Regression", "load_baseline",
           "update_baseline", "compare_to_baseline"]

#: repo-root default the CLI looks for (override with ``--baseline``)
DEFAULT_BASELINE = "SLO_BASELINE_TORCH.json"


@dataclass(frozen=True)
class Regression:
    """One metric that moved past tolerance the wrong way."""

    metric: str
    direction: str              # from SLO_METRICS: "max" = lower-better
    baseline: float
    measured: Optional[float]   # None: the run could not measure it
    allowed: float              # the tolerance-adjusted bound crossed

    def describe(self) -> str:
        if self.measured is None:
            return (f"{self.metric}: baseline {self.baseline:.6g} but the "
                    f"run measured nothing (scenario no longer exercises "
                    f"this metric?)")
        worse = "above" if self.direction == "max" else "below"
        return (f"{self.metric}: measured {self.measured:.6g} is {worse} "
                f"the allowed {self.allowed:.6g} "
                f"(baseline {self.baseline:.6g})")


def load_baseline(path: str) -> Dict[str, Dict[str, float]]:
    """Read ``{scenario_name: {metric: value}}``; a malformed file is an
    error (a gate must not silently pass on a truncated baseline)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or not all(
            isinstance(v, dict) for v in data.values()):
        raise ValueError(
            f"{path}: baseline must map scenario names to metric dicts")
    return data


def update_baseline(path: str, scenario_name: str,
                    metrics: Dict[str, Optional[float]]) -> Dict[str, float]:
    """Merge ``metrics`` (dropping unmeasured ``None`` and non-finite
    values — an unrecovered run must not become the bar) into the
    baseline file under ``scenario_name``; returns the entry written."""
    try:
        baseline = load_baseline(path)
    except FileNotFoundError:
        baseline = {}
    entry = {name: float(value) for name, value in sorted(metrics.items())
             if isinstance(value, (int, float))
             and value == value and value not in (float("inf"),
                                                  float("-inf"))}
    baseline[scenario_name] = entry
    with open(path, "w", encoding="utf-8") as f:
        json.dump(baseline, f, indent=2, sort_keys=True)
        f.write("\n")
    return entry


def compare_to_baseline(measured: Dict[str, Optional[float]],
                        baseline: Dict[str, float],
                        tolerance: float) -> List[Regression]:
    """Every baselined metric, checked directionally against its
    tolerance-adjusted bound. Metrics measured now but absent from the
    baseline are ignored (they join the bar at the next
    ``--update-baseline``)."""
    if tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    regressions: List[Regression] = []
    for metric in sorted(baseline):
        base = baseline[metric]
        if metric not in SLO_METRICS:
            raise ValueError(
                f"baseline contains unknown metric {metric!r}; known: "
                f"{sorted(SLO_METRICS)}")
        direction = SLO_METRICS[metric][0]
        value = measured.get(metric)
        if direction == "max":
            allowed = base * (1.0 + tolerance)
            bad = value is None or value > allowed
        else:
            allowed = base * (1.0 - tolerance)
            bad = value is None or value < allowed
        if bad:
            regressions.append(Regression(
                metric=metric, direction=direction, baseline=float(base),
                measured=value, allowed=allowed))
    return regressions
