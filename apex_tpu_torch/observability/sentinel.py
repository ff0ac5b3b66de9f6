"""Drift sentinel: online anomaly detection over the fleet's health
signals.

Breakers and watchdogs catch *hard* failures — a hung tick, a crashed
engine. What they miss is **drift**: TTFT p99 creeping up as a replica's
page pool fragments, windowed goodput sagging under a slow memory leak,
queue depth climbing because one replica quietly serves at half speed.
Nothing trips, the loadtest gate fails hours later, and the evidence is
gone.

The :class:`DriftSentinel` polls ``FleetMetrics.signals()`` on the fleet
tick (same cadence seam as the autoscaler) and keeps, per monitored
signal, an EWMA baseline plus an EWMA of absolute deviation — a robust,
O(1)-memory scale estimate that one outlier can't crater. Each poll's
robust z-score ``|x - mean| / max(dev, floor)`` is compared against
``z_threshold`` **directionally** (high TTFT is an anomaly; low TTFT is
a good day): ``hysteresis_polls`` consecutive breaches arm the trigger,
a per-signal ``cooldown_s`` stops re-firing on the same excursion, and
``warmup_polls`` keeps the sentinel silent while the baseline learns.

Firing follows the observability plane's reconcile contract: one
``anomalies_total`` + ``anomalies_<signal>`` counter increment co-sited
with an ``event("anomaly", ...)`` and a typed ``kind="anomaly"`` record
(wall-stamped through the clock seam so replays are deterministic).
The ``anomaly`` event is an incident-class trigger for the
:class:`~apex_tpu_torch.observability.recorder.FlightRecorder`, so a drift
that never trips a breaker still leaves a postmortem bundle.

As a satellite duty the sentinel also samples a ``kind="gauge_snapshot"``
record every ``snapshot_every_polls`` polls (labeled gauges + signals
excerpt, paired with a ``gauge_snapshots`` counter) — the live
trajectory feed for ``monitor --follow`` and the bundle's
signal-history section.

Pure stdlib; the detector core (:meth:`DriftSentinel.observe`) takes a
plain signals dict, so tests drive it without a fleet or torch.
Copied from ``apex_tpu/observability/sentinel.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.observability.fleet_metrics import FleetMetrics
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["SentinelConfig", "DriftSentinel", "DEGRADE_DIRECTION"]

_LOG = get_logger(__name__)

#: which way each monitored signal degrades: ``"up"`` fires on values
#: above baseline, ``"down"`` on values below. Signals absent here are
#: treated two-sided.
DEGRADE_DIRECTION: Dict[str, str] = {
    "ttft_p99_s": "up",
    "tpot_p99_s": "up",
    "queue_depth": "up",
    "queued_tokens": "up",
    "goodput_window": "down",
    "spec_accept_rate": "down",
}

#: compact per-poll excerpt stamped into gauge_snapshot records — the
#: trajectory axes the monitor plots and bundles replay
_SNAPSHOT_SIGNALS = ("ttft_p99_s", "tpot_p99_s", "goodput_window",
                     "queue_depth", "inflight", "slot_occupancy",
                     "kv_page_occupancy", "spec_accept_rate")


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Drift-detection policy knobs (validated up front — a bad config
    fails at construction, not at the 400th poll).

    ``signals`` names the ``FleetMetrics.signals()`` keys to watch;
    ``ewma_alpha`` is the baseline learning rate (higher = faster
    adaptation, lower = longer memory); ``z_threshold`` the robust
    z-score that counts as a breach; ``min_abs_dev`` floors the scale
    estimate so a perfectly-flat warmup can't make z explode on the
    first real wiggle. ``snapshot_every_polls=0`` disables the periodic
    gauge_snapshot feed."""

    poll_interval_s: float = 0.25
    warmup_polls: int = 8
    ewma_alpha: float = 0.2
    z_threshold: float = 4.0
    hysteresis_polls: int = 2
    cooldown_s: float = 10.0
    min_abs_dev: float = 1e-3
    snapshot_every_polls: int = 4
    signals: Tuple[str, ...] = ("ttft_p99_s", "tpot_p99_s",
                                "goodput_window", "queue_depth",
                                "spec_accept_rate")

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, "
                f"got {self.poll_interval_s}")
        if self.warmup_polls < 1:
            raise ValueError(
                f"warmup_polls must be >= 1, got {self.warmup_polls}")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if self.z_threshold <= 0:
            raise ValueError(
                f"z_threshold must be > 0, got {self.z_threshold}")
        if self.hysteresis_polls < 1:
            raise ValueError(
                f"hysteresis_polls must be >= 1, "
                f"got {self.hysteresis_polls}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.min_abs_dev <= 0:
            raise ValueError(
                f"min_abs_dev must be > 0, got {self.min_abs_dev}")
        if self.snapshot_every_polls < 0:
            raise ValueError(
                f"snapshot_every_polls must be >= 0, "
                f"got {self.snapshot_every_polls}")
        if not self.signals:
            raise ValueError("signals must name at least one "
                             "FleetMetrics.signals() key")


class _Tracker:
    """One signal's online baseline: EWMA mean + EWMA absolute
    deviation, warmup counter, breach streak, last-fire stamp."""

    __slots__ = ("mean", "dev", "samples", "streak", "last_fire_ts")

    def __init__(self):
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.samples = 0
        self.streak = 0
        self.last_fire_ts: Optional[float] = None

    def update(self, value: float, alpha: float) -> None:
        if self.mean is None:
            self.mean = value
        else:
            self.dev += alpha * (abs(value - self.mean) - self.dev)
            self.mean += alpha * (value - self.mean)
        self.samples += 1

    def z(self, value: float, floor: float) -> float:
        if self.mean is None:
            return 0.0
        return abs(value - self.mean) / max(self.dev, floor)


class DriftSentinel:
    """Online drift detector over ``FleetMetrics.signals()``.

    Mirrors the :class:`~apex_tpu_torch.serving.fleet.autoscale.Autoscaler`
    seam: the fleet tick calls :meth:`maybe_poll(fleet, now)`; the
    sentinel gates on ``poll_interval_s``, holds its own
    :class:`FleetMetrics` (window deltas are per-instance state), and
    emits through the fleet's registry. The pure core,
    :meth:`observe(signals, now)`, returns the anomalies a signals dict
    provokes — unit-testable with no fleet at all.
    """

    def __init__(self, config: Optional[SentinelConfig] = None):
        self.config = config or SentinelConfig()
        self._trackers: Dict[str, _Tracker] = {
            name: _Tracker() for name in self.config.signals}
        self._fm: Optional[FleetMetrics] = None
        self._last_poll: Optional[float] = None
        self._polls = 0
        self._declared = False

    @property
    def polls(self) -> int:
        """Completed observation polls (after the interval gate)."""
        return self._polls

    # -- pure detector core ------------------------------------------------

    def observe(self, signals: Dict[str, object],
                now: float) -> List[dict]:
        """Feed one signals sample; return the anomaly dicts it fires
        (``signal`` / ``value`` / ``baseline`` / ``deviation`` / ``z``).
        Missing or ``None`` signals are skipped — an idle window's
        ``ttft_p99_s=None`` is absence of evidence, not a zero."""
        self._polls += 1
        cfg = self.config
        fired: List[dict] = []
        for name, tracker in self._trackers.items():
            value = signals.get(name)
            if not isinstance(value, (int, float)) or isinstance(
                    value, bool):
                continue
            value = float(value)
            z = tracker.z(value, cfg.min_abs_dev)
            direction = DEGRADE_DIRECTION.get(name)
            degrading = (
                tracker.mean is not None
                and z >= cfg.z_threshold
                and (direction is None
                     or (direction == "up" and value > tracker.mean)
                     or (direction == "down" and value < tracker.mean)))
            armed = tracker.samples >= cfg.warmup_polls
            cooling = (tracker.last_fire_ts is not None
                       and now - tracker.last_fire_ts < cfg.cooldown_s)
            if degrading and armed and not cooling:
                tracker.streak += 1
                if tracker.streak >= cfg.hysteresis_polls:
                    tracker.streak = 0
                    tracker.last_fire_ts = now
                    fired.append({
                        "signal": name,
                        "value": value,
                        "baseline": tracker.mean,
                        "deviation": max(tracker.dev,
                                         cfg.min_abs_dev),
                        "z": z,
                    })
                # a breach is evidence about the incident, not about
                # the healthy baseline: don't absorb it into the EWMA
                continue
            tracker.streak = 0
            tracker.update(value, cfg.ewma_alpha)
        return fired

    # -- fleet-facing seam -------------------------------------------------

    def maybe_poll(self, fleet, now: float) -> List[dict]:
        """Tick-driven entry point: interval-gate, sample the fleet's
        signals, emit any anomalies + the periodic gauge_snapshot.
        Returns the anomalies fired this poll (``[]`` when gated)."""
        if (self._last_poll is not None
                and now - self._last_poll < self.config.poll_interval_s):
            return []
        self._last_poll = now
        if self._fm is None or self._fm.fleet is not fleet:
            self._fm = FleetMetrics(fleet)
        registry = fleet.metrics
        if not self._declared:
            registry.declare_counters(
                "anomalies_total", "gauge_snapshots",
                *(f"anomalies_{name}" for name in self.config.signals))
            self._declared = True
        signals = self._fm.signals()
        fired = self.observe(signals, now)
        from apex_tpu_torch.serving import clock
        for anomaly in fired:
            # counter + event + typed record co-sited: the reconcile
            # contract (counters move iff their event was emitted)
            registry.inc("anomalies_total")
            registry.inc(f"anomalies_{anomaly['signal']}")
            log_event(_LOG, "anomaly", **anomaly)
            registry.event("anomaly", **anomaly)
            registry.emit_record({"kind": "anomaly",
                                  "wall": clock.wall(), **anomaly})
        every = self.config.snapshot_every_polls
        if every and self._polls % every == 0:
            registry.inc("gauge_snapshots")
            registry.emit_record({
                "kind": "gauge_snapshot", "wall": clock.wall(),
                "signals": {k: signals.get(k)
                            for k in _SNAPSHOT_SIGNALS},
                "gauges": self._fm.labeled_gauges()})
        return fired
