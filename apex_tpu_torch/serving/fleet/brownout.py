"""Brownout ladder: staged degradation under sustained overload.

When the fleet is saturated past what autoscaling can absorb (bounds
hit, or pressure rising faster than replicas can build), the remaining
choice is WHICH traffic degrades. Without a policy that choice is made
implicitly — FCFS queues and deadline sheds hit interactive users first,
exactly backwards. The :class:`BrownoutController` makes it
explicit: polled from ``ReplicaFleet.tick`` like the autoscaler, it
reads the same :meth:`~apex_tpu_torch.observability.FleetMetrics.signals`
stream and walks a ladder of increasingly aggressive rungs, degrading
best-effort traffic first and touching standard traffic only as the
last step before the existing shed machinery takes over:

====  ================  ==================================================
rung  name              effect
====  ================  ==================================================
0     ``normal``        no degradation
1     ``pause_batch``   admission floor ``standard``: queued batch
                        requests stop dispatching (they stay queued;
                        deadlines still apply)
2     ``preempt_batch`` one-shot: every RUNNING batch slot is parked
                        (:meth:`~apex_tpu_torch.serving.EngineSupervisor.\
preempt_class`) and its token-exact resume continuation re-queued —
                        slots and pages hand over to higher classes now
3     ``clamp_batch``   batch submits get ``max_new_tokens`` clamped to
                        ``clamp_max_new_tokens`` — best-effort work
                        still flows, but each admission is bounded
4     ``pause_standard``  admission floor ``interactive``: only
                        interactive traffic dispatches
====  ================  ==================================================

Escalation requires ``hot_polls`` consecutive polls with per-replica
queue pressure above ``queue_depth_high``; recovery (one rung at a
time, in reverse) requires ``cool_polls`` consecutive polls below
``queue_depth_low``. Pressure counts only ADMISSIBLE queued work:
requests held by the current rung's own admission floor are excluded,
so a paused class's (intentionally) retained backlog can never keep
the ladder hot — without that exclusion a pure-batch storm would wedge
at the top rung forever instead of breathing back down. The gap between the two thresholds plus the
streak requirement is the hysteresis that keeps the ladder from
flapping. Every transition emits a typed ``kind="brownout"`` record
plus a ``brownout_escalate``/``brownout_recover`` event+counter pair
the monitor reconciles key-for-key
(docs/serving.md#priority-preemption-and-quotas).

Copied from ``apex_tpu/serving/fleet/brownout.py``, so the port never
imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from apex_tpu_torch.observability.fleet_metrics import FleetMetrics
from apex_tpu_torch.serving import clock
from apex_tpu_torch.serving.request import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    PRIORITY_RANK,
    PRIORITY_STANDARD,
    Request,
)
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["BrownoutConfig", "BrownoutController", "BROWNOUT_RUNGS"]

_LOG = get_logger(__name__)

#: ladder rungs in escalation order (index == rung number)
BROWNOUT_RUNGS = ("normal", "pause_batch", "preempt_batch",
                  "clamp_batch", "pause_standard")
_RUNG_PAUSE_BATCH = 1
_RUNG_PREEMPT_BATCH = 2
_RUNG_CLAMP_BATCH = 3
_RUNG_PAUSE_STANDARD = 4


@dataclass(frozen=True)
class BrownoutConfig:
    """Ladder knobs (docs/serving.md#priority-preemption-and-quotas).

    Pressure is queued requests per dispatchable replica — the same
    ``queue_depth`` / ``replicas_dispatchable`` ratio the autoscaler
    triggers on, so the two controllers agree about what "overloaded"
    means. ``queue_depth_high`` must exceed ``queue_depth_low``; the
    band between them is the neutral zone where streaks reset.
    ``max_rung`` caps how far the ladder may escalate (default: the
    whole ladder)."""

    poll_interval_s: float = 0.25
    queue_depth_high: float = 8.0
    queue_depth_low: float = 2.0
    hot_polls: int = 2
    cool_polls: int = 2
    clamp_max_new_tokens: int = 32
    max_rung: int = len(BROWNOUT_RUNGS) - 1

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {self.poll_interval_s}")
        if self.queue_depth_high <= 0:
            raise ValueError(
                f"queue_depth_high must be > 0, got "
                f"{self.queue_depth_high}")
        if not 0 <= self.queue_depth_low < self.queue_depth_high:
            raise ValueError(
                f"queue_depth_low ({self.queue_depth_low}) must be in "
                f"[0, queue_depth_high={self.queue_depth_high}) — "
                f"overlapping bands would flap")
        if self.hot_polls < 1:
            raise ValueError(
                f"hot_polls must be >= 1, got {self.hot_polls}")
        if self.cool_polls < 1:
            raise ValueError(
                f"cool_polls must be >= 1, got {self.cool_polls}")
        if self.clamp_max_new_tokens < 1:
            raise ValueError(
                f"clamp_max_new_tokens must be >= 1, got "
                f"{self.clamp_max_new_tokens}")
        if not 0 <= self.max_rung < len(BROWNOUT_RUNGS):
            raise ValueError(
                f"max_rung must be in [0, {len(BROWNOUT_RUNGS) - 1}], "
                f"got {self.max_rung}")


class BrownoutController:
    """The degradation policy; polled via :meth:`maybe_step` from
    ``ReplicaFleet.tick`` (after the autoscaler and sentinel, so it
    sees the tick's final queue state). Holds its OWN
    :class:`FleetMetrics` view — window privacy, same as the
    autoscaler."""

    def __init__(self, config: Optional[BrownoutConfig] = None):
        self.config = config or BrownoutConfig()
        self.rung = 0
        self._fm: Optional[FleetMetrics] = None
        self._last_poll: Optional[float] = None
        self._hot = 0
        self._cool = 0
        #: applied transitions, for tests and callers: (now, action, rung,
        #: pressure) tuples in order
        self.transitions: List[Tuple[float, str, int, float]] = []

    @property
    def rung_name(self) -> str:
        return BROWNOUT_RUNGS[self.rung]

    def admission_floor(self) -> Optional[str]:
        """The scheduler floor the current rung implies (None = all
        classes dispatch)."""
        if self.rung >= _RUNG_PAUSE_STANDARD:
            return PRIORITY_INTERACTIVE
        if self.rung >= _RUNG_PAUSE_BATCH:
            return PRIORITY_STANDARD
        return None

    def clamp(self, request: Request) -> Request:
        """At ``clamp_batch`` and above, bound a batch request's
        ``max_new_tokens`` to the configured clamp — same ids, same
        deadline clock, same trace, so exactly-once accounting and span
        conservation are untouched. Everything else passes through."""
        cap = self.config.clamp_max_new_tokens
        if (self.rung < _RUNG_CLAMP_BATCH
                or request.sampling.priority != PRIORITY_BATCH
                or request.max_new_tokens <= cap):
            return request
        return Request(
            prompt=list(request.prompt), max_new_tokens=cap,
            sampling=request.sampling, eos_token=request.eos_token,
            deadline_s=request.deadline_s,
            request_id=request.request_id,
            arrival_ts=request.arrival_ts, trace_id=request.trace_id)

    @staticmethod
    def pressure(signals: dict) -> float:
        """Queued requests per dispatchable replica — pure, so the
        ladder policy is unit-testable from a signals dict alone."""
        dispatchable = max(1, signals.get("replicas_dispatchable") or 0)
        return (signals.get("queue_depth") or 0) / dispatchable

    def _held_depth(self, fleet) -> int:
        """Queued requests the CURRENT admission floor is holding.
        They are excluded from the pressure the ladder judges: a paused
        class keeps its backlog queued by design, and counting it would
        let the ladder escalate on (and then never recover from) its
        own backpressure — a pure-batch storm would wedge at the top
        rung with batch starved forever instead of breathing back down
        once the admissible queue drains."""
        floor = self.admission_floor()
        if floor is None:
            return 0
        rank = PRIORITY_RANK[floor]
        held = 0
        for replica in fleet.replicas:
            by = getattr(replica.supervisor.engine,
                         "queued_depth_by_class", None)
            if by is not None:
                held += sum(n for p, n in by().items()
                            if PRIORITY_RANK[p] > rank)
        for req in getattr(fleet, "_backlog", ()):
            if PRIORITY_RANK.get(req.sampling.priority, 0) > rank:
                held += 1
        return held

    def maybe_step(self, fleet, now: Optional[float] = None
                   ) -> Optional[str]:
        """One poll: read signals, update streaks, move at most one
        rung. Returns ``"escalate"``/``"recover"`` when a transition
        was applied, else None. Safe to call every tick — the poll
        interval is enforced internally, and the current rung's
        admission floor is re-asserted each poll so replicas built
        mid-brownout (autoscale-ups, rebuilds) inherit it."""
        if now is None:
            now = clock.now()
        if (self._last_poll is not None
                and now - self._last_poll < self.config.poll_interval_s):
            return None
        self._last_poll = now
        if self._fm is None or self._fm.fleet is not fleet:
            self._fm = FleetMetrics(fleet)
        signals = dict(self._fm.signals())
        signals["queue_depth"] = max(
            0, (signals.get("queue_depth") or 0) - self._held_depth(fleet))
        pressure = self.pressure(signals)
        self._assert_floor(fleet)
        cfg = self.config
        if pressure > cfg.queue_depth_high:
            self._hot += 1
            self._cool = 0
            if self._hot >= cfg.hot_polls and self.rung < cfg.max_rung:
                return self._apply(fleet, self.rung + 1, "escalate",
                                   pressure, now)
        elif pressure < cfg.queue_depth_low:
            self._cool += 1
            self._hot = 0
            if self._cool >= cfg.cool_polls and self.rung > 0:
                return self._apply(fleet, self.rung - 1, "recover",
                                   pressure, now)
        else:
            # neutral zone: neither streak advances — the hysteresis
            # band that keeps a noisy signal from walking the ladder
            self._hot = 0
            self._cool = 0
        return None

    def _assert_floor(self, fleet) -> None:
        floor = self.admission_floor()
        for replica in fleet.replicas:
            fn = getattr(replica.supervisor, "set_admission_floor", None)
            if fn is not None:
                fn(floor)

    def _apply(self, fleet, new_rung: int, action: str,
               pressure: float, now: float) -> str:
        self.rung = new_rung
        self._hot = 0
        self._cool = 0
        self._assert_floor(fleet)
        parked = 0
        if action == "escalate" and new_rung == _RUNG_PREEMPT_BATCH:
            # one-shot at entry: park every running batch slot; the
            # floor (already at "standard") keeps new ones from starting
            from apex_tpu_torch.serving.fleet.router import REPLICA_ACTIVE
            for replica in fleet.replicas:
                if replica.state != REPLICA_ACTIVE:
                    continue
                fn = getattr(replica.supervisor, "preempt_class", None)
                if fn is not None:
                    parked += fn(PRIORITY_BATCH, cause="brownout")
        self.transitions.append((now, action, new_rung, pressure))
        counter = ("brownouts_escalated" if action == "escalate"
                   else "brownouts_recovered")
        event = ("brownout_escalate" if action == "escalate"
                 else "brownout_recover")
        fleet.metrics.inc(counter)
        log_event(_LOG, event, rung=new_rung,
                  rung_name=self.rung_name, pressure=pressure,
                  parked=parked)
        fleet.metrics.event(event, rung=new_rung,
                            rung_name=self.rung_name,
                            pressure=pressure, parked=parked)
        fleet.metrics.emit_record({
            "kind": "brownout", "action": action, "rung": new_rung,
            "rung_name": self.rung_name, "pressure": pressure,
            "parked": parked, "wall": clock.wall()})
        return action
