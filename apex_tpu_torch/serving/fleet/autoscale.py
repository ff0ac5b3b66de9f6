"""SLO-driven autoscaling for :class:`~apex_tpu_torch.serving.fleet.ReplicaFleet`.

Closes the serve half of the ROADMAP's train->serve loop: the fleet's
size stops being frozen at construction. An :class:`Autoscaler` is a
policy object polled from the fleet tick loop
(``ReplicaFleet(..., autoscale=AutoscaleConfig(...))``). Each poll it
reads :meth:`~apex_tpu_torch.observability.FleetMetrics.signals` — windowed
goodput, queue depth plus the token-weighted ``queued_tokens`` backlog,
merged TTFT/TPOT p99, slot/page occupancy — and decides between
``min_replicas`` and ``max_replicas``:

- **scale-up** spawns a replica through the existing
  rebuild-and-health-probe path (:meth:`ReplicaFleet.add_replica`): the
  new replica joins the dispatch set only after a real one-token probe
  request succeeds, so a scale-up can never route traffic at an engine
  that cannot serve.
- **scale-down** retires the least-loaded ACTIVE replica through
  ``drain_restart``'s migrate-or-finish machinery
  (:meth:`ReplicaFleet.retire_replica`): in-flight work migrates
  token-exact or finishes in place — no request dropped — and the id is
  removed from the router's cost/residency tables and every live
  per-replica metrics view.

Decisions are deliberately sluggish: a direction must hold for
``hysteresis_polls`` consecutive polls, at most one topology change per
``cooldown_s`` window, and the autoscaler holds entirely while any
replica is draining/probing or a deployment is rolling — signal noise
cannot flap the fleet. Every applied decision is emitted as a typed
``kind="autoscale"`` record plus a ``replica_scale_up``/
``replica_scale_down`` event+counter pair that the monitor's fleet
section reconciles key-for-key.

The policy itself (:meth:`Autoscaler.desired_direction`) is a pure
function of one signals dict — unit-testable without a fleet, an
engine, or torch.
Copied from ``apex_tpu/serving/fleet/autoscale.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from apex_tpu_torch.observability.fleet_metrics import FleetMetrics
from apex_tpu_torch.serving import clock
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["AutoscaleConfig", "Autoscaler"]

_LOG = get_logger(__name__)

#: signals keys echoed into each kind="autoscale" decision record — the
#: evidence the decision was made on, for the monitor's timeline
_DECISION_SIGNALS = ("replicas_total", "replicas_dispatchable",
                     "queue_depth", "queued_tokens", "inflight",
                     "goodput_window", "window_terminal", "window_s",
                     "ttft_p99_s", "slot_occupancy")


@dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs (docs/serving.md#autoscaling).

    Scale-up triggers (any one suffices; 0 disables a trigger):

    - ``scale_up_queue_per_replica`` — queued requests per dispatchable
      replica above this means admission is outrunning capacity;
    - ``scale_up_queued_tokens_per_replica`` — same, token-weighted
      (a backlog of LONG prompts trips this before raw depth does);
    - ``scale_up_goodput`` — windowed goodput below this *with traffic
      in the window* (``window_terminal > 0``; an idle window's 0.0
      never scales up);
    - ``scale_up_ttft_p99_s`` — merged TTFT p99 above the SLO bound.

    Scale-down requires quiet on EVERY axis: queue per replica at or
    under ``scale_down_queue_per_replica`` AND slot occupancy at or
    under ``scale_down_slot_occupancy`` (an unmeasurable occupancy
    counts as quiet).

    Flap damping: a direction must hold ``hysteresis_polls``
    consecutive polls (spaced ``poll_interval_s`` apart) and applied
    decisions are at least ``cooldown_s`` apart.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    poll_interval_s: float = 0.25
    cooldown_s: float = 2.0
    hysteresis_polls: int = 2
    scale_up_queue_per_replica: float = 4.0
    scale_up_queued_tokens_per_replica: float = 0.0
    scale_up_goodput: float = 0.0
    scale_up_ttft_p99_s: float = 0.0
    scale_down_queue_per_replica: float = 0.5
    scale_down_slot_occupancy: float = 0.25

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {self.poll_interval_s}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.hysteresis_polls < 1:
            raise ValueError(
                f"hysteresis_polls must be >= 1, got "
                f"{self.hysteresis_polls}")
        for knob in ("scale_up_queue_per_replica",
                     "scale_up_queued_tokens_per_replica",
                     "scale_up_goodput", "scale_up_ttft_p99_s",
                     "scale_down_queue_per_replica",
                     "scale_down_slot_occupancy"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob} must be >= 0, got {getattr(self, knob)}")
        if not 0.0 <= self.scale_up_goodput <= 1.0:
            raise ValueError(
                f"scale_up_goodput must be in [0, 1], got "
                f"{self.scale_up_goodput}")
        if (self.scale_up_queue_per_replica > 0
                and self.scale_down_queue_per_replica
                >= self.scale_up_queue_per_replica):
            raise ValueError(
                f"scale_down_queue_per_replica "
                f"({self.scale_down_queue_per_replica}) must be < "
                f"scale_up_queue_per_replica "
                f"({self.scale_up_queue_per_replica}) — overlapping "
                f"bands would flap")


class Autoscaler:
    """The fleet-size policy; polled via :meth:`maybe_scale` from
    ``ReplicaFleet.tick``. Holds its OWN :class:`FleetMetrics` view so
    its goodput window is private — an application also polling
    ``signals()`` on its own view cannot steal the autoscaler's window
    deltas."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self._fm: Optional[FleetMetrics] = None
        self._last_poll: Optional[float] = None
        self._last_action_ts: Optional[float] = None
        self._streak_dir: Optional[str] = None
        self._streak = 0
        #: applied decisions, for tests and callers: (now, action,
        #: replica_id, reason) tuples in order
        self.decisions: List[Tuple[float, str, int, str]] = []

    # -- the pure policy ---------------------------------------------------

    def desired_direction(self, signals: dict
                          ) -> Tuple[Optional[str], Optional[str]]:
        """Map one signals dict to ``("up"|"down"|None, reason)`` —
        pure, no side effects, no fleet access."""
        cfg = self.config
        dispatchable = max(1, signals.get("replicas_dispatchable") or 0)
        queue_per = (signals.get("queue_depth") or 0) / dispatchable
        if (cfg.scale_up_queue_per_replica > 0
                and queue_per > cfg.scale_up_queue_per_replica):
            return "up", "queue_depth"
        tokens_per = (signals.get("queued_tokens") or 0) / dispatchable
        if (cfg.scale_up_queued_tokens_per_replica > 0
                and tokens_per > cfg.scale_up_queued_tokens_per_replica):
            return "up", "queued_tokens"
        # goodput is only evidence when the window saw traffic: an idle
        # window reports 0.0 with window_terminal == 0 — never scale on it
        if (cfg.scale_up_goodput > 0
                and (signals.get("window_terminal") or 0) > 0
                and signals.get("goodput_window", 1.0)
                < cfg.scale_up_goodput):
            return "up", "goodput"
        ttft = signals.get("ttft_p99_s")
        if (cfg.scale_up_ttft_p99_s > 0 and ttft is not None
                and ttft > cfg.scale_up_ttft_p99_s):
            return "up", "ttft_p99"
        occupancy = signals.get("slot_occupancy")
        if (queue_per <= cfg.scale_down_queue_per_replica
                and (occupancy is None
                     or occupancy <= cfg.scale_down_slot_occupancy)):
            return "down", "idle"
        return None, None

    # -- the fleet-side actuator ------------------------------------------

    def maybe_scale(self, fleet, now: Optional[float] = None
                    ) -> Optional[str]:
        """One poll: read signals, damp, and apply at most one topology
        change. Returns ``"up"``/``"down"`` when a change was applied,
        else None. Safe to call every tick — the poll interval is
        enforced internally."""
        if now is None:
            now = clock.now()
        if (self._last_poll is not None
                and now - self._last_poll < self.config.poll_interval_s):
            return None
        self._last_poll = now
        if self._fm is None or self._fm.fleet is not fleet:
            self._fm = FleetMetrics(fleet)
        signals = self._fm.signals()
        direction, reason = self.desired_direction(signals)
        # clamp to bounds BEFORE streak accounting: a direction the
        # bounds forbid is no direction at all
        n = fleet.n_replicas
        if direction == "up" and n >= self.config.max_replicas:
            direction = None
        if direction == "down" and n <= self.config.min_replicas:
            direction = None
        if direction is None:
            self._streak_dir, self._streak = None, 0
            return None
        if direction == self._streak_dir:
            self._streak += 1
        else:
            self._streak_dir, self._streak = direction, 1
        if self._streak < self.config.hysteresis_polls:
            return None
        if (self._last_action_ts is not None
                and now - self._last_action_ts < self.config.cooldown_s):
            return None
        # hold (without resetting the streak) while the fleet is mid
        # topology change or a deployment is rolling — one change at a
        # time is the fleet's invariant, not just ours
        if fleet.topology_busy is not None:
            return None
        deployment = getattr(fleet, "deployment", None)
        if deployment is not None and not deployment.done:
            return None
        if direction == "up":
            replica_id = fleet.add_replica()
        else:
            replica_id = self._retire_target(fleet)
            if replica_id is None:
                return None
            fleet.retire_replica(replica_id)
        self._last_action_ts = now
        self._streak_dir, self._streak = None, 0
        self.decisions.append((now, direction, replica_id, reason))
        excerpt = {k: signals.get(k) for k in _DECISION_SIGNALS}
        log_event(_LOG, f"autoscale_{direction}", replica_id=replica_id,
                  reason=reason, n_replicas=fleet.n_replicas)
        fleet.metrics.emit_record({
            "kind": "autoscale",
            "action": f"scale_{direction}",
            "replica_id": replica_id,
            "reason": reason,
            "n_replicas": fleet.n_replicas,
            "signals": excerpt,
            "wall": clock.wall()})
        return direction

    @staticmethod
    def _retire_target(fleet) -> Optional[int]:
        """Least-loaded ACTIVE replica; depth ties retire the YOUNGEST
        id (scale-ups unwind in reverse order, keeping the original
        replicas long-lived)."""
        from apex_tpu_torch.serving.fleet.router import REPLICA_ACTIVE, Router
        candidates = [r for r in fleet.replicas
                      if r.state == REPLICA_ACTIVE]
        if len(candidates) < 2:
            return None
        target = min(candidates,
                     key=lambda r: (Router.depth(r), -r.replica_id))
        return target.replica_id
