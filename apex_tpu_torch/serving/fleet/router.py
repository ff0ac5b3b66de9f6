"""Replica fleet: N supervised engines behind one ``submit()`` front door
(counterpart of ``apex_tpu/serving/fleet/router.py``).

:class:`ReplicaFleet` runs ``n_replicas``
:class:`~apex_tpu_torch.serving.EngineSupervisor`-wrapped replicas (each a
full engine: own slot pool, own KV caches — or another engine built by
``engine_factory=``) behind a single front door:

- **Least-loaded dispatch** (:class:`Router`): each submit goes to the
  replica minimizing ``queue_depth × EWMA(service_s)`` — the SAME
  service-time estimate the supervisor's deadline shedding maintains
  (:attr:`~apex_tpu_torch.serving.EngineSupervisor.service_estimate_s`), so
  routing and shedding agree about how loaded a replica is — plus the
  supervisor's token-aware surcharge
  (:attr:`~apex_tpu_torch.serving.EngineSupervisor.queued_token_excess_s`)
  so a backlog of unusually LONG prompts prices above the same depth
  of short ones. Ties break by depth then replica id, keeping runs
  deterministic.
- **Prefix-affinity dispatch**: the router hashes each prompt's
  page-aligned prefix with the SAME chain the engine's prefix cache
  interns (:func:`~apex_tpu_torch.serving.prefix.prefix_hash_chain`) and
  folds a BOUNDED discount into the least-loaded cost for replicas
  that recently served a matching prefix — their intern index likely
  still holds the pages, so the request prefills only its suffix
  there. Bounded means multiplicative, at most
  ``prefix_affinity_weight < 1``: a hot replica's cost can shrink but
  never reach zero, so load still sheds to cold peers. Residency is
  tracked from dispatch history (bounded LRU per replica) and
  invalidated on rebuild — a rebuilt replica has an empty intern
  index, so stale affinity would route misses at it.
- **Sticky routing**: an admitted request stays on its replica;
  ``cancel()`` and result harvesting follow it there (and through a
  migration to wherever it went).
- **Fleet-wide admission control**: a replica with an OPEN circuit
  breaker leaves the dispatch set instead of fast-failing the caller —
  traffic flows to healthy peers, while the sick replica keeps ticking
  so its breaker can half-open and probe.
  :class:`FleetUnavailableError` (recorded terminally, like every
  rejection in this stack) only when NO replica is dispatchable.
- **Draining restarts**: :meth:`ReplicaFleet.drain_restart` quiesces a
  replica — dispatch stops, in-flight work either finishes in place or
  is handed to a peer through the supervisor's token-exact
  re-prefill continuations
  (:meth:`~apex_tpu_torch.serving.EngineSupervisor.detach_for_migration`) —
  then rebuilds it from scratch (fresh supervisor, fresh engine; the
  service-time EWMA is CARRIED so the rebuilt replica does not shed
  blind), health-probes it with a real one-token request, and
  rejoins it to the dispatch set. Only one replica may drain at a time,
  so a rebuild never drops fleet capacity below N−1.

Telemetry follows the serving contract: fleet counters
(``fleet_dispatches`` = Σ ``replica<i>_dispatches``, ``replica_drains``,
``replica_rebuilds``, ``requests_migrated``, ``requests_shed_fleet``)
are incremented at the same sites as their ``kind="event"`` incident
records, every terminal request record carries the ``replica_id`` that
retired it, and ``python -m apex_tpu_torch.monitor`` renders a fleet
section reconciling the two key-for-key.

Where the port differs from the JAX fleet:

- the port's model owns its parameters, so ``ReplicaFleet(model, config,
  *, ..., device="cuda")`` takes no ``params``: every replica's engine
  serves ``model`` (in a 16-bit ``compute_dtype`` each engine casts its
  own copy). A canary deploy gives its replica a module of its own
  (``_replica_models``, the JAX fleet's ``_replica_params``); a rollback
  drops it and rebuilds the replica on the incumbent model;
- a drained, retired or rolled-back replica's supervisor releases its
  KV pools and cast model copy
  (:meth:`~apex_tpu_torch.serving.EngineSupervisor.release_device_memory`)
  before its replacement allocates, so repeated drains do not grow the
  card's memory;
- :meth:`ReplicaFleet.tick` ticks the replicas in turn on one host
  thread, and each replica's tick ends in a host read, so on one card
  two replicas' device work does not overlap (as in the JAX fleet).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.observability.fleet_metrics import ReplicaRegistry
from apex_tpu_torch.observability.trace import (
    SPAN_DECODE,
    SPAN_MIGRATION,
    SPAN_SHED,
    emit_span,
)
from apex_tpu_torch.serving import clock
from apex_tpu_torch.serving.engine import EngineConfig
from apex_tpu_torch.serving.prefix import (
    adapter_salt,
    common_chain_len,
    prefix_hash_chain,
    prefix_salt,
)
from apex_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISH_TIMEOUT,
    PRIORITY_RANK,
    PRIORITY_STANDARD,
    Request,
    RequestResult,
    SamplingParams,
)
from apex_tpu_torch.serving.scheduler import DeadlineExpiredError, QueueFullError
from apex_tpu_torch.serving.supervisor import (
    BREAKER_OPEN,
    EngineSupervisor,
    EngineUnavailableError,
    SupervisorConfig,
)
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["FleetUnavailableError", "FleetConfig", "Router", "ReplicaFleet",
           "REPLICA_ACTIVE", "REPLICA_DRAINING", "REPLICA_PROBING",
           "REPLICA_FAILED"]

_LOG = get_logger(__name__)

#: replica lifecycle states (``ReplicaFleet.replica_states``)
REPLICA_ACTIVE = "active"        # in the dispatch set (breaker permitting)
REPLICA_DRAINING = "draining"    # quiescing: no new dispatches
REPLICA_PROBING = "probing"      # rebuilt, health probe in flight
REPLICA_FAILED = "failed"        # rebuild probes exhausted; out for good

#: declared up front so the final snapshot carries every key even when
#: an incident type never fired — the monitor's fleet section reconciles
#: these against the event stream key-for-key
_FLEET_COUNTERS = ("fleet_dispatches", "replica_drains", "replica_rebuilds",
                   "requests_migrated", "requests_shed_fleet",
                   # autoscaling + continuous deployment: each
                   # counter pairs with a same-named kind="event" record
                   "replica_scale_ups", "replica_scale_downs",
                   "deploys_started", "deploys_completed",
                   "deploys_rolled_back", "deploys_rejected",
                   "canary_promotions",
                   # per-tenant quotas + the brownout ladder:
                   # same counter<->event pairing contract
                   "requests_shed_quota", "requests_deferred_quota",
                   "brownouts_escalated", "brownouts_recovered")


class FleetUnavailableError(EngineUnavailableError):
    """No replica is dispatchable: every one is drained, failed, or has
    an open circuit breaker. The request IS recorded terminally
    (``finish_reason="rejected"``) — the fleet-wide analogue of the
    supervisor's fail-fast contract."""


@dataclass
class FleetConfig:
    """Fleet sizing and drain-lifecycle knobs (docs/serving.md#fleet).

    ``migrate_on_drain`` picks the drain policy: True hands in-flight
    work to peers immediately (token-exact re-prefill — the drain
    completes as fast as one rebuild), False lets the draining replica
    finish its own work first (no migration cost, slower drain).
    ``probe_on_rebuild`` gates the health probe — a real one-token
    greedy request served end-to-end before the replica rejoins;
    ``max_rebuild_probes`` failed probes mark the replica FAILED
    instead of looping a persistently-broken rebuild forever.
    ``prefix_affinity_weight`` caps the routing discount for replicas
    with a resident matching prefix (0 disables affinity; must stay
    < 1 so load always dominates a full-prefix match).
    """

    n_replicas: int = 2
    migrate_on_drain: bool = True
    probe_on_rebuild: bool = True
    max_rebuild_probes: int = 3
    prefix_affinity_weight: float = 0.3

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(
                f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.max_rebuild_probes < 1:
            raise ValueError(
                f"max_rebuild_probes must be >= 1, got "
                f"{self.max_rebuild_probes}")
        if not 0.0 <= self.prefix_affinity_weight < 1.0:
            raise ValueError(
                f"prefix_affinity_weight must be in [0, 1), got "
                f"{self.prefix_affinity_weight}")


class _Replica:
    """One fleet slot: a supervisor plus its lifecycle state.

    ``retire_on_drain`` marks a scale-down: when the drain empties, the
    replica is REMOVED from the fleet (:meth:`ReplicaFleet._finish_retire`)
    instead of rebuilt — the terminal leg of ``retire_replica``.
    """

    __slots__ = ("replica_id", "supervisor", "state", "dispatches",
                 "probe_id", "probe_attempts", "retire_on_drain")

    def __init__(self, replica_id: int, supervisor: EngineSupervisor):
        self.replica_id = replica_id
        self.supervisor = supervisor
        self.state = REPLICA_ACTIVE
        self.dispatches = 0
        self.probe_id: Optional[int] = None
        self.probe_attempts = 0
        self.retire_on_drain = False


class _FleetTracked:
    """Fleet-side state of one admitted-and-not-yet-terminal request —
    survives replica migrations the way the supervisor's ``_Tracked``
    survives engine rebuilds."""

    __slots__ = ("request", "first_submit_ts", "prefix", "order",
                 "replica_id", "migrations")

    def __init__(self, request: Request, submit_ts: float, order: int):
        self.request = request
        self.first_submit_ts = submit_ts
        self.prefix: List[int] = []   # tokens recovered from drained peers
        self.order = order
        self.replica_id: Optional[int] = None   # current home (sticky)
        self.migrations = 0


class Router:
    """The dispatch policy: least loaded first, prefix-affinity aware.

    Cost of a replica is ``depth × service_s`` where ``depth`` counts
    everything already committed to it (queued + backlogged + active
    slots) and ``service_s`` is the supervisor's deadline-shedding EWMA
    — before the first completion the EWMA is unknown and the replica
    costs 0, which deliberately attracts traffic to fresh (just
    rebuilt) replicas. Deterministic: ties break by depth, then id.

    When the fleet hands :meth:`pick` a prefix hash chain, the cost is
    discounted multiplicatively for replicas whose recent dispatch
    history (:meth:`note_dispatch`, a bounded per-replica LRU of
    chains) contains a matching prefix run:
    ``cost × (1 − weight × share)`` with ``share`` the matched fraction
    of the request's chain. The discount is BOUNDED by
    ``affinity_weight < 1`` — a perfect match shrinks the cost by at
    most that factor, so a deeply-loaded hot replica still loses to an
    idle cold one and affinity can never starve the fleet onto one
    replica. On exact cost-and-depth ties the better match wins (that
    is what routes a cold fleet's repeat prefixes together before any
    EWMA exists). :meth:`invalidate` forgets a replica's residency when
    its engine is rebuilt (fresh intern index — nothing is resident).
    """

    def __init__(self, affinity_weight: float = 0.0,
                 residency_capacity: int = 128):
        if not 0.0 <= affinity_weight < 1.0:
            raise ValueError(
                f"affinity_weight must be in [0, 1), got "
                f"{affinity_weight}")
        if residency_capacity < 1:
            raise ValueError(
                f"residency_capacity must be >= 1, got "
                f"{residency_capacity}")
        self.affinity_weight = affinity_weight
        self.residency_capacity = residency_capacity
        self._resident: Dict[int, "OrderedDict[Tuple[int, ...], None]"] \
            = {}

    @staticmethod
    def depth(replica: _Replica) -> int:
        sup = replica.supervisor
        return sup.queued_count + sup.active_count

    @classmethod
    def cost(cls, replica: _Replica) -> Tuple[float, int, int]:
        depth = cls.depth(replica)
        service = replica.supervisor.service_estimate_s
        # depth x EWMA(service) underprices a backlog of LONG prompts —
        # fold in the supervisor's token-aware surcharge (0.0 until the
        # per-token prefill rate has been measured, so a fresh replica
        # still costs exactly 0 and routing stays deterministic)
        base = depth * service if service is not None else 0.0
        # getattr: the router prices any supervisor-shaped object (test
        # stubs included); no surcharge is indistinguishable from a
        # not-yet-measured one
        base += getattr(replica.supervisor, "queued_token_excess_s", 0.0)
        return (base, depth, replica.replica_id)

    def affinity(self, replica_id: int,
                 chain: Optional[Sequence[int]]) -> float:
        """Matched fraction of ``chain`` best resident on a replica,
        in [0, 1] — 0 when no chain, no residency, or no common run."""
        if not chain:
            return 0.0
        resident = self._resident.get(replica_id)
        if not resident:
            return 0.0
        best = 0
        for r in resident:
            n = common_chain_len(r, chain)
            if n > best:
                best = n
        return best / len(chain)

    def pick(self, candidates: Sequence[_Replica],
             chain: Optional[Sequence[int]] = None) -> _Replica:
        if not candidates:
            raise ValueError("no candidates to route to")
        w = self.affinity_weight

        def key(replica: _Replica):
            base, depth, rid = self.cost(replica)
            share = self.affinity(replica.replica_id, chain) \
                if w > 0.0 else 0.0
            # -share: on exact (cost, depth) ties prefer the replica
            # holding the longer resident run — replica id still breaks
            # true ties, keeping routing deterministic
            return (base * (1.0 - w * share), depth, -share, rid)

        return min(candidates, key=key)

    def note_dispatch(self, replica_id: int,
                      chain: Optional[Sequence[int]]) -> None:
        """Record that a prompt with this chain was dispatched to the
        replica — its engine will intern the prefix on prefill, so the
        run becomes resident there. Bounded LRU per replica."""
        if not chain:
            return
        resident = self._resident.setdefault(replica_id, OrderedDict())
        resident[tuple(chain)] = None
        resident.move_to_end(tuple(chain))
        while len(resident) > self.residency_capacity:
            resident.popitem(last=False)

    def invalidate(self, replica_id: int) -> None:
        """Forget a replica's residency (engine rebuilt: empty intern
        index)."""
        self._resident.pop(replica_id, None)


class ReplicaFleet:
    """Horizontally scaled serving tier; see the module docstring. The
    driving surface mirrors :class:`~apex_tpu_torch.serving.EngineSupervisor`
    (``submit`` / ``cancel`` / ``tick`` / ``serve`` / ``close``,
    results in :attr:`completed`), so the loadtest runner and other
    callers work against either unchanged.

    ``faults`` may be a single ``ServingFaultInjector`` (applied to
    replica 0) or a ``{replica_id: injector}`` dict; injector call
    counters keep advancing across replica rebuilds, so a scheduled
    fault fires exactly once fleet-wide.
    """

    def __init__(self, model,
                 config: Optional[EngineConfig] = None, *,
                 supervisor: Optional[SupervisorConfig] = None,
                 fleet: Optional[FleetConfig] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None, router: Optional[Router] = None,
                 engine_factory=None, adapters=None, autoscale=None,
                 sentinel=None, quotas=None, brownout=None,
                 device="cuda"):
        #: the incumbent model every replica serves (a completed
        #: checkpoint deploy replaces it)
        self._model = model
        self._device = device
        #: shared LoRA :class:`~apex_tpu_torch.lora.AdapterStore` — every
        #: replica's supervisor (and engine incarnation) reads the SAME
        #: store, so one load()/unload() takes effect fleet-wide and a
        #: migrated continuation finds its adapter on the new replica
        self._adapters = adapters
        self.config = config or EngineConfig()
        self.supervisor_config = supervisor or SupervisorConfig()
        self.fleet = fleet or FleetConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.declare_counters(*_FLEET_COUNTERS)
        self.metrics.declare_counters(
            *(f"replica{i}_dispatches"
              for i in range(self.fleet.n_replicas)))
        self.router = router if router is not None else Router(
            affinity_weight=self.fleet.prefix_affinity_weight)
        self._engine_factory = engine_factory
        # affinity chains only mean something when replicas actually
        # intern prefixes — flat layout / prefix_cache=False fleets
        # route purely least-loaded (chain stays None)
        self._route_chains = (self.config.kv_layout == "paged"
                              and self.config.prefix_cache
                              and self.router.affinity_weight > 0.0)
        self._route_salt = prefix_salt(model.config)
        if faults is None:
            self._faults: Dict[int, object] = {}
        elif isinstance(faults, dict):
            self._faults = dict(faults)
        else:
            self._faults = {0: faults}
        unknown = set(self._faults) - set(range(self.fleet.n_replicas))
        if unknown:
            raise ValueError(
                f"faults keyed by unknown replica ids {sorted(unknown)}; "
                f"fleet has replicas 0..{self.fleet.n_replicas - 1}")
        self.completed: Dict[int, RequestResult] = {}
        self._tracked: Dict[int, _FleetTracked] = {}
        #: migrated continuations waiting for a dispatchable peer
        self._backlog: List[Request] = []
        self._order = 0
        self._closed = False
        self._engine_restarts_base = 0   # restarts of already-rebuilt sups
        #: per-replica registry views (fleet_metrics.ReplicaRegistry):
        #: every producer call lands on BOTH the replica's local state
        #: and the shared fleet registry, so the global stream/counters
        #: are unchanged while FleetMetrics can split by replica. One
        #: view per replica id, surviving rebuilds — a replica's
        #: counters are cumulative over its whole slot in the fleet.
        self.replica_metrics: Dict[int, ReplicaRegistry] = {}
        #: registry views of RETIRED replicas — removed from every live
        #: per-replica view but still folded into FleetMetrics' merged
        #: counters/histograms, so scaling a replica away never
        #: un-counts the work it did
        self.retired_replica_metrics: Dict[int, ReplicaRegistry] = {}
        #: per-replica model overrides (canary deploys): a replica id
        #: present here rebuilds on THIS module instead of
        #: ``self._model``; a rollback pops the entry and rebuilds
        self._replica_models: Dict[int, Any] = {}
        #: monotonic id source for scale-ups — retired ids are never
        #: reused, so records/counters stay unambiguous across churn
        self._next_replica_id = self.fleet.n_replicas
        self._deployment = None
        self.replicas: List[_Replica] = [
            _Replica(i, self._build_supervisor(i))
            for i in range(self.fleet.n_replicas)]
        if autoscale is not None:
            from apex_tpu_torch.serving.fleet.autoscale import (
                Autoscaler,
                AutoscaleConfig,
            )
            if isinstance(autoscale, Autoscaler):
                self.autoscaler: Optional[Autoscaler] = autoscale
            elif isinstance(autoscale, AutoscaleConfig):
                self.autoscaler = Autoscaler(autoscale)
            else:
                raise TypeError(
                    f"autoscale must be an AutoscaleConfig or Autoscaler, "
                    f"got {type(autoscale).__name__}")
            cfg = self.autoscaler.config
            if not (cfg.min_replicas <= self.fleet.n_replicas
                    <= cfg.max_replicas):
                raise ValueError(
                    f"n_replicas={self.fleet.n_replicas} outside the "
                    f"autoscaler's [{cfg.min_replicas}, "
                    f"{cfg.max_replicas}] bounds")
        else:
            self.autoscaler = None
        if sentinel is not None:
            from apex_tpu_torch.observability.sentinel import (
                DriftSentinel,
                SentinelConfig,
            )
            if isinstance(sentinel, DriftSentinel):
                self.sentinel: Optional[DriftSentinel] = sentinel
            elif isinstance(sentinel, SentinelConfig):
                self.sentinel = DriftSentinel(sentinel)
            else:
                raise TypeError(
                    f"sentinel must be a SentinelConfig or DriftSentinel, "
                    f"got {type(sentinel).__name__}")
        else:
            self.sentinel = None
        if quotas is not None:
            from apex_tpu_torch.serving.fleet.quota import QuotaConfig, QuotaLedger
            if isinstance(quotas, QuotaLedger):
                self.quota: Optional[QuotaLedger] = quotas
            elif isinstance(quotas, QuotaConfig):
                self.quota = QuotaLedger(quotas)
            else:
                raise TypeError(
                    f"quotas must be a QuotaConfig or QuotaLedger, "
                    f"got {type(quotas).__name__}")
        else:
            self.quota = None
        #: rid -> (tenant, pages) the quota ledger holds for it —
        #: committed at dispatch, released at the terminal state
        self._quota_held: Dict[int, Tuple[str, int]] = {}
        #: backlogged rids waiting on a soft quota (re-checked per tick)
        self._quota_deferred: set = set()
        if brownout is not None:
            from apex_tpu_torch.serving.fleet.brownout import (
                BrownoutConfig,
                BrownoutController,
            )
            if isinstance(brownout, BrownoutController):
                self.brownout: Optional[BrownoutController] = brownout
            elif isinstance(brownout, BrownoutConfig):
                self.brownout = BrownoutController(brownout)
            else:
                raise TypeError(
                    f"brownout must be a BrownoutConfig or "
                    f"BrownoutController, got {type(brownout).__name__}")
        else:
            self.brownout = None

    def _build_supervisor(self, replica_id: int,
                          service_s: Optional[float] = None
                          ) -> EngineSupervisor:
        reg = self.replica_metrics.get(replica_id)
        if reg is None:
            reg = self.replica_metrics[replica_id] = ReplicaRegistry(
                self.metrics, replica_id)
        return EngineSupervisor(
            self._replica_models.get(replica_id, self._model),
            self.config,
            supervisor=self.supervisor_config, metrics=reg,
            faults=self._faults.get(replica_id), replica_id=replica_id,
            service_s=service_s, engine_factory=self._engine_factory,
            adapters=self._adapters, device=self._device)

    # -- introspection ----------------------------------------------------

    def _replica(self, replica_id: int) -> Optional[_Replica]:
        """Id-keyed lookup — replica ids are NOT list indices once
        scale-up/down churn starts (ids are monotonic, never reused)."""
        for replica in self.replicas:
            if replica.replica_id == replica_id:
                return replica
        return None

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def topology_busy(self) -> Optional[int]:
        """Replica id currently draining or probing, else None — one
        topology change (drain, scale, deploy step) at a time."""
        for r in self.replicas:
            if r.state in (REPLICA_DRAINING, REPLICA_PROBING):
                return r.replica_id
        return None

    @property
    def deployment(self):
        """The current (or most recent) :class:`~apex_tpu_torch.serving.fleet.\
deploy.Deployment`, or None if :meth:`deploy` was never called."""
        return self._deployment

    @property
    def replica_states(self) -> Dict[int, str]:
        return {r.replica_id: r.state for r in self.replicas}

    @property
    def restarts(self) -> int:
        """Engine restarts across the fleet's whole history (rebuilt
        replicas included) — what the loadtest runner reports."""
        return self._engine_restarts_base + sum(
            r.supervisor.restarts for r in self.replicas)

    @property
    def inflight_count(self) -> int:
        """Non-terminal client requests plus in-flight health probes —
        nonzero means :meth:`tick` still has work to advance."""
        return len(self._tracked) + sum(
            1 for r in self.replicas if r.probe_id is not None)

    @property
    def inflight_ids(self) -> List[int]:
        """Ids of non-terminal CLIENT requests (probes are fleet-internal
        and excluded) — what a caller cancels to abort early."""
        return sorted(self._tracked)

    def dispatch_set(self) -> List[_Replica]:
        """Replicas currently taking new work: ACTIVE and breaker not
        open. Draining / probing / failed replicas are excluded — that is
        what makes a restart 'draining' rather than disruptive."""
        return [r for r in self.replicas
                if r.state == REPLICA_ACTIVE
                and r.supervisor.breaker_state != BREAKER_OPEN]

    def _chain_for(self, request: Request) -> Optional[Tuple[int, ...]]:
        """The request's prefix hash chain for affinity routing — the
        SAME chain (same salt, same page size) the target engine will
        look up and intern, or None when affinity is off."""
        if not self._route_chains:
            return None
        # same adapter fold the engine applies: a tenant's chains only
        # collide with that tenant's resident pages
        salt = adapter_salt(self._route_salt, request.sampling.adapter_id)
        return prefix_hash_chain(request.prompt, self.config.page_size,
                                 salt) or None

    # -- admission --------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Route one request to the least-loaded dispatchable replica.
        Raises :class:`FleetUnavailableError` when no replica can take
        work (recorded terminally), or whatever the chosen replica's own
        admission gates raise (queue full, deadline shed — also recorded
        terminally, by the replica, with its ``replica_id``)."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        now = clock.now()
        tenant = pages = None
        if self.quota is not None:
            from apex_tpu_torch.serving.fleet.quota import (
                QUOTA_DEFER,
                QUOTA_SHED,
                QuotaLedger,
            )
            tenant = QuotaLedger.tenant(request)
            pages = self._quota_pages(request)
            verdict, limit = self.quota.verdict(tenant, now, pages=pages)
            if verdict == QUOTA_SHED:
                self._shed_quota(request, tenant, limit, now)   # raises
            if verdict == QUOTA_DEFER:
                self._defer_quota(request, tenant, limit, now)
                return request.request_id
        if self.brownout is not None:
            # at the clamp rung and above, batch submits get a bounded
            # token budget (same ids/deadline/trace — accounting intact)
            request = self.brownout.clamp(request)
        candidates = self.dispatch_set()
        if not candidates:
            self._shed_fleet(request, now)
        # an active adapter-canary deployment pins its tenant's traffic
        # to the canary replica (when dispatchable) so the canary window
        # actually observes the adapter under live load
        dep = self._deployment
        if dep is not None and not dep.done:
            pin = dep.pin_replica(request)
            if pin is not None:
                pinned = [r for r in candidates if r.replica_id == pin]
                if pinned:
                    candidates = pinned
        chain = self._chain_for(request)
        replica = self.router.pick(candidates, chain=chain)
        tr = _FleetTracked(request, now, self._order)
        self._order += 1
        self._tracked[request.request_id] = tr
        try:
            replica.supervisor.submit(request)
        except Exception:
            # the replica recorded the rejection terminally (with its
            # replica_id); keep the fleet's view consistent
            self._harvest_replica(replica, now)
            self._tracked.pop(request.request_id, None)
            raise
        tr.replica_id = replica.replica_id
        self._count_dispatch(replica)
        self.router.note_dispatch(replica.replica_id, chain)
        if self.quota is not None and tenant is not None:
            self.quota.commit(tenant, now, pages=pages or 0)
            self._quota_held[request.request_id] = (tenant, pages or 0)
        return request.request_id

    # -- per-tenant quotas -------------------------------------------------

    def _quota_pages(self, request: Request) -> int:
        """Worst-case KV page footprint the engine's admission will
        reserve (0 on non-paged layouts — the page cap is then inert)."""
        if self.config.kv_layout != "paged":
            return 0
        ps = self.config.page_size
        return -(-request.total_len // ps)

    def _quota_release(self, request_id: int) -> None:
        """Return a terminal request's quota holdings (idempotent)."""
        held = self._quota_held.pop(request_id, None)
        if held is not None and self.quota is not None:
            self.quota.release(held[0], pages=held[1])
        self._quota_deferred.discard(request_id)

    def _shed_quota(self, request: Request, tenant: str,
                    limit: Optional[str], now: float) -> None:
        """Hard quota exceeded: terminal ``rejected`` record + the typed
        ``requests_shed_quota`` counter + ``request_shed`` (reason
        ``quota``) event, then raise — the same contract as
        :meth:`_shed_fleet`, scoped to one tenant."""
        from apex_tpu_torch.serving.fleet.quota import QuotaExceededError
        self.metrics.inc("requests_submitted")
        self.metrics.inc("requests_shed_quota")
        self.metrics.inc(f"requests_{FINISH_REJECTED}")
        start = request.arrival_ts if request.arrival_ts is not None \
            else now
        result = RequestResult(
            request_id=request.request_id, prompt_len=request.prompt_len,
            tokens=[], finish_reason=FINISH_REJECTED,
            queue_s=now - start, total_s=now - start,
            adapter_id=request.sampling.adapter_id,
            trace_id=request.trace_id,
            priority=request.sampling.priority)
        self.completed[request.request_id] = result
        wall = clock.wall()
        emit_span(self.metrics, SPAN_SHED, trace_id=request.trace_id,
                  request_id=request.request_id, start_s=start,
                  end_s=now, wall=wall, detail="quota")
        self.metrics.emit_record(result.record(wall=wall))
        log_event(_LOG, "request_shed", request_id=request.request_id,
                  reason="quota", tenant=tenant, limit=limit)
        self.metrics.event("request_shed", request_id=request.request_id,
                           reason="quota", tenant=tenant, limit=limit)
        raise QuotaExceededError(
            f"request {request.request_id} shed: tenant {tenant!r} is "
            f"over its {limit} quota")

    def _defer_quota(self, request: Request, tenant: str,
                     limit: Optional[str], now: float) -> None:
        """Soft quota exceeded: throttle instead of shed — the request
        joins the fleet backlog (counted submitted NOW, dispatched as a
        resubmission later) and is re-checked against the ledger every
        tick until its bucket refills or its deadline expires."""
        self.metrics.inc("requests_submitted")
        self.metrics.inc("requests_deferred_quota")
        tr = _FleetTracked(request, now, self._order)
        self._order += 1
        self._tracked[request.request_id] = tr
        self._quota_deferred.add(request.request_id)
        self._backlog.append(request)
        log_event(_LOG, "request_quota_deferred",
                  request_id=request.request_id, tenant=tenant,
                  limit=limit)
        self.metrics.event("request_quota_deferred",
                           request_id=request.request_id, tenant=tenant,
                           limit=limit)

    def _count_dispatch(self, replica: _Replica) -> None:
        replica.dispatches += 1
        self.metrics.inc("fleet_dispatches")
        self.metrics.inc(f"replica{replica.replica_id}_dispatches")

    def _shed_fleet(self, request: Request, now: float) -> None:
        """No dispatchable replica: terminal ``rejected`` record +
        counters + ``request_shed`` (reason ``fleet``) event, then
        raise — the same contract as the supervisor's ``_shed``."""
        self.metrics.inc("requests_submitted")
        self.metrics.inc("requests_shed_fleet")
        self.metrics.inc(f"requests_{FINISH_REJECTED}")
        start = request.arrival_ts if request.arrival_ts is not None \
            else now
        result = RequestResult(
            request_id=request.request_id, prompt_len=request.prompt_len,
            tokens=[], finish_reason=FINISH_REJECTED,
            queue_s=now - start, total_s=now - start,
            adapter_id=request.sampling.adapter_id,
            trace_id=request.trace_id,
            priority=request.sampling.priority)
        self.completed[request.request_id] = result
        wall = clock.wall()
        # front-door shed: one shed phase span, no replica_id (the
        # request never reached one)
        emit_span(self.metrics, SPAN_SHED, trace_id=request.trace_id,
                  request_id=request.request_id, start_s=start,
                  end_s=now, wall=wall, detail="fleet")
        self.metrics.emit_record(result.record(wall=wall))
        states = {r.replica_id: (BREAKER_OPEN
                                 if r.supervisor.breaker_state ==
                                 BREAKER_OPEN and r.state == REPLICA_ACTIVE
                                 else r.state)
                  for r in self.replicas}
        log_event(_LOG, "request_shed", request_id=request.request_id,
                  reason="fleet", replicas=str(states))
        self.metrics.event("request_shed", request_id=request.request_id,
                           reason="fleet", replicas=str(states))
        raise FleetUnavailableError(
            f"request {request.request_id} shed at the fleet front door: "
            f"no dispatchable replica (states: {states}) — every replica "
            f"is draining, failed, or has an open circuit breaker")

    def cancel(self, request_id: int) -> bool:
        """Cancel wherever the request currently lives: the migration
        backlog, or (sticky) the replica it was dispatched to."""
        now = clock.now()
        tr = self._tracked.get(request_id)
        if tr is None:
            return False
        for i, cont in enumerate(self._backlog):
            if cont.request_id == request_id:
                del self._backlog[i]
                self._tracked.pop(request_id)
                self._quota_release(request_id)
                self._retire_fleet(tr, "cancelled", now)
                return True
        if tr.replica_id is None:
            return False
        replica = self._replica(tr.replica_id)
        if replica is None:
            return False
        found = replica.supervisor.cancel(request_id)
        if found:
            self._harvest_replica(replica, now)
        return found

    # -- the fleet tick ---------------------------------------------------

    def tick(self) -> List[RequestResult]:
        """One fleet iteration: re-home migrated work, tick every live
        replica (each runs at most one decode step), harvest terminal
        results, and advance any drain/probe lifecycle. Returns requests
        that reached a terminal state in the fleet's view."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        before = set(self.completed)
        self._dispatch_backlog()
        for replica in list(self.replicas):
            if replica.state == REPLICA_FAILED:
                continue
            replica.supervisor.tick()
            self._harvest_replica(replica, clock.now())
        self._advance_drains()
        now = clock.now()
        if self._deployment is not None and not self._deployment.done:
            self._deployment.step(self, now)
        if self.autoscaler is not None:
            self.autoscaler.maybe_scale(self, now)
        if self.sentinel is not None:
            # after the autoscaler so a scale decision's effect on queue
            # depth and the anomaly that provoked it share a tick stamp
            self.sentinel.maybe_poll(self, now)
        if self.brownout is not None:
            # last: the ladder reacts to pressure the autoscaler could
            # not absorb (bounds hit, or building too slowly)
            self.brownout.maybe_step(self, now)
        return [self.completed[rid] for rid in sorted(
            set(self.completed) - before)]

    def serve(self, requests: Sequence[Request], *,
              on_tick: Optional[Callable[["ReplicaFleet", int], None]]
              = None, max_ticks: Optional[int] = None
              ) -> List[RequestResult]:
        """Serve ``requests`` to completion across the fleet. Requests
        rejected at admission (fleet or replica gates) are terminal
        immediately with ``finish_reason="rejected"`` — every submitted
        request reaches exactly one terminal state."""
        pending = list(requests)
        ids = [r.request_id for r in pending]
        ticks = 0
        while pending or self.inflight_count:
            while pending:
                req = pending[0]
                targets = self.dispatch_set()
                if targets and all(
                        Router.depth(t) >= self.config.scheduler.max_queue
                        for t in targets):
                    break       # every queue is full: tick, then retry
                pending.pop(0)
                try:
                    self.submit(req)
                except (EngineUnavailableError, QueueFullError,
                        DeadlineExpiredError):
                    pass        # already recorded terminally
            self.tick()
            ticks += 1
            if on_tick is not None:
                on_tick(self, ticks)
            if max_ticks is not None and ticks >= max_ticks:
                break
        return [self.completed[i] for i in ids if i in self.completed]

    # -- draining restarts ------------------------------------------------

    def drain_restart(self, replica_id: int) -> None:
        """Begin a draining restart of one replica: quiesce (leave the
        dispatch set), migrate or finish its in-flight work, rebuild,
        health-probe, rejoin. Progress happens across :meth:`tick`
        calls; fleet capacity never drops below N−1 because only one
        replica may be draining/probing at a time (a second request
        raises ``RuntimeError`` instead of silently stacking drains)."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        replica = self._replica(replica_id)
        if replica is None:
            raise ValueError(
                f"no replica {replica_id} (fleet has "
                f"{sorted(r.replica_id for r in self.replicas)})")
        if replica.state != REPLICA_ACTIVE:
            raise RuntimeError(
                f"replica {replica_id} is {replica.state}, not active")
        busy = self.topology_busy
        if busy is not None:
            raise RuntimeError(
                f"replica {busy} is already draining/probing — one "
                f"restart at a time keeps fleet capacity at N-1")
        replica.state = REPLICA_DRAINING
        self.metrics.inc("replica_drains")
        inflight = replica.supervisor.inflight_count
        log_event(_LOG, "replica_drain", replica_id=replica_id,
                  inflight=inflight,
                  migrate=self.fleet.migrate_on_drain)
        self.metrics.event("replica_drain", replica_id=replica_id,
                           inflight=inflight,
                           migrate=self.fleet.migrate_on_drain)
        if self.fleet.migrate_on_drain:
            self._migrate_from(replica)
        self._advance_drains()

    def _migrate_from(self, replica: _Replica) -> None:
        """Detach the draining replica's non-terminal work as token-exact
        continuations and queue them for peers."""
        now = clock.now()
        conts = replica.supervisor.detach_for_migration()
        self._harvest_replica(replica, now)   # detach may retire some
        for cont, recovered in conts:
            tr = self._tracked.get(cont.request_id)
            if tr is None:      # cancelled between snapshot and handover
                continue
            tr.prefix += recovered
            tr.replica_id = None
            tr.migrations += 1
            self.metrics.inc("requests_migrated")
            log_event(_LOG, "request_migrated",
                      request_id=cont.request_id,
                      from_replica=replica.replica_id,
                      tokens_carried=len(recovered))
            self.metrics.event("request_migrated",
                               request_id=cont.request_id,
                               from_replica=replica.replica_id,
                               tokens_carried=len(recovered))
            # mark span (zero-width): the handoff instant — the carried
            # token count explains any TTFT/decode split across replicas
            emit_span(self.metrics, SPAN_MIGRATION,
                      trace_id=cont.trace_id,
                      request_id=cont.request_id, start_s=now,
                      end_s=now, wall=clock.wall(),
                      from_replica=replica.replica_id,
                      tokens_carried=len(recovered))
            self._backlog.append(cont)
        self._dispatch_backlog()

    def _dispatch_backlog(self) -> None:
        """Re-home backlogged work — migrated continuations and
        quota-deferred submits — on the least-loaded peer with queue
        room, in priority order (rank, then arrival order) so a
        backlogged interactive request never waits behind batch.
        Deferred entries are re-checked against the quota ledger (and
        their deadline) first; whatever cannot be placed yet stays
        backlogged and keeps being retried every tick — never dropped."""
        if not self._backlog:
            return
        self._backlog.sort(key=lambda c: (
            PRIORITY_RANK.get(c.sampling.priority,
                              PRIORITY_RANK[PRIORITY_STANDARD]),
            self._tracked[c.request_id].order
            if c.request_id in self._tracked else 0))
        kept: List[Request] = []
        for cont in self._backlog:
            rid = cont.request_id
            tr = self._tracked.get(rid)
            if tr is None:
                continue        # cancelled while backlogged
            now = clock.now()
            deferred = rid in self._quota_deferred
            tenant = pages = None
            if deferred:
                start = cont.arrival_ts if cont.arrival_ts is not None \
                    else tr.first_submit_ts
                if cont.deadline_s is not None \
                        and now - start > cont.deadline_s:
                    # a throttled request whose bucket never refilled in
                    # time — terminal, never silently dropped
                    self._tracked.pop(rid)
                    self._quota_release(rid)
                    self._retire_fleet(tr, FINISH_TIMEOUT, now)
                    continue
                if self.quota is not None:
                    from apex_tpu_torch.serving.fleet.quota import (
                        QUOTA_ADMIT,
                        QuotaLedger,
                    )
                    tenant = QuotaLedger.tenant(cont)
                    pages = self._quota_pages(cont)
                    verdict, _ = self.quota.verdict(tenant, now,
                                                    pages=pages)
                    if verdict != QUOTA_ADMIT:
                        kept.append(cont)
                        continue
            candidates = [r for r in self.dispatch_set()
                          if Router.depth(r)
                          < self.config.scheduler.max_queue]
            if not candidates:
                kept.append(cont)
                continue
            # the continuation's prompt is the stitched original-plus-
            # recovered-tokens the peer will actually prefill, so its
            # chain (a superset of the original's) is the right
            # affinity key
            chain = self._chain_for(cont)
            replica = self.router.pick(candidates, chain=chain)
            try:
                replica.supervisor.submit(cont, resubmission=True)
            except (QueueFullError, DeadlineExpiredError,
                    EngineUnavailableError):
                # recorded terminally by the replica — harvest below
                self._harvest_replica(replica, clock.now())
                continue
            tr.replica_id = replica.replica_id
            self._count_dispatch(replica)
            self.router.note_dispatch(replica.replica_id, chain)
            if deferred:
                self._quota_deferred.discard(rid)
                if self.quota is not None and tenant is not None:
                    self.quota.commit(tenant, now, pages=pages or 0)
                    self._quota_held[rid] = (tenant, pages or 0)
        self._backlog = kept

    def _advance_drains(self) -> None:
        """Move the drain/probe lifecycle forward: rebuild (or, for a
        scale-down, retire) a drained-out replica, then score its health
        probe. Iterates a copy — retirement mutates ``self.replicas``."""
        for replica in list(self.replicas):
            if (replica.state == REPLICA_DRAINING
                    and replica.supervisor.inflight_count == 0):
                if replica.retire_on_drain:
                    self._finish_retire(replica)
                    continue
                self._rebuild(replica)
            if replica.state == REPLICA_PROBING:
                self._check_probe(replica)

    # -- autoscaling: add / retire replicas -------------------------------

    def add_replica(self) -> int:
        """Scale up by one replica (the autoscaler's up-leg, also usable
        directly). The new replica gets a fresh, never-reused id and
        joins through the SAME health-probe gate as a rebuild: it enters
        the dispatch set only after a real one-token probe request
        succeeds (``probe_on_rebuild`` permitting). One topology change
        at a time — raises ``RuntimeError`` while another replica is
        draining or probing. Returns the new replica id."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        busy = self.topology_busy
        if busy is not None:
            raise RuntimeError(
                f"replica {busy} is draining/probing — one topology "
                f"change at a time")
        rid = self._next_replica_id
        self._next_replica_id += 1
        self.metrics.declare_counters(f"replica{rid}_dispatches")
        replica = _Replica(rid, self._build_supervisor(rid))
        self.replicas.append(replica)
        self.metrics.inc("replica_scale_ups")
        log_event(_LOG, "replica_scale_up", replica_id=rid,
                  n_replicas=len(self.replicas))
        self.metrics.event("replica_scale_up", replica_id=rid,
                           n_replicas=len(self.replicas))
        if self.fleet.probe_on_rebuild:
            replica.state = REPLICA_PROBING
            self._launch_probe(replica)
        else:
            replica.state = REPLICA_ACTIVE
        return rid

    def retire_replica(self, replica_id: int) -> None:
        """Scale down by retiring one replica (the autoscaler's
        down-leg): drain it through the migrate-or-finish machinery —
        no request dropped — then REMOVE it from the fleet entirely
        (its id never comes back; its counters fold into the retired
        ledger so fleet totals still reconcile). One topology change at
        a time; the last active replica cannot be retired."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        replica = self._replica(replica_id)
        if replica is None:
            raise ValueError(
                f"no replica {replica_id} (fleet has "
                f"{sorted(r.replica_id for r in self.replicas)})")
        if replica.state != REPLICA_ACTIVE:
            raise RuntimeError(
                f"replica {replica_id} is {replica.state}, not active")
        busy = self.topology_busy
        if busy is not None:
            raise RuntimeError(
                f"replica {busy} is draining/probing — one topology "
                f"change at a time")
        others = [r for r in self.replicas
                  if r.state == REPLICA_ACTIVE and r is not replica]
        if not others:
            raise RuntimeError(
                f"replica {replica_id} is the last active replica — "
                f"retiring it would empty the dispatch set")
        replica.state = REPLICA_DRAINING
        replica.retire_on_drain = True
        self.metrics.inc("replica_scale_downs")
        inflight = replica.supervisor.inflight_count
        log_event(_LOG, "replica_scale_down", replica_id=replica_id,
                  inflight=inflight, n_replicas=len(self.replicas))
        self.metrics.event("replica_scale_down", replica_id=replica_id,
                           inflight=inflight,
                           n_replicas=len(self.replicas))
        if self.fleet.migrate_on_drain:
            self._migrate_from(replica)
        self._advance_drains()

    def _finish_retire(self, replica: _Replica) -> None:
        """Terminal leg of a scale-down: the drain has emptied — close
        the supervisor, remove the id from the fleet, the router's
        residency/cost tables, and every live per-replica metrics view
        (the registry moves to ``retired_replica_metrics`` so merged
        fleet totals keep reconciling with the parent)."""
        rid = replica.replica_id
        self._harvest_replica(replica, clock.now())
        self._engine_restarts_base += replica.supervisor.restarts
        replica.supervisor.release_device_memory()
        self.replicas.remove(replica)
        self.router.invalidate(rid)
        reg = self.replica_metrics.pop(rid, None)
        if reg is not None:
            self.retired_replica_metrics[rid] = reg
        log_event(_LOG, "replica_retired", replica_id=rid,
                  n_replicas=len(self.replicas))
        self.metrics.event("replica_retired", replica_id=rid,
                           n_replicas=len(self.replicas))

    # -- continuous deployment --------------------------------------------

    def deploy(self, checkpoint_dir: Optional[str] = None, *,
               step: Optional[int] = None, adapter=None, canary=None):
        """Start a rolling canary deployment
        (docs/serving.md#continuous-deployment). Exactly one of
        ``checkpoint_dir`` (roll every replica onto the committed
        sharded checkpoint at ``step``, default latest, via draining
        restarts) or ``adapter`` (``(adapter_id, factors)`` — hot-load
        a LoRA adapter through the shared ``AdapterStore`` and canary
        it on one replica, gated on its per-tenant SLO score).

        The checkpoint is fsck-verified BEFORE the first drain — a
        corrupt step raises
        :class:`~apex_tpu_torch.checkpoint.CheckpointCorruptionError` here
        (recorded as ``deploy_rejected``) and no replica is touched.
        Progress then happens across :meth:`tick` calls; watch
        :attr:`deployment`. Raises ``RuntimeError`` if a deployment is
        already in progress."""
        from apex_tpu_torch.serving.fleet.deploy import Deployment
        if self._closed:
            raise RuntimeError("fleet is closed")
        if self._deployment is not None and not self._deployment.done:
            raise RuntimeError(
                f"deployment {self._deployment.describe()} is already "
                f"in progress — one rollout at a time")
        dep = Deployment(checkpoint_dir=checkpoint_dir, step=step,
                         adapter=adapter, canary=canary)
        try:
            dep.start(self)
        except Exception:
            if dep.done:        # recorded as deploy_rejected: keep it
                self._deployment = dep   # visible (and non-blocking)
            raise
        self._deployment = dep
        return dep

    def _rebuild(self, replica: _Replica) -> None:
        """Tear down the drained supervisor and build a fresh one (new
        engine, slot pool, KV pools — the old pools released first),
        carrying the service-time EWMA so post-rebuild deadline shedding
        is not blind."""
        old = replica.supervisor
        carried = old.service_estimate_s
        self._engine_restarts_base += old.restarts
        old.release_device_memory()
        # the fresh engine's intern index is empty — stale affinity
        # would keep routing this replica's old prefixes at a replica
        # that now misses on all of them
        self.router.invalidate(replica.replica_id)
        replica.supervisor = self._build_supervisor(
            replica.replica_id, service_s=carried)
        self.metrics.inc("replica_rebuilds")
        log_event(_LOG, "replica_rebuild", replica_id=replica.replica_id,
                  carried_service_s=carried)
        self.metrics.event("replica_rebuild",
                           replica_id=replica.replica_id,
                           carried_service_s=carried)
        if self.fleet.probe_on_rebuild:
            replica.state = REPLICA_PROBING
            self._launch_probe(replica)
        else:
            replica.state = REPLICA_ACTIVE

    def _launch_probe(self, replica: _Replica) -> None:
        """One-token greedy health probe through the NORMAL submit path —
        counted and recorded like any request (conservation holds), so a
        replica only rejoins after serving real work end-to-end."""
        replica.probe_attempts += 1
        probe = Request(prompt=[0], max_new_tokens=1,
                        sampling=SamplingParams())
        replica.probe_id = probe.request_id
        try:
            replica.supervisor.submit(probe)
        except Exception:       # a probe the engine cannot even queue
            replica.probe_id = None
            self._probe_failed(replica)

    def _check_probe(self, replica: _Replica) -> None:
        if replica.probe_id is None:
            return
        res = replica.supervisor.completed.get(replica.probe_id)
        if res is None:
            return              # probe still in flight; keep ticking
        replica.probe_id = None
        if res.finish_reason in (FINISH_EOS, FINISH_LENGTH):
            replica.state = REPLICA_ACTIVE
            replica.probe_attempts = 0
        else:
            self._probe_failed(replica)

    def _probe_failed(self, replica: _Replica) -> None:
        if replica.probe_attempts >= self.fleet.max_rebuild_probes:
            replica.state = REPLICA_FAILED
            log_event(_LOG, "replica_failed",
                      replica_id=replica.replica_id,
                      probe_attempts=replica.probe_attempts)
            self.metrics.event("replica_failed",
                               replica_id=replica.replica_id,
                               probe_attempts=replica.probe_attempts)
            return
        self._rebuild(replica)  # another rebuild + probe round

    # -- harvesting -------------------------------------------------------

    def _harvest_replica(self, replica: _Replica, now: float) -> None:
        """Pull newly-terminal results from one replica into the fleet's
        view, stitching migrated requests back together (fleet-side
        prefix + the replica's continuation tokens, the ORIGINAL prompt
        length, total latency from the FIRST dispatch)."""
        sup = replica.supervisor
        done = [rid for rid in list(self._tracked)
                if rid in sup.completed]
        for rid in sorted(done, key=lambda r: self._tracked[r].order):
            tr = self._tracked.pop(rid)
            self._quota_release(rid)
            res = sup.completed[rid]
            if tr.prefix or tr.migrations:
                res = RequestResult(
                    request_id=rid, prompt_len=tr.request.prompt_len,
                    tokens=tr.prefix + res.tokens,
                    finish_reason=res.finish_reason,
                    queue_s=res.queue_s, prefill_s=res.prefill_s,
                    decode_s=res.decode_s,
                    total_s=now - tr.first_submit_ts,
                    ttft_s=None if tr.prefix else res.ttft_s,
                    tpot_s=res.tpot_s, replica_id=res.replica_id)
            self.completed[rid] = res

    def _retire_fleet(self, tr: _FleetTracked, reason: str,
                      now: float) -> RequestResult:
        """Terminal retirement by the fleet itself (cancelled from the
        migration backlog): one counter, one record, one event — the
        same contract as a replica-side finish."""
        rid = tr.request.request_id
        result = RequestResult(
            request_id=rid, prompt_len=tr.request.prompt_len,
            tokens=list(tr.prefix), finish_reason=reason,
            total_s=now - tr.first_submit_ts,
            adapter_id=tr.request.sampling.adapter_id,
            trace_id=tr.request.trace_id,
            priority=tr.request.sampling.priority)
        self.completed[rid] = result
        self.metrics.inc(f"requests_{reason}")
        wall = clock.wall()
        # no replica will ever finish this request (it died in the
        # migration backlog), so the fleet owns its timeline: one coarse
        # phase span over the whole fleet-tracked lifetime
        emit_span(self.metrics,
                  SPAN_DECODE if reason in (FINISH_EOS, FINISH_LENGTH)
                  else SPAN_SHED,
                  trace_id=tr.request.trace_id, request_id=rid,
                  start_s=tr.first_submit_ts, end_s=now, wall=wall,
                  detail="migration_backlog")
        self.metrics.emit_record(result.record(wall=wall))
        log_event(_LOG, f"request_{reason}", request_id=rid,
                  new_tokens=result.new_tokens)
        self.metrics.event(f"request_{reason}", request_id=rid,
                           new_tokens=result.new_tokens)
        return result

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Close every replica (releases slots, flushes the registry).
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        for replica in self.replicas:
            replica.supervisor.close()

    def __enter__(self) -> "ReplicaFleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
