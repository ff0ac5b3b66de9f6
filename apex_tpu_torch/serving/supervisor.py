"""Engine supervision: restart-with-recovery and overload admission.

Counterpart of ``apex_tpu/serving/supervisor.py``.
:class:`~apex_tpu_torch.serving.engine.InferenceEngine` owns device state
and assumes every step returns; production traffic does not oblige — a
decode exception, a hung collective, or a poisoned slot must be routine,
not fatal. :class:`EngineSupervisor` is the serving-side survive leg:

- **Tick-level fault recovery**: every ``tick()`` runs under a
  try/except plus a wall-clock budget (``hung_tick_s``; the tick's one
  host read synchronises, so the card's asynchrony cannot hide a hang).
  On failure the supervisor rebuilds the engine from scratch — fresh slot
  pool, fresh KV caches, allocated after the dead engine's are dropped so
  the card never holds two sets — and **re-prefills every in-flight
  request from its prompt plus the tokens already generated**. Because
  sampling keys on the absolute position (``fold_in(seed, position)``)
  and greedy decoding is prefix-deterministic, a resumed request's
  stream is TOKEN-EXACT across the restart, for greedy and sampled
  requests alike. Recovery is budgeted per request
  (``max_restarts_per_request``); over-budget requests retire with
  ``finish_reason="error"`` — admitted work is never silently lost.
- **Circuit breaker**: ``breaker_threshold`` consecutive tick failures
  open the breaker; while open, ``submit()`` fails fast with
  :class:`EngineUnavailableError` instead of queuing doomed work. After
  ``breaker_cooldown_s`` the breaker goes half-open; the next clean tick
  closes it, the next failure re-opens it with a fresh cooldown.
- **Deadline-aware load shedding**: the supervisor tracks an EWMA of
  observed per-request service time; a deadline request whose projected
  queue wait (``queue_depth × ewma``) already exceeds its remaining
  budget is shed at submit — layered on the scheduler's
  ``QueueFullError`` backpressure and expired-deadline fast-fail.

Every retry / quarantine / breaker transition / shed is wired into the
shared :class:`~apex_tpu_torch.observability.MetricsRegistry` (counters
AND ``kind="event"`` incident records) and each terminal outcome emits one
``kind="request"`` row, so the incident timeline reconciles against the
counters key-for-key. The registry is owned by the supervisor and
survives engine rebuilds.

One metrics invariant to lean on: every arrival increments
``requests_submitted`` exactly once (restart continuations resubmit
with ``resubmission=True``) and produces exactly one terminal
``kind="request"`` record plus one ``requests_<reason>`` increment —
whether it finishes in the engine, is shed at admission, or is retired
by the supervisor itself.

The fleet-facing surface is the JAX supervisor's:
:class:`~apex_tpu_torch.serving.fleet.ReplicaFleet` migrates a draining
replica's work through :meth:`EngineSupervisor.detach_for_migration` and
``submit(resubmission=True)``, the brownout ladder reaches the engine
through :meth:`~EngineSupervisor.preempt_class` and
:meth:`~EngineSupervisor.set_admission_floor`, the router prices a
replica with :attr:`~EngineSupervisor.queued_token_excess_s` and
:attr:`~EngineSupervisor.queued_prompt_tokens`, ``service_s=`` seeds a
rebuilt replica's EWMA, and ``engine_factory=`` builds another engine
under the same supervision. :meth:`~EngineSupervisor.release_device_memory`
drops a closed supervisor's KV pools, so a replica rebuilt beside
serving peers never holds two sets on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import clock
from apex_tpu_torch.observability.trace import (
    SPAN_DECODE,
    SPAN_RESUME,
    SPAN_SHED,
    emit_span,
)
from apex_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from apex_tpu_torch.serving.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISH_TIMEOUT,
    PRIORITY_RANK,
    Request,
    RequestResult,
)
from apex_tpu_torch.serving.scheduler import DeadlineExpiredError, QueueFullError
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["EngineUnavailableError", "SupervisorConfig", "EngineSupervisor",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]

_LOG = get_logger(__name__)

#: circuit-breaker states (EngineSupervisor.breaker_state)
BREAKER_CLOSED = "closed"        # normal admission
BREAKER_OPEN = "open"            # submit() fails fast, cooldown running
BREAKER_HALF_OPEN = "half_open"  # probing: next tick decides

#: declared up front so the final snapshot carries every key even for
#: incident types that never fired — the monitor's serving-incidents
#: section reconciles these against the event stream key-for-key
_SUP_COUNTERS = ("engine_restarts", "tick_failures", "requests_recovered",
                 "breaker_opens", "breaker_half_opens", "breaker_closes",
                 "requests_shed_breaker", "requests_shed_deadline",
                 "requests_resumed")


class EngineUnavailableError(RuntimeError):
    """Admission control rejected the submit: the circuit breaker is
    open, or the projected queue wait already exceeds the request's
    deadline. The request IS recorded terminally
    (``finish_reason="rejected"``) — fail fast, never silently drop."""


@dataclass
class SupervisorConfig:
    """Recovery and admission-control knobs.

    ``hung_tick_s`` is a wall-clock budget per engine tick: a tick that
    takes longer is treated as a tick failure (its committed tokens are
    kept — recovery re-prefills from prompt + tokens, so a slow-but-
    completed tick loses nothing). ``None`` disables the check.
    ``max_engine_restarts`` bounds TOTAL rebuild work per supervisor
    lifetime — past it every surviving request retires with an error
    instead of looping a persistently-broken engine forever.
    """

    max_restarts_per_request: int = 2
    max_engine_restarts: int = 32
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.25
    hung_tick_s: Optional[float] = None
    shed_deadlines: bool = True
    #: EWMA weight for the observed per-request service time that feeds
    #: the deadline shed estimate
    service_time_alpha: float = 0.3

    def __post_init__(self):
        if self.max_restarts_per_request < 0:
            raise ValueError(
                f"max_restarts_per_request must be >= 0, got "
                f"{self.max_restarts_per_request}")
        if self.max_engine_restarts < 1:
            raise ValueError(
                f"max_engine_restarts must be >= 1, got "
                f"{self.max_engine_restarts}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}")
        if self.breaker_cooldown_s <= 0:
            raise ValueError(
                f"breaker_cooldown_s must be positive, got "
                f"{self.breaker_cooldown_s}")
        if self.hung_tick_s is not None and self.hung_tick_s <= 0:
            raise ValueError(
                f"hung_tick_s must be positive, got {self.hung_tick_s}")
        if not 0.0 < self.service_time_alpha <= 1.0:
            raise ValueError(
                f"service_time_alpha must be in (0, 1], got "
                f"{self.service_time_alpha}")


class _Tracked:
    """Supervisor-side state of one admitted-and-not-yet-terminal
    request — the source of truth that survives engine rebuilds."""

    __slots__ = ("request", "first_submit_ts", "prefix", "restarts",
                 "order")

    def __init__(self, request: Request, submit_ts: float, order: int):
        self.request = request
        self.first_submit_ts = submit_ts
        self.prefix: List[int] = []   # tokens recovered from dead engines
        self.restarts = 0
        self.order = order            # original arrival order (FCFS)


class EngineSupervisor:
    """Crash-only wrapper around :class:`InferenceEngine`; see the
    module docstring. API mirrors the engine: :meth:`submit` /
    :meth:`cancel` / :meth:`tick` / :meth:`serve` / :meth:`close`, plus
    context-manager support; results land in :attr:`completed` with the
    ORIGINAL prompt lengths and the full recovered token streams."""

    def __init__(self, model,
                 config: Optional[EngineConfig] = None, *,
                 supervisor: Optional[SupervisorConfig] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None, replica_id: Optional[int] = None,
                 service_s: Optional[float] = None,
                 engine_factory=None, adapters=None, device="cuda"):
        self._model = model
        self._device = device
        #: LoRA :class:`~apex_tpu_torch.lora.AdapterStore`, handed to every
        #: engine incarnation — the store (and its device bank) is
        #: supervisor state, so loaded adapters survive engine rebuilds
        #: and restart continuations keep their per-tenant deltas
        self._adapters = adapters
        self.config = config or EngineConfig()
        self.supervisor = supervisor or SupervisorConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.declare_counters(*_SUP_COUNTERS)
        self._faults = faults
        #: replica label, stamped on every result/record this supervisor
        #: (or its engines) emits; None = standalone
        self.replica_id = replica_id
        self.completed: Dict[int, RequestResult] = {}
        self._tracked: Dict[int, _Tracked] = {}
        #: restart continuations waiting for queue room in the new engine
        self._backlog: List[Request] = []
        #: backlog ids that are PREEMPTION resumes (not restart
        #: recoveries) — tagged so the successful resubmit emits the
        #: ``requests_resumed`` counter / zero-width resume mark span
        self._resuming: set = set()
        self._order = 0
        self._closed = False
        self.restarts = 0
        self.breaker_state = BREAKER_CLOSED
        self._breaker_opened_ts = 0.0
        self._consecutive_failures = 0
        # the deadline-shedding EWMA is SUPERVISOR state: it survives
        # engine rebuilds, and a fleet replica rebuild seeds the fresh
        # supervisor with the old one's estimate (``service_s=``) so the
        # first post-restart submits are not admitted blind
        self._service_s: Optional[float] = service_s
        # token-aware companion EWMAs (same alpha): per-token prefill
        # cost and typical prompt length, so the shed projection and the
        # fleet Router can price a backlog of LONG prompts above the
        # same depth of short ones. None until the first completion
        # measures them.
        self._prefill_s_per_token: Optional[float] = None
        self._avg_prompt_tokens: Optional[float] = None
        #: engine constructor, ``(model, config, *, metrics, faults,
        #: replica_id, adapters, device) -> InferenceEngine`` — how a fleet
        #: runs another engine under the same supervision
        self._engine_factory = engine_factory or InferenceEngine
        self.engine = self._build_engine()

    def _build_engine(self) -> InferenceEngine:
        eng = self._engine_factory(
            self._model, self.config, metrics=self.metrics,
            faults=self._faults, replica_id=self.replica_id,
            adapters=self._adapters, device=self._device)
        # this supervisor drains take_parked() every tick, so the engine
        # may preempt: a parked request is guaranteed a resume path
        eng.resume_consumer = True
        return eng

    # -- introspection ----------------------------------------------------

    @property
    def active_count(self) -> int:
        return self.engine.active_count

    @property
    def queued_count(self) -> int:
        return self.engine.queued_count + len(self._backlog)

    @property
    def inflight_count(self) -> int:
        """Admitted-or-queued requests not yet terminal."""
        return len(self._tracked)

    @property
    def inflight_ids(self) -> List[int]:
        """Ids of admitted-or-queued requests not yet terminal — what a
        driver must cancel to drain the supervisor early (the loadtest
        wall-budget abort path)."""
        return sorted(self._tracked)

    @property
    def service_estimate_s(self) -> Optional[float]:
        """The deadline-shedding EWMA of observed per-request service
        time (None until the first completion) — also the fleet router's
        per-replica load weight, and the value carried into a rebuilt
        replica so it never restarts blind."""
        return self._service_s

    @property
    def queued_prompt_tokens(self) -> int:
        """Total prompt tokens waiting in line (engine queue + restart
        backlog) — the token-denominated companion to
        :attr:`queued_count`."""
        return (self.engine.queued_tokens
                + sum(r.prompt_len for r in self._backlog))

    @property
    def queued_token_excess_s(self) -> float:
        """Extra prefill seconds the queued PROMPT TOKENS represent
        beyond what ``depth x EWMA(service_s)`` already prices in: the
        queued tokens in EXCESS of ``depth x EWMA(prompt_tokens)``, at the
        observed per-token prefill rate. Non-negative by construction (a
        backlog of SHORT prompts never discounts the estimate below the
        depth-based one), and 0.0 until both token EWMAs have been
        measured."""
        if self._prefill_s_per_token is None \
                or self._avg_prompt_tokens is None:
            return 0.0
        waiting = self.engine.queued_count + len(self._backlog)
        excess = self.queued_prompt_tokens - waiting * self._avg_prompt_tokens
        return max(0.0, excess) * self._prefill_s_per_token

    def _queued_ahead(self, priority: str):
        """``(depth, token_excess_s)`` of the queued work that would
        dispatch AT OR BEFORE ``priority`` under strict-priority order —
        the class-aware inputs to the deadline-shed projection, so an
        interactive submit is not priced against a deep batch backlog
        that would never run ahead of it."""
        rank = PRIORITY_RANK[priority]
        waiting = sum(n for p, n in self.engine.queued_depth_by_class()
                      .items() if PRIORITY_RANK[p] <= rank)
        tokens = sum(n for p, n in self.engine.queued_tokens_by_class()
                     .items() if PRIORITY_RANK[p] <= rank)
        for r in self._backlog:
            if PRIORITY_RANK.get(r.sampling.priority, 0) <= rank:
                waiting += 1
                tokens += r.prompt_len
        if self._prefill_s_per_token is None \
                or self._avg_prompt_tokens is None:
            return waiting, 0.0
        excess = tokens - waiting * self._avg_prompt_tokens
        return waiting, max(0.0, excess) * self._prefill_s_per_token

    def queued_token_excess_s_for(self, priority: str) -> float:
        """Class-aware :attr:`queued_token_excess_s`: only the queued
        tokens of same-or-higher classes count (a batch backlog must not
        inflate the shed estimate for an interactive submit)."""
        return self._queued_ahead(priority)[1]

    # -- priority control (brownout ladder / fleet passthroughs) ----------

    def set_admission_floor(self, priority: Optional[str]) -> None:
        """Pause dispatch of classes below ``priority`` (engine/scheduler
        passthrough); ``None`` restores all classes."""
        self.engine.set_admission_floor(priority)

    def preempt_class(self, priority: str, *, cause: str = "brownout") -> int:
        """Park every active slot of ``priority`` and immediately queue
        their resume continuations (the brownout ladder's "preempt batch
        slots" rung). Returns the number parked."""
        n = self.engine.park_class(priority, cause=cause)
        if n:
            self._drain_parked(clock.now())
            self._drain_backlog()
        return n

    # -- admission --------------------------------------------------------

    def submit(self, request: Request, *, resubmission: bool = False) -> int:
        """Admit one request through the overload gates: circuit breaker
        first, then the deadline-aware shed estimate, then the engine's
        own queue bound and expired-deadline fast-fail. Raises
        :class:`EngineUnavailableError` /
        :class:`~apex_tpu_torch.serving.scheduler.QueueFullError` /
        :class:`~apex_tpu_torch.serving.scheduler.DeadlineExpiredError`; every
        rejection is recorded terminally.

        ``resubmission=True`` is the fleet's migration path (a request
        handed over from a draining peer): it was already counted at its
        ORIGINAL submit, so ``requests_submitted`` is not incremented
        again — one arrival == one count == one terminal record, however
        many replicas the request visited."""
        if self._closed:
            raise RuntimeError("supervisor is closed")
        now = clock.now()
        self._poll_breaker(now)
        if self.breaker_state == BREAKER_OPEN:
            self._shed(request, "breaker", now, resubmission=resubmission)
        if (self.supervisor.shed_deadlines
                and request.deadline_s is not None
                and self._service_s is not None):
            # projected wait before this request even starts: everything
            # in line that would dispatch at-or-before its class, at the
            # observed per-request service rate, plus the token-aware
            # surcharge for unusually long prompts (0.0 until measured)
            waiting, excess_s = self._queued_ahead(
                request.sampling.priority)
            projected = waiting * self._service_s + excess_s
            start = request.arrival_ts if request.arrival_ts is not None \
                else now
            remaining = request.deadline_s - (now - start)
            if projected > remaining:
                self._shed(request, "deadline", now,
                           resubmission=resubmission,
                           projected_s=projected, remaining_s=remaining)
        tr = _Tracked(request, now, self._order)
        self._order += 1
        self._tracked[request.request_id] = tr
        try:
            self.engine.submit(request, resubmission=resubmission)
        except Exception:
            # QueueFull/DeadlineExpired were recorded terminally by the
            # engine and harvest below; validation errors recorded
            # nothing — either way the request must not stay tracked
            self._harvest(now)
            self._tracked.pop(request.request_id, None)
            raise
        return request.request_id

    def _shed(self, request: Request, why: str, now: float, *,
              resubmission: bool = False, **fields) -> None:
        """Reject at admission: terminal ``rejected`` record + counters +
        ``request_shed`` incident event, then raise."""
        if not resubmission:
            self.metrics.inc("requests_submitted")
        self.metrics.inc(f"requests_shed_{why}")
        self.metrics.inc(f"requests_{FINISH_REJECTED}")
        start = request.arrival_ts if request.arrival_ts is not None \
            else now
        result = RequestResult(
            request_id=request.request_id, prompt_len=request.prompt_len,
            tokens=[], finish_reason=FINISH_REJECTED,
            queue_s=now - start, total_s=now - start,
            replica_id=self.replica_id,
            adapter_id=request.sampling.adapter_id,
            trace_id=request.trace_id,
            priority=request.sampling.priority)
        self.completed[request.request_id] = result
        wall = clock.wall()
        # one shed phase span covering the request's whole (rejected)
        # lifetime — span-sum == total_s for admission sheds too
        emit_span(self.metrics, SPAN_SHED, trace_id=request.trace_id,
                  request_id=request.request_id, start_s=start,
                  end_s=now, wall=wall, replica_id=self.replica_id,
                  detail=why)
        self.metrics.emit_record(result.record(wall=wall))
        log_event(_LOG, "request_shed", request_id=request.request_id,
                  reason=why, **fields)
        self.metrics.event("request_shed", request_id=request.request_id,
                           reason=why, **fields)
        raise EngineUnavailableError(
            f"request {request.request_id} shed at admission "
            f"({why}): "
            + ("circuit breaker is open — engine is failing; retry after "
               f"{self.supervisor.breaker_cooldown_s}s"
               if why == "breaker" else
               f"projected queue wait {fields.get('projected_s', 0.0):.3f}s "
               f"exceeds remaining deadline "
               f"{fields.get('remaining_s', 0.0):.3f}s"))

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued, in-flight, or restart-pending request."""
        now = clock.now()
        for i, cont in enumerate(self._backlog):
            if cont.request_id == request_id:
                del self._backlog[i]
                self._resuming.discard(request_id)
                tr = self._tracked.pop(request_id)
                self._retire_supervised(tr, FINISH_CANCELLED, now)
                return True
        found = self.engine.cancel(request_id)
        if found:
            self._harvest(now)   # queued cancels are terminal immediately
        return found

    # -- the supervised tick ----------------------------------------------

    def tick(self) -> List[RequestResult]:
        """One engine tick under supervision. Failures (exception or
        hung-tick budget) trigger a restart with in-flight recovery; the
        return value lists requests that reached a terminal state in the
        SUPERVISOR's view during this call."""
        if self._closed:
            raise RuntimeError("supervisor is closed")
        before = set(self.completed)
        now = clock.now()
        self._poll_breaker(now)
        self._drain_backlog()
        compiles = self.engine.prefill_compiles + self.engine.decode_compiles
        t0 = clock.now()
        failure: Optional[str] = None
        try:
            self.engine.tick()
        except Exception as exc:  # tick faults are recoverable by design
            failure = f"{type(exc).__name__}: {exc}"
        else:
            hung = self.supervisor.hung_tick_s
            elapsed = clock.now() - t0
            # warmup ticks are exempt: a shape's first run (fresh engine,
            # new prefill bucket: kernel build, library handles) is not a
            # hang
            compiled = (self.engine.prefill_compiles
                        + self.engine.decode_compiles) > compiles
            if hung is not None and elapsed > hung and not compiled:
                failure = (f"hung tick: {elapsed:.3f}s > "
                           f"budget {hung:.3f}s")
        if failure is not None:
            self._on_tick_failure(failure)
        else:
            self._consecutive_failures = 0
            if self.breaker_state == BREAKER_HALF_OPEN:
                self._breaker_to(BREAKER_CLOSED)
            after = clock.now()
            self._harvest(after)
            # preempted slots parked this tick become resume
            # continuations NOW — re-queued in their own class lane so
            # strict priority keeps them behind the displacing traffic
            self._drain_parked(after)
            self._drain_backlog()
        return [self.completed[rid] for rid in sorted(
            set(self.completed) - before)]

    def serve(self, requests: Sequence[Request], *,
              on_tick: Optional[Callable[["EngineSupervisor", int], None]]
              = None, max_ticks: Optional[int] = None
              ) -> List[RequestResult]:
        """Serve ``requests`` to completion under supervision. Requests
        rejected by admission control (breaker open, shed, queue full)
        are terminal immediately and appear in the returned results with
        ``finish_reason="rejected"`` — every submitted request reaches a
        terminal state, faults or not."""
        pending = list(requests)
        ids = [r.request_id for r in pending]
        ticks = 0
        while pending or self._tracked:
            while pending and (self.engine.queued_count
                               < self.config.scheduler.max_queue):
                req = pending.pop(0)
                try:
                    self.submit(req)
                except (EngineUnavailableError, QueueFullError,
                        DeadlineExpiredError):
                    pass     # already recorded terminally
            self.tick()
            ticks += 1
            if on_tick is not None:
                on_tick(self, ticks)
            if max_ticks is not None and ticks >= max_ticks:
                break
        return [self.completed[i] for i in ids if i in self.completed]

    # -- failure handling -------------------------------------------------

    def _on_tick_failure(self, failure: str) -> None:
        self.metrics.inc("tick_failures")
        self._consecutive_failures += 1
        log_event(_LOG, "tick_failure", failure=failure,
                  consecutive=self._consecutive_failures)
        self.metrics.event("tick_failure", failure=failure,
                           consecutive=self._consecutive_failures)
        if self.breaker_state == BREAKER_HALF_OPEN:
            self._breaker_to(BREAKER_OPEN)     # failed probe: re-open
        elif (self.breaker_state == BREAKER_CLOSED
              and self._consecutive_failures
              >= self.supervisor.breaker_threshold):
            self._breaker_to(BREAKER_OPEN)
        self._restart(failure)

    def _restart(self, failure: str) -> None:
        """Rebuild the engine and recover its admitted work: terminal
        results survive as-is, queued requests requeue for free, and
        every in-flight request re-prefills from prompt + generated
        tokens (bounded by its retry budget)."""
        now = clock.now()
        old = self.engine
        self._harvest(now)       # anything terminal before the fault
        queued = {r.request_id for r, _ in old.scheduler.snapshot()}
        inflight = {req.request_id: toks
                    for req, toks, _ in old.inflight()}
        self.restarts += 1
        self.metrics.inc("engine_restarts")
        log_event(_LOG, "engine_restart", failure=failure,
                  restart=self.restarts, inflight=len(inflight),
                  queued=len(queued))
        self.metrics.event("engine_restart", failure=failure,
                           restart=self.restarts, inflight=len(inflight),
                           queued=len(queued))
        # the dead engine's host state is read: drop its caches (and its
        # cast model copy) before the rebuild allocates new ones
        old.release_device_memory()
        self.engine = None
        self.engine = self._build_engine()
        self._backlog = []
        # a pending resume swept into the rebuild becomes a plain
        # restart continuation — the resume mark fires at most once
        self._resuming.clear()
        exhausted = self.restarts > self.supervisor.max_engine_restarts
        for rid in sorted(self._tracked,
                          key=lambda r: self._tracked[r].order):
            tr = self._tracked[rid]
            tr.prefix += inflight.get(rid, [])
            began = rid not in queued   # left the queue => lost real work
            if began:
                tr.restarts += 1
            if exhausted or \
                    tr.restarts > self.supervisor.max_restarts_per_request:
                self._retire_supervised(tr, FINISH_ERROR, now,
                                        detail="retry_budget_exhausted")
                continue
            cont = self._continuation(tr, now)
            if cont is None:
                continue        # retired inside _continuation
            if began:
                self.metrics.inc("requests_recovered")
                log_event(_LOG, "request_recovered", request_id=rid,
                          restart=tr.restarts,
                          tokens_resumed=len(tr.prefix))
                self.metrics.event("request_recovered", request_id=rid,
                                   restart=tr.restarts,
                                   tokens_resumed=len(tr.prefix))
            self._backlog.append(cont)
        self._drain_backlog()

    def _continuation(self, tr: _Tracked, now: float) -> Optional[Request]:
        """Build the re-prefill request: prompt + recovered tokens, the
        remaining token budget, the ORIGINAL deadline clock. Returns
        None (after retiring the request) when nothing remains to do."""
        req = tr.request
        remaining = req.max_new_tokens - len(tr.prefix)
        if remaining <= 0:      # fully generated just as the engine died
            self._retire_supervised(tr, FINISH_LENGTH, now)
            return None
        start = req.arrival_ts if req.arrival_ts is not None \
            else tr.first_submit_ts
        if req.deadline_s is not None and now - start > req.deadline_s:
            self._retire_supervised(tr, FINISH_TIMEOUT, now)
            return None
        return Request(
            prompt=list(req.prompt) + tr.prefix,
            max_new_tokens=remaining, sampling=req.sampling,
            eos_token=req.eos_token, deadline_s=req.deadline_s,
            request_id=req.request_id, arrival_ts=start,
            trace_id=req.trace_id)

    def _drain_parked(self, now: float) -> None:
        """Turn preempted (parked) requests into restart-style resume
        continuations: fold the generated tokens into the tracked
        prefix, rebuild the request with the remaining budget and the
        ORIGINAL ids/deadline clock, and queue it for resubmission.
        Preemption is not a failure: restart budgets are NOT charged
        and ``requests_recovered`` does not fire — the resume has its
        own counter/event pair, emitted at successful resubmit."""
        for request, tokens, _submit_ts in self.engine.take_parked():
            tr = self._tracked.get(request.request_id)
            if tr is None:
                continue   # cancelled/retired while parked
            tr.prefix += tokens
            cont = self._continuation(tr, now)
            if cont is None:
                continue   # retired (length/timeout) inside
            self._resuming.add(request.request_id)
            self._backlog.append(cont)

    def _drain_backlog(self) -> None:
        while self._backlog and (self.engine.queued_count
                                 < self.config.scheduler.max_queue):
            cont = self._backlog.pop(0)
            rid = cont.request_id
            resuming = rid in self._resuming
            self._resuming.discard(rid)
            try:
                self.engine.submit(cont, resubmission=True)
            except (QueueFullError, DeadlineExpiredError):
                # terminal in the engine (recorded there) — harvest below
                self._harvest(clock.now())
            else:
                if resuming:
                    now = clock.now()
                    tr = self._tracked.get(rid)
                    carried = len(tr.prefix) if tr is not None else 0
                    self.metrics.inc("requests_resumed")
                    log_event(_LOG, "request_resumed", request_id=rid,
                              tokens_carried=carried)
                    self.metrics.event("request_resumed", request_id=rid,
                                       tokens_carried=carried)
                    # zero-width mark on the request's ORIGINAL trace —
                    # excluded from phase conservation (MARK_SPANS), the
                    # bookend of the park's ``preempt`` mark
                    emit_span(self.metrics, SPAN_RESUME,
                              trace_id=cont.trace_id, request_id=rid,
                              start_s=now, end_s=now, wall=clock.wall(),
                              replica_id=self.replica_id,
                              tokens_carried=carried)

    def _retire_supervised(self, tr: _Tracked, reason: str, now: float,
                           detail: Optional[str] = None) -> RequestResult:
        """Terminal retirement by the supervisor itself (over-budget,
        expired mid-restart, cancelled from the backlog): one counter
        increment, one ``kind="request"`` record, one event — same
        contract as an engine-side finish."""
        rid = tr.request.request_id
        self._tracked.pop(rid, None)
        result = RequestResult(
            request_id=rid, prompt_len=tr.request.prompt_len,
            tokens=list(tr.prefix), finish_reason=reason,
            total_s=now - tr.first_submit_ts, replica_id=self.replica_id,
            adapter_id=tr.request.sampling.adapter_id,
            trace_id=tr.request.trace_id,
            priority=tr.request.sampling.priority)
        self.completed[rid] = result
        self.metrics.inc(f"requests_{reason}")
        wall = clock.wall()
        # the engine incarnation that held this request died without
        # finishing it, so the supervisor owns the timeline: one coarse
        # phase span over the whole supervised lifetime (``decode`` when
        # generation actually completed, else ``shed``)
        emit_span(self.metrics,
                  SPAN_DECODE if reason in (FINISH_EOS, FINISH_LENGTH)
                  else SPAN_SHED,
                  trace_id=tr.request.trace_id, request_id=rid,
                  start_s=tr.first_submit_ts, end_s=now, wall=wall,
                  replica_id=self.replica_id, detail=detail)
        self.metrics.emit_record(result.record(wall=wall))
        extra = {"reason": detail} if detail else {}
        log_event(_LOG, f"request_{reason}", request_id=rid,
                  new_tokens=result.new_tokens, **extra)
        self.metrics.event(f"request_{reason}", request_id=rid,
                           new_tokens=result.new_tokens, **extra)
        return result

    # -- circuit breaker --------------------------------------------------

    def _poll_breaker(self, now: float) -> None:
        if self.breaker_state == BREAKER_OPEN and \
                now - self._breaker_opened_ts \
                >= self.supervisor.breaker_cooldown_s:
            self._breaker_to(BREAKER_HALF_OPEN)

    def _breaker_to(self, state: str) -> None:
        prev = self.breaker_state
        self.breaker_state = state
        if state == BREAKER_OPEN:
            self._breaker_opened_ts = clock.now()
            counter, event = "breaker_opens", "breaker_open"
        elif state == BREAKER_HALF_OPEN:
            counter, event = "breaker_half_opens", "breaker_half_open"
        else:
            counter, event = "breaker_closes", "breaker_closed"
        self.metrics.inc(counter)
        log_event(_LOG, event, previous=prev,
                  consecutive_failures=self._consecutive_failures)
        self.metrics.event(event, previous=prev,
                           consecutive_failures=self._consecutive_failures)

    # -- harvesting -------------------------------------------------------

    def _harvest(self, now: float) -> None:
        """Move the engine's newly-terminal results into the supervisor's
        view, stitching restarted requests back together: recovered
        prefix + continuation tokens, the ORIGINAL prompt length, and a
        total latency measured from the first submit."""
        done = [rid for rid in self._tracked
                if rid in self.engine.completed]
        for rid in sorted(done, key=lambda r: self._tracked[r].order):
            tr = self._tracked.pop(rid)
            res = self.engine.completed[rid]
            if tr.prefix or tr.restarts:
                # ttft_s only survives when no token predates this engine
                # incarnation (the original first-token timestamp died
                # with the crashed engine); tpot_s — the decode cadence —
                # stays meaningful for the continuation stream
                res = RequestResult(
                    request_id=rid, prompt_len=tr.request.prompt_len,
                    tokens=tr.prefix + res.tokens,
                    finish_reason=res.finish_reason,
                    queue_s=res.queue_s, prefill_s=res.prefill_s,
                    decode_s=res.decode_s,
                    total_s=now - tr.first_submit_ts,
                    ttft_s=None if tr.prefix else res.ttft_s,
                    tpot_s=res.tpot_s, replica_id=res.replica_id,
                    adapter_id=tr.request.sampling.adapter_id,
                    trace_id=tr.request.trace_id,
                    prefill_chunks=res.prefill_chunks,
                    priority=tr.request.sampling.priority)
            self.completed[rid] = res
            service = res.prefill_s + res.decode_s
            if service > 0 and res.finish_reason in (FINISH_EOS,
                                                     FINISH_LENGTH):
                a = self.supervisor.service_time_alpha
                self._service_s = (
                    service if self._service_s is None
                    else a * service + (1.0 - a) * self._service_s)
                # token-aware companions: per-token prefill cost and
                # typical prompt length, feeding queued_token_excess_s.
                # Under chunked prefill, prefill_s includes interleaved
                # co-tenant decode wall time — a conservative (over-)
                # estimate, which is the right bias for shedding.
                if res.prefill_s > 0 and res.prompt_len > 0:
                    rate = res.prefill_s / res.prompt_len
                    self._prefill_s_per_token = (
                        rate if self._prefill_s_per_token is None
                        else a * rate + (1.0 - a) * self._prefill_s_per_token)
                    self._avg_prompt_tokens = (
                        float(res.prompt_len)
                        if self._avg_prompt_tokens is None
                        else a * res.prompt_len
                        + (1.0 - a) * self._avg_prompt_tokens)

    # -- lifecycle --------------------------------------------------------

    # -- migration (the fleet's draining-restart path) --------------------

    def detach_for_migration(self) -> List:
        """Hand every non-terminal request over to the caller as
        ``(continuation, recovered_tokens)`` pairs, in arrival order —
        the fleet's draining-restart path: a peer replica re-prefills
        each continuation (prompt + tokens already generated) TOKEN-EXACT,
        exactly like this supervisor's own restart recovery.

        A request with nothing left to do (budget fully generated,
        deadline already expired) is retired terminally here instead of
        being handed over. After this call the supervisor tracks nothing;
        the caller is expected to :meth:`close` and rebuild it. Migration
        is not a failure: per-request restart budgets are NOT charged."""
        now = clock.now()
        self._harvest(now)
        inflight = {req.request_id: toks
                    for req, toks, _ in self.engine.inflight()}
        out: List = []
        for rid in sorted(self._tracked,
                          key=lambda r: self._tracked[r].order):
            tr = self._tracked[rid]
            tr.prefix += inflight.get(rid, [])
            cont = self._continuation(tr, now)
            if cont is None:
                continue        # retired (length/timeout) terminally
            self._tracked.pop(rid)
            out.append((cont, list(tr.prefix)))
        self._backlog = []
        self._resuming.clear()
        return out

    def close(self) -> None:
        """Close the underlying engine (releases slots, flushes the
        registry). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.engine.close()

    def release_device_memory(self) -> None:
        """Close, then drop the engine's KV pools and its cast model copy
        (:meth:`InferenceEngine.release_device_memory`): what a fleet does
        to a drained replica's supervisor before it builds the
        replacement, so the card never holds two sets of pools for one
        replica. Host state (:attr:`completed`, :attr:`restarts`, the
        service estimate) stays readable."""
        self.close()
        self.engine.release_device_memory()

    def __enter__(self) -> "EngineSupervisor":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
