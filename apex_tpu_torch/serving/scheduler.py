"""FCFS admission scheduling for the serving engine.

Adapted from ``apex_tpu/serving/scheduler.py`` (stdlib only), kept in the
port so it never imports the JAX package.

The queue half of continuous batching (Orca-style — PAPERS.md survey of
request-level schedulers; TorchTitan's serving siblings ship the same
split): the engine owns device state (slots, caches), the
scheduler owns the host-side request queue and the admission policy.

Design points:

- **Class-aware, head-of-line honest**: each priority class keeps its
  own FIFO lane; dispatch is strict-priority across lanes and FCFS
  inside one. A single-class workload (everything ``standard``, the default) is
  byte-identical to plain FCFS. If the selected head cannot be admitted
  (no free slot, policy hook defers), nothing jumps the line — resources
  it is waiting on will free up, so admitting around it would starve it;
  smarter policies plug in via ``admission_hook``.
- **Anti-starvation aging**: a ``batch`` head that has waited longer
  than ``batch_aging_s`` competes at ``standard`` rank, so a steady
  stream of standard traffic cannot starve batch forever. Aging never
  lifts batch above ``interactive``, and never bypasses an admission
  floor (``set_admission_floor`` filters on the TRUE class).
- **Bounded queue = backpressure**: ``submit`` past ``max_queue`` raises
  :class:`QueueFullError` so callers shed load at the edge instead of
  growing an unbounded host-side backlog.
- **Bucketed prefill**: prompts prefill at power-of-two padded lengths
  (:func:`bucket_for`), so the number of distinct prefill shapes is
  ``log2(max_len)``-bounded no matter how ragged the traffic is.
- **Decode-starvation cap**: while any slot is decoding, at most
  ``max_prefills_per_tick`` prefills are admitted per engine tick, so a
  deep queue of arrivals cannot stall in-flight requests' token cadence;
  with nothing decoding, admission bursts to fill all free slots.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from apex_tpu_torch.serving.request import (PRIORITIES, PRIORITY_BATCH,
                                      PRIORITY_RANK, PRIORITY_STANDARD,
                                      Request)

__all__ = ["QueueFullError", "DeadlineExpiredError", "SchedulerConfig",
           "FCFSScheduler", "prefill_buckets", "bucket_for"]


class QueueFullError(RuntimeError):
    """The bounded admission queue is full — shed load upstream."""


class DeadlineExpiredError(RuntimeError):
    """The request's deadline had already elapsed at submit time (its
    ``arrival_ts`` is older than ``deadline_s``) — fast-fail instead of
    queuing work that can only ever finish as a timeout."""


def prefill_buckets(max_len: int) -> Tuple[int, ...]:
    """Padded prefill lengths: powers of two up to ``max_len``, plus
    ``max_len`` itself — the complete, static set of prefill shapes the
    engine can ever compile."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    buckets = []
    b = 1
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_for(length: int, max_len: int) -> int:
    """Smallest bucket that fits ``length`` tokens."""
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")
    if length > max_len:
        raise ValueError(f"length {length} exceeds max_len {max_len}")
    for b in prefill_buckets(max_len):
        if b >= length:
            return b
    raise AssertionError("unreachable: max_len bucket fits by construction")


@dataclass
class SchedulerConfig:
    """Knobs for :class:`FCFSScheduler`.

    ``admission_hook`` is the policy extension point: called with the
    head-of-queue request right before admission; returning False defers
    it (and, FCFS, everything behind it) to a later tick — enough to
    express cost caps, per-tenant throttles, or load-aware admission
    without subclassing.
    """

    max_queue: int = 64
    #: decode-starvation cap — prefills admitted per tick while any slot
    #: is mid-decode (a tick always runs one decode step for all active
    #: slots, so in-flight requests advance at least once per tick)
    max_prefills_per_tick: int = 1
    admission_hook: Optional[Callable[[Request], bool]] = None
    #: anti-starvation floor: a queued ``batch`` head older than this
    #: competes at ``standard`` rank (never above ``interactive``)
    batch_aging_s: float = 30.0

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_prefills_per_tick < 1:
            raise ValueError(
                f"max_prefills_per_tick must be >= 1, got "
                f"{self.max_prefills_per_tick}")
        if self.batch_aging_s < 0.0:
            raise ValueError(
                f"batch_aging_s must be >= 0, got {self.batch_aging_s}")


@dataclass
class _Queued:
    request: Request
    submit_ts: float
    #: arrival order — totally orders requests ACROSS the per-class lanes
    #: (snapshot/restart replay arrival order exactly; requeue_front
    #: entries get negative orders so they sort first)
    order: int = 0


class FCFSScheduler:
    """Bounded, priority-class-aware admission queue with deadline
    expiry. The name survives from the single-lane original: dispatch is
    still FCFS *inside* a class, and an all-``standard`` workload
    behaves exactly as before."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._queues: Dict[str, Deque[_Queued]] = {
            p: deque() for p in PRIORITIES}
        self._next_order = 0
        self._next_front = -1
        #: admission floor rank — classes with a TRUE rank above this are
        #: not dispatched (brownout's "pause batch/standard" rungs)
        self._floor_rank = PRIORITY_RANK[PRIORITY_BATCH]

    def _lane(self, request: Request) -> Deque[_Queued]:
        return self._queues[request.sampling.priority]

    def _all(self) -> List[_Queued]:
        out = [q for lane in self._queues.values() for q in lane]
        out.sort(key=lambda q: q.order)
        return out

    @property
    def depth(self) -> int:
        return sum(len(lane) for lane in self._queues.values())

    @property
    def queued_tokens(self) -> int:
        """Total PROMPT tokens waiting in line — the token-denominated
        companion to ``depth``: a backlog of long prompts costs far more
        prefill work than the same depth of short ones (the supervisor's
        deadline-shed projection folds it in)."""
        return sum(q.request.prompt_len
                   for lane in self._queues.values() for q in lane)

    def queued_tokens_by_class(self) -> Dict[str, int]:
        """Queued PROMPT tokens per priority class, so an interactive
        submit's shed projection counts only the backlog that would run
        ahead of it."""
        return {p: sum(q.request.prompt_len for q in lane)
                for p, lane in self._queues.items()}

    def depth_by_class(self) -> Dict[str, int]:
        """Queue depth per priority class."""
        return {p: len(lane) for p, lane in self._queues.items()}

    def set_admission_floor(self, priority: Optional[str]) -> None:
        """Pause dispatch of classes BELOW ``priority`` (higher rank): the
        brownout ladder's "pause batch admissions" rung. ``None`` (or
        ``"batch"``) restores dispatch of every class. Paused requests stay
        queued — deadline expiry still applies. The floor filters on a
        request's TRUE class, so aging cannot tunnel through it."""
        if priority is None:
            self._floor_rank = PRIORITY_RANK[PRIORITY_BATCH]
            return
        if priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {PRIORITIES} or None, "
                f"got {priority!r}")
        self._floor_rank = PRIORITY_RANK[priority]

    @property
    def admission_floor(self) -> str:
        """The lowest-ranked class currently admissible."""
        return PRIORITIES[self._floor_rank]

    def _effective_rank(self, priority: str, head: _Queued,
                        now: Optional[float]) -> int:
        rank = PRIORITY_RANK[priority]
        if (priority == PRIORITY_BATCH and now is not None
                and now - head.submit_ts > self.config.batch_aging_s):
            rank = PRIORITY_RANK[PRIORITY_STANDARD]
        return rank

    def _select_class(self, now: Optional[float]) -> Optional[str]:
        """The class whose head dispatches next: lowest effective rank
        (aging may promote a stale batch head to standard rank), oldest
        arrival on ties, honoring the admission floor."""
        best, best_key = None, None
        for p, lane in self._queues.items():
            if not lane or PRIORITY_RANK[p] > self._floor_rank:
                continue
            head = lane[0]
            key = (self._effective_rank(p, head, now), head.order)
            if best_key is None or key < best_key:
                best, best_key = p, key
        return best

    def head(self, now: Optional[float] = None
             ) -> Optional[Tuple[Request, float]]:
        """The (request, submit_ts) that ``pop_admissible`` would consider
        next, non-popping — the engine's preemption check peeks here."""
        p = self._select_class(now)
        if p is None:
            return None
        head = self._queues[p][0]
        return head.request, head.submit_ts

    def submit(self, request: Request, now: float) -> None:
        # deadline fast-fail: a request whose budget elapsed before it
        # reached the queue (stale arrival_ts) can only ever time out —
        # reject it at the edge instead of letting it rot in line
        start = request.arrival_ts if request.arrival_ts is not None \
            else now
        if request.deadline_s is not None and \
                now - start > request.deadline_s:
            raise DeadlineExpiredError(
                f"request {request.request_id} deadline "
                f"({request.deadline_s}s) already elapsed "
                f"{now - start - request.deadline_s:.3f}s before submit")
        if self.depth >= self.config.max_queue:
            raise QueueFullError(
                f"admission queue full ({self.config.max_queue}); "
                f"request {request.request_id} rejected — retry with "
                f"backoff or raise SchedulerConfig.max_queue")
        self._lane(request).append(_Queued(request, start, self._next_order))
        self._next_order += 1

    def cancel(self, request_id: int) -> Optional[Tuple[Request, float]]:
        """Remove a still-queued request; (request, submit_ts) or None."""
        for lane in self._queues.values():
            for i, q in enumerate(lane):
                if q.request.request_id == request_id:
                    del lane[i]
                    return q.request, q.submit_ts
        return None

    def expire(self, now: float) -> List[Tuple[Request, float]]:
        """Pop queued requests whose deadline elapsed while waiting —
        including requests an admission floor is holding back (paused does
        not mean immortal)."""
        dead: List[_Queued] = []
        for p, lane in self._queues.items():
            kept: Deque[_Queued] = deque()
            for q in lane:
                d = q.request.deadline_s
                if d is not None and now - q.submit_ts > d:
                    dead.append(q)
                else:
                    kept.append(q)
            self._queues[p] = kept
        dead.sort(key=lambda q: q.order)
        return [(q.request, q.submit_ts) for q in dead]

    def pop_admissible(self, free_slots: int, decoding: bool, *,
                       predicate: Optional[Callable[[Request], str]] = None,
                       shed: Optional[List[Tuple[Request, float]]] = None,
                       now: Optional[float] = None
                       ) -> List[Tuple[Request, float]]:
        """The admission batch for this tick: up to ``free_slots``
        requests, capped at ``max_prefills_per_tick`` while decode
        traffic is in flight (the starvation cap). Heads are taken in
        strict-priority order across class lanes (FCFS inside a lane,
        batch aging per ``batch_aging_s`` when ``now`` is given). Stops
        at the first head the admission hook defers — no queue jumping,
        in ANY lane: a deferred head is waiting on resources that will
        free up, and dispatching a lower class around it would invert
        the priority order the moment they do.

        ``predicate(request)`` refines admission per request (the
        engine's pages-aware policy): ``"admit"`` pops and admits,
        ``"defer"`` head-blocks like the admission hook (resources will
        free up — wait, FCFS honest), ``"shed"`` pops the request
        WITHOUT admitting it and appends ``(request, submit_ts)`` to the
        caller's ``shed`` list (it can never be satisfied — the caller
        records the rejection). The predicate runs after the admission
        hook and only counts admitted requests against the cap."""
        cap = free_slots
        if decoding:
            cap = min(cap, self.config.max_prefills_per_tick)
        admitted: List[Tuple[Request, float]] = []
        hook = self.config.admission_hook
        while len(admitted) < cap:
            p = self._select_class(now)
            if p is None:
                break
            lane = self._queues[p]
            head = lane[0]
            if hook is not None and not hook(head.request):
                break
            if predicate is not None:
                verdict = predicate(head.request)
                if verdict == "defer":
                    break
                if verdict == "shed":
                    lane.popleft()
                    if shed is not None:
                        shed.append((head.request, head.submit_ts))
                    continue
                if verdict != "admit":
                    raise ValueError(
                        f"admission predicate must return 'admit', "
                        f"'defer', or 'shed'; got {verdict!r}")
            lane.popleft()
            admitted.append((head.request, head.submit_ts))
        return admitted

    def requeue_front(self, request: Request, submit_ts: float) -> None:
        """Put a popped request BACK at the head of its class lane,
        keeping its original ``submit_ts`` (deadline clock keeps
        running). Used when the engine discovers, after
        ``pop_admissible`` said yes, that the resources it predicted are
        gone (an intern-index eviction reshaped the page pool) — FCFS
        honesty demands the request retries from the front, not the
        back. Deliberately bypasses ``max_queue``: the request already
        held a queue position."""
        self._lane(request).appendleft(
            _Queued(request, submit_ts, self._next_front))
        self._next_front -= 1

    def snapshot(self) -> List[Tuple[Request, float]]:
        """Queued (request, submit_ts) pairs in arrival order across all
        classes, non-popping — the supervisor's restart path uses this to
        requeue survivors."""
        return [(q.request, q.submit_ts) for q in self._all()]
