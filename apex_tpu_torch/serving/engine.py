"""Continuous-batching inference engine over the paged decode path.

Counterpart of ``apex_tpu/serving/engine.py``: greedy requests on the
paged KV layout, with the prefix cache, int8 KV pools and self-speculative
verify windows. The loop is the JAX engine's — requests are admitted and
retired per decode step over one batched step across all slots:

- **Slots and pages**: :class:`~apex_tpu_torch.serving.slots.SlotPool`
  hands out decode rows; :class:`~apex_tpu_torch.serving.slots.PagePool`
  maps each slot onto pages of the shared per-layer pools through a host
  page table whose unmapped entries hold the sentinel ``n_pages``.
  Admission reserves a request's worst case (prompt + max_new_tokens), so
  decode-time page growth can never exhaust the pool.
- **Bucketed prefill**: a prompt is right-padded to a power-of-two
  bucket, run through the 4D-cache prefill path (causal flash), and its
  K/V rows are copied into the slot's pages (int8 pools: each whole page
  quantized at its own scale); the LM head reads the single row
  ``prompt_len - 1``. Chunks past the mapped pages are dropped.
- **Prefix cache** (``prefix_cache=True``, the default): a prompt's
  page-aligned prefix is interned in the pool's content-addressed index
  once its prefill logits are finite; a later prompt sharing it maps
  those pages refcounted and prefills only its suffix at the cache
  offset (the mid-cache 4D path: offset-causal mask, unfused softmax).
  A fully page-aligned hit recomputes the prompt's last token for its
  logits and skips writing its row (the copy-on-write seam).
- **One decode step per tick** over every slot: page table, positions and
  tokens are uploaded once per tick, each layer appends its row and runs
  the paged decode kernel, and the next tokens come back in ONE host read.
  With ``speculation=k`` the step is a ``k``-row verify window a slot
  (the token to feed, then an n-gram draft over the slot's own history),
  and the longest prefix the model agrees with is accepted. A slot whose
  logits are not finite is quarantined (the pages its release frees are
  zeroed, and their scales) while co-tenants keep serving.

Eager PyTorch has no retrace, so the JAX engine's retrace watchdog has no
counterpart; caches are updated in place (no donation). Knobs of later
slices — ``prefill_token_budget``, ``kv_layout="flat"``, adapters, fault
injectors, and sampled requests (``temperature > 0``, which needs the
threefry port for token parity) — raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.models.generation import (
    _cached_forward,
    cast_decode_params,
    decode_step,
    flatten_decode_caches,
    init_kv_caches,
    init_paged_kv_caches,
)
from apex_tpu_torch.observability.registry import MetricsRegistry
from apex_tpu_torch.ops._support import cdiv, resolve_device
from apex_tpu_torch.ops.decode_attention import (
    paged_quant_fill,
    paged_quant_scatter,
    spare_page_view,
)
from apex_tpu_torch.serving import clock
from apex_tpu_torch.serving.prefix import prefix_hash_chain, prefix_salt
from apex_tpu_torch.serving.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISH_TIMEOUT,
    Request,
    RequestResult,
)
from apex_tpu_torch.serving.scheduler import (
    DeadlineExpiredError,
    FCFSScheduler,
    QueueFullError,
    SchedulerConfig,
    bucket_for,
    prefill_buckets,
)
from apex_tpu_torch.serving.slots import PagePool, SlotPool
from apex_tpu_torch.serving.speculation import propose_draft

__all__ = ["EngineConfig", "InferenceEngine"]

#: declared up front so final counter snapshots carry every key
_COUNTERS = ("requests_submitted", "requests_eos", "requests_length",
             "requests_cancelled", "requests_timeout", "requests_rejected",
             "requests_error", "prefills", "decode_steps",
             "tokens_generated", "slots_quarantined", "requests_shed_pages",
             # prefix cache: hits + misses == prefills when it is on;
             # pages_shared counts prefill pages NOT recomputed
             "prefix_hits", "prefix_misses", "prefix_pages_shared",
             "prefix_evictions",
             # speculative decoding: proposed counts drafted positions
             # beyond the forced first feed, accepted the ones the model
             # agreed with
             "draft_tokens_proposed", "draft_tokens_accepted")


@dataclass
class EngineConfig:
    """Engine sizing knobs — the JAX ``EngineConfig``'s names and
    defaults. ``retrace_budget`` and ``donate_caches`` have no counterpart
    in eager PyTorch and are absent.

    ``n_pages=None`` sizes the pool to back every slot at ``max_len``;
    smaller overcommits, and a request whose worst case can never fit is
    shed as ``pages_exhausted``. ``prefix_cache`` interns page-aligned
    prompt prefixes (``prefix_lru_capacity`` entries, evicted LRU-first
    under page pressure); ``False`` restores the one-owner pool.
    ``kv_dtype="int8"`` stores the pools int8 with per-(page, kv-head)
    scales; ``speculation=k`` (``k >= 2``) makes each decode step a
    ``k``-row verify window. Both keep greedy streams token-exact
    against the defaults."""

    max_slots: int = 8
    max_len: int = 512
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    kv_layout: str = "paged"
    page_size: int = 64
    n_pages: Optional[int] = None
    prefix_cache: bool = True
    prefix_lru_capacity: int = 32
    kv_dtype: str = "bf16"
    speculation: int = 0
    prefill_token_budget: Optional[int] = None

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 2:
            raise ValueError(
                f"max_len must be >= 2 (one prompt + one generated token), "
                f"got {self.max_len}")
        if self.kv_layout not in ("flat", "paged"):
            raise ValueError(f"kv_layout must be 'flat' or 'paged', got "
                             f"{self.kv_layout!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.prefix_lru_capacity < 0:
            raise ValueError(f"prefix_lru_capacity must be >= 0, got "
                             f"{self.prefix_lru_capacity}")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{self.kv_dtype!r}")
        if self.speculation < 0 or self.speculation == 1:
            raise ValueError(f"speculation is 0 (off) or a verify window "
                             f">= 2, got {self.speculation}")
        unported = [name for name, on in (
            ("kv_layout='flat'", self.kv_layout == "flat"),
            ("prefill_token_budget", self.prefill_token_budget is not None),
        ) if on]
        if unported:
            raise NotImplementedError(
                f"not ported yet (later slices): {', '.join(unported)}")

    @property
    def pages_per_slot(self) -> int:
        """Page-table width: pages covering one slot at ``max_len``."""
        return -(-self.max_len // self.page_size)


class _Active:
    """Host-side state of a request holding a slot."""

    __slots__ = ("request", "slot", "tokens", "last_token", "position",
                 "submit_ts", "prefill_start", "prefill_end",
                 "first_token_ts", "last_token_ts", "cancelled",
                 "reserved_pages", "spec_proposed", "spec_accepted")

    def __init__(self, request: Request, slot: int, submit_ts: float):
        self.request = request
        self.slot = slot
        self.tokens: List[int] = []
        self.last_token = 0
        self.position = 0        # cache rows written for this slot
        self.reserved_pages = 0  # worst-case pages minus shared-prefix hit
        self.spec_proposed = 0   # draft positions offered over the lifetime
        self.spec_accepted = 0   # draft positions the model agreed with
        self.submit_ts = submit_ts
        self.prefill_start = 0.0
        self.prefill_end = 0.0
        self.first_token_ts = 0.0
        self.last_token_ts = 0.0
        self.cancelled = False


class InferenceEngine:
    """Continuous-batching serving engine; see the module docstring.

    Drive it with :meth:`serve` (submit a request list, tick to
    completion, collect results) or with :meth:`submit` + :meth:`tick`.
    The model must already live on ``device`` (``"cuda"`` unless the
    caller asks for the CPU); under a non-fp32 ``compute_dtype`` the engine
    serves its own copy of the model, cast once at construction, and the
    caller's model keeps its fp32 parameters.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None, *,
                 metrics: Optional[MetricsRegistry] = None, faults=None,
                 replica_id: Optional[int] = None, adapters=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if faults is not None or adapters is not None:
            raise NotImplementedError(
                "fault injectors and LoRA adapters are not ported yet")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device} but the engine "
                             f"runs on {self.device}; build the model with "
                             f"device={str(self.device)!r}")
        self.model = model
        self.config = config or EngineConfig()
        self.replica_id = replica_id
        self._closed = False
        c = model.config
        if (c.position_embedding_type == "learned"
                and self.config.max_len > c.max_position_embeddings):
            raise ValueError(
                f"max_len ({self.config.max_len}) exceeds the model's "
                f"max_position_embeddings ({c.max_position_embeddings})")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.declare_counters(*_COUNTERS)
        self.scheduler = FCFSScheduler(self.config.scheduler)
        self.slots = SlotPool(self.config.max_slots)
        self.buckets = prefill_buckets(self.config.max_len)
        self.completed: Dict[int, RequestResult] = {}
        #: request ids in admission (prefill) order — the FCFS audit trail
        self.admission_log: List[int] = []
        self._active: Dict[int, _Active] = {}      # slot -> state
        self._vocab = c.vocab_size
        if c.compute_dtype != torch.float32:
            model = self.model = cast_decode_params(model, c.compute_dtype)

        pps = self.config.pages_per_slot
        n_pages = (self.config.n_pages if self.config.n_pages is not None
                   else self.config.max_slots * pps)
        self.pages = PagePool(
            n_pages, self.config.page_size, pps,
            lru_capacity=(self.config.prefix_lru_capacity
                          if self.config.prefix_cache else 0))
        #: salt of the prompt-prefix hash chains: the model's fingerprint
        self._prefix_salt = prefix_salt(c)
        self._evictions_seen = 0
        self._quantized = self.config.kv_dtype == "int8"
        self._caches = init_paged_kv_caches(model, n_pages,
                                            self.config.page_size,
                                            quantized=self._quantized)
        # bytes one decode step streams per mapped page (K + V, all layers,
        # plus the f32 scale sidecars when quantized)
        itemsize = 1 if self._quantized else torch.empty(
            (), dtype=c.compute_dtype).element_size()
        self._page_read_bytes = 2 * c.num_layers * (
            self.config.page_size * c.kv_heads * c.head_dim * itemsize
            + (c.kv_heads * 4 if self._quantized else 0))
        self._page_table_h = np.full((self.config.max_slots, pps), n_pages,
                                     np.int32)
        self._reserved_pages = 0
        n = self.config.max_slots
        self._tokens_h = np.zeros(n, np.int64)
        self._positions_h = np.zeros(n, np.int32)
        #: speculation: per-slot verify window (row 0 the token the
        #: sequential step would feed, rows 1.. the n-gram draft, padded by
        #: repeating the last real feed) and its valid length
        self._spec = self.config.speculation
        if self._spec:
            self._window_h = np.zeros((n, self._spec), np.int64)
            self._wlen_h = np.ones(n, np.int32)

    # -- introspection ----------------------------------------------------

    @property
    def active_count(self) -> int:
        return self.slots.active_count

    @property
    def queued_count(self) -> int:
        return self.scheduler.depth

    # -- request lifecycle ------------------------------------------------

    def submit(self, request: Request) -> int:
        """Enqueue; returns the request id. Raises
        :class:`~apex_tpu_torch.serving.scheduler.QueueFullError` /
        :class:`~apex_tpu_torch.serving.scheduler.DeadlineExpiredError`
        after recording a ``rejected`` result."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if request.request_id in self.completed:
            raise ValueError(
                f"request id {request.request_id} already completed")
        if request.total_len > self.config.max_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the engine's max_len "
                f"({self.config.max_len})")
        sp = request.sampling
        if sp.temperature > 0.0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) needs the threefry port "
                "for token parity; only greedy requests are served yet")
        if sp.adapter_id is not None:
            raise NotImplementedError("LoRA adapters are not ported yet")
        now = clock.now()
        self.metrics.inc("requests_submitted")
        try:
            self.scheduler.submit(request, now)
        except QueueFullError:
            self._finish(request, [], FINISH_REJECTED, submit_ts=now,
                         now=now, detail="queue_full")
            raise
        except DeadlineExpiredError:
            self._finish(request, [], FINISH_REJECTED, submit_ts=now,
                         now=now, detail="deadline_expired")
            raise
        return request.request_id

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or in-flight request; returns True when found.
        A queued request terminates now; an in-flight one is evicted at
        the start of the next tick, keeping its partial tokens."""
        queued = self.scheduler.cancel(request_id)
        if queued is not None:
            request, submit_ts = queued
            self._finish(request, [], FINISH_CANCELLED, submit_ts=submit_ts,
                         now=clock.now())
            return True
        for rec in self._active.values():
            if rec.request.request_id == request_id:
                rec.cancelled = True
                return True
        return False

    def tick(self) -> List[RequestResult]:
        """One scheduler iteration: expire deadlines, evict cancellations,
        admit + prefill (FCFS, decode-starvation capped), then one batched
        decode step over all active slots. Returns the requests that
        reached a terminal state during this tick."""
        if self._closed:
            raise RuntimeError("engine is closed")
        finished: List[RequestResult] = []
        now = clock.now()
        self._expire(now, finished)
        self._evict_cancelled(finished)
        self._admit(finished)
        self._decode_tick(finished)
        self.metrics.observe("slot_occupancy", self.slots.occupancy)
        self.metrics.set_gauge("kv_pages_in_use", self.pages.in_use_count)
        self.metrics.set_gauge("kv_pages_free", self.pages.free_count)
        self.metrics.observe("kv_page_occupancy", self.pages.occupancy)
        delta = self.pages.evictions - self._evictions_seen
        if delta:
            self.metrics.inc("prefix_evictions", delta)
            self._evictions_seen = self.pages.evictions
        return finished

    def serve(self, requests: Sequence[Request], *,
              on_tick: Optional[Callable[["InferenceEngine", int], None]]
              = None, max_ticks: Optional[int] = None
              ) -> List[RequestResult]:
        """Serve ``requests`` to completion: submit lazily as the bounded
        queue drains, tick until idle, return results in input order.
        ``on_tick(engine, i)`` runs after each tick."""
        pending = list(requests)
        ids = [r.request_id for r in pending]
        ticks = 0
        while pending or self.scheduler.depth or self._active:
            while pending and \
                    self.scheduler.depth < self.config.scheduler.max_queue:
                self.submit(pending.pop(0))
            before = (len(pending), self.scheduler.depth, len(self._active))
            self.tick()
            ticks += 1
            if on_tick is not None:
                on_tick(self, ticks)
            if max_ticks is not None and ticks >= max_ticks:
                break
            if (before == (len(pending), self.scheduler.depth,
                           len(self._active))
                    and not self._active and self.scheduler.depth):
                raise RuntimeError(
                    "serve() made no progress: queued requests exist but "
                    "none are admissible (admission_hook deferring "
                    "forever?)")
        return [self.completed[i] for i in ids if i in self.completed]

    def close(self) -> None:
        """Release every slot and page and flush the metrics registry.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._active.clear()
        self.slots.reset()
        self.pages.reset()
        self._reserved_pages = 0
        self._page_table_h[:] = self.pages.n_pages
        self.metrics.flush()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- tick phases ------------------------------------------------------

    def _expire(self, now: float, finished: List[RequestResult]) -> None:
        for request, submit_ts in self.scheduler.expire(now):
            finished.append(self._finish(
                request, [], FINISH_TIMEOUT, submit_ts=submit_ts, now=now))
        for slot in sorted(self._active):
            rec = self._active[slot]
            d = rec.request.deadline_s
            if d is not None and now - rec.submit_ts > d:
                finished.append(self._retire(rec, FINISH_TIMEOUT, now))

    def _evict_cancelled(self, finished: List[RequestResult]) -> None:
        for slot in sorted(self._active):
            rec = self._active[slot]
            if rec.cancelled:
                finished.append(self._retire(
                    rec, FINISH_CANCELLED, clock.now()))

    def _plan_prefix(self, request: Request):
        """Match ``request``'s page-aligned prompt prefix against the
        intern index: ``(chain, shared_pages, skip_first)``. The chain is
        always computed (the miss path interns it); ``shared_pages`` is
        the longest interned leading run (empty on a miss or with
        ``prefix_cache=False``). ``skip_first`` marks the fully
        page-aligned hit, whose suffix prefill recomputes only the
        prompt's last token with its K/V write masked. A match is trimmed
        when its suffix bucket would overrun ``max_len``, so the bucket
        set keeps holding."""
        ps = self.config.page_size
        chain = prefix_hash_chain(request.prompt, ps, self._prefix_salt)
        if not self.config.prefix_cache or not chain:
            return chain, [], False
        pages, matched = self.pages.match_prefix(chain)
        max_len = self.config.max_len
        while matched:
            start = (request.prompt_len - 1
                     if matched * ps == request.prompt_len
                     else matched * ps)
            if start + bucket_for(request.prompt_len - start,
                                  max_len) <= max_len:
                break
            matched -= 1
        if matched == 0:
            return chain, [], False
        return chain, pages[:matched], matched * ps == request.prompt_len

    def _page_predicate(self):
        """Admission predicate: a request enters only when its worst-case
        page need (minus the shared-prefix pages a cache hit maps
        refcounted) fits beside every admitted request's outstanding
        reservation. Pages held only by the intern index count as
        capacity, since allocation evicts entries under pressure, less
        this request's own shared pages (mapping pins them). One that can
        never fit is shed, one that must wait defers (FCFS head-blocking).
        ``planned`` and ``planned_shared`` accumulate across the pops of
        one call."""
        planned = 0          # private pages promised this tick
        planned_shared = 0   # reclaimable pages pinned this tick

        def predicate(request):
            nonlocal planned, planned_shared
            need = self.pages.pages_for(request.total_len)
            if need > self.pages.n_pages:
                return "shed"
            _, shared_pages, _ = self._plan_prefix(request)
            shared = len(shared_pages)
            pool = self.pages
            avail = (pool.free_count
                     + max(0, pool.reclaimable_count
                           - planned_shared - shared)
                     - (self._reserved_pages - pool.owned_count)
                     - planned)
            if need - shared <= avail:
                planned += need - shared
                planned_shared += shared
                return "admit"
            return "defer"

        return predicate

    def _admit(self, finished: List[RequestResult]) -> None:
        shed: List = []
        now = clock.now()
        batch = self.scheduler.pop_admissible(
            self.slots.free_count, decoding=bool(self._active),
            predicate=self._page_predicate(), shed=shed, now=now)
        for request, submit_ts in shed:
            finished.append(self._shed_pages(request, submit_ts, now))
        for request, submit_ts in batch:
            slot = self.slots.allocate()
            assert slot is not None  # pop_admissible respects free_count
            self._prefill_into(request, slot, submit_ts, finished)

    def _shed_pages(self, request: Request, submit_ts: float,
                    now: float) -> RequestResult:
        need = self.pages.pages_for(request.total_len)
        self.metrics.inc("requests_shed_pages")
        self.metrics.event("request_shed", request_id=request.request_id,
                           reason="pages_exhausted", pages_needed=need,
                           n_pages=self.pages.n_pages)
        return self._finish(request, [], FINISH_REJECTED,
                            submit_ts=submit_ts, now=now,
                            detail="pages_exhausted")

    def _first_token(self, logits: torch.Tensor):
        """``(greedy token, finite)`` of one prefill's logits ``[1, 1,
        V]``, in one host read."""
        row = logits[0, 0]
        both = torch.stack([torch.argmax(row),
                            torch.isfinite(row).all().long()]).tolist()
        return int(both[0]), bool(both[1])

    def _paged_prefill(self, page_row: np.ndarray, prompt: np.ndarray,
                       prompt_len: int):
        """Prefill one bucket-padded prompt ``[1, bucket]`` and land its
        K/V rows in the slot's pages (``page_row``); returns ``(first
        token, finite logits)``. Chunks whose page is the sentinel (bucket
        padding past the mapped pages) are dropped; garbage rows inside the
        last mapped page stay causally masked by the slot's position. An
        int8 pool takes each chunk as a whole page at its own scale
        (:func:`paged_quant_fill`)."""
        model = self.model
        bucket = prompt.shape[1]
        small = init_kv_caches(model, 1, bucket)
        logits, small = _cached_forward(
            model, small, torch.as_tensor(prompt, device=self.device), 0,
            last_index=prompt_len - 1)
        ps = self.config.page_size
        n_chunks = cdiv(bucket, ps)
        pad = n_chunks * ps - bucket
        if self._quantized:
            dest = torch.as_tensor(page_row[:n_chunks].astype(np.int64),
                                   device=self.device)
            for ((bk, bks), (bv, bvs)), (fk, fv) in zip(
                    self._caches, flatten_decode_caches(small)):
                for pool, scales, rows in ((bk, bks, fk), (bv, bvs, fv)):
                    paged_quant_fill(pool, scales, F.pad(
                        rows[0], (0, 0, 0, pad)).reshape(n_chunks, ps, -1),
                        dest)
            return self._first_token(logits)
        keep = [i for i in range(n_chunks)
                if page_row[i] < self.pages.n_pages]
        dest = torch.as_tensor(page_row[keep].astype(np.int64),
                               device=self.device)
        sel = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        for (bk, bv), (fk, fv) in zip(self._caches,
                                      flatten_decode_caches(small)):
            for pool, rows in ((bk, fk), (bv, fv)):
                chunks = F.pad(rows[0], (0, 0, 0, pad)).reshape(
                    n_chunks, ps, -1)
                pool.index_copy_(0, dest,
                                 chunks.index_select(0, sel).to(pool.dtype))
        return self._first_token(logits)

    def _suffix_prefill(self, page_row: np.ndarray, suffix: np.ndarray,
                        start: int, suffix_len: int, skip_first: bool):
        """Prefill ONLY the suffix of a prefix-cache hit; returns ``(first
        token, finite logits)``.

        The slot's page row already maps the shared prefix pages for
        tokens ``[0, start)``; their rows (int8 ones dequantized with their
        pages' scales) are gathered into a 4D cache of ``pages_per_slot *
        page_size + bucket`` rows, the suffix runs at ``cache_index =
        start`` (the mid-cache path: offset-causal mask, rope and
        positions at the absolute offset), and the suffix K/V rows land
        in the slot's PRIVATE pages row by row (int8 through the
        rescale-on-append scatter). Shared pages are never written: with
        ``skip_first`` (a fully page-aligned hit, whose one-token suffix
        recomputes the prompt's last token for its logits only) that
        row's write is masked, since it already lives in the last shared
        page."""
        model = self.model
        c = model.config
        ps = self.config.page_size
        pps = self.config.pages_per_slot
        n_pages = self.pages.n_pages
        bucket = suffix.shape[1]
        s0 = pps * ps
        dev = self.device
        small = init_kv_caches(model, 1, s0 + bucket)
        row = torch.as_tensor(page_row.astype(np.int64), device=dev)
        valid_page = (row < n_pages)[:, None, None]
        clamped = row.clamp(0, n_pages - 1)
        h, d = c.kv_heads, c.head_dim

        def place(pool, sm, scales=None):
            g = pool[clamped]                               # [pps, ps, h*d]
            if scales is not None:
                g = g.float() * scales[clamped].repeat_interleave(
                    d, dim=-1)[:, None, :]
            # sentinel rows read as exact zeros (a clamped gather could
            # import a co-tenant's NaN into masked positions)
            g = torch.where(valid_page, g, torch.zeros((), dtype=g.dtype,
                                                       device=dev))
            sm[:, :, :s0] = g.reshape(s0, h, d).transpose(0, 1)[None] \
                .to(sm.dtype)

        for cache, (sk, sv) in zip(self._caches, small):
            if self._quantized:
                (bk, bks), (bv, bvs) = cache
                place(bk, sk, bks)
                place(bv, sv, bvs)
            else:
                place(cache[0], sk)
                place(cache[1], sv)
        logits, small = _cached_forward(
            model, small, torch.as_tensor(suffix, device=dev), start,
            last_index=suffix_len - 1)
        # the suffix rows' destinations: pad rows and a skipped first row
        # go to the spare page
        idx = np.arange(bucket)
        pos = start + idx
        dest_page = page_row[np.clip(pos // ps, 0, pps - 1)].astype(np.int64)
        valid = (idx < suffix_len) & ~(skip_first & (idx == 0))
        dest_page = np.where(valid & (dest_page < n_pages), dest_page,
                             n_pages)
        dest = torch.as_tensor(dest_page, device=dev)
        off = torch.as_tensor(pos % ps, dtype=torch.long, device=dev)
        for cache, (fk, fv) in zip(self._caches, small):

            def rows(f):
                return f[0, :, start:start + bucket].transpose(0, 1) \
                    .reshape(bucket, h * d)

            if self._quantized:
                (bk, bks), (bv, bvs) = cache
                paged_quant_scatter(bk, bks, rows(fk), dest, off)
                paged_quant_scatter(bv, bvs, rows(fv), dest, off)
            else:
                for pool, f in zip(cache, (fk, fv)):
                    spare_page_view(pool).index_put_(
                        (dest, off), rows(f).to(pool.dtype))
        return self._first_token(logits)

    def _reset_fresh_scales(self, pages) -> None:
        """Zero the scale sidecars of freshly allocated ``pages`` (int8
        pools only): a stale scale from the previous tenant would poison
        the rescale-on-append floor. Shared pages keep theirs."""
        if not self._quantized or len(pages) == 0:
            return
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        for (_, ks), (_, vs) in self._caches:
            ks.index_fill_(0, idx, 0.0)
            vs.index_fill_(0, idx, 0.0)

    def _prefill_into(self, request: Request, slot: int, submit_ts: float,
                      finished: List[RequestResult]) -> None:
        rec = _Active(request, slot, submit_ts)
        rec.prefill_start = clock.now()
        # re-match the prefix NOW (the predicate's match may have been
        # reshaped by a later head's intern eviction), commit the
        # worst-case reservation minus the shared pages, then map only the
        # prompt's pages (decode extends on demand)
        chain, shared_pages, skip_first = self._plan_prefix(request)
        shared_used = len(shared_pages)
        need = self.pages.pages_for(request.total_len) - shared_used
        mapped = self.pages.map_slot(slot, request.prompt_len,
                                     shared=shared_pages or None)
        if mapped is None:
            self.slots.release(slot)
            if self.config.prefix_cache:
                # an intern eviction between the predicate and this map
                # changed what is reclaimable: retry from the FRONT of the
                # queue on a later tick
                self.scheduler.requeue_front(request, submit_ts)
                return
            raise RuntimeError(
                f"page pool exhausted at prefill despite admission "
                f"reservation (slot {slot}, free={self.pages.free_count})")
        rec.reserved_pages = need
        self._reserved_pages += need
        row = self._page_table_h[slot]
        row[:] = self.pages.n_pages
        row[:len(mapped)] = mapped
        self._reset_fresh_scales(mapped[shared_used:])
        try:
            if shared_used:
                # prefix-cache hit: prefill ONLY the suffix, from the first
                # token the shared pages do not cover (or, fully covered,
                # the prompt's last token, for its logits only)
                ps = self.config.page_size
                start = (request.prompt_len - 1 if skip_first
                         else shared_used * ps)
                suffix_len = request.prompt_len - start
                bucket = bucket_for(suffix_len, self.config.max_len)
                suffix = np.zeros((1, bucket), np.int64)
                suffix[0, :suffix_len] = request.prompt[start:]
                first, finite = self._suffix_prefill(
                    row, suffix, start, suffix_len, skip_first)
            else:
                bucket = bucket_for(request.prompt_len, self.config.max_len)
                padded = np.zeros((1, bucket), np.int64)
                padded[0, :request.prompt_len] = request.prompt
                first, finite = self._paged_prefill(row, padded,
                                                    request.prompt_len)
        except Exception:
            # keep the pool invariants as the failure propagates
            self.slots.release(slot)
            self.pages.release_slot(slot)
            self._reserved_pages -= rec.reserved_pages
            self._page_table_h[slot, :] = self.pages.n_pages
            raise
        if self.config.prefix_cache:
            if shared_used:
                self.metrics.inc("prefix_hits")
                self.metrics.inc("prefix_pages_shared", shared_used)
            else:
                self.metrics.inc("prefix_misses")
            # publish the prompt's full pages (shared run + fresh privates)
            # so later prompts hit; never a prefill with non-finite logits
            if chain and finite:
                self.pages.intern_prefix(
                    chain, [int(p) for p in row[:len(chain)]])
        rec.prefill_end = clock.now()
        rec.tokens.append(first)
        rec.last_token = first
        # token #1 lands with the prefill result — TTFT is submit -> here
        rec.first_token_ts = rec.last_token_ts = rec.prefill_end
        rec.position = request.prompt_len
        self._active[slot] = rec
        self.admission_log.append(request.request_id)
        self.metrics.inc("prefills")
        self.metrics.inc("tokens_generated")
        self._sync_slot(rec)
        done = self._finish_reason(rec, first)
        if done is not None:
            finished.append(self._retire(rec, done, clock.now()))

    def _build_windows(self) -> None:
        """Fill the per-slot verify windows for the next speculative step:
        row 0 is the token the sequential engine would feed, rows
        ``1..wl-1`` the n-gram draft over the slot's own history, rows past
        ``wl`` repeat the last real feed (causally invisible padding that
        cannot inflate an int8 page scale). ``wl`` is clipped so a nearly
        finished request cannot overrun its page reservation."""
        k = self._spec
        for slot in sorted(self._active):
            rec = self._active[slot]
            wl = max(1, min(k, rec.request.max_new_tokens - len(rec.tokens)))
            draft = propose_draft(list(rec.request.prompt) + rec.tokens,
                                  wl - 1)
            window = [rec.last_token] + draft
            window += [window[-1]] * (k - wl)
            self._window_h[slot] = window
            self._wlen_h[slot] = wl

    def _decode_tick(self, finished: List[RequestResult]) -> None:
        if self._spec and self._active:
            self._build_windows()
        self._extend_pages(finished)
        if not self._active:
            return
        # bytes of KV stream one decode step reads (mapped pages of every
        # active slot, dtype- and scale-aware)
        self.metrics.set_gauge(
            "kv_bytes_per_step",
            sum(len(self.pages.slot_pages(s)) for s in self._active)
            * self._page_read_bytes)
        t0 = clock.now()
        dev = self.device
        positions = torch.as_tensor(self._positions_h, device=dev)
        table = torch.as_tensor(self._page_table_h, device=dev)
        if self._spec:
            logits, self._caches = _cached_forward(
                self.model, self._caches,
                torch.as_tensor(self._window_h, device=dev), positions,
                paged_state=table)                           # [k, n, V]
            logits = logits.transpose(0, 1)                  # [n, k, V]
        else:
            logits, self._caches = decode_step(
                self.model, self._caches,
                torch.as_tensor(self._tokens_h, device=dev), positions,
                paged_state=table)                           # [n, V]
        # one host read per tick: the greedy token, or -1 for a row whose
        # logits are not finite
        nxt = torch.where(torch.isfinite(logits).all(dim=-1),
                          torch.argmax(logits, dim=-1),
                          torch.full(logits.shape[:-1], -1,
                                     dtype=torch.long, device=dev))
        nxt = nxt.cpu().numpy()
        now = clock.now()
        self.metrics.observe("decode_step_s", now - t0)
        self.metrics.inc("decode_steps")
        self.metrics.observe("decode_batch_size", len(self._active))
        if self._spec:
            self._accept_windows(nxt, now, finished)
            return
        for slot in sorted(self._active):
            rec = self._active[slot]
            token = int(nxt[slot])
            if not 0 <= token < self._vocab:
                cause = ("nonfinite_logits" if token == -1
                         else "out_of_vocab_token")
                finished.append(self._quarantine(rec, cause, now))
                continue
            rec.position += 1            # last_token's K/V are now cached
            rec.tokens.append(token)
            rec.last_token = token
            rec.last_token_ts = now
            self.metrics.inc("tokens_generated")
            self._sync_slot(rec)
            done = self._finish_reason(rec, token)
            if done is not None:
                finished.append(self._retire(rec, done, now))

    def _accept_windows(self, nxt: np.ndarray, now: float,
                        finished: List[RequestResult]) -> None:
        """Consume each slot's verified window ``nxt [n, k]``: walk the
        rows left to right, keeping the model's token at row ``j`` only
        while the token FED at row ``j`` was the model's previous output —
        the first disagreement invalidates everything to its right (those
        rows' K/V are garbage the next window overwrites). Row 0 is always
        the sequential feed, so every step emits >= 1 token."""
        for slot in sorted(self._active):
            rec = self._active[slot]
            wl = int(self._wlen_h[slot])
            consumed = 0
            quarantined = done = None
            for j in range(wl):
                token = int(nxt[slot, j])
                if not 0 <= token < self._vocab:
                    quarantined = ("nonfinite_logits" if token == -1
                                   else "out_of_vocab_token")
                    break
                rec.position += 1     # row j's fed K/V are now cached
                rec.tokens.append(token)
                rec.last_token = token
                rec.last_token_ts = now
                consumed += 1
                self.metrics.inc("tokens_generated")
                done = self._finish_reason(rec, token)
                if done is not None:
                    break
                if j + 1 >= wl or int(self._window_h[slot, j + 1]) != token:
                    break             # the draft diverged from the model
            # rows 1..wl-1 were drafted; those the walk consumed beyond the
            # mandatory row-0 token are the accepted ones
            proposed = wl - 1
            accepted = max(0, consumed - 1)
            if proposed:
                self.metrics.inc("draft_tokens_proposed", proposed)
                self.metrics.inc("draft_tokens_accepted", accepted)
                self.metrics.observe("spec_accept_rate",
                                     accepted / proposed)
                rec.spec_proposed += proposed
                rec.spec_accepted += accepted
            if quarantined is not None:
                # poisoned at any window row: quarantine the slot even if
                # clean tokens landed first — its KV is suspect
                finished.append(self._quarantine(rec, quarantined, now))
                continue
            self._sync_slot(rec)
            if done is not None:
                finished.append(self._retire(rec, done, now))

    def _extend_pages(self, finished: List[RequestResult]) -> None:
        """Map the pages backing the rows the decode step appends — row
        ``position``, or the whole verify window ``position .. position +
        wl - 1`` — of every active slot. Admission reserved each request's
        worst case (``wl`` is clipped to ``max_new_tokens``), so this cannot
        fail; the defensive branch retires the slot as an error rather
        than corrupt a foreign page."""
        now = clock.now()
        for slot in sorted(self._active):
            rec = self._active[slot]
            grow = int(self._wlen_h[slot]) if self._spec else 1
            fresh = self.pages.extend_slot(slot, rec.position + grow)
            if fresh is None:
                self.metrics.inc("requests_shed_pages")
                self.metrics.event("request_shed",
                                   request_id=rec.request.request_id,
                                   reason="pages_exhausted", mid_flight=True)
                finished.append(self._retire(rec, FINISH_ERROR, now))
                continue
            if fresh:
                row = self._page_table_h[slot]
                pages = self.pages.slot_pages(slot)
                row[len(pages) - len(fresh):len(pages)] = fresh
                self._reset_fresh_scales(fresh)

    # -- retirement & bookkeeping ----------------------------------------

    def _quarantine(self, rec: _Active, cause: str,
                    now: float) -> RequestResult:
        """Retire ONE poisoned slot and keep the batch serving: the pages
        its release frees are zeroed (and their scales) so no NaN outlives
        the occupant. Shared prefix pages still referenced elsewhere hold
        only pre-intern prefill data, interned on finite logits, and are
        zeroed when their last reference drops."""
        self.metrics.inc("slots_quarantined")
        self.metrics.event("slot_quarantined", slot=rec.slot,
                           request_id=rec.request.request_id, cause=cause)
        return self._retire(rec, FINISH_ERROR, now, scrub=True)

    def _finish_reason(self, rec: _Active, token: int) -> Optional[str]:
        if rec.request.eos_token is not None and \
                token == rec.request.eos_token:
            return FINISH_EOS
        if len(rec.tokens) >= rec.request.max_new_tokens:
            return FINISH_LENGTH
        return None

    def _sync_slot(self, rec: _Active) -> None:
        self._tokens_h[rec.slot] = rec.last_token
        self._positions_h[rec.slot] = rec.position

    def _clear_slot(self, slot: int) -> None:
        self._tokens_h[slot] = 0
        self._positions_h[slot] = 0
        if self._spec:
            self._window_h[slot] = 0
            self._wlen_h[slot] = 1

    def _retire(self, rec: _Active, reason: str, now: float, *,
                scrub: bool = False) -> RequestResult:
        del self._active[rec.slot]
        self.slots.release(rec.slot)
        # release returns only the pages whose LAST reference this drop
        # removed — shared prefix pages outlive the slot
        freed = self.pages.release_slot(rec.slot)
        self._reserved_pages -= rec.reserved_pages
        self._page_table_h[rec.slot, :] = self.pages.n_pages
        if scrub and freed:
            idx = torch.as_tensor(freed, dtype=torch.long, device=self.device)
            for k, v in self._caches:
                for pool in ((*k, *v) if self._quantized else (k, v)):
                    pool.index_fill_(0, idx, 0)
            # PagePool.check() can now assert these free pages hold zero
            # scales until their next allocation
            self.pages.note_scrubbed(freed)
        self._clear_slot(rec.slot)
        if rec.spec_proposed:
            # lifetime speculation totals of the request
            self.metrics.event("spec_verify",
                               request_id=rec.request.request_id,
                               proposed=rec.spec_proposed,
                               accepted=rec.spec_accepted)
        return self._finish(
            rec.request, rec.tokens, reason, submit_ts=rec.submit_ts,
            now=now, prefill_start=rec.prefill_start,
            prefill_end=rec.prefill_end, first_token_ts=rec.first_token_ts,
            last_token_ts=rec.last_token_ts)

    def _finish(self, request: Request, tokens: List[int], reason: str, *,
                submit_ts: float, now: float, prefill_start: float = 0.0,
                prefill_end: float = 0.0, first_token_ts: float = 0.0,
                last_token_ts: float = 0.0,
                detail: Optional[str] = None) -> RequestResult:
        if prefill_start:
            queue_s = prefill_start - submit_ts
            prefill_s = prefill_end - prefill_start
            decode_s = now - prefill_end
        else:                       # never left the queue
            queue_s, prefill_s, decode_s = now - submit_ts, 0.0, 0.0
        ttft_s = (first_token_ts - submit_ts
                  if tokens and first_token_ts else None)
        tpot_s = ((last_token_ts - first_token_ts) / (len(tokens) - 1)
                  if len(tokens) >= 2 and first_token_ts else None)
        result = RequestResult(
            request_id=request.request_id, prompt_len=request.prompt_len,
            tokens=list(tokens), finish_reason=reason, queue_s=queue_s,
            prefill_s=prefill_s, decode_s=decode_s,
            total_s=now - submit_ts, ttft_s=ttft_s, tpot_s=tpot_s,
            replica_id=self.replica_id, trace_id=request.trace_id,
            priority=request.sampling.priority)
        self.completed[request.request_id] = result
        self.metrics.inc(f"requests_{reason}")
        for name, value in (("request_queue_s", result.queue_s),
                            ("request_prefill_s", result.prefill_s),
                            ("request_decode_s", result.decode_s),
                            ("request_total_s", result.total_s)):
            self.metrics.observe(name, value)
        if result.ttft_s is not None:
            self.metrics.observe("request_ttft_s", result.ttft_s)
        if result.tpot_s is not None:
            self.metrics.observe("request_tpot_s", result.tpot_s)
        self.metrics.emit_record(result.record(wall=clock.wall()))
        if reason in (FINISH_REJECTED, FINISH_TIMEOUT, FINISH_CANCELLED,
                      FINISH_ERROR):
            extra = {"reason": detail} if detail else {}
            self.metrics.event(f"request_{reason}",
                               request_id=request.request_id,
                               new_tokens=result.new_tokens, **extra)
        return result
