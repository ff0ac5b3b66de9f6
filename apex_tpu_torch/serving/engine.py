"""Continuous-batching inference engine.

Counterpart of ``apex_tpu/serving/engine.py``: greedy and sampled requests
on the paged or the flat KV layout, with the prefix cache, int8 KV pools,
self-speculative verify windows, chunked prefill and priority preemption.
The loop is the JAX engine's — requests are admitted and retired per
decode step over one batched step across all slots:

- **Slots and pages** (``kv_layout="paged"``, the default):
  :class:`~apex_tpu_torch.serving.slots.SlotPool` hands out decode rows;
  :class:`~apex_tpu_torch.serving.slots.PagePool` maps each slot onto
  pages of the shared per-layer pools through a host page table whose
  unmapped entries hold the sentinel ``n_pages``. Admission reserves a
  request's worst case (prompt + max_new_tokens), so decode-time page
  growth can never exhaust the pool. ``kv_layout="flat"`` keeps dense
  ``[max_slots, max_len]`` rows per layer instead (the bisection layout:
  no pages, no prefix cache, decode through two GEMMs a layer).
- **Bucketed prefill**: a prompt is right-padded to a power-of-two
  bucket, run through the 4D-cache prefill path (causal flash), and its
  K/V rows are copied into the slot's pages (int8 pools: each whole page
  quantized at its own scale) or its flat row; the LM head reads the
  single row ``prompt_len - 1``.
- **Prefix cache** (``prefix_cache=True``, the default, paged only): a
  prompt's page-aligned prefix is interned in the pool's content-addressed
  index once its prefill logits are finite; a later prompt sharing it maps
  those pages refcounted and prefills only its suffix at the cache offset
  (the mid-cache 4D path: offset-causal mask, unfused softmax).
- **Chunked prefill** (``prefill_token_budget=n``): a prompt prefills as a
  sequence of bucketed chunks carried across ticks, at most ``n`` prompt
  tokens a tick, interleaved with the batched decode step. Paged chunks
  run the suffix-prefill program at a page-aligned offset; flat chunks
  gather the slot's row into a small 4D cache. The last chunk's sample is
  keyed to the absolute position, so it is the monolithic first token.
- **Sampling**: greedy where ``temperature == 0``; otherwise the logits
  over the temperature, truncated below the row's k-th largest, drawn with
  ``categorical(fold_in(PRNGKey(seed), position))`` through the port's
  threefry (:mod:`apex_tpu_torch.utils.prng`), so a sampled stream is the
  JAX engine's token for token and depends on nothing else in the batch.
- **One decode step per tick** over every slot: page table, positions and
  tokens are uploaded once per tick, each layer appends its row and attends
  (the paged decode kernel, or the flat GEMMs), and the next tokens and the
  per-slot finite flags come back in ONE host read. With ``speculation=k``
  the step is a ``k``-row verify window a slot, each row sampled with the
  key of the sequential step it stands for. A slot whose logits are not
  finite is quarantined (its freed pages or its row zeroed) while
  co-tenants keep serving.
- **Preemption**: with a ``resume_consumer`` (the
  :class:`~apex_tpu_torch.serving.supervisor.EngineSupervisor`), a
  higher-class queued head blocked on slots or pages parks the
  lowest-class running slot; its host cursor (request, tokens) waits in
  :meth:`take_parked` for a continuation that resumes token-exact.
- **Multi-LoRA** (``adapters=``, an
  :class:`~apex_tpu_torch.lora.AdapterStore`): a request's ``adapter_id``
  selects a bank row; each tick gathers every slot's factors once (null
  row for base traffic and idle slots) and each layer adds the per-slot
  low-rank delta to its QKV and MLP up-projections, on every prefill,
  chunk, decode and verify-window path. The bank is read on every step,
  so a hot ``load``/``unload`` lands on the next one. The prefix cache
  salts each chain with the adapter, so tenants never share pages.

Eager PyTorch has no retrace, so the JAX engine's retrace watchdog has no
counterpart; caches are updated in place (no donation).
``prefill_compiles``/``decode_compiles`` count the shapes first run (their
first call pays the one-time costs: kernel build, library handles), which
the supervisor's hung-tick check exempts as the JAX one exempts compiles.

Telemetry is the JAX engine's: each terminal request writes its
``kind="request"`` record, the ``request_*`` histograms
(``request_tokens_per_s`` among them) and its span timeline
(``queued``, ``prefill`` — one span a chunk under chunked prefill — and
``decode``), with the ``preempt``, ``quarantine`` and ``spec_verify``
marks (:mod:`apex_tpu_torch.observability.trace`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.lora.adapter import UnknownAdapterError
from apex_tpu_torch.models.generation import (
    _cached_forward,
    cast_decode_params,
    decode_step,
    flatten_decode_caches,
    init_kv_caches,
    init_paged_kv_caches,
)
from apex_tpu_torch.observability.registry import MetricsRegistry
from apex_tpu_torch.observability.trace import (
    SPAN_PREEMPT,
    SPAN_QUARANTINE,
    SPAN_SPEC_VERIFY,
    emit_request_spans,
    emit_span,
)
from apex_tpu_torch.ops._support import cdiv, resolve_device
from apex_tpu_torch.ops.decode_attention import (
    paged_quant_fill,
    paged_quant_scatter,
    spare_page_view,
)
from apex_tpu_torch.serving import clock
from apex_tpu_torch.serving.prefix import adapter_salt, prefix_hash_chain, \
    prefix_salt
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
from apex_tpu_torch.utils.logging import get_logger, log_event
from apex_tpu_torch.utils.prng import categorical, fold_in, prng_key

__all__ = ["EngineConfig", "InferenceEngine"]

_LOG = get_logger(__name__)

#: declared up front so final counter snapshots carry every key
_COUNTERS = ("requests_submitted", "requests_eos", "requests_length",
             "requests_cancelled", "requests_timeout", "requests_rejected",
             "requests_error", "prefills", "decode_steps",
             "tokens_generated", "slots_quarantined", "requests_shed_pages",
             # multi-LoRA: submits whose adapter_id the AdapterStore does
             # not know, fast-failed at submit as request_shed
             # reason="unknown_adapter"
             "requests_shed_adapter",
             # prefix cache: hits + misses == prefills when it is on;
             # pages_shared counts prefill pages NOT recomputed
             "prefix_hits", "prefix_misses", "prefix_pages_shared",
             "prefix_evictions",
             # speculative decoding: proposed counts drafted positions
             # beyond the forced first feed, accepted the ones the model
             # agreed with
             "draft_tokens_proposed", "draft_tokens_accepted",
             # chunked prefill: chunk programs run under
             # prefill_token_budget
             "prefill_chunks",
             # priority preemption: running slots parked for a higher
             # class (parks are not terminal)
             "requests_preempted")


@dataclass
class EngineConfig:
    """Engine sizing knobs — the JAX ``EngineConfig``'s names, defaults and
    checks. ``retrace_budget`` and ``donate_caches`` have no counterpart
    in eager PyTorch and are absent.

    ``kv_layout="paged"`` backs slots with a shared page pool;
    ``n_pages=None`` sizes it to back every slot at ``max_len``, smaller
    overcommits (a request whose worst case can never fit is shed as
    ``pages_exhausted``). ``kv_layout="flat"`` keeps dense rows. Paged
    only: ``prefix_cache`` interns page-aligned prompt prefixes
    (``prefix_lru_capacity`` entries, evicted LRU-first under page
    pressure); ``kv_dtype="int8"`` stores the pools int8 with
    per-(page, kv-head) scales; ``speculation=k`` (``k >= 2``) makes each
    decode step a ``k``-row verify window. ``prefill_token_budget=n``
    bounds the prefill tokens a tick runs (chunked prefill; under the
    paged layout internal chunk boundaries are page-aligned, so ``n`` must
    be at least ``page_size``). Every knob keeps greedy and sampled streams
    token-exact against the defaults."""

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
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' needs kv_layout='paged' — the "
                             "scales are per-page sidecars")
        if self.speculation < 0 or self.speculation == 1:
            raise ValueError(f"speculation is 0 (off) or a verify window "
                             f">= 2, got {self.speculation}")
        if self.speculation and self.kv_layout != "paged":
            raise ValueError("speculation needs kv_layout='paged' — the "
                             "verify window rides the fused paged kernel")
        if self.prefill_token_budget is not None:
            if self.prefill_token_budget < 1:
                raise ValueError(
                    f"prefill_token_budget must be >= 1 (or None to "
                    f"disable chunking), got {self.prefill_token_budget}")
            if (self.kv_layout == "paged"
                    and self.prefill_token_budget < self.page_size):
                raise ValueError(
                    f"prefill_token_budget ({self.prefill_token_budget}) "
                    f"must be >= page_size ({self.page_size}) under the "
                    f"paged layout — internal chunk boundaries are "
                    f"page-aligned, so a smaller budget could never make "
                    f"progress on a multi-page prompt")

    @property
    def pages_per_slot(self) -> int:
        """Page-table width: pages covering one slot at ``max_len``."""
        return -(-self.max_len // self.page_size)


class _Active:
    """Host-side state of a request holding a slot."""

    __slots__ = ("request", "slot", "tokens", "last_token", "position",
                 "submit_ts", "prefill_start", "prefill_end",
                 "first_token_ts", "last_token_ts", "cancelled",
                 "reserved_pages", "adapter_ix", "spec_proposed",
                 "spec_accepted",
                 "prefill_pos", "prefill_chunks", "chunk_marks",
                 "page_row", "chain", "shared_used", "skip_first",
                 "finite_ok")

    def __init__(self, request: Request, slot: int, submit_ts: float):
        self.request = request
        self.slot = slot
        self.tokens: List[int] = []
        self.last_token = 0
        self.position = 0        # cache rows written for this slot
        self.reserved_pages = 0  # worst-case pages minus shared-prefix hit
        self.adapter_ix = 0      # bank row (the null row without adapter)
        self.spec_proposed = 0   # draft positions offered over the lifetime
        self.spec_accepted = 0   # draft positions the model agreed with
        self.submit_ts = submit_ts
        self.prefill_start = 0.0
        self.prefill_end = 0.0
        self.first_token_ts = 0.0
        self.last_token_ts = 0.0
        self.cancelled = False
        # chunked-prefill progress, carried across ticks as host data
        self.prefill_pos = 0     # prompt tokens whose K/V are written
        self.prefill_chunks = 0  # chunk programs run so far
        self.chunk_marks: List[float] = []  # interior chunk-end stamps
        self.page_row = None     # the slot's REAL page row while chunking
        self.chain = ()          # prefix hash chain (interned at the end)
        self.shared_used = 0     # prefix-hit pages mapped at admission
        self.skip_first = False  # fully page-aligned hit (COW seam)
        self.finite_ok = True    # AND of every chunk's isfinite flag


def _sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                   topks: torch.Tensor, seeds: torch.Tensor,
                   steps: torch.Tensor) -> torch.Tensor:
    """Per-row sampling over ``logits [n, V]`` (the JAX engine's
    ``_sample_tokens``): greedy where ``temps == 0``, else the logits over
    the row's temperature, masked below its k-th largest (``topks == V``
    disables truncation), drawn with ``fold_in(PRNGKey(seed), step)`` — so
    a request's stream depends only on its own (seed, positions), never on
    batch co-tenants. ``temps``/``topks``/``seeds``/``steps`` are ``[n]``
    tensors on ``logits``' device; returns int64 tokens ``[n]``."""
    greedy = torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    safe_t = torch.where(temps > 0.0, temps, 1.0).to(logits.dtype)
    scaled = logits / safe_t[:, None]
    # kth-largest per row via one ascending sort (top_k varies per row);
    # mask below it — generate()'s truncation support
    order = torch.sort(scaled, dim=-1).values
    kth = torch.gather(order, -1, (v - topks.long()).clamp(0, v - 1)[:, None])
    masked = torch.where(scaled < kth, float("-inf"), scaled)
    keys = fold_in(prng_key(seeds.long()), steps.long())
    sampled = categorical(keys, masked)
    return torch.where(temps > 0.0, sampled, greedy)


class InferenceEngine:
    """Continuous-batching serving engine; see the module docstring.

    Drive it with :meth:`serve` (submit a request list, tick to
    completion, collect results) or with :meth:`submit` + :meth:`tick`.
    The model must already live on ``device`` (``"cuda"`` unless the
    caller asks for the CPU); under a non-fp32 ``compute_dtype`` the engine
    serves its own copy of the model, cast once at construction, and the
    caller's model keeps its fp32 parameters. ``faults`` takes a
    :class:`~apex_tpu_torch.testing_faults.ServingFaultInjector`, whose
    hooks run before each prefill (and chunk), before each decode step and
    on its host outputs. ``adapters`` takes an
    :class:`~apex_tpu_torch.lora.AdapterStore` on the engine's device.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None, *,
                 metrics: Optional[MetricsRegistry] = None, faults=None,
                 replica_id: Optional[int] = None, adapters=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if adapters is not None and adapters.device != self.device:
            raise ValueError(f"the adapter bank lives on {adapters.device} "
                             f"but the engine runs on {self.device}")
        #: optional AdapterStore (apex_tpu_torch.lora): a request's
        #: adapter_id selects a bank row; the bank is re-read every step,
        #: so a host-side load/unload between ticks applies on the next
        self.adapters = adapters
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device} but the engine "
                             f"runs on {self.device}; build the model with "
                             f"device={str(self.device)!r}")
        self.model = model
        self.config = config or EngineConfig()
        self.replica_id = replica_id
        self._faults = faults
        self._closed = False
        c = model.config
        if (c.position_embedding_type == "learned"
                and self.config.max_len > c.max_position_embeddings):
            raise ValueError(
                f"max_len ({self.config.max_len}) exceeds the model's "
                f"max_position_embeddings ({c.max_position_embeddings})")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.declare_counters(*_COUNTERS)
        if self.adapters is not None:
            # per-adapter submit counters, declared up front so final
            # snapshots carry every key; the monitor reconciles them
            # against the adapter_request events key for key
            self.metrics.declare_counters(
                *(f"adapter{ix}_requests"
                  for ix in range(self.adapters.max_adapters)))
        self.scheduler = FCFSScheduler(self.config.scheduler)
        self.slots = SlotPool(self.config.max_slots)
        self.buckets = prefill_buckets(self.config.max_len)
        self.completed: Dict[int, RequestResult] = {}
        #: request ids in admission (prefill) order — the FCFS audit trail
        self.admission_log: List[int] = []
        self._active: Dict[int, _Active] = {}      # slot -> state
        #: slots mid-chunked-prefill, in admission order — kept out of
        #: _active so the batched decode step never sees them
        self._prefilling: Dict[int, _Active] = {}
        #: preempted (parked) requests as (request, generated_tokens,
        #: submit_ts), slot and pages released; drained by take_parked()
        self._parked: List = []
        #: set True by a caller that drains take_parked() every tick (the
        #: EngineSupervisor). Without a consumer the engine never preempts
        #: on its own; park_class() is exempt (its caller owns the drain)
        self.resume_consumer = False
        self._chunk_tokens_tick = 0   # prefill tokens run this tick
        #: shapes first run, per program (see prefill_compiles)
        self._shapes: Dict[str, set] = {"prefill": set(), "decode": set(),
                                         "chunk": set()}
        self._vocab = c.vocab_size
        if c.compute_dtype != torch.float32:
            model = self.model = cast_decode_params(model, c.compute_dtype)

        self._quantized = self.config.kv_dtype == "int8"
        if self.config.kv_layout == "paged":
            pps = self.config.pages_per_slot
            n_pages = (self.config.n_pages if self.config.n_pages is not None
                       else self.config.max_slots * pps)
            self.pages: Optional[PagePool] = PagePool(
                n_pages, self.config.page_size, pps,
                lru_capacity=(self.config.prefix_lru_capacity
                              if self.config.prefix_cache else 0))
            #: salt of the prompt-prefix hash chains: the model's
            #: fingerprint, with each request's adapter_id folded in at hash
            #: time (adapter deltas write adapter-specific K/V)
            self._prefix_salt = prefix_salt(c)
            self._evictions_seen = 0
            self._caches = init_paged_kv_caches(model, n_pages,
                                                self.config.page_size,
                                                quantized=self._quantized)
            # bytes one decode step streams per mapped page (K + V, all
            # layers, plus the f32 scale sidecars when quantized)
            itemsize = 1 if self._quantized else torch.empty(
                (), dtype=c.compute_dtype).element_size()
            self._page_read_bytes = 2 * c.num_layers * (
                self.config.page_size * c.kv_heads * c.head_dim * itemsize
                + (c.kv_heads * 4 if self._quantized else 0))
            self._page_table_h = np.full((self.config.max_slots, pps),
                                         n_pages, np.int32)
            self._reserved_pages = 0
        else:
            self.pages = None
            self._caches = init_kv_caches(model, self.config.max_slots,
                                          self.config.max_len, flat=True)
        n = self.config.max_slots
        self._tokens_h = np.zeros(n, np.int64)
        self._positions_h = np.zeros(n, np.int32)
        self._temps_h = np.zeros(n, np.float32)
        self._topks_h = np.full(n, self._vocab, np.int32)
        self._seeds_h = np.zeros(n, np.int32)
        #: per-slot adapter bank row; idle and base slots hold the null row
        self._null_adapter = (0 if self.adapters is None
                              else self.adapters.null_index)
        self._adapter_ix_h = np.full(n, self._null_adapter, np.int64)
        #: speculation: per-slot verify window (row 0 the token the
        #: sequential step would feed, rows 1.. the n-gram draft, padded by
        #: repeating the last real feed) and its valid length
        self._spec = self.config.speculation
        if self._spec:
            self._window_h = np.zeros((n, self._spec), np.int64)
            self._wlen_h = np.ones(n, np.int32)

    @property
    def _bank(self):
        """The current adapter bank (None without an AdapterStore), read
        on every step so a hot load or unload lands on the next."""
        return None if self.adapters is None else self.adapters.bank

    def _adapter_index(self, adapter_id, *, strict: bool) -> int:
        """An ``adapter_id``'s bank row. ``strict`` raises
        :class:`~apex_tpu_torch.lora.UnknownAdapterError` (submit
        validation); non-strict falls back to the null row — the prefill
        and decode path of a request whose adapter was unloaded after
        admission, which degrades to base-model output instead of failing
        the batch."""
        if self.adapters is None:
            if adapter_id is not None and strict:
                raise UnknownAdapterError(
                    f"adapter {adapter_id!r}: engine has no AdapterStore")
            return self._null_adapter
        try:
            return self.adapters.index_of(adapter_id)
        except UnknownAdapterError:
            if strict:
                raise
            return self._null_adapter

    def _lora(self, adapter_ix) -> Optional[dict]:
        """Per-slot LoRA factors from the adapter bank (the JAX engine's
        ``_select_adapters``): leaves ``[L, max_adapters + 1, ...]`` at
        bank rows ``adapter_ix`` (host ints, one a slot) -> ``[L, b,
        ...]``, the layout the transformer's layer loop slices, one gather
        a factor. None without an AdapterStore: no delta runs at all."""
        if self.adapters is None:
            return None
        ix = torch.as_tensor(np.asarray(adapter_ix, np.int64),
                             device=self.device)
        return {t: {k: v.index_select(1, ix) for k, v in f.items()}
                for t, f in self._bank.items()}

    # -- introspection ----------------------------------------------------

    @property
    def prefill_compiles(self) -> int:
        """Distinct full-prefill buckets run — bounded by ``len(buckets)``.
        Eager PyTorch compiles nothing, but a shape's first call pays the
        one-time costs (kernel build, library handles) that the JAX
        engine's compiles stand for."""
        return len(self._shapes["prefill"])

    @property
    def decode_compiles(self) -> int:
        """1 once the decode step has run (its one program shape)."""
        return len(self._shapes["decode"])

    @property
    def chunk_compiles(self) -> int:
        """Distinct chunk buckets run under chunked prefill (paged chunks
        run the suffix program)."""
        return len(self._shapes["chunk"])

    @property
    def active_count(self) -> int:
        return self.slots.active_count

    @property
    def queued_count(self) -> int:
        return self.scheduler.depth

    @property
    def queued_tokens(self) -> int:
        """Prompt tokens waiting in the queue — the token-aware load signal
        of the supervisor's shed estimate."""
        return self.scheduler.queued_tokens

    @property
    def parked_count(self) -> int:
        """Preempted requests awaiting resume."""
        return len(self._parked)

    def take_parked(self) -> List:
        """Drain the parked (preempted) requests as ``(request,
        generated_tokens, submit_ts)`` tuples — the supervisor turns each
        into a continuation (prompt + generated prefix, remaining budget,
        same ids and deadline clock) and resubmits it."""
        parked, self._parked = self._parked, []
        return parked

    def queued_tokens_by_class(self) -> Dict[str, int]:
        """Queued prompt tokens per priority class (scheduler
        passthrough)."""
        return self.scheduler.queued_tokens_by_class()

    def queued_depth_by_class(self) -> Dict[str, int]:
        """Queue depth per priority class (scheduler passthrough)."""
        return self.scheduler.depth_by_class()

    def set_admission_floor(self, priority: Optional[str]) -> None:
        """Scheduler passthrough: pause dispatch of classes below
        ``priority``."""
        self.scheduler.set_admission_floor(priority)

    def inflight(self) -> List:
        """Active requests as ``(request, generated_tokens, submit_ts)`` in
        slot order — what the supervisor re-prefills after a restart —
        then mid-chunked-prefill requests with NO tokens (their chunk
        progress dies with the engine), then parked requests with theirs."""
        recs = [(rec.request, list(rec.tokens), rec.submit_ts)
                for _, rec in sorted(self._active.items())]
        recs += [(rec.request, [], rec.submit_ts)
                 for rec in self._prefilling.values()]
        recs += [(request, list(tokens), submit_ts)
                 for request, tokens, submit_ts in self._parked]
        return recs

    # -- request lifecycle ------------------------------------------------

    def submit(self, request: Request, *, resubmission: bool = False) -> int:
        """Enqueue; returns the request id. Raises
        :class:`~apex_tpu_torch.serving.scheduler.QueueFullError` /
        :class:`~apex_tpu_torch.serving.scheduler.DeadlineExpiredError`
        after recording a ``rejected`` result. ``resubmission=True`` is the
        supervisor's continuation path: the request was counted at its
        original submit, so ``requests_submitted`` is not counted again.
        An ``adapter_id`` the AdapterStore does not hold (or any, without
        one) raises :class:`~apex_tpu_torch.lora.UnknownAdapterError` after
        counting ``requests_shed_adapter`` and recording a ``rejected``
        result; a continuation whose adapter was unloaded since serves on
        the null row instead."""
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
        now = clock.now()
        if not resubmission:
            self.metrics.inc("requests_submitted")
        aid = request.sampling.adapter_id
        try:
            # restart continuations were validated at their original
            # submit; if the adapter vanished since, they degrade to the
            # null row (base output) instead of failing the restart
            ix = self._adapter_index(aid, strict=not resubmission)
        except UnknownAdapterError:
            # fast-fail before the queue: an unknown or unloaded adapter
            # can never give the tenant's output, so it sheds with its own
            # counter, a request_shed event and a terminal rejected record
            self.metrics.inc("requests_shed_adapter")
            log_event(_LOG, "request_shed", request_id=request.request_id,
                      reason="unknown_adapter", adapter_id=aid)
            self.metrics.event("request_shed",
                               request_id=request.request_id,
                               reason="unknown_adapter", adapter_id=aid)
            self._finish(request, [], FINISH_REJECTED, submit_ts=now,
                         now=now, detail="unknown_adapter")
            raise
        if aid is not None and not resubmission:
            # the per-adapter arrival ledger (the monitor reconciles the
            # counter against these events key for key)
            self.metrics.inc(f"adapter{ix}_requests")
            self.metrics.event("adapter_request",
                               request_id=request.request_id,
                               adapter_id=aid, adapter_ix=ix)
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
        """Cancel a queued, parked or in-flight request; returns True when
        found. A queued or parked request terminates now (a parked one
        keeps its tokens); an in-flight one is evicted at the start of the
        next tick, keeping its partial tokens."""
        queued = self.scheduler.cancel(request_id)
        if queued is not None:
            request, submit_ts = queued
            self._finish(request, [], FINISH_CANCELLED, submit_ts=submit_ts,
                         now=clock.now())
            return True
        for i, (request, tokens, submit_ts) in enumerate(self._parked):
            if request.request_id == request_id:
                del self._parked[i]
                self._finish(request, tokens, FINISH_CANCELLED,
                             submit_ts=submit_ts, now=clock.now())
                return True
        for rec in (*self._active.values(), *self._prefilling.values()):
            if rec.request.request_id == request_id:
                rec.cancelled = True
                return True
        return False

    def tick(self) -> List[RequestResult]:
        """One scheduler iteration: expire deadlines, evict cancellations,
        maybe preempt, admit + prefill (FCFS, decode-starvation capped, or
        token-budgeted chunks), then one batched decode step over all
        active slots. Returns the requests that reached a terminal state
        during this tick."""
        if self._closed:
            raise RuntimeError("engine is closed")
        finished: List[RequestResult] = []
        now = clock.now()
        self._expire(now, finished)
        self._evict_cancelled(finished)
        self._maybe_preempt(now)
        self._chunk_tokens_tick = 0
        if self.config.prefill_token_budget is None:
            self._admit(finished)
        else:
            self._chunked_admit(finished)
        if self._chunk_tokens_tick:
            # one observation per tick with prefill activity: its max
            # never exceeds prefill_token_budget
            self.metrics.observe("prefill_tokens_per_tick",
                                 self._chunk_tokens_tick)
        self._decode_tick(finished)
        self.metrics.observe("slot_occupancy", self.slots.occupancy)
        if self.pages is not None:
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
        while pending or self.scheduler.depth or self._active \
                or self._prefilling:
            while pending and \
                    self.scheduler.depth < self.config.scheduler.max_queue:
                self.submit(pending.pop(0))
            before = (len(pending), self.scheduler.depth, len(self._active),
                      len(self._prefilling))
            self.tick()
            ticks += 1
            if on_tick is not None:
                on_tick(self, ticks)
            if max_ticks is not None and ticks >= max_ticks:
                break
            if (before == (len(pending), self.scheduler.depth,
                           len(self._active), len(self._prefilling))
                    and not self._active and not self._prefilling
                    and self.scheduler.depth):
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
        self._prefilling.clear()
        self._parked.clear()
        self.slots.reset()
        if self.pages is not None:
            self.pages.reset()
            self._reserved_pages = 0
            self._page_table_h[:] = self.pages.n_pages
        self.metrics.flush()

    def release_device_memory(self) -> None:
        """Drop the KV caches and the engine's own cast copy of the model,
        so a replacement engine can allocate them again without two sets on
        the card (the supervisor's restart calls this on the dead engine
        after reading its host state). The engine is unusable after."""
        self._closed = True
        self._caches = None
        self.model = None

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
        if self._parked:
            # a park never stops the deadline clock; a parked request
            # expires with its partial tokens
            kept = []
            for request, tokens, submit_ts in self._parked:
                d = request.deadline_s
                if d is not None and now - submit_ts > d:
                    finished.append(self._finish(
                        request, tokens, FINISH_TIMEOUT,
                        submit_ts=submit_ts, now=now))
                else:
                    kept.append((request, tokens, submit_ts))
            self._parked = kept
        for slot in sorted(self._active):
            rec = self._active[slot]
            d = rec.request.deadline_s
            if d is not None and now - rec.submit_ts > d:
                finished.append(self._retire(rec, FINISH_TIMEOUT, now))
        for slot in list(self._prefilling):
            rec = self._prefilling[slot]
            d = rec.request.deadline_s
            if d is not None and now - rec.submit_ts > d:
                finished.append(self._abandon_prefill(
                    rec, FINISH_TIMEOUT, now))

    def _evict_cancelled(self, finished: List[RequestResult]) -> None:
        for slot in sorted(self._active):
            rec = self._active[slot]
            if rec.cancelled:
                finished.append(self._retire(
                    rec, FINISH_CANCELLED, clock.now()))
        for slot in list(self._prefilling):
            rec = self._prefilling[slot]
            if rec.cancelled:
                finished.append(self._abandon_prefill(
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
        # the request's adapter folded into the salt: adapter deltas make
        # K/V adapter-specific, so same-prompt tenants under different
        # adapters never share a chain (base traffic keeps the model salt)
        salt = adapter_salt(self._prefix_salt, request.sampling.adapter_id)
        chain = prefix_hash_chain(request.prompt, ps, salt)
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
        """Admission predicate (None under the flat layout): a request
        enters only when its worst-case page need (minus the shared-prefix
        pages a cache hit maps refcounted) fits beside every admitted
        request's outstanding reservation. Pages held only by the intern
        index count as capacity, since allocation evicts entries under
        pressure, less this request's own shared pages (mapping pins them).
        One that can never fit is shed, one that must wait defers (FCFS
        head-blocking). ``planned`` and ``planned_shared`` accumulate across
        the pops of one call — chunked admission builds a fresh predicate
        per single-head pop, because it maps pages between pops."""
        if self.pages is None:
            return None
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

    def _maybe_preempt(self, now: float) -> None:
        """Park ONE lowest-class running slot when a strictly-higher-class
        queued head is blocked on slots or pages. Runs before admission so
        the freed slot and pages can admit the head in the same tick; one
        park a tick converges without thrashing (the continuation re-queues
        in its own class lane, behind the traffic that displaced it). The
        head's TRUE class decides: an aged batch head never preempts."""
        if not self.resume_consumer or not self._active:
            return
        head = self.scheduler.head(now=now)
        if head is None:
            return
        head_rank = PRIORITY_RANK[head[0].sampling.priority]
        blocked = self.slots.free_count == 0
        if not blocked and self.pages is not None:
            blocked = self._page_predicate()(head[0]) == "defer"
        if not blocked:
            return
        victim, victim_key = None, None
        for slot in sorted(self._active):
            rec = self._active[slot]
            rank = PRIORITY_RANK[rec.request.sampling.priority]
            if rank <= head_rank:
                continue
            # lowest class first; among peers the one with the least
            # generated work (cheapest re-prefill), ids breaking ties
            key = (rank, -len(rec.tokens), rec.request.request_id)
            if victim_key is None or key > victim_key:
                victim, victim_key = rec, key
        if victim is not None:
            self._park(victim, now, cause="priority")

    def _park(self, rec: _Active, now: float, *, cause: str) -> None:
        """Preempt one ACTIVE slot: release the slot and its pages (shared
        prefix pages outlive it, refcounted — the ``_retire`` release
        sequence) with NO terminal record: a park is not an outcome. The
        host cursor (request, generated tokens, submit_ts) moves to the
        parked list for the supervisor's continuation path."""
        slot = rec.slot
        del self._active[slot]
        self.slots.release(slot)
        if self.pages is not None:
            self.pages.release_slot(slot)
            self._reserved_pages -= rec.reserved_pages
            self._page_table_h[slot, :] = self.pages.n_pages
        self._clear_slot(slot)
        self._parked.append((rec.request, list(rec.tokens), rec.submit_ts))
        self.metrics.inc("requests_preempted")
        self.metrics.event("request_preempted",
                           request_id=rec.request.request_id, cause=cause,
                           priority=rec.request.sampling.priority,
                           tokens_parked=len(rec.tokens))
        emit_span(self.metrics, SPAN_PREEMPT,
                  trace_id=rec.request.trace_id,
                  request_id=rec.request.request_id,
                  start_s=now, end_s=now, wall=clock.wall(),
                  replica_id=self.replica_id, detail=cause,
                  tokens_parked=len(rec.tokens),
                  priority=rec.request.sampling.priority)

    def park_class(self, priority: str, *, cause: str = "brownout") -> int:
        """Park EVERY active slot of ``priority``; returns the number
        parked. The caller owns the take_parked() drain. Mid-chunked-prefill
        slots are not parked — their progress lives in half-filled pages,
        not a host cursor."""
        now = clock.now()
        victims = [self._active[s] for s in sorted(self._active)
                   if self._active[s].request.sampling.priority == priority]
        for rec in victims:
            self._park(rec, now, cause=cause)
        return len(victims)

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

    def _chunked_admit(self, finished: List[RequestResult]) -> None:
        """Token-budgeted mixed tick: continue in-flight chunked prefills
        in admission order, then admit new heads while budget remains, each
        running its first chunk(s) in the same tick.
        ``max_prefills_per_tick`` still caps NEW admissions while requests
        are decoding; the token budget bounds the tick's prefill work."""
        budget = self.config.prefill_token_budget
        spent = 0
        for slot in list(self._prefilling):
            if spent >= budget:
                break
            ran = self._run_chunk(self._prefilling[slot], budget - spent,
                                  finished)
            if ran == 0:
                break           # remaining budget below one page
            spent += ran
        admitted = 0
        limit = self.slots.free_count
        if self._active:
            limit = min(limit, self.config.scheduler.max_prefills_per_tick)
        while spent < budget and admitted < limit and self.scheduler.depth:
            shed: List = []
            now = clock.now()
            batch = self.scheduler.pop_admissible(
                1, decoding=False, predicate=self._page_predicate(),
                shed=shed, now=now)
            for request, submit_ts in shed:
                finished.append(self._shed_pages(request, submit_ts, now))
            if not batch:
                break           # head deferred (pages) or queue drained
            request, submit_ts = batch[0]
            slot = self.slots.allocate()
            assert slot is not None
            rec = self._begin_chunked_prefill(request, slot, submit_ts)
            if rec is None:
                break           # intern-eviction race: requeued at front
            admitted += 1
            ran = self._run_chunk(rec, budget - spent, finished)
            if ran == 0:
                break           # admitted; first chunk waits for budget
            spent += ran

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

    def _sampling(self, request: Request):
        """``(temperature, top_k, seed)`` of one request as the host arrays
        hold them: ``top_k=None`` is the vocabulary size."""
        sp = request.sampling
        return (sp.temperature,
                sp.top_k if sp.top_k is not None else self._vocab, sp.seed)

    def _pick(self, logits: torch.Tensor, temps: np.ndarray,
              topks: np.ndarray, seeds: np.ndarray,
              steps: np.ndarray) -> torch.Tensor:
        """Tokens of ``logits [n, V]`` under the host sampling arrays
        (``[n]`` each): the argmax, with the sampled rows (temperature > 0)
        drawn by :func:`_sample_tokens` — over those rows only, which gives
        the same tokens (every op is row-independent), so a greedy batch
        launches no sampling work."""
        tokens = torch.argmax(logits, dim=-1)
        rows = np.flatnonzero(temps > 0.0)
        if rows.size:
            dev = logits.device

            def up(a):
                return torch.as_tensor(a[rows], device=dev)

            idx = torch.as_tensor(rows, device=dev)
            tokens[idx] = _sample_tokens(logits[idx], up(temps), up(topks),
                                         up(seeds), up(steps))
        return tokens

    def _first_token(self, logits: torch.Tensor, request: Request,
                     sample: bool = True):
        """``(first token, finite)`` of one prefill's logits ``[1, 1, V]``,
        in one host read; the token is sampled at step ``prompt_len`` (the
        absolute position it will occupy). ``sample=False`` (an interior
        prefill chunk) reads only the finite flag and returns token 0."""
        row = logits[0]
        finite = torch.isfinite(row).all().long()
        if not sample:
            return 0, bool(finite.item())
        t, k, sd = self._sampling(request)
        token = self._pick(row, np.array([t], np.float32),
                           np.array([k], np.int32), np.array([sd], np.int32),
                           np.array([request.prompt_len], np.int64))
        both = torch.stack([token[0], finite]).tolist()
        return int(both[0]), bool(both[1])

    def _note_shape(self, program: str, bucket: int) -> None:
        self._shapes[program].add(bucket)

    def _paged_prefill(self, lora, page_row: np.ndarray, prompt: np.ndarray,
                       prompt_len: int) -> torch.Tensor:
        """Prefill one bucket-padded prompt ``[1, bucket]`` and land its
        K/V rows in the slot's pages (``page_row``); returns the logits of
        its last token ``[1, 1, V]``. Chunks whose page is the sentinel (bucket
        padding past the mapped pages) are dropped; garbage rows inside the
        last mapped page stay causally masked by the slot's position. An
        int8 pool takes each chunk as a whole page at its own scale
        (:func:`paged_quant_fill`). ``lora`` (here and in the other
        prefill and chunk programs): the request's gathered adapter
        factors (``b = 1``), or None."""
        model = self.model
        bucket = prompt.shape[1]
        self._note_shape("prefill", bucket)
        small = init_kv_caches(model, 1, bucket)
        logits, small = _cached_forward(
            model, small, torch.as_tensor(prompt, device=self.device), 0,
            last_index=prompt_len - 1, lora=lora)
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
            return logits
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
        return logits

    def _flat_prefill(self, lora, slot: int, prompt: np.ndarray,
                      prompt_len: int) -> torch.Tensor:
        """Prefill one bucket-padded prompt into the slot's flat row (rows
        ``[0, bucket)``; pad rows land past the live length and are never
        read); returns the logits of its last token ``[1, 1, V]``."""
        model = self.model
        bucket = prompt.shape[1]
        self._note_shape("prefill", bucket)
        small = init_kv_caches(model, 1, bucket)
        logits, small = _cached_forward(
            model, small, torch.as_tensor(prompt, device=self.device), 0,
            last_index=prompt_len - 1, lora=lora)
        for (bk, bv), (fk, fv) in zip(self._caches,
                                      flatten_decode_caches(small)):
            bk[slot, :bucket] = fk[0].to(bk.dtype)
            bv[slot, :bucket] = fv[0].to(bv.dtype)
        return logits

    def _suffix_prefill(self, lora, page_row: np.ndarray,
                        suffix: np.ndarray, start: int, suffix_len: int,
                        skip_first: bool) -> torch.Tensor:
        """Prefill ONLY the suffix of a prefix-cache hit, or one paged
        prefill chunk; returns the logits of its last token ``[1, 1,
        V]``.

        The slot's page row already maps the pages holding tokens ``[0,
        start)``; their rows (int8 ones dequantized with their pages'
        scales) are gathered into a 4D cache of ``pages_per_slot *
        page_size + bucket`` rows, the suffix runs at ``cache_index =
        start`` (a tensor, so even a chunk at 0 takes the mid-cache path:
        offset-causal mask, rope and positions at the absolute offset, the
        unfused softmax), and the suffix K/V rows land in the slot's
        PRIVATE pages row by row (int8 through the rescale-on-append
        scatter). Shared pages are never written: with ``skip_first`` (a
        fully page-aligned hit, whose one-token suffix recomputes the
        prompt's last token for its logits only) that row's write is
        masked, since it already lives in the last shared page."""
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
            model, small, torch.as_tensor(suffix, device=dev),
            torch.tensor(start), last_index=suffix_len - 1, lora=lora)
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
        return logits

    def _flat_chunk(self, lora, slot: int, chunk: np.ndarray, start: int,
                    chunk_len: int) -> torch.Tensor:
        """Prefill ONE bucketed chunk of a prompt into a flat slot row;
        returns the logits of its last token ``[1, 1, V]``. The slot's dense row
        (tokens ``[0, start)`` live, later rows garbage the offset-causal
        mask never attends) is gathered into a small 4D cache of ``max_len
        + bucket`` rows, the chunk runs at ``cache_index = start`` (rope and
        sampling keyed to the ABSOLUTE position, so the final chunk's sample
        is the monolithic prefill's first token), and the chunk's K/V rows
        go back into the row (pad rows dropped)."""
        model = self.model
        c = model.config
        max_len = self.config.max_len
        bucket = chunk.shape[1]
        dev = self.device
        h, d = c.kv_heads, c.head_dim
        small = init_kv_caches(model, 1, max_len + bucket)
        for (bk, bv), (sk, sv) in zip(self._caches, small):
            for big, sm in ((bk, sk), (bv, sv)):
                sm[0, :, :max_len] = big[slot].reshape(max_len, h, d) \
                    .transpose(0, 1).to(sm.dtype)
        logits, small = _cached_forward(
            model, small, torch.as_tensor(chunk, device=dev),
            torch.tensor(start), last_index=chunk_len - 1, lora=lora)
        for (bk, bv), (fk, fv) in zip(self._caches, small):
            for big, f in ((bk, fk), (bv, fv)):
                big[slot, start:start + chunk_len] = \
                    f[0, :, start:start + chunk_len].transpose(0, 1) \
                    .reshape(chunk_len, h * d).to(big.dtype)
        return logits

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

    def _map_pages(self, request: Request, slot: int, submit_ts: float):
        """Paged admission: re-match the prefix NOW (the predicate's match
        may have been reshaped by a later head's intern eviction), map the
        prompt's pages (shared prefix refcounted, decode extends on demand)
        and commit the worst-case reservation minus the shared pages.
        Returns ``(mapped, chain, shared_used, skip_first, need)``, or None
        when an intern eviction between the predicate and this map left no
        room: the request is then back at the FRONT of the queue."""
        chain, shared_pages, skip_first = self._plan_prefix(request)
        shared_used = len(shared_pages)
        need = self.pages.pages_for(request.total_len) - shared_used
        mapped = self.pages.map_slot(slot, request.prompt_len,
                                     shared=shared_pages or None)
        if mapped is None:
            self.slots.release(slot)
            if self.config.prefix_cache:
                self.scheduler.requeue_front(request, submit_ts)
                return None
            raise RuntimeError(
                f"page pool exhausted at prefill despite admission "
                f"reservation (slot {slot}, free={self.pages.free_count})")
        self._reserved_pages += need
        # freshly mapped PRIVATE pages may carry a previous tenant's scales
        self._reset_fresh_scales(mapped[shared_used:])
        return mapped, chain, shared_used, skip_first, need

    def _prefill_into(self, request: Request, slot: int, submit_ts: float,
                      finished: List[RequestResult]) -> None:
        rec = _Active(request, slot, submit_ts)
        rec.prefill_start = clock.now()
        # resolve the adapter row now (non-strict: an id unloaded while
        # queued degrades to the null row, base output, rather than
        # failing admission; submit() already validated it existed)
        rec.adapter_ix = self._adapter_index(request.sampling.adapter_id,
                                             strict=False)
        chain, shared_used, skip_first = (), 0, False
        if self.pages is not None:
            planned = self._map_pages(request, slot, submit_ts)
            if planned is None:
                return
            mapped, chain, shared_used, skip_first, rec.reserved_pages = \
                planned
            row = self._page_table_h[slot]
            row[:] = self.pages.n_pages
            row[:len(mapped)] = mapped
        try:
            if self._faults is not None:
                self._faults.before_prefill()
            if self.pages is not None and shared_used:
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
                logits = self._suffix_prefill(
                    self._lora([rec.adapter_ix]), row, suffix, start,
                    suffix_len, skip_first)
            else:
                bucket = bucket_for(request.prompt_len, self.config.max_len)
                padded = np.zeros((1, bucket), np.int64)
                padded[0, :request.prompt_len] = request.prompt
                lora = self._lora([rec.adapter_ix])
                if self.pages is not None:
                    logits = self._paged_prefill(lora, row, padded,
                                                 request.prompt_len)
                else:
                    logits = self._flat_prefill(lora, slot, padded,
                                                request.prompt_len)
            first, finite = self._first_token(logits, request)
        except Exception:
            # keep the pool invariants as the failure propagates
            self.slots.release(slot)
            if self.pages is not None:
                self.pages.release_slot(slot)
                self._reserved_pages -= rec.reserved_pages
                self._page_table_h[slot, :] = self.pages.n_pages
            raise
        if self.pages is not None and self.config.prefix_cache:
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
        self.admission_log.append(request.request_id)
        self._activate(rec, first, finished)

    def _activate(self, rec: _Active, first: int,
                  finished: List[RequestResult]) -> None:
        """A prefill landed: promote ``rec`` to the active set with its
        first token (TTFT is submit -> here)."""
        rec.prefill_end = clock.now()
        rec.tokens.append(first)
        rec.last_token = first
        rec.first_token_ts = rec.last_token_ts = rec.prefill_end
        rec.position = rec.request.prompt_len
        self._active[rec.slot] = rec
        self.metrics.inc("prefills")
        self.metrics.inc("tokens_generated")
        self._sync_slot(rec)
        done = self._finish_reason(rec, first)
        if done is not None:
            finished.append(self._retire(rec, done, clock.now()))

    def _begin_chunked_prefill(self, request: Request, slot: int,
                               submit_ts: float) -> Optional[_Active]:
        """Admission half of a chunked prefill: allocate the slot, commit
        the page reservation and map the prompt's pages (shared prefix
        refcounted, as the monolithic path) — but run NO compute yet. The
        slot's real page row lives on the rec while chunks land; the global
        table row stays all-sentinel, so the batched decode step treats the
        slot as idle (gathers mask, appends drop). Returns None when an
        intern-eviction race requeued the request."""
        rec = _Active(request, slot, submit_ts)
        rec.prefill_start = clock.now()
        rec.adapter_ix = self._adapter_index(request.sampling.adapter_id,
                                             strict=False)
        if self.pages is not None:
            planned = self._map_pages(request, slot, submit_ts)
            if planned is None:
                return None
            mapped, rec.chain, rec.shared_used, rec.skip_first, \
                rec.reserved_pages = planned
            row = np.full(self.config.pages_per_slot, self.pages.n_pages,
                          np.int32)
            row[:len(mapped)] = mapped
            rec.page_row = row
            # shared prefix rows are already resident: chunking starts at
            # the first uncovered token (page-aligned), or — fully covered —
            # at the last-token recompute (the COW seam)
            rec.prefill_pos = (request.prompt_len - 1 if rec.skip_first
                               else rec.shared_used * self.config.page_size)
        else:
            # park the position at the last row: the flat decode step
            # appends at _positions_h[slot] unconditionally, and row
            # max_len-1 is never live (a request's final token is never fed
            # back), so co-tenant decode garbage cannot clobber chunk rows
            self._positions_h[slot] = self.config.max_len - 1
        self._prefilling[slot] = rec
        self.admission_log.append(request.request_id)
        return rec

    def _run_chunk(self, rec: _Active, budget_left: int,
                   finished: List[RequestResult]) -> int:
        """Run ONE maximal prefill chunk for ``rec`` within ``budget_left``
        tokens; returns the tokens consumed (0 = no progress possible this
        tick). Paged chunks reuse the suffix program (the slot's pages ARE
        the carried state); flat chunks run :meth:`_flat_chunk`. The final
        chunk's sample — keyed at step ``prompt_len`` from the prompt's
        last-token logits — is the request's first token, what the
        monolithic prefill emits; interior chunks sample nothing."""
        request = rec.request
        remaining = request.prompt_len - rec.prefill_pos
        chunk_len = min(remaining, budget_left)
        if chunk_len < remaining and self.pages is not None:
            # internal chunk boundaries stay page-aligned: every fresh page
            # is written whole onto a zeroed scale, so int8 page contents
            # (and interned prefix pages) are what the monolithic fill
            # produces
            ps = self.config.page_size
            chunk_len = ((rec.prefill_pos + chunk_len) // ps) * ps \
                - rec.prefill_pos
        if chunk_len <= 0:
            return 0
        start = rec.prefill_pos
        last = chunk_len == remaining
        bucket = bucket_for(chunk_len, self.config.max_len)
        self._note_shape("chunk", bucket)
        chunk = np.zeros((1, bucket), np.int64)
        chunk[0, :chunk_len] = request.prompt[start:start + chunk_len]
        try:
            if self._faults is not None:
                self._faults.before_prefill()
            lora = self._lora([rec.adapter_ix])
            if self.pages is not None:
                logits = self._suffix_prefill(
                    lora, rec.page_row, chunk, start, chunk_len,
                    rec.skip_first and rec.prefill_chunks == 0)
            else:
                logits = self._flat_chunk(lora, rec.slot, chunk, start,
                                          chunk_len)
            first, finite = self._first_token(logits, request, sample=last)
            rec.finite_ok = rec.finite_ok and finite
        except Exception:
            # the monolithic prefill's failure contract: release everything
            # as the exception propagates; the supervisor's restart
            # re-prefills the request from its prompt
            del self._prefilling[rec.slot]
            self.slots.release(rec.slot)
            if self.pages is not None:
                self.pages.release_slot(rec.slot)
                self._reserved_pages -= rec.reserved_pages
                self._page_table_h[rec.slot, :] = self.pages.n_pages
            self._clear_slot(rec.slot)
            raise
        rec.prefill_pos += chunk_len
        rec.prefill_chunks += 1
        self.metrics.inc("prefill_chunks")
        self._chunk_tokens_tick += chunk_len
        if last:
            self._complete_chunked_prefill(rec, first, finished)
        else:
            rec.chunk_marks.append(clock.now())
        return chunk_len

    def _complete_chunked_prefill(self, rec: _Active, first: int,
                                  finished: List[RequestResult]) -> None:
        """Final chunk landed: publish the page row to the global table
        (the decode step sees, and appends to, the slot from the next step
        on), intern the prefix, and activate the rec with its first
        token."""
        slot = rec.slot
        del self._prefilling[slot]
        if self.pages is not None:
            self._page_table_h[slot] = rec.page_row
            if self.config.prefix_cache:
                # hit/miss accounting lands at COMPLETION, so hits + misses
                # stays == prefills when a mid-prefill request is abandoned
                if rec.shared_used:
                    self.metrics.inc("prefix_hits")
                    self.metrics.inc("prefix_pages_shared", rec.shared_used)
                else:
                    self.metrics.inc("prefix_misses")
                if rec.chain and rec.finite_ok:
                    self.pages.intern_prefix(
                        rec.chain,
                        [int(p) for p in rec.page_row[:len(rec.chain)]])
        self._activate(rec, first, finished)

    def _abandon_prefill(self, rec: _Active, reason: str,
                         now: float) -> RequestResult:
        """Retire a request whose chunked prefill never completed
        (deadline/cancel): release the slot and its pages. Partially
        written rows need no scrub unless a chunk went non-finite — finite
        garbage is causally invisible to any future occupant, like bucket
        padding."""
        del self._prefilling[rec.slot]
        self.slots.release(rec.slot)
        if self.pages is not None:
            freed = self.pages.release_slot(rec.slot)
            self._reserved_pages -= rec.reserved_pages
            self._page_table_h[rec.slot, :] = self.pages.n_pages
            if not rec.finite_ok and freed:
                self._scrub_pages(freed)
        self._clear_slot(rec.slot)
        return self._finish(
            rec.request, [], reason, submit_ts=rec.submit_ts, now=now,
            prefill_start=rec.prefill_start, prefill_end=now,
            prefill_segments=tuple(rec.chunk_marks),
            prefill_chunks=rec.prefill_chunks or None)

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
        if self.pages is not None:
            self._extend_pages(finished)
        if not self._active:
            return
        if self._faults is not None:
            self._faults.before_decode()
        self._note_shape("decode", 0)
        t0 = clock.now()
        dev = self.device
        positions = torch.as_tensor(self._positions_h, device=dev)
        n = self.config.max_slots
        if self.pages is not None:
            # bytes of KV stream one decode step reads (mapped pages of
            # every active slot, dtype- and scale-aware)
            self.metrics.set_gauge(
                "kv_bytes_per_step",
                sum(len(self.pages.slot_pages(s)) for s in self._active)
                * self._page_read_bytes)
            table = torch.as_tensor(self._page_table_h, device=dev)
        # every slot's factors, gathered once this tick (idle slots hold
        # the null row)
        lora = self._lora(self._adapter_ix_h)
        if self._spec:
            k = self._spec
            logits, self._caches = _cached_forward(
                self.model, self._caches,
                torch.as_tensor(self._window_h, device=dev), positions,
                paged_state=table, lora=lora)                # [k, n, V]
            logits = logits.transpose(0, 1).reshape(n * k, -1)
            # row j of a slot's window samples with the key of the
            # sequential step at position + 1 + j
            steps = (self._positions_h[:, None].astype(np.int64) + 1
                     + np.arange(k)[None, :]).reshape(-1)
            nxt = self._pick(logits, np.repeat(self._temps_h, k),
                             np.repeat(self._topks_h, k),
                             np.repeat(self._seeds_h, k), steps)
        else:
            logits, self._caches = decode_step(
                self.model, self._caches,
                torch.as_tensor(self._tokens_h, device=dev), positions,
                paged_state=table if self.pages is not None else None,
                lora=lora)
            nxt = self._pick(logits, self._temps_h, self._topks_h,
                             self._seeds_h,
                             self._positions_h.astype(np.int64) + 1)
        # one host read per tick: the tokens and the per-row finite flags
        finite = torch.isfinite(logits).all(dim=-1).long()
        both = torch.stack([nxt, finite]).cpu().numpy()
        nxt, finite = both[0], both[1].astype(bool)
        if self._spec:
            nxt, finite = nxt.reshape(n, self._spec), \
                finite.reshape(n, self._spec)
        if self._faults is not None:
            nxt, finite = self._faults.corrupt_decode(nxt, finite)
        now = clock.now()
        self.metrics.observe("decode_step_s", now - t0)
        self.metrics.inc("decode_steps")
        self.metrics.observe("decode_batch_size", len(self._active))
        if self._spec:
            self._accept_windows(nxt, finite, now, finished)
            return
        for slot in sorted(self._active):
            rec = self._active[slot]
            token = int(nxt[slot])
            # a row whose logits are not finite, or an out-of-vocab token:
            # quarantine it alone, co-tenant rows keep their clean step
            if not finite[slot] or not 0 <= token < self._vocab:
                cause = ("nonfinite_logits" if not finite[slot]
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

    def _accept_windows(self, nxt: np.ndarray, finite: np.ndarray,
                        now: float, finished: List[RequestResult]) -> None:
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
                if not finite[slot, j] or not 0 <= token < self._vocab:
                    quarantined = ("nonfinite_logits"
                                   if not finite[slot, j]
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

    def _scrub_pages(self, freed) -> None:
        """Zero ``freed`` pages (and their scales) across every layer, and
        tell the pool so ``PagePool.check()`` can assert they stay zeroed
        until their next allocation."""
        idx = torch.as_tensor(freed, dtype=torch.long, device=self.device)
        for k, v in self._caches:
            for pool in ((*k, *v) if self._quantized else (k, v)):
                pool.index_fill_(0, idx, 0)
        self.pages.note_scrubbed(freed)

    def _quarantine(self, rec: _Active, cause: str,
                    now: float) -> RequestResult:
        """Retire ONE poisoned slot and keep the batch serving: its flat row
        is zeroed, or the pages its release frees (and their scales), so no
        NaN outlives the occupant. Shared prefix pages still referenced
        elsewhere hold only pre-intern prefill data, interned on finite
        logits, and are zeroed when their last reference drops."""
        if self.pages is None:
            for k, v in self._caches:
                k[rec.slot] = 0
                v[rec.slot] = 0
        self.metrics.inc("slots_quarantined")
        self.metrics.event("slot_quarantined", slot=rec.slot,
                           request_id=rec.request.request_id, cause=cause)
        # mark span (zero-width): annotates the timeline with the scrub —
        # excluded from the phase-span conservation sum
        emit_span(self.metrics, SPAN_QUARANTINE,
                  trace_id=rec.request.trace_id,
                  request_id=rec.request.request_id,
                  start_s=now, end_s=now, wall=clock.wall(),
                  replica_id=self.replica_id, detail=cause)
        return self._retire(rec, FINISH_ERROR, now, scrub=True)

    def _finish_reason(self, rec: _Active, token: int) -> Optional[str]:
        if rec.request.eos_token is not None and \
                token == rec.request.eos_token:
            return FINISH_EOS
        if len(rec.tokens) >= rec.request.max_new_tokens:
            return FINISH_LENGTH
        return None

    def _sync_slot(self, rec: _Active) -> None:
        i = rec.slot
        self._tokens_h[i] = rec.last_token
        self._positions_h[i] = rec.position
        self._temps_h[i], self._topks_h[i], self._seeds_h[i] = \
            self._sampling(rec.request)
        self._adapter_ix_h[i] = rec.adapter_ix

    def _clear_slot(self, slot: int) -> None:
        self._tokens_h[slot] = 0
        self._positions_h[slot] = 0
        self._temps_h[slot] = 0.0
        self._topks_h[slot] = self._vocab
        self._seeds_h[slot] = 0
        self._adapter_ix_h[slot] = self._null_adapter
        if self._spec:
            self._window_h[slot] = 0
            self._wlen_h[slot] = 1

    def _retire(self, rec: _Active, reason: str, now: float, *,
                scrub: bool = False) -> RequestResult:
        del self._active[rec.slot]
        self.slots.release(rec.slot)
        if self.pages is not None:
            # release returns only the pages whose LAST reference this drop
            # removed — shared prefix pages outlive the slot
            freed = self.pages.release_slot(rec.slot)
            self._reserved_pages -= rec.reserved_pages
            self._page_table_h[rec.slot, :] = self.pages.n_pages
            if scrub and freed:
                self._scrub_pages(freed)
        self._clear_slot(rec.slot)
        if rec.spec_proposed:
            # mark span over the decode stretch the verify windows rode:
            # lifetime speculation totals, for the --trace timeline
            emit_span(self.metrics, SPAN_SPEC_VERIFY,
                      trace_id=rec.request.trace_id,
                      request_id=rec.request.request_id,
                      start_s=rec.prefill_end, end_s=now,
                      wall=clock.wall(), replica_id=self.replica_id,
                      proposed=rec.spec_proposed,
                      accepted=rec.spec_accepted)
        return self._finish(
            rec.request, rec.tokens, reason, submit_ts=rec.submit_ts,
            now=now, prefill_start=rec.prefill_start,
            prefill_end=rec.prefill_end, first_token_ts=rec.first_token_ts,
            last_token_ts=rec.last_token_ts,
            prefill_segments=tuple(rec.chunk_marks),
            prefill_chunks=rec.prefill_chunks or None)

    def _finish(self, request: Request, tokens: List[int], reason: str, *,
                submit_ts: float, now: float, prefill_start: float = 0.0,
                prefill_end: float = 0.0, first_token_ts: float = 0.0,
                last_token_ts: float = 0.0,
                prefill_segments: Sequence[float] = (),
                prefill_chunks: Optional[int] = None,
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
            replica_id=self.replica_id,
            adapter_id=request.sampling.adapter_id,
            trace_id=request.trace_id,
            prefill_chunks=prefill_chunks,
            priority=request.sampling.priority)
        self.completed[request.request_id] = result
        self.metrics.inc(f"requests_{reason}")
        # the span timeline, stamped at the same terminal choke point and
        # from the same timestamps as the queue/prefill/decode
        # decomposition above — so span-sum == total_s by construction,
        # and restarts stay exactly-once (a dead incarnation emits
        # neither a record nor spans)
        emit_request_spans(
            self.metrics, trace_id=request.trace_id,
            request_id=request.request_id, submit_ts=submit_ts, now=now,
            wall=clock.wall(), prefill_start=prefill_start,
            prefill_end=prefill_end, replica_id=self.replica_id,
            prefill_segments=prefill_segments, detail=detail)
        for name, value in (("request_queue_s", result.queue_s),
                            ("request_prefill_s", result.prefill_s),
                            ("request_decode_s", result.decode_s),
                            ("request_total_s", result.total_s)):
            self.metrics.observe(name, value)
        tps = result.tokens_per_s
        if tps is not None:
            self.metrics.observe("request_tokens_per_s", tps)
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
