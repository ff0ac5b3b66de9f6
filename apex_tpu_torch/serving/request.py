"""Request/result types for the serving engine.

Adapted from ``apex_tpu/serving/request.py`` (stdlib only), kept in the
port so it never imports the JAX package.

A :class:`Request` is one user generation call: a prompt, a budget of new
tokens, per-request sampling parameters, and optional deadline/EOS. The
engine turns each terminal request into a :class:`RequestResult` carrying
the generated tokens, the finish reason, and the latency breakdown
(queue/prefill/decode/total) that feeds the ``kind="request"`` JSONL
records and the monitor report's serving section.

Validation lives here, at construction time — a malformed request must
fail loudly at ``submit()`` instead of deep inside the engine.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from apex_tpu_torch.observability.trace import new_trace_id

__all__ = ["SamplingParams", "Request", "RequestResult",
           "FINISH_EOS", "FINISH_LENGTH", "FINISH_CANCELLED",
           "FINISH_TIMEOUT", "FINISH_REJECTED", "FINISH_ERROR",
           "FINISH_REASONS",
           "PRIORITY_INTERACTIVE", "PRIORITY_STANDARD", "PRIORITY_BATCH",
           "PRIORITIES", "PRIORITY_RANK"]

#: priority classes a request can declare (SamplingParams.priority) —
#: dispatch order under contention. Rank 0 is the most latency-sensitive;
#: the scheduler dispatches strictly by rank (FCFS inside a class).
PRIORITY_INTERACTIVE = "interactive"    # user-facing, never degraded first
PRIORITY_STANDARD = "standard"          # the default class
PRIORITY_BATCH = "batch"                # best-effort, first to brownout
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_STANDARD, PRIORITY_BATCH)
#: class -> dispatch rank (lower dispatches first)
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

#: terminal outcomes a request can reach (RequestResult.finish_reason)
FINISH_EOS = "eos"              # emitted its eos_token
FINISH_LENGTH = "length"        # hit max_new_tokens
FINISH_CANCELLED = "cancelled"  # cancel() — queued or mid-decode
FINISH_TIMEOUT = "timeout"      # deadline_s elapsed — queued or mid-decode
FINISH_REJECTED = "rejected"    # queue full / expired deadline / shed at submit
FINISH_ERROR = "error"          # engine fault: quarantined slot or retry
#                                 budget exhausted — never silently lost
FINISH_REASONS = (FINISH_EOS, FINISH_LENGTH, FINISH_CANCELLED,
                  FINISH_TIMEOUT, FINISH_REJECTED, FINISH_ERROR)

_REQUEST_IDS = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: ``temperature == 0`` is greedy; with
    ``temperature > 0`` the engine samples from the (optionally
    ``top_k``-truncated) softmax, keyed by ``seed`` folded with the
    absolute position of each generated token — one request's stream is
    deterministic in (seed, prompt) and independent of what else shares
    the batch, and equal to the JAX engine's. ``adapter_id`` selects a
    LoRA adapter loaded in the engine's
    :class:`~apex_tpu_torch.lora.AdapterStore` (``None``: the base
    model).

    ``priority`` is the request's scheduling class (one of
    :data:`PRIORITIES`). It orders dispatch under contention; it never
    changes WHAT tokens a request produces, only WHEN."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    adapter_id: Optional[str] = None
    priority: str = PRIORITY_STANDARD

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.adapter_id is not None and (
                not isinstance(self.adapter_id, str) or not self.adapter_id):
            raise ValueError(
                f"adapter_id must be None or a non-empty string, "
                f"got {self.adapter_id!r}")
        if self.priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, "
                f"got {self.priority!r}")


@dataclass
class Request:
    """One generation request.

    ``deadline_s`` is a wall-clock budget relative to submission: a
    request still queued (or still decoding) when it elapses finishes as
    ``timeout`` — queued requests never silently rot behind a long
    backlog. ``request_id`` is assigned process-wide; pass an explicit id
    to correlate with an external system.

    ``arrival_ts`` is an optional ``time.monotonic()`` stamp of when the
    request entered the wider system (an API gateway, a prior engine
    incarnation). When set, ``deadline_s`` counts from it instead of
    from ``submit()`` — so a request that spent its whole budget in
    transit fast-fails at admission, and the supervisor's restart
    continuations keep honoring the ORIGINAL deadline.

    ``trace_id`` names the request: minted fresh per request and stamped
    onto its terminal ``kind="request"`` record.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token: Optional[int] = None
    deadline_s: Optional[float] = None
    request_id: int = field(default_factory=lambda: next(_REQUEST_IDS))
    arrival_ts: Optional[float] = None
    trace_id: str = field(default_factory=new_trace_id)

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("prompt must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclass
class RequestResult:
    """Terminal outcome of one request.

    ``tokens`` are the GENERATED ids only (no prompt echo), including the
    ``eos_token`` when that is what ended the request — exactly the
    ``out[:, prompt_len:]`` slice of a per-request ``generate()`` call
    truncated at its first EOS. Latencies are host wall-clock seconds:
    ``queue_s`` (submit -> prefill start), ``prefill_s``, ``decode_s``
    (first decode participation -> finish) and ``total_s`` (submit ->
    finish); a request that never left the queue has zero prefill/decode.

    ``ttft_s`` (time to first token: submit -> the first generated token
    materializing on the host) and ``tpot_s`` (time per output token: the
    mean inter-token interval over the decode stream) are stamped from
    the engine's own token timestamps. ``None`` when unmeasurable:
    ``ttft_s`` for a request that produced no token, ``tpot_s`` below two
    tokens.

    ``replica_id``, ``adapter_id``, ``trace_id`` and ``priority`` echo the
    engine's replica id and the request's LoRA adapter (``None`` for base
    traffic), trace id and scheduling class;
    ``prefill_chunks`` counts the chunk programs a token-budgeted (chunked)
    prefill ran for the request (``None`` on the monolithic path). Each is
    omitted from the JSONL record when ``None``, as in the JAX package's
    records.
    """

    request_id: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str
    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    total_s: float = 0.0
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    replica_id: Optional[int] = None
    adapter_id: Optional[str] = None
    trace_id: Optional[str] = None
    prefill_chunks: Optional[int] = None
    priority: Optional[str] = None

    @property
    def new_tokens(self) -> int:
        return len(self.tokens)

    @property
    def tokens_per_s(self) -> Optional[float]:
        """Generation rate over the in-engine (non-queue) lifetime."""
        busy = self.prefill_s + self.decode_s
        if not self.tokens or busy <= 0.0:
            return None
        return len(self.tokens) / busy

    def record(self, wall: float) -> dict:
        """The ``kind="request"`` JSONL record the engine emits into its
        :class:`~apex_tpu_torch.observability.MetricsRegistry` sinks."""
        rec = {"kind": "request", "request_id": self.request_id,
               "finish_reason": self.finish_reason,
               "prompt_len": self.prompt_len,
               "new_tokens": self.new_tokens,
               "queue_s": self.queue_s, "prefill_s": self.prefill_s,
               "decode_s": self.decode_s, "total_s": self.total_s,
               "wall": wall}
        # optional fields are OMITTED (not null) when unmeasured, so the
        # records stay readable by pre-TTFT report readers and the
        # summary's per-field guards
        if self.trace_id is not None:
            rec["trace_id"] = self.trace_id
        if self.replica_id is not None:
            rec["replica_id"] = self.replica_id
        if self.adapter_id is not None:
            rec["adapter_id"] = self.adapter_id
        if self.ttft_s is not None:
            rec["ttft_s"] = self.ttft_s
        if self.tpot_s is not None:
            rec["tpot_s"] = self.tpot_s
        if self.prefill_chunks is not None:
            rec["prefill_chunks"] = self.prefill_chunks
        if self.priority is not None:
            rec["priority"] = self.priority
        tps = self.tokens_per_s
        if tps is not None:
            rec["tokens_per_s"] = tps
        return rec
