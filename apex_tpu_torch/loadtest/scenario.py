"""Declarative load-test scenarios: traffic shape, faults, SLOs.

A :class:`Scenario` is the unit the harness runs and the gate scores —
one JSON file describing *everything* a capacity/perf measurement needs
to be repeatable:

- the **model under test** (:class:`ModelSpec` — tiny dims for CI smoke,
  real dims on hardware; parameters are seeded so two runs serve the
  same weights);
- the **engine/supervisor sizing** (:class:`EngineKnobs` plus a
  validated passthrough dict for
  :class:`~apex_tpu_torch.serving.SupervisorConfig`);
- the **traffic**, as ordered :class:`LoadPhase` segments — each an
  open-loop Poisson arrival process at its own rate with its own
  prompt-length / output-length / deadline / sampling mixes, so a
  scenario expresses warmup -> steady -> burst -> overload in one file;
- an optional **fault schedule** (:class:`FaultSchedule`) that drives
  :class:`~apex_tpu_torch.testing_faults.ServingFaultInjector` — "inject an
  engine crash at decode call M, measure recovery" as data, not code;
- the declared **SLOs** (``{metric: threshold}`` over
  :data:`apex_tpu_torch.observability.slo.SLO_METRICS`) and the regression
  ``tolerance`` the baseline gate applies.

This module is stdlib-only (the generator additionally needs just
:mod:`apex_tpu_torch.serving.request`, which is host-side too): loading and
validating a scenario, or re-scoring an existing run log with
``python -m apex_tpu_torch.loadtest --from-log``, runs no model code — torch
enters only through :mod:`~apex_tpu_torch.loadtest.runner` when a scenario
actually executes.

Copied from ``apex_tpu/loadtest/scenario.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from apex_tpu_torch.observability.slo import SLO_METRICS

__all__ = ["ModelSpec", "EngineKnobs", "LoadPhase", "FaultSchedule",
           "FleetSpec", "AutoscaleSpec", "DeploySpec", "SentinelSpec",
           "RecorderSpec", "QuotaSpec", "BrownoutSpec", "Scenario"]

#: priority classes a phase may stamp on its traffic — mirrors
#: ``apex_tpu_torch.serving.PRIORITIES`` (string literals here so scenario
#: loading stays torch-free, same pattern as ``OK_FINISH_REASONS``)
_PRIORITIES = ("interactive", "standard", "batch")

#: keys accepted in a scenario's ``"supervisor"`` section — mirrors the
#: :class:`~apex_tpu_torch.serving.SupervisorConfig` fields so a typo fails at
#: scenario load, not deep in a run
_SUPERVISOR_KEYS = frozenset({
    "max_restarts_per_request", "max_engine_restarts", "breaker_threshold",
    "breaker_cooldown_s", "hung_tick_s", "shed_deadlines",
    "service_time_alpha"})


def _weighted(data: Dict[Any, Any], what: str) -> Dict[int, float]:
    """Normalize a ``{value: weight}`` mix (JSON keys arrive as strings)."""
    if not data:
        raise ValueError(f"{what} mix must be non-empty")
    out: Dict[int, float] = {}
    for key, weight in data.items():
        value = int(key)
        w = float(weight)
        if value < 1:
            raise ValueError(f"{what} values must be >= 1, got {value}")
        if w <= 0:
            raise ValueError(
                f"{what} weight for {value} must be > 0, got {w}")
        out[value] = w
    return out


@dataclass(frozen=True)
class ModelSpec:
    """The (seeded) model the scenario serves. Defaults are the tier-1
    smoke size — the same tiny GPT the serving tests use."""

    num_layers: int = 2
    hidden_size: int = 32
    num_attention_heads: int = 4
    vocab_size: int = 64
    max_position_embeddings: int = 64
    param_seed: int = 0

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ModelSpec":
        return cls(**{k: int(v) for k, v in data.items()})

    def to_dict(self) -> Dict[str, int]:
        return {"num_layers": self.num_layers,
                "hidden_size": self.hidden_size,
                "num_attention_heads": self.num_attention_heads,
                "vocab_size": self.vocab_size,
                "max_position_embeddings": self.max_position_embeddings,
                "param_seed": self.param_seed}


@dataclass(frozen=True)
class EngineKnobs:
    """Engine/scheduler sizing — the subset of
    :class:`~apex_tpu_torch.serving.EngineConfig` /
    :class:`~apex_tpu_torch.serving.SchedulerConfig` a scenario varies.
    ``kv_layout``/``page_size``/``n_pages`` select and size the paged KV
    pool (docs/serving.md#paged-kv); ``n_pages=None`` fully backs every
    slot at ``max_len`` — set it lower to overcommit, which is how the
    ``long_context`` scenario expresses "this mix fits paged but could
    not fit dense rows in the same HBM". ``prefix_cache`` /
    ``prefix_lru_capacity`` drive the paged engine's shared-prefix
    interning (docs/serving.md#prefix-cache) — turning the cache off is
    how the ``shared_prefix`` scenario measures its own speedup.
    ``kv_dtype="int8"`` serves from the quantized pool
    (docs/serving.md#kv-quantization) and ``speculation=k`` turns on
    k-row speculative verify windows
    (docs/serving.md#speculative-decoding) — both paged-only, like the
    engine knobs they mirror. ``lora_adapters``/``lora_rank`` > 0 serve
    the traffic through a LoRA :class:`~apex_tpu_torch.lora.AdapterStore` of
    that many seeded rank-``lora_rank`` adapters (ids ``"0"`` ..
    ``"n-1"``), which phases address via ``adapter_mix``
    (docs/serving.md#multi-lora)."""

    max_slots: int = 4
    max_len: int = 64
    max_queue: int = 64
    max_prefills_per_tick: int = 1
    kv_layout: str = "paged"
    page_size: int = 64
    n_pages: Optional[int] = None
    prefix_cache: bool = True
    prefix_lru_capacity: int = 32
    kv_dtype: str = "bf16"
    speculation: int = 0
    lora_rank: int = 0
    lora_adapters: int = 0
    #: chunked-prefill token budget per tick (docs/serving.md#chunked-
    #: prefill); None = monolithic prefill (the pre-PR-15 behavior)
    prefill_token_budget: Optional[int] = None

    def __post_init__(self):
        if self.kv_layout not in ("flat", "paged"):
            raise ValueError(
                f"kv_layout must be 'flat' or 'paged', got "
                f"{self.kv_layout!r}")
        if self.prefix_lru_capacity < 0:
            raise ValueError(
                f"prefix_lru_capacity must be >= 0, got "
                f"{self.prefix_lru_capacity}")
        # mirror EngineConfig's validation so a bad scenario fails at
        # parse time, not at engine construction mid-run
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got "
                f"{self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError(
                "kv_dtype='int8' needs kv_layout='paged' (scales are "
                "per-page)")
        if self.speculation < 0 or self.speculation == 1:
            raise ValueError(
                f"speculation must be 0 (off) or a window >= 2, got "
                f"{self.speculation}")
        if self.speculation and self.kv_layout != "paged":
            raise ValueError(
                "speculation needs kv_layout='paged' (the windowed "
                "verify rides the paged kernel)")
        if self.lora_rank < 0 or self.lora_adapters < 0:
            raise ValueError(
                f"lora_rank/lora_adapters must be >= 0, got "
                f"{self.lora_rank}/{self.lora_adapters}")
        if bool(self.lora_rank) != bool(self.lora_adapters):
            raise ValueError(
                f"lora_rank ({self.lora_rank}) and lora_adapters "
                f"({self.lora_adapters}) must be set together (both 0 "
                f"= no adapter store)")
        if self.prefill_token_budget is not None:
            if self.prefill_token_budget < 1:
                raise ValueError(
                    f"prefill_token_budget must be >= 1, got "
                    f"{self.prefill_token_budget}")
            if self.kv_layout == "paged" \
                    and self.prefill_token_budget < self.page_size:
                raise ValueError(
                    f"prefill_token_budget ({self.prefill_token_budget}) "
                    f"must be >= page_size ({self.page_size}) under the "
                    f"paged layout — chunk boundaries are page-aligned")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "EngineKnobs":
        d = dict(data)
        kw: Dict[str, Any] = {}
        if "kv_layout" in d:
            kw["kv_layout"] = str(d.pop("kv_layout"))
        if "kv_dtype" in d:
            kw["kv_dtype"] = str(d.pop("kv_dtype"))
        if "n_pages" in d:
            n = d.pop("n_pages")
            kw["n_pages"] = int(n) if n is not None else None
        if "prefix_cache" in d:
            kw["prefix_cache"] = bool(d.pop("prefix_cache"))
        if "prefill_token_budget" in d:
            b = d.pop("prefill_token_budget")
            kw["prefill_token_budget"] = int(b) if b is not None else None
        kw.update({k: int(v) for k, v in d.items()})
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "max_slots": self.max_slots, "max_len": self.max_len,
            "max_queue": self.max_queue,
            "max_prefills_per_tick": self.max_prefills_per_tick,
            "kv_layout": self.kv_layout, "page_size": self.page_size}
        if self.n_pages is not None:
            out["n_pages"] = self.n_pages
        if not self.prefix_cache:
            out["prefix_cache"] = False
        if self.prefix_lru_capacity != 32:
            out["prefix_lru_capacity"] = self.prefix_lru_capacity
        if self.kv_dtype != "bf16":
            out["kv_dtype"] = self.kv_dtype
        if self.speculation:
            out["speculation"] = self.speculation
        if self.lora_adapters:
            out["lora_rank"] = self.lora_rank
            out["lora_adapters"] = self.lora_adapters
        if self.prefill_token_budget is not None:
            out["prefill_token_budget"] = self.prefill_token_budget
        return out


@dataclass(frozen=True)
class LoadPhase:
    """One open-loop traffic segment.

    ``n_requests`` arrivals are generated with exponential inter-arrival
    gaps at ``rate_rps`` (a Poisson process — arrivals do NOT wait for
    completions; overload is expressed by a rate the engine cannot
    sustain). Prompt and output lengths draw from ``{value: weight}``
    mixes; ``deadline_fraction`` of requests carry a deadline uniform in
    ``[deadline_min_s, deadline_max_s]``; ``greedy_fraction`` decode
    greedily, the rest sample at a drawn temperature/top-k (``top_ks``
    entry ``0`` means untruncated). ``shared_prefix_len`` > 0 makes
    every prompt in the phase open with the SAME ``shared_prefix_len``
    seeded tokens (drawn once at phase start) — the multi-turn /
    system-prompt traffic shape the engine's prefix cache exists for.
    ``prompt_period`` > 0 makes each prompt PERIODIC (its tokens repeat
    with that period) — the repeated-text traffic shape whose n-gram
    structure the self-speculative drafter exploits
    (docs/serving.md#speculative-decoding). ``adapter_mix`` is a
    ``{adapter_id: weight}`` draw over the LoRA tenants each request
    serves under — the special id ``"base"`` means no adapter; every
    other id must name an adapter the engine's store holds (the runner
    loads ids ``"0"`` .. ``"lora_adapters-1"``). Empty = all-base
    traffic with NO extra generator draws, so pre-LoRA scenarios
    reproduce byte-identical schedules (docs/serving.md#multi-lora).
    """

    name: str
    n_requests: int
    rate_rps: float
    prompt_lens: Dict[int, float]
    max_new_tokens: Dict[int, float]
    deadline_fraction: float = 0.0
    deadline_min_s: float = 1.0
    deadline_max_s: float = 1.0
    greedy_fraction: float = 1.0
    temperatures: Tuple[float, ...] = (0.7,)
    top_ks: Tuple[int, ...] = (0,)
    eos_token: Optional[int] = None
    shared_prefix_len: int = 0
    prompt_period: int = 0
    adapter_mix: Dict[str, float] = field(default_factory=dict)
    #: priority class every request in this phase carries (a FIXED
    #: per-phase knob, deliberately not a random mix: no extra generator
    #: draw, so pre-priority scenarios reproduce byte-identical
    #: schedules). None = the engine default ("standard").
    priority: Optional[str] = None

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(
                f"phase {self.name!r}: n_requests must be >= 1, got "
                f"{self.n_requests}")
        if self.rate_rps <= 0:
            raise ValueError(
                f"phase {self.name!r}: rate_rps must be > 0, got "
                f"{self.rate_rps}")
        if not 0.0 <= self.deadline_fraction <= 1.0:
            raise ValueError(
                f"phase {self.name!r}: deadline_fraction must be in "
                f"[0, 1], got {self.deadline_fraction}")
        if self.deadline_fraction > 0 and not \
                0 < self.deadline_min_s <= self.deadline_max_s:
            raise ValueError(
                f"phase {self.name!r}: need 0 < deadline_min_s <= "
                f"deadline_max_s, got [{self.deadline_min_s}, "
                f"{self.deadline_max_s}]")
        if not 0.0 <= self.greedy_fraction <= 1.0:
            raise ValueError(
                f"phase {self.name!r}: greedy_fraction must be in [0, 1], "
                f"got {self.greedy_fraction}")
        if self.greedy_fraction < 1.0:
            if not self.temperatures or \
                    any(t <= 0 for t in self.temperatures):
                raise ValueError(
                    f"phase {self.name!r}: sampled traffic needs positive "
                    f"temperatures, got {self.temperatures}")
            if any(k < 0 for k in self.top_ks):
                raise ValueError(
                    f"phase {self.name!r}: top_ks must be >= 0 "
                    f"(0 = untruncated), got {self.top_ks}")
        if self.shared_prefix_len < 0:
            raise ValueError(
                f"phase {self.name!r}: shared_prefix_len must be >= 0, "
                f"got {self.shared_prefix_len}")
        if self.shared_prefix_len > min(self.prompt_lens):
            raise ValueError(
                f"phase {self.name!r}: shared_prefix_len "
                f"({self.shared_prefix_len}) exceeds the shortest "
                f"prompt length in the mix ({min(self.prompt_lens)})")
        if self.prompt_period < 0:
            raise ValueError(
                f"phase {self.name!r}: prompt_period must be >= 0, "
                f"got {self.prompt_period}")
        for aid, w in self.adapter_mix.items():
            if not isinstance(aid, str) or not aid:
                raise ValueError(
                    f"phase {self.name!r}: adapter_mix keys must be "
                    f"non-empty strings, got {aid!r}")
            if float(w) <= 0:
                raise ValueError(
                    f"phase {self.name!r}: adapter_mix weight for "
                    f"{aid!r} must be > 0, got {w}")
        if self.priority is not None and self.priority not in _PRIORITIES:
            raise ValueError(
                f"phase {self.name!r}: priority must be one of "
                f"{_PRIORITIES}, got {self.priority!r}")

    @property
    def max_total_len(self) -> int:
        return max(self.prompt_lens) + max(self.max_new_tokens)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "LoadPhase":
        d = dict(data)
        name = str(d.pop("name", "phase"))
        eos = d.pop("eos_token", None)
        prio = d.pop("priority", None)
        phase = cls(
            name=name,
            n_requests=int(d.pop("n_requests")),
            rate_rps=float(d.pop("rate_rps")),
            prompt_lens=_weighted(d.pop("prompt_lens"),
                                  f"phase {name!r} prompt_lens"),
            max_new_tokens=_weighted(d.pop("max_new_tokens"),
                                     f"phase {name!r} max_new_tokens"),
            deadline_fraction=float(d.pop("deadline_fraction", 0.0)),
            deadline_min_s=float(d.pop("deadline_min_s", 1.0)),
            deadline_max_s=float(d.pop("deadline_max_s", 1.0)),
            greedy_fraction=float(d.pop("greedy_fraction", 1.0)),
            temperatures=tuple(float(t)
                               for t in d.pop("temperatures", (0.7,))),
            top_ks=tuple(int(k) for k in d.pop("top_ks", (0,))),
            eos_token=int(eos) if eos is not None else None,
            shared_prefix_len=int(d.pop("shared_prefix_len", 0)),
            prompt_period=int(d.pop("prompt_period", 0)),
            adapter_mix={str(k): float(v)
                         for k, v in d.pop("adapter_mix", {}).items()},
            priority=str(prio) if prio is not None else None)
        if d:
            raise ValueError(
                f"phase {name!r}: unknown keys {sorted(d)}")
        return phase

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "n_requests": self.n_requests,
            "rate_rps": self.rate_rps,
            "prompt_lens": {str(k): v
                            for k, v in self.prompt_lens.items()},
            "max_new_tokens": {str(k): v
                               for k, v in self.max_new_tokens.items()}}
        if self.deadline_fraction > 0:
            out["deadline_fraction"] = self.deadline_fraction
            out["deadline_min_s"] = self.deadline_min_s
            out["deadline_max_s"] = self.deadline_max_s
        if self.greedy_fraction < 1.0:
            out["greedy_fraction"] = self.greedy_fraction
            out["temperatures"] = list(self.temperatures)
            out["top_ks"] = list(self.top_ks)
        if self.eos_token is not None:
            out["eos_token"] = self.eos_token
        if self.shared_prefix_len > 0:
            out["shared_prefix_len"] = self.shared_prefix_len
        if self.prompt_period > 0:
            out["prompt_period"] = self.prompt_period
        if self.adapter_mix:
            out["adapter_mix"] = dict(self.adapter_mix)
        if self.priority is not None:
            out["priority"] = self.priority
        return out


@dataclass(frozen=True)
class FaultSchedule:
    """Plain-data mirror of :class:`~apex_tpu_torch.testing_faults.\
ServingFaultInjector`'s schedule (kept torch-free here; the runner builds
    the injector). Call indices are the INJECTOR's own monotonically
    advancing decode/prefill counters — they keep counting across engine
    rebuilds, so a scheduled fault fires exactly once."""

    decode_raise_calls: Tuple[int, ...] = ()
    prefill_raise_calls: Tuple[int, ...] = ()
    decode_hang: Dict[int, float] = field(default_factory=dict)
    poison_decode: Dict[int, Tuple[int, str]] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not (self.decode_raise_calls or self.prefill_raise_calls
                    or self.decode_hang or self.poison_decode)

    def injector_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``ServingFaultInjector``."""
        return {"decode_raise_calls": self.decode_raise_calls,
                "prefill_raise_calls": self.prefill_raise_calls,
                "decode_hang": dict(self.decode_hang),
                "poison_decode": dict(self.poison_decode)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FaultSchedule":
        return cls(
            decode_raise_calls=tuple(
                int(c) for c in data.get("decode_raise_calls", ())),
            prefill_raise_calls=tuple(
                int(c) for c in data.get("prefill_raise_calls", ())),
            decode_hang={int(k): float(v)
                         for k, v in data.get("decode_hang", {}).items()},
            poison_decode={int(k): (int(v[0]), str(v[1]))
                           for k, v in data.get("poison_decode",
                                                {}).items()})

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.decode_raise_calls:
            out["decode_raise_calls"] = list(self.decode_raise_calls)
        if self.prefill_raise_calls:
            out["prefill_raise_calls"] = list(self.prefill_raise_calls)
        if self.decode_hang:
            out["decode_hang"] = {str(k): v
                                  for k, v in self.decode_hang.items()}
        if self.poison_decode:
            out["poison_decode"] = {str(k): list(v)
                                    for k, v in self.poison_decode.items()}
        return out


@dataclass(frozen=True)
class FleetSpec:
    """Optional ``"fleet"`` scenario block: run the traffic against a
    :class:`~apex_tpu_torch.serving.fleet.ReplicaFleet` of ``n_replicas``
    supervised engines instead of a single supervisor.

    ``drain_restarts`` is the fleet-level fault kind: each
    ``(at_s, replica)`` entry schedules a DRAINING restart of that
    replica at ``at_s`` seconds into the run — the runner quiesces it,
    migrates or finishes its in-flight work, rebuilds and health-probes
    it, all while the rest of the fleet keeps serving (capacity >= N-1).
    The scenario's regular ``faults`` schedule applies to replica 0.
    """

    n_replicas: int = 2
    migrate_on_drain: bool = True
    probe_on_rebuild: bool = True
    drain_restarts: Tuple[Tuple[float, int], ...] = ()

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(
                f"fleet n_replicas must be >= 1, got {self.n_replicas}")
        for at_s, replica in self.drain_restarts:
            if at_s < 0:
                raise ValueError(
                    f"drain_restart at_s must be >= 0, got {at_s}")
            if not 0 <= replica < self.n_replicas:
                raise ValueError(
                    f"drain_restart replica {replica} out of range "
                    f"[0, {self.n_replicas})")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FleetSpec":
        d = dict(data)
        spec = cls(
            n_replicas=int(d.pop("n_replicas", 2)),
            migrate_on_drain=bool(d.pop("migrate_on_drain", True)),
            probe_on_rebuild=bool(d.pop("probe_on_rebuild", True)),
            drain_restarts=tuple(
                (float(e["at_s"]), int(e["replica"]))
                for e in d.pop("drain_restarts", ())))
        if d:
            raise ValueError(f"unknown fleet keys {sorted(d)}")
        return spec

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"n_replicas": self.n_replicas}
        if not self.migrate_on_drain:
            out["migrate_on_drain"] = False
        if not self.probe_on_rebuild:
            out["probe_on_rebuild"] = False
        if self.drain_restarts:
            out["drain_restarts"] = [
                {"at_s": at_s, "replica": replica}
                for at_s, replica in self.drain_restarts]
        return out


@dataclass(frozen=True)
class AutoscaleSpec:
    """Optional ``"autoscale"`` scenario block: run the fleet under an
    :class:`~apex_tpu_torch.serving.fleet.Autoscaler` that grows/shrinks the
    replica count between ``min_replicas``/``max_replicas`` off the
    live :meth:`~apex_tpu_torch.observability.FleetMetrics.signals` poll
    (docs/serving.md#autoscaling). Fields mirror
    :class:`~apex_tpu_torch.serving.fleet.AutoscaleConfig` (kept torch-free
    here; the runner builds the config) so a typo fails at scenario
    load, not deep in a run. Requires a ``"fleet"`` block whose
    ``n_replicas`` lies inside the band."""

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
        # mirror AutoscaleConfig's validation so a bad scenario fails
        # at parse time, not at fleet construction mid-run
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale min_replicas must be >= 1, got "
                f"{self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale max_replicas ({self.max_replicas}) must be "
                f">= min_replicas ({self.min_replicas})")
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"autoscale poll_interval_s must be > 0, got "
                f"{self.poll_interval_s}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"autoscale cooldown_s must be >= 0, got "
                f"{self.cooldown_s}")
        if self.hysteresis_polls < 1:
            raise ValueError(
                f"autoscale hysteresis_polls must be >= 1, got "
                f"{self.hysteresis_polls}")

    def config_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``AutoscaleConfig``."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "poll_interval_s": self.poll_interval_s,
            "cooldown_s": self.cooldown_s,
            "hysteresis_polls": self.hysteresis_polls,
            "scale_up_queue_per_replica": self.scale_up_queue_per_replica,
            "scale_up_queued_tokens_per_replica":
                self.scale_up_queued_tokens_per_replica,
            "scale_up_goodput": self.scale_up_goodput,
            "scale_up_ttft_p99_s": self.scale_up_ttft_p99_s,
            "scale_down_queue_per_replica":
                self.scale_down_queue_per_replica,
            "scale_down_slot_occupancy": self.scale_down_slot_occupancy,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AutoscaleSpec":
        d = dict(data)
        kw: Dict[str, Any] = {}
        for key in ("min_replicas", "max_replicas", "hysteresis_polls"):
            if key in d:
                kw[key] = int(d.pop(key))
        for key in ("poll_interval_s", "cooldown_s",
                    "scale_up_queue_per_replica",
                    "scale_up_queued_tokens_per_replica",
                    "scale_up_goodput", "scale_up_ttft_p99_s",
                    "scale_down_queue_per_replica",
                    "scale_down_slot_occupancy"):
            if key in d:
                kw[key] = float(d.pop(key))
        if d:
            raise ValueError(f"unknown autoscale keys {sorted(d)}")
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        defaults = AutoscaleSpec()
        out: Dict[str, Any] = {"min_replicas": self.min_replicas,
                               "max_replicas": self.max_replicas}
        out.update({k: v for k, v in self.config_kwargs().items()
                    if v != getattr(defaults, k)})
        return out


#: keys accepted in a deploy block's ``"canary"`` section — mirrors
#: :class:`~apex_tpu_torch.serving.fleet.CanaryConfig`
_CANARY_KEYS = frozenset({
    "window_s", "min_requests", "max_window_s", "max_error_rate",
    "latency_ratio"})


@dataclass(frozen=True)
class DeploySpec:
    """Optional ``"deploy"`` scenario block: at ``at_s`` seconds into
    the run, fire a :meth:`~apex_tpu_torch.serving.fleet.ReplicaFleet.deploy`
    — a rolling, canary-scored weight rollout
    (docs/serving.md#continuous-deployment).

    ``kind="checkpoint"`` saves the scenario's own (seeded) parameters
    through a :class:`~apex_tpu_torch.checkpoint.ShardedCheckpointManager`
    into a scratch directory and deploys that step — a happy-path
    deploy is therefore weight-identical and must be token-exact.
    ``kind="adapter"`` hot-loads a seeded LoRA adapter ``adapter_id``
    as a canary tenant (needs ``engine.lora_adapters`` > 0).
    ``poison=true`` corrupts the artifact's values post-commit with
    non-finite weights (``corrupt_checkpoint_weights`` — manifest and
    checksums stay green) so the deploy must be caught by the live
    canary score and rolled back, not by fsck. ``canary`` is a
    validated passthrough for
    :class:`~apex_tpu_torch.serving.fleet.CanaryConfig` kwargs."""

    at_s: float
    kind: str = "checkpoint"
    poison: bool = False
    adapter_id: str = "canary"
    canary: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError(
                f"deploy at_s must be >= 0, got {self.at_s}")
        if self.kind not in ("checkpoint", "adapter"):
            raise ValueError(
                f"deploy kind must be 'checkpoint' or 'adapter', got "
                f"{self.kind!r}")
        if self.kind == "adapter" and not self.adapter_id:
            raise ValueError("deploy adapter_id must be non-empty")
        unknown = set(self.canary) - _CANARY_KEYS
        if unknown:
            raise ValueError(
                f"unknown deploy canary keys {sorted(unknown)}; known: "
                f"{sorted(_CANARY_KEYS)}")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeploySpec":
        d = dict(data)
        spec = cls(
            at_s=float(d.pop("at_s")),
            kind=str(d.pop("kind", "checkpoint")),
            poison=bool(d.pop("poison", False)),
            adapter_id=str(d.pop("adapter_id", "canary")),
            canary=dict(d.pop("canary", {})))
        if d:
            raise ValueError(f"unknown deploy keys {sorted(d)}")
        return spec

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"at_s": self.at_s, "kind": self.kind}
        if self.poison:
            out["poison"] = True
        if self.kind == "adapter":
            out["adapter_id"] = self.adapter_id
        if self.canary:
            out["canary"] = dict(self.canary)
        return out


@dataclass(frozen=True)
class SentinelSpec:
    """Optional ``"sentinel"`` scenario block: run the fleet under a
    :class:`~apex_tpu_torch.observability.DriftSentinel` polling
    ``FleetMetrics.signals()`` from the tick (docs/observability.md#
    drift-sentinel). Fields mirror
    :class:`~apex_tpu_torch.observability.SentinelConfig` (kept torch-free
    here; the runner builds the config) so a typo fails at scenario
    load. Requires a ``"fleet"`` block — the sentinel rides the fleet
    tick."""

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
        # mirror SentinelConfig's validation so a bad scenario fails at
        # parse time, not at fleet construction mid-run
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"sentinel poll_interval_s must be > 0, got "
                f"{self.poll_interval_s}")
        if self.warmup_polls < 1:
            raise ValueError(
                f"sentinel warmup_polls must be >= 1, got "
                f"{self.warmup_polls}")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(
                f"sentinel ewma_alpha must be in (0, 1], got "
                f"{self.ewma_alpha}")
        if self.z_threshold <= 0:
            raise ValueError(
                f"sentinel z_threshold must be > 0, got "
                f"{self.z_threshold}")
        if self.hysteresis_polls < 1:
            raise ValueError(
                f"sentinel hysteresis_polls must be >= 1, got "
                f"{self.hysteresis_polls}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"sentinel cooldown_s must be >= 0, got "
                f"{self.cooldown_s}")
        if self.min_abs_dev <= 0:
            raise ValueError(
                f"sentinel min_abs_dev must be > 0, got "
                f"{self.min_abs_dev}")
        if self.snapshot_every_polls < 0:
            raise ValueError(
                f"sentinel snapshot_every_polls must be >= 0, got "
                f"{self.snapshot_every_polls}")
        if not self.signals:
            raise ValueError(
                "sentinel signals must name at least one signal")

    def config_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``SentinelConfig``."""
        return {
            "poll_interval_s": self.poll_interval_s,
            "warmup_polls": self.warmup_polls,
            "ewma_alpha": self.ewma_alpha,
            "z_threshold": self.z_threshold,
            "hysteresis_polls": self.hysteresis_polls,
            "cooldown_s": self.cooldown_s,
            "min_abs_dev": self.min_abs_dev,
            "snapshot_every_polls": self.snapshot_every_polls,
            "signals": self.signals,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SentinelSpec":
        d = dict(data)
        kw: Dict[str, Any] = {}
        for key in ("warmup_polls", "hysteresis_polls",
                    "snapshot_every_polls"):
            if key in d:
                kw[key] = int(d.pop(key))
        for key in ("poll_interval_s", "ewma_alpha", "z_threshold",
                    "cooldown_s", "min_abs_dev"):
            if key in d:
                kw[key] = float(d.pop(key))
        if "signals" in d:
            kw["signals"] = tuple(str(s) for s in d.pop("signals"))
        if d:
            raise ValueError(f"unknown sentinel keys {sorted(d)}")
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        defaults = SentinelSpec()
        out = {k: v for k, v in self.config_kwargs().items()
               if v != getattr(defaults, k)}
        if "signals" in out:
            out["signals"] = list(out["signals"])
        return out


@dataclass(frozen=True)
class RecorderSpec:
    """Optional ``"recorder"`` scenario block: attach a
    :class:`~apex_tpu_torch.observability.FlightRecorder` to the run's
    registry so any incident-class event dumps a postmortem bundle next
    to the run log (docs/observability.md#flight-recorder). Fields
    mirror the recorder's constructor knobs."""

    events_capacity: int = 256
    records_capacity: int = 256
    gauges_capacity: int = 64
    max_bundles: int = 1

    def __post_init__(self):
        for knob in ("events_capacity", "records_capacity",
                     "gauges_capacity"):
            if getattr(self, knob) < 1:
                raise ValueError(
                    f"recorder {knob} must be >= 1, "
                    f"got {getattr(self, knob)}")
        if self.max_bundles < 0:
            raise ValueError(
                f"recorder max_bundles must be >= 0, got "
                f"{self.max_bundles}")

    def recorder_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``FlightRecorder`` (the runner adds
        ``bundle_dir``/``bundle_prefix`` from the run-log path)."""
        return {
            "events_capacity": self.events_capacity,
            "records_capacity": self.records_capacity,
            "gauges_capacity": self.gauges_capacity,
            "max_bundles": self.max_bundles,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "RecorderSpec":
        d = dict(data)
        kw: Dict[str, Any] = {}
        for key in ("events_capacity", "records_capacity",
                    "gauges_capacity", "max_bundles"):
            if key in d:
                kw[key] = int(d.pop(key))
        if d:
            raise ValueError(f"unknown recorder keys {sorted(d)}")
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        defaults = RecorderSpec()
        return {k: v for k, v in self.recorder_kwargs().items()
                if v != getattr(defaults, k)}


#: keys accepted in a quota tenant entry — mirrors
#: :class:`~apex_tpu_torch.serving.fleet.TenantQuota`
_TENANT_QUOTA_KEYS = frozenset({
    "rate_rps", "burst", "max_inflight", "max_pages", "soft"})


def _tenant_quota_entry(data: Dict[str, Any], what: str) -> Dict[str, Any]:
    """Validate + coerce one tenant-quota dict (mirrors ``TenantQuota``
    validation so a bad scenario fails at parse time, torch-free)."""
    unknown = set(data) - _TENANT_QUOTA_KEYS
    if unknown:
        raise ValueError(
            f"unknown {what} keys {sorted(unknown)}; known: "
            f"{sorted(_TENANT_QUOTA_KEYS)}")
    entry: Dict[str, Any] = {}
    for key in ("rate_rps", "burst"):
        if key in data:
            entry[key] = float(data[key])
    for key in ("max_inflight", "max_pages"):
        if key in data:
            entry[key] = int(data[key])
    if "soft" in data:
        entry["soft"] = bool(data["soft"])
    if entry.get("rate_rps", 0.0) < 0:
        raise ValueError(
            f"{what}: rate_rps must be >= 0, got {entry['rate_rps']}")
    if entry.get("burst", 1.0) < 1.0:
        raise ValueError(
            f"{what}: burst must be >= 1, got {entry['burst']}")
    for key in ("max_inflight", "max_pages"):
        if entry.get(key, 0) < 0:
            raise ValueError(
                f"{what}: {key} must be >= 0, got {entry[key]}")
    return entry


@dataclass(frozen=True)
class QuotaSpec:
    """Optional ``"quotas"`` scenario block: run the fleet front door
    behind a per-tenant :class:`~apex_tpu_torch.serving.fleet.QuotaLedger`
    (docs/serving.md#priority-preemption-and-quotas). ``tenants`` maps
    tenant keys (adapter ids, or ``"base"``) to
    :class:`~apex_tpu_torch.serving.fleet.TenantQuota` kwargs; ``default``
    applies to tenants not named. Kept torch-free here — the runner
    builds the ledger. Requires a ``"fleet"`` block."""

    tenants: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    default: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        for key, entry in self.tenants.items():
            if not isinstance(key, str) or not key:
                raise ValueError(
                    f"quota tenant keys must be non-empty strings, "
                    f"got {key!r}")
            _tenant_quota_entry(entry, f"quota tenant {key!r}")
        if self.default is not None:
            _tenant_quota_entry(self.default, "quota default")
        if not self.tenants and self.default is None:
            raise ValueError(
                "a 'quotas' block must name at least one tenant or a "
                "default")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "QuotaSpec":
        d = dict(data)
        spec = cls(
            tenants={str(k): _tenant_quota_entry(
                dict(v), f"quota tenant {k!r}")
                for k, v in d.pop("tenants", {}).items()},
            default=(_tenant_quota_entry(dict(d.pop("default")),
                                         "quota default")
                     if d.get("default") is not None
                     else d.pop("default", None)))
        if d:
            raise ValueError(f"unknown quotas keys {sorted(d)}")
        return spec

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.tenants:
            out["tenants"] = {k: dict(v) for k, v in self.tenants.items()}
        if self.default is not None:
            out["default"] = dict(self.default)
        return out


@dataclass(frozen=True)
class BrownoutSpec:
    """Optional ``"brownout"`` scenario block: run the fleet under a
    :class:`~apex_tpu_torch.serving.fleet.BrownoutController` that walks the
    staged-degradation ladder off the live signals poll
    (docs/serving.md#priority-preemption-and-quotas). Fields mirror
    :class:`~apex_tpu_torch.serving.fleet.BrownoutConfig` (kept torch-free
    here; the runner builds the config) so a typo fails at scenario
    load. Requires a ``"fleet"`` block — the controller rides the
    fleet tick."""

    poll_interval_s: float = 0.25
    queue_depth_high: float = 8.0
    queue_depth_low: float = 2.0
    hot_polls: int = 2
    cool_polls: int = 2
    clamp_max_new_tokens: int = 32
    max_rung: int = 4

    def __post_init__(self):
        # mirror BrownoutConfig's validation so a bad scenario fails at
        # parse time, not at fleet construction mid-run
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"brownout poll_interval_s must be > 0, got "
                f"{self.poll_interval_s}")
        if self.queue_depth_high <= 0:
            raise ValueError(
                f"brownout queue_depth_high must be > 0, got "
                f"{self.queue_depth_high}")
        if not 0 <= self.queue_depth_low < self.queue_depth_high:
            raise ValueError(
                f"brownout queue_depth_low ({self.queue_depth_low}) "
                f"must be in [0, queue_depth_high="
                f"{self.queue_depth_high})")
        if self.hot_polls < 1:
            raise ValueError(
                f"brownout hot_polls must be >= 1, got {self.hot_polls}")
        if self.cool_polls < 1:
            raise ValueError(
                f"brownout cool_polls must be >= 1, got "
                f"{self.cool_polls}")
        if self.clamp_max_new_tokens < 1:
            raise ValueError(
                f"brownout clamp_max_new_tokens must be >= 1, got "
                f"{self.clamp_max_new_tokens}")
        if not 0 <= self.max_rung <= 4:
            raise ValueError(
                f"brownout max_rung must be in [0, 4], got "
                f"{self.max_rung}")

    def config_kwargs(self) -> Dict[str, Any]:
        """Constructor kwargs for ``BrownoutConfig``."""
        return {
            "poll_interval_s": self.poll_interval_s,
            "queue_depth_high": self.queue_depth_high,
            "queue_depth_low": self.queue_depth_low,
            "hot_polls": self.hot_polls,
            "cool_polls": self.cool_polls,
            "clamp_max_new_tokens": self.clamp_max_new_tokens,
            "max_rung": self.max_rung,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "BrownoutSpec":
        d = dict(data)
        kw: Dict[str, Any] = {}
        for key in ("hot_polls", "cool_polls", "clamp_max_new_tokens",
                    "max_rung"):
            if key in d:
                kw[key] = int(d.pop(key))
        for key in ("poll_interval_s", "queue_depth_high",
                    "queue_depth_low"):
            if key in d:
                kw[key] = float(d.pop(key))
        if d:
            raise ValueError(f"unknown brownout keys {sorted(d)}")
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        defaults = BrownoutSpec()
        return {k: v for k, v in self.config_kwargs().items()
                if v != getattr(defaults, k)}


@dataclass(frozen=True)
class Scenario:
    """One complete load-test description; see the module docstring.

    ``seed`` drives every random draw the traffic generator makes;
    ``slo`` declares the objectives the run is scored against;
    ``tolerance`` is the relative slack the regression gate allows
    against the committed baseline; ``max_wall_s`` is the harness's own
    runaway guard — a scenario that cannot finish inside it is aborted
    (remaining requests cancelled, recorded terminally, and the abort
    stamped into the log as an event).
    """

    name: str
    phases: Tuple[LoadPhase, ...]
    seed: int = 0
    description: str = ""
    model: ModelSpec = field(default_factory=ModelSpec)
    engine: EngineKnobs = field(default_factory=EngineKnobs)
    supervisor: Dict[str, Any] = field(default_factory=dict)
    faults: FaultSchedule = field(default_factory=FaultSchedule)
    fleet: Optional[FleetSpec] = None
    autoscale: Optional[AutoscaleSpec] = None
    deploy: Optional[DeploySpec] = None
    sentinel: Optional[SentinelSpec] = None
    recorder: Optional[RecorderSpec] = None
    quotas: Optional[QuotaSpec] = None
    brownout: Optional[BrownoutSpec] = None
    slo: Dict[str, float] = field(default_factory=dict)
    tolerance: float = 0.25
    max_wall_s: float = 300.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario name must be non-empty")
        if not self.phases:
            raise ValueError(f"scenario {self.name!r} needs >= 1 phase")
        if self.tolerance < 0:
            raise ValueError(
                f"tolerance must be >= 0, got {self.tolerance}")
        if self.max_wall_s <= 0:
            raise ValueError(
                f"max_wall_s must be > 0, got {self.max_wall_s}")
        unknown = set(self.supervisor) - _SUPERVISOR_KEYS
        if unknown:
            raise ValueError(
                f"unknown supervisor knobs {sorted(unknown)}; known: "
                f"{sorted(_SUPERVISOR_KEYS)}")
        for metric in self.slo:
            if metric not in SLO_METRICS:
                raise ValueError(
                    f"unknown SLO metric {metric!r}; known: "
                    f"{sorted(SLO_METRICS)}")
        for phase in self.phases:
            if phase.max_total_len > self.engine.max_len:
                raise ValueError(
                    f"phase {phase.name!r}: worst-case prompt + "
                    f"max_new_tokens ({phase.max_total_len}) exceeds "
                    f"engine max_len ({self.engine.max_len})")
            for k in phase.top_ks:
                if k > self.model.vocab_size:
                    raise ValueError(
                        f"phase {phase.name!r}: top_k {k} exceeds vocab "
                        f"size {self.model.vocab_size}")
            if phase.eos_token is not None and not \
                    0 <= phase.eos_token < self.model.vocab_size:
                raise ValueError(
                    f"phase {phase.name!r}: eos_token {phase.eos_token} "
                    f"out of vocab [0, {self.model.vocab_size})")
            deploy_aid = (self.deploy.adapter_id
                          if self.deploy is not None
                          and self.deploy.kind == "adapter" else None)
            for aid in phase.adapter_mix:
                # the deploy block's canary tenant may be addressed too
                # (requests before the deploy fires shed as unknown —
                # the tenant comes online mid-run, by design)
                if aid == "base" or aid == deploy_aid:
                    continue
                if not self.engine.lora_adapters:
                    raise ValueError(
                        f"phase {phase.name!r}: adapter_mix names "
                        f"adapter {aid!r} but the engine has no "
                        f"adapter store (set engine.lora_adapters/"
                        f"lora_rank)")
                if not (aid.isdigit()
                        and int(aid) < self.engine.lora_adapters):
                    raise ValueError(
                        f"phase {phase.name!r}: adapter_mix id {aid!r} "
                        f"is not one of the runner-loaded ids '0'..'"
                        f"{self.engine.lora_adapters - 1}' (or 'base')")
        if self.autoscale is not None:
            if self.fleet is None:
                raise ValueError(
                    "an 'autoscale' block needs a 'fleet' block")
            if not (self.autoscale.min_replicas <= self.fleet.n_replicas
                    <= self.autoscale.max_replicas):
                raise ValueError(
                    f"fleet n_replicas ({self.fleet.n_replicas}) must "
                    f"lie in the autoscale band "
                    f"[{self.autoscale.min_replicas}, "
                    f"{self.autoscale.max_replicas}]")
        if self.sentinel is not None and self.fleet is None:
            raise ValueError("a 'sentinel' block needs a 'fleet' block "
                             "(the sentinel rides the fleet tick)")
        if self.quotas is not None and self.fleet is None:
            raise ValueError("a 'quotas' block needs a 'fleet' block "
                             "(quotas gate the fleet front door)")
        if self.brownout is not None and self.fleet is None:
            raise ValueError("a 'brownout' block needs a 'fleet' block "
                             "(the controller rides the fleet tick)")
        if self.deploy is not None:
            if self.fleet is None:
                raise ValueError("a 'deploy' block needs a 'fleet' block")
            if self.deploy.kind == "adapter":
                if not self.engine.lora_adapters:
                    raise ValueError(
                        "deploy kind='adapter' needs an adapter store "
                        "(set engine.lora_adapters/lora_rank)")
                if self.deploy.adapter_id.isdigit() and int(
                        self.deploy.adapter_id) < self.engine.lora_adapters:
                    raise ValueError(
                        f"deploy adapter_id {self.deploy.adapter_id!r} "
                        f"collides with a runner-preloaded tenant id")
        if self.engine.max_len > self.model.max_position_embeddings:
            raise ValueError(
                f"engine max_len ({self.engine.max_len}) exceeds the "
                f"model's max_position_embeddings "
                f"({self.model.max_position_embeddings})")

    @property
    def total_requests(self) -> int:
        return sum(p.n_requests for p in self.phases)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Scenario":
        known = {"name", "seed", "description", "model", "engine",
                 "supervisor", "phases", "faults", "fleet", "autoscale",
                 "deploy", "sentinel", "recorder", "quotas", "brownout",
                 "slo", "tolerance", "max_wall_s"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown scenario keys {sorted(unknown)}; known: "
                f"{sorted(known)}")
        return cls(
            name=str(data["name"]),
            seed=int(data.get("seed", 0)),
            description=str(data.get("description", "")),
            model=ModelSpec.from_dict(data.get("model", {})),
            engine=EngineKnobs.from_dict(data.get("engine", {})),
            supervisor=dict(data.get("supervisor", {})),
            phases=tuple(LoadPhase.from_dict(p)
                         for p in data.get("phases", ())),
            faults=FaultSchedule.from_dict(data.get("faults", {})),
            fleet=(FleetSpec.from_dict(data["fleet"])
                   if data.get("fleet") is not None else None),
            autoscale=(AutoscaleSpec.from_dict(data["autoscale"])
                       if data.get("autoscale") is not None else None),
            deploy=(DeploySpec.from_dict(data["deploy"])
                    if data.get("deploy") is not None else None),
            sentinel=(SentinelSpec.from_dict(data["sentinel"])
                      if data.get("sentinel") is not None else None),
            recorder=(RecorderSpec.from_dict(data["recorder"])
                      if data.get("recorder") is not None else None),
            quotas=(QuotaSpec.from_dict(data["quotas"])
                    if data.get("quotas") is not None else None),
            brownout=(BrownoutSpec.from_dict(data["brownout"])
                      if data.get("brownout") is not None else None),
            slo={str(k): float(v)
                 for k, v in data.get("slo", {}).items()},
            tolerance=float(data.get("tolerance", 0.25)),
            max_wall_s=float(data.get("max_wall_s", 300.0)))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "seed": self.seed,
            "model": self.model.to_dict(),
            "engine": self.engine.to_dict(),
            "phases": [p.to_dict() for p in self.phases],
            "tolerance": self.tolerance, "max_wall_s": self.max_wall_s}
        if self.description:
            out["description"] = self.description
        if self.supervisor:
            out["supervisor"] = dict(self.supervisor)
        if not self.faults.empty:
            out["faults"] = self.faults.to_dict()
        if self.fleet is not None:
            out["fleet"] = self.fleet.to_dict()
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.to_dict()
        if self.deploy is not None:
            out["deploy"] = self.deploy.to_dict()
        if self.sentinel is not None:
            out["sentinel"] = self.sentinel.to_dict()
        if self.recorder is not None:
            out["recorder"] = self.recorder.to_dict()
        if self.quotas is not None:
            out["quotas"] = self.quotas.to_dict()
        if self.brownout is not None:
            out["brownout"] = self.brownout.to_dict()
        if self.slo:
            out["slo"] = dict(self.slo)
        return out

    @classmethod
    def load(cls, path: str) -> "Scenario":
        """Parse and validate a scenario JSON file."""
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: scenario must be a JSON object")
        return cls.from_dict(data)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
