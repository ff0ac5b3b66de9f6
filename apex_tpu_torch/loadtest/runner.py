"""Scenario execution: generator -> supervised engine -> JSONL -> SLOs
(counterpart of ``apex_tpu/loadtest/runner.py``).

:func:`run_scenario` materializes the scenario's arrival schedule
(:mod:`~apex_tpu_torch.loadtest.generator`), builds the model under test,
wraps an :class:`~apex_tpu_torch.serving.InferenceEngine` in an
:class:`~apex_tpu_torch.serving.EngineSupervisor` (with the scenario's
fault schedule driving a :class:`~apex_tpu_torch.testing_faults.\
ServingFaultInjector`), and replays the schedule **open-loop** against
wall clock: a request is submitted the moment its arrival time passes,
whether or not the engine kept up — queue growth, shedding, and
deadline misses are the signal, not an error.

Everything observable flows through one
:class:`~apex_tpu_torch.observability.MetricsRegistry`: the scenario
record (name, seed, declared SLOs — so the log scores itself in
``python -m apex_tpu_torch.monitor``), every ``kind="request"`` and
``kind="span"`` row and incident event the serving tier emits, and the
final counter snapshot. The returned :class:`ScenarioRun` carries the
in-memory record stream plus the scored :class:`~apex_tpu_torch.\
observability.slo.SLOReport`, and the same records land in ``log_path``
when given.

Where the port differs from the JAX runner:

- the port's model owns its parameters, so :func:`build_model` returns
  the model alone (weights drawn from a ``torch.Generator`` seeded with
  ``param_seed``: the same seed gives the same weights on any device, but
  not the JAX package's) and :func:`run_scenario` takes ``model=`` alone —
  a comparison with the JAX runner loads converted weights into it;
- ``lora_adapters``: the seeded :class:`~apex_tpu_torch.lora.AdapterStore`
  (ids ``"0"`` .. ``"n-1"``, rank ``lora_rank``) draws its factors from a
  ``torch.Generator`` seeded with the scenario's ``seed``, as
  :func:`build_model` draws weights, so they are not the JAX runner's;
  :func:`run_scenario` takes ``adapters=`` too (converted JAX adapters for
  a comparison);
- one engine only: a scenario with a ``fleet``, ``autoscale``, ``deploy``,
  ``sentinel``, ``quotas`` or ``brownout`` block raises
  ``NotImplementedError`` before anything runs, naming the ROADMAP item
  that brings it;
- ``ScenarioRun.retraces`` reads the ``retraces`` counter as the JAX
  runner does; the port's engines compile nothing, so it stays 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch

from apex_tpu_torch.loadtest.generator import ScheduledRequest, \
    TrafficGenerator
from apex_tpu_torch.loadtest.scenario import ModelSpec, Scenario
from apex_tpu_torch.observability import (
    InMemorySink,
    JsonlSink,
    MetricsRegistry,
)
from apex_tpu_torch.observability.slo import (
    SLOReport,
    SLOSpec,
    evaluate_slos,
    measure_slo_metrics,
)
from apex_tpu_torch.serving import (
    DeadlineExpiredError,
    EngineConfig,
    EngineSupervisor,
    EngineUnavailableError,
    QueueFullError,
    RequestResult,
    SchedulerConfig,
    SupervisorConfig,
    UnknownAdapterError,
)
from apex_tpu_torch.serving import clock
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["ScenarioRun", "build_model", "run_scenario"]

_LOG = get_logger(__name__)

#: while no arrival is due and nothing is in flight, sleep at most this
#: long per wait slice (keeps the loop responsive to the next arrival
#: without busy-spinning)
_IDLE_SLEEP_S = 0.005

#: scenario blocks the port cannot run yet, each with the ROADMAP §1 item
#: that brings it
_UNPORTED = (("fleet", "the fleet, ROADMAP §1 item 4"),
             ("autoscale", "the fleet's autoscaler, ROADMAP §1 item 4"),
             ("deploy", "fleet deployments and checkpoints, ROADMAP §1 "
                        "items 4-5"),
             ("sentinel", "the fleet's drift sentinel, ROADMAP §1 item 4"),
             ("quotas", "the fleet's tenant quotas, ROADMAP §1 item 4"),
             ("brownout", "the fleet's brownout ladder, ROADMAP §1 item 4"))


def build_model(spec: ModelSpec, *,
                device: Union[str, torch.device, None] = "cuda",
                compute_dtype: Union[str, torch.dtype] = torch.float32):
    """Build the (seeded) model under test from its scenario spec on
    ``device``: fp32 parameters drawn from ``param_seed``, computing in
    ``compute_dtype`` (a torch dtype or its name; fp32 as in the JAX
    runner unless asked otherwise)."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig

    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    return GPTModel(TransformerConfig(
        num_layers=spec.num_layers, hidden_size=spec.hidden_size,
        num_attention_heads=spec.num_attention_heads,
        vocab_size=spec.vocab_size,
        max_position_embeddings=spec.max_position_embeddings,
        hidden_dropout=0.0, attention_dropout=0.0,
        params_dtype=torch.float32, compute_dtype=compute_dtype),
        device=device,
        generator=torch.Generator().manual_seed(spec.param_seed))


def _build_adapters(scenario: Scenario, model):
    """The scenario's seeded adapter store on the model's device (None
    without ``lora_adapters``): ids ``"0"`` .. ``"n-1"``, each a
    :func:`~apex_tpu_torch.lora.random_adapter` of rank ``lora_rank``
    drawn in turn from a ``torch.Generator`` seeded with the scenario's
    ``seed`` — reproducible per-tenant weights, as :func:`build_model`
    seeds the base model."""
    from apex_tpu_torch.lora import AdapterStore, random_adapter

    knobs = scenario.engine
    if not knobs.lora_adapters:
        return None
    store = AdapterStore(model.config, knobs.lora_rank,
                         max_adapters=knobs.lora_adapters,
                         device=model.device)
    g = torch.Generator().manual_seed(scenario.seed)
    for ix in range(knobs.lora_adapters):
        store.load(str(ix), random_adapter(model.config, knobs.lora_rank, g,
                                           device=model.device))
    return store


@dataclass
class ScenarioRun:
    """Everything one scenario execution produced."""

    scenario: Scenario
    schedule: List[ScheduledRequest]
    results: Dict[int, RequestResult]     # request_id -> terminal result
    records: List[dict]                   # the full JSONL record stream
    counters: Dict[str, int]
    wall_s: float
    aborted: bool = False                 # hit the max_wall_s guard
    slo: Optional[SLOReport] = None
    log_path: Optional[str] = None
    ticks: int = 0
    engine_restarts: int = 0
    submitted: int = 0                    # arrivals actually offered
    metrics_by_name: Dict[str, Optional[float]] = field(
        default_factory=dict)
    #: per-tenant SLO attribution (adapter_id -> metrics dict); kept
    #: apart from metrics_by_name — never part of the baseline payload
    slo_by_adapter: Dict[str, Dict[str, Optional[float]]] = field(
        default_factory=dict)
    #: the final fleet signals poll: always None (one engine)
    signals: Optional[dict] = None
    #: the ``retraces`` counter; must be 0 (the port compiles nothing)
    retraces: int = 0
    #: postmortem bundles the scenario's FlightRecorder dumped (empty
    #: when no ``recorder`` block, or when nothing incident-class fired)
    bundles: List[dict] = field(default_factory=list)
    #: where those bundles landed on disk — next to the run log (empty
    #: for in-memory runs with no ``log_path``)
    bundle_paths: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        """SLO verdict (vacuously true when no SLOs are declared), AND'd
        with a zero retrace count."""
        slo_ok = self.slo.ok if self.slo is not None else True
        return slo_ok and self.retraces == 0


def _check_ported(scenario: Scenario) -> None:
    """Raise for a scenario the port cannot run whole — before anything
    is built, so no such scenario runs partly."""
    for block, what in _UNPORTED:
        if getattr(scenario, block) is not None:
            raise NotImplementedError(
                f"scenario {scenario.name!r} has a {block!r} block: "
                f"{what} is not ported yet")


def _build_serving(scenario: Scenario, model, metrics: MetricsRegistry,
                   adapters=None) -> EngineSupervisor:
    """The serving tier under test: one
    :class:`~apex_tpu_torch.serving.EngineSupervisor` on the model's
    device, the scenario's fault schedule driving its injector and
    ``adapters`` its adapter store."""
    from apex_tpu_torch.testing_faults import ServingFaultInjector

    knobs = scenario.engine
    engine_cfg = EngineConfig(
        max_slots=knobs.max_slots, max_len=knobs.max_len,
        kv_layout=knobs.kv_layout, page_size=knobs.page_size,
        n_pages=knobs.n_pages,
        prefix_cache=knobs.prefix_cache,
        prefix_lru_capacity=knobs.prefix_lru_capacity,
        kv_dtype=knobs.kv_dtype,
        speculation=knobs.speculation,
        prefill_token_budget=knobs.prefill_token_budget,
        scheduler=SchedulerConfig(
            max_queue=knobs.max_queue,
            max_prefills_per_tick=knobs.max_prefills_per_tick))
    sup_cfg = SupervisorConfig(**scenario.supervisor)
    faults = None
    if not scenario.faults.empty:
        faults = ServingFaultInjector(**scenario.faults.injector_kwargs())
    return EngineSupervisor(model, engine_cfg, supervisor=sup_cfg,
                            metrics=metrics, faults=faults,
                            adapters=adapters, device=model.device)


def run_scenario(scenario: Scenario, *, model=None, adapters=None,
                 metrics: Optional[MetricsRegistry] = None,
                 log_path: Optional[str] = None) -> ScenarioRun:
    """Execute ``scenario`` and score it against its declared SLOs.

    ``model`` defaults to :func:`build_model` of the scenario's model spec
    on the card (pass one to run another device, dtype or set of weights,
    e.g. converted JAX weights on the CPU). ``adapters`` defaults, for a
    scenario with ``lora_adapters``, to the seeded store on the
    model's device (pass a store to serve other factors, e.g. converted
    JAX adapters). ``metrics`` defaults to a
    fresh registry; ``log_path`` attaches a JSONL sink so the run is
    ``python -m apex_tpu_torch.monitor``-able afterwards. An
    :class:`~apex_tpu_torch.observability.InMemorySink` is always
    attached: the SLO verdict is computed from the very records the sinks
    saw.
    """
    _check_ported(scenario)
    if model is None:
        model = build_model(scenario.model)
    registry = metrics if metrics is not None else MetricsRegistry()
    mem = InMemorySink()
    registry.add_sink(mem)
    if log_path is not None:
        registry.add_sink(JsonlSink(log_path))
    recorder = None
    if scenario.recorder is not None:
        from apex_tpu_torch.observability.recorder import FlightRecorder

        # bundles land next to the run log, named after it; a run with
        # no log keeps them in memory (ScenarioRun.bundles)
        bundle_dir = bundle_prefix = None
        if log_path is not None:
            bundle_dir = os.path.dirname(os.path.abspath(log_path))
            bundle_prefix = os.path.splitext(
                os.path.basename(log_path))[0]
        recorder = FlightRecorder(
            bundle_dir=bundle_dir,
            bundle_prefix=bundle_prefix or scenario.name,
            **scenario.recorder.recorder_kwargs())
        # attached before the scenario record so the rings hold the
        # run's self-description too
        registry.add_sink(recorder)
    # the log's self-description: name + seed for provenance, the SLO
    # spec so the monitor (and --from-log re-scoring) can render a
    # verdict without the scenario file at hand
    registry.emit_record({
        "kind": "scenario", "name": scenario.name, "seed": scenario.seed,
        "total_requests": scenario.total_requests,
        "slo": dict(scenario.slo), "wall": clock.wall()})

    schedule = TrafficGenerator(scenario).schedule()
    if adapters is None:
        adapters = _build_adapters(scenario, model)
    sup = _build_serving(scenario, model, registry, adapters)
    if recorder is not None:
        recorder.attach(sup, registry)
    run = ScenarioRun(scenario=scenario, schedule=schedule, results={},
                      records=mem.records, counters={}, wall_s=0.0,
                      log_path=log_path)
    t0 = clock.now()
    i = 0
    try:
        while i < len(schedule) or sup.inflight_count:
            now = clock.now() - t0
            if now > scenario.max_wall_s:
                run.aborted = True
                _abort(sup, scenario, registry, now)
                break
            while i < len(schedule) and schedule[i].at_s <= now:
                req = schedule[i].request
                # open-loop contract: the deadline clock starts at the
                # SCHEDULED arrival, not whenever the loop got to it
                req.arrival_ts = t0 + schedule[i].at_s
                i += 1
                run.submitted += 1
                try:
                    sup.submit(req)
                except (EngineUnavailableError, QueueFullError,
                        DeadlineExpiredError, UnknownAdapterError):
                    pass        # recorded terminally by the supervisor
            if sup.inflight_count:
                sup.tick()
                run.ticks += 1
            elif i < len(schedule):
                gap = (t0 + schedule[i].at_s) - clock.now()
                if gap > 0:
                    clock.sleep(min(gap, _IDLE_SLEEP_S))
    finally:
        run.wall_s = clock.now() - t0
        sup.close()             # flushes the final counter snapshot
    run.results = dict(sup.completed)
    run.counters = registry.counters()
    if recorder is not None:
        run.bundles = list(recorder.bundles)
        run.bundle_paths = list(recorder.bundle_paths)
    run.engine_restarts = sup.restarts
    run.retraces = int(run.counters.get("retraces", 0))
    if run.retraces:
        log_event(_LOG, "scenario_retraces", scenario=scenario.name,
                  retraces=run.retraces, level="error")
        registry.event("scenario_retraces", scenario=scenario.name,
                       retraces=run.retraces)
    if scenario.slo:
        run.slo = evaluate_slos(mem.records,
                                SLOSpec.from_dict(scenario.slo))
        run.metrics_by_name = dict(run.slo.metrics)
    else:
        run.metrics_by_name = measure_slo_metrics(mem.records)
    run.slo_by_adapter = measure_slo_metrics(mem.records,
                                             by_adapter=True)
    return run


def _abort(sup: EngineSupervisor, scenario: Scenario,
           registry: MetricsRegistry, now_s: float) -> None:
    """Wall-budget breach: cancel every non-terminal request (each still
    reaches exactly one terminal record — conservation holds even for an
    aborted run) and stamp the abort into the log."""
    log_event(_LOG, "loadtest_aborted", scenario=scenario.name,
              wall_s=now_s, budget_s=scenario.max_wall_s,
              inflight=sup.inflight_count)
    registry.event("loadtest_aborted", scenario=scenario.name,
                   wall_s=now_s, budget_s=scenario.max_wall_s,
                   inflight=sup.inflight_count)
    for rid in sup.inflight_ids:
        sup.cancel(rid)
    # in-flight cancellations retire at the start of the next tick
    guard = 0
    while sup.inflight_count and guard < scenario.engine.max_slots + 2:
        sup.tick()
        guard += 1
