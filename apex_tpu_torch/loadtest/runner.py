"""Scenario execution: generator -> supervised engine or fleet -> JSONL ->
SLOs (counterpart of ``apex_tpu/loadtest/runner.py``).

:func:`run_scenario` materializes the scenario's arrival schedule
(:mod:`~apex_tpu_torch.loadtest.generator`), builds the model under test,
wraps an :class:`~apex_tpu_torch.serving.InferenceEngine` in an
:class:`~apex_tpu_torch.serving.EngineSupervisor` — or, for a scenario
with a ``fleet`` block, a :class:`~apex_tpu_torch.serving.ReplicaFleet`
with the scenario's autoscale, sentinel, quotas and brownout blocks —
(with the scenario's fault schedule driving a
:class:`~apex_tpu_torch.testing_faults.ServingFaultInjector`), and
replays the schedule **open-loop** against wall clock, with the fleet's
scheduled draining restarts and its one ``deploy``: a request is submitted the moment its arrival time passes,
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
- a ``deploy`` block's checkpoint is the model's parameters in the JAX
  package's tree (:func:`~apex_tpu_torch.serving.fleet.deploy.\
model_params_tree`), so the step directory is the one the JAX runner
  writes for the same weights; its adapter canary draws its factors from
  a ``torch.Generator`` seeded with ``seed + 7919`` (the JAX runner's
  offset, not its draws);
- ``ScenarioRun.retraces`` reads the ``retraces`` counter as the JAX
  runner does; the port's engines compile nothing, so it stays 0.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import torch

from apex_tpu_torch.loadtest.generator import ScheduledRequest, \
    TrafficGenerator
from apex_tpu_torch.loadtest.scenario import ModelSpec, Scenario
from apex_tpu_torch.observability import (
    FleetMetrics,
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
    #: the final FleetMetrics.signals() poll (fleet scenarios only) —
    #: also stamped into the log as the kind="signals" record
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


def _build_serving(scenario: Scenario, model, metrics: MetricsRegistry,
                   adapters=None):
    """The serving tier under test on the model's device: one
    :class:`~apex_tpu_torch.serving.EngineSupervisor`, or — when the
    scenario declares a ``fleet`` block — a
    :class:`~apex_tpu_torch.serving.ReplicaFleet` (the fault schedule then
    drives replica 0's injector); ``adapters`` is the adapter store. Both
    expose the same driving surface, so the replay loop is
    tier-agnostic."""
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
    if scenario.fleet is not None:
        from apex_tpu_torch.serving.fleet import (
            AutoscaleConfig,
            BrownoutConfig,
            FleetConfig,
            QuotaConfig,
            ReplicaFleet,
            TenantQuota,
        )
        from apex_tpu_torch.observability.sentinel import SentinelConfig

        fl = scenario.fleet
        autoscale = AutoscaleConfig(**scenario.autoscale.config_kwargs()) \
            if scenario.autoscale is not None else None
        sentinel = SentinelConfig(**scenario.sentinel.config_kwargs()) \
            if scenario.sentinel is not None else None
        quotas = None
        if scenario.quotas is not None:
            quotas = QuotaConfig(
                tenants={k: TenantQuota(**v)
                         for k, v in scenario.quotas.tenants.items()},
                default=(TenantQuota(**scenario.quotas.default)
                         if scenario.quotas.default is not None else None))
        brownout = BrownoutConfig(**scenario.brownout.config_kwargs()) \
            if scenario.brownout is not None else None
        return ReplicaFleet(
            model, engine_cfg, supervisor=sup_cfg,
            fleet=FleetConfig(n_replicas=fl.n_replicas,
                              migrate_on_drain=fl.migrate_on_drain,
                              probe_on_rebuild=fl.probe_on_rebuild),
            metrics=metrics, faults=faults, adapters=adapters,
            autoscale=autoscale, sentinel=sentinel, quotas=quotas,
            brownout=brownout, device=model.device)
    return EngineSupervisor(model, engine_cfg, supervisor=sup_cfg,
                            metrics=metrics, faults=faults,
                            adapters=adapters, device=model.device)


def _prepare_deploy(scenario: Scenario, model,
                    scratch: str) -> Dict[str, Any]:
    """Materialize the scenario's ``deploy`` artifact and return the
    kwargs for :meth:`~apex_tpu_torch.serving.ReplicaFleet.deploy`.

    ``kind="checkpoint"`` saves the model's own parameters, in the JAX
    package's tree (:func:`~apex_tpu_torch.serving.fleet.deploy.\
model_params_tree`), at step 1 through a
    :class:`~apex_tpu_torch.checkpoint.ShardedCheckpointManager` (a
    happy-path deploy is weight-identical, so it must be token-exact);
    ``poison=true`` then value-corrupts the committed step with
    :func:`~apex_tpu_torch.testing_faults.corrupt_checkpoint_weights` —
    fsck stays green, the live canary score is the only detector.
    ``kind="adapter"`` builds a seeded LoRA canary tenant (NaN factors
    when poisoned)."""
    from apex_tpu_torch.serving.fleet import CanaryConfig

    spec = scenario.deploy
    canary = CanaryConfig(**{
        k: (int(v) if k == "min_requests" else float(v))
        for k, v in spec.canary.items()})
    if spec.kind == "adapter":
        from apex_tpu_torch.lora import random_adapter

        # offset keeps the canary tenant's weights distinct from the
        # runner-preloaded ids "0".."n-1" (same seed stream)
        factors = random_adapter(
            model.config, scenario.engine.lora_rank,
            torch.Generator().manual_seed(scenario.seed + 7919),
            device=model.device)
        if spec.poison:
            factors = {t: {k: v * float("nan") for k, v in f.items()}
                       for t, f in factors.items()}
        return {"adapter": (spec.adapter_id, factors), "canary": canary}
    from apex_tpu_torch.checkpoint import ShardedCheckpointManager
    from apex_tpu_torch.serving.fleet.deploy import model_params_tree

    ShardedCheckpointManager(scratch, max_to_keep=1).save(
        1, model_params_tree(model))
    if spec.poison:
        from apex_tpu_torch.testing_faults import corrupt_checkpoint_weights

        corrupt_checkpoint_weights(scratch, 1)
    return {"checkpoint_dir": scratch, "step": 1, "canary": canary}


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
    # the fleet-level fault schedule: draining restarts at fixed offsets
    drains = sorted(scenario.fleet.drain_restarts) \
        if scenario.fleet is not None else []
    d = 0
    # the continuous-deployment schedule: one rollout at a fixed offset
    # (artifact materialized up front — a poisoned checkpoint must be
    # committed and fsck-green BEFORE the first drain)
    deploy_fired = scenario.deploy is None
    deploy_kwargs: Optional[Dict[str, Any]] = None
    scratch = None
    if scenario.deploy is not None:
        scratch = tempfile.TemporaryDirectory(prefix="apex-deploy-")
        deploy_kwargs = _prepare_deploy(scenario, model, scratch.name)

    def _deploy_active() -> bool:
        dep = getattr(sup, "deployment", None)
        return dep is not None and not dep.done

    def _autoscale_settling() -> bool:
        # after traffic drains, keep polling until the autoscaler has
        # retired back to min_replicas — an idle fleet always meets the
        # scale-down bands, so this converges (max_wall_s still guards)
        scaler = getattr(sup, "autoscaler", None)
        return (scaler is not None
                and len(sup.replicas) > scaler.config.min_replicas)

    autoscaling = getattr(sup, "autoscaler", None) is not None
    t0 = clock.now()
    i = 0
    try:
        while (i < len(schedule) or sup.inflight_count or d < len(drains)
               or not deploy_fired or _deploy_active()
               or _autoscale_settling()):
            now = clock.now() - t0
            if now > scenario.max_wall_s:
                run.aborted = True
                _abort(sup, scenario, registry, now)
                break
            while d < len(drains) and drains[d][0] <= now:
                at_s, replica = drains[d]
                d += 1
                try:
                    sup.drain_restart(replica)
                except RuntimeError as exc:
                    # another drain still in progress (or replica not
                    # active): skip rather than stack — N-1 capacity is
                    # the invariant; the skip is stamped into the log
                    log_event(_LOG, "drain_restart_skipped",
                              replica_id=replica, at_s=at_s,
                              reason=str(exc))
                    registry.event("drain_restart_skipped",
                                   replica_id=replica, at_s=at_s,
                                   reason=str(exc))
            if not deploy_fired and scenario.deploy.at_s <= now:
                deploy_fired = True
                try:
                    sup.deploy(**deploy_kwargs)
                except Exception as exc:
                    # pre-flight rejection (fsck failure) or a topology
                    # race: the fleet already stamped deploy_rejected
                    # when it could; the skip itself is logged too
                    log_event(_LOG, "deploy_skipped",
                              at_s=scenario.deploy.at_s, reason=str(exc))
                    registry.event("deploy_skipped",
                                   at_s=scenario.deploy.at_s,
                                   reason=str(exc))
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
            if sup.inflight_count or _deploy_active():
                sup.tick()
                run.ticks += 1
            elif i < len(schedule):
                gap = (t0 + schedule[i].at_s) - clock.now()
                if gap > 0:
                    clock.sleep(min(gap, _IDLE_SLEEP_S))
                if autoscaling:
                    # idle ticks keep the autoscaler's poll clock alive
                    # through traffic gaps (scale-down happens here)
                    sup.tick()
                    run.ticks += 1
            elif d < len(drains) or not deploy_fired \
                    or _autoscale_settling():
                # waiting on a scheduled drain/deploy, or for the
                # autoscaler to retire back to min_replicas
                clock.sleep(_IDLE_SLEEP_S)
                if autoscaling:
                    sup.tick()
                    run.ticks += 1
    finally:
        run.wall_s = clock.now() - t0
        if hasattr(sup, "replica_metrics"):
            # final fleet poll, stamped into the log before the
            # close-time snapshots so signals precede the counters they
            # must reconcile with
            run.signals = FleetMetrics(sup).signals()
            registry.emit_record({"kind": "signals", "wall": clock.wall(),
                                  "values": run.signals})
        sup.close()             # flushes the final counter snapshot
        if scratch is not None:
            scratch.cleanup()   # the deployed weights live in the fleet
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
