"""The port's ``ReplicaFleet`` against the port's single engine, on the CPU.

A 2-layer, 32-wide f32 GPT (its transformer weights scaled x4 so the
tokens do not echo the prompt) serves through a fleet of supervised
replicas; the reference is :class:`~apex_tpu_torch.serving.InferenceEngine`
serving the same requests alone (itself held to the JAX engine by
``tests/test_torch_gpt_serving.py`` and the serving tests). Held here:

- dispatch: arrivals spread over the replicas, every result carries its
  replica, the dispatch counters split exactly; cancel follows a request
  to its replica; an open breaker leaves the dispatch set, and
  ``FleetUnavailableError`` (a terminal ``rejected`` record) comes only
  when every breaker is open;
- draining restarts: a request migrated mid-decode by ``drain_restart``
  finishes on the peer with the single engine's tokens, greedy and
  sampled; without migration it finishes in place; one drain at a time;
  the one-token probe gates rejoining; the drained supervisor's KV pools
  are released before its replacement allocates; the service-time EWMA
  is carried;
- autoscale churn: ``add_replica``/``retire_replica`` sweeps leak no slot
  or page, retired ids never come back, a retired replica's work stays
  counted in the merged counters; one topology change at a time; the last
  active replica cannot retire; a burst scales a live fleet up and idle
  polls scale it back down, decisions reconciling with their counters;
- the brownout ladder on a live fleet: a standard-class backlog climbs
  it while the running batch slots are parked (they resume token-exact),
  the clamp rung bounds a late batch request's budget, and the drained
  fleet walks back to rung 0;
- a chaos sweep (random arrivals, per-replica decode failures and
  non-finite slots, cancellations, a drain): every request reaches
  exactly one terminal record and no replica leaks a slot or a page.
"""

import time

import numpy as np
import pytest
import torch

from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.observability import (FleetMetrics, InMemorySink,
                                          MetricsRegistry,
                                          check_span_conservation)
from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                    FleetConfig, FleetUnavailableError,
                                    InferenceEngine, ReplicaFleet, Request,
                                    SamplingParams, SchedulerConfig,
                                    SupervisorConfig)
from apex_tpu_torch.serving.fleet import (REPLICA_ACTIVE, REPLICA_DRAINING,
                                          REPLICA_PROBING, AutoscaleConfig,
                                          BrownoutConfig)
from apex_tpu_torch.serving.request import FINISH_REASONS
from apex_tpu_torch.serving.supervisor import BREAKER_OPEN
from apex_tpu_torch.testing_faults import ServingFaultInjector

SMALL = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
             vocab_size=64, max_position_embeddings=64)
MAX_LEN = 32


def tiny_model(seed=0, scale=4.0):
    """The tiny f32 GPT on the CPU, transformer weights scaled."""
    model = GPTModel(TransformerConfig(**SMALL, hidden_dropout=0.0,
                                       attention_dropout=0.0),
                     device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("transformer."):
                p.mul_(scale)
    return model


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the tiny model's ops gain nothing from threads, and beside busy
    # test workers an oversubscribed pool costs seconds a test
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=n).tolist() for n in lens]


def _sampling(sampled, i=0):
    return (SamplingParams(temperature=0.9, top_k=8, seed=101 + i)
            if sampled else SamplingParams())


def _engine_cfg(max_slots=2, max_queue=16, **kw):
    return EngineConfig(max_slots=max_slots, max_len=MAX_LEN,
                        scheduler=SchedulerConfig(max_queue=max_queue), **kw)


def _fleet(model, n=2, *, faults=None, fleet_cfg=None, supervisor=None,
           metrics=None, **kw):
    return ReplicaFleet(model, _engine_cfg(**kw), supervisor=supervisor,
                        metrics=metrics, faults=faults,
                        fleet=fleet_cfg or FleetConfig(n_replicas=n),
                        device="cpu")


def _single(model, requests):
    """The single engine's tokens for fresh copies of ``requests``."""
    fresh = [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                     sampling=r.sampling, eos_token=r.eos_token)
             for r in requests]
    with InferenceEngine(model, _engine_cfg(max_slots=4),
                         device="cpu") as eng:
        return [r.tokens for r in eng.serve(fresh)]


def _no_leaks(fleet):
    for r in fleet.replicas:
        eng = r.supervisor.engine
        eng.slots.check()
        assert eng.slots.free_count == fleet.config.max_slots
        if eng.pages is not None:
            eng.pages.check()           # refcounts conserved
            assert eng.pages.owned_count == 0   # no slot holds a page


# ---------------------------------------------------------------------------
# dispatch and admission


def test_fleet_validation(model):
    with pytest.raises(ValueError, match="n_replicas"):
        FleetConfig(n_replicas=0)
    with pytest.raises(ValueError, match="max_rebuild_probes"):
        FleetConfig(max_rebuild_probes=0)
    with pytest.raises(ValueError, match="prefix_affinity_weight"):
        FleetConfig(prefix_affinity_weight=1.0)
    with pytest.raises(ValueError, match="unknown replica ids"):
        _fleet(model, faults={5: ServingFaultInjector()})


def test_spreads_load_and_labels_results(model):
    sink = InMemorySink()
    reg = MetricsRegistry([sink])
    reqs = [Request(prompt=p, max_new_tokens=4, sampling=_sampling(i % 2, i))
            for i, p in enumerate(_prompts([4, 5, 3, 6], seed=11))]
    want = _single(model, reqs)
    with _fleet(model, metrics=reg) as fleet:
        results = fleet.serve(reqs)
    assert [r.finish_reason for r in results] == ["length"] * 4
    assert [r.tokens for r in results] == want
    assert {r.replica_id for r in results} == {0, 1}
    counters = reg.counters()
    assert counters["fleet_dispatches"] == 4
    assert counters["replica0_dispatches"] + \
        counters["replica1_dispatches"] == 4
    assert counters["requests_submitted"] == 4
    records = [r for r in sink.records if r.get("kind") == "request"]
    assert sorted(r["replica_id"] for r in records) == \
        sorted(r.replica_id for r in results)
    assert check_span_conservation(sink.records) == []


def test_sticky_cancel_follows_the_request(model):
    reqs = [Request(prompt=p, max_new_tokens=16)
            for p in _prompts([4, 4], seed=13)]
    with _fleet(model) as fleet:
        for r in reqs:
            fleet.submit(r)
        fleet.tick()
        assert fleet.cancel(reqs[1].request_id)
        while fleet.inflight_count:
            fleet.tick()
        assert fleet.completed[reqs[1].request_id].finish_reason == \
            "cancelled"
        assert fleet.completed[reqs[0].request_id].finish_reason == "length"
        assert not fleet.cancel(reqs[0].request_id)


def test_open_breaker_leaves_dispatch_set(model):
    inj = ServingFaultInjector(decode_raise_calls=range(0, 64))
    with _fleet(model, faults={0: inj},
                supervisor=SupervisorConfig(breaker_threshold=1,
                                            breaker_cooldown_s=60.0,
                                            max_restarts_per_request=1)) \
            as fleet:
        fleet.submit(Request(prompt=_prompts([4], seed=17)[0],
                             max_new_tokens=4))
        for _ in range(8):
            fleet.tick()
            if fleet.replicas[0].supervisor.breaker_state == BREAKER_OPEN:
                break
        assert fleet.replicas[0].supervisor.breaker_state == BREAKER_OPEN
        assert [r.replica_id for r in fleet.dispatch_set()] == [1]
        after = Request(prompt=_prompts([4], seed=19)[0], max_new_tokens=3)
        fleet.submit(after)
        while fleet.inflight_count:
            fleet.tick()
        res = fleet.completed[after.request_id]
        assert res.finish_reason == "length" and res.replica_id == 1
        assert res.tokens == _single(model, [after])[0]


def test_fleet_unavailable_when_all_replicas_open(model):
    reg = MetricsRegistry([InMemorySink()])
    inj = {i: ServingFaultInjector(decode_raise_calls=range(0, 64))
           for i in range(2)}
    with _fleet(model, faults=inj, metrics=reg,
                supervisor=SupervisorConfig(breaker_threshold=1,
                                            breaker_cooldown_s=60.0,
                                            max_restarts_per_request=1,
                                            max_engine_restarts=1)) as fleet:
        for p in _prompts([4, 4], seed=23):
            fleet.submit(Request(prompt=p, max_new_tokens=4))
        for _ in range(10):
            fleet.tick()
            if not fleet.dispatch_set():
                break
        assert not fleet.dispatch_set()
        shed = Request(prompt=_prompts([3], seed=29)[0], max_new_tokens=2)
        with pytest.raises(FleetUnavailableError, match="no dispatchable"):
            fleet.submit(shed)
        assert fleet.completed[shed.request_id].finish_reason == "rejected"
        guard = 0
        while fleet.inflight_count and guard < 50:
            fleet.tick()
            guard += 1
        assert not fleet.inflight_count
    counters = reg.counters()
    assert counters["requests_shed_fleet"] == 1
    assert counters["requests_submitted"] == 3
    assert sum(counters[f"requests_{r}"] for r in FINISH_REASONS) == 3


# ---------------------------------------------------------------------------
# draining restarts


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_migrated_request_is_token_exact(model, sampled):
    """Drain mid-generation: the request re-prefills on the peer from
    prompt + generated tokens, and the stitched stream equals the single
    engine's; the rebuilt replica rejoins with the carried EWMA."""
    sink = InMemorySink()
    reg = MetricsRegistry([sink])
    warm = [Request(prompt=p, max_new_tokens=3)
            for p in _prompts([4, 4], seed=31)]
    victims = [Request(prompt=p, max_new_tokens=10,
                       sampling=_sampling(sampled, i))
               for i, p in enumerate(_prompts([5, 7], seed=37))]
    want = _single(model, victims)
    with _fleet(model, metrics=reg) as fleet:
        fleet.serve(warm)
        for v in victims:
            fleet.submit(v)
        for _ in range(3):
            fleet.tick()
        assert not any(v.request_id in fleet.completed for v in victims)
        home = fleet._tracked[victims[0].request_id].replica_id
        carried = fleet.replicas[home].supervisor.service_estimate_s
        assert carried is not None
        old = fleet.replicas[home].supervisor
        fleet.drain_restart(home)
        # the drained supervisor's pools were dropped before the rebuild
        assert old.engine._caches is None and old.engine.model is None
        assert fleet.replicas[home].supervisor is not old
        floor = []
        while fleet.inflight_count:
            fleet.tick()
            floor.append(len(fleet.dispatch_set()))
        assert min(floor) >= fleet.n_replicas - 1
        got = [fleet.completed[v.request_id] for v in victims]
        assert [r.tokens for r in got] == want
        assert all(r.finish_reason == "length" for r in got)
        assert got[0].replica_id == 1 - home    # finished on the peer
        rebuilt = fleet._replica(home)
        assert rebuilt.state == REPLICA_ACTIVE
        assert rebuilt.supervisor.service_estimate_s is not None
        again = Request(prompt=_prompts([4], seed=41)[0], max_new_tokens=2)
        fleet.serve([again])
        assert fleet.completed[again.request_id].finish_reason == "length"
        _no_leaks(fleet)
    counters = reg.counters()
    assert counters["replica_drains"] == 1
    assert counters["replica_rebuilds"] == 1
    assert counters["requests_migrated"] >= 1
    assert counters["requests_migrated"] == sum(
        1 for r in sink.records if r.get("kind") == "event"
        and r["event"] == "request_migrated")
    assert check_span_conservation(sink.records) == []


def test_drain_without_migration_finishes_in_place(model):
    reg = MetricsRegistry([InMemorySink()])
    req = Request(prompt=_prompts([4], seed=43)[0], max_new_tokens=6,
                  sampling=_sampling(True, 3))
    want = _single(model, [req])
    with _fleet(model, metrics=reg,
                fleet_cfg=FleetConfig(n_replicas=2,
                                      migrate_on_drain=False)) as fleet:
        fleet.submit(req)
        fleet.tick()
        home = fleet._tracked[req.request_id].replica_id
        fleet.drain_restart(home)
        assert fleet.replicas[home].state == REPLICA_DRAINING
        while fleet.inflight_count:
            fleet.tick()
        res = fleet.completed[req.request_id]
        assert res.replica_id == home
        assert res.tokens == want[0]
        assert fleet.replicas[home].state == REPLICA_ACTIVE
    counters = reg.counters()
    assert counters["requests_migrated"] == 0
    assert counters["replica_rebuilds"] == 1


def test_one_drain_at_a_time(model):
    with _fleet(model, fleet_cfg=FleetConfig(n_replicas=2,
                                             migrate_on_drain=False,
                                             probe_on_rebuild=False)) \
            as fleet:
        req = Request(prompt=_prompts([4], seed=47)[0], max_new_tokens=8)
        fleet.submit(req)
        fleet.tick()
        home = fleet._tracked[req.request_id].replica_id
        fleet.drain_restart(home)
        with pytest.raises(RuntimeError, match="one.*at a time"):
            fleet.drain_restart(1 - home)
        with pytest.raises(RuntimeError, match="not active"):
            fleet.drain_restart(home)
        with pytest.raises(ValueError, match="no replica"):
            fleet.drain_restart(7)
        while fleet.inflight_count:
            fleet.tick()
        assert fleet.topology_busy is None


def test_probe_gates_rejoin(model):
    reg = MetricsRegistry([InMemorySink()])
    with _fleet(model, metrics=reg) as fleet:
        fleet.drain_restart(0)
        assert fleet.replicas[0].state == REPLICA_PROBING
        assert [r.replica_id for r in fleet.dispatch_set()] == [1]
        assert fleet.inflight_count == 1
        while fleet.inflight_count:
            fleet.tick()
        assert fleet.replicas[0].state == REPLICA_ACTIVE
    counters = reg.counters()
    assert counters["requests_submitted"] == 1
    assert counters["requests_length"] == 1


def test_service_estimate_seed_and_carry(model):
    sup = EngineSupervisor(model, _engine_cfg(max_slots=1), service_s=0.125,
                           device="cpu")
    assert sup.service_estimate_s == 0.125
    sup.close()
    with EngineSupervisor(model, _engine_cfg(max_slots=1),
                          device="cpu") as sup:
        sup.serve([Request(prompt=_prompts([4], seed=53)[0],
                           max_new_tokens=3)])
        before = sup.service_estimate_s
        assert before is not None
        sup._restart("test: forced rebuild")
        assert sup.service_estimate_s == before


def test_engine_factory_builds_every_incarnation(model):
    built = []

    def factory(m, config, **kw):
        built.append(kw["replica_id"])
        return InferenceEngine(m, config, **kw)

    fleet = ReplicaFleet(model, _engine_cfg(), device="cpu",
                         engine_factory=factory,
                         fleet=FleetConfig(n_replicas=2))
    with fleet:
        fleet.drain_restart(1)
        while fleet.inflight_count:
            fleet.tick()
    assert built == [0, 1, 1]


# ---------------------------------------------------------------------------
# autoscale churn


def test_scale_up_down_sweep_leaks_nothing(model):
    fleet = _fleet(model, fleet_cfg=FleetConfig(n_replicas=2,
                                                probe_on_rebuild=False))
    fm = FleetMetrics(fleet)
    with fleet:
        retired = []
        for i in range(3):
            rid = fleet.add_replica()
            fleet.router.note_dispatch(rid, (1, 2, 3))
            req = Request(prompt=_prompts([5], seed=60 + i)[0],
                          max_new_tokens=3)
            fleet.submit(req)
            fleet.retire_replica(rid)
            while fleet.inflight_count or \
                    any(r.replica_id == rid for r in fleet.replicas):
                fleet.tick()
            assert fleet.completed[req.request_id].finish_reason == "length"
            retired.append(rid)
        live = {r.replica_id for r in fleet.replicas}
        assert live == {0, 1}
        for rid in retired:
            assert rid not in fleet.router._resident
            assert rid not in fleet.replica_metrics
            assert rid in fleet.retired_replica_metrics
            assert rid not in fm.replica_counters()
            assert not any(f'replica="{rid}"' in k
                           for k in fm.labeled_gauges())
        assert fleet._next_replica_id == 2 + len(retired)
        signals = fm.signals()
        assert signals["replicas_total"] == 2
        assert signals["replicas_dispatchable"] == 2
        _no_leaks(fleet)


def test_retired_work_stays_counted(model):
    fleet = _fleet(model, n=1, fleet_cfg=FleetConfig(n_replicas=1,
                                                     probe_on_rebuild=False))
    fm = FleetMetrics(fleet)
    with fleet:
        rid = fleet.add_replica()
        for prompt in ([1, 2, 3], [4, 5, 6], [7, 8]):
            fleet.submit(Request(prompt=prompt, max_new_tokens=2))
        while fleet.inflight_count:
            fleet.tick()
        served = fleet.metrics.counters().get(f"replica{rid}_dispatches", 0)
        assert served > 0
        fleet.retire_replica(rid)
        while any(r.replica_id == rid for r in fleet.replicas):
            fleet.tick()
        merged = fm.merged_counters()
        parent = fleet.metrics.counters()
        for key in ("requests_submitted", "requests_length", "prefills",
                    "decode_steps"):
            assert merged[key] == parent[key], key
        assert fleet.retired_replica_metrics[rid].counters()[
            "requests_submitted"] > 0


def test_one_topology_change_at_a_time(model):
    with _fleet(model) as fleet:
        rid = fleet.add_replica()
        assert fleet.topology_busy == rid
        with pytest.raises(RuntimeError, match="one topology"):
            fleet.add_replica()
        with pytest.raises(RuntimeError, match="one topology"):
            fleet.retire_replica(0)
        while fleet.topology_busy is not None:
            fleet.tick()
        fleet.retire_replica(rid)
        while fleet.topology_busy is not None:
            fleet.tick()
        assert [r.replica_id for r in fleet.replicas] == [0, 1]


def test_last_active_replica_cannot_retire(model):
    with _fleet(model, n=1) as fleet:
        with pytest.raises(RuntimeError, match="last active"):
            fleet.retire_replica(0)


def test_burst_scales_up_then_idle_scales_down(model):
    fleet = ReplicaFleet(
        model, _engine_cfg(max_queue=32), fleet=FleetConfig(n_replicas=1),
        autoscale=AutoscaleConfig(min_replicas=1, max_replicas=2,
                                  poll_interval_s=0.01, cooldown_s=0.05,
                                  hysteresis_polls=2,
                                  scale_up_queue_per_replica=2.0),
        device="cpu")
    reqs = [Request(prompt=[1 + i % 8, 2, 3], max_new_tokens=3)
            for i in range(12)]
    want = _single(model, reqs)
    with fleet:
        for r in reqs:
            fleet.submit(r)
        while fleet.inflight_count:
            fleet.tick()
            time.sleep(0.003)
        assert [fleet.completed[r.request_id].tokens for r in reqs] == want
        actions = [a for _, a, _, _ in fleet.autoscaler.decisions]
        assert "up" in actions
        deadline = time.monotonic() + 30.0
        while len(fleet.replicas) > 1 and time.monotonic() < deadline:
            fleet.tick()
            time.sleep(0.005)
        assert len(fleet.replicas) == 1
        actions = [a for _, a, _, _ in fleet.autoscaler.decisions]
        assert "down" in actions
        counters = fleet.metrics.counters()
        assert counters["replica_scale_ups"] == actions.count("up")
        assert counters["replica_scale_downs"] == actions.count("down")
        _no_leaks(fleet)


def test_brownout_ladder_on_a_live_fleet(model):
    sink = InMemorySink()
    fleet = ReplicaFleet(
        model, _engine_cfg(max_queue=32), fleet=FleetConfig(n_replicas=1),
        metrics=MetricsRegistry([sink]),
        brownout=BrownoutConfig(poll_interval_s=0.001, queue_depth_high=3.0,
                                queue_depth_low=1.0, hot_polls=1,
                                cool_polls=1, clamp_max_new_tokens=2,
                                max_rung=3),
        device="cpu")
    prompts = _prompts([5] * 12, seed=71)
    batch = [Request(prompt=p, max_new_tokens=8,
                     sampling=SamplingParams(priority="batch"))
             for p in prompts[:2]]
    standard = [Request(prompt=p, max_new_tokens=4) for p in prompts[2:11]]
    late = Request(prompt=prompts[11], max_new_tokens=6,
                   sampling=SamplingParams(priority="batch"))
    want = _single(model, batch + standard + [late])
    with fleet:
        for r in batch:
            fleet.submit(r)
        fleet.tick()                    # both batch requests take a slot
        for r in standard:
            fleet.submit(r)
        rungs = []
        while fleet.brownout.rung < 3:
            fleet.tick()
            time.sleep(0.002)
            rungs.append(fleet.brownout.rung)
        fleet.submit(late)              # clamped at the clamp rung
        while fleet.inflight_count or fleet.brownout.rung:
            fleet.tick()
            time.sleep(0.002)
        got = [fleet.completed[r.request_id].tokens
               for r in batch + standard + [late]]
        _no_leaks(fleet)
    assert got[:-1] == want[:-1]                # parked ones resumed exact
    assert got[-1] == want[-1][:2]              # the clamped budget
    counters = fleet.metrics.counters()
    assert counters["requests_preempted"] >= 2
    assert counters["brownouts_escalated"] == 3
    assert counters["brownouts_recovered"] == 3
    trans = [(r["action"], r["rung"]) for r in sink.records
             if r.get("kind") == "brownout"]
    assert trans[:3] == [("escalate", 1), ("escalate", 2), ("escalate", 3)]


# ---------------------------------------------------------------------------
# chaos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_terminal_exactly_once_no_leaks(model, seed):
    rng = np.random.RandomState(100 + seed)
    faults = {
        0: ServingFaultInjector(
            decode_raise_calls={int(rng.randint(2, 12))},
            poison_decode={int(rng.randint(4, 16)):
                           (int(rng.randint(0, 2)), "nonfinite")}),
        1: ServingFaultInjector(decode_raise_calls={int(rng.randint(2, 12))}),
    }
    sink = InMemorySink()
    reg = MetricsRegistry([sink])
    submitted = []
    with _fleet(model, faults=faults, metrics=reg,
                supervisor=SupervisorConfig(max_restarts_per_request=3,
                                            breaker_threshold=3,
                                            breaker_cooldown_s=0.05)) \
            as fleet:
        drained = False
        for step in range(40):
            if rng.rand() < 0.6:
                req = Request(
                    prompt=rng.randint(0, 64,
                                       size=int(rng.randint(2, 9))).tolist(),
                    max_new_tokens=int(rng.randint(1, 8)),
                    sampling=(SamplingParams() if rng.rand() < 0.5
                              else SamplingParams(
                                  temperature=0.9,
                                  seed=int(rng.randint(0, 2**31)))))
                submitted.append(req)
                try:
                    fleet.submit(req)
                except Exception:
                    pass        # recorded terminally
            if submitted and rng.rand() < 0.1:
                fleet.cancel(submitted[int(rng.randint(len(submitted)))]
                             .request_id)
            if step == 15 and not drained:
                target = [r.replica_id for r in fleet.replicas
                          if r.state == REPLICA_ACTIVE]
                if target:
                    try:
                        fleet.drain_restart(target[0])
                        drained = True
                    except RuntimeError:
                        pass
            fleet.tick()
            assert sum(1 for r in fleet.replicas
                       if r.state in (REPLICA_DRAINING,
                                      REPLICA_PROBING)) <= 1
        guard = 0
        while fleet.inflight_count and guard < 400:
            fleet.tick()
            guard += 1
        assert not fleet.inflight_count
        for req in submitted:
            assert fleet.completed[req.request_id].finish_reason in \
                FINISH_REASONS
        _no_leaks(fleet)
    counters = reg.counters()
    terminal = sum(counters[f"requests_{r}"] for r in FINISH_REASONS)
    assert counters["requests_submitted"] == terminal
    records = [r for r in sink.records if r.get("kind") == "request"]
    assert len(records) == terminal
    assert len({r["request_id"] for r in records}) == terminal
