"""The port's canary deploys, on the CPU, against the port's single engine
and the JAX package's checkpoints and runner.

Held here:

- pre-flight: a byte-corrupt step (``corrupt_shard``) is rejected before
  any drain, as ``deploy_rejected``, and does not block the next deploy;
  an empty directory, a second concurrent deploy and an adapter deploy
  without a store raise JAX's errors; ``CanaryConfig`` rejects JAX's bad
  knobs;
- the deploy's tree: :func:`model_params_tree` is the JAX package's
  parameter tree, so a step the port writes for converted weights is byte
  for byte the step the JAX package's ``ShardedCheckpointManager`` writes
  for the JAX params, and a step the JAX package wrote deploys onto the
  port's fleet with the canary's weights bitwise ``convert``'s;
- a happy deploy of the fleet's own weights promotes every replica, and
  the tokens after it equal the tokens before;
- a deploy poisoned by ``corrupt_checkpoint_weights`` passes fsck and the
  canary's probe, errors in the canary window and rolls back: every
  arrival one terminal record, spans conserved, migrated requests keep
  their trace ids, the deploy records, events and counters reconcile, and
  the incumbent model's parameters are bitwise unchanged (the restore
  never writes them);
- an adapter canary is promoted and a poisoned one (NaN factors) rolled
  back and unloaded;
- slow tier: the JAX runner and the port's runner on ``fleet_smoke``,
  ``canary_rollback`` and ``traffic_ramp`` with converted weights: every
  request that ends ``length`` or ``eos`` in both has equal tokens.
"""

import copy
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from apex_tpu.checkpoint import ShardedCheckpointManager as JManager
from apex_tpu.loadtest import Scenario as JScenario
from apex_tpu.loadtest import run_scenario as jrun_scenario
from apex_tpu.loadtest.runner import build_model as jbuild_model
from apex_tpu.models import GPTModel as JGPT
from apex_tpu.models import TransformerConfig as JConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu_torch.checkpoint import (CheckpointCorruptionError,
                                       ShardedCheckpointManager)
from apex_tpu_torch.convert import load_jax_params, params_from_jax
from apex_tpu_torch.loadtest import Scenario, run_scenario
from apex_tpu_torch.lora import AdapterStore, random_adapter
from apex_tpu_torch.observability import (InMemorySink, MetricsRegistry,
                                          check_span_conservation)
from apex_tpu_torch.serving import (EngineConfig, FleetConfig,
                                    InferenceEngine, ReplicaFleet, Request,
                                    SamplingParams, SchedulerConfig)
from apex_tpu_torch.serving.fleet import (DEPLOY_CANARY, DEPLOY_COMPLETE,
                                          DEPLOY_DRAINING, DEPLOY_REJECTED,
                                          DEPLOY_ROLLED_BACK, DEPLOY_ROLLING,
                                          CanaryConfig, Deployment)
from apex_tpu_torch.serving.fleet.deploy import (checkpoint_template,
                                                 model_params_tree)
from apex_tpu_torch.testing_faults import (corrupt_checkpoint_weights,
                                           corrupt_shard)

from test_torch_fleet import SMALL, tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: deployment states during which the tests keep feeding live traffic
_FEEDING = (DEPLOY_ROLLING, DEPLOY_DRAINING, DEPLOY_CANARY)
CANARY = CanaryConfig(window_s=0.05, min_requests=2, max_window_s=15.0)


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


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


def _fleet(model, *, metrics=None, adapters=None, n=2):
    return ReplicaFleet(
        model, EngineConfig(max_slots=2, max_len=32,
                            scheduler=SchedulerConfig(max_queue=16)),
        metrics=metrics, adapters=adapters, fleet=FleetConfig(n_replicas=n),
        device="cpu")


def _save_step(root, model, step=1):
    directory = str(root)
    ShardedCheckpointManager(directory, max_to_keep=1).save(
        step, model_params_tree(model))
    return directory


def _drain(fleet, cap=20000):
    ticks = 0
    while fleet.inflight_count:
        fleet.tick()
        ticks += 1
        assert ticks < cap, "fleet failed to settle"


def _feed(fleet, dep, submitted, *, max_inflight=3, tokens=3,
          adapter_id=None, cap=60000):
    """Tick the deployment to its end, feeding live traffic while the
    rollout can use it."""
    rng = np.random.RandomState(1234)
    ticks = 0
    while not dep.done:
        fleet.tick()
        ticks += 1
        assert ticks < cap, f"deployment stuck in state {dep.state}"
        if dep.state in _FEEDING and fleet.inflight_count < max_inflight:
            submitted.append(fleet.submit(Request(
                prompt=rng.randint(1, 64, size=4).tolist(),
                max_new_tokens=tokens,
                sampling=SamplingParams(adapter_id=adapter_id))))
    _drain(fleet)
    return submitted


def _conservation_stream(registry, mem):
    """The log so far plus the counters as they stand (the registry
    writes its counter snapshot at close)."""
    return mem.records + [{"kind": "counters", "wall": time.time(),
                           "values": dict(registry.counters())}]


def _snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _bitwise(model, snap):
    return all(torch.equal(p, snap[n]) and p.dtype == snap[n].dtype
               for n, p in model.named_parameters())


def _greedy(fleet, prompt, n):
    rid = fleet.submit(Request(prompt=prompt, max_new_tokens=n))
    _drain(fleet)
    return fleet.completed[rid].tokens


def _single_greedy(model, prompt, n):
    with InferenceEngine(model, EngineConfig(max_slots=2, max_len=32),
                         device="cpu") as eng:
        return eng.serve([Request(prompt=prompt, max_new_tokens=n)])[0].tokens


# ---------------------------------------------------------------------------
# pre-flight


def test_exactly_one_target_required():
    with pytest.raises(ValueError, match="exactly one"):
        Deployment()
    with pytest.raises(ValueError, match="exactly one"):
        Deployment("/tmp/ckpt", adapter=("a", {}))


def test_byte_corrupt_checkpoint_rejected_before_any_drain(model, tmp_path):
    directory = _save_step(tmp_path / "ckpt", model)
    corrupt_shard(directory, 1, kind="bitflip")
    mem = InMemorySink()
    with _fleet(model, metrics=MetricsRegistry([mem])) as fleet:
        with pytest.raises(CheckpointCorruptionError):
            fleet.deploy(directory, step=1)
        assert fleet.deployment.state == DEPLOY_REJECTED
        assert fleet.deployment.done and fleet.topology_busy is None
        counters = fleet.metrics.counters()
        assert counters["deploys_rejected"] == 1
        assert counters["deploys_started"] == 0
        assert counters["replica_drains"] == 0
        assert [r["action"] for r in mem.records
                if r.get("kind") == "deploy"] == ["rejected"]
        assert any(r.get("event") == "deploy_rejected" for r in mem.records)
        good = _save_step(tmp_path / "good", model)
        assert not fleet.deploy(good, step=1).done


def test_preflight_errors(model, tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with _fleet(model) as fleet:
        with pytest.raises(CheckpointCorruptionError,
                           match="no committed step"):
            fleet.deploy(str(empty))
        assert fleet.deployment.state == DEPLOY_REJECTED
        with pytest.raises(ValueError, match="AdapterStore"):
            fleet.deploy(adapter=("t", {}))
        directory = _save_step(tmp_path / "ckpt", model)
        fleet.deploy(directory, step=1)
        with pytest.raises(RuntimeError, match="already"):
            fleet.deploy(directory, step=1)
    with pytest.raises(ValueError, match="window_s"):
        CanaryConfig(window_s=0.0)
    with pytest.raises(ValueError, match="max_window_s"):
        CanaryConfig(window_s=1.0, max_window_s=0.5)
    with pytest.raises(ValueError, match="max_error_rate"):
        CanaryConfig(max_error_rate=1.5)


# ---------------------------------------------------------------------------
# the deploy's tree against the JAX package's


def _jax_pair():
    jm = JGPT(JConfig(**SMALL, hidden_dropout=0.0, attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(0))
    tm = tiny_model(scale=1.0)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def test_port_step_is_the_jax_step_byte_for_byte(tmp_path):
    _, params, tm = _jax_pair()
    JManager(str(tmp_path / "jax"), max_to_keep=1).save(1, params)
    _save_step(tmp_path / "port", tm)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)
    # the restore target shares no storage with the live model
    live = {p.data_ptr() for p in tm.parameters()}
    leaves = jax.tree.leaves(checkpoint_template(tm),
                             is_leaf=torch.is_tensor)
    assert len(leaves) == len(jax.tree.leaves(params))
    assert not live & {t.data_ptr() for t in leaves}


def test_jax_written_step_deploys_onto_the_port_fleet(model, tmp_path):
    """A step the JAX package's manager wrote from a JAX GPT's params
    deploys onto the port's fleet (another set of weights): the canary's
    model holds ``convert``'s weights bitwise and serves the converted
    model's tokens, while the incumbent stays as it was."""
    _, params, tm = _jax_pair()
    directory = str(tmp_path / "jax")
    JManager(directory, max_to_keep=1).save(1, params)
    want = params_from_jax(jax.tree.map(np.asarray, params))
    snap = _snapshot(model)
    with _fleet(model) as fleet:
        dep = fleet.deploy(directory, canary=CANARY)
        assert dep.checkpoint_step == 1
        while dep.state != DEPLOY_CANARY:
            fleet.tick()
        canary = fleet._replica_models[dep.canary_replica]
        assert canary is not model
        got = dict(canary.named_parameters())
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert fleet._replica(dep.canary_replica).supervisor.engine.model \
            is canary
        prompt = [5, 6, 7, 8]
        sup = fleet._replica(dep.canary_replica).supervisor
        rid = sup.submit(Request(prompt=prompt, max_new_tokens=4))
        while rid not in sup.completed:
            sup.tick()
        assert sup.completed[rid].tokens == _single_greedy(tm, prompt, 4)
    assert _bitwise(model, snap)


# ---------------------------------------------------------------------------
# rollouts


def test_happy_deploy_promotes_every_replica(model, tmp_path):
    directory = _save_step(tmp_path / "ckpt", model)
    mem = InMemorySink()
    registry = MetricsRegistry([mem])
    prompt = [5, 6, 7, 8]
    with _fleet(model, metrics=registry) as fleet:
        before = _greedy(fleet, prompt, 4)
        ids = [fleet.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=2))
               for _ in range(4)]
        dep = fleet.deploy(directory, step=1, canary=CANARY)
        _feed(fleet, dep, ids)
        assert dep.state == DEPLOY_COMPLETE
        assert dep.promoted == [0, 1]
        assert [s["pass"] for s in dep.scores] == [True, True]
        counters = fleet.metrics.counters()
        assert counters["deploys_started"] == 1
        assert counters["deploys_completed"] == 1
        assert counters["canary_promotions"] == 2
        assert counters["deploys_rolled_back"] == 0
        records = [r for r in mem.records if r.get("kind") == "request"
                   and r["request_id"] in set(ids)]
        assert len(records) == len(ids)
        assert check_span_conservation(
            _conservation_stream(registry, mem)) == []
        # the deployed model is the fleet's baseline now, with no override
        assert fleet._model is not model and not fleet._replica_models
        assert all(r.supervisor.engine.model is fleet._model
                   for r in fleet.replicas)
        assert _greedy(fleet, prompt, 4) == before == \
            _single_greedy(model, prompt, 4)


def test_poisoned_deploy_rolls_back_and_leaves_the_incumbent_bitwise(
        model, tmp_path):
    directory = _save_step(tmp_path / "ckpt", model)
    corrupt_checkpoint_weights(directory, 1)
    ShardedCheckpointManager(directory).verify_step(1, deep=True)  # green
    snap = _snapshot(model)
    mem = InMemorySink()
    registry = MetricsRegistry([mem])
    prompt = [5, 6, 7, 8]
    with _fleet(model, metrics=registry) as fleet:
        ids = [fleet.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=3))
               for _ in range(4)]
        dep = fleet.deploy(directory, step=1, canary=CANARY)
        assert dep.state == DEPLOY_ROLLING
        probes = []
        while dep.state != DEPLOY_CANARY:
            fleet.tick()
            rep = fleet._replica(dep.canary_replica or 0)
            if rep.probe_id is not None:
                probes.append(rep.probe_id)
        canary = fleet._replica(dep.canary_replica)
        probe = canary.supervisor.completed[probes[-1]]
        assert probe.finish_reason == "length"      # argmax of NaN logits
        assert not all(torch.isfinite(p).all() for p in
                       fleet._replica_models[dep.canary_replica]
                       .parameters())
        _feed(fleet, dep, ids)
        assert dep.state == DEPLOY_ROLLED_BACK
        assert dep.rollback_reason == "error_rate"
        assert dep.promoted == []
        assert dep.scores[-1]["pass"] is False and dep.scores[-1]["errors"]
        counters = fleet.metrics.counters()
        assert counters["deploys_started"] == 1
        assert counters["deploys_rolled_back"] == 1
        assert counters["deploys_completed"] == 0
        assert counters["canary_promotions"] == 0
        events = [r["event"] for r in mem.records if r.get("kind") == "event"
                  and r["event"].startswith("deploy_")]
        assert events == ["deploy_start", "deploy_rollback"]
        assert [r["action"] for r in mem.records
                if r.get("kind") == "deploy"] == ["start", "rollback"]
        idset = set(ids)
        records = [r for r in mem.records if r.get("kind") == "request"
                   and r["request_id"] in idset]
        assert len(records) == len(ids)
        assert {r["finish_reason"] for r in records} >= {"error"}
        assert check_span_conservation(
            _conservation_stream(registry, mem)) == []
        tids = {}
        for s in mem.records:
            if s.get("kind") == "span" and s.get("request_id") in idset:
                tids.setdefault(s["request_id"], set()).add(s["trace_id"])
        assert all(tids[r["request_id"]] == {r["trace_id"]}
                   for r in records)
        assert not fleet._replica_models and fleet._model is model
        assert all(r.supervisor.engine.model is model
                   for r in fleet.replicas)
        assert _greedy(fleet, prompt, 4) == _single_greedy(model, prompt, 4)
    assert _bitwise(model, snap)


def test_adapter_canary_promote_then_poisoned_rollback(model):
    store = AdapterStore(model.config, 4, max_adapters=4, device="cpu")
    with _fleet(model, adapters=store) as fleet:
        good = random_adapter(model.config, 4,
                              torch.Generator().manual_seed(3), device="cpu")
        dep = fleet.deploy(adapter=("tenant-x", good), canary=CANARY)
        assert "tenant-x" in store
        _feed(fleet, dep, [], tokens=2, adapter_id="tenant-x")
        assert dep.state == DEPLOY_COMPLETE and "tenant-x" in store
        bad = {t: {k: v * float("nan") for k, v in f.items()}
               for t, f in random_adapter(
                   model.config, 4, torch.Generator().manual_seed(4),
                   device="cpu").items()}
        dep2 = fleet.deploy(adapter=("tenant-bad", bad), canary=CANARY)
        _feed(fleet, dep2, [], tokens=2, adapter_id="tenant-bad")
        assert dep2.state == DEPLOY_ROLLED_BACK
        assert dep2.rollback_reason == "error_rate"
        assert "tenant-bad" not in store and "tenant-x" in store
        counters = fleet.metrics.counters()
        assert counters["deploys_started"] == 2
        assert counters["deploys_completed"] == 1
        assert counters["canary_promotions"] == 1
        assert counters["deploys_rolled_back"] == 1


# ---------------------------------------------------------------------------
# slow tier: the JAX runner and the port's on the committed fleet scenarios


@pytest.mark.slow
@pytest.mark.parametrize("name", ["fleet_smoke", "canary_rollback",
                                  "traffic_ramp"])
def test_fleet_scenario_tokens_equal_jax_runner(name):
    path = os.path.join(REPO, "benchmarks", "scenarios", f"{name}.json")
    with open(path) as f:
        d = json.load(f)
    spec = Scenario.from_dict(copy.deepcopy(d)).model
    jm, params = jbuild_model(JScenario.from_dict(copy.deepcopy(d)).model)
    from apex_tpu_torch.loadtest import build_model

    tm = build_model(spec, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    jrun = jrun_scenario(JScenario.from_dict(copy.deepcopy(d)), model=jm,
                         params=params)
    start = time.perf_counter()
    run = run_scenario(Scenario.from_dict(copy.deepcopy(d)), model=tm)
    assert time.perf_counter() - start < d["max_wall_s"]
    assert not run.aborted and not jrun.aborted
    ok = ("length", "eos")
    pairs = [(run.results[s.request.request_id],
              jrun.results[js.request.request_id])
             for s, js in zip(run.schedule, jrun.schedule)]
    both = [(a.tokens, b.tokens) for a, b in pairs
            if a.finish_reason in ok and b.finish_reason in ok]
    assert both and all(a == b for a, b in both)
    assert check_span_conservation(run.records) == []
