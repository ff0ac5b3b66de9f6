"""The port's ``loadtest`` against the JAX package's, on the CPU.

Held here:

- scenarios: dicts built in code, one mirroring each committed scenario
  and each block of the schema (``fleet``, ``autoscale``, ``deploy`` of
  both kinds, ``sentinel``, ``recorder``, ``quotas``, ``brownout``, the
  fault schedule, the supervisor knobs, the LoRA knobs, every phase
  knob), parse and ``to_dict`` to what JAX's ``Scenario`` gives; the same
  bad knobs are rejected with the same error;
- schedules: the generator's schedule equals JAX's request for request
  (arrival, phase, prompt, budgets, deadline, sampling, adapter,
  priority);
- a tiny scenario runs end to end through ``python -m
  apex_tpu_torch.loadtest`` on the CPU: every request terminal, its spans
  conserved, ``--from-log`` re-scoring to the same numbers, ``--check``
  exiting 3 without a baseline entry and 0 after ``--update-baseline``;
- the nine one-engine scenarios (``multi_tenant``'s LoRA adapters among
  them) build one ``EngineSupervisor``; ``multi_tenant``'s schedule
  carries JAX's adapter ids request for request;
- every fleet block runs on the CPU port: ``fleet_smoke``,
  ``canary_rollback``, ``latency_drift``, ``traffic_ramp`` and
  ``noisy_neighbor`` as committed under ``benchmarks/scenarios``, and the
  ``brownout_ladder`` dict: every arrival one terminal record, spans
  conserved, the fleet, deploy, autoscale, brownout and anomaly records
  reconciling with their counters key for key, the JAX package's monitor
  folding the log into the port's report, and each scenario's own
  outcome (the drain, the rollback, one bundle per anomaly up to the
  recorder's one, the ramp settled back to one replica, the quota sheds with undegraded
  neighbours);
- the engine's telemetry repair: for the same requests and converted
  weights, the port's engine writes the JAX engine's span timelines
  (``queued``, one ``prefill`` span a chunk, ``decode``) and
  ``request_tokens_per_s`` observations, monolithic and chunked;
- slow tier: the same tiny scenario through JAX's runner and the port's,
  converted f32 weights: equal tokens for every request; and
  ``multi_tenant`` with converted weights and converted adapters.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from apex_tpu.loadtest import Scenario as JScenario
from apex_tpu.loadtest import TrafficGenerator as JGenerator
from apex_tpu.loadtest import run_scenario as jrun_scenario
from apex_tpu.loadtest.runner import build_model as jbuild_model
from apex_tpu.lora import AdapterStore as JStore
from apex_tpu.lora import random_adapter as jrandom_adapter
from apex_tpu.observability import InMemorySink as JSink
from apex_tpu.observability import build_report as jbuild_report
from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JEngineConfig
from apex_tpu.serving import InferenceEngine as JEngine
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import SamplingParams as JSampling
from apex_tpu_torch.convert import adapter_from_jax, load_jax_params
from apex_tpu_torch.loadtest import Scenario, TrafficGenerator, build_model, \
    run_scenario
from apex_tpu_torch.loadtest.__main__ import main as cli_main
from apex_tpu_torch.loadtest.runner import _build_serving
from apex_tpu_torch.lora import AdapterStore
from apex_tpu_torch.observability import (InMemorySink, MetricsRegistry,
                                          build_report,
                                          check_span_conservation,
                                          read_records)
from apex_tpu_torch.serving import EngineConfig, EngineSupervisor, \
    InferenceEngine, Request, SamplingParams

from chip_smoke import fleet_log_problems

SCENARIO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "scenarios")
MODEL = {"num_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
         "vocab_size": 64, "max_position_embeddings": 64, "param_seed": 0}
SLO = {"ttft_p99_s": 60.0, "tpot_p99_s": 10.0, "latency_p99_s": 120.0,
       "goodput": 0.99, "error_budget": 0.0}
WARMUP = {"name": "warmup", "n_requests": 4, "rate_rps": 50.0,
          "prompt_lens": {"4": 1}, "max_new_tokens": {"3": 1}}
STEADY = {"name": "steady", "n_requests": 20, "rate_rps": 200.0,
          "prompt_lens": {"4": 2, "8": 2, "12": 1},
          "max_new_tokens": {"3": 1, "5": 2, "8": 1},
          "greedy_fraction": 0.5, "temperatures": [0.7, 1.0],
          "top_ks": [0, 8]}
SMALL_ENGINE = {"max_slots": 4, "max_len": 32, "max_queue": 32,
                "max_prefills_per_tick": 2}
LORA_ENGINE = {"max_slots": 4, "max_len": 48, "max_queue": 32,
               "max_prefills_per_tick": 2, "page_size": 4, "lora_rank": 4,
               "lora_adapters": 3}


def _sc(name, seed, phases, engine=None, **blocks):
    d = {"name": name, "seed": seed, "model": dict(MODEL),
         "engine": dict(engine or SMALL_ENGINE), "phases": phases,
         "slo": dict(SLO), "tolerance": 0.5, "max_wall_s": 300.0}
    d.update(blocks)
    return d


#: one dict per committed scenario (the same blocks and knobs), plus the
#: blocks no committed scenario uses (brownout, an adapter deploy)
SCENARIOS = {
    "smoke": _sc("smoke", 7, [WARMUP, STEADY]),
    "bimodal_burst": _sc(
        "bimodal_burst", 37,
        [WARMUP,
         {"name": "interactive_steady", "n_requests": 12, "rate_rps": 200.0,
          "prompt_lens": {"4": 2, "8": 1}, "max_new_tokens": {"8": 2,
                                                             "12": 1},
          "greedy_fraction": 0.5, "temperatures": [0.7, 1.0],
          "top_ks": [0, 8]},
         {"name": "long_prompt_burst", "n_requests": 8, "rate_rps": 400.0,
          "prompt_lens": {"48": 1, "56": 1, "6": 2},
          "max_new_tokens": {"4": 1, "8": 1}, "greedy_fraction": 0.5,
          "temperatures": [0.7], "top_ks": [8]}],
        engine={"max_slots": 8, "max_len": 64, "max_queue": 64,
                "max_prefills_per_tick": 2, "kv_layout": "paged",
                "page_size": 8, "n_pages": 48, "prefill_token_budget": 16}),
    "canary_rollback": _sc(
        "canary_rollback", 37,
        [WARMUP, dict(STEADY, rate_rps=8.0),
         {"name": "tail", "n_requests": 24, "rate_rps": 4.0,
          "prompt_lens": {"4": 2, "8": 1},
          "max_new_tokens": {"4": 1, "6": 1}}],
        fleet={"n_replicas": 2},
        deploy={"at_s": 2.0, "kind": "checkpoint", "poison": True,
                "canary": {"window_s": 0.5, "min_requests": 3,
                           "max_window_s": 20.0, "max_error_rate": 0.0}}),
    "crash_recovery": _sc(
        "crash_recovery", 13,
        [{"name": "steady", "n_requests": 20, "rate_rps": 100.0,
          "prompt_lens": {"4": 2, "8": 1},
          "max_new_tokens": {"4": 1, "6": 2, "8": 1}}],
        supervisor={"max_restarts_per_request": 6, "breaker_threshold": 3,
                    "breaker_cooldown_s": 0.25, "hung_tick_s": 5.0},
        faults={"decode_raise_calls": [8], "decode_hang": {"20": 6.0},
                "prefill_raise_calls": [3],
                "poison_decode": {"12": [1, "nonfinite"]}}),
    "fleet_smoke": _sc("fleet_smoke", 11, [WARMUP, STEADY],
                       fleet={"n_replicas": 2, "drain_restarts": [
                           {"at_s": 2.0, "replica": 0}]}),
    "latency_drift": _sc(
        "latency_drift", 37, [WARMUP, STEADY],
        fleet={"n_replicas": 2},
        sentinel={"poll_interval_s": 0.02, "warmup_polls": 5,
                  "ewma_alpha": 0.02, "z_threshold": 4.0,
                  "hysteresis_polls": 2, "cooldown_s": 60.0,
                  "min_abs_dev": 2.0, "snapshot_every_polls": 5,
                  "signals": ["queue_depth"]},
        recorder={"events_capacity": 128, "records_capacity": 192,
                  "gauges_capacity": 48, "max_bundles": 1},
        faults={"decode_hang": {str(i): 0.3 for i in range(150, 160)}}),
    "long_context": _sc(
        "long_context", 23, [WARMUP],
        engine={"max_slots": 8, "max_len": 64, "max_queue": 64,
                "max_prefills_per_tick": 2, "kv_layout": "paged",
                "page_size": 8, "n_pages": 32}),
    "multi_tenant": _sc(
        "multi_tenant", 23,
        [dict(STEADY, name="tenant_mix", n_requests=16,
              prompt_lens={"8": 2, "12": 1},
              max_new_tokens={"6": 2, "10": 1},
              adapter_mix={"0": 30, "1": 25, "2": 25, "base": 20})],
        engine=LORA_ENGINE),
    "noisy_neighbor": _sc(
        "noisy_neighbor", 31,
        [dict(STEADY, name="neighbors", n_requests=30,
              prompt_lens={"8": 2, "12": 1},
              max_new_tokens={"5": 2, "8": 1},
              adapter_mix={"0": 60, "1": 15, "2": 15, "base": 10})],
        engine=LORA_ENGINE, fleet={"n_replicas": 1},
        quotas={"tenants": {"0": {"rate_rps": 1.0, "burst": 2,
                                  "max_inflight": 2}}}),
    "overload": _sc(
        "overload", 11,
        [{"name": "steady", "n_requests": 8, "rate_rps": 20.0,
          "prompt_lens": {"4": 2, "8": 1},
          "max_new_tokens": {"4": 1, "6": 1}},
         {"name": "burst", "n_requests": 48, "rate_rps": 2000.0,
          "prompt_lens": {"4": 2, "8": 2, "12": 1},
          "max_new_tokens": {"4": 2, "8": 1}, "deadline_fraction": 1.0,
          "deadline_min_s": 5.0, "deadline_max_s": 10.0}],
        engine=dict(SMALL_ENGINE, max_queue=8, max_prefills_per_tick=1),
        supervisor={"shed_deadlines": True, "service_time_alpha": 0.3}),
    "priority_storm": _sc(
        "priority_storm", 29,
        [{"name": "storm", "priority": "batch", "n_requests": 16,
          "rate_rps": 400.0, "prompt_lens": {"8": 1},
          "max_new_tokens": {"10": 1, "14": 1}, "greedy_fraction": 0.5,
          "temperatures": [0.8, 1.0], "top_ks": [0, 8]},
         {"name": "interactive", "priority": "interactive",
          "n_requests": 12, "rate_rps": 20.0,
          "prompt_lens": {"4": 1, "8": 1},
          "max_new_tokens": {"4": 2, "6": 1}, "greedy_fraction": 0.5,
          "temperatures": [0.7], "top_ks": [0, 8], "eos_token": 5}],
        engine={"max_slots": 2, "max_len": 48, "max_queue": 64,
                "max_prefills_per_tick": 1, "page_size": 4},
        slo=dict(SLO, goodput_interactive=1.0)),
    "shared_prefix": _sc(
        "shared_prefix", 11,
        [dict(STEADY, n_requests=24, prompt_lens={"26": 2, "28": 2,
                                                  "30": 1},
              max_new_tokens={"4": 2, "6": 1}, shared_prefix_len=24)],
        engine={"max_slots": 4, "max_len": 48, "max_queue": 32,
                "max_prefills_per_tick": 2, "page_size": 4,
                "prefix_cache": True, "prefix_lru_capacity": 8}),
    "spec_decode": _sc(
        "spec_decode", 17,
        [{"name": "steady", "n_requests": 16, "rate_rps": 200.0,
          "prompt_lens": {"16": 2, "20": 1},
          "max_new_tokens": {"8": 2, "12": 1}, "greedy_fraction": 1.0,
          "prompt_period": 4}],
        engine={"max_slots": 4, "max_len": 48, "max_queue": 32,
                "max_prefills_per_tick": 2, "page_size": 4,
                "kv_dtype": "int8", "speculation": 3}),
    "traffic_ramp": _sc(
        "traffic_ramp", 31,
        [WARMUP, dict(STEADY, name="ramp", n_requests=24),
         {"name": "ebb", "n_requests": 8, "rate_rps": 2.0,
          "prompt_lens": {"4": 1}, "max_new_tokens": {"3": 1}}],
        engine=dict(SMALL_ENGINE, max_slots=2, max_queue=48),
        fleet={"n_replicas": 1},
        autoscale={"min_replicas": 1, "max_replicas": 2,
                   "poll_interval_s": 0.1, "cooldown_s": 1.0,
                   "hysteresis_polls": 2, "scale_up_queue_per_replica": 3.0,
                   "scale_down_queue_per_replica": 0.5,
                   "scale_down_slot_occupancy": 0.3}),
    "brownout_ladder": _sc(
        "brownout_ladder", 5,
        [dict(STEADY, priority="standard",
              deadline_fraction=0.5, deadline_min_s=2.0,
              deadline_max_s=4.0)],
        fleet={"n_replicas": 1},
        brownout={"poll_interval_s": 0.1, "queue_depth_high": 6.0,
                  "queue_depth_low": 1.0, "hot_polls": 3,
                  "cool_polls": 2, "clamp_max_new_tokens": 4,
                  "max_rung": 3}),
    "adapter_canary": _sc(
        "adapter_canary", 3,
        [dict(STEADY, adapter_mix={"0": 1, "base": 1})],
        engine=LORA_ENGINE, fleet={"n_replicas": 2},
        deploy={"at_s": 1.0, "kind": "adapter", "adapter_id": "canary",
                "canary": {"window_s": 0.5, "min_requests": 2}}),
}

#: the scenarios one engine runs whole
ONE_ENGINE = ("smoke", "bimodal_burst", "crash_recovery", "long_context",
              "multi_tenant", "overload", "priority_storm", "shared_prefix",
              "spec_decode")


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _both(d):
    return (Scenario.from_dict(copy.deepcopy(d)),
            JScenario.from_dict(copy.deepcopy(d)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_parses_and_round_trips_like_jax(name):
    port, ref = _both(SCENARIOS[name])
    assert port.to_dict() == ref.to_dict()
    assert port.total_requests == ref.total_requests
    again, _ = _both(port.to_dict())
    assert again.to_dict() == port.to_dict()
    assert json.dumps(port.to_dict(), sort_keys=True) == \
        json.dumps(ref.to_dict(), sort_keys=True)


def _phase(d, **kw):
    d["phases"][0].update(kw)


def _engine(d, **kw):
    d["engine"].update(kw)


#: (name, edit of a copy of the smoke dict) — each a knob both reject
BAD = {
    "unknown_key": lambda d: d.update(bogus=1),
    "no_phases": lambda d: d.update(phases=[]),
    "negative_tolerance": lambda d: d.update(tolerance=-0.1),
    "unknown_phase_key": lambda d: _phase(d, bogus=1),
    "zero_rate": lambda d: _phase(d, rate_rps=0.0),
    "zero_weight": lambda d: _phase(d, prompt_lens={"4": 0}),
    "empty_mix": lambda d: _phase(d, max_new_tokens={}),
    "budget_past_max_len": lambda d: _phase(d, prompt_lens={"30": 1},
                                            max_new_tokens={"8": 1}),
    "unknown_priority": lambda d: _phase(d, priority="urgent"),
    "negative_period": lambda d: _phase(d, prompt_period=-1),
    "shared_prefix_past_prompt": lambda d: _phase(d, shared_prefix_len=5),
    "adapter_mix_without_lora": lambda d: _phase(d, adapter_mix={"0": 1}),
    "unknown_supervisor_knob": lambda d: d.update(
        supervisor={"bogus": 1}),
    "unknown_slo_metric": lambda d: d.update(slo={"p42": 1.0}),
    "bad_kv_layout": lambda d: _engine(d, kv_layout="dense"),
    "bad_kv_dtype": lambda d: _engine(d, kv_dtype="fp8"),
    "speculation_one": lambda d: _engine(d, speculation=1),
    "int8_flat": lambda d: _engine(d, kv_dtype="int8", kv_layout="flat"),
    "lora_rank_without_adapters": lambda d: _engine(d, lora_rank=4),
    "bad_fault_call": lambda d: d.update(
        faults={"decode_raise_calls": ["third"]}),
    "autoscale_without_fleet": lambda d: d.update(
        autoscale={"min_replicas": 1}),
    "autoscale_band": lambda d: d.update(
        fleet={"n_replicas": 3}, autoscale={"min_replicas": 1,
                                            "max_replicas": 2}),
    "deploy_without_fleet": lambda d: d.update(deploy={"at_s": 1.0}),
    "deploy_bad_kind": lambda d: d.update(
        fleet={"n_replicas": 2}, deploy={"at_s": 1.0, "kind": "binary"}),
    "sentinel_unknown_key": lambda d: d.update(
        fleet={"n_replicas": 2}, sentinel={"bogus": 1}),
    "recorder_unknown_key": lambda d: d.update(recorder={"bogus": 1}),
    "quotas_without_fleet": lambda d: d.update(
        quotas={"tenants": {"0": {"rate_rps": 1.0}}}),
    "brownout_unknown_key": lambda d: d.update(
        fleet={"n_replicas": 1}, brownout={"bogus": 1}),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_knob_rejected_like_jax(name):
    d = copy.deepcopy(SCENARIOS["smoke"])
    BAD[name](d)
    errors = []
    for cls in (Scenario, JScenario):
        with pytest.raises(Exception) as info:
            cls.from_dict(copy.deepcopy(d))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def _signature(sched):
    return [(s.at_s, s.signature()) for s in sched]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_schedule_equals_jax_request_for_request(name):
    port, ref = _both(SCENARIOS[name])
    mine = TrafficGenerator(port).schedule()
    want = JGenerator(ref).schedule()
    assert len(mine) == port.total_requests
    assert _signature(mine) == _signature(want)
    assert [type(s.request) for s in mine] == [Request] * len(mine)


@pytest.mark.parametrize("name", ONE_ENGINE)
def test_one_engine_scenarios_are_ported(name):
    scenario = Scenario.from_dict(copy.deepcopy(SCENARIOS[name]))
    model = build_model(scenario.model, device="cpu")
    sup = _build_serving(scenario, model, MetricsRegistry())
    assert type(sup) is EngineSupervisor
    sup.close()


def test_multi_tenant_schedule_carries_jax_adapters():
    port, ref = _both(SCENARIOS["multi_tenant"])
    mine = TrafficGenerator(port).schedule()
    want = JGenerator(ref).schedule()
    ids = [s.request.sampling.adapter_id for s in mine]
    assert ids == [s.request.sampling.adapter_id for s in want]
    assert set(ids) == {"0", "1", "2", None}
    assert [(s.at_s, s.request.prompt, s.request.sampling.seed,
             s.request.sampling.temperature) for s in mine] == \
        [(s.at_s, s.request.prompt, s.request.sampling.seed,
          s.request.sampling.temperature) for s in want]


def _fleet_smoke_outcome(run, counters):
    assert counters["replica_drains"] == 1
    assert counters["replica_rebuilds"] == 1


def _canary_rollback_outcome(run, counters):
    assert counters["deploys_started"] == 1
    assert counters["deploys_rolled_back"] == 1
    assert counters["deploys_completed"] == 0
    assert counters["requests_error"] >= 1     # the canary's window


def _latency_drift_outcome(run, counters):
    # the anomaly is the run's only incident-class event, and the
    # recorder keeps one bundle (whether the hang band lands in the surge
    # is the host's timing; test_torch_fleet_controllers.py holds the
    # sentinel's firing on recorded signals)
    assert counters["anomalies_total"] == counters["anomalies_queue_depth"]
    assert len(run.bundles) == len(run.bundle_paths) == \
        min(1, counters["anomalies_total"])


def _traffic_ramp_outcome(run, counters):
    # whether the ramp outruns two 0.1 s polls depends on the host's
    # speed; the runner settles back to min_replicas either way
    # (tests/test_torch_fleet.py scales a live fleet up and down)
    assert counters["replica_scale_ups"] == counters["replica_scale_downs"]
    assert run.signals["replicas_total"] == 1


def _noisy_neighbor_outcome(run, counters):
    assert counters["requests_shed_quota"] > 0
    neighbours = {k: v for k, v in run.slo_by_adapter.items() if k != "0"}
    assert neighbours and all(m["goodput"] == 1.0
                              for m in neighbours.values())


def _brownout_ladder_outcome(run, counters):
    # on the CPU port the tiny model drains the 0.1 s burst within the
    # ladder's three hot polls; tests/test_torch_fleet.py climbs it
    assert counters["brownouts_escalated"] >= counters["brownouts_recovered"]
    assert "brownouts_escalated" in counters and \
        run.signals["replicas_total"] == 1


#: the fleet scenarios: the committed file (or the dict above), and what
#: each run must show besides conservation and reconciliation
FLEET_RUNS = {
    "fleet_smoke": ("fleet_smoke.json", _fleet_smoke_outcome),
    "canary_rollback": ("canary_rollback.json", _canary_rollback_outcome),
    "latency_drift": ("latency_drift.json", _latency_drift_outcome),
    "traffic_ramp": ("traffic_ramp.json", _traffic_ramp_outcome),
    "noisy_neighbor": ("noisy_neighbor.json", _noisy_neighbor_outcome),
    "brownout_ladder": (None, _brownout_ladder_outcome),
}


@pytest.fixture
def one_torch_thread():
    # the tiny model's ops gain nothing from threads, and beside busy
    # test workers an oversubscribed pool stretches the timed scenarios
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(FLEET_RUNS))
def test_fleet_block_runs(name, tmp_path, one_torch_thread):
    committed, outcome = FLEET_RUNS[name]
    if committed is None:
        d = copy.deepcopy(SCENARIOS[name])
    else:
        with open(os.path.join(SCENARIO_DIR, committed)) as f:
            d = json.load(f)
    scenario = Scenario.from_dict(d)
    log = str(tmp_path / f"{name}.jsonl")
    run = run_scenario(scenario, model=build_model(scenario.model,
                                                   device="cpu"),
                       log_path=log)
    # the SLO verdict rides on this host's speed (deadlines, TTFT); the
    # gate's exit is held on the card (chip_smoke.py [fleet_scenarios])
    assert not run.aborted and run.slo is not None
    assert run.submitted == scenario.total_requests
    assert all(s.request.request_id in run.results for s in run.schedule)
    assert run.signals is not None
    assert fleet_log_problems(log) == []
    # the JAX package's monitor reads the port's fleet log as the port's
    assert jbuild_report(log) == build_report(log)
    outcome(run, run.counters)


def _tiny(tmp_path):
    d = _sc("tiny", 7, [dict(WARMUP, n_requests=2),
                        dict(STEADY, n_requests=8)],
            engine=dict(SMALL_ENGINE, prefill_token_budget=4,
                        page_size=4))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(d))
    return d, str(path)


def _cli(capsys, *argv):
    code = cli_main(list(argv))
    return code, json.loads(capsys.readouterr().out)


def test_tiny_scenario_through_the_cli(tmp_path, capsys):
    _, path = _tiny(tmp_path)
    log = str(tmp_path / "run.jsonl")
    base = str(tmp_path / "base.json")
    code, verdict = _cli(capsys, path, "--device", "cpu", "--out", log,
                         "--json")
    assert code == 0 and verdict["exit"] == 0
    assert not verdict["aborted"] and verdict["requests"] == 10
    records = read_records(log)
    reasons = [r["finish_reason"] for r in records
               if r.get("kind") == "request"]
    assert len(reasons) == 10 and set(reasons) <= {"length", "eos"}
    assert check_span_conservation(records) == []
    chunked = [r for r in records if r.get("kind") == "span"
               and r.get("chunk") is not None]
    assert chunked, "prompts past the 4-token budget prefill in chunks"
    # --from-log re-scores the same numbers; no baseline entry: exit 3
    code, again = _cli(capsys, path, "--from-log", log, "--check",
                       "--baseline", base, "--json")
    assert code == 3 and again["metrics"] == verdict["metrics"]
    assert again["span_violations"] == []
    code, _ = _cli(capsys, path, "--from-log", log, "--update-baseline",
                   "--baseline", base, "--json")
    assert code == 0
    code, gated = _cli(capsys, path, "--from-log", log, "--check",
                       "--baseline", base, "--json")
    assert code == 0 and gated["regressions"] == []


def _engine_pair():
    spec = Scenario.from_dict(copy.deepcopy(SCENARIOS["smoke"])).model
    jm, params = jbuild_model(spec)
    tm = build_model(spec, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _span_shape(records):
    """Each request's spans in emission order, stamps and ids aside."""
    keep = ("span", "chunk", "detail")
    out = {}
    for r in records:
        if r.get("kind") == "span":
            out.setdefault(r["request_id"], []).append(
                tuple(r.get(k) for k in keep))
    return list(out.values())


@pytest.mark.parametrize("budget", [None, 8])
def test_engine_spans_and_tokens_per_s_match_jax_engine(budget):
    jm, params, tm = _engine_pair()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 64, size=n).tolist() for n in (5, 13, 19)]
    cfg = dict(max_slots=2, max_len=32, page_size=4,
               prefill_token_budget=budget)
    jsink, sink = JSink(), InMemorySink()
    jeng = JEngine(jm, params, JEngineConfig(**cfg),
                   metrics=JRegistry(sinks=[jsink]))
    jres = jeng.serve([JRequest(prompt=p, max_new_tokens=4,
                                sampling=JSampling()) for p in prompts])
    eng = InferenceEngine(tm, EngineConfig(**cfg),
                          metrics=MetricsRegistry(sinks=[sink]),
                          device="cpu")
    res = eng.serve([Request(prompt=p, max_new_tokens=4,
                             sampling=SamplingParams()) for p in prompts])
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    shape = _span_shape(sink.records)
    assert shape == _span_shape(jsink.records)
    assert all(s[0][0] == "queued" and s[-1][0] == "decode" for s in shape)
    if budget:
        assert any(len(s) > 3 for s in shape)
    for reg, jreg in ((eng.metrics, jeng.metrics),):
        got = reg.histogram("request_tokens_per_s")
        want = jreg.histogram("request_tokens_per_s")
        assert got.count == want.count == len(prompts)
    spans = {k: v for k, v in eng.metrics.counters().items()
             if k.startswith("spans_")}
    jspans = {k: v for k, v in jeng.metrics.counters().items()
              if k.startswith("spans_")}
    assert spans == jspans
    eng.close()
    assert check_span_conservation(sink.records) == []


@pytest.mark.slow
def test_tiny_scenario_tokens_equal_jax_runner():
    d = _sc("tiny_pair", 7, [dict(WARMUP, n_requests=2),
                             dict(STEADY, n_requests=10)])
    jm, params, tm = _engine_pair()
    jrun = jrun_scenario(JScenario.from_dict(copy.deepcopy(d)), model=jm,
                         params=params)
    run = run_scenario(Scenario.from_dict(copy.deepcopy(d)), model=tm)
    assert not run.aborted and not jrun.aborted
    want = [jrun.results[s.request.request_id].tokens
            for s in jrun.schedule]
    got = [run.results[s.request.request_id].tokens for s in run.schedule]
    assert got == want
    assert check_span_conservation(run.records) == []


@pytest.mark.slow
def test_multi_tenant_tokens_equal_jax_runner():
    """The multi_tenant scenario on both runners with converted weights
    and the JAX runner's own seeded adapters, converted: equal tokens for
    every request, every tenant's adapter echoed on its result."""
    d = copy.deepcopy(SCENARIOS["multi_tenant"])
    jm, params, tm = _engine_pair()
    jscenario = JScenario.from_dict(copy.deepcopy(d))
    jrun = jrun_scenario(jscenario, model=jm, params=params)
    knobs = jscenario.engine
    keys = jax.random.split(jax.random.PRNGKey(jscenario.seed),
                            knobs.lora_adapters)
    store = AdapterStore(tm.config, knobs.lora_rank,
                         max_adapters=knobs.lora_adapters, device="cpu")
    jstore = JStore(jm.config, knobs.lora_rank,
                    max_adapters=knobs.lora_adapters)
    for ix in range(knobs.lora_adapters):
        jf = jrandom_adapter(jm.config, knobs.lora_rank, keys[ix])
        jstore.load(str(ix), jf)
        store.load(str(ix), adapter_from_jax(jax.tree.map(np.asarray, jf)))
    run = run_scenario(Scenario.from_dict(copy.deepcopy(d)), model=tm,
                       adapters=store)
    assert not run.aborted and not jrun.aborted
    want = [jrun.results[s.request.request_id] for s in jrun.schedule]
    got = [run.results[s.request.request_id] for s in run.schedule]
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.adapter_id for r in got] == [r.adapter_id for r in want]
    assert set(run.slo_by_adapter) == set(jrun.slo_by_adapter)
    assert check_span_conservation(run.records) == []
