"""The port's ``EngineSupervisor`` against the JAX package's, on the CPU.

Both packages serve the same converted weights and requests under the
same :class:`ServingFaultInjector` schedules. Held here:

- restart exactness: a decode failure, a prefill failure, and a failure
  between the chunks of a chunked prefill each rebuild the engine and
  re-prefill every in-flight request from prompt + generated tokens; the
  final tokens (greedy and sampled, paged and flat) equal the JAX
  supervisor's and the fault-free run's, and the supervisor counters
  (restarts, tick failures, recoveries, submits) and its incident events
  (tick failure, restart, recovery: names and fields, request ids aside)
  equal JAX's; the dead engine's caches are dropped before the new engine
  allocates;
- a hung tick (``hung_tick_s``) restarts like a failure, first-run ticks
  exempt;
- past ``max_restarts_per_request`` a request retires with ``error`` and
  the tokens recovered so far;
- the circuit breaker opens after ``breaker_threshold`` consecutive
  failures (submits then fail fast as ``rejected``), goes half-open after
  the cooldown, closes on a clean probe and re-opens on a failed one;
- the EWMA deadline shedding rejects a deadline request whose projected
  wait exceeds its budget, and never sheds before the first observation.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

import jax
import numpy as np
import pytest

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.observability import MetricsRegistry as JaxRegistry
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import EngineSupervisor as JaxSupervisor
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import SamplingParams as JaxSampling
from apex_tpu.testing_faults import ServingFaultInjector as JaxInjector
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                    EngineUnavailableError, Request,
                                    SamplingParams, SupervisorConfig, clock)
from apex_tpu_torch.serving.supervisor import BREAKER_CLOSED, BREAKER_OPEN
from apex_tpu_torch.testing_faults import (InjectedEngineFault,
                                           ServingFaultInjector)

SMALL = dict(num_layers=1, hidden_size=32, num_attention_heads=4,
             vocab_size=64, max_position_embeddings=64)
COUNTERS = ("engine_restarts", "tick_failures", "requests_recovered",
            "requests_submitted", "requests_length", "requests_error",
            "breaker_opens", "requests_resumed")
#: the supervisor's incident events
EVENTS = ("tick_failure", "engine_restart", "request_recovered",
          "breaker_open", "breaker_half_open", "breaker_closed",
          "request_shed", "request_resumed", "request_error")


class _Sink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def flush(self):
        pass

    def events(self):
        """Supervisor incident events without their stamps and ids."""
        drop = {"seq", "ts", "wall", "request_id"}
        return [{k: v for k, v in r.items() if k not in drop}
                for r in self.records
                if r.get("kind") == "event" and r["event"] in EVENTS]


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(extra=None, scale=4.0):
    cfg = dict(SMALL, **(extra or {}))
    jm = JaxGPT(JaxConfig(**cfg, hidden_dropout=0.0, attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(0))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tm = GPTModel(TransformerConfig(**cfg), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _requests(cls, sampling_cls, sampled, seed=31):
    rng = np.random.RandomState(seed)
    out = []
    for i, (n, m) in enumerate([(3, 6), (13, 8), (5, 7)]):
        sp = sampling_cls(temperature=1.0, top_k=5, seed=123 + i) \
            if sampled and i != 1 else sampling_cls()
        out.append(cls(prompt=rng.randint(0, 64, size=n).tolist(),
                       max_new_tokens=m, sampling=sp))
    return out


SCENARIOS = {
    "decode_raise": (dict(decode_raise_calls={2}), {}),
    "prefill_raise": (dict(prefill_raise_calls={1}), {}),
    "decode_raise_flat": (dict(decode_raise_calls={1}),
                          dict(kv_layout="flat")),
    "mid_chunk_raise": (dict(prefill_raise_calls={2}),
                        dict(prefill_token_budget=4)),
    "mid_chunk_raise_flat": (dict(prefill_raise_calls={2}),
                             dict(kv_layout="flat",
                                  prefill_token_budget=4)),
}


def _restart_both(pair, faults, knobs, sampled):
    jm, params, tm = pair
    cfg = dict(max_slots=2, max_len=24, page_size=4, **knobs)
    jsink, sink = _Sink(), _Sink()
    jsup = JaxSupervisor(jm, params, JaxEngineConfig(**cfg),
                         faults=JaxInjector(**faults),
                         metrics=JaxRegistry(sinks=[jsink]))
    jres = jsup.serve(_requests(JaxRequest, JaxSampling, sampled))
    inj = ServingFaultInjector(**faults)
    sup = EngineSupervisor(tm, EngineConfig(**cfg), faults=inj,
                           metrics=MetricsRegistry(sinks=[sink]),
                           device="cpu")
    first = sup.engine
    tres = sup.serve(_requests(Request, SamplingParams, sampled))
    assert sup.restarts >= 1 and inj.log
    assert first._caches is None and first.model is None
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [r.prompt_len for r in tres] == [3, 13, 5]
    jc, tc = jsup.metrics.counters(), sup.metrics.counters()
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert sink.events() == jsink.events() != []
    sup.engine.slots.check()
    clean = EngineSupervisor(tm, EngineConfig(**cfg), device="cpu").serve(
        _requests(Request, SamplingParams, sampled))
    assert [r.tokens for r in clean] == [r.tokens for r in tres]
    return tres, tc


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_restart_is_token_exact_against_jax_supervisor(pair, scenario,
                                                       sampled):
    faults, knobs = SCENARIOS[scenario]
    _, counters = _restart_both(pair, faults, knobs, sampled)
    assert counters["engine_restarts"] == 1
    assert counters["requests_submitted"] == 3


def test_hung_tick_triggers_restart(pair):
    tm = pair[2]
    inj = ServingFaultInjector(decode_hang={2: 1.0})
    sup = EngineSupervisor(tm, EngineConfig(max_slots=2, max_len=24),
                           supervisor=SupervisorConfig(hung_tick_s=0.5),
                           faults=inj, device="cpu")
    (res,) = sup.serve([Request(prompt=[3, 1, 4], max_new_tokens=6)])
    (clean,) = EngineSupervisor(tm, EngineConfig(max_slots=2, max_len=24),
                                device="cpu").serve(
        [Request(prompt=[3, 1, 4], max_new_tokens=6)])
    assert (res.finish_reason, res.tokens) == ("length", clean.tokens)
    assert sup.restarts == 1 and ("hang", 2, 1.0) in inj.log
    assert sup.metrics.counters()["tick_failures"] == 1


def test_retry_budget_exhausted_retires_with_error(pair):
    tm = pair[2]
    inj = ServingFaultInjector(decode_raise_calls=set(range(100)))
    sup = EngineSupervisor(
        tm, EngineConfig(max_slots=2, max_len=24),
        supervisor=SupervisorConfig(max_restarts_per_request=1,
                                    breaker_threshold=100),
        faults=inj, device="cpu")
    (res,) = sup.serve([Request(prompt=[5, 9, 2], max_new_tokens=6)])
    assert res.finish_reason == "error" and res.new_tokens >= 1
    assert sup.restarts == 2 and sup.inflight_count == 0
    sup.engine.slots.check()
    with pytest.raises(InjectedEngineFault):
        inj.before_decode()


@pytest.fixture
def fake_clock(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(clock, "now", lambda: now[0])
    return now


def test_breaker_open_half_open_close_and_failed_probe(pair, fake_clock):
    tm = pair[2]
    inj = ServingFaultInjector(decode_raise_calls={0, 1, 2})
    sink = _Sink()
    sup = EngineSupervisor(
        tm, EngineConfig(max_slots=2, max_len=24),
        supervisor=SupervisorConfig(breaker_threshold=2,
                                    breaker_cooldown_s=0.05,
                                    max_restarts_per_request=10),
        metrics=MetricsRegistry(sinks=[sink]), faults=inj, device="cpu")
    victim = Request(prompt=[4, 4, 8], max_new_tokens=6)
    sup.submit(victim)
    sup.tick()
    assert sup.breaker_state == BREAKER_CLOSED   # 1 failure < threshold
    sup.tick()
    assert sup.breaker_state == BREAKER_OPEN     # the 2nd in a row
    shed = Request(prompt=[1, 2, 3, 4], max_new_tokens=3)
    with pytest.raises(EngineUnavailableError, match="breaker"):
        sup.submit(shed)
    assert sup.completed[shed.request_id].finish_reason == "rejected"
    fake_clock[0] += 0.06
    sup.tick()                                   # the probe fails
    assert sup.breaker_state == BREAKER_OPEN
    fake_clock[0] += 0.06
    sup.tick()                                   # a clean probe
    assert sup.breaker_state == BREAKER_CLOSED
    restart = ["tick_failure", "engine_restart", "request_recovered"]
    assert [e["event"] for e in sink.events()] == [
        *restart, "tick_failure", "breaker_open", *restart[1:],
        "request_shed", "breaker_half_open", "tick_failure", "breaker_open",
        *restart[1:], "breaker_half_open", "breaker_closed"]
    while sup.inflight_count:
        sup.tick()
    (clean,) = EngineSupervisor(tm, EngineConfig(max_slots=2, max_len=24),
                                device="cpu").serve(
        [Request(prompt=[4, 4, 8], max_new_tokens=6)])
    assert sup.completed[victim.request_id].tokens == clean.tokens
    c = sup.metrics.counters()
    assert (c["breaker_opens"], c["breaker_half_opens"],
            c["breaker_closes"], c["requests_shed_breaker"]) == (2, 2, 1, 1)


def test_deadline_shedding_against_jax(pair):
    jm, params, tm = pair

    def run(sup, req_cls):
        sup._service_s = 50.0            # observed: ~50 s a request
        sup.submit(req_cls(prompt=[1, 2, 3], max_new_tokens=8))
        sup.submit(req_cls(prompt=[4, 5, 6, 7], max_new_tokens=8))
        doomed = req_cls(prompt=[7, 7, 7], max_new_tokens=2, deadline_s=1.0)
        with pytest.raises(Exception, match="deadline") as exc:
            sup.submit(doomed)
        res = sup.completed[doomed.request_id]
        # no-deadline traffic is never shed by the estimate
        sup.submit(req_cls(prompt=[3, 3], max_new_tokens=2))
        return (type(exc.value).__name__, res.finish_reason, res.tokens,
                sup.metrics.counters()["requests_shed_deadline"],
                sup.inflight_count)

    got = run(EngineSupervisor(tm, EngineConfig(max_slots=1, max_len=24),
                               device="cpu"), Request)
    want = run(JaxSupervisor(jm, params,
                             JaxEngineConfig(max_slots=1, max_len=24)),
               JaxRequest)
    assert got == want == ("EngineUnavailableError", "rejected", [], 1, 3)
    fresh = EngineSupervisor(tm, EngineConfig(max_slots=1, max_len=24),
                             device="cpu")
    assert fresh.service_estimate_s is None
    fresh.submit(Request(prompt=[3, 2], max_new_tokens=2, deadline_s=30.0))
    assert fresh.inflight_count == 1
    fresh.serve([])
    assert fresh.service_estimate_s > 0


@pytest.mark.slow
def test_rope_gqa_sampled_chunked_restart_matches_jax():
    """rope + rmsnorm + swiglu + GQA at two layers: a failure between
    chunks, sampled, paged and flat."""
    pair = _pair(dict(position_embedding_type="rope",
                      normalization="rmsnorm", activation="swiglu",
                      num_query_groups=2, num_layers=2))
    for scenario in ("mid_chunk_raise", "mid_chunk_raise_flat"):
        faults, knobs = SCENARIOS[scenario]
        _restart_both(pair, faults, knobs, sampled=True)
