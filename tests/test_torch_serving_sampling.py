"""Sampled serving in the port against the JAX engine, on the CPU.

The requests are ``benchmarks/scenarios/smoke.json``'s, as the JAX
loadtest generates them (half greedy, the rest at temperatures 0.7 and
1.0 with top-k off and 8, seeds from the scenario's seed), served by the
scenario's model and engine knobs in both packages with the same weights.
Held here, tokens EXACTLY equal (f32 throughout):

- the port's ``InferenceEngine`` gives the JAX engine's tokens for the mix,
  on the paged layout (the default) and on the flat layout;
- sampled speculation: ``speculation=3`` gives the tokens of the
  sequential decode in both packages, and the port's equal the JAX
  engine's.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from apex_tpu.loadtest.generator import TrafficGenerator
from apex_tpu.loadtest.runner import build_model
from apex_tpu.loadtest.scenario import Scenario
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams, SchedulerConfig)

SMOKE = Path(__file__).resolve().parent.parent / "benchmarks" / \
    "scenarios" / "smoke.json"


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _port_model(jm, params, extra=None):
    c = jm.config
    tm = GPTModel(TransformerConfig(
        num_layers=c.num_layers, hidden_size=c.hidden_size,
        num_attention_heads=c.num_attention_heads, vocab_size=c.vocab_size,
        max_position_embeddings=c.max_position_embeddings, **(extra or {})),
        device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return tm


@pytest.fixture(scope="module")
def smoke():
    scenario = Scenario.load(str(SMOKE))
    jm, params = build_model(scenario.model)
    return scenario, jm, params, _port_model(jm, params)


def _port_requests(jreqs):
    return [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    sampling=SamplingParams(
                        temperature=r.sampling.temperature,
                        top_k=r.sampling.top_k, seed=r.sampling.seed,
                        priority=r.sampling.priority),
                    eos_token=r.eos_token, deadline_s=r.deadline_s)
            for r in jreqs]


def _knobs(scenario, **extra):
    e = scenario.engine
    return dict(max_slots=e.max_slots, max_len=e.max_len, **extra), \
        dict(max_queue=e.max_queue,
             max_prefills_per_tick=e.max_prefills_per_tick)


def _serve_both(jm, params, tm, jreqs, knobs, sched):
    jres = JaxEngine(jm, params, JaxEngineConfig(
        **knobs, scheduler=JaxSchedulerConfig(**sched))).serve(jreqs)
    engine = InferenceEngine(tm, EngineConfig(
        **knobs, scheduler=SchedulerConfig(**sched)), device="cpu")
    tres = engine.serve(_port_requests(jreqs))
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    return [r.tokens for r in jres], [r.tokens for r in tres], engine


@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_smoke_mix_is_token_exact_against_jax_engine(smoke, layout):
    scenario, jm, params, tm = smoke
    jreqs = TrafficGenerator(scenario).requests()
    sampled = [r for r in jreqs if r.sampling.temperature > 0]
    assert len(sampled) >= 6 and {r.sampling.top_k for r in sampled} == \
        {None, 8}
    knobs, sched = _knobs(scenario, kv_layout=layout)
    want, got, engine = _serve_both(jm, params, tm, jreqs, knobs, sched)
    assert got == want
    assert engine.metrics.counters()["tokens_generated"] == \
        sum(map(len, want))


def _spec_requests(vocab, seed=3):
    """Sampled requests on period-tiled prompts (the n-gram drafter then
    proposes, and some drafts land), plus two greedy ones."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(6):
        period = rng.randint(0, vocab, size=3).tolist()
        temp = 0.0 if i % 3 == 2 else (0.7, 1.0)[i % 2]
        out.append(dict(prompt=(period * 5)[:9 + i], max_new_tokens=14,
                        sampling=dict(temperature=temp,
                                      top_k=(None, 8)[i % 2],
                                      seed=int(rng.randint(2 ** 31 - 1)))))
    return out


def test_sampled_speculation_equals_sequential_decode(smoke):
    from apex_tpu.serving import Request as JaxRequest
    from apex_tpu.serving import SamplingParams as JaxSampling
    scenario, jm, params, tm = smoke
    specs = _spec_requests(jm.config.vocab_size)
    out = {}
    for spec in (0, 3):
        jreqs = [JaxRequest(prompt=r["prompt"],
                            max_new_tokens=r["max_new_tokens"],
                            sampling=JaxSampling(**r["sampling"]))
                 for r in specs]
        knobs, sched = _knobs(scenario, speculation=spec)
        want, got, engine = _serve_both(jm, params, tm, jreqs, knobs, sched)
        assert got == want
        out[spec] = got
        if spec:
            c = engine.metrics.counters()
            assert c["draft_tokens_accepted"] > 0
    assert out[3] == out[0]


@pytest.mark.slow
def test_rope_gqa_sampled_mix_token_exact_against_jax_engine(smoke):
    """The smoke mix through a rope + rmsnorm + swiglu + GQA model whose
    transformer weights are scaled up (varied streams), paged and flat."""
    scenario, _, _, _ = smoke
    c = scenario.model
    extra = dict(position_embedding_type="rope", normalization="rmsnorm",
                 activation="swiglu", num_query_groups=2)
    jm = JaxGPT(JaxConfig(
        num_layers=c.num_layers, hidden_size=c.hidden_size,
        num_attention_heads=c.num_attention_heads, vocab_size=c.vocab_size,
        max_position_embeddings=c.max_position_embeddings, **extra,
        hidden_dropout=0.0, attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(4))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * 4.0, params["transformer"]))
    tm = _port_model(jm, params, extra)
    jreqs = TrafficGenerator(scenario).requests()
    for layout in ("paged", "flat"):
        knobs, sched = _knobs(scenario, kv_layout=layout)
        want, got, _ = _serve_both(jm, params, tm, jreqs, knobs, sched)
        assert got == want
