"""Chunked prefill (``prefill_token_budget``) in the port against the JAX
engine and against the port's own monolithic prefill, on the CPU.

Both packages serve the same converted weights (a tiny f32 GPT whose
transformer weights are scaled up so that streams vary) and the same
numpy-made requests, half of them sampled. Held here, tokens EXACTLY equal:

- paged (with the prefix cache, its hits landing mid-prompt) and flat
  layouts, and paged int8 pools with speculation: the chunked run gives
  the JAX engine's chunked tokens, ``prefill_chunks`` counters and
  per-request chunk counts, and (bf16-or-f32 pools) the port's own
  monolithic tokens. With int8 pools the JAX engine's own chunked stream
  differs from its monolithic one on these requests (the monolithic fill
  scales a prompt's last, partial page over the bucket's pad rows too), so
  there the bar is the JAX engine's chunked run alone;
- a request whose deadline expires between chunks retires as a timeout
  with its slot and pages released (the abandon path), and a request
  cancelled between chunks retires as cancelled; the engine then serves a
  fresh request.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

import time

import jax
import numpy as np
import pytest

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import SamplingParams as JaxSampling
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)

SMALL = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
             vocab_size=64, max_position_embeddings=64)
ROPE = dict(position_embedding_type="rope", normalization="rmsnorm",
            activation="swiglu", num_query_groups=2)
LAYOUTS = {
    "paged": dict(kv_layout="paged", page_size=4, n_pages=96),
    "flat": dict(kv_layout="flat"),
    "paged_int8_spec": dict(kv_layout="paged", page_size=4, n_pages=96,
                            kv_dtype="int8", speculation=3),
}


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(extra=None, scale=4.0):
    extra = extra or {}
    jm = JaxGPT(JaxConfig(**SMALL, **extra, hidden_dropout=0.0,
                          attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(0))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tm = GPTModel(TransformerConfig(**SMALL, **extra), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _requests(cls, sampling_cls, seed=41):
    """Prompts of 23, 5, 11 and 17 tokens, the 17 sharing the 23's first
    12 (a prefix-cache hit of three 4-token pages), every other one
    sampled."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 64, size=n).tolist() for n in (23, 5, 11)]
    prompts.append(prompts[0][:12] + rng.randint(0, 64, size=5).tolist())
    out = []
    for i, p in enumerate(prompts):
        sp = sampling_cls(temperature=0.9, top_k=8, seed=100 + i) \
            if i % 2 else sampling_cls()
        out.append(cls(prompt=p, max_new_tokens=6, sampling=sp))
    return out


def _serve_both(pair, knobs):
    jm, params, tm = pair
    cfg = dict(max_slots=4, max_len=64, **knobs)
    jeng = JaxEngine(jm, params, JaxEngineConfig(**cfg))
    jres = jeng.serve(_requests(JaxRequest, JaxSampling))
    teng = InferenceEngine(tm, EngineConfig(**cfg), device="cpu")
    tres = teng.serve(_requests(Request, SamplingParams))
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert [r.prefill_chunks for r in tres] == \
        [r.prefill_chunks for r in jres]
    jc, tc = jeng.metrics.counters(), teng.metrics.counters()
    keys = ("prefill_chunks", "prefills", "tokens_generated", "prefix_hits",
            "prefix_misses")
    assert {k: tc.get(k) for k in keys} == {k: jc.get(k) for k in keys}
    if teng.pages is not None:
        assert teng.pages.free_count + teng.pages.reclaimable_count == \
            teng.pages.n_pages
    return [r.tokens for r in tres], tres, teng


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunked_is_token_exact_against_jax_and_monolithic(pair, layout):
    tokens, results, engine = _serve_both(
        pair, dict(LAYOUTS[layout], prefill_token_budget=8))
    # the 23-token prompt could not fit one 8-token tick budget
    assert results[0].prefill_chunks > 1
    assert engine.metrics.histogram("prefill_tokens_per_tick").max <= 8
    assert engine.chunk_compiles <= len(engine.buckets)
    if layout == "paged":
        assert engine.metrics.counters()["prefix_hits"] >= 1
    if "kv_dtype" in LAYOUTS[layout]:
        return
    mono = InferenceEngine(pair[2], EngineConfig(
        max_slots=4, max_len=64, **LAYOUTS[layout]), device="cpu")
    mres = mono.serve(_requests(Request, SamplingParams))
    assert [r.tokens for r in mres] == tokens
    assert all(r.prefill_chunks is None for r in mres)


@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_deadline_expiry_mid_prefill_releases_the_slot(pair, layout):
    tm = pair[2]
    eng = InferenceEngine(tm, EngineConfig(
        max_slots=2, max_len=64, **LAYOUTS[layout], prefill_token_budget=4),
        device="cpu")
    rng = np.random.RandomState(97)
    doomed = Request(prompt=rng.randint(0, 64, size=30).tolist(),
                     max_new_tokens=4, deadline_s=0.05)
    eng.submit(doomed)
    eng.tick()                    # the first chunk runs
    assert eng._prefilling
    time.sleep(0.1)
    eng.tick()                    # the deadline check fires
    res = eng.completed[doomed.request_id]
    assert (res.finish_reason, res.tokens, res.prefill_chunks) == \
        ("timeout", [], 1)
    assert not eng._prefilling
    eng.slots.check()
    if eng.pages is not None:
        assert eng.pages.in_use_count == 0
    ok = eng.serve([Request(prompt=rng.randint(0, 64, size=5).tolist(),
                            max_new_tokens=3)])
    assert ok[0].finish_reason in ("eos", "length")


@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_cancel_mid_prefill(pair, layout):
    tm = pair[2]
    eng = InferenceEngine(tm, EngineConfig(
        max_slots=2, max_len=64, **LAYOUTS[layout], prefill_token_budget=4),
        device="cpu")
    rng = np.random.RandomState(101)
    req = Request(prompt=rng.randint(0, 64, size=30).tolist(),
                  max_new_tokens=4)
    eng.submit(req)
    eng.tick()
    assert eng._prefilling
    assert eng.cancel(req.request_id)
    eng.tick()
    res = eng.completed[req.request_id]
    assert res.finish_reason == "cancelled" and res.tokens == []
    assert not eng._prefilling
    eng.slots.check()
    if eng.pages is not None:
        assert eng.pages.in_use_count == 0
    assert eng.metrics.counters()["requests_cancelled"] == 1


@pytest.mark.slow
def test_rope_gqa_chunked_token_exact_against_jax_engine():
    """rope + rmsnorm + swiglu + GQA, chunked at budget 8, every
    layout."""
    pair = _pair(ROPE)
    for knobs in LAYOUTS.values():
        _serve_both(pair, dict(knobs, prefill_token_budget=8))
