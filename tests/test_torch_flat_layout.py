"""The flat KV layout in the port against the JAX package, on the CPU.

Held here:

- ``_flat_cache_attention`` through the whole layer stack, over flat
  ``[b, S, kv_heads * head_dim]`` caches seeded with numpy values: the
  single-token step at a ``[b]`` vector of per-row positions (each row
  written at its own offset, offset-causal per row), with a sliding window
  and ``kv_lengths``, and a 4-token slice at a scalar offset (the grouped
  product and the masked softmax) — outputs and the written caches against
  JAX's in f32 (atol 2e-5) and bf16 (atol 0.05 on O(1) outputs: two layers
  of bf16 GEMMs, rounded where JAX rounds);
- ``InferenceEngine(kv_layout="flat")`` is token-exact against the JAX
  flat engine, greedy;
- ``generate`` gives JAX's tokens, greedy and sampled (top-k, EOS
  freezing), on learned and rope positions.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import generation as jgen
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.models import generation as tgen
from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request
from apex_tpu_torch.utils import prng

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
VARIANTS = {
    "learned": {},
    "rope_gqa_window": dict(position_embedding_type="rope",
                            normalization="rmsnorm", activation="swiglu",
                            num_query_groups=2, sliding_window=6),
}


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(extra, compute=jnp.float32, scale=6.0):
    jm = JaxGPT(JaxConfig(**TINY, **extra, hidden_dropout=0.0,
                          attention_dropout=0.0, compute_dtype=compute))
    params = jm.init(jax.random.PRNGKey(3))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tdtype = torch.float32 if compute == jnp.float32 else torch.bfloat16
    tm = GPTModel(TransformerConfig(**TINY, **extra, compute_dtype=tdtype),
                  device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    if tdtype != torch.float32:
        params = jgen.cast_decode_params(params, compute)
        tm = tgen.cast_decode_params(tm, tdtype)
    return jm, params, tm


def _seeded_caches(jm, b, S, dtype, seed=0):
    c = jm.config
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(b, S, c.kv_heads * c.head_dim).astype(np.float32),
             rng.randn(b, S, c.kv_heads * c.head_dim).astype(np.float32))
            for _ in range(c.num_layers)]
    jc = [(jnp.asarray(k, dtype), jnp.asarray(v, dtype)) for k, v in arrs]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tc = [(torch.as_tensor(k).to(tdt), torch.as_tensor(v).to(tdt))
          for k, v in arrs]
    return jc, tc


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@torch.no_grad()
def test_flat_cache_attention_matches_jax(variant, dtype):
    compute = jnp.float32 if dtype == "f32" else jnp.bfloat16
    atol = 2e-5 if dtype == "f32" else 0.05
    jm, params, tm = _pair(VARIANTS[variant], compute, scale=1.0)
    c = jm.config
    b, S = 3, 24
    rng = np.random.RandomState(1)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jc, tc = _seeded_caches(jm, b, S, compute)
    # single-token steps at per-row positions, kv_lengths bounding row 1
    pos = np.array([5, 17, 0], np.int32)
    lens = np.array([S, 12, S], np.int32)
    for _ in range(3):
        hidden = rng.randn(1, b, c.hidden_size).astype(np.float32)
        jo, jc = jm.transformer.apply(
            params["transformer"], jnp.asarray(hidden, compute),
            kv_caches=jc, cache_index=jnp.asarray(pos),
            kv_lengths=jnp.asarray(lens))
        to, tc = tm.transformer(torch.as_tensor(hidden).to(tdt),
                                kv_caches=tc, cache_index=torch.as_tensor(pos),
                                kv_lengths=torch.as_tensor(lens))
        _close(to, jo, atol)
        pos = pos + 1
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk, atol)
        _close(tv, jv, atol)
    # a 4-token slice at a scalar offset: the grouped product
    hidden = rng.randn(4, b, c.hidden_size).astype(np.float32)
    jo, jc = jm.transformer.apply(params["transformer"],
                                  jnp.asarray(hidden, compute), kv_caches=jc,
                                  cache_index=jnp.int32(9))
    to, tc = tm.transformer(torch.as_tensor(hidden).to(tdt), kv_caches=tc,
                            cache_index=9)
    _close(to, jo, atol)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk, atol)
        _close(tv, jv, atol)


def _requests(cls, seed=5):
    rng = np.random.RandomState(seed)
    shape = [(7, 10), (16, 8), (3, 20), (25, 12), (12, 30), (40, 8)]
    return [cls(prompt=rng.randint(0, TINY["vocab_size"], size=n).tolist(),
                max_new_tokens=m) for n, m in shape]


def test_flat_engine_is_token_exact_against_jax_engine():
    jm, params, tm = _pair({})
    cfg = dict(max_slots=4, max_len=48, kv_layout="flat")
    jres = JaxEngine(jm, params, JaxEngineConfig(**cfg)).serve(
        _requests(JaxRequest))
    engine = InferenceEngine(tm, EngineConfig(**cfg), device="cpu")
    assert engine.pages is None
    tres = engine.serve(_requests(Request))
    assert [r.finish_reason for r in tres] == ["length"] * 6
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    # greedy streams of the two layouts agree too
    paged = InferenceEngine(tm, EngineConfig(max_slots=4, max_len=48),
                            device="cpu").serve(_requests(Request))
    assert [r.tokens for r in paged] == [r.tokens for r in tres]


GEN_KNOBS = [dict(), dict(temperature=0.8, top_k=8), dict(temperature=1.0),
             dict(temperature=0.7, eos_token=5)]


def _generate_both(jm, params, tm, knobs, prompt, n_new):
    sampled = bool(knobs)
    want = np.asarray(jgen.generate(
        jm, params, jnp.asarray(prompt), n_new,
        rng=jax.random.PRNGKey(11) if sampled else None, **knobs))
    got = tgen.generate(tm, torch.as_tensor(prompt), n_new,
                        rng=prng.prng_key(11) if sampled else None, **knobs)
    assert got.tolist() == want.tolist()
    return got


@pytest.mark.parametrize("knobs", GEN_KNOBS,
                         ids=["greedy", "topk", "sampled", "eos"])
def test_generate_matches_jax(knobs):
    jm, params, tm = _pair({})
    prompt = np.random.RandomState(0).randint(0, 128, size=(3, 7))
    out = _generate_both(jm, params, tm, knobs, prompt, 12)
    assert out.shape == (3, 19)
    if "eos_token" in knobs:
        for row in out[:, 7:].tolist():
            if 5 in row:
                assert set(row[row.index(5):]) == {5}


def test_generate_argument_checks():
    tm = _pair({})[2]
    prompt = torch.zeros((1, 4), dtype=torch.long)
    for kw, match in ((dict(max_new_tokens=0), "max_new_tokens"),
                      (dict(max_new_tokens=2, top_k=0), "top_k"),
                      (dict(max_new_tokens=2, temperature=0.5), "rng"),
                      (dict(max_new_tokens=61), "max_position_embeddings"),
                      (dict(max_new_tokens=4, max_len=6), "max_len")):
        with pytest.raises(ValueError, match=match):
            tgen.generate(tm, prompt, **kw)


@pytest.mark.slow
def test_rope_gqa_window_generate_and_flat_engine_match_jax():
    """rope + rmsnorm + swiglu + GQA + a sliding window: ``generate``
    greedy and sampled, and the flat engine, token-exact."""
    jm, params, tm = _pair(VARIANTS["rope_gqa_window"])
    prompt = np.random.RandomState(2).randint(0, 128, size=(2, 9))
    for knobs in GEN_KNOBS:
        _generate_both(jm, params, tm, knobs, prompt, 10)
    cfg = dict(max_slots=4, max_len=48, kv_layout="flat")
    jres = JaxEngine(jm, params, JaxEngineConfig(**cfg)).serve(
        _requests(JaxRequest))
    tres = InferenceEngine(tm, EngineConfig(**cfg), device="cpu").serve(
        _requests(Request))
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
