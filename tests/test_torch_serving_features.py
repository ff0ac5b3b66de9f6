"""The rest of paged serving in the port against the JAX package, on the
CPU: the prefix cache, int8 KV pools and speculative verify windows.

Both packages get the same converted weights (a tiny f32 GPT whose
transformer weights are scaled up so that greedy streams vary and drafts
get rejected) and the same numpy-made requests: five that share a
two-page prompt prefix (one of them exactly that prefix, a fully
page-aligned hit whose suffix prefill recomputes only the last token),
two period-tiled prompts the drafter predicts, and one half-page prompt.
Held here:

- ``InferenceEngine.serve()`` is TOKEN-EXACT against apex_tpu's engine
  with ``prefix_cache=True``, with ``kv_dtype="int8"``, with
  ``speculation=3`` and with all three at once, and the prefix and draft
  counters are equal;
- speculation changes nothing in the stream: ``speculation=3`` gives the
  tokens of ``speculation=0``;
- the mid-cache 4D path (``cache_index`` past 0: a suffix prefill) gives
  JAX's logits, f32 atol 1e-4.

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
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
ROPE = dict(position_embedding_type="rope", normalization="rmsnorm",
            activation="swiglu", num_query_groups=2)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_pages_shared",
            "prefix_evictions", "draft_tokens_proposed",
            "draft_tokens_accepted", "decode_steps", "tokens_generated",
            "prefills")
BASE = dict(max_slots=3, max_len=48, page_size=8)


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(extra=None, scale=6.0):
    """A tiny f32 GPT in both packages with the same weights; the
    transformer's weights scaled by ``scale`` (the embedding kept), so
    the residual stream no longer echoes the input token."""
    extra = extra or {}
    jm = JaxGPT(JaxConfig(**TINY, **extra, hidden_dropout=0.0,
                          attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(3))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tm = GPTModel(TransformerConfig(**TINY, **extra), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _requests(cls, seed=5):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 128, size=16).tolist()
    period = rng.randint(0, 128, size=5).tolist()
    out = [cls(prompt=prefix + rng.randint(0, 128, size=n).tolist(),
               max_new_tokens=m)
           for n, m in [(3, 10), (9, 8), (0, 12), (20, 6), (5, 9)]]
    out += [cls(prompt=(period * 6)[:n], max_new_tokens=m)
            for n, m in [(12, 20), (23, 15)]]
    out += [cls(prompt=prefix[:8], max_new_tokens=5)]
    return out


def _serve_both(pair, **knobs):
    jm, params, tm = pair
    cfg = dict(BASE, **knobs)
    jeng = JaxEngine(jm, params, JaxEngineConfig(**cfg))
    jres = jeng.serve(_requests(JaxRequest))
    teng = InferenceEngine(tm, EngineConfig(**cfg), device="cpu")
    aligned = []
    inner = teng._suffix_prefill
    teng._suffix_prefill = lambda *a: aligned.append(a[-1]) or inner(*a)
    before = dict(LAUNCHES)
    tres = teng.serve(_requests(Request))
    assert LAUNCHES == before          # the CPU runs the plain versions
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    jc, tc = jeng.metrics.counters(), teng.metrics.counters()
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    # every page is back: free, or held only by the intern index
    assert teng.pages.free_count + teng.pages.reclaimable_count == \
        teng.pages.n_pages
    scales = ([s for _, s in teng._caches[0]] if teng._quantized else [])
    teng.pages.check(*scales)
    return [r.tokens for r in tres], tc, aligned


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache=True),
    dict(prefix_cache=False, kv_dtype="int8"),
    dict(prefix_cache=False, speculation=3),
    dict(prefix_cache=True, kv_dtype="int8", speculation=3),
], ids=["prefix", "int8", "speculation", "all_three"])
def test_serve_features_are_token_exact_against_jax_engine(pair, knobs):
    tokens, counters, aligned = _serve_both(pair, **knobs)
    if knobs["prefix_cache"]:
        assert counters["prefix_hits"] >= 4
        assert True in aligned          # a fully page-aligned hit ran
    if knobs.get("speculation"):
        assert 0 < counters["draft_tokens_accepted"] < \
            counters["draft_tokens_proposed"]


def test_speculation_changes_nothing_in_the_stream(pair):
    jm, params, tm = pair
    out = {}
    for spec in (0, 3):
        for kv in ("bf16", "int8"):
            eng = InferenceEngine(tm, EngineConfig(
                **BASE, kv_dtype=kv, speculation=spec), device="cpu")
            out[spec, kv] = [r.tokens for r in eng.serve(_requests(Request))]
            if spec:
                c = eng.metrics.counters()
                assert c["decode_steps"] < c["tokens_generated"] - 8
    assert out[3, "bf16"] == out[0, "bf16"]
    assert out[3, "int8"] == out[0, "int8"]


def test_mid_cache_prefill_matches_jax(pair):
    """A 16-token prefill, then 5 tokens at ``cache_index`` 16 of a 4D
    cache of 40 rows (the suffix prefill's path): logits of both steps
    f32 atol 1e-4."""
    jm, params, tm = pair
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 128, size=(1, 21))
    jc = jgen.init_kv_caches(jm, 1, 40, stacked=False)
    tc = tgen.init_kv_caches(tm, 1, 40)
    for lo, hi in ((0, 16), (16, 21)):
        jl, jc = jgen._cached_forward(jm, params, jc,
                                      jnp.asarray(tokens[:, lo:hi]),
                                      jnp.int32(lo) if lo else 0)
        tl, tc = tgen._cached_forward(tm, tc, torch.as_tensor(
            tokens[:, lo:hi]), lo)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)


@pytest.mark.slow
def test_rope_gqa_all_features_token_exact_against_jax_engine():
    """rope + rmsnorm + swiglu + GQA with all three features on."""
    _serve_both(_pair(ROPE), prefix_cache=True, kv_dtype="int8",
                speculation=3)
