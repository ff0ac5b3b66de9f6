"""The port's serving slice against the JAX package, end to end, on the CPU.

Both packages get the same converted weights and the same numpy-made
prompts. Held here:

- ``_cached_forward`` prefill logits and four paged ``decode_step``s
  (f32, atol 1e-4) for learned positions and for rope + rmsnorm + swiglu
  + GQA;
- the port's ``InferenceEngine.serve()`` is TOKEN-EXACT against
  apex_tpu's engine over six greedy requests (f32, paged, no prefix
  cache, ``max_len`` 48 not divisible by ``page_size`` 8);
- a bf16 variant of the decode comparison (slow tier) to a stated
  tolerance: the two frameworks round bf16 at different points.

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
from apex_tpu_torch.lora import AdapterStore, UnknownAdapterError
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.models import generation as tgen
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
VARIANTS = {
    "learned": {},
    "rope_rms_swiglu_gqa": dict(position_embedding_type="rope",
                                normalization="rmsnorm", activation="swiglu",
                                num_query_groups=2),
}


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """Pin apex_tpu to its plain jnp path: other test modules export
    ``APEX_TPU_FORCE_PALLAS=interpret`` process-wide at import."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(variant, compute=jnp.float32):
    extra = VARIANTS[variant]
    tdtype = torch.float32 if compute == jnp.float32 else torch.bfloat16
    jm = JaxGPT(JaxConfig(**TINY, **extra, hidden_dropout=0.0,
                          attention_dropout=0.0, compute_dtype=compute))
    params = jm.init(jax.random.PRNGKey(3))
    tm = GPTModel(TransformerConfig(**TINY, **extra, compute_dtype=tdtype),
                  device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=list(VARIANTS))
def f32_pair(request):
    return _pair(request.param)


def _paged_decode_run(jm, params, tm, steps=4):
    """Prefill two slots (prompt lengths 5 and 11), land their K/V in
    pages through a sentinel-padded table, then ``steps`` batched paged
    decode steps; the JAX greedy tokens feed both sides. Returns the
    per-stage (jax, torch) logits."""
    ps, n_pages, pps = 8, 10, 4
    rng = np.random.RandomState(11)
    lens = [5, 11]
    prompts = [rng.randint(0, TINY["vocab_size"], size=n) for n in lens]
    table = np.full((2, pps), n_pages, np.int32)          # all sentinel
    table[0, :2] = [3, 7]
    table[1, :2] = [1, 5]
    cdt_j = jm.config.compute_dtype
    jparams = jgen.cast_decode_params(params, cdt_j)
    # jitted: op-by-op JAX dispatch costs more than the compiles here
    jprefill = jax.jit(lambda p_, c_, t_, last: jgen._cached_forward(
        jm, p_, c_, t_, 0, last_index=last), static_argnums=3)
    jdecode = jax.jit(lambda p_, c_, t_, i_, pt_: jgen.decode_step(
        jm, p_, c_, t_, i_, paged_state=pt_))
    jpools = jgen.init_paged_kv_caches(jm, n_pages, ps)
    tpools = tgen.init_paged_kv_caches(tm, n_pages, ps)
    out, first = [], []
    for r, p in enumerate(prompts):
        n = len(p)
        jl, jsmall = jprefill(
            jparams, jgen.init_kv_caches(jm, 1, n, stacked=False),
            jnp.asarray(p[None], jnp.int32), n - 1)
        tl, tsmall = tgen._cached_forward(
            tm, tgen.init_kv_caches(tm, 1, n), torch.as_tensor(p[None]), 0,
            last_index=n - 1)
        out.append((np.asarray(jl[0, 0]), tl[0, 0].numpy()))
        first.append(int(np.argmax(np.asarray(jl[0, 0]))))
        chunks = -(-n // ps)
        dest = table[r, :chunks]
        jflat = jgen.flatten_decode_caches(jsmall, jm.config.num_layers)
        for li, (fk, fv) in enumerate(jflat):
            pad = ((0, chunks * ps - n), (0, 0))
            jk = jpools[li][0].at[dest].set(
                jnp.pad(fk[0], pad).reshape(chunks, ps, -1))
            jv = jpools[li][1].at[dest].set(
                jnp.pad(fv[0], pad).reshape(chunks, ps, -1))
            jpools[li] = (jk, jv)
        for (pk, pv), (fk, fv) in zip(tpools,
                                      tgen.flatten_decode_caches(tsmall)):
            for pool, rows in ((pk, fk), (pv, fv)):
                rows = torch.nn.functional.pad(
                    rows[0], (0, 0, 0, chunks * ps - n))
                pool.index_copy_(0, torch.as_tensor(dest.astype(np.int64)),
                                 rows.reshape(chunks, ps, -1).to(pool.dtype))
    tokens = np.asarray(first, np.int32)
    positions = np.asarray(lens, np.int32)
    for _ in range(steps):
        jl, jpools = jdecode(jparams, jpools, jnp.asarray(tokens),
                             jnp.asarray(positions), jnp.asarray(table))
        tl, tpools = tgen.decode_step(
            tm, tpools, torch.as_tensor(tokens.astype(np.int64)),
            torch.as_tensor(positions), paged_state=torch.as_tensor(table))
        out.append((np.asarray(jl), tl.numpy()))
        tokens = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        positions = positions + 1
    return out


class TestCachedForward:
    def test_prefill_and_paged_decode_match_jax(self, f32_pair):
        jm, params, tm = f32_pair
        before = dict(LAUNCHES)
        for jl, tl in _paged_decode_run(jm, params, tm):
            np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        # CPU tensors take the plain versions: no kernel wrapper launched
        assert LAUNCHES == before


@pytest.mark.slow
def test_bf16_paged_decode_matches_jax_to_tolerance():
    """bf16 rounds at other points in the two frameworks (e.g. JAX's CPU
    decode reference scores with a bf16 einsum); logits of O(1) agree to
    a few bf16 ulps after two layers — atol 0.1."""
    jm, params, tm = _pair("learned", compute=jnp.bfloat16)
    tm = tgen.cast_decode_params(tm, torch.bfloat16)
    for jl, tl in _paged_decode_run(jm, params, tm):
        np.testing.assert_allclose(tl, jl, atol=0.1, rtol=0)


def _requests(cls, seed=5):
    rng = np.random.RandomState(seed)
    shape = [(7, 10), (16, 8), (3, 20), (25, 12), (12, 30), (40, 8)]
    return [cls(prompt=rng.randint(0, TINY["vocab_size"], size=n).tolist(),
                max_new_tokens=m) for n, m in shape]


class TestEngine:
    def test_serve_is_token_exact_against_jax_engine(self):
        jm, params, tm = _pair("learned")
        cfg = dict(max_slots=4, max_len=48, page_size=8, prefix_cache=False)
        jres = JaxEngine(jm, params, JaxEngineConfig(**cfg)).serve(
            _requests(JaxRequest))
        engine = InferenceEngine(tm, EngineConfig(**cfg), device="cpu")
        tres = engine.serve(_requests(Request))
        assert [r.finish_reason for r in tres] == ["length"] * 6
        assert [r.tokens for r in tres] == [r.tokens for r in jres]
        assert engine.pages.in_use_count == 0
        assert engine.metrics.counters()["decode_steps"] > 0

    def test_engine_refuses_unported_knobs(self):
        """No knob is left to port. Every knob constructs — the flat
        layout, chunked prefill, the prefix cache (on by default, as in
        apex_tpu), int8 pools, speculation, LoRA adapters — and the config
        raises ``ValueError`` wherever the JAX ``EngineConfig`` does; an
        ``adapter_id`` on an engine without an adapter store raises
        ``UnknownAdapterError``, as in apex_tpu."""
        for knobs in (dict(prefix_cache=True), dict(kv_dtype="int8"),
                      dict(speculation=2),
                      dict(kv_dtype="int8", speculation=4),
                      dict(kv_layout="flat"),
                      dict(kv_layout="flat", prefill_token_budget=1),
                      dict(prefill_token_budget=64)):
            EngineConfig(**knobs)
        for knobs in (dict(kv_layout="flat", kv_dtype="int8"),
                      dict(kv_layout="flat", speculation=2),
                      dict(prefill_token_budget=0),
                      dict(prefill_token_budget=63)):
            with pytest.raises(ValueError):
                EngineConfig(**knobs)
            with pytest.raises(ValueError):
                JaxEngineConfig(**knobs)
        _, _, tm = _pair("learned")
        InferenceEngine(tm, EngineConfig(max_len=48), device="cpu",
                        adapters=AdapterStore(tm.config, 4, device="cpu"))
        engine = InferenceEngine(tm, EngineConfig(max_len=48), device="cpu")
        with pytest.raises(UnknownAdapterError):
            engine.submit(Request(prompt=[1, 2], max_new_tokens=2,
                                  sampling=SamplingParams(adapter_id="a")))
        assert EngineConfig().prefix_cache is True
        assert EngineConfig().kv_layout == "paged"
