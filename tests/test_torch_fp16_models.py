"""fp16 models of the port against the JAX package on the CPU: serving a
GPT in fp16, BERT trained under amp O2 in fp16 with FusedLAMB, and an
encoder-decoder (T5-like) under amp O2 in fp16 with FusedAdam.

- Serving: a tiny GPT (2 layers, hidden 64; its transformer weights scaled
  x6 so that greedy streams vary and drafts are rejected, as
  ``test_torch_serving_features.py`` makes it) with ``compute_dtype``
  fp16 in both packages, from the same weights: ``InferenceEngine.serve``
  on the paged layout is TOKEN-EXACT against apex_tpu's engine with fp16
  pools, with int8 pools and with ``speculation=3``, and the engines'
  counters agree. Both sides cast the weights to fp16 and run each op in
  fp32 rounded once to fp16, but their fp16 GEMMs sum in other orders, so
  the logits differ by a few fp16 ulps (up to 0.016 at |logit| ~4 here)
  and a stream may part where two logits tie closer than that; none of
  these requests meets such a tie. (With the prefix cache one does: a
  suffix prefill reaches request 3's sixth token by another path than a
  full prefill, and there the f32 logits separate the top two by 0.011,
  under 6 fp16 ulps; the port's own fp16 full forward ranks them the
  other way. So the prefix cache is left to the f32 tests.)
- BERT: one layer (the trust ratio spans one parameter in the port and a
  layer-stacked leaf in JAX, equal only at one layer) under
  ``initialize("O2", half_dtype=float16)``: fp16 params and compute,
  ``FusedLAMB(lr=1e-3, weight_decay=0.01, master_weights=True)``, a
  dynamic scale from 2^16, a padding mask (its padded query rows mask
  every key: the masked softmax path, Kernels G and H on the card) and an
  inf injected after the backward of step 1; three steps against the JAX
  package's BERT under the same amp O2 flow: the losses within 2e-3
  relative (fp16 rounds at other points in the two frameworks), the
  scaler states equal at every step, every parameter fp16.
- Encoder-decoder: ``test_torch_encoder_decoder.py``'s tiny T5 variant
  (RMSNorm, ReLU, GQA; 2 + 2 layers) with ``enc_lengths`` (the encoder on
  the packed path with kv_lengths, the cross-attention on the 4D flash
  forward and backward: Kernels E, F, B and I on the card) under the same
  O2 fp16 flow with ``FusedAdam(lr=1e-3, master_weights=True)``, an inf
  injected after the backward of step 1: three steps against the JAX
  package's flow, the losses within 2e-3 relative, the scaler states equal
  at every step, the skipped step leaving the loss as it was.

The JAX side runs its plain (non-Pallas) path, pinned per test. The rope
+ rmsnorm + swiglu + GQA model's fp16 serving is the slow test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.models.encoder_decoder import EncoderDecoderModel as JaxEncDec
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu_torch import amp
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import (BertModel, EncoderDecoderModel, GPTModel,
                                   TransformerConfig)
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request

F16 = torch.float16
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
ROPE = dict(position_embedding_type="rope", normalization="rmsnorm",
            activation="swiglu", num_query_groups=2)
COUNTERS = ("draft_tokens_proposed", "draft_tokens_accepted",
            "decode_steps", "tokens_generated", "prefills")
BASE = dict(max_slots=3, max_len=48, page_size=8, prefix_cache=False)


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _gpt_pair(extra=None, scale=6.0):
    """A tiny fp16 GPT in both packages with the same weights, the
    transformer's scaled by ``scale``."""
    extra = extra or {}
    jm = JaxGPT(JaxConfig(**TINY, **extra, hidden_dropout=0.0,
                          attention_dropout=0.0, compute_dtype=jnp.float16))
    params = jm.init(jax.random.PRNGKey(3))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tm = GPTModel(TransformerConfig(**TINY, **extra, compute_dtype=F16),
                  device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def gpt_pair():
    return _gpt_pair()


def _requests(cls, seed=5):
    """Five prompts sharing a two-page prefix, two period-tiled prompts the
    drafter predicts, one half-page prompt."""
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
    before = dict(LAUNCHES)
    tres = teng.serve(_requests(Request))
    assert LAUNCHES == before          # the CPU runs the plain versions
    assert teng.model.embedding.word_embeddings.weight.dtype == F16
    pools = teng._caches[0][0]
    pools = pools[0] if isinstance(pools, tuple) else pools
    assert pools.dtype == (torch.int8 if knobs.get("kv_dtype") == "int8"
                           else F16)
    assert [r.finish_reason for r in tres] == \
        [r.finish_reason for r in jres]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    jc, tc = jeng.metrics.counters(), teng.metrics.counters()
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    return tc


@pytest.mark.parametrize("knobs", [
    dict(), dict(kv_dtype="int8"), dict(speculation=3),
], ids=["fp16_pools", "int8", "speculation"])
def test_fp16_engine_is_token_exact_against_jax_engine(gpt_pair, knobs):
    counters = _serve_both(gpt_pair, **knobs)
    if knobs.get("speculation"):
        assert 0 < counters["draft_tokens_accepted"] < \
            counters["draft_tokens_proposed"]


@pytest.mark.slow
def test_rope_gqa_fp16_engine_is_token_exact_against_jax_engine():
    """rope + rmsnorm + swiglu + GQA served in fp16, paged greedy."""
    _serve_both(_gpt_pair(ROPE))


# -- BERT under amp O2 in fp16 ------------------------------------------------

BERT = dict(num_layers=1, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
BATCH, SEQ = 2, 24
OVERFLOW_STEP = 1


def _bert_batch(seed=2):
    """Tokens, a padding mask (row 1 padded from position 15), tokentype
    ids (0 before a split point, 1 after) and labels."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, BERT["vocab_size"], (BATCH, SEQ)).astype(
        np.int32)
    labels = rng.randint(0, BERT["vocab_size"], (BATCH, SEQ)).astype(
        np.int32)
    pad = np.ones((BATCH, SEQ), bool)
    pad[1, 15:] = False
    split = rng.randint(4, SEQ - 4, BATCH)
    types = (np.arange(SEQ)[None, :] >= split[:, None]).astype(np.int32)
    return tokens, pad, types, labels


def _scaler_state(st):
    return (float(st.loss_scale), int(st.growth_tracker),
            int(st.hysteresis_tracker), int(st.unskipped))


def _bert_o2_fp16(steps=3):
    """The JAX and the port amp O2 fp16 flows with LAMB over fp32 masters
    on one BERT: ``(jax losses, jax scaler states, port losses, port
    scaler states, port model)``; both grads take an inf after the
    backward of ``OVERFLOW_STEP``."""
    jst = jamp.initialize("O2", half_dtype=jnp.float16)
    jm = JaxBert(JaxConfig(**BERT, compute_dtype=jnp.float16))
    params = jm.init(jax.random.PRNGKey(5))
    tm = BertModel(TransformerConfig(**BERT, compute_dtype=F16),
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    # jitted whole: eager, each leaf's cast compiles on its own
    params = jax.jit(jst.policy.cast_to_param)(params)
    tst = amp.initialize("O2", half_dtype=F16, device="cpu")
    tst.policy.cast_to_param(tm)
    batch = _bert_batch()
    jargs = tuple(jnp.asarray(a) for a in batch)
    jsc, jss = jst.scaler, jst.scaler_states[0]
    jopt = JaxFusedLAMB(lr=1e-3, weight_decay=0.01, master_weights=True)
    jos = jopt.init(params)

    @jax.jit
    def grads_of(p, ss):
        return jax.value_and_grad(
            lambda q: jsc.scale(jm.apply(q, *jargs)[0], ss))(p)

    jlosses, jstates = [], []
    for i in range(steps):
        sloss, g = grads_of(params, jss)
        jlosses.append(float(sloss) / float(jss.loss_scale))
        if i == OVERFLOW_STEP:
            emb = g["embedding"]["word_embeddings"]
            emb["weight"] = emb["weight"].at[0, 0].set(jnp.inf)
        g, found = jsc.unscale(g, jss)
        params, jos = jopt.step(g, params, jos, found_inf=found)
        jss = jsc.update(jss, found)
        jstates.append(_scaler_state(jss))

    sc, ss = tst.scaler, tst.scaler_states[0]
    opt = FusedLAMB(tm.parameters(), lr=1e-3, weight_decay=0.01,
                    master_weights=True)
    tokens, pad, types, labels = batch
    targs = (torch.from_numpy(tokens).long(), torch.from_numpy(pad),
             torch.from_numpy(types).long(), torch.from_numpy(labels).long())
    tlosses, tstates = [], []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss, _ = tm(*targs)
        amp.scale_loss(loss, ss).backward()
        for p in tm.parameters():      # the binary head: zero, as jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        tlosses.append(float(loss.detach()))
        if i == OVERFLOW_STEP:
            tm.embedding.word_embeddings.weight.grad[0, 0] = float("inf")
        _, found = sc.unscale([p.grad for p in tm.parameters()], ss)
        opt.step(found_inf=found)
        ss = sc.update(ss, found)
        tstates.append(_scaler_state(ss))
    return jlosses, jstates, tlosses, tstates, tm


def test_bert_o2_fp16_lamb_steps_match_jax():
    jl, js, tl, ts, tm = _bert_o2_fp16()
    assert all(p.dtype == F16 for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert ts == js
    assert ts[OVERFLOW_STEP][0] == 2.0 ** 15 and ts[OVERFLOW_STEP][1] == 0
    # the skipped step left the weights as they were: the same loss again
    assert tl[OVERFLOW_STEP + 1] == tl[OVERFLOW_STEP]
    assert tl[1] < tl[0]


def test_bert_binary_head_promotes_to_fp32_under_o2():
    """The pooler and the classifier run in fp32 as jnp promotes them, so
    the fp16 weights of amp O2 reach the binary logits as fp32."""
    tm = BertModel(TransformerConfig(**BERT, compute_dtype=F16),
                   device="cpu", generator=torch.Generator().manual_seed(0))
    amp.initialize("O2", half_dtype=F16, device="cpu").policy.cast_to_param(
        tm)
    tokens, pad, types, _ = _bert_batch(3)
    with torch.no_grad():
        logits, binary = tm(torch.from_numpy(tokens).long(),
                            torch.from_numpy(pad),
                            torch.from_numpy(types).long())
    assert logits.dtype == F16 and binary.dtype == torch.float32
    assert torch.isfinite(binary).all()


# -- encoder-decoder (T5-like) under amp O2 in fp16 ---------------------------

T5 = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
          attention_dropout=0.0, normalization="rmsnorm", activation="relu",
          ffn_hidden_size=96, num_query_groups=2)
T5_BATCH, S_ENC, S_DEC = 3, 24, 10
ENC_LENGTHS = np.array([24, 13, 19], np.int32)


def _t5_batch(seed=4):
    rng = np.random.RandomState(seed)
    enc = rng.randint(0, T5["vocab_size"], (T5_BATCH, S_ENC)).astype(
        np.int32)
    dec = rng.randint(0, T5["vocab_size"], (T5_BATCH, S_DEC)).astype(
        np.int32)
    labels = rng.randint(0, T5["vocab_size"], (T5_BATCH, S_DEC)).astype(
        np.int32)
    return enc, dec, labels


def _t5_o2_fp16(steps=3):
    """The JAX and the port amp O2 fp16 flows with Adam over fp32 masters
    on one encoder-decoder with ``enc_lengths``: ``(jax losses, jax scaler
    states, port losses, port scaler states, port model, no kernel
    launched)``; both grads take an inf after the backward of
    ``OVERFLOW_STEP``."""
    jst = jamp.initialize("O2", half_dtype=jnp.float16)
    jm = JaxEncDec(JaxConfig(**T5, compute_dtype=jnp.float16))
    params = jax.jit(jm.init)(jax.random.PRNGKey(7))
    tm = EncoderDecoderModel(TransformerConfig(**T5, compute_dtype=F16),
                             device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    # jitted whole: eager, each leaf's cast compiles on its own
    params = jax.jit(jst.policy.cast_to_param)(params)
    tst = amp.initialize("O2", half_dtype=F16, device="cpu")
    tst.policy.cast_to_param(tm)
    enc, dec, labels = _t5_batch()
    jargs = tuple(jnp.asarray(a) for a in (enc, dec, labels))
    jlen = jnp.asarray(ENC_LENGTHS)
    jsc, jss = jst.scaler, jst.scaler_states[0]
    jopt = JaxFusedAdam(lr=1e-3, master_weights=True)
    jos = jax.jit(jopt.init)(params)

    @jax.jit
    def jstep(p, os_, ss, inject):
        """One step of the flow (jitted whole: eager it compiles each of
        the optimizer's small ops on its own)."""
        sloss, g = jax.value_and_grad(
            lambda q: jsc.scale(jm.apply(q, *jargs, enc_lengths=jlen),
                                ss))(p)
        emb = g["embedding"]["word_embeddings"]
        emb["weight"] = jnp.where(inject, emb["weight"].at[0, 0].set(
            jnp.inf), emb["weight"])
        g, found = jsc.unscale(g, ss)
        p, os_ = jopt.step(g, p, os_, found_inf=found)
        return sloss / ss.loss_scale, p, os_, jsc.update(ss, found)

    jlosses, jstates = [], []
    for i in range(steps):
        loss, params, jos, jss = jstep(params, jos, jss, i == OVERFLOW_STEP)
        jlosses.append(float(loss))
        jstates.append(_scaler_state(jss))

    sc, ss = tst.scaler, tst.scaler_states[0]
    opt = FusedAdam(tm.parameters(), lr=1e-3, master_weights=True)
    targs = tuple(torch.from_numpy(a).long() for a in (enc, dec, labels))
    tlen = torch.from_numpy(ENC_LENGTHS)
    before = dict(LAUNCHES)
    tlosses, tstates = [], []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = tm(*targs, enc_lengths=tlen)
        amp.scale_loss(loss, ss).backward()
        tlosses.append(float(loss.detach()))
        if i == OVERFLOW_STEP:
            tm.embedding.word_embeddings.weight.grad[0, 0] = float("inf")
        _, found = sc.unscale([p.grad for p in tm.parameters()], ss)
        opt.step(found_inf=found)
        ss = sc.update(ss, found)
        tstates.append(_scaler_state(ss))
    return jlosses, jstates, tlosses, tstates, tm, LAUNCHES == before


def test_t5_o2_fp16_adam_steps_match_jax():
    jl, js, tl, ts, tm, no_launch = _t5_o2_fp16()
    assert no_launch                    # CPU tensors launch no kernel
    assert all(p.dtype == F16 for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert ts == js
    assert ts[OVERFLOW_STEP][0] == 2.0 ** 15 and ts[OVERFLOW_STEP][1] == 0
    # the skipped step left the weights as they were: the same loss again
    assert tl[OVERFLOW_STEP + 1] == tl[OVERFLOW_STEP]
    assert tl[1] < tl[0]
