"""Dropout in the port against the JAX package, on the CPU.

The port draws every dropout mask from :mod:`apex_tpu_torch.utils.prng`
keys, split and folded as the JAX layers split and fold theirs, so with
the same key the masks are the JAX package's bit for bit. Held here:

- ``split``, ``bernoulli`` (its uniform in float32, ``p``'s weak type)
  and ``randint`` (int32, the key split in two and the uint32 remainder
  arithmetic) BITWISE ``jax.random``'s over several keys, shapes and
  bounds;
- ``_dropout`` (hidden, embedding and the softmax path's probabilities)
  BITWISE the JAX ``_dropout`` in f32 and bf16: the same keep mask and
  the kept values scaled by ``1 / (1 - rate)`` rounded to the tensor's
  dtype, as a weakly typed JAX constant is;
- the packed attention's per-layer hash seeds: one ``randint`` of
  ``fold_in(rng, num_layers)`` plus ``idx * 0x9E3779B9`` with int32
  wrap-around, as ``ParallelTransformer.apply`` draws them;
- a tiny GPT (RoPE, RMSNorm, SwiGLU, GQA: the packed path's in-kernel
  hash dropout), a tiny BERT with a padding mask (the masked softmax,
  then ``bernoulli`` on the probabilities) and a tiny encoder-decoder
  with ``enc_lengths`` (packed self-attention, cross-attention through
  the unfused path with dropout), every rate 0.1, one key: the loss and
  EVERY gradient leaf against ``jax.value_and_grad`` of the JAX model
  with the same key, in f32 (loss rtol 1e-5, each leaf atol 1e-5 of its
  largest magnitude: sums in other orders, as
  ``test_torch_gpt_training.py``): the GPT in tier 1, BERT and the
  encoder-decoder in the slow test, which also runs every model in bf16,
  the loss to
  rtol 2e-3 and each leaf to 5e-2 of its largest magnitude (the
  frameworks round bf16 at other points, as the bf16 training tests find
  without dropout).

The JAX side runs its plain path (pinned per test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import BertModel as JaxBert
from apex_tpu.models import EncoderDecoderModel as JaxEncDec
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import transformer as jtransformer
from apex_tpu.ops import _support as jax_support
from apex_tpu.transformer.enums import AttnMaskType as JaxMask
from apex_tpu_torch.convert import grads_to_jax, params_to_jax
from apex_tpu_torch.models import (
    BertModel,
    EncoderDecoderModel,
    GPTModel,
    TransformerConfig,
)
from apex_tpu_torch.models import transformer as ttransformer
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.utils import prng

SEEDS = [0, 7, -3, 2 ** 31 - 1]
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.1,
            attention_dropout=0.1)
KINDS = {
    "gpt_rope_rms_swiglu_gqa": dict(position_embedding_type="rope",
                                    normalization="rmsnorm",
                                    activation="swiglu", num_query_groups=2),
    "bert_padding": dict(attn_mask_type="padding"),
    "enc_dec_enc_lengths": dict(normalization="rmsnorm", activation="relu"),
}
KEY = 11


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """apex_tpu on its plain jnp path (other modules export interpret
    mode process-wide at import)."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()


def _key_ints(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bernoulli_randint_are_jax_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for n in (2, 3, 4):
        assert (prng.split(tk, n).numpy()
                == _key_ints(jax.random.split(jk, n))).all()
    for p, shape in ((0.9, (3, 5, 7)), (0.5, (2, 64)), (1.0 - 0.1, (129,))):
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        assert (prng.bernoulli(tk, p, shape).numpy() == want).all()
    for lo, hi in ((-2 ** 31, 2 ** 31 - 1), (0, 10), (5, 3), (-7, 1000003),
                   (0, 2 ** 31 - 1)):
        want = np.asarray(jax.random.randint(jk, (6,), lo, hi, jnp.int32))
        got = prng.randint(tk, (6,), lo, hi)
        assert got.dtype == torch.int32 and (got.numpy() == want).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_is_jax_bitwise(rate, dtype):
    x = np.random.RandomState(3).randn(24, 2, 64).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for seed in SEEDS:
        want = jtransformer._dropout(jx, rate, jax.random.PRNGKey(seed),
                                     False, False, "tensor")
        got = ttransformer._dropout(tx, rate, prng.prng_key(seed), False)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
    assert ttransformer._dropout(tx, rate, None, False) is tx
    assert ttransformer._dropout(tx, rate, prng.prng_key(0), True) is tx


@pytest.mark.parametrize("num_layers", [2, 24])
def test_attention_seeds_are_the_jax_stacks(num_layers):
    """One base draw a step plus ``idx * 0x9E3779B9`` a layer, int32."""
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        base = jax.random.randint(jax.random.fold_in(jk, num_layers), (1,),
                                  -2 ** 31, 2 ** 31 - 1, jnp.int32)
        tbase = prng.randint(prng.fold_in(prng.prng_key(seed), num_layers),
                             (1,), -2 ** 31, 2 ** 31 - 1)
        for idx in range(num_layers):
            want = np.asarray(base + jnp.int32(idx) * jnp.int32(-1640531527))
            got = ttransformer._layer_seed(tbase, idx)
            assert got.dtype == torch.int32 and (got.numpy() == want).all()


def _configs(kind, compute):
    extra = dict(KINDS[kind])
    mask = extra.pop("attn_mask_type", None)
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    tcfg = TransformerConfig(**TINY, **extra, compute_dtype=tdt,
                             **({} if mask is None else dict(
                                 attn_mask_type=AttnMaskType.padding)))
    jcfg = JaxConfig(**TINY, **extra, compute_dtype=jdt,
                     **({} if mask is None else dict(
                         attn_mask_type=JaxMask.padding)))
    return tcfg, jcfg


def _batch(kind):
    rng = np.random.RandomState(1)
    v = TINY["vocab_size"]
    if kind.startswith("gpt"):
        return tuple(rng.randint(0, v, (2, 32)).astype(np.int32)
                     for _ in range(2))
    if kind.startswith("bert"):
        tokens, labels = (rng.randint(0, v, (2, 32)).astype(np.int32)
                          for _ in range(2))
        padding = np.ones((2, 32), bool)
        padding[1, 20:] = False
        types = np.zeros((2, 32), np.int32)
        types[:, 10:] = 1
        return tokens, padding, types, labels
    enc, dec, labels = (rng.randint(0, v, (2, n)).astype(np.int32)
                        for n in (32, 16, 16))
    return enc, dec, labels, np.array([32, 19], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(kind, compute):
    """The JAX model's jitted loss-and-grad with dropout on, compiled once
    for the tests of this module."""
    _, jcfg = _configs(kind, compute)
    if kind.startswith("gpt"):
        jm = JaxGPT(jcfg)
        loss = lambda p, b, k: jm.apply(p, b[0], b[1], rng=k,  # noqa: E731
                                        deterministic=False)
    elif kind.startswith("bert"):
        jm = JaxBert(jcfg)
        loss = lambda p, b, k: jm.apply(p, *b, rng=k,  # noqa: E731
                                        deterministic=False)[0]
    else:
        jm = JaxEncDec(jcfg)
        loss = lambda p, b, k: jm.apply(  # noqa: E731
            p, b[0], b[1], b[2], enc_lengths=b[3], rng=k,
            deterministic=False)
    return jax.jit(jax.value_and_grad(loss))


def _port_loss(kind, compute):
    tcfg, _ = _configs(kind, compute)
    gen = torch.Generator().manual_seed(5)
    cls = (GPTModel if kind.startswith("gpt") else
           BertModel if kind.startswith("bert") else EncoderDecoderModel)
    tm = cls(tcfg, device="cpu", generator=gen)
    batch = _batch(kind)
    tb = [torch.from_numpy(a) for a in batch]
    tb = [t if t.dtype == torch.bool else t.long() for t in tb]
    key = prng.prng_key(KEY)
    if kind.startswith("gpt"):
        loss = tm(*tb, rng=key, deterministic=False)
    elif kind.startswith("bert"):
        loss = tm(*tb, rng=key, deterministic=False)[0]
    else:
        loss = tm(tb[0], tb[1], tb[2], enc_lengths=tb[3], rng=key,
                  deterministic=False)
    loss.backward()
    return tm, batch, loss


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_against_jax(kind, compute, loss_rtol, leaf_atol):
    """The port's loss and gradients with dropout on against the JAX
    model's, same weights (``params_to_jax``), batch and key."""
    tm, batch, loss = _port_loss(kind, compute)
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jloss, jgrads = _jax_loss_and_grad(kind, compute)(
        params, tuple(jnp.asarray(a) for a in batch),
        jax.random.PRNGKey(KEY))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=loss_rtol)
    want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key], w, rtol=0,
            atol=leaf_atol * float(np.abs(w).max()) + 1e-12, err_msg=key)
    return float(loss)


@pytest.mark.parametrize("kind", ["gpt_rope_rms_swiglu_gqa"])
def test_dropout_loss_and_grads_match_jax(kind):
    check_against_jax(kind, "float32", 1e-5, 1e-5)
    # dropout on: the loss differs from the deterministic one
    tm, batch, _ = _port_loss(kind, "float32")
    tb = [torch.from_numpy(a) for a in batch]
    tb = [t if t.dtype == torch.bool else t.long() for t in tb]
    with torch.no_grad():
        if kind.startswith("gpt"):
            off = tm(*tb)
            on = tm(*tb, rng=prng.prng_key(KEY), deterministic=False)
        elif kind.startswith("bert"):
            off = tm(*tb)[0]
            on = tm(*tb, rng=prng.prng_key(KEY), deterministic=False)[0]
        else:
            off = tm(tb[0], tb[1], tb[2], enc_lengths=tb[3])
            on = tm(tb[0], tb[1], tb[2], enc_lengths=tb[3],
                    rng=prng.prng_key(KEY), deterministic=False)
    assert float(on) != float(off)


@pytest.mark.slow
def test_dropout_bert_enc_dec_and_bf16_models_match_jax_to_tolerance():
    """BERT and the encoder-decoder in f32 (each JAX loss-and-grad costs
    5-15 s to compile beside busy workers), then every model in bf16."""
    for kind in ("bert_padding", "enc_dec_enc_lengths"):
        check_against_jax(kind, "float32", 1e-5, 1e-5)
    for kind in KINDS:
        check_against_jax(kind, "bfloat16", 2e-3, 5e-2)
