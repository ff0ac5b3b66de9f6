"""The port's threefry (``apex_tpu_torch/utils/prng.py``) and the engine's
``_sample_tokens`` against ``jax.random`` and the JAX engine, on the CPU.

Held here:

- key data (``PRNGKey``, ``fold_in``), random bits and uniforms are
  BITWISE ``jax.random``'s, at ``(V,)`` and ``(b, V)`` with V = 50257 (one
  key over the whole shape, the partitionable counter layout ``generate``
  draws) and per row under a batch of keys (the engine's ``vmap`` draw);
- the gumbel noise, ``-log(-log(u))`` of those bitwise uniforms, is within
  1 ulp of ``jax.random.gumbel`` at unit scale (``max(|g|, 1)``): each
  ``log`` is within 1 ulp of XLA's, and near g = 0 the outer ``-log(x)``
  at x ~ 1 turns the inner log's 1 ulp into an absolute ~6e-8, which is
  many ulps of a tiny g but never more than 1 ulp of 1;
- ``categorical`` draws the same index as ``jax.random.categorical`` over
  a hypothesis range of seeds and steps;
- ``_sample_tokens`` gives the JAX engine's tokens on seeded logits with
  mixed temperatures (greedy rows among them), top-k and steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apex_tpu.serving.engine import _sample_tokens as jax_sample_tokens
from apex_tpu_torch.serving.engine import _sample_tokens
from apex_tpu_torch.utils import prng

V = 50257
SEEDS = [0, 1, 12345, 2 ** 31 - 1, -1, -7]


def _key(seed, step):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), step),
            prng.fold_in(prng.prng_key(seed), step))


def _as_int(a):
    return np.asarray(a).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_is_jax_bitwise(seed):
    jk = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert (prng.prng_key(seed).numpy() == jk.astype(np.int64)).all()
    for step in (0, 1, 77, 700, 2 ** 31 - 1):
        jf, tf = _key(seed, step)
        assert (tf.numpy() == np.asarray(jax.random.key_data(jf))
                .astype(np.int64)).all()


def test_batched_keys_fold_like_vmap():
    seeds = np.array(SEEDS, np.int32)
    steps = np.array([3, 0, 9, 2 ** 31 - 1, 64, 5], np.int32)
    jk = jax.vmap(lambda s, t: jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(s), t)))(seeds, steps)
    tk = prng.fold_in(prng.prng_key(torch.as_tensor(seeds)),
                      torch.as_tensor(steps))
    assert (tk.numpy() == np.asarray(jk).astype(np.int64)).all()


def test_threefry_block_is_jax_bitwise():
    from jax._src import prng as jprng
    jf, tf = _key(3, 9)
    counters = (np.arange(11, dtype=np.uint64) * 2654435761 % 2 ** 32) \
        .astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(jax.random.key_data(jf),
                                          jnp.asarray(counters, jnp.uint32)))
    got = prng.threefry2x32(tf, torch.as_tensor(counters.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize("shape", [(V,), (3, V), (7,), (1,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bits_and_uniform_are_jax_bitwise(shape):
    jk, tk = _key(3, 9)
    bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert (prng.random_bits(tk, shape).numpy() == bits).all()
    u = jax.random.uniform(jk, shape)
    assert (_as_int(prng.uniform(tk, shape).numpy()) == _as_int(u)).all()
    tiny = np.finfo(np.float32).tiny
    u = jax.random.uniform(jk, shape, minval=tiny, maxval=1.0)
    got = prng.uniform(tk, shape, minval=float(tiny), maxval=1.0)
    assert (_as_int(got.numpy()) == _as_int(u)).all()
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float16, torch.float16)):
        want = np.asarray(jax.random.uniform(jk, shape, jdt)
                          .astype(jnp.float32))
        assert (prng.uniform(tk, shape, tdt).float().numpy() == want).all()


def test_per_row_keys_draw_like_vmap():
    """A [n, 2] key batch draws each row with its own key: the engine's
    ``vmap(draw)`` layout, counters over one row each."""
    seeds = np.array([5, 6, 7], np.int32)
    steps = np.array([10, 11, 300], np.int32)
    jkeys = jax.vmap(lambda s, t: jax.random.fold_in(
        jax.random.PRNGKey(s), t))(seeds, steps)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (V,)))(jkeys))
    tkeys = prng.fold_in(prng.prng_key(torch.as_tensor(seeds)),
                         torch.as_tensor(steps))
    assert (_as_int(prng.uniform(tkeys, (V,)).numpy()) == _as_int(want)).all()


@pytest.mark.parametrize("shape", [(V,), (3, V)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gumbel_within_one_ulp_at_unit_scale(shape):
    jk, tk = _key(3, 9)
    want = np.asarray(jax.random.gumbel(jk, shape))
    got = prng.gumbel(tk, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()
    # each log alone: within 1 ulp of XLA's
    u = np.asarray(jax.random.uniform(jk, shape,
                                      minval=np.finfo(np.float32).tiny))
    inner = np.asarray(jnp.log(u))
    for x, ref in ((u, inner), (-inner, np.asarray(jnp.log(-inner)))):
        got = torch.log(torch.as_tensor(np.array(x))).numpy()
        assert np.abs(_as_int(got) - _as_int(ref)).max() <= 1


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(-2 ** 31, 2 ** 31 - 1),
       step=st.integers(0, 2 ** 31 - 1))
def test_categorical_draws_jax_index(seed, step):
    logits = np.random.RandomState(seed % 1000).randn(2, 1000) \
        .astype(np.float32) * 3
    jk, tk = _key(seed, step)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = prng.categorical(tk, torch.as_tensor(logits)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("vocab", [128, V])
def test_sample_tokens_match_jax_engine(vocab):
    """Rows greedy (temperature 0) and sampled at temperatures 0.7 and
    1.0, with top-k 1, 8 and off (k = V), at steps past 2**16."""
    rng = np.random.RandomState(0)
    n = 8
    logits = (rng.randn(n, vocab) * 2).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 0.7, 1.0, 0.0, 1.3, 0.7], np.float32)
    topks = np.array([vocab, 8, vocab, 1, 8, 8, vocab, vocab], np.int32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=n).astype(np.int32)
    steps = np.array([5, 6, 7, 8, 70000, 9, 10, 11], np.int32)
    want = np.asarray(jax_sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
        jnp.asarray(seeds), jnp.asarray(steps)))
    got = _sample_tokens(*(torch.as_tensor(a) for a in (
        logits, temps, topks, seeds, steps)))
    assert got.tolist() == want.tolist()
    assert got[0] == logits[0].argmax() and got[3] == logits[3].argmax()
