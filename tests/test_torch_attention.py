"""Flash attention of the port against the JAX package.

4D forward: numpy-made q/k/v go through ``apex_tpu.ops.flash_attention``
(its plain path, and the Pallas kernels in interpret mode: a multi-block
shape, s=160 with 64-row blocks, and a single-block shape) and through
``apex_tpu_torch.ops.flash_attention`` on the CPU (the plain version of
the Hopper kernel). Cases: causal and not, GQA (8 heads over 2 groups),
``kv_lengths`` (one of them 0: a batch row with no visible key),
``sliding_window``, ``sq != sk``, head_dim 64.

Packed QKV: a numpy-made packed projection goes through both packages'
``flash_attention_packed`` — forward, and backward through ``jax.vjp``
and torch autograd with the same cotangent — with the JAX side on its
plain path and on the Pallas kernels in interpret mode. Cases: causal,
GQA (``qpg = 2``), RoPE over half the head dim, a sliding window,
``kv_lengths`` with a row at 0, and hash dropout. ``hash_keep`` is held
bit for bit, and the plain backward against autograd of the plain
forward.

Tolerances: f32 forward atol 2e-5 — both compute softmax in fp32; the
flash kernels sum in another order than one softmax over the row;
f32 dqkv atol 1e-4 (the same sums, through the softmax Jacobian).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import attention as jatt
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu_torch.ops import LAUNCHES, flash_attention
from apex_tpu_torch.ops.attention import (
    drop_combo,
    flash_attention_packed,
    flash_packed_bwd_plain,
    flash_packed_fwd_plain,
    hash_keep,
    packed_attention_supported,
    packed_geometry,
)
from apex_tpu_torch.ops.rope import rope_freqs, rope_tables

CASES = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window)
    "causal": (2, 4, 4, 96, 96, 64, True, None, None),
    "full": (2, 4, 4, 96, 96, 64, False, None, None),
    "gqa_8_over_2": (1, 8, 2, 80, 80, 64, True, None, None),
    "kv_lengths": (3, 4, 4, 64, 64, 64, False, [64, 17, 0], None),
    "causal_kv_lengths": (2, 4, 2, 72, 72, 64, True, [40, 72], None),
    "sliding_window": (1, 4, 4, 128, 128, 64, True, None, 24),
    "sq_lt_sk_causal": (2, 4, 4, 24, 100, 64, True, None, None),
    "sq_lt_sk_window": (1, 8, 2, 33, 90, 64, True, [70], 16),
    "head_dim_32": (1, 2, 1, 50, 70, 32, False, None, None),
}


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _run(case, seed=0, **blocks):
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kvh, sk, d).astype(np.float32)
    v = rng.randn(b, kvh, sk, d).astype(np.float32)
    kvl = None if kvl is None else np.asarray(kvl, np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, sliding_window=window,
                     kv_lengths=None if kvl is None else jnp.asarray(kvl),
                     **blocks)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          sliding_window=window,
                          kv_lengths=None if kvl is None
                          else torch.from_numpy(kvl))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_plain(jax_mode, name):
    jax_mode("off")
    want, got = _run(CASES[name])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case,blocks", [
    # multi-block: s=160 over 64-row tiles (causal, GQA, varlen)
    ((1, 8, 2, 160, 160, 64, True, [150], None),
     dict(block_q=64, block_k=64)),
    # multi-block with a sliding window (banded grid)
    ((1, 4, 4, 160, 160, 64, True, None, 40), dict(block_q=64, block_k=64)),
    # single-block: the whole problem is one (bq, bk) tile
    ((2, 4, 4, 48, 48, 64, True, None, None), {}),
])
def test_forward_matches_jax_interpret_kernel(jax_mode, case, blocks):
    jax_mode("interpret")
    want, got = _run(case, seed=1, **blocks)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_fully_masked_row_is_zero():
    _, got = _run(CASES["kv_lengths"])
    assert not np.any(got[2])


def test_bf16_output_keeps_input_dtype():
    q = torch.randn(1, 2, 8, 64, dtype=torch.bfloat16)
    assert flash_attention(q, q, q, causal=True).dtype == torch.bfloat16


def test_invalid_arguments_raise():
    q = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="kv_heads"):
        flash_attention(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, sliding_window=4)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(), q, q)


# ---------------------------------------------------------------------------
# packed QKV
# ---------------------------------------------------------------------------

PACKED = {
    # name: (s, b, groups, qpg, d, kwargs); every shape fits the JAX
    # package's 128-lane packed geometry, so interpret mode takes it too
    "causal": (64, 2, 2, 1, 64, dict(causal=True)),
    "gqa_qpg2": (64, 2, 2, 2, 64, dict(causal=True)),
    "rope_half": (64, 1, 2, 1, 64, dict(causal=True, rot=32)),
    "window": (96, 1, 2, 1, 64, dict(causal=True, sliding_window=20)),
    "kv_lengths_with_zero": (48, 3, 2, 1, 64,
                             dict(kv_lengths=[48, 20, 0])),
    "dropout": (64, 2, 2, 1, 64, dict(causal=True, dropout_rate=0.2,
                                      dropout_seed=-7)),
}


def _packed_run(case, seed=0):
    """(jax o, jax dqkv), (torch o, torch dqkv) for one case; the
    cotangent is numpy-made and shared."""
    s, b, g, qpg, d, kw = case
    kw = dict(kw)
    rng = np.random.RandomState(seed)
    qkv = rng.randn(s, b, g * (qpg + 2) * d).astype(np.float32)
    do = rng.randn(s, b, g * qpg * d).astype(np.float32)
    rot = kw.pop("rot", 0)
    freqs = (None if not rot
             else np.asarray(rope_freqs(0, s, rot, 10000.0)).reshape(s, rot))
    jkw, tkw = dict(kw), dict(kw)
    if "kv_lengths" in kw:
        jkw["kv_lengths"] = jnp.asarray(kw["kv_lengths"], jnp.int32)
        tkw["kv_lengths"] = torch.tensor(kw["kv_lengths"])
    if "dropout_seed" in kw:
        jkw["dropout_seed"] = jnp.asarray([kw["dropout_seed"]], jnp.int32)
    if freqs is not None:
        jkw["rope_freqs"] = jnp.asarray(freqs)
        tkw["rope_freqs"] = torch.from_numpy(freqs)
    jo, vjp = jax.vjp(lambda x: jatt.flash_attention_packed(
        x, queries_per_group=qpg, head_dim=d, **jkw), jnp.asarray(qkv))
    (jd,) = vjp(jnp.asarray(do))
    x = torch.from_numpy(qkv).requires_grad_()
    to = flash_attention_packed(x, queries_per_group=qpg, head_dim=d, **tkw)
    to.backward(torch.from_numpy(do))
    return (np.asarray(jo), np.asarray(jd)), (to.detach().numpy(),
                                              x.grad.numpy())


def _check_packed(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_matches_jax_plain(jax_mode, name):
    jax_mode("off")
    before = dict(LAUNCHES)
    _check_packed(*_packed_run(PACKED[name]))
    assert LAUNCHES == before          # CPU tensors launch no kernel


@pytest.mark.parametrize("name", ["causal", "gqa_qpg2", "rope_half",
                                  "window", "kv_lengths_with_zero",
                                  "dropout"])
def test_packed_matches_jax_interpret_kernel(jax_mode, name):
    jax_mode("interpret")
    s, b, g, qpg, d, _ = PACKED[name]
    assert jatt.packed_attention_supported(s, g, qpg, d)
    _check_packed(*_packed_run(PACKED[name], seed=1))


def test_packed_fully_masked_row_is_zero(jax_mode):
    jax_mode("off")
    _, (o, dqkv) = _packed_run(PACKED["kv_lengths_with_zero"])
    assert not np.any(o[:, 2]) and not np.any(dqkv[:, 2])


@pytest.mark.parametrize("seed", [0, 7, -1, -2 ** 31, 2 ** 31 - 1,
                                  -123456789])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9, 0.999999])
def test_hash_keep_is_bit_exact(seed, rate):
    """``hash_keep`` against ``_hash_keep`` over [b, h, s, s] positions
    with the shared (batch, head) combo; the int32 seed wraps to uint32
    on both sides."""
    b, h, s = 2, 3, 40
    jcombo = jatt._drop_combo(
        jnp.arange(b, dtype=jnp.uint32)[:, None, None, None],
        jnp.arange(h, dtype=jnp.uint32)[None, :, None, None])
    want = np.asarray(jatt._hash_keep(jnp.int32(seed), jcombo, (b, h, s, s),
                                      rate))
    tcombo = drop_combo(torch.arange(b)[:, None, None, None],
                        torch.arange(h)[None, :, None, None])
    got = hash_keep(seed, tcombo, (b, h, s, s), rate).numpy()
    assert np.array_equal(got, want)


def test_hash_keep_combo_stride():
    assert drop_combo(3, 5) == jatt._drop_combo(3, 5) == 3 * 4096 + 5


@pytest.mark.parametrize("seed", [torch.tensor(-7, dtype=torch.int32),
                                  torch.tensor([2 ** 32 - 7])],
                         ids=["int32", "int64_wraps"])
def test_packed_tensor_seed_matches_int_seed(seed):
    """A one-element integer tensor seed (kept on its device, an int64
    value cut to its low 32 bits) gives the int seed's output and grads
    exactly."""
    s, b, g, qpg, d, kw = PACKED["dropout"]
    rng = np.random.RandomState(3)
    qkv = rng.randn(s, b, g * (qpg + 2) * d).astype(np.float32)
    do = torch.from_numpy(rng.randn(s, b, g * qpg * d).astype(np.float32))
    outs = []
    for sd in (-7, seed):
        x = torch.from_numpy(qkv).requires_grad_()
        o = flash_attention_packed(x, queries_per_group=qpg, head_dim=d,
                                   causal=True, dropout_rate=0.2,
                                   dropout_seed=sd)
        o.backward(do)
        outs.append((o.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_bwd_plain_matches_autograd_of_plain_fwd(name):
    """The hand-written backward algebra (p from lse, delta = rowsum(do *
    o), dropout on dp, un-rotation with -sin) against torch autograd
    through the plain forward, f32 atol 2e-5."""
    s, b, g, qpg, d, kw = PACKED[name]
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(s, b, g * (qpg + 2) * d)
                           .astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(s, b, g * qpg * d).astype(np.float32))
    kvl = (None if "kv_lengths" not in kw
           else torch.tensor(kw["kv_lengths"]))
    rope = (None if "rot" not in kw
            else rope_tables(rope_freqs(0, s, kw["rot"], 10000.0), s, d))
    rate = kw.get("dropout_rate", 0.0)
    args = (kvl, rope, kw.get("dropout_seed"), rate, 1.0 / np.sqrt(d),
            kw.get("causal", False), kw.get("sliding_window"), qpg, d)
    o, lse = flash_packed_fwd_plain(qkv, *args)
    o.backward(do)
    got = flash_packed_bwd_plain(qkv.detach(), do, o.detach(), lse.detach(),
                                 *args)
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), atol=2e-5,
                               rtol=0)


def test_packed_gate_and_errors():
    """The port's gate takes every shape its kernels take (head_dim up to
    128, any length and group count), where the JAX Pallas gate also needs
    128-lane cells; the geometry helper is the JAX package's."""
    assert packed_geometry(16, 1, 64) == jatt.packed_geometry(16, 1, 64)
    assert packed_geometry(3, 1, 64) is None
    assert packed_attention_supported(2048, 3, 1, 64)
    assert packed_attention_supported(197, 16, 1, 128)
    assert not packed_attention_supported(64, 2, 1, 256)
    qkv = torch.zeros(8, 1, 2 * 3 * 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_packed(qkv, queries_per_group=2, head_dim=16)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_packed(qkv, queries_per_group=1, head_dim=16,
                               sliding_window=4)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention_packed(qkv, queries_per_group=1, head_dim=16,
                               dropout_rate=0.1)
    with pytest.raises(TypeError, match="integer"):
        flash_attention_packed(qkv, queries_per_group=1, head_dim=16,
                               dropout_rate=0.1,
                               dropout_seed=torch.tensor(1.0))
    assert flash_attention_packed(
        qkv.bfloat16(), queries_per_group=1, head_dim=16,
        causal=True).dtype == torch.bfloat16
