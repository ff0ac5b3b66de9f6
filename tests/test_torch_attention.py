"""Flash attention of the port against the JAX package.

4D forward: numpy-made q/k/v go through ``apex_tpu.ops.flash_attention``
(its plain path, and the Pallas kernels in interpret mode: a multi-block
shape, s=160 with 64-row blocks, and a single-block shape) and through
``apex_tpu_torch.ops.flash_attention`` on the CPU (the plain version of
the Hopper kernel). Cases: causal and not, GQA (8 heads over 2 groups),
``kv_lengths`` (one of them 0: a batch row with no visible key),
``sliding_window``, ``sq != sk``, head_dim 64.

4D backward: the same inputs and a numpy-made cotangent through
``jax.vjp`` of the JAX ``flash_attention`` (its plain path, and in
interpret mode with small blocks the two-pass ``_dq_kernel`` /
``_dkv_kernel`` and the single-block ``_dqkv_single_kernel``) and torch
autograd of the port's (``flash_bwd_plain``, what Kernel I computes).
Cases: cross-attention (``sq != sk``) with ``kv_lengths`` and a 0 row,
causal with the offset, GQA, a window; f32 grads atol 1e-4. In bf16 each
grad element is held to 1 ulp plus ``flash_bwd_rounding_slack`` (the
backward rounds ds and p to bf16 before its products, as the JAX kernels
do): against the plain path's ``jax.vjp`` with a further term for delta,
which the port reads off the stored bf16 o and JAX's autograd off its fp32
o; against the interpret-mode kernels' backward on the same forward
residuals, with at most 0.1% of the elements past 1 ulp. The plain
backward is also held against autograd of the plain forward.

Packed QKV: a numpy-made packed projection goes through both packages'
``flash_attention_packed`` — forward, and backward through ``jax.vjp``
and torch autograd with the same cotangent — with the JAX side on its
plain path and on the Pallas kernels in interpret mode. Cases: causal,
GQA (``qpg = 2``), RoPE over half the head dim, a sliding window,
``kv_lengths`` with a row at 0, and hash dropout. ``hash_keep`` is held
bit for bit, and the plain backward against autograd of the plain
forward.

The bf16 rounding plans of the Hopper kernels are emulated on the CPU
and held to the plain versions: the forwards' (Kernels E and B: an online
softmax over 64-key tiles, p split into bf16 hi + lo) within 1 ulp, the
backwards' (Kernels F and I: ds and p rounded to bf16 once per tile) within
1 ulp plus the rounding slack, on one GPT-2 head and, in the 4D layout,
one head of the T5 cross-attention with a 0 length, causal sq > sk, a
window with the sk - sq offset, and GQA 12 over 4.

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
from apex_tpu_torch.ops import LAUNCHES, _build, flash_attention
from apex_tpu_torch.ops.attention import (
    _visible,
    drop_combo,
    flash_attention_packed,
    flash_bwd_cuda,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_fwd_cuda,
    flash_fwd_plain,
    flash_packed_bwd_cuda,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_cuda,
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
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention(q, q, q, causal=True, sliding_window=0)


# ---------------------------------------------------------------------------
# 4D backward
# ---------------------------------------------------------------------------

BWD_CASES = dict(CASES, **{
    # the encoder-decoder's cross-attention: 114 decoder queries over 200
    # encoder keys (scaled down), varlen keys with an empty row
    "cross_kv_lengths": (3, 4, 4, 28, 100, 64, False, [100, 37, 0], None),
    "cross_gqa": (2, 8, 2, 20, 70, 64, False, [70, 50], None),
})


def _bwd_run(case, seed=0, dtype="float32", **blocks):
    """(jax o, dq, dk, dv), (torch o, dq, dk, dv) with one cotangent, as
    fp32 numpy; in bf16 also the bound past 1 ulp (:func:`_bf16_slack`)."""
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    q, k, v, do = _bwd_inputs(case, seed)
    kvl = None if kvl is None else np.asarray(kvl, np.int32)
    jkvl = None if kvl is None else jnp.asarray(kvl)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo, vjp = jax.vjp(lambda a, bb, c: jax_flash(
        a, bb, c, causal=causal, sliding_window=window, kv_lengths=jkvl,
        **blocks), *(jnp.asarray(a, jdt) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tdo = torch.from_numpy(do).to(tdt)
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    before = dict(LAUNCHES)
    to = flash_attention(tq, tk, tv, causal=causal, sliding_window=window,
                         kv_lengths=tkvl)
    to.backward(tdo)
    assert LAUNCHES == before          # CPU tensors launch no kernel
    slack = None
    if dtype == BF16:
        slack = _bf16_slack(tq, tk, tv, tdo, tkvl, causal, window,
                            o_rounded=True)
    return ([_f32(a) for a in (jo, *jgrads)],
            [_f32(t) for t in (to, tq.grad, tk.grad, tv.grad)], slack)


def _bwd_inputs(case, seed):
    b, h, kvh, sq, sk, d = case[:6]
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d), (b, h, sq, d))]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bf16_slack(q, k, v, do, kvl, causal, window, o_rounded=False):
    """How far past 1 bf16 ulp a correct bf16 backward may land from another:
    ``flash_bwd_rounding_slack`` (the backward rounds ds and p to bf16
    before its products, as the JAX kernels do) on the port's forward
    residuals. With ``o_rounded``, also what the bf16 rounding of o moves
    delta = rowsum(do o) by, one bf16 step of each |do o| term, through ds
    into dq and dk: the port (like the JAX kernels) reads delta off the
    stored bf16 o, the JAX plain path's autograd off its fp32 o."""
    q, k, v = q.detach(), k.detach(), v.detach()
    args = (kvl, 1.0 / np.sqrt(q.shape[-1]), causal, window)
    o, lse = flash_fwd_plain(q, k, v, *args)
    slack = list(flash_bwd_rounding_slack(q, k, v, do, o, lse, *args))
    if o_rounded:
        p, _ = flash_bwd_factors(q, k, v, do, o, lse, *args)
        scale, group = args[1], q.shape[1] // k.shape[1]
        dd = 2.0 ** -8 * (do.float() * o.float()).abs().sum(-1)[..., None]
        ka = k.float().abs().repeat_interleave(group, dim=1)
        slack[0] = slack[0] + scale * dd * (p @ ka)
        dk = scale * torch.einsum("bhqk,bhqd->bhkd", p * dd, q.float().abs())
        b, kvh, sk, d = k.shape
        slack[1] = slack[1] + dk.reshape(b, kvh, group, sk, d).sum(dim=2)
    return [t.numpy() for t in slack]


def _check_bwd(want, got, slack=None):
    """f32: o atol 2e-5, grads atol 1e-4. bf16: o within 1 ulp, each grad
    within 1 ulp plus ``slack``."""
    names = ("o", "dq", "dk", "dv")
    if slack is None:
        np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
        for name, w, g in zip(names[1:], want[1:], got[1:]):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)
        return
    _check_bf16(names, want, got, [0.0] + slack)


def _check_bf16(names, want, got, slack, max_past_ulp=1.0):
    """Every element within 1 bf16 ulp plus its slack, and at most a share
    ``max_past_ulp`` of them past 1 ulp."""
    for name, w, g, sl in zip(names, want, got, slack):
        ulp = 2.0 ** -15 + 2.0 ** -7 * np.abs(w)
        e = np.abs(g - w)
        assert (e - ulp - sl).max() <= 0, \
            f"{name}: {(e - ulp - sl).max()} past the bound"
        assert (e > ulp).mean() <= max_past_ulp, \
            f"{name}: {(e > ulp).mean()} of the elements past 1 ulp"


def _kernel_bwd_run(case, blocks, seed=1):
    """In bf16, the JAX kernels' backward (``_flash_vjp_bwd`` with the
    Pallas path on) and the port's autograd backward, on the same forward
    residuals (the port's o and lse): the JAX kernel forward rounds p to
    bf16 before ``p v`` and the port's does not, so their o may differ by
    more than an ulp. Returns (jax dq, dk, dv), (torch dq, dk, dv), slack."""
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _bwd_inputs(case, seed))
    tkvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    o, lse = flash_fwd_plain(q, k, v, tkvl, scale, causal, window)
    block_q, block_k = jatt._auto_blocks(blocks.get("block_q"),
                                         blocks.get("block_k"), sk)
    bq = min(block_q, jatt.round_up(sq, 8))
    bk = min(block_k, jatt.round_up(sk, 128))
    to_jax = lambda t: jnp.asarray(_f32(t), t.dtype is torch.bfloat16  # noqa
                                   and jnp.bfloat16 or jnp.float32)
    res = (to_jax(q), to_jax(k), to_jax(v),
           None if kvl is None else jnp.asarray(kvl, jnp.int32),
           to_jax(o), to_jax(lse))
    want = jatt._flash_vjp_bwd(scale, causal, bq, bk, window, res,
                               to_jax(do))[:3]
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(tq, tk, tv, causal=causal, sliding_window=window,
                    kv_lengths=tkvl).backward(do)
    return ([_f32(a) for a in want], [_f32(t.grad) for t in (tq, tk, tv)],
            _bf16_slack(q, k, v, do, tkvl, causal, window))


BF16 = "bfloat16"


@pytest.mark.parametrize("name,dtype", [
    *((n, "float32") for n in BWD_CASES),
    *(pytest.param(n, BF16, id=f"{n}-bf16") for n in BWD_CASES)])
def test_backward_matches_jax_plain(jax_mode, name, dtype):
    jax_mode("off")
    _check_bwd(*_bwd_run(BWD_CASES[name], dtype=dtype))


INTERPRET_BWD = [
    # two-pass _dq_kernel + _dkv_kernel: cross-attention over 3 key blocks
    # with an empty row (interpret mode keeps the two-pass path for nq >= 2)
    ((3, 4, 2, 100, 160, 64, False, [160, 90, 0], None),
     dict(block_q=64, block_k=64)),
    # two-pass, causal with the sk - sq offset
    ((1, 4, 4, 72, 130, 64, True, None, None), dict(block_q=64, block_k=64)),
    # two-pass with a sliding window (banded grid), GQA
    ((1, 8, 2, 160, 160, 64, True, None, 40), dict(block_q=64, block_k=64)),
    # single block (_dqkv_single_kernel): the cross-attention shape
    ((2, 4, 4, 24, 100, 64, False, [100, 61], None), {}),
]


@pytest.mark.parametrize("case,blocks,dtype", [
    *((c, bl, "float32") for c, bl in INTERPRET_BWD),
    *(pytest.param(c, bl, BF16, id=f"case{i}-bf16")
      for i, (c, bl) in enumerate(INTERPRET_BWD))])
def test_backward_matches_jax_interpret_kernels(jax_mode, case, blocks,
                                                dtype):
    jax_mode("interpret")
    if dtype == BF16:
        # both round ds and p where the kernels do: few elements past 1 ulp
        # (a backward that rounds neither puts 6-12% of them there)
        _check_bf16(("dq", "dk", "dv"), *_kernel_bwd_run(case, blocks),
                    max_past_ulp=1e-3)
    else:
        _check_bwd(*_bwd_run(case, seed=1, **blocks))


def test_backward_of_an_empty_row_is_zero(jax_mode):
    jax_mode("off")
    _, got, _ = _bwd_run(BWD_CASES["cross_kv_lengths"])
    assert not any(np.any(g[2]) for g in got)


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_flash_bwd_plain_matches_autograd_of_plain_fwd(name):
    """The hand-written algebra (p from lse, delta = rowsum(do * o),
    ds = p * (dp - delta), dk/dv summed over the group) against torch
    autograd through the plain forward, f32 atol 2e-5."""
    b, h, kvh, sq, sk, d, causal, kvl, window = BWD_CASES[name]
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(b, n, s, d).astype(np.float32))
               .requires_grad_() for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
    do = torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32))
    kvl = None if kvl is None else torch.tensor(kvl)
    scale = 1.0 / np.sqrt(d)
    o, lse = flash_fwd_plain(q, k, v, kvl, scale, causal, window)
    o.backward(do)
    got = flash_bwd_plain(q.detach(), k.detach(), v.detach(), do, o.detach(),
                          lse.detach(), kvl, scale, causal, window)
    for g, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=2e-5,
                                   rtol=0)


def test_plain_forward_lse_of_an_empty_row():
    """The plain forward returns the lse Kernel B writes: 1e30 (the JAX
    ``_LSE_PAD``) on a row that sees no key, with o = 0 there."""
    q = torch.randn(2, 2, 5, 16)
    k = torch.randn(2, 2, 7, 16)
    o, lse = flash_fwd_plain(q, k, k, torch.tensor([7, 0]), 0.25, False)
    assert bool((lse[1] == 1e30).all()) and not o[1].any()
    want = torch.logsumexp(0.25 * q[0] @ k[0].transpose(-1, -2), dim=-1)
    torch.testing.assert_close(lse[0], want)


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


def _packed_bf16_inputs(case, seed):
    """bf16 qkv and do for one ``PACKED`` case, and the port's arguments
    ``(kv_lengths, rope, seed, rate, scale, causal, window, qpg, d)``."""
    s, b, g, qpg, d, kw = case
    rng = np.random.RandomState(seed)
    qkv, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .bfloat16() for shape in ((s, b, g * (qpg + 2) * d),
                                         (s, b, g * qpg * d)))
    kvl = kw.get("kv_lengths")
    rope = (None if "rot" not in kw
            else rope_tables(rope_freqs(0, s, kw["rot"], 10000.0), s, d))
    return qkv, do, (None if kvl is None else torch.tensor(kvl), rope,
                     kw.get("dropout_seed"), kw.get("dropout_rate", 0.0),
                     1.0 / np.sqrt(d), kw.get("causal", False),
                     kw.get("sliding_window"), qpg, d)


def _packed_kernel_bwd_run(case, seed=1):
    """In bf16, the JAX packed kernel's backward (``_flash_packed_vjp_bwd``
    with the Pallas path on) and the port's plain backward, on the same
    residuals: qkv, do, the JAX kernel forward's o and the port's lse (the
    JAX forward rounds p to bf16 before ``p v``, the port's keeps it in
    fp32, so the two o's may differ by more than an ulp; feeding both the
    same o keeps that out). Returns (jax dqkv), (torch dqkv), (slack) as
    fp32 numpy, the slack from ``flash_packed_bwd_rounding_slack``."""
    s, b, g, qpg, d, kw = case
    qkv, do, args = _packed_bf16_inputs(case, seed)
    kvl, rope, dseed, rate, scale, causal, window = args[:7]
    _, lse = flash_packed_fwd_plain(qkv, *args)
    jqkv = jnp.asarray(_f32(qkv), jnp.bfloat16)
    jkvl = None if kvl is None else jnp.asarray(kvl.numpy(), jnp.int32)
    jseed = None if not rate else jnp.asarray([dseed], jnp.int32)
    jkw = dict(kv_lengths=jkvl, causal=causal, sliding_window=window,
               dropout_rate=rate, dropout_seed=jseed)
    cos = sin = None
    rot = 0
    if rope is not None:
        cos, sin = (jnp.asarray(t.numpy()) for t in rope[:2])
        rot = rope[2]
        jkw["rope_freqs"] = jnp.asarray(
            rope_freqs(0, s, rot, 10000.0).reshape(s, rot).numpy())
    jo = jatt.flash_attention_packed(jqkv, queries_per_group=qpg,
                                     head_dim=d, **jkw)
    res = (jqkv, jkvl, cos, sin, jseed, jo,
           jnp.asarray(lse.numpy()).reshape(b, g * qpg, 1, s))
    want = jatt._flash_packed_vjp_bwd(scale, causal, window, qpg, d, rot,
                                      rate, res,
                                      jnp.asarray(_f32(do), jnp.bfloat16))[0]
    o = torch.from_numpy(_f32(jo)).bfloat16()
    got = flash_packed_bwd_plain(qkv, do, o, lse, *args)
    slack = flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
    return [_f32(want)], [_f32(got)], [slack.numpy()]


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_bwd_bf16_matches_jax_interpret_kernel(jax_mode, name):
    """The plain backward rounds ds and the dropped p to bf16 where
    ``_dqkv_packed_kernel`` does: every element of dqkv within 1 bf16 ulp
    plus ``flash_packed_bwd_rounding_slack``, at most 0.1% past 1 ulp (a
    backward that keeps them in fp32 puts ~9% there, up to ~34 ulps)."""
    jax_mode("interpret")
    s, b, g, qpg, d, _ = PACKED[name]
    assert jatt.packed_attention_supported(s, g, qpg, d)
    _check_bf16(("dqkv",), *_packed_kernel_bwd_run(PACKED[name]),
                max_past_ulp=1e-3)


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


def test_packed_gate_and_errors(monkeypatch):
    """The port's gate takes every shape its kernels take (any head_dim,
    length and group count), where the JAX Pallas gate also needs 128-lane
    cells; the geometry helper is the JAX package's. Past 512 the gate
    says yes and each kernel wrapper hands the head dim to its C entry (a
    stand-in library records the calls); the errors left are the
    layout's."""
    assert packed_geometry(16, 1, 64) == jatt.packed_geometry(16, 1, 64)
    assert packed_geometry(3, 1, 64) is None
    assert packed_attention_supported(2048, 3, 1, 64)
    assert packed_attention_supported(197, 16, 1, 128)
    assert packed_attention_supported(64, 2, 1, 256)
    assert packed_attention_supported(64, 1, 8, 256) == \
        jatt.packed_attention_supported(64, 1, 8, 256)
    assert packed_attention_supported(64, 2, 1, 264)
    assert packed_attention_supported(64, 2, 4, 512)
    assert packed_attention_supported(64, 1, 8, 512) == \
        jatt.packed_attention_supported(64, 1, 8, 512)
    assert packed_attention_supported(64, 2, 1, 520)
    d = 520
    qkv = torch.zeros(8, 1, 3 * d)
    q, o, lse = torch.zeros(1, 1, 8, d), torch.zeros(8, 1, d), \
        torch.zeros(1, 1, 8)
    calls = {}

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.setdefault(name, args) and 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    flash_fwd_cuda(q, q, q, None, 0.1, True)
    flash_bwd_cuda(q, q, q, q, q, lse[0, None], None, 0.1, True)
    flash_packed_fwd_cuda(qkv, None, None, None, 0.0, 0.1, True, None, 1, d)
    flash_packed_bwd_cuda(qkv, o, o, lse, None, None, None, 0.0, 0.1, True,
                          None, 1, d)
    assert [calls[n][i] for n, i in (
        ("apex_flash_fwd", 12), ("apex_flash_bwd", 17),
        ("apex_flash_packed_fwd", 13), ("apex_flash_packed_bwd", 17))] == \
        [d] * 4
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


# ---------------------------------------------------------------------------
# Kernels E's and B's bf16 rounding plan, emulated on the CPU
# ---------------------------------------------------------------------------

def _fwd_emulation(q, k, v, valid, scale, keep=None, rate=0.0, split=True,
                   tile=64):
    """The bf16 arithmetic of Kernels E and B, one (batch, head) pair per
    row of the leading dimension: q ``[n, sq, d]``, k and v ``[n, sk, d]``,
    ``valid`` ``[n or 1, sq, sk]`` (the mask, with the sk - sq offset),
    ``keep`` the dropout keep mask or None. An online softmax over
    ``tile``-key tiles with a running max, l from the undropped p, the
    dropped fp32 p split into bf16 hi + lo (or, with ``split=False``,
    rounded once to bf16) before its products with v, fp32 sums, and one
    round of o to bf16 at the end. Returns ``(o [n, sq, d], lse [n, sq])``;
    a row that sees no key gives o = 0 and lse = 1e30."""
    q, k, v = q.float(), k.float(), v.float()
    n, sq, d = q.shape
    m = torch.full((n, sq, 1), -1e30)
    l = torch.zeros(n, sq, 1)
    acc = torch.zeros(n, sq, d)
    for c0 in range(0, k.shape[1], tile):
        sl = slice(c0, c0 + tile)
        sc = torch.einsum("bqd,bkd->bqk", q, k[:, sl]) * scale
        sc = torch.where(valid[:, :, sl], sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(sc == -1e30, torch.zeros(()), torch.exp(sc - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[:, :, sl], p * (1.0 / (1.0 - rate)),
                            torch.zeros(()))
        hi = p.bfloat16().float()
        pv = hi @ v[:, sl]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ v[:, sl]
        acc = acc * alpha + pv
        m = m_new
    o = acc * torch.where(l > 0, 1.0 / l, torch.zeros(()))
    lse = torch.where(l > 0, m + torch.log(l), torch.tensor(1e30))
    return o.bfloat16(), lse[..., 0]


def _packed_keep(seed, rate, b, s):
    """The dropout keep mask ``[b, s, s]`` of head 0 of a one-head packed
    projection, or None without dropout."""
    if rate == 0.0:
        return None
    combo = drop_combo(torch.arange(b)[:, None, None, None],
                       torch.zeros(1, 1, 1, 1, dtype=torch.long))
    return hash_keep(seed, combo, (b, 1, s, s), rate)[:, 0]


def _kernel_e_emulation(qkv, kv_lengths, seed, rate, scale, causal,
                        split=True, tile=64):
    """Kernel E's bf16 arithmetic (:func:`_fwd_emulation`) for one head
    (groups 1, qpg 1). Returns ``(o [s, b, d], lse [b, 1, s])`` as
    ``flash_packed_fwd_plain`` lays them out."""
    s, b, w = qkv.shape
    t = qkv.reshape(s, b, 3, w // 3).permute(1, 2, 0, 3)
    kvl = None if kv_lengths is None else torch.as_tensor(kv_lengths)
    valid = _visible(s, s, kvl, causal, None, "cpu")[:, 0]
    o, lse = _fwd_emulation(t[:, 0], t[:, 1], t[:, 2], valid, scale,
                            _packed_keep(seed, rate, b, s), rate, split, tile)
    return o.permute(1, 0, 2), lse[:, None]


def _heads_4d(q, k, kv_lengths, causal, window):
    """``[b, h, sq, d]`` q and ``[b, kvh, sk, d]`` k as the one-head rows
    of the emulations: ``(n, k and v repeat, valid [b h, sq, sk])``."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    valid = _visible(sq, sk, kv_lengths, causal, window, "cpu")
    valid = valid.expand(b, h, sq, sk).reshape(b * h, sq, sk)
    group = h // k.shape[1]
    return b * h, (lambda t: t.repeat_interleave(group, dim=1).reshape(
        b * h, sk, -1)), valid


def _kernel_b_emulation(q, k, v, kv_lengths, scale, causal, window):
    """Kernel B's bf16 arithmetic (:func:`_fwd_emulation`) over
    ``[b, h, s, d]`` with GQA. Returns ``(o [b, h, sq, d], lse [b, h,
    sq])``."""
    b, h, sq, d = q.shape
    n, kv, valid = _heads_4d(q, k, kv_lengths, causal, window)
    o, lse = _fwd_emulation(q.reshape(n, sq, d), kv(k), kv(v), valid, scale)
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _within_one_bf16_ulp(got, want) -> bool:
    """The card tests' bf16 tolerance (``assert_close_once_rounded``): one
    rounding step of 2^-7 of the magnitude, floored at 2^-15 near 0."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -15 + 2.0 ** -7 * w.abs()).all())


ROUNDING_CASES = {
    # name: (s, b, causal, kv_lengths, rate): one head of the GPT-2
    # training shape, the same with dropout, and kv_lengths with a 0 row
    "gpt2_causal_s1024": (1024, 1, True, None, 0.0),
    "gpt2_causal_s1024_dropout": (1024, 1, True, None, 0.1),
    "kv_lengths_with_zero": (256, 3, False, [256, 100, 0], 0.0),
}


def _rounding_inputs(s, b, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(s, b, 3 * 64).astype(
        np.float32)).bfloat16()


@pytest.mark.parametrize("name", list(ROUNDING_CASES))
def test_kernel_e_rounding_plan_holds_one_ulp(name):
    """p split into bf16 hi + lo keeps Kernel E's bf16 o within one bf16
    ulp of the plain version (p in fp32) and lse within 1e-4; a row that
    sees no key is 0 with lse 1e30."""
    s, b, causal, kvl, rate = ROUNDING_CASES[name]
    qkv = _rounding_inputs(s, b)
    kvl_t = None if kvl is None else torch.tensor(kvl)
    seed = -1234567 if rate else None
    args = (kvl_t, None, seed, rate, 0.125, causal, None, 1, 64)
    want_o, want_lse = flash_packed_fwd_plain(qkv, *args)
    got_o, got_lse = _kernel_e_emulation(qkv, kvl, seed, rate, 0.125,
                                         causal)
    assert _within_one_bf16_ulp(got_o.reshape(want_o.shape), want_o)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-6)
    if kvl is not None and 0 in kvl:
        row = kvl.index(0)
        assert not got_o[:, row].any()
        assert bool((got_lse[row] == 1e30).all())


def test_kernel_e_single_bf16_p_misses_one_ulp():
    """Why the kernel splits p: rounded once to bf16 before P V, p puts o
    past one bf16 ulp of the plain version at s 1024."""
    s, b, causal, _, _ = ROUNDING_CASES["gpt2_causal_s1024"]
    qkv = _rounding_inputs(s, b)
    want_o, _ = flash_packed_fwd_plain(qkv, None, None, None, 0.0, 0.125,
                                       causal, None, 1, 64)
    got_o, _ = _kernel_e_emulation(qkv, None, None, 0.0, 0.125, causal,
                                   split=False)
    assert not _within_one_bf16_ulp(got_o.reshape(want_o.shape), want_o)


# ---------------------------------------------------------------------------
# Kernels F's and I's bf16 rounding plan, emulated on the CPU
# ---------------------------------------------------------------------------

def _bwd_emulation(q, k, v, do, o, lse, valid, scale, keep=None, rate=0.0,
                   tile=64):
    """The bf16 arithmetic of Kernels F and I, as their passes order it,
    one (batch, head) pair per row of the leading dimension (q, do, o
    ``[n, sq, d]``, k, v ``[n, sk, d]``, lse ``[n, sq]``, ``valid`` ``[n or
    1, sq, sk]``): delta = rowsum(do * o); the dq pass walks ``tile``-key
    tiles, the dk/dv pass ``tile``-query tiles, each recomputing the tile's
    fp32 scores and dp, p = 2^((scale s - lse) log2 e) (0 where masked),
    the dropout keep mask on dp and p, ds = p (dp - delta), then ds and the
    dropped p rounded to bf16 per tile before their products, which are
    summed over tiles in fp32. Returns fp32 ``(scale dq, scale dk, dv)``
    before the one rounding."""
    q, k, v, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    log2e = 1.4426950408889634

    def factors(rows, cols):
        """p (dropped) and ds of the tile rows x cols, rounded to bf16."""
        x = torch.einsum("bqd,bkd->bqk", q[:, rows], k[:, cols]) * scale
        x = torch.where(valid[:, rows, cols], x - lse[:, rows, None],
                        torch.tensor(-1e30))
        p = torch.exp2(x * log2e)
        dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], v[:, cols])
        pd = p
        if keep is not None:
            kp = keep[:, rows, cols]
            dp = torch.where(kp, dp * (1.0 / (1.0 - rate)), torch.zeros(()))
            pd = torch.where(kp, p * (1.0 / (1.0 - rate)), torch.zeros(()))
        ds = p * (dp - delta[:, rows, None])
        return pd.bfloat16().float(), ds.bfloat16().float()

    sq, sk = q.shape[1], k.shape[1]
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, sk, tile):                           # the dq pass
        cols = slice(c0, c0 + tile)
        _, ds = factors(slice(0, sq), cols)
        dq = dq + ds @ k[:, cols]
    for r0 in range(0, sq, tile):                           # the dk/dv pass
        rows = slice(r0, r0 + tile)
        pd, ds = factors(rows, slice(0, sk))
        dk = dk + ds.transpose(1, 2) @ q[:, rows]
        dv = dv + pd.transpose(1, 2) @ dof[:, rows]
    return dq * scale, dk * scale, dv


def _kernel_f_emulation(qkv, do, o, lse, seed, rate, scale, causal,
                        tile=64):
    """Kernel F's bf16 arithmetic (:func:`_bwd_emulation`) for one head
    (groups 1, qpg 1). Returns dqkv in the packed layout, rounded to
    bf16."""
    s, b, w = qkv.shape
    d = w // 3
    t = qkv.reshape(s, b, 3, d).permute(1, 2, 0, 3)
    rows = lambda x: x.reshape(s, b, d).permute(1, 0, 2)  # noqa: E731
    valid = _visible(s, s, None, causal, None, "cpu")[:, 0]
    grads = _bwd_emulation(t[:, 0], t[:, 1], t[:, 2], rows(do), rows(o),
                           lse[:, 0], valid, scale,
                           _packed_keep(seed, rate, b, s), rate, tile)
    out = torch.stack(grads, dim=2)                         # [b, s, 3, d]
    return out.permute(1, 0, 2, 3).reshape(s, b, w).bfloat16()


def _kernel_i_emulation(q, k, v, do, o, lse, kv_lengths, scale, causal,
                        window):
    """Kernel I's bf16 arithmetic (:func:`_bwd_emulation`) over
    ``[b, h, s, d]`` with GQA: dk and dv summed over each group's query
    heads in fp32 before the one rounding. Returns ``(dq, dk, dv)`` in
    bf16."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    n, kv, valid = _heads_4d(q, k, kv_lengths, causal, window)
    flat = lambda t: t.reshape(n, sq, -1)  # noqa: E731
    dq, dk, dv = _bwd_emulation(flat(q), kv(k), kv(v), flat(do), flat(o),
                                lse.reshape(n, sq), valid, scale)
    group = lambda t: t.reshape(b, kvh, h // kvh, sk, d).sum(2)  # noqa
    return (dq.reshape(b, h, sq, d).bfloat16(), group(dk).bfloat16(),
            group(dv).bfloat16())


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_kernel_f_rounding_plan_holds_one_ulp(rate):
    """ds and the dropped p formed per 64-wide tile in fp32 and rounded to
    bf16 once each, as Kernel F's bf16 path does, keep dqkv at one head of
    the GPT-2 training shape (s 1024, causal) within 1 bf16 ulp of the
    repaired plain version plus ``flash_packed_bwd_rounding_slack``, with
    at most 0.1% of the elements past 1 ulp."""
    s, b = 1024, 1
    rng = np.random.RandomState(4)
    qkv, do = (torch.from_numpy(rng.randn(s, b, n).astype(np.float32))
               .bfloat16() for n in (3 * 64, 64))
    seed = -1234567 if rate else None
    args = (None, None, seed, rate, 0.125, True, None, 1, 64)
    o, lse = flash_packed_fwd_plain(qkv, *args)
    want = flash_packed_bwd_plain(qkv, do, o, lse, *args)
    slack = flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
    got = _kernel_f_emulation(qkv, do, o, lse, seed, rate, 0.125, True)
    _check_bf16(("dqkv",), [_f32(want)], [_f32(got)], [slack.numpy()],
                max_past_ulp=1e-3)


#: (b, h, kvh, sq, sk, causal, kv_lengths, window): one head of the T5
#: cross-attention (114 queries over 512 keys, kv_lengths with a 0 row),
#: causal with sq > sk (the first sq - sk rows see no key), a window with
#: the sk - sq offset and a length, GQA 12 over 4
KERNEL_BI_CASES = {
    "t5_cross_one_head": (3, 1, 1, 114, 512, False, [512, 300, 0], None),
    "sq_gt_sk_causal": (1, 2, 2, 200, 130, True, None, None),
    "window_offset": (1, 2, 2, 160, 300, True, [280], 64),
    "gqa_12_over_4": (1, 12, 4, 128, 192, True, None, None),
}


def _kernel_bi_inputs(case, seed=5):
    b, h, kvh, sq, sk, causal, kvl, window = case
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _bwd_inputs(
        (b, h, kvh, sq, sk, 64), seed))
    kvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    return q, k, v, do, (kvl, 0.125, causal, window)


def _no_key_rows(case):
    """``(batch, query row)`` pairs that see no key."""
    b, _, _, sq, sk, causal, kvl, _ = case
    lengths = [sk] * b if kvl is None else kvl
    return [(bb, r) for bb in range(b) for r in range(sq)
            if lengths[bb] == 0 or (causal and r + sk - sq < 0)]


@pytest.mark.parametrize("name", list(KERNEL_BI_CASES))
def test_kernel_b_rounding_plan_holds_one_ulp(name):
    """Kernel B's bf16 plan (Kernel E's: p split into bf16 hi + lo before
    P V, an online softmax over 64-key tiles) keeps o within one bf16 ulp
    of the plain version (p in fp32) and lse within 1e-4, with the sk - sq
    offset, kv_lengths, a window and GQA; a row that sees no key is 0 with
    lse 1e30."""
    case = KERNEL_BI_CASES[name]
    q, k, v, _, args = _kernel_bi_inputs(case)
    want_o, want_lse = flash_fwd_plain(q, k, v, *args)
    got_o, got_lse = _kernel_b_emulation(q, k, v, *args)
    assert _within_one_bf16_ulp(got_o, want_o)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-6)
    empty = _no_key_rows(case)
    assert empty or name != "sq_gt_sk_causal"
    for bb, r in empty:
        assert not got_o[bb, :, r].any()
        assert bool((got_lse[bb, :, r] == 1e30).all())


@pytest.mark.parametrize("name", list(KERNEL_BI_CASES))
def test_kernel_i_rounding_plan_holds_one_ulp(name):
    """Kernel I's bf16 plan (Kernel F's: ds and p formed per 64-wide tile
    in fp32 and rounded to bf16 once each, dk and dv summed over a group's
    heads in fp32) keeps dq, dk and dv within 1 bf16 ulp of the plain
    version plus ``flash_bwd_rounding_slack``, with at most 0.1% of the
    elements past 1 ulp; a batch row with kv_length 0 gets zero
    gradients."""
    case = KERNEL_BI_CASES[name]
    q, k, v, do, args = _kernel_bi_inputs(case)
    o, lse = flash_fwd_plain(q, k, v, *args)
    want = flash_bwd_plain(q, k, v, do, o, lse, *args)
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    got = _kernel_i_emulation(q, k, v, do, o, lse, *args)
    _check_bf16(("dq", "dk", "dv"), [_f32(w) for w in want],
                [_f32(g) for g in got], [sl.numpy() for sl in slack],
                max_past_ulp=1e-3)
    kvl = case[6]
    if kvl is not None and 0 in kvl:
        assert not any(t[kvl.index(0)].any() for t in got)
