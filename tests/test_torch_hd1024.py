"""Head dims past 512 (Kernels B, I, E and F walk d in parts of 512
columns; Kernel C's element path cuts its query rows into chunks) against
the JAX package, on the CPU.

The plain versions the wrappers run on a CPU tensor, and which the card
checks hold each kernel to, are einsums over any head dim; these tests
hold them to the JAX package's Pallas kernels in interpret mode, which
take any head dim (``_pad_qkv`` pads d to a multiple of 64):

- packed QKV (Kernels E and F) at head_dim 1024 in f32: 4 query heads
  over one K/V group with RoPE over all 1024 columns, a sliding window,
  ``kv_lengths`` holding a 0 row and hash dropout, and in bf16 RoPE over
  640 columns (rot / 2 = 320: pairs that straddle the kernels'
  512-column parts), against ``_fwd_packed_kernel`` and
  ``_dqkv_packed_kernel`` (JAX's 128-lane packed geometry takes d 1024);
- 4D (Kernels B and I): GQA 4:1 causal with ``kv_lengths`` and a 0 row
  at head_dim 1024 in bf16;
- head_dim 840 (fp16), 1030 (bf16) and 2048 (f32): the packed plain
  versions on a packed qkv and the 4D ones on its unpacked q, k and v,
  against one run of the 4D kernels (causal GQA; at 2048 not causal, a
  0 length). JAX's packed gate refuses 840 and 1030 (no 128-lane
  geometry; d % 8 != 0) and takes 2048, whose packed run the d-1024 cases
  stand for;
- ``flash_chunk_fwd/bwd`` at global offsets at head_dim 1024, in f32, bf16
  and fp16, against JAX's chunk functions;

so each of the three dtypes meets both kernel pairs past 512 (an
interpret-mode JAX kernel costs ~1-2 s to trace whatever its shape, so
the file does not run every dtype at every width), with the tolerances
of ``test_torch_hd512.py``: f32 o atol 2e-5 and gradients atol 1e-4; in
bf16 and fp16 o within 1 ulp plus one rounding step of each
unnormalised p times |v| (the JAX kernels round p to the input type
before P V, the plain versions keep it fp32), and the gradients within 1
ulp plus the rounding slack of ds and p, at most 0.1% of the elements
past 1 ulp (0.8% for Kernel I in fp16), the 1-ulp floor of the
gradients' magnitudes scaled by d / 256 past 256 (:func:`backward_floor`,
unchanged past 512: these comparisons pass it).

The wrappers of B, I, E and F take any head dim: on CUDA tensors they
hand d past 512 to their C entries, E and F with their scratch (the
rotated copy of qkv under RoPE; F's fp32 dq and dk), which a stand-in
library records here.

Kernel C: ``decode_plain`` against JAX's ``_reference`` at head_dim 1024
with 32 query rows (GQA 8:1 under a w = 4 window) and at 2048 with 16
(f32 atol 2e-5), and ``paged_decode_plan`` on the element path: the
parent's plan (all of a kv head's rows) wherever ``element_tile`` finds a
tile for them, else the fewest equal row chunks that leave one, every
block's shared memory within an H100's, and ``ValueError`` past
``ELEMENT_MAX_HEAD_DIM`` (14526).

Then a tiny GPT with 1024-wide heads (2 layers, hidden 2048, 2 query
heads over one K/V group, SwiGLU, RMSNorm, RoPE, vocab 128, s 32): its
f32 loss and every gradient leaf against the JAX ``GPTModel``, and three
``FusedAdam`` steps' losses; in bf16 (slow) three steps to rtol 2e-2.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import attention as jatt
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops.decode_attention import _reference
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.convert import grads_to_jax, params_to_jax
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.ops import LAUNCHES, _build, flash_attention
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops.attention import (
    _packed_bwd_factors,
    _qk,
    _unpack,
    backward_floor,
    flash_attention_packed,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_chunk_bwd,
    flash_chunk_fwd,
    flash_fwd_plain,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_plain,
    packed_attention_supported,
    rounding_step,
)
from apex_tpu_torch.ops.decode_attention import (
    ELEMENT_MAX_HEAD_DIM,
    element_chunks,
    element_tile,
    fused_paged_decode_attention,
    page_pool,
    paged_decode_plan,
    paged_decode_smem,
)
from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

DTYPES = ["float32", "bfloat16", "float16"]
#: an H100 block's shared memory (the kernels' static_assert)
SMEM = 232448


def _cases(table):
    """(case, dtype) pairs: the dtype, or the dtypes, each case names."""
    return [(n, dt) for n, case in table.items()
            for dt in ([case[-1]] if isinstance(case[-1], str)
                       else case[-1])]


PACKED = {
    # name: (s, b, groups, qpg, d, kwargs, dtype or dtypes)
    "gqa4_rope1024_window_kv_lengths_0_dropout": (
        40, 2, 1, 4, 1024, dict(causal=True, rot=1024, sliding_window=17,
                                kv_lengths=[30, 0], dropout_rate=0.2,
                                dropout_seed=-7), "float32"),
    "gqa4_rope640_dropout": (
        40, 1, 1, 4, 1024, dict(causal=True, rot=640, dropout_rate=0.1,
                                dropout_seed=11), "bfloat16"),
}

FLASH = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window, dtype)
    "gqa4_causal_kv_lengths_0": (2, 4, 1, 40, 40, 1024, True, [33, 0], None,
                                 "bfloat16"),
}

#: widths held to the 4D kernels, for E/F and B/I at once: (s, b, groups,
#: qpg, d, causal, kv_lengths, dtype)
OFF_LANES = {
    "d840_gqa_causal_kv_lengths": (36, 1, 2, 2, 840, True, [23], "float16"),
    "d1030_gqa_causal": (36, 1, 1, 2, 1030, True, None, "bfloat16"),
    "d2048_gqa_kv_lengths_0": (24, 2, 1, 2, 2048, False, [24, 0],
                               "float32"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these CPU ops are small, and beside busy test
    workers a thread per core makes them crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_half(name, want, got, dtype, slack=0.0, max_past_ulp=1.0,
                floor=2.0 ** -8):
    """Every element within 1 ulp of ``dtype`` (2^-7 or 2^-10 of the
    magnitude, floored at magnitude ``floor``) plus ``slack``, at most a
    share ``max_past_ulp`` past 1 ulp."""
    eps = float(torch.finfo(dtype).eps)
    one = floor * eps + eps * np.abs(want)
    e = np.abs(got - want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    assert (e - one - slack).max() <= 0, \
        f"{name}: {(e - one - slack).max()} past the bound"
    assert (e > one).mean() <= max_past_ulp, \
        f"{name}: {(e > one).mean()} of the elements past 1 ulp"


def _check(name, want, got, dtype, slack, max_past_ulp=1.0,
           floor=2.0 ** -8):
    """f32: o atol 2e-5, gradients atol 1e-4; 16-bit: 1 ulp plus
    ``slack`` (:func:`_check_half`)."""
    assert got.dtype == dtype, name
    want, got = _f32(want), _f32(got)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5 if name == "o"
                                   else 1e-4, rtol=0, err_msg=name)
    else:
        _check_half(name, want, got, dtype, _f32(slack), max_past_ulp,
                    floor)


# ---------------------------------------------------------------------------
# Kernels E and F: packed QKV
# ---------------------------------------------------------------------------

def _packed_inputs(case, seed, dtype):
    """qkv and do in ``dtype``, the port's arguments ``(kv_lengths, rope,
    seed, rate, scale, causal, window, qpg, d)`` and the JAX keywords."""
    s, b, g, qpg, d, kw, _ = case
    rng = np.random.RandomState(seed)
    qkv, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dtype) for shape in ((s, b, g * (qpg + 2) * d),
                                        (s, b, g * qpg * d)))
    kvl, rot = kw.get("kv_lengths"), kw.get("rot", 0)
    rate = kw.get("dropout_rate", 0.0)
    rope = None if not rot else rope_tables(rope_freqs(0, s, rot, 10000.0),
                                            s, d)
    args = (None if kvl is None else torch.tensor(kvl), rope,
            kw.get("dropout_seed"), rate, 1.0 / np.sqrt(d),
            kw.get("causal", False), kw.get("sliding_window"), qpg, d)
    jkw = dict(causal=args[5], sliding_window=args[6], dropout_rate=rate,
               kv_lengths=None if kvl is None else jnp.asarray(kvl,
                                                               jnp.int32),
               dropout_seed=None if not rate else jnp.asarray(
                   [kw["dropout_seed"]], jnp.int32))
    if rot:
        jkw["rope_freqs"] = jnp.asarray(
            rope_freqs(0, s, rot, 10000.0).reshape(s, rot).numpy())
    return qkv, do, args, jkw


@pytest.mark.parametrize("name,dtype", _cases(PACKED))
def test_packed_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """E's plain version (through ``flash_attention_packed`` on CPU
    tensors) against ``_fwd_packed_kernel``, F's against
    ``_dqkv_packed_kernel`` on the same residuals (JAX's o, the port's
    lse), both in interpret mode at head_dim 1024, RoPE over all of it or
    over 640 columns; a kv_length-0 row is zero in o and dqkv."""
    jax_mode("interpret")
    s, b, g, qpg, d, kw, _ = PACKED[name]
    assert jatt.packed_attention_supported(s, g, qpg, d)
    assert packed_attention_supported(s, g, qpg, d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qkv, do, args, jkw = _packed_inputs(PACKED[name], 4, tdt)
    jqkv = jnp.asarray(_f32(qkv), jdt)
    jo = jatt.flash_attention_packed(jqkv, queries_per_group=qpg,
                                     head_dim=d, **jkw)
    before = dict(LAUNCHES)
    o = flash_attention_packed(
        qkv, queries_per_group=qpg, head_dim=d, causal=args[5],
        sliding_window=args[6], kv_lengths=args[0],
        rope_freqs=rope_freqs(0, s, kw["rot"], 10000.0).reshape(s,
                                                                kw["rot"]),
        dropout_rate=args[3], dropout_seed=args[2])
    assert LAUNCHES == before           # CPU tensors launch no kernel
    _, lse = flash_packed_fwd_plain(qkv, *args)
    _, _, _, pd, _ = _packed_bwd_factors(qkv, do, o, lse, *args)
    _, _, v = _qk(qkv, qpg, d, args[1])
    h = g * qpg
    slack = torch.einsum("bhqk,bhkd->bhqd", rounding_step(pd, tdt),
                         v.float().abs())
    _check("o", jo, o, tdt, slack.permute(2, 0, 1, 3).reshape(s, b, h * d))
    cos, sin = (jnp.asarray(t.numpy()) for t in args[1][:2])
    res = (jqkv, jkw["kv_lengths"], cos, sin, jkw["dropout_seed"], jo,
           jnp.asarray(lse.numpy()).reshape(b, h, 1, s))
    want = jatt._flash_packed_vjp_bwd(
        args[4], args[5], args[6], qpg, d, kw.get("rot", 0), args[3], res,
        jnp.asarray(_f32(do), jdt))[0]
    jo_t = torch.from_numpy(_f32(jo).copy()).to(tdt)
    dqkv = flash_packed_bwd_plain(qkv, do, jo_t, lse, *args)
    _check("dqkv", want, dqkv, tdt,
           flash_packed_bwd_rounding_slack(qkv, do, jo_t, lse, *args),
           max_past_ulp=1e-3, floor=backward_floor(d))
    if kw.get("kv_lengths"):
        r = kw["kv_lengths"].index(0)
        assert not o[:, r].any() and not dqkv[:, r].any()


# ---------------------------------------------------------------------------
# Kernels B and I: [b, h, s, d]
# ---------------------------------------------------------------------------

def _jax_4d(q, k, v, do, o, lse, kvl, scale, causal, window, jdt):
    """The JAX 4D kernels (interpret mode): o from ``flash_attention``,
    (dq, dk, dv) from ``_flash_vjp_bwd`` on the port's o and lse."""
    jx = lambda t: jnp.asarray(_f32(t), jdt)  # noqa: E731
    jkvl = None if kvl is None else jnp.asarray(kvl.numpy(), jnp.int32)
    sq, sk = q.shape[2], k.shape[2]
    want_o = jax_flash(jx(q), jx(k), jx(v), causal=causal,
                       sliding_window=window, kv_lengths=jkvl)
    block_q, block_k = jatt._auto_blocks(None, None, sk)
    res = (jx(q), jx(k), jx(v), jkvl, jx(o), jnp.asarray(lse.numpy()))
    grads = jatt._flash_vjp_bwd(scale, causal,
                                min(block_q, jatt.round_up(sq, 8)),
                                min(block_k, jatt.round_up(sk, 128)), window,
                                res, jx(do))[:3]
    return want_o, grads


def _grad_checks(want, grads, slack, tdt, d):
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g_, tdt, sl,
               max_past_ulp=8e-3 if tdt == torch.float16 else 1e-3,
               floor=backward_floor(d))


@pytest.mark.parametrize("name,dtype", _cases(FLASH))
def test_flash_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """B's plain version (through ``flash_attention`` on CPU tensors)
    against ``_fwd_single_kernel``, I's against ``_dqkv_single_kernel`` on
    the port's o and lse, both in interpret mode at head_dim 1024; a
    kv_length-0 row gets o = 0 and zero gradients."""
    jax_mode("interpret")
    b, h, kvh, sq, sk, d, causal, kvl, window, _ = FLASH[name]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(tdt) for shape in ((b, h, sq, d), (b, kvh, sk, d),
                                          (b, kvh, sk, d), (b, h, sq, d)))
    tkvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    args = (tkvl, scale, causal, window)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=causal, sliding_window=window,
                        kv_lengths=tkvl)
    assert LAUNCHES == before           # CPU tensors launch no kernel
    _, lse = flash_fwd_plain(q, k, v, *args)
    want_o, want = _jax_4d(q, k, v, do, o, lse, tkvl, scale, causal, window,
                           jdt)
    p, _ = flash_bwd_factors(q, k, v, o, o, lse, *args)
    _check("o", want_o, o, tdt, torch.einsum(
        "bhqk,bhkd->bhqd", rounding_step(p, tdt),
        v.float().abs().repeat_interleave(h // kvh, dim=1)))
    grads = flash_bwd_plain(q, k, v, do, o, lse, *args)
    _grad_checks(want, grads,
                 flash_bwd_rounding_slack(q, k, v, do, o, lse, *args), tdt,
                 d)
    r = kvl.index(0)
    assert not o[r].any() and not any(g_[r].any() for g_ in grads)


@pytest.mark.parametrize("name,dtype", _cases(OFF_LANES))
def test_plain_past_512_match_jax_4d_kernels(jax_mode, name, dtype):
    """At head_dim 840, 1030 and 2048 E's and F's plain versions (on the
    packed qkv) and B's and I's (through ``flash_attention`` on the
    unpacked q, k and v) are held to one run of the 4D kernels on the
    unpacked q, k and v: o against ``flash_attention``, the gradients
    against ``_flash_vjp_bwd``. JAX's packed gate takes only the 128-lane
    width among them."""
    jax_mode("interpret")
    s, b, g, qpg, d, causal, kvl, _ = OFF_LANES[name]
    assert jatt.packed_attention_supported(s, g, qpg, d) == (d == 2048)
    assert packed_attention_supported(s, g, qpg, d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qkv, do, args, _ = _packed_inputs(
        (s, b, g, qpg, d, dict(causal=causal, kv_lengths=kvl), None), 8, tdt)
    o = flash_attention_packed(qkv, queries_per_group=qpg, head_dim=d,
                               causal=causal, kv_lengths=args[0])
    _, lse = flash_packed_fwd_plain(qkv, *args)
    q, k, v = (t.contiguous() for t in _unpack(qkv, qpg, d))
    h = g * qpg
    o4 = o.reshape(s, b, h, d).permute(1, 2, 0, 3).contiguous()
    do4 = do.reshape(s, b, h, d).permute(1, 2, 0, 3).contiguous()
    want_o, want = _jax_4d(q, k, v, do4, o4, lse, args[0], args[4], causal,
                           None, jdt)
    _, _, _, pd, _ = _packed_bwd_factors(qkv, do, o, lse, *args)
    slack = torch.einsum("bhqk,bhkd->bhqd", rounding_step(pd, tdt),
                         v.float().abs().repeat_interleave(qpg, dim=1))
    _check("o", want_o, o4, tdt, slack)
    dqkv = flash_packed_bwd_plain(qkv, do, o, lse, *args)
    slack = flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
    _grad_checks(want, [t.contiguous() for t in _unpack(dqkv, qpg, d)],
                 [t.contiguous() for t in _unpack(slack, qpg, d)], tdt, d)
    # B and I on the same q, k, v and residuals
    before = dict(LAUNCHES)
    o_b = flash_attention(q, k, v, causal=causal, kv_lengths=args[0])
    assert LAUNCHES == before           # CPU tensors launch no kernel
    p, _ = flash_bwd_factors(q, k, v, o4, o4, lse, args[0], args[4], causal)
    _check("o", want_o, o_b, tdt, torch.einsum(
        "bhqk,bhkd->bhqd", rounding_step(p, tdt),
        v.float().abs().repeat_interleave(qpg, dim=1)))
    bargs = (args[0], args[4], causal, None)
    _grad_checks(want, flash_bwd_plain(q, k, v, do4, o4, lse, *bargs),
                 flash_bwd_rounding_slack(q, k, v, do4, o4, lse, *bargs),
                 tdt, d)
    if kvl and 0 in kvl:
        r = kvl.index(0)
        assert not o[:, r].any() and not dqkv[:, r].any()


# ---------------------------------------------------------------------------
# The chunk functions at global offsets, head_dim 1024
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_plain_matches_jax_chunks_at_head_dim_1024(jax_mode, dtype):
    """``flash_chunk_fwd/bwd`` on CPU tensors (their plain versions) at a
    diagonal pair of a 48-position sequence in chunks of 16 (GQA 4:2, a
    window of 11, global kv_lengths ending inside and after the chunk) at
    head_dim 1024, against JAX's chunk functions on their plain path, with
    the global lse and delta of the whole sequence."""
    jax_mode("off")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    b, h, kvh, s, c, d, window = 2, 4, 2, 48, 16, 1024, 11
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(tdt) for shape in ((b, h, s, d), (b, kvh, s, d),
                                          (b, kvh, s, d), (b, h, s, d)))
    kvl = torch.tensor([40, 48], dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    o, lse = flash_fwd_plain(q, k, v, kvl, scale, True, window)
    delta = (do.float() * o.float()).sum(-1)
    rows = cols = slice(2 * c, 3 * c)
    qc, kc, vc, doc = q[:, :, rows], k[:, :, cols], v[:, :, cols], \
        do[:, :, rows]
    lse_c, delta_c = lse[:, :, rows], delta[:, :, rows]
    kw = dict(q_start=2 * c, k_start=2 * c, causal=True, window=window,
              kv_lengths=kvl, softmax_scale=scale)
    before = dict(LAUNCHES)
    co, clse = flash_chunk_fwd(qc, kc, vc, **kw)
    grads = flash_chunk_bwd(qc, kc, vc, doc, lse_c, delta_c, **kw)
    assert LAUNCHES == before            # CPU tensors launch no kernel
    jx = lambda t: jnp.asarray(_f32(t), jdt)  # noqa: E731
    jkw = dict(kw, kv_lengths=jnp.asarray(kvl.numpy()))
    jo, jlse = jatt.flash_chunk_fwd(jx(qc), jx(kc), jx(vc), **jkw)
    _check("o", jo, co, tdt, 0.0)
    np.testing.assert_allclose(_f32(clse), _f32(jlse), atol=1e-5, rtol=1e-6)
    want = jatt.flash_chunk_bwd(jx(qc), jx(kc), jx(vc), jx(doc),
                                jnp.asarray(lse_c.numpy()),
                                jnp.asarray(delta_c.numpy()), **jkw)
    args = (kvl, scale, True, window, 2 * c, 2 * c)
    slack = flash_bwd_rounding_slack(qc, kc, vc, doc, None, lse_c, *args,
                                     delta=delta_c)
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g_, tdt, sl, floor=backward_floor(d))


# ---------------------------------------------------------------------------
# The wrappers take any head dim
# ---------------------------------------------------------------------------

class _Lib:
    """A stand-in for the kernel library: records each entry's arguments
    and reports success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("d,rot", [(1024, 1024), (840, 0), (1030, 640),
                                   (2048, 0), (512, 512)])
def test_wrappers_hand_any_head_dim_to_the_kernels(monkeypatch, d, rot):
    """``flash_fwd_cuda``, ``flash_bwd_cuda``, ``flash_packed_fwd_cuda``
    and ``flash_packed_bwd_cuda`` pass d past 512 to their C entries (a
    stand-in library here): E and F with a rotated copy of qkv (qkv's
    shape and dtype) only under RoPE, F with its fp32 dq/dk scratch [s, b,
    G (qpg + 1), d] only past 512; each wrapper counts one launch."""
    lib = _Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    s, b, g, qpg = 8, 1, 1, 2
    qkv = torch.zeros(s, b, g * (qpg + 2) * d, dtype=torch.bfloat16)
    o = torch.zeros(s, b, g * qpg * d, dtype=torch.bfloat16)
    lse = torch.zeros(b, g * qpg, s)
    q = torch.zeros(b, 2, s, d, dtype=torch.bfloat16)
    k = torch.zeros(b, 1, s, d, dtype=torch.bfloat16)
    rope = None if not rot else rope_tables(rope_freqs(0, s, rot, 1e4), s,
                                            d)
    before = dict(LAUNCHES)
    tatt.flash_fwd_cuda(q, k, k, None, 0.1, True)
    tatt.flash_bwd_cuda(q, k, k, q, q, lse, None, 0.1, True)
    tatt.flash_packed_fwd_cuda(qkv, None, rope, None, 0.0, 0.1, True, None,
                               qpg, d)
    tatt.flash_packed_bwd_cuda(qkv, o, o, lse, None, rope, None, 0.0, 0.1,
                               True, None, qpg, d)
    for name in ("flash_fwd", "flash_bwd", "flash_packed_fwd",
                 "flash_packed_bwd"):
        assert LAUNCHES[name] == before[name] + 1
    assert lib.calls["apex_flash_fwd"][12] == d
    assert lib.calls["apex_flash_bwd"][17] == d
    fwd, bwd = lib.calls["apex_flash_packed_fwd"], \
        lib.calls["apex_flash_packed_bwd"]
    assert fwd[13] == d and bwd[17] == d
    # E: rot_qkv; F: grad32, rot_qkv (the pointers after the seed)
    wide_rope = d > 512 and rot > 0
    assert (fwd[7] is not None) == wide_rope
    assert (bwd[10] is not None) == (d > 512)
    assert (bwd[11] is not None) == wide_rope
    assert packed_attention_supported(s, g, qpg, d)


def test_packed_gate_takes_every_head_dim_jax_does():
    """The port's packed gate takes every head dim; where JAX's Pallas
    gate also takes one (a 128-lane geometry), both say yes."""
    for d in (1024, 2048, 4096):
        assert packed_attention_supported(64, 1, 4, d)
        assert jatt.packed_attention_supported(64, 1, 4, d)
    for d in (520, 840, 1030, 14600):
        assert packed_attention_supported(64, 2, 1, d)
    assert not packed_attention_supported(64, 2, 1, 0)


# ---------------------------------------------------------------------------
# Kernel C: the plain version past 512 and the element path's row chunks
# ---------------------------------------------------------------------------

#: JAX's ``_reference``, jitted (group and window static): one compile a
#: case in place of its ops' eager compiles
_jit_reference = jax.jit(_reference, static_argnums=(9, 10))


@pytest.mark.parametrize("hl,group,w,dh,window", [
    (16, 8, 4, 1024, None), (16, 16, 1, 2048, 5)],
    ids=["dh1024_gqa8_w4_32rows", "dh2048_mqa16_16rows_window"])
def test_decode_plain_matches_jax_reference_past_512(hl, group, w, dh,
                                                     window):
    """``decode_plain`` (through ``fused_paged_decode_attention`` on CPU
    tensors: the append, then the plain version) against JAX's
    ``_reference`` in f32 (atol 2e-5) at the shapes where Kernel C's
    element path cuts its rows into chunks: head_dim 1024 with 32 query
    rows a kv head (GQA 8:1 under a w = 4 window) and 2048 with 16 (MQA
    16:1, a sliding window); window rows past a slot's table drop."""
    b, ps, pps = 3, 16, 4
    rng = np.random.RandomState(3)
    n_pages, f = b * pps + 2, hl // group * dh
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(
        np.int32)
    table[2, 1] = n_pages
    positions = np.array([ps - 1, 0, ps * pps - 2], np.int32)
    q, k_new, v_new, kp, vp = (rng.randn(*shape).astype(np.float32)
                               for shape in ((b, w, hl, dh), (b, w, f),
                                             (b, w, f), (n_pages, ps, f),
                                             (n_pages, ps, f)))
    a = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    ctx, _, _, _, _ = _jit_reference(
        a(q), a(k_new), a(v_new), a(kp), a(vp), None, None,
        jnp.asarray(table), jnp.asarray(positions), group, window)
    t = torch.from_numpy
    pools = [page_pool(*kp.shape, torch.float32, "cpu") for _ in range(2)]
    for pool, x in zip(pools, (kp, vp)):
        pool.copy_(t(x))
    got, _, _ = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), *pools, t(table), t(positions),
        queries_per_group=group, sliding_window=window)
    np.testing.assert_allclose(_f32(got), np.asarray(ctx, np.float32),
                               atol=2e-5, rtol=0)


def _element_plan(rows, dh, page, kvh=2):
    """The element path's plan for ``rows`` query rows a kv head (f32 q
    over int8 pools: the element path at every head dim)."""
    return paged_decode_plan(8, kvh * rows, kvh, dh, page, 12, torch.float32,
                             True, lambda p, h: 1, 132, pool_dtype=torch.int8)


@pytest.mark.parametrize("page", [16, 64, 128])
def test_element_row_chunks_only_where_the_parent_had_no_tile(page):
    """Over rows 1-64 and head dims 60 to 8192: where ``element_tile``
    finds a tile for all of a kv head's rows the plan is the parent's (one
    block a kv head holding every row); where it found none (d 1024 at 32
    rows, 2048 at 16, 4096 at 8, pages of 64) the rows go in the fewest
    equal chunks whose rows leave a tile; every block's shared memory fits
    an H100's."""
    for rows, dh in itertools.product((1, 4, 8, 16, 32, 64),
                                      (60, 260, 512, 1024, 1030, 2048, 4096,
                                       8192)):
        plan = _element_plan(rows, dh, page)
        assert plan.path == "element"
        chunks = element_chunks(rows, dh, page)
        if element_tile(rows, dh, page):
            assert chunks == 1 and plan.heads == rows
            assert plan.grid == (2, 8, 1)
        else:
            assert chunks > 1 and element_tile(-(-rows // chunks), dh, page)
            assert not element_tile(-(-rows // (chunks - 1)), dh, page)
            assert plan.heads == -(-rows // chunks)
            assert plan.grid == (2 * -(-rows // plan.heads), 8, 1)
        assert element_tile(plan.heads, dh, page) >= 1
        assert paged_decode_smem(plan, dh, page) <= SMEM
    assert element_tile(32, 1024, 64) == 0 and \
        element_chunks(32, 1024, 64) == 2
    assert element_tile(16, 2048, 64) == 0 and \
        element_chunks(16, 2048, 64) == 2
    assert element_tile(8, 4096, 64) == 0


def test_element_path_head_dim_limit():
    """One query row and one K/V row fit up to head_dim 14526 (4 d + 5
    floats); past it the plan raises."""
    assert ELEMENT_MAX_HEAD_DIM == 14526
    plan = _element_plan(4, ELEMENT_MAX_HEAD_DIM, 64)
    assert (plan.heads, element_tile(1, ELEMENT_MAX_HEAD_DIM, 64)) == (1, 1)
    assert paged_decode_smem(plan, ELEMENT_MAX_HEAD_DIM, 64) <= SMEM
    with pytest.raises(ValueError, match="14526"):
        _element_plan(4, ELEMENT_MAX_HEAD_DIM + 1, 64)


# ---------------------------------------------------------------------------
# A tiny GPT with 1024-wide heads against the JAX GPTModel
# ---------------------------------------------------------------------------

TINY_HD1024 = dict(num_layers=2, hidden_size=2048, num_attention_heads=2,
                   num_query_groups=1, ffn_hidden_size=256,
                   activation="swiglu", normalization="rmsnorm",
                   position_embedding_type="rope", vocab_size=128,
                   max_position_embeddings=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
BATCH, SEQ = 2, 32


@pytest.fixture
def jax_plain_path(jax_mode):
    """apex_tpu on its plain jnp path (other modules export interpret
    mode process-wide at import)."""
    jax_mode("off")


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(compute: str):
    """The JAX GPTModel's jitted loss-and-grad, compiled once for the
    tests of this module."""
    jm = JaxGPT(JaxConfig(**TINY_HD1024,
                          compute_dtype=getattr(jnp, compute)))
    return jax.jit(jax.value_and_grad(lambda p, tok, lab: jm.apply(p, tok,
                                                                 lab)))


def _pair(compute="float32"):
    """The port's GPT with weights from a seed, the same weights as a JAX
    params tree and JAX's loss-and-grad."""
    tm = GPTModel(TransformerConfig(**TINY_HD1024,
                                    compute_dtype=getattr(torch, compute)),
                  device="cpu", generator=torch.Generator().manual_seed(5))
    assert tm.config.head_dim == 1024
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    return params, _jax_loss_and_grad(compute), tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, TINY_HD1024["vocab_size"], (BATCH, SEQ))
                 .astype(np.int32) for _ in range(2))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _three_steps(compute, rtol, grads_after_first=None):
    """Three FusedAdam steps (lr 1e-3) on both sides: JAX's
    ``value_and_grad`` then ``FusedAdam.step``, the port's through
    ``make_train_step``; ``grads_after_first(jax_grads, port_model)`` sees
    the first step's gradients (both at the initial weights)."""
    params, vg, tm = _pair(compute)
    batch_np = _batch(1)
    tokens, labels = (jnp.asarray(t) for t in batch_np)
    jopt = JaxFusedAdam(lr=1e-3)
    jstate = jopt.init(params)
    jstep = jax.jit(jopt.step)
    step = make_train_step(lambda batch: tm(*batch),
                           FusedAdam(tm.parameters(), lr=1e-3))
    batch = tuple(torch.from_numpy(t).long() for t in batch_np)
    jlosses, tlosses = [], []
    for i in range(3):
        jloss, grads = vg(params, tokens, labels)
        params, jstate = jstep(grads, params, jstate)
        jlosses.append(float(jloss))
        tlosses.append(float(step(batch)))
        if i == 0 and grads_after_first is not None:
            grads_after_first(grads, tm)
    np.testing.assert_allclose(tlosses, jlosses, rtol=rtol)
    assert tlosses[-1] < tlosses[0]


def test_hd1024_gpt_loss_grads_and_adam_steps_match_jax(jax_plain_path,
                                                        monkeypatch):
    """The tiny d-1024 GPT in f32: the first loss to rtol 1e-5 and every
    gradient leaf to atol 1e-5 of its largest magnitude, then three
    FusedAdam steps' losses to rtol 1e-5; the layers' attention takes the
    packed path (Kernels E and F on the card)."""
    from apex_tpu_torch.models import transformer as ttransformer
    calls = []
    packed = ttransformer.flash_attention_packed
    monkeypatch.setattr(ttransformer, "flash_attention_packed",
                        lambda *a, **k: calls.append(1) or packed(*a, **k))

    def check_grads(jgrads, tm):
        assert len(calls) == TINY_HD1024["num_layers"]
        want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
        assert want.keys() == got.keys()
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max())
                                       + 1e-12, err_msg=key)

    _three_steps("float32", 1e-5, check_grads)


@pytest.mark.slow
def test_hd1024_gpt_bf16_steps_match_jax_to_tolerance(jax_plain_path):
    """bf16 compute over fp32 params: the frameworks round bf16 at other
    points (JAX's reference attention takes bf16 p into P V, the port's
    plain version keeps it fp32), so three losses agree to rtol 2e-2."""
    _three_steps("bfloat16", 2e-2)
