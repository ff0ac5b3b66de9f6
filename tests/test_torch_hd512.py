"""Head dims past 256 (Kernels B, I, E and F up to 512; Kernel C's vector
path up to 512) against the JAX package, on the CPU.

The plain versions the wrappers run on a CPU tensor, and which the card
checks hold each kernel to, are einsums over any head dim; these tests
hold them to the JAX package's Pallas kernels in interpret mode:

- packed QKV (Kernels E and F) at head_dim 512 in f32, bf16 and fp16: 4
  query heads over one K/V group (``HD512``'s group) with RoPE over all
  512 columns, a sliding window, ``kv_lengths``
  holding a 0 row and hash dropout, against ``_fwd_packed_kernel`` and
  ``_dqkv_packed_kernel`` (JAX's 128-lane packed geometry takes d 512);
- 4D (Kernels B and I): GQA 4:1 causal with ``kv_lengths`` and a 0 row
  at head_dim 512 in f32, bf16 and fp16 (the single-block kernels, whose
  function the multi-block ones share);
- head_dim 392 (fp16) and 260 (bf16), which JAX's packed gate refuses (no
  128-lane geometry; d % 8 != 0): the packed plain versions on a packed
  qkv and the 4D ones on its unpacked q, k and v, against one run of the
  4D kernels (causal, GQA, ``kv_lengths``; ``_pad_qkv`` pads every head
  dim to a multiple of 64);

with the tolerances of ``test_torch_hd256.py``: f32 o atol 2e-5 and
gradients atol 1e-4; in bf16 and fp16 o within 1 ulp plus one rounding
step of each unnormalised p times |v| (the JAX kernels round p to the
input type before P V, the plain versions keep it fp32), and the
gradients within 1 ulp plus the rounding slack of ds and p, at most 0.1%
of the elements past 1 ulp (0.8% for Kernel I in fp16), the 1-ulp
floor of the gradients' magnitudes scaled by d / 256 past 256
(:func:`backward_floor`). The JAX backward kernels run on the same
residuals as the port's plain backward.

Kernel C: ``decode_plain`` against JAX's ``_reference`` at head_dim 512
(f32 atol 2e-5), and ``paged_decode_plan`` at 512: the
vector path with 2 pieces a lane in bf16 and fp16 (4 in f32) and at most
4 query rows a block, its shared memory under an H100 block's 232,448
bytes, as the element path's at head_dim 260 and 512 with pages of 64.

Then a tiny GPT with 512-wide heads (2 layers, hidden 1024, 2 query heads
over one K/V group, SwiGLU, RMSNorm, RoPE, vocab 128, s 32): its f32 loss
and every gradient leaf against the JAX ``GPTModel``, and three
``FusedAdam`` steps' losses; in bf16 (slow) three steps to rtol 2e-2.
"""

import functools

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
from apex_tpu_torch.ops import LAUNCHES, flash_attention
from apex_tpu_torch.ops.attention import (
    _packed_bwd_factors,
    _qk,
    _unpack,
    backward_floor,
    flash_attention_packed,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_fwd_plain,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_plain,
    packed_attention_supported,
    rounding_step,
)
from apex_tpu_torch.ops.decode_attention import (
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
    """(case, dtype) pairs: head_dim 512 in every dtype, the others in
    the dtype each names. An interpret-mode JAX kernel costs ~1-2 s to
    trace and compile whatever its shape."""
    return [(n, dt) for n, case in table.items()
            for dt in (DTYPES if case[-1] is None else [case[-1]])]


PACKED = {
    # name: (s, b, groups, qpg, d, kwargs, dtype or None for all three)
    "gqa4_rope512_window_kv_lengths_0_dropout": (
        48, 2, 1, 4, 512, dict(causal=True, rot=512, sliding_window=20,
                               kv_lengths=[30, 0], dropout_rate=0.2,
                               dropout_seed=-7), None),
}

FLASH = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window, dtype)
    "gqa4_causal_kv_lengths_0": (2, 4, 1, 48, 48, 512, True, [40, 0], None,
                                 None),
}

#: widths JAX's packed gate refuses, for E/F and B/I at once: (s, b,
#: groups, qpg, d, causal, kv_lengths, dtype)
OFF_LANES = {
    "d392_gqa_causal_kv_lengths": (40, 1, 2, 2, 392, True, [23],
                                   "float16"),
    "d260_gqa_causal": (40, 1, 1, 2, 260, True, None, "bfloat16"),
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
    lse), both in interpret mode at head_dim 512; a kv_length-0 row is
    zero in o and dqkv."""
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


@pytest.mark.parametrize("name,dtype", _cases(FLASH))
def test_flash_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """B's plain version (through ``flash_attention`` on CPU tensors)
    against ``_fwd_single_kernel``, I's against ``_dqkv_single_kernel`` on
    the port's o and lse, both in interpret mode; a kv_length-0 row gets
    o = 0 and zero gradients."""
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
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g_, tdt, sl,
               max_past_ulp=8e-3 if tdt == torch.float16 else 1e-3,
               floor=backward_floor(d))
    if kvl is not None and 0 in kvl:
        r = kvl.index(0)
        assert not o[r].any() and not any(g_[r].any() for g_ in grads)


@pytest.mark.parametrize("name,dtype", _cases(OFF_LANES))
def test_plain_off_the_lanes_match_jax_4d_kernels(jax_mode, name, dtype):
    """At head_dim 392 and 260 JAX's packed gate says no (no 128-lane
    geometry; d % 8 != 0), so E's and F's plain versions (on the packed
    qkv) and B's and I's (through ``flash_attention`` on the unpacked q, k
    and v) are held to one run of the 4D kernels on the unpacked q, k and
    v: o against ``flash_attention`` (``_pad_qkv`` pads d to a multiple of
    64), the gradients against ``_flash_vjp_bwd``."""
    jax_mode("interpret")
    s, b, g, qpg, d, causal, kvl, _ = OFF_LANES[name]
    assert not jatt.packed_attention_supported(s, g, qpg, d)
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
    got = [t.contiguous() for t in _unpack(dqkv, qpg, d)]
    bound = [t.contiguous() for t in _unpack(slack, qpg, d)]
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, got, bound):
        _check(n, w, g_, tdt, sl,
               max_past_ulp=8e-3 if tdt == torch.float16 else 1e-3,
               floor=backward_floor(d))
    # B and I on the same q, k, v and residuals
    before = dict(LAUNCHES)
    o_b = flash_attention(q, k, v, causal=causal, kv_lengths=args[0])
    assert LAUNCHES == before           # CPU tensors launch no kernel
    p, _ = flash_bwd_factors(q, k, v, o4, o4, lse, args[0], args[4], causal)
    _check("o", want_o, o_b, tdt, torch.einsum(
        "bhqk,bhkd->bhqd", rounding_step(p, tdt),
        v.float().abs().repeat_interleave(qpg, dim=1)))
    bargs = (args[0], args[4], causal, None)
    grads = flash_bwd_plain(q, k, v, do4, o4, lse, *bargs)
    slack = flash_bwd_rounding_slack(q, k, v, do4, o4, lse, *bargs)
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g_, tdt, sl,
               max_past_ulp=8e-3 if tdt == torch.float16 else 1e-3,
               floor=backward_floor(d))


# ---------------------------------------------------------------------------
# Kernel C: the plain version and the plan at head_dim 512
# ---------------------------------------------------------------------------

#: JAX's ``_reference``, jitted (group and window static): one compile a
#: case in place of its ops' eager compiles (f32 only: in bf16 XLA's
#: fusions under jit drop some of the eager path's bf16 roundings)
_jit_reference = jax.jit(_reference, static_argnums=(9, 10))


def _decode_inputs(seed, b=3, hl=8, group=4, dh=512, ps=16, pps=4):
    """q, the step's rows, f32 pools, a table (a sentinel inside slot 2's
    range) and positions (a page's last row, 0 and the table's end)."""
    rng = np.random.RandomState(seed)
    n_pages, f = b * pps + 2, hl // group * dh
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(
        np.int32)
    table[2, 1] = n_pages
    positions = np.array([ps - 1, 0, ps * pps - 1], np.int32)
    arrays = [rng.randn(*shape).astype(np.float32) for shape in (
        (b, hl, dh), (b, f), (b, f), (n_pages, ps, f), (n_pages, ps, f))]
    return (*arrays, table, positions)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_plain_matches_jax_reference_at_head_dim_512(window):
    """``decode_plain`` (through ``fused_paged_decode_attention`` on CPU
    tensors: the append, then the plain version) against JAX's
    ``_reference`` at head_dim 512, GQA 4:1, in f32 (atol 2e-5): the masks,
    the window and the heads' map at the new width. Its bf16 rounding
    points are held bitwise at head_dim 64 (``test_torch_decode_attention
    .py``); at 512 torch's and XLA's CPU GEMMs sum 512-long contractions in
    other orders, and one element of 12,288 rounded to the neighbouring
    bf16 value."""
    q, k_new, v_new, kp, vp, table, positions = _decode_inputs(3)
    tdt, jdt = torch.float32, jnp.float32
    a = lambda x: jnp.asarray(x, jdt)  # noqa: E731
    ctx, _, _, _, _ = _jit_reference(
        a(q)[:, None], a(k_new)[:, None], a(v_new)[:, None], a(kp), a(vp),
        None, None, jnp.asarray(table), jnp.asarray(positions), 4, window)
    want = np.asarray(ctx[:, 0], np.float32)
    t = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    pools = [page_pool(*kp.shape, tdt, "cpu") for _ in range(2)]
    for pool, x in zip(pools, (kp, vp)):
        pool.copy_(t(x))
    got, _, _ = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), *pools, torch.from_numpy(table),
        torch.from_numpy(positions), queries_per_group=4,
        sliding_window=window)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=0)


#: (dtype, pool dtype, w) -> (pieces, heads a block)
PLAN_512 = {
    "bf16": (torch.bfloat16, torch.bfloat16, 1, 2, 4),
    "fp16": (torch.float16, torch.float16, 1, 2, 4),
    "f32": (torch.float32, torch.float32, 1, 4, 4),
    "bf16_int8": (torch.bfloat16, torch.int8, 1, 2, 4),
    "bf16_w4": (torch.bfloat16, torch.bfloat16, 4, 2, 4),
}


@pytest.mark.parametrize("name", list(PLAN_512))
def test_decode_plan_vector_path_at_head_dim_512(name):
    """At head_dim 512 (the serving shape of ``HD512``: 8 query heads
    over 2 K/V heads, pages of 64) Kernel C takes the vector path: two
    16-byte pieces a lane in bf16 and fp16 (int8 pools too), four in f32,
    at most 4 query rows a block (16 columns a lane), and its shared
    memory fits an H100 block."""
    dtype, pool, w, pieces, heads = PLAN_512[name]
    plan = paged_decode_plan(8, 8, 2, 512, 64, 12, dtype, True,
                             lambda p, h: 1, 132, window=w, pool_dtype=pool)
    assert (plan.path, plan.pieces, plan.lanes, plan.heads) == \
        ("vector", pieces, 32, heads)
    assert plan.grid[0] == 2 * (w * 4) // heads
    assert paged_decode_smem(plan, 512, 64, pool == torch.int8) <= SMEM


@pytest.mark.parametrize("dh,dtype,pool,aligned,tile", [
    (260, torch.bfloat16, torch.bfloat16, True, 64),
    (260, torch.float16, torch.float16, True, 64),
    (512, torch.float32, torch.int8, True, 32),
    (512, torch.bfloat16, torch.bfloat16, False, 32),
])
def test_decode_plan_element_path_fits_at_pages_of_64(dh, dtype, pool,
                                                      aligned, tile):
    """The element path (head_dim off the 16-byte pieces, int8 pools under
    f32 q, a misaligned base) at the engine's pages of 64: at head_dim 260
    a page of K and V fits beside each other; at 512 (279,856 bytes for
    the whole page) the kernel walks each page in 32-row tiles, and either
    way its shared memory fits an H100 block."""
    plan = paged_decode_plan(8, 8, 2, dh, 64, 12, dtype, aligned,
                             lambda p, h: 1, 132, pool_dtype=pool)
    assert plan.path == "element" and plan.heads == 4
    assert element_tile(4, dh, 64) == tile
    assert paged_decode_smem(plan, dh, 64) <= SMEM
    if tile < 64:
        assert 4 * (4 * dh * 2 + 64 * (2 * dh + 1) + 4 * 64 + 12) > SMEM


@pytest.mark.parametrize("dh,rows,page,tile", [
    (512, 4, 128, 32), (512, 16, 128, 32), (260, 4, 256, 64),
    (512, 4, 1024, 32)])
def test_decode_plan_element_path_sub_page_tiles(dh, rows, page, tile):
    """Where a page of K and V does not fit, the element path takes the
    first of page / 2, / 4, ... rows that fits, and its shared memory
    stays within a block."""
    assert 4 * (rows * dh * 2 + page * (2 * dh + 1) + rows * page
                + 3 * rows) > SMEM
    assert element_tile(rows, dh, page) == tile
    plan = paged_decode_plan(1, rows, 1, dh, page, 4, torch.float32, False,
                             lambda p, h: 1, 132)
    assert plan.path == "element" and plan.heads == rows
    assert paged_decode_smem(plan, dh, page) <= SMEM


# ---------------------------------------------------------------------------
# A tiny GPT with 512-wide heads against the JAX GPTModel
# ---------------------------------------------------------------------------

TINY_HD512 = dict(num_layers=2, hidden_size=1024, num_attention_heads=2,
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
    jm = JaxGPT(JaxConfig(**TINY_HD512, compute_dtype=getattr(jnp, compute)))
    return jax.jit(jax.value_and_grad(lambda p, tok, lab: jm.apply(p, tok,
                                                                 lab)))


def _pair(compute="float32"):
    """The port's GPT with weights from a seed, the same weights as a JAX
    params tree (``params_to_jax``: no JAX init to compile) and JAX's
    loss-and-grad."""
    tm = GPTModel(TransformerConfig(**TINY_HD512,
                                    compute_dtype=getattr(torch, compute)),
                  device="cpu", generator=torch.Generator().manual_seed(5))
    assert tm.config.head_dim == 512
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    return params, _jax_loss_and_grad(compute), tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, TINY_HD512["vocab_size"], (BATCH, SEQ))
                 .astype(np.int32) for _ in range(2))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _three_steps(compute, rtol, grads_after_first=None):
    """Three FusedAdam steps (lr 1e-3) on both sides: JAX's as its
    ``make_train_step`` runs them on a one-device mesh (``value_and_grad``,
    then ``FusedAdam.step``), the port's through ``make_train_step``;
    ``grads_after_first(jax_grads, port_model)`` sees the first step's
    gradients (both at the initial weights)."""
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


def test_hd512_gpt_loss_grads_and_adam_steps_match_jax(jax_plain_path,
                                                       monkeypatch):
    """The tiny d-512 GPT in f32: the first loss to rtol 1e-5 and every
    gradient leaf to atol 1e-5 of its largest magnitude
    (test_torch_gpt_training.py's bar), then three FusedAdam steps' losses
    to rtol 1e-5; the layers' attention takes the packed path (Kernels E
    and F on the card)."""
    from apex_tpu_torch.models import transformer as ttransformer
    calls = []
    packed = ttransformer.flash_attention_packed
    monkeypatch.setattr(ttransformer, "flash_attention_packed",
                        lambda *a, **k: calls.append(1) or packed(*a, **k))

    def check_grads(jgrads, tm):
        assert len(calls) == TINY_HD512["num_layers"]
        want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
        assert want.keys() == got.keys()
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max())
                                       + 1e-12, err_msg=key)

    _three_steps("float32", 1e-5, check_grads)


@pytest.mark.slow
def test_hd512_gpt_bf16_steps_match_jax_to_tolerance(jax_plain_path):
    """bf16 compute over fp32 params: the frameworks round bf16 at other
    points (JAX's reference attention takes bf16 p into P V, the port's
    plain version keeps it fp32), so three losses agree to rtol 2e-2."""
    _three_steps("bfloat16", 2e-2)
