"""Paged decode attention of the port against the JAX package.

The same numpy-made query, new rows, pools, page table (with sentinel
entries, a ragged last page, a row past the table) and positions go
through ``apex_tpu.ops.decode_attention._reference`` (the gathered-view
reference the JAX engine is token-exact with) and through
``apex_tpu_torch.ops.fused_paged_decode_attention`` on the CPU, which
appends in place and runs the plain version of the Hopper kernel.

Tolerances: f32 context atol 2e-5 (the two run the same gathered-view
formulation; sums differ only in order); the pools after the append
must be EQUAL — an append is a copy, and a dropped row must leave every
page untouched.

bf16: the two packages split the same way. ``_reference`` (and
``decode_plain``, the port's CPU path) forms the scores by a GEMM in
q's dtype and rounds the probabilities to q's dtype before ``p v``;
the TPU kernel ``_decode_kernel`` (and Kernel C, the port's card path)
keeps scores and p in fp32 and rounds the context once. So in bf16
``decode_plain`` is held to ``_reference`` bitwise, and the function
Kernel C computes, the plain version run in f32 and rounded once, to
``_pallas`` in interpret mode within 1 bf16 ulp. The two pairs differ
from each other by design.

int8 pools and ``w``-row windows: the port's appends (the windowed row
scatter, ``paged_quant_scatter``, ``paged_quant_fill``, ``_quant_append``)
leave pools and scales BITWISE equal to JAX's, sentinel pages, rows past
the table and duplicate destinations included; ``decode_plain`` with
windows (GQA, a sliding window, int8 pools) is held to ``_reference``,
f32 atol 2e-5 and bf16 bitwise, and Kernel C's function in bf16 (the plain
version run in f32, rounded once) to ``_reference`` run in f32 and rounded
once within 1 bf16 ulp. The JAX interpret kernel is not used for int8
windows: it disagrees with ``_reference`` there (a fault of the
reference package).

Kernel C's launch plan (``paged_decode_plan``: vector or element path,
pages a split, splits, heads a block) is pure Python and pinned here at
every shape the card checks and the timing tool use; the vector kernel's
walk (splits of a slot's pages, row slots stepping by the block's row
slots in tiles, the online softmax in log2 units, the merges of row
slots, warps and splits in fixed order) is emulated in fp32 numpy and
held to the plain version within 1e-5.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import decode_attention as jda
from apex_tpu.ops.decode_attention import _pallas, _reference
from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops.decode_attention import (
    DecodePlan,
    _quant_append,
    append_rows,
    decode_plain,
    fused_paged_decode_attention,
    page_pool,
    paged_decode_cuda_plan,
    paged_decode_plan,
    paged_quant_fill,
    paged_quant_scatter,
    scale_pool,
)

N_PAGES, PS, PPS = 12, 8, 5
B, KVH, GROUP, DH = 5, 2, 4, 16
HL, F = KVH * GROUP, KVH * DH


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HL, DH).astype(np.float32)
    k_new = rng.randn(B, F).astype(np.float32)
    v_new = rng.randn(B, F).astype(np.float32)
    k_pages = rng.randn(N_PAGES, PS, F).astype(np.float32)
    v_pages = rng.randn(N_PAGES, PS, F).astype(np.float32)
    table = np.full((B, PPS), N_PAGES, np.int32)       # sentinel = unmapped
    table[0, :2] = [4, 9]        # pos 13: ragged last page
    table[1, :1] = [0]           # pos 0: the first row of its first page
    table[2, :3] = [2, 7, 11]    # pos 23: last row of its third page
    table[3, :2] = [1, 3]        # pos 20: its page is a sentinel -> drop
    table[4, :] = [5, 6, 8, 10, 1]  # pos 40: past the table -> drop
    positions = np.array([13, 0, 23, 20, 40], np.int32)
    return q, k_new, v_new, k_pages, v_pages, table, positions


def _torch_pool(a, dtype=torch.float32):
    pool = page_pool(N_PAGES, PS, F, dtype, "cpu")
    pool.copy_(torch.from_numpy(a))
    return pool


def _run_torch(q, k_new, v_new, k_pages, v_pages, table, positions,
               window, dtype=torch.float32):
    """The port's CPU path in ``dtype`` (f32 numpy in; outputs as f32
    numpy)."""
    kp, vp = _torch_pool(k_pages, dtype), _torch_pool(v_pages, dtype)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    ctx, kp2, vp2 = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), kp, vp, torch.from_numpy(table),
        torch.from_numpy(positions), queries_per_group=GROUP,
        sliding_window=window)
    assert kp2 is kp and vp2 is vp                     # updated in place
    assert ctx.dtype == dtype
    return ctx.float().numpy(), kp.float().numpy(), vp.float().numpy()


def _jax_args(q, k_new, v_new, k_pages, v_pages, table, positions,
              dtype=jnp.float32):
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return (a(q)[:, None], a(k_new)[:, None], a(v_new)[:, None],
            a(k_pages), a(v_pages), None, None, jnp.asarray(table),
            jnp.asarray(positions))


def _run_reference(q, k_new, v_new, k_pages, v_pages, table, positions,
                   window, dtype=jnp.float32):
    ctx, kp, vp, _, _ = _reference(
        *_jax_args(q, k_new, v_new, k_pages, v_pages, table, positions,
                   dtype), GROUP, window)
    return (np.asarray(ctx[:, 0], np.float32), np.asarray(kp, np.float32),
            np.asarray(vp, np.float32))


def _bf16_inputs(seed):
    """``_inputs(seed)`` rounded to bf16 values (still f32 arrays), so
    that an f32 run and a bf16 run read the same numbers."""
    return tuple(a if a.dtype != np.float32 else
                 torch.from_numpy(a).bfloat16().float().numpy()
                 for a in _inputs(seed))


@pytest.mark.parametrize("window", [None, 6])
def test_decode_matches_reference(window):
    args = _inputs()
    ctx, kp, vp = _run_torch(*args, window)
    rctx, rkp, rvp = _run_reference(*args, window)
    np.testing.assert_allclose(ctx, rctx, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(kp, rkp)
    np.testing.assert_array_equal(vp, rvp)


def test_decode_matches_interpret_kernel(monkeypatch):
    """The TPU kernel itself (Pallas interpret mode) agrees too: f32 atol
    2e-5 (an online softmax over pages against one softmax)."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "interpret")
    jax_support.pallas_mode.cache_clear()
    try:
        q, k_new, v_new, k_pages, v_pages, table, positions = _inputs(1)
        kctx, kkp, _, _, _ = _pallas(
            jnp.asarray(q)[:, None], jnp.asarray(k_new)[:, None],
            jnp.asarray(v_new)[:, None], jnp.asarray(k_pages),
            jnp.asarray(v_pages), None, None, jnp.asarray(table),
            jnp.asarray(positions), GROUP, None)
    finally:
        jax_support.pallas_mode.cache_clear()
    ctx, kp, _ = _run_torch(q, k_new, v_new, k_pages, v_pages, table,
                            positions, None)
    np.testing.assert_allclose(ctx, np.asarray(kctx[:, 0]), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(kp, np.asarray(kkp))


@pytest.mark.parametrize("window", [None, 6])
def test_decode_bf16_matches_reference_bitwise(window):
    """In bf16 the port's plain version is JAX's ``_reference`` bit for
    bit: the same GEMM in bf16, the same roundings of the scores and
    of p before ``p v``."""
    args = _bf16_inputs(2)
    ctx, kp, vp = _run_torch(*args, window, dtype=torch.bfloat16)
    rctx, rkp, rvp = _run_reference(*args, window, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(ctx, rctx)
    np.testing.assert_array_equal(kp, rkp)
    np.testing.assert_array_equal(vp, rvp)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_bf16_kernel_function_matches_interpret_kernel(monkeypatch,
                                                              window):
    """What Kernel C computes in bf16 (scores and p in fp32, the context
    rounded once: the plain version run in f32 on the bf16 values, then
    rounded to bf16) is within 1 bf16 ulp of the TPU kernel in interpret
    mode on the same bf16 inputs."""
    args = _bf16_inputs(3)
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "interpret")
    jax_support.pallas_mode.cache_clear()
    try:
        kctx, _, _, _, _ = _pallas(*_jax_args(*args, dtype=jnp.bfloat16),
                                   GROUP, window)
    finally:
        jax_support.pallas_mode.cache_clear()
    want = np.asarray(kctx[:, 0], np.float32)
    ctx, _, _ = _run_torch(*args, window)
    got = torch.from_numpy(ctx).bfloat16().float().numpy()
    ulp = 2.0 ** -15 + 2.0 ** -7 * np.abs(want)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_dropped_rows_land_in_the_spare_page_only():
    _, k_new, _, k_pages, _, table, positions = _inputs()
    pool = _torch_pool(k_pages)
    append_rows(pool, torch.from_numpy(k_new), torch.from_numpy(table),
                torch.from_numpy(positions), PS)
    got = pool.numpy()
    want = k_pages.copy()
    for r in range(3):                       # slots whose page is mapped
        want[table[r, positions[r] // PS], positions[r] % PS] = k_new[r]
    np.testing.assert_array_equal(got, want)
    spare = pool.as_strided((N_PAGES + 1, PS, F), pool.stride())[N_PAGES]
    np.testing.assert_array_equal(spare[positions[3] % PS].numpy(), k_new[3])


def test_window_query_of_one_row_is_accepted():
    args = _inputs()
    q, k_new, v_new, k_pages, v_pages, table, positions = args
    ctx, _, _ = fused_paged_decode_attention(
        torch.from_numpy(q)[:, None], torch.from_numpy(k_new)[:, None],
        torch.from_numpy(v_new)[:, None], _torch_pool(k_pages),
        _torch_pool(v_pages), torch.from_numpy(table),
        torch.from_numpy(positions), queries_per_group=GROUP)
    want, _, _ = _run_torch(*args, None)
    np.testing.assert_array_equal(ctx[:, 0].numpy(), want)


def test_later_slices_raise_not_implemented():
    """What the first slice refused (``w > 1`` windows, int8 pools) now
    runs; a pool and its scales must still come together."""
    q, k_new, v_new, k_pages, v_pages, table, positions = _inputs()
    kp, vp = _torch_pool(k_pages), _torch_pool(v_pages)
    t = torch.from_numpy
    ctx, _, _ = fused_paged_decode_attention(
        t(q)[:, None].repeat(1, 2, 1, 1), t(k_new)[:, None].repeat(1, 2, 1),
        t(v_new)[:, None].repeat(1, 2, 1), kp, vp, t(table), t(positions),
        queries_per_group=GROUP)
    assert ctx.shape == (B, 2, HL * DH)
    ks, vs = scale_pool(N_PAGES, KVH, "cpu"), scale_pool(N_PAGES, KVH, "cpu")
    k8 = _torch_int8(k_pages.astype(np.int8))
    v8 = _torch_int8(v_pages.astype(np.int8))
    out = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), k8, v8, t(table), t(positions),
        queries_per_group=GROUP, k_scales=ks, v_scales=vs)
    assert len(out) == 5 and out[3] is ks and out[4] is vs
    with pytest.raises(ValueError, match="scale"):
        fused_paged_decode_attention(
            t(q), t(k_new), t(v_new), k8, v8, t(table), t(positions),
            queries_per_group=GROUP)
    with pytest.raises(ValueError, match="scale"):
        fused_paged_decode_attention(
            t(q), t(k_new), t(v_new), kp, vp, t(table), t(positions),
            queries_per_group=GROUP, k_scales=ks, v_scales=vs)


def test_plain_path_counts_no_launch():
    before = dict(_support.LAUNCHES)
    _run_torch(*_inputs(), None)
    assert _support.LAUNCHES == before



# -- int8 pools and windows ---------------------------------------------------

W_POSITIONS = np.array([13, 0, 22, 20, 38], np.int32)


def _window_inputs(w, seed=2):
    """``_inputs`` with ``w``-row windows of queries and new rows at
    positions whose windows cross a page (slot 0), start a slot (1), run
    past the last mapped page (2, the rows past it land on sentinels), hit
    a sentinel page (3) and run past the table (4)."""
    q, _, _, k_pages, v_pages, table, _ = _inputs(seed)
    rng = np.random.RandomState(seed + 50)
    q = rng.randn(B, w, HL, DH).astype(np.float32)
    k_new = rng.randn(B, w, F).astype(np.float32)
    v_new = rng.randn(B, w, F).astype(np.float32)
    return q, k_new, v_new, k_pages, v_pages, table, W_POSITIONS


def _quantized(pages, seed):
    """An int8 pool from float pages and per-(page, kv head) scales as a
    whole-page fill makes them (some pages left at scale 0, as free pages
    are)."""
    rng = np.random.RandomState(seed)
    amax = np.abs(pages.reshape(N_PAGES, PS, KVH, DH)).max(axis=(1, 3))
    scales = (amax / 127.0).astype(np.float32)
    scales[rng.rand(N_PAGES) < 0.25] = 0.0
    safe = np.where(scales > 0, scales, 1.0)[:, None, :, None]
    q = np.clip(np.round(pages.reshape(N_PAGES, PS, KVH, DH) / safe),
                -127, 127).astype(np.int8).reshape(N_PAGES, PS, F)
    return q, scales


def _torch_scales(a):
    sc = scale_pool(N_PAGES, KVH, "cpu")
    sc.copy_(torch.from_numpy(a))
    return sc


def _torch_int8(a):
    pool = page_pool(N_PAGES, PS, F, torch.int8, "cpu")
    pool.copy_(torch.from_numpy(a))
    return pool


@pytest.mark.parametrize("w", [1, 2, 4])
def test_windowed_append_matches_jax_bitwise(w):
    _, k_new, _, k_pages, _, table, positions = _window_inputs(w)
    pool = _torch_pool(k_pages)
    append_rows(pool, torch.from_numpy(k_new), torch.from_numpy(table),
                torch.from_numpy(positions), PS)
    want = jda._append_rows(jnp.asarray(k_pages), jnp.asarray(k_new),
                            jnp.asarray(table), jnp.asarray(positions), PS)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_quant_append_matches_jax_bitwise(w):
    """The windowed rescale-on-append: pools and scales bitwise JAX's,
    with rows on sentinels and past the table dropped, pages at scale 0
    (their resident bits zeroed) and rows of one window sharing a page
    (duplicate destinations of the rescale)."""
    _, k_new, _, k_pages, _, table, positions = _window_inputs(w, seed=3)
    k8, ks = _quantized(k_pages * 0.5, 7)
    pool, sc = _torch_int8(k8), _torch_scales(ks)
    out = _quant_append(pool, sc, torch.from_numpy(k_new),
                        torch.from_numpy(table), torch.from_numpy(positions),
                        PS)
    assert out[0] is pool and out[1] is sc
    jp, js = jda._quant_append(jnp.asarray(k8), jnp.asarray(ks),
                               jnp.asarray(k_new), jnp.asarray(table),
                               jnp.asarray(positions), PS)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


def test_quant_scatter_and_fill_match_jax_bitwise():
    """``paged_quant_scatter`` with duplicate destination pages, a
    sentinel page and a page id far past the pool, then
    ``paged_quant_fill`` of whole pages with one sentinel: bitwise
    JAX's, and the spare page alone takes the dropped rows."""
    rng = np.random.RandomState(9)
    k8, ks = _quantized(rng.randn(N_PAGES, PS, F).astype(np.float32), 4)
    rows = (rng.randn(7, F) * 2).astype(np.float32)
    dest_page = np.array([3, 3, 5, N_PAGES, 2 ** 30, 0, 3], np.int32)
    dest_row = np.array([0, 1, 7, 2, 3, 4, 6], np.int32)
    pool, sc = _torch_int8(k8), _torch_scales(ks)
    paged_quant_scatter(pool, sc, torch.from_numpy(rows),
                        torch.from_numpy(dest_page), torch.from_numpy(dest_row))
    jp, js = jda.paged_quant_scatter(jnp.asarray(k8), jnp.asarray(ks),
                                     jnp.asarray(rows), jnp.asarray(dest_page),
                                     jnp.asarray(dest_row))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    chunks = rng.randn(3, PS, F).astype(np.float32)
    chunks[1, :, :DH] = 0.0            # a kv head of zeros: scale 0
    dest = np.array([6, N_PAGES, 1], np.int32)
    paged_quant_fill(pool, sc, torch.from_numpy(chunks),
                     torch.from_numpy(dest))
    jp, js = jda.paged_quant_fill(jp, js, jnp.asarray(chunks),
                                  jnp.asarray(dest))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


def _run_window(args, window, int8, dtype=torch.float32, seed=0):
    """The port's CPU path over ``w``-row windows (int8 pools from the
    f32 pages when ``int8``); outputs as f32 numpy."""
    q, k_new, v_new, k_pages, v_pages, table, positions = args
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    kw = {}
    if int8:
        (k8, ks), (v8, vs) = _quantized(k_pages, seed), _quantized(v_pages,
                                                                  seed + 1)
        kp, vp = _torch_int8(k8), _torch_int8(v8)
        kw = dict(k_scales=_torch_scales(ks), v_scales=_torch_scales(vs))
    else:
        kp, vp = _torch_pool(k_pages, dtype), _torch_pool(v_pages, dtype)
    out = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), kp, vp, torch.from_numpy(table),
        torch.from_numpy(positions), queries_per_group=GROUP,
        sliding_window=window, **kw)
    return [o.float().numpy() for o in out]


def _reference_window(args, window, int8, dtype=jnp.float32, seed=0):
    q, k_new, v_new, k_pages, v_pages, table, positions = args
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    if int8:
        (k8, ks), (v8, vs) = _quantized(k_pages, seed), _quantized(v_pages,
                                                                  seed + 1)
        pools = (jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
                 jnp.asarray(vs))
    else:
        pools = (a(k_pages), a(v_pages), None, None)
    kp, vp, ks, vs = pools
    out = _reference(a(q), a(k_new), a(v_new), kp, vp, ks, vs,
                     jnp.asarray(table), jnp.asarray(positions), GROUP,
                     window)
    return [np.asarray(o, np.float32) for o in out if o is not None]


@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("w", [2, 4])
def test_decode_windows_match_reference(w, window, int8):
    """``decode_plain`` over ``w``-row windows (GQA 4, int8 pools through
    their scales) against ``_reference``: f32 context atol 2e-5, pools and
    scales after the append equal."""
    args = _window_inputs(w)
    got = _run_window(args, window, int8)
    want = _reference_window(args, window, int8)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("w", [2, 4])
def test_decode_windows_bf16_match_reference_bitwise(w, window, int8):
    """In bf16 ``decode_plain`` rounds where ``_reference`` does (the
    score GEMM in q's dtype, int8 pages dequantized to q's dtype, p
    rounded before ``p v``): equal bit for bit."""
    args = tuple(a if a.dtype != np.float32 else
                 torch.from_numpy(a).bfloat16().float().numpy()
                 for a in _window_inputs(w, seed=4))
    got = _run_window(args, window, int8, torch.bfloat16)
    want = _reference_window(args, window, int8, jnp.bfloat16)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("w", [2, 4])
def test_decode_windows_bf16_kernel_function_matches_reference(w, int8):
    """Kernel C's function in bf16 (scores and p in fp32, int8 dequantized
    in fp32, the context rounded once: the plain version run in f32 on
    the bf16 values) against ``_reference`` run in f32 on the same values
    and rounded once: within 1 bf16 ulp (summation order only)."""
    args = tuple(a if a.dtype != np.float32 else
                 torch.from_numpy(a).bfloat16().float().numpy()
                 for a in _window_inputs(w, seed=5))
    got = torch.from_numpy(_run_window(args, 6, int8)[0]).bfloat16().float()
    want = torch.from_numpy(_reference_window(args, 6, int8)[0]) \
        .bfloat16().float()
    torch.testing.assert_close(got, want, atol=2.0 ** -15, rtol=2.0 ** -7)


#: a card's resident blocks an SM by the query heads a block holds (made
#: up: the plan's arithmetic is what is pinned, the card answers its own)
_OCCUPANCY = {1: 8, 2: 6, 3: 4, 4: 4, 5: 2, 6: 2, 7: 2, 8: 2}
BF16, F32 = torch.bfloat16, torch.float32

#: (b, heads, kv heads, head_dim, page size, pages a slot, dtype, aligned,
#: window)
#: -> (path, pieces, lanes, heads a block, pages a split, splits, grid)
_PLANS = [
    # chip_smoke / decode_timing "table" and "full" (GPT-2 serve), bf16, f32
    ((8, 12, 12, 64, 64, 12, BF16, True, None),
     ("vector", 1, 8, 1, 2, 6, (12, 8, 6))),
    ((8, 12, 12, 64, 64, 12, F32, True, None),
     ("vector", 1, 16, 1, 2, 6, (12, 8, 6))),
    # "one": b 1 at 767
    ((1, 12, 12, 64, 64, 12, BF16, True, None),
     ("vector", 1, 8, 1, 1, 12, (12, 1, 12))),
    # "gqa": 32 heads over 8, head_dim 128, 2048 rows
    ((8, 32, 8, 128, 64, 32, BF16, True, None),
     ("vector", 1, 16, 4, 4, 8, (8, 8, 8))),
    # "gqa_window": a window of 512 rows spans at most 9 pages, so the
    # splits are sized on 9 pages and cover all 32
    ((8, 32, 8, 128, 64, 32, BF16, True, 512),
     ("vector", 1, 16, 4, 2, 16, (8, 8, 16))),
    # a window shorter than a page: 2 pages at most
    ((6, 12, 3, 64, 16, 8, BF16, True, 9),
     ("vector", 1, 8, 4, 1, 8, (3, 6, 8))),
    # G 8 at head_dim 64: one block holds the whole group
    ((8, 32, 4, 64, 64, 12, BF16, True, None),
     ("vector", 1, 8, 8, 2, 6, (4, 8, 6))),
    # test_paged_decode_kernel: pages of 16, G 1, 4, 3 and 12 (two chunks
    # of 6), bf16 and f32
    ((6, 12, 12, 64, 16, 8, BF16, True, None),
     ("vector", 1, 8, 1, 1, 8, (12, 6, 8))),
    ((6, 12, 3, 64, 16, 8, BF16, True, None),
     ("vector", 1, 8, 4, 1, 8, (3, 6, 8))),
    ((6, 12, 4, 64, 16, 8, F32, True, None),
     ("vector", 1, 16, 3, 1, 8, (4, 6, 8))),
    ((6, 12, 1, 64, 16, 8, BF16, True, None),
     ("vector", 1, 8, 6, 1, 8, (2, 6, 8))),
    # head_dim 128 at G 4 (the card test's GQA case)
    ((6, 16, 4, 128, 16, 8, BF16, True, None),
     ("vector", 1, 16, 4, 1, 8, (4, 6, 8))),
    # f32 at head_dim 256: two pieces a lane
    ((2, 4, 2, 256, 64, 16, F32, True, None),
     ("vector", 2, 32, 2, 1, 16, (2, 2, 16))),
    # more triples than a wave: one split of at most 64 pages
    ((64, 32, 32, 64, 16, 4096, BF16, True, None),
     ("vector", 1, 8, 1, 64, 64, (32, 64, 64))),
    # past 256: two pieces a lane (bf16) or four (f32), at most 4 query
    # rows a block (16 columns a lane); head_dim 264 covers 33 of bf16's 64
    ((2, 8, 2, 264, 16, 4, BF16, True, None),
     ("vector", 2, 32, 4, 1, 4, (2, 2, 4))),
    ((8, 8, 2, 512, 64, 12, BF16, True, None),
     ("vector", 2, 32, 4, 1, 12, (2, 8, 12))),
    ((8, 8, 2, 512, 64, 12, F32, True, None),
     ("vector", 4, 32, 4, 1, 12, (2, 8, 12))),
    # the element path: head_dim 60 in bf16 (off the 8-element pieces), a
    # misaligned base, head_dim past 512
    ((8, 12, 12, 60, 64, 12, BF16, True, None),
     ("element", 0, 0, 1, 12, 1, (12, 8, 1))),
    ((8, 12, 12, 64, 64, 12, BF16, False, None),
     ("element", 0, 0, 1, 12, 1, (12, 8, 1))),
    ((2, 8, 2, 520, 16, 4, BF16, True, None),
     ("element", 0, 0, 4, 4, 1, (2, 2, 1))),
]

#: windows and int8 pools: (shape as above, w, pool dtype) -> plan
I8 = torch.int8
_WINDOW_PLANS = [
    # the serve shape with a 4-row window: 4 query rows a block, so fewer
    # resident blocks and splits of 3 pages
    ((8, 12, 12, 64, 64, 12, BF16, True, None), 4, BF16,
     ("vector", 1, 8, 4, 3, 4, (12, 8, 4))),
    # ... over int8 pools (8-byte pieces under bf16 q)
    ((8, 12, 12, 64, 64, 12, BF16, True, None), 4, I8,
     ("vector", 1, 8, 4, 3, 4, (12, 8, 4))),
    ((8, 12, 12, 64, 64, 12, BF16, True, None), 1, I8,
     ("vector", 1, 8, 1, 2, 6, (12, 8, 6))),
    # GQA 32/8 at w 4: 16 rows a kv head, two chunks of 8
    ((8, 32, 8, 128, 64, 32, BF16, True, None), 4, BF16,
     ("vector", 1, 16, 8, 16, 2, (16, 8, 2))),
    # a sliding window of 512 with w 4 spans at most 10 pages
    ((8, 32, 8, 128, 64, 32, BF16, True, 512), 4, BF16,
     ("vector", 1, 16, 8, 5, 7, (16, 8, 7))),
    # a window of 9 rows with w 2 still spans at most 2 pages of 16
    ((6, 12, 3, 64, 16, 8, BF16, True, 9), 2, BF16,
     ("vector", 1, 8, 8, 1, 8, (3, 6, 8))),
    # f32 q over int8 pools, and int8 at head_dim 60: the element path,
    # all of a kv head's w x group rows in one block
    ((8, 12, 12, 64, 64, 12, F32, True, None), 4, I8,
     ("element", 0, 0, 4, 12, 1, (12, 8, 1))),
    ((8, 12, 12, 60, 64, 12, BF16, True, None), 4, I8,
     ("element", 0, 0, 4, 12, 1, (12, 8, 1))),
]


@pytest.mark.parametrize("shape,w,pool,want", _WINDOW_PLANS)
def test_decode_plan_windows_and_int8(shape, w, pool, want):
    b, hl, kvh, dh, ps, pps, dtype, aligned, window = shape
    plan = paged_decode_plan(b, hl, kvh, dh, ps, pps, dtype, aligned,
                             lambda pieces, heads: _OCCUPANCY[heads], 132,
                             window, window=w, pool_dtype=pool)
    assert (plan.path, plan.pieces, plan.lanes, plan.heads, plan.split_pages,
            plan.splits, plan.grid) == want


@pytest.mark.parametrize("shape,want", _PLANS)
def test_decode_plan(shape, want):
    b, hl, kvh, dh, ps, pps, dtype, aligned, window = shape
    asked = []

    def occupancy(pieces, heads):
        asked.append((pieces, heads))
        return _OCCUPANCY[heads]

    plan = paged_decode_plan(b, hl, kvh, dh, ps, pps, dtype, aligned,
                             occupancy, 132, window)
    assert isinstance(plan, DecodePlan)
    assert (plan.path, plan.pieces, plan.lanes, plan.heads, plan.split_pages,
            plan.splits, plan.grid) == want
    if plan.path == "vector":
        assert asked == [(plan.pieces, plan.heads)]
        assert 1 <= plan.heads <= 8
        assert plan.split_pages * (plan.splits - 1) < pps <= \
            plan.split_pages * plan.splits
    else:
        assert asked == []
    # the plan is a function of the shapes: no position reaches it
    from apex_tpu_torch.ops.decode_attention import _card_plan
    for fn in (paged_decode_plan, paged_decode_cuda_plan, _card_plan):
        assert "positions" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_decode_card_plan_is_made_once_per_configuration(monkeypatch, dtype):
    """``paged_decode_cuda_plan`` asks the card once per configuration
    (shapes, dtype, 16-byte alignment, window): a repeated call takes the
    plan already made, a misaligned pool or a window makes its own."""
    from apex_tpu_torch.ops import decode_attention as da
    asked = []
    monkeypatch.setattr(_support, "blocks_per_sm",
                        lambda dev, name, *args: asked.append(args) or 2)
    monkeypatch.setattr(_support, "sm_count", lambda dev: 132)
    da._card_plan.cache_clear()
    try:
        n = 96 * 64 * 768
        q = torch.zeros(8, 12, 64, dtype=dtype)
        kp = page_pool(96, 64, 768, dtype, "cpu")
        vp = page_pool(96, 64, 768, dtype, "cpu")
        pt = torch.zeros(8, 12, dtype=torch.int32)
        first = paged_decode_cuda_plan(q, kp, vp, pt, 1)
        for _ in range(3):
            assert paged_decode_cuda_plan(q, kp, vp, pt, 1) == first
        assert first == paged_decode_plan(8, 12, 12, 64, 64, 12, dtype, True,
                                          lambda *_: 2, 132)
        assert first.path == "vector" and len(asked) == 1
        # one element past a 16-byte boundary
        off = torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(96, 64, 768)
        assert paged_decode_cuda_plan(q, off, vp, pt, 1).path == "element"
        assert len(asked) == 1
        window = paged_decode_cuda_plan(q, kp, vp, pt, 1, 128)
        assert window == paged_decode_plan(8, 12, 12, 64, 64, 12, dtype,
                                           True, lambda *_: 2, 132, 128)
        assert paged_decode_cuda_plan(q, kp, vp, pt, 1, 128) == window
        assert len(asked) == 2
    finally:
        da._card_plan.cache_clear()


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_buffers_are_per_stream(monkeypatch, dtype):
    """Each stream gets its own zeroed counters (int32) and partials
    (fp32), kept across calls; a buffer outgrown is replaced by one at
    least twice its size, and the outgrown one is kept."""
    from apex_tpu_torch.ops import decode_attention as da
    monkeypatch.setattr(da, "_BUFFERS", {})
    cpu = torch.device("cpu")
    first = da._stream_buffer(cpu, 1, dtype, 96)
    assert first.numel() >= 96 and first.dtype == dtype and not first.any()
    assert da._stream_buffer(cpu, 1, dtype, 96) is first
    other = da._stream_buffer(cpu, 2, dtype, 96)
    assert other is not first
    grown = da._stream_buffer(cpu, 1, dtype, first.numel() + 1)
    assert grown.numel() >= 2 * first.numel() and not grown.any()
    assert da._stream_buffer(cpu, 1, dtype, 96) is grown
    assert [t is u for t, u in zip(da._BUFFERS[(None, 1, dtype)],
                                   (first, grown))] == [True, True]
    assert da._stream_buffer(cpu, 2, dtype, 96) is other
    other_dtype = torch.float32 if dtype == torch.int32 else torch.int32
    assert da._stream_buffer(cpu, 1, other_dtype, 96) is not grown


def _emulate_vector_kernel(q, kp, vp, table, positions, group, window, plan):
    """Kernel C's vector path walked in fp32 numpy, block by block, as
    csrc/paged_decode.cu does it (8 warps; row slots of ``plan.lanes``
    lanes; tiles of 2 rows a slot)."""
    n_pages, ps, f = kp.shape
    b, hl, dh = q.shape
    kvh = hl // group
    pps = table.shape[1]
    slots = 32 // plan.lanes
    groups = 8 * slots
    rt = 2
    chunks = plan.grid[0] // kvh
    split_rows = plan.split_pages * ps
    qs = q.astype(np.float32) * np.float32(np.log2(np.e) / np.sqrt(dh))
    ctx = np.full((b, hl, dh), np.nan, np.float32)
    neg = np.float32(-1e30)
    for r in range(b):
        pos = int(positions[r])
        row_lo = max(0, pos - window + 1) if window else 0
        row_hi = min(pos + 1, pps * ps)
        for kv in range(kvh):
            for chunk in range(chunks):
                h0 = kv * group + chunk * plan.heads
                heads = range(h0, min(h0 + plan.heads, (kv + 1) * group))
                if row_lo >= row_hi:
                    ctx[r, heads] = 0
                    continue
                s_lo = row_lo // split_rows
                s_hi = (row_hi - 1) // split_rows
                parts = []
                for s in range(s_lo, s_hi + 1):
                    lo = max(row_lo, s * split_rows)
                    hi = min(row_hi, (s + 1) * split_rows)
                    tiles = -(-(hi - lo) // (groups * rt))
                    m = np.full((groups, len(heads)), neg, np.float32)
                    l = np.zeros((groups, len(heads)), np.float32)
                    acc = np.zeros((groups, len(heads), dh), np.float32)
                    for gi in range(groups):
                        for tile in range(tiles):
                            rows = [lo + gi + (tile * rt + k) * groups
                                    for k in range(rt)]
                            rows = [u for u in rows if u < hi]
                            if not rows:
                                continue
                            pages = [min(max(int(table[r, u // ps]), 0),
                                         n_pages - 1) for u in rows]
                            kk = np.stack([kp[p, u % ps, kv * dh:(kv + 1) * dh]
                                           for p, u in zip(pages, rows)])
                            vv = np.stack([vp[p, u % ps, kv * dh:(kv + 1) * dh]
                                           for p, u in zip(pages, rows)])
                            sc = qs[r, heads] @ kk.T          # [heads, rows]
                            mt = np.maximum(m[gi], sc.max(axis=1))
                            alpha = np.exp2(m[gi] - mt)
                            p = np.exp2(sc - mt[:, None])
                            l[gi] = l[gi] * alpha + p.sum(axis=1)
                            acc[gi] = acc[gi] * alpha[:, None] + p @ vv
                            m[gi] = mt
                    # row slots of a warp (xor butterfly), then the warps
                    wm, wl, wacc = [], [], []
                    for w in range(8):
                        sl = slice(w * slots, (w + 1) * slots)
                        mx = m[sl].max(axis=0)
                        sc = np.exp2(m[sl] - mx)
                        wm.append(mx)
                        wl.append((l[sl] * sc).sum(axis=0))
                        wacc.append((acc[sl] * sc[..., None]).sum(axis=0))
                    mx = np.max(wm, axis=0)
                    sc = [np.exp2(x - mx) for x in wm]
                    parts.append((mx, sum(x * y for x, y in zip(wl, sc)),
                                  sum(x * y[:, None] for x, y in
                                      zip(wacc, sc))))
                # the splits, folded in split order
                mx, ls, accs = neg, 0, 0
                for pm, pl, pa in parts:
                    mn = np.maximum(mx, pm)
                    a0, a1 = np.exp2(mx - mn), np.exp2(pm - mn)
                    ls = ls * a0 + pl * a1
                    accs = accs * a0[:, None] + pa * a1[:, None]
                    mx = mn
                ctx[r, heads] = accs / np.where(ls > 0, ls, 1)[:, None]
    return ctx.reshape(b, hl * dh)


@pytest.mark.parametrize("group,window,dh,split_pages", [
    (1, None, 64, 1), (4, None, 64, 3), (3, 20, 64, 2), (12, 70, 64, 1),
    (4, None, 128, 2), (8, 9, 32, 8), (2, None, 16, 2)])
def test_kernel_c_vector_walk_emulation(group, window, dh, split_pages):
    """The vector kernel's walk, at the card test's shapes (pages of 16;
    a slot at 0, one past its table, a sentinel inside a slot's range),
    gives the plain version's context within 1e-5 in fp32, and zeros
    where a window leaves a slot no row."""
    rng = np.random.RandomState(group * 100 + dh)
    b, hl, ps, pps, n_pages = 6, 12 if group != 8 else 16, 16, 8, 40
    kvh = hl // group
    f = kvh * dh
    positions = np.array([0, 15, 16, 77, 127, 200], np.int32)
    table = np.full((b, pps), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for r in range(b):
        need = min(pps, int(positions[r]) // ps + 1)
        table[r, :need] = perm[used % n_pages:used % n_pages + need]
        used += need
    table[4, 1] = n_pages          # a sentinel inside the slot's range
    q = rng.randn(b, hl, dh).astype(np.float32)
    kp = rng.randn(n_pages, ps, f).astype(np.float32)
    vp = rng.randn(n_pages, ps, f).astype(np.float32)
    plan = paged_decode_plan(b, hl, kvh, dh, ps, pps, torch.float32, True,
                             lambda *_: 4, 132, window)
    splits = -(-pps // split_pages)
    plan = plan._replace(split_pages=split_pages, splits=splits,
                         grid=plan.grid[:2] + (splits,))
    got = _emulate_vector_kernel(q, kp, vp, table, positions, group, window,
                                 plan)
    want = decode_plain(torch.from_numpy(q), torch.from_numpy(kp),
                        torch.from_numpy(vp), torch.from_numpy(table),
                        torch.from_numpy(positions), group, window).numpy()
    # a slot whose window lies past its table has no row to read: the
    # kernels give 0 (the TPU kernel's l > 0 guard), the plain version the
    # mean of every (masked) row
    empty = positions - (window or 10 ** 9) + 1 >= pps * ps
    np.testing.assert_array_equal(got[empty], 0)
    np.testing.assert_allclose(got[~empty], want[~empty], atol=1e-5, rtol=0)
