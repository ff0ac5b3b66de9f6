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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops.decode_attention import _pallas, _reference
from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops.decode_attention import (
    append_rows,
    fused_paged_decode_attention,
    page_pool,
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
    q, k_new, v_new, k_pages, v_pages, table, positions = _inputs()
    kp, vp = _torch_pool(k_pages), _torch_pool(v_pages)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="w > 1"):
        fused_paged_decode_attention(
            t(q)[:, None].repeat(1, 2, 1, 1), t(k_new)[:, None].repeat(1, 2, 1),
            t(v_new)[:, None].repeat(1, 2, 1), kp, vp, t(table),
            t(positions), queries_per_group=GROUP)
    with pytest.raises(NotImplementedError, match="int8"):
        fused_paged_decode_attention(
            t(q), t(k_new), t(v_new), kp.to(torch.int8), vp.to(torch.int8),
            t(table), t(positions), queries_per_group=GROUP)


def test_plain_path_counts_no_launch():
    before = dict(_support.LAUNCHES)
    _run_torch(*_inputs(), None)
    assert _support.LAUNCHES == before
