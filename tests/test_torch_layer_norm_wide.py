"""Kernels A and D past their element kernels' shared memory, on the CPU.

Rows wider than h = 14336 (Kernel A) or 29056 (Kernel D) take the
wide-row kernels on the card (``csrc/layer_norm_fwd.cu``,
``csrc/layer_norm_bwd.cu``); here the host's plan is held to that choice,
exactly past the old limits, and the plain versions the wide kernels are
checked against on the card are held to the JAX package's Pallas kernels
(``_fwd_pallas``, ``_bwd_pallas``) in interpret mode at h 16384 in f32,
bf16 and fp16 and at 18440 (not a multiple of 128: the TPU kernels pad)
in fp16, a few rows each, fp32 w and b.

Tolerances (those of ``test_torch_layer_norm.py``): f32 y and dx atol
1e-5, mean and invvar atol 1e-5; bf16 and fp16 y and dx within one ulp of
their magnitude (floored at 2^-8), one rounding of fp32 values that agree
to ~1e-6; dw and db (fp32 sums over the rows in another order) atol 1e-4
+ rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_bwd_plain,
    layer_norm_bwd_plan,
    layer_norm_fwd,
    layer_norm_fwd_plain,
    layer_norm_fwd_plan,
)

ROWS = 8
#: (h, dtype): h 16384 (Llama-3.1-405B's hidden size, as LayerNorm) in
#: each dtype, 18440 (as RMSNorm) in fp16, the finest rounding (an
#: interpret-mode JAX kernel costs ~1 s of tracing whatever its shape)
WIDE = {16384: False, 18440: True}
CASES = [(16384, "float32"), (16384, "bfloat16"), (16384, "float16"),
         (18440, "float16")]


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "interpret")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


@pytest.mark.parametrize("kernel,h,path", [
    ("fwd", 14336, "element"), ("fwd", 14337, "wide"),
    ("fwd", 16384, "wide"), ("fwd", 32768, "wide"),
    ("bwd", 29056, "element"), ("bwd", 29057, "wide"),
    ("bwd", 16384, "element"), ("bwd", 32768, "wide")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_takes_the_wide_path_past_the_old_limits(kernel, h, path,
                                                      dtype):
    """A's wide path starts one past h 14336, D's one past 29056, for any
    dtype; below them nothing changes. The wide grid covers every row
    once: A a block a row, D runs of ``ceil(m / SMs)`` rows, at most one
    block an SM."""
    m, n_sms = 2048, 132
    ptrs = (4096, 8192, 12288, None)
    if kernel == "fwd":
        plan = layer_norm_fwd_plan(m, h, dtype, ptrs, lambda p: 2, n_sms)
    else:
        plan = layer_norm_bwd_plan(m, h, dtype, dtype, ptrs, lambda p: 2,
                                   n_sms)
    assert plan.path == path
    assert (plan.blocks - 1) * plan.block_rows < m <= \
        plan.blocks * plan.block_rows
    if path == "wide":
        assert plan.pieces == 0 and plan.wide == 1
        assert plan.blocks == (m if kernel == "fwd" else 128)


def test_wide_rows_run_through_the_autograd_function():
    """The public function takes any width (the wrapper's old raise past
    h 14336 is gone) and differentiates through it."""
    x = torch.randn(3, 16400, requires_grad=True)
    y = layer_norm_fwd(x, None, None, 16400, 1e-5, True)[0]
    y.square().sum().backward()
    assert y.shape == x.shape and torch.isfinite(x.grad).all()


def _inputs(h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(ROWS, h) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(ROWS, h).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    return x, dy, w, b


def _check_rounded(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    bits = 7 if dtype == "bfloat16" else 10
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(mag)) - bits)
    assert np.all(np.abs(got - want) <= ulp), \
        float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("h,dtype", CASES)
def test_wide_forward_plain_matches_jax_interpret_kernel(jax_interpret, h,
                                                         dtype):
    is_rms = WIDE[h]
    x, _, w, b = _inputs(h, 1)
    b = None if is_rms else b
    jy, jmean, jiv = jln._fwd_pallas(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
        None if b is None else jnp.asarray(b), h, 1e-5, is_rms,
        getattr(jnp, dtype))
    ty, tmean, tiv = layer_norm_fwd_plain(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5, is_rms,
        getattr(torch, dtype))
    _check_rounded(ty.float().numpy(),
                   np.asarray(jy.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tiv.numpy(), np.asarray(jiv), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("h,dtype", CASES)
def test_wide_backward_plain_matches_jax_interpret_kernel(jax_interpret, h,
                                                          dtype):
    is_rms = WIDE[h]
    has_bias = not is_rms
    x, dy, w, _ = _inputs(h, 2)
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in (x, dy))
    _, mean, iv = layer_norm_fwd_plain(tx, torch.from_numpy(w), None, 1e-5,
                                       is_rms, torch.float32)
    jdx, jdw, jdb = jln._bwd_pallas(
        jnp.asarray(dy, getattr(jnp, dtype)),
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(mean.numpy()),
        jnp.asarray(iv.numpy()), jnp.asarray(w), h, is_rms, has_bias)
    tdx, tdw, tdb = layer_norm_bwd_plain(tdy, tx, mean, iv,
                                         torch.from_numpy(w), is_rms,
                                         has_bias)
    _check_rounded(tdx.float().numpy(),
                   np.asarray(jdx.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), atol=1e-4,
                               rtol=1e-5)
    assert (tdb is None) == (jdb is None)
    if has_bias:
        np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), atol=1e-4,
                                   rtol=1e-5)
