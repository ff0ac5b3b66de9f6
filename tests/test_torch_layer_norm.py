"""LayerNorm / RMSNorm forward and backward of the port against the JAX
package.

Numpy-made inputs go through ``apex_tpu.ops.layer_norm`` (its plain path,
and the Pallas kernels in interpret mode) and through
``apex_tpu_torch.ops.layer_norm`` on the CPU (the plain versions of the
Hopper kernels). Hidden sizes 96 (not a multiple of 128: the TPU kernels
pad) and 768, 300 rows (more than one 256-row TPU block, so the
backward's dw/db reduction crosses blocks).

Tolerances: f32 output, mean and invvar atol 1e-5; a bf16 output within
one bf16 ulp of the JAX value (one rounding of an f32 value that agrees
to ~1e-6 can land on either neighbour). Backward: f32 dx atol 1e-5, dw
and db (fp32 sums over 300 rows in another order) atol 1e-4 + rtol 1e-5;
bf16 dx within one bf16 ulp of its magnitude floored at 2^-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import layer_norm as jln
from apex_tpu.ops.layer_norm import _norm_fwd_impl
from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    layer_norm_bwd_plain,
    layer_norm_fwd,
)

ROWS = 300
# (is_rms, affine, bias)
KINDS = {"ln_affine_bias": (False, True, True),
         "ln_affine": (False, True, False),
         "ln": (False, False, False),
         "rms_affine": (True, True, False),
         "rms": (True, False, False)}
# (x dtype, out dtype: None keeps the promote semantics)
DTYPES = {"f32": ("float32", None), "bf16_promote": ("bfloat16", None),
          "bf16_out_bf16": ("bfloat16", "bfloat16")}


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _inputs(h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(ROWS, h) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    return x, w, b


def _both(kind, h, dtype_case, seed=0):
    is_rms, affine, has_bias = KINDS[kind]
    xdt, odt = DTYPES[dtype_case]
    x, w, b = _inputs(h, seed)
    w = w if affine else None
    b = b if has_bias else None
    jx = jnp.asarray(x, getattr(jnp, xdt))
    jy, jmean, jiv = _norm_fwd_impl(
        jx, None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), (h,), 1e-5, is_rms,
        None if odt is None else getattr(jnp, odt))
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    ty, tmean, tiv = layer_norm_fwd(
        tx, None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), (h,), 1e-5, is_rms,
        None if odt is None else getattr(torch, odt))
    return (np.asarray(jy.astype(jnp.float32)), np.asarray(jmean),
            np.asarray(jiv), str(jy.dtype)), (
            ty.float().numpy(), tmean.numpy(), tiv.numpy(),
            str(ty.dtype).replace("torch.", ""))


def _check(jax_out, torch_out):
    jy, jmean, jiv, jdt = jax_out
    ty, tmean, tiv, tdt = torch_out
    assert tdt == jdt
    np.testing.assert_allclose(tmean, jmean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tiv, jiv, atol=1e-5, rtol=0)
    if tdt == "bfloat16":
        mag = np.maximum(np.abs(jy), np.abs(ty))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(ty - jy) <= ulp)
    else:
        np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype_case", list(DTYPES))
@pytest.mark.parametrize("h", [96, 768])
@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_jax_plain(jax_mode, kind, h, dtype_case):
    jax_mode("off")
    _check(*_both(kind, h, dtype_case))


@pytest.mark.parametrize("kind,dtype_case", [("ln_affine_bias", "f32"),
                                             ("rms_affine", "bf16_promote"),
                                             ("ln", "bf16_out_bf16")])
@pytest.mark.parametrize("h", [96, 768])
def test_forward_matches_jax_interpret_kernel(jax_mode, kind, h, dtype_case):
    jax_mode("interpret")
    _check(*_both(kind, h, dtype_case, seed=1))


def test_modules_match_functions():
    x, w, b = _inputs(96, 2)
    tx = torch.from_numpy(x)
    ln = FusedLayerNorm(96, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(tx)
    want = fused_layer_norm_affine(tx, torch.from_numpy(w),
                                   torch.from_numpy(b), 96)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    rms = FusedRMSNorm(96, elementwise_affine=False, device="cpu")
    assert rms(tx.to(torch.bfloat16)).dtype == torch.bfloat16


def test_forward_only_raises_for_autograd():
    """LayerNorm is no longer forward-only (its backward is Kernel D):
    autograd reaches x through y, and mean/invvar carry no gradient."""
    x = torch.randn(4, 96, requires_grad=True)
    y, mean, invvar = layer_norm_fwd(x, None, None, 96, 1e-5, False)
    assert not mean.requires_grad and not invvar.requires_grad
    y.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    with torch.no_grad():
        assert not layer_norm_fwd(x, None, None, 96, 1e-5, False)[0] \
            .requires_grad


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="normalized_shape"):
        layer_norm_fwd(torch.zeros(4, 96), None, None, 64, 1e-5, False)


def _bwd_inputs(kind, h, dtype_case, seed):
    is_rms, affine, has_bias = KINDS[kind]
    xdt, _ = DTYPES[dtype_case]
    x, w, b = _inputs(h, seed)
    dy = np.random.RandomState(seed + 100).randn(ROWS, h).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, xdt))
    _, jmean, jiv = _norm_fwd_impl(jx, jnp.asarray(w) if affine else None,
                                   None, (h,), 1e-5, is_rms, None)
    return (is_rms, affine, has_bias, xdt, x, dy, w if affine else None,
            np.asarray(jmean), np.asarray(jiv))


def _check_bwd(got, want, xdt):
    (tdx, tdw, tdb), (jdx, jdw, jdb) = got, want
    jdx = np.asarray(jnp.asarray(jdx).astype(jnp.float32))
    tdx = tdx.float().numpy()
    if xdt == "bfloat16":
        # magnitude floored at 2^-8: where dyw - c1 - xhat * c2 cancels to
        # ~1e-6, fp32 summation order moves the result by more than the
        # bf16 ulp of the tiny value
        mag = np.maximum(np.maximum(np.abs(jdx), np.abs(tdx)), 2.0 ** -8)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(tdx - jdx) <= ulp)
    else:
        np.testing.assert_allclose(tdx, jdx, atol=1e-5, rtol=0)
    for t, j in ((tdw, jdw), (tdb, jdb)):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                       rtol=1e-5)


@pytest.mark.parametrize("dtype_case", ["f32", "bf16_out_bf16"])
@pytest.mark.parametrize("h", [96, 768])
@pytest.mark.parametrize("kind", list(KINDS))
def test_backward_plain_matches_jax_bwd_jnp(kind, h, dtype_case):
    is_rms, affine, has_bias, xdt, x, dy, w, mean, iv = _bwd_inputs(
        kind, h, dtype_case, seed=3)
    jx, jdy = (jnp.asarray(a, getattr(jnp, xdt)) for a in (x, dy))
    want = jln._bwd_jnp(jdy, jx, jnp.asarray(mean), jnp.asarray(iv),
                        None if w is None else jnp.asarray(w), h, is_rms,
                        has_bias)
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, xdt)) for a in (x, dy))
    got = layer_norm_bwd_plain(tdy, tx, torch.from_numpy(mean),
                               torch.from_numpy(iv),
                               None if w is None else torch.from_numpy(w),
                               is_rms, has_bias)
    _check_bwd(got, want, xdt)


@pytest.mark.parametrize("kind,dtype_case", [("ln_affine_bias", "f32"),
                                             ("rms_affine", "f32"),
                                             ("ln_affine_bias",
                                              "bf16_out_bf16")])
@pytest.mark.parametrize("h", [96, 768])
def test_backward_plain_matches_jax_interpret_kernel(jax_mode, kind, h,
                                                     dtype_case):
    """Against the Pallas backward in interpret mode: 300 rows over two
    256-row blocks, so its revisited dw/db accumulator runs twice."""
    jax_mode("interpret")
    is_rms, affine, has_bias, xdt, x, dy, w, mean, iv = _bwd_inputs(
        kind, h, dtype_case, seed=4)
    jx, jdy = (jnp.asarray(a, getattr(jnp, xdt)) for a in (x, dy))
    want = jln._bwd_pallas(jdy, jx, jnp.asarray(mean), jnp.asarray(iv),
                           jnp.asarray(w), h, is_rms, has_bias)
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, xdt)) for a in (x, dy))
    got = layer_norm_bwd_plain(tdy, tx, torch.from_numpy(mean),
                               torch.from_numpy(iv), torch.from_numpy(w),
                               is_rms, has_bias)
    _check_bwd(got, want, xdt)


def _jax_vs_torch_grads(jfn, tfn, x, w, b, dy):
    """d(sum(y * dy)) wrt (x, w, b) through jax.grad and torch autograd."""
    args = [a for a in (x, w, b) if a is not None]
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) * dy),
                  argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (tfn(*targs).float() * torch.from_numpy(dy)).sum().backward()
    return [np.asarray(g) for g in jg], [t.grad.numpy() for t in targs]


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("kind", ["ln_affine_bias", "rms_affine", "ln",
                                  "rms"])
def test_autograd_matches_jax_grad(jax_mode, kind, memory_efficient):
    jax_mode("off")
    is_rms, affine, has_bias = KINDS[kind]
    x, w, b = _inputs(96, 5)
    dy = np.random.RandomState(6).randn(ROWS, 96).astype(np.float32)
    me = memory_efficient
    if is_rms and affine:
        jfn = lambda x_, w_: jln.fused_rms_norm_affine(  # noqa: E731
            x_, w_, 96, memory_efficient=me)
        tfn = lambda x_, w_: fused_rms_norm_affine(  # noqa: E731
            x_, w_, 96, memory_efficient=me)
        args = (x, w, None)
    elif affine:
        jfn = lambda x_, w_, b_: jln.fused_layer_norm_affine(  # noqa: E731
            x_, w_, b_, 96, memory_efficient=me)
        tfn = lambda x_, w_, b_: fused_layer_norm_affine(  # noqa: E731
            x_, w_, b_, 96, memory_efficient=me)
        args = (x, w, b)
    else:
        norm = jln.fused_rms_norm if is_rms else jln.fused_layer_norm
        tnorm = fused_rms_norm if is_rms else fused_layer_norm
        jfn = lambda x_: norm(x_, 96, memory_efficient=me)  # noqa: E731
        tfn = lambda x_: tnorm(x_, 96, memory_efficient=me)  # noqa: E731
        args = (x, None, None)
    jg, tg = _jax_vs_torch_grads(jfn, tfn, *args, dy)
    for j, t in zip(jg, tg):
        # fp32 sums over 300 rows in another order (dw/db reach ~40);
        # memory_efficient rebuilds x from y: rounding of (y - b) / w
        np.testing.assert_allclose(t, j, atol=1e-4 if me else 1e-5,
                                   rtol=1e-5)


def test_bf16_block_grads_keep_their_dtypes():
    """The transformer block's LN: bf16 x and out_dtype=x.dtype over fp32
    parameters gives a bf16 dx and fp32 dw/db (the caller casts them to
    the parameters' dtype), and the CPU path launches no kernel."""
    before = dict(LAUNCHES)
    x = torch.randn(8, 96, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(96, requires_grad=True)
    b = torch.zeros(96, requires_grad=True)
    y = fused_layer_norm_affine(x, w, b, 96, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
    assert LAUNCHES == before
