"""LayerNorm / RMSNorm forward of the port against the JAX package.

Numpy-made inputs go through ``apex_tpu.ops.layer_norm._norm_fwd_impl``
(its plain path, and the Pallas kernel in interpret mode) and through
``apex_tpu_torch.ops.layer_norm.layer_norm_fwd`` on the CPU (the plain
version of the Hopper kernel). Hidden sizes 96 (not a multiple of 128:
the TPU kernel pads) and 768, 300 rows (more than one TPU row block).

Tolerances: f32 output, mean and invvar atol 1e-5; a bf16 output within
one bf16 ulp of the JAX value (one rounding of an f32 value that agrees
to ~1e-6 can land on either neighbour).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops.layer_norm import _norm_fwd_impl
from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm_affine,
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
    x = torch.randn(4, 96, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        layer_norm_fwd(x, None, None, 96, 1e-5, False)
    with torch.no_grad():
        layer_norm_fwd(x, None, None, 96, 1e-5, False)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="normalized_shape"):
        layer_norm_fwd(torch.zeros(4, 96), None, None, 64, 1e-5, False)
