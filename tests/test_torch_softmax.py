"""The fused scale + mask + softmax of the port against the JAX package.

Numpy-made scores and masks go through ``apex_tpu.ops.softmax`` (the plain
``_fwd_jnp`` / ``_bwd_jnp``, and the Pallas ``_fwd_pallas`` /
``_bwd_pallas`` in interpret mode) and through the port's plain versions
``softmax_fwd_plain`` / ``softmax_bwd_plain`` (what Kernels G and H compute
on the card). Cases: a BERT padding mask ``[b, 1, sq, sk]`` whose padded
query rows mask every key (uniform ``1/k``, not 0), a key mask
``[b, 1, 1, sk]``, causal, a row of 200, ``scale = 0.5``; f32 and bf16.
Every public function goes through torch autograd against ``jax.vjp`` with
the same cotangent, including the masked positions' gradient
(``y * (dy - s)``, not 0). ``FusedScaleMaskSoftmax`` routes as the JAX one
does: causal with a mask, or non-square causal scores, take the unfused
path.

Tolerances: f32 atol 2e-6 (one fp32 softmax on each side, exp and the row
sum in other orders); bf16 one rounding step (rtol 2^-7, atol 2^-15) —
both compute in fp32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFusedSoftmax,
)
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.ops.softmax import (
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
    softmax_bwd_plain,
    softmax_fwd_plain,
)
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

CASES = {
    # name: (x shape, mask: None | "padding" | mask shape, causal, scale)
    "bert_padding": ((2, 3, 20, 20), "padding", False, 1.0),
    "key_mask_k200": ((2, 3, 10, 200), (2, 1, 1, 200), False, 1.0),
    "causal": ((1, 2, 24, 24), None, True, 1.0),
    "scale_half": ((2, 2, 8, 33), (2, 1, 8, 33), False, 0.5),
    "no_mask": ((1, 4, 6, 50), None, False, 0.125),
}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _inputs(name, seed=0):
    shape, mask, causal, scale = CASES[name]
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*shape)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    if mask == "padding":
        valid = np.ones((shape[0], shape[-1]), bool)
        valid[1, 13:] = False
        mask = ~(valid[:, None, None, :] & valid[:, None, :, None])
    elif mask is not None:
        mask = rng.rand(*mask) < 0.3
    return x, dy, mask, causal, scale


def _check(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -15,
                                   rtol=2.0 ** -7)


def _torch(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][1])


def _jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][2])


def _jax_rows(x, mask, dtype):
    k = x.shape[-1]
    x2 = _jax(x, dtype).reshape(-1, k)
    m2 = (None if mask is None
          else jnp.broadcast_to(jnp.asarray(mask), x.shape).reshape(-1, k))
    return x2, m2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_jax_reference(name, dtype):
    x, dy, mask, causal, scale = _inputs(name)
    k, sq = x.shape[-1], x.shape[-2]
    x2, m2 = _jax_rows(x, mask, dtype)
    jdt = DTYPES[dtype][2]
    want_y = jsm._fwd_jnp(x2, m2, scale, k, sq, causal, jdt)
    tx = _torch(x, dtype)
    y = softmax_fwd_plain(tx, None if mask is None
                          else torch.from_numpy(mask), scale, sq, causal)
    assert y.dtype == tx.dtype
    _check(y.reshape(-1, k), want_y, dtype)
    # the backward on the same y (the JAX one's, widened exactly)
    want_dx = jsm._bwd_jnp(_jax(dy, dtype).reshape(-1, k), want_y, scale, k)
    ty = torch.from_numpy(np.array(want_y.astype(jnp.float32))).to(
        tx.dtype)
    dx = softmax_bwd_plain(_torch(dy, dtype).reshape(-1, k), ty, scale)
    _check(dx, want_dx, dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_jax_interpret_kernels(jax_mode, name):
    jax_mode("interpret")
    x, dy, mask, causal, scale = _inputs(name, seed=1)
    k, sq = x.shape[-1], x.shape[-2]
    x2, m2 = _jax_rows(x, mask, "f32")
    want_y = jsm._fwd_pallas(x2, m2, scale, k, sq, causal, jnp.float32)
    y = softmax_fwd_plain(torch.from_numpy(x), None if mask is None
                          else torch.from_numpy(mask), scale, sq, causal)
    _check(y.reshape(-1, k), want_y, "f32")
    want_dx = jsm._bwd_pallas(jnp.asarray(dy).reshape(-1, k), want_y, scale, k)
    dx = softmax_bwd_plain(torch.from_numpy(dy).reshape(-1, k),
                           torch.from_numpy(np.array(want_y)), scale)
    _check(dx, want_dx, "f32")


def _public(name):
    """(jax function, torch function) of the public API for a case."""
    _, mask, causal, _ = CASES[name]
    if causal:
        return (lambda x, m, s: jsm.scaled_upper_triang_masked_softmax(
                    x.reshape(-1, *x.shape[-2:]), s).reshape(x.shape),
                lambda x, m, s: scaled_upper_triang_masked_softmax(
                    x.reshape(-1, *x.shape[-2:]), s).reshape(x.shape))
    if mask is None:
        return (lambda x, m, s: jsm.scaled_softmax(x, s),
                lambda x, m, s: scaled_softmax(x, s))
    if name == "scale_half":
        return (jsm.generic_scaled_masked_softmax,
                generic_scaled_masked_softmax)
    return jsm.scaled_masked_softmax, scaled_masked_softmax


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_autograd_matches_jax_vjp(jax_mode, name, dtype):
    jax_mode("off")
    x, dy, mask, _, scale = _inputs(name, seed=2)
    jfn, tfn = _public(name)
    jm = None if mask is None else jnp.asarray(mask)
    jy, vjp = jax.vjp(lambda a: jfn(a, jm, scale), _jax(x, dtype))
    (jdx,) = vjp(_jax(dy, dtype))
    tx = _torch(x, dtype).requires_grad_()
    before = dict(LAUNCHES)
    ty = tfn(tx, None if mask is None else torch.from_numpy(mask), scale)
    ty.backward(_torch(dy, dtype))
    assert LAUNCHES == before            # CPU tensors launch no kernel
    assert ty.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    _check(ty.detach(), jy, dtype)
    _check(tx.grad, jdx, dtype)


def test_fully_masked_rows_are_uniform_with_nonzero_grads():
    """A padded query row masks every key: the forward is 1/k on that row,
    and its gradient is y * (dy - s), not 0 (the JAX custom VJP does not
    re-apply the mask)."""
    x, dy, mask, _, scale = _inputs("bert_padding")
    tx = torch.from_numpy(x).requires_grad_()
    y = scaled_masked_softmax(tx, torch.from_numpy(mask), scale)
    y.backward(torch.from_numpy(dy))
    k = x.shape[-1]
    pad = y[1, :, 13:].detach().numpy()
    np.testing.assert_allclose(pad, np.full_like(pad, 1.0 / k), rtol=1e-6)
    assert np.abs(tx.grad[1, :, 13:].numpy()).max() > 1e-3
    # the padded keys of a valid query row: p ~ e^-10000, a zero gradient
    assert np.abs(tx.grad[1, :, :13, 13:].numpy()).max() < 1e-6


@pytest.mark.parametrize("mask_type,shape,with_mask,fused", [
    ("padding", (2, 2, 12, 12), True, True),
    ("padding", (2, 2, 8, 12), False, True),
    ("causal", (2, 2, 12, 12), False, True),
    ("causal", (2, 2, 12, 12), True, False),
    ("causal", (2, 2, 6, 12), False, False),
])
def test_fused_scale_mask_softmax_routes_as_jax(jax_mode, monkeypatch,
                                                mask_type, shape, with_mask,
                                                fused):
    """The same ``is_kernel_available`` predicate: causal with an explicit
    mask, or non-square causal scores, take the unfused path (causal AND
    the mask); the outputs match the JAX dispatcher's."""
    jax_mode("off")
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(shape[0], 1, shape[2], shape[3]) < 0.3
            if with_mask else None)
    jsoft = JaxFusedSoftmax(attn_mask_type=getattr(JaxMaskType, mask_type),
                            scale=0.7)
    tsoft = FusedScaleMaskSoftmax(attn_mask_type=getattr(AttnMaskType,
                                                         mask_type),
                                  scale=0.7)
    tm = None if mask is None else torch.from_numpy(mask)
    assert tsoft.is_kernel_available(tm, *shape) == fused
    assert jsoft.is_kernel_available(None if mask is None
                                     else jnp.asarray(mask), *shape) == fused
    calls = []
    monkeypatch.setattr(tsoft, "forward_torch_softmax",
                        lambda *a: calls.append(1) or
                        FusedScaleMaskSoftmax.forward_torch_softmax(tsoft,
                                                                    *a))
    got = tsoft(torch.from_numpy(x), tm)
    assert bool(calls) != fused
    want = jsoft(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    _check(got, want, "f32")


def test_unfused_path_in_bf16_with_fp32_softmax():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    mask = rng.rand(1, 1, 5, 5) < 0.3
    jsoft = JaxFusedSoftmax(input_in_bf16=True,
                            attn_mask_type=JaxMaskType.causal)
    tsoft = FusedScaleMaskSoftmax(input_in_bf16=True,
                                  attn_mask_type=AttnMaskType.causal)
    got = tsoft(_torch(x, "bf16"), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    _check(got, jsoft(_jax(x, "bf16"), jnp.asarray(mask)), "bf16")


def test_errors():
    with pytest.raises(ValueError, match="sq == sk"):
        scaled_upper_triang_masked_softmax(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="broadcast"):
        scaled_masked_softmax(torch.zeros(2, 1, 3, 4),
                              torch.zeros(3, 1, 3, 4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)
