"""The softmax cross entropy and the RoPE variants against the JAX
package, on the CPU.

Numpy-made inputs go through ``apex_tpu.ops.cross_entropy`` /
``apex_tpu.ops.rope`` and their ports; gradients are taken of
``sum(out * g)`` for a numpy-made ``g`` through ``jax.grad`` and torch
autograd, so each side runs its own custom backward (JAX's ``_vjp_bwd``
and ``_rc_bwd``; the port's ``torch.autograd.Function``s).

- ``softmax_cross_entropy_loss`` over ``[N, V]`` logits, smoothing 0.1 in
  f32 and 0 in bf16, with rows at ``ignore_index`` (which give 0 and no
  gradient): loss atol 1e-5, dlogits atol 1e-6 in f32; in bf16 dlogits
  within one bf16 ulp (one rounding of fp32 values that agree to ~1e-7);
- ``fused_rope_cached`` (tables whose two halves differ, so its VJP, the
  gradient rotated by ``-sin``, is not autograd's; a partial rotary dim)
  and ``fused_rope_thd`` (three packed sequences) in f32,
  ``fused_rope_2d`` (a 3 x 5 image) in bf16, forward and input gradient:
  f32 atol 1e-6, bf16 within one bf16 ulp (each JAX call costs seconds
  of op-by-op compiles, so each variant runs in one dtype);
- ``fused_rope`` bitwise ``fused_rope_cached`` on its angles, and the
  re-exports under the reference's names
  (``transformer.functional.fused_apply_rotary_pos_emb*``,
  ``contrib.xentropy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import cross_entropy as jce
from apex_tpu.ops import rope as jrope
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex_tpu_torch.ops import cross_entropy as tce
from apex_tpu_torch.ops import rope as trope
from apex_tpu_torch.transformer import functional as tfunc

def _check(got, want, dtype, atol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    else:
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -20)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= ulp)


def _grads(jfn, tfn, arrays, dtype, g, argnums=(0,)):
    """Outputs and the gradients of ``sum(out * g)`` wrt ``argnums`` on both
    sides."""
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) if i in argnums
             else jnp.asarray(a) for i, a in enumerate(arrays)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             if i in argnums else torch.from_numpy(a)
             for i, a in enumerate(arrays)]
    jout = jfn(*jargs)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) * g),
        argnums=argnums)(*jargs)
    tout = tfn(*targs)
    (tout.float() * torch.from_numpy(g)).sum().backward()
    return jout, tout, jgrads, [targs[i].grad for i in argnums]


@pytest.mark.parametrize("smoothing,dtype", [(0.1, "float32"),
                                             (0.0, "bfloat16")])
def test_softmax_cross_entropy_matches_jax(smoothing, dtype):
    rng = np.random.RandomState(0)
    logits = (3.0 * rng.randn(12, 50)).astype(np.float32)
    labels = rng.randint(0, 50, 12).astype(np.int64)
    labels[[2, 7]] = -100
    g = rng.rand(12).astype(np.float32)
    jout, tout, (jd,), (td,) = _grads(
        lambda lo, la: jce.softmax_cross_entropy_loss(lo, la, smoothing,
                                                      -100),
        lambda lo, la: tce.softmax_cross_entropy_loss(lo, la, smoothing,
                                                      -100),
        [logits, labels], dtype, g)
    assert tout.dtype == torch.float32
    _check(tout, jout, "float32", 1e-5)
    assert not tout[[2, 7]].any() and not td[[2, 7]].any()
    assert td.dtype == getattr(torch, dtype)
    _check(td, jd, dtype, 1e-6)
    same = SoftmaxCrossEntropyLoss.apply(
        torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    torch.testing.assert_close(same, tce.softmax_cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), smoothing))


@pytest.mark.parametrize("rot,dtype", [(10, "float32")])
def test_fused_rope_cached_matches_jax(rot, dtype):
    rng = np.random.RandomState(1)
    t = rng.randn(6, 2, 3, 16).astype(np.float32)
    ang = rng.randn(6, 1, 1, rot).astype(np.float32)   # halves differ
    cos, sin = np.cos(ang), np.sin(ang)
    g = rng.randn(*t.shape).astype(np.float32)
    jout, tout, (jg,), (tg,) = _grads(jrope.fused_rope_cached,
                                      trope.fused_rope_cached,
                                      [t, cos, sin], dtype, g)
    _check(tout, jout, dtype, 1e-6)
    _check(tg, jg, dtype, 1e-6)


@pytest.mark.parametrize("dtype", ["float32"])
def test_fused_rope_thd_matches_jax(dtype):
    rng = np.random.RandomState(2)
    cu = np.array([0, 5, 6, 14], np.int32)
    t = rng.randn(14, 3, 16).astype(np.float32)
    freqs = rng.randn(10, 1, 1, 12).astype(np.float32)
    g = rng.randn(*t.shape).astype(np.float32)
    jout, tout, (jg,), (tg,) = _grads(jrope.fused_rope_thd,
                                      trope.fused_rope_thd,
                                      [t, cu, freqs], dtype, g)
    _check(tout, jout, dtype, 1e-6)
    _check(tg, jg, dtype, 1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_fused_rope_2d_matches_jax(dtype):
    rng = np.random.RandomState(3)
    t = rng.randn(2, 15, 2, 16).astype(np.float32)
    fh = rng.randn(4, 1, 1, 8).astype(np.float32)
    fw = rng.randn(6, 1, 1, 8).astype(np.float32)
    g = rng.randn(*t.shape).astype(np.float32)
    jout, tout, (jg,), (tg,) = _grads(
        lambda a, h, w: jrope.fused_rope_2d(a, 3, 5, h, w),
        lambda a, h, w: trope.fused_rope_2d(a, 3, 5, h, w),
        [t, fh, fw], dtype, g)
    _check(tout, jout, dtype, 1e-6)
    _check(tg, jg, dtype, 1e-6)


def test_fused_rope_and_its_reexports():
    """``fused_rope`` runs ``fused_rope_cached``'s function and backward
    (bitwise, on its angles' cos and sin); the reference's names point at
    the four functions."""
    rng = np.random.RandomState(4)
    t = torch.from_numpy(rng.randn(5, 2, 2, 8).astype(np.float32))
    freqs = torch.from_numpy(rng.randn(5, 1, 1, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(5, 2, 2, 8).astype(np.float32))
    outs = []
    for fn in (lambda a: trope.fused_rope(a, freqs),
               lambda a: trope.fused_rope_cached(a, torch.cos(freqs),
                                                 torch.sin(freqs))):
        a = t.clone().requires_grad_()
        out = fn(a)
        (out * g).sum().backward()
        outs += [out.detach(), a.grad]
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert tfunc.fused_apply_rotary_pos_emb is trope.fused_rope
    assert tfunc.fused_apply_rotary_pos_emb_cached is trope.fused_rope_cached
    assert tfunc.fused_apply_rotary_pos_emb_thd is trope.fused_rope_thd
    assert tfunc.fused_apply_rotary_pos_emb_2d is trope.fused_rope_2d
