"""Vocab-parallel cross entropy of the port (tp=1) against the JAX package.

Numpy-made logits ``[s, b, V]``, integer targets (one of them outside
``[0, V)``, which both packages give a predicted logit of 0) and a
numpy-made cotangent go through ``vocab_parallel_cross_entropy`` in both
packages: the per-token loss, and the logits' gradient through
``jax.vjp`` and torch autograd. f32 and bf16 logits, with and without
label smoothing and z-loss.

Tolerances: the loss is fp32 math in both (atol 1e-5 at magnitudes of
~5); the f32 gradient atol 1e-6; the bf16 gradient (computed in fp32 from
the bf16 softmax residual, rounded once) within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_ce,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

S, B, V = 6, 3, 50


def _inputs(seed):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(S, B, V)).astype(np.float32)
    target = rng.randint(0, V, size=(S, B)).astype(np.int32)
    target[2, 1] = -1                    # outside [0, V): predicted 0
    g = rng.rand(S, B).astype(np.float32)
    return logits, target, g


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grad_match_jax(dtype, smoothing, z_loss):
    logits, target, g = _inputs(0)
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    jloss, vjp = jax.vjp(lambda x: jax_ce(x, jnp.asarray(target), smoothing,
                                          z_loss=z_loss), jl)
    (jgrad,) = vjp(jnp.asarray(g))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tloss = vocab_parallel_cross_entropy(tl, torch.from_numpy(target),
                                         smoothing, z_loss)
    tloss.backward(torch.from_numpy(g))
    assert tloss.dtype == torch.float32
    assert tl.grad.dtype == tl.dtype
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               atol=1e-5, rtol=0)
    want = np.asarray(jgrad.astype(jnp.float32))
    got = tl.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        mag = np.maximum(np.maximum(np.abs(want), np.abs(got)), 2.0 ** -30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= ulp)


def test_target_shape_is_checked():
    with pytest.raises(ValueError, match="target"):
        vocab_parallel_cross_entropy(torch.zeros(4, 2, 10),
                                     torch.zeros(4, dtype=torch.long))
