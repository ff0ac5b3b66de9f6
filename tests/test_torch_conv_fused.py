"""The port's fused 1x1 / 3x3 conv + batch-norm ops against the JAX package.

The same numpy-made inputs (x, w, the input affine a/b, the stats shift c)
and cotangents (dy for y, ds for the stats) go through
``apex_tpu.ops.conv_fused`` run in Pallas interpret mode — the TPU kernels'
own bodies, as ``tests/test_conv_fused.py`` runs them — and through the
port's ``conv1x1_bn_act`` / ``conv3x3_bn_act`` on the CPU (their plain
versions). Forward y and stats, and every gradient (x, a, b, w) with a
nonzero statistics cotangent, over all three ``(affine, relu)``
combinations, in f32 and bf16: a 1x1 with a ragged row count (M = 200)
and a 3x3 over three odd-sized images.

Tolerances, as relative max errors (max |port - jax| over max |jax|):
- f32: 1e-5 everywhere (the same fp32 products, summed in another order);
- bf16 y: one bf16 ulp (both round the fp32 sum once; the sums differ in
  order only); bf16 stats: 1e-5 (fp32 sums of the same products);
- bf16 gradients: 1e-2 — the bf16 y each side saves may differ by one ulp,
  and ``dy_eff = dy + ds0 + 2 (y - c) ds1`` is rounded to bf16 before the
  products, so a few of its elements can land one bf16 step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops._support as jax_support
from apex_tpu.ops import conv_fused as jcf
from apex_tpu_torch.ops import LAUNCHES, reset_launches
from apex_tpu_torch.ops.conv_fused import (
    conv1x1_bn_act,
    conv3x3_bn_act,
    dw_chunks,
)

ACTS = [(False, False), (True, False), (True, True)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "interpret")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _inputs(seed, x_shape, w_shape, affine, dtype):
    rng = np.random.RandomState(seed)
    k, n = w_shape[-2], w_shape[-1]
    fan_in = int(np.prod(w_shape[:-1]))
    x = rng.randn(*x_shape).astype(np.float32)
    w = (rng.randn(*w_shape) * fan_in ** -0.5).astype(np.float32)
    a = (rng.rand(k) + 0.5).astype(np.float32) if affine else None
    b = rng.randn(k).astype(np.float32) if affine else None
    c = (0.1 * rng.randn(n)).astype(np.float32)
    dy = rng.randn(*x_shape[:-1], n).astype(np.float32)
    ds = (0.01 * rng.randn(2, n)).astype(np.float32)
    if dtype == "bfloat16":
        # values on the bf16 grid, so both sides start from the same inputs
        x, w, dy = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                    for t in (x, w, dy))
    return x, w, a, b, c, dy, ds


def _jax(op, x, w, a, b, c, dy, ds, relu, dtype):
    jdt = getattr(jnp, dtype)
    affine = a is not None
    prim = [jnp.asarray(x, jdt), jnp.asarray(w, jdt)]
    if affine:
        prim += [jnp.asarray(a), jnp.asarray(b)]

    def f(*args):
        xa, wa = args[:2]
        ab = args[2:] if affine else (None, None)
        return op(xa, wa, *ab, relu=relu, stats_shift=jnp.asarray(c))

    (y, s), vjp = jax.vjp(f, *prim)
    grads = vjp((jnp.asarray(dy, jdt), jnp.asarray(ds)))
    return [np.asarray(t, np.float32) for t in (y, s, *grads)]


def _torch(op, x, w, a, b, c, dy, ds, relu, dtype):
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x).to(tdt).requires_grad_()
    wt = torch.tensor(w).to(tdt).requires_grad_()
    leaves = [xt, wt]
    at = bt = None
    if a is not None:
        at = torch.tensor(a).requires_grad_()
        bt = torch.tensor(b).requires_grad_()
        leaves += [at, bt]
    y, s = op(xt, wt, at, bt, relu=relu, stats_shift=torch.tensor(c))
    grads = torch.autograd.grad((y, s), leaves,
                                (torch.tensor(dy).to(tdt), torch.tensor(ds)))
    return [t.detach().float().numpy() for t in (y, s, *grads)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check(port, ref, dtype):
    names = ["y", "stats", "dx", "dw", "da", "db"]
    for name, got, want in zip(names, port, ref):
        assert got.shape == want.shape, name
        if dtype == "bfloat16" and name == "y":
            ulp = np.exp2(np.floor(np.log2(np.maximum(
                np.maximum(np.abs(got), np.abs(want)), 2.0 ** -8))) - 7)
            assert float((np.abs(got - want) / ulp).max()) <= 1.0, name
            continue
        tol = 1e-2 if (dtype == "bfloat16" and name not in ("stats",)) \
            else 1e-5
        assert _rel(got, want) <= tol, (name, _rel(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("affine,relu", ACTS)
def test_conv1x1_matches_jax_kernel(interpret, affine, relu, dtype):
    args = _inputs(0, (200, 64), (64, 96), affine, dtype)
    ref = _jax(jcf.conv1x1_bn_act, *args, relu, dtype)
    port = _torch(conv1x1_bn_act, *args, relu, dtype)
    _check(port, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("affine,relu", ACTS)
def test_conv3x3_matches_jax_kernel(interpret, affine, relu, dtype):
    args = _inputs(1, (3, 5, 9, 16), (3, 3, 16, 32), affine, dtype)
    ref = _jax(jcf.conv3x3_bn_act, *args, relu, dtype)
    port = _torch(conv3x3_bn_act, *args, relu, dtype)
    _check(port, ref, dtype)


def test_leading_dims_flatten_like_jax(interpret):
    """A 1x1 over NHWC ``[2, 3, 5, 8]``: the rows are every leading index,
    as ``conv1x1_bn_act`` flattens ``x[..., K]``."""
    args = _inputs(2, (2, 3, 5, 8), (8, 24), True, "float32")
    ref = _jax(jcf.conv1x1_bn_act, *args, True, "float32")
    port = _torch(conv1x1_bn_act, *args, True, "float32")
    assert port[0].shape == (2, 3, 5, 24)
    _check(port, ref, "float32")


def test_halo_is_zero_after_the_affine():
    """With a = 0 and b = 1 every z inside the image is 1 and the padding 0:
    a 3x3 of ones counts each pixel's in-image neighbours (4 at a corner,
    6 on an edge, 9 inside). Padding x and then applying the affine would
    give 9 everywhere."""
    x = torch.randn(1, 4, 5, 2)
    w = torch.ones(3, 3, 2, 1)
    y, _ = conv3x3_bn_act(x, w, torch.zeros(2), torch.ones(2), relu=True)
    counts = torch.tensor([[4, 6, 6, 6, 4], [6, 9, 9, 9, 6], [6, 9, 9, 9, 6],
                           [4, 6, 6, 6, 4]], dtype=torch.float32)
    torch.testing.assert_close(y[0, :, :, 0], 2.0 * counts)


@pytest.mark.parametrize("op", [conv1x1_bn_act, conv3x3_bn_act])
def test_b_or_relu_without_a_raise(op):
    x = torch.zeros(1, 3, 3, 4)
    w = torch.zeros(4, 4) if op is conv1x1_bn_act else torch.zeros(3, 3, 4, 4)
    with pytest.raises(ValueError, match="pass both a and b, or neither"):
        op(x, w, b=torch.zeros(4))
    with pytest.raises(ValueError, match="pass both a and b, or neither"):
        op(x, w, relu=True)
    with pytest.raises(ValueError, match="needs both a and b"):
        op(x, w, torch.ones(4))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    reset_launches()
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    y, s = conv3x3_bn_act(x, torch.randn(3, 3, 8, 8))
    (y.sum() + s.sum()).backward()
    y, s = conv1x1_bn_act(x, torch.randn(8, 8))
    (y.sum() + s.sum()).backward()
    assert all(LAUNCHES[k] == 0 for k in ("conv1x1_fwd", "conv1x1_bwd",
                                          "conv3x3_fwd", "conv3x3_bwd"))


@pytest.mark.parametrize("m,tiles,want", [
    (802816, 4, (132, 6082)),        # ResNet-50 layer1 1x1 (K N = 16k)
    (12544, 256, (3, 4182)),         # layer4 conv1 (K N = 1M)
    (200, 2, (1, 200)),              # fewer rows than one chunk's minimum
    (802816, 9, (59, 13608)),        # layer1 3x3: 9 taps of one tile
])
def test_dw_chunks_follow_m_and_kn(m, tiles, want):
    chunks, rows = dw_chunks(m, tiles)
    assert (chunks, rows) == want
    assert (chunks - 1) * rows < m <= chunks * rows
