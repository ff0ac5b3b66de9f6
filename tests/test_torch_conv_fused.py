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
    conv1x1_bwd_scratch,
    conv1x1_fwd_scratch,
    conv3x3_bn_act,
    conv3x3_bwd_scratch,
    conv3x3_fwd_scratch,
    dw_chunks,
    k_dw_chunks,
    m_dw_chunks,
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


@pytest.mark.parametrize("m,tiles,want", [
    (802816, 1, (176, 4576)),        # ResNet-50 layer1 3x3 (K = N = 64)
    (200704, 4, (44, 4576)),         # layer2 (128)
    (50176, 16, (11, 4576)),         # layer3 (256)
    (12544, 64, (4, 3136)),          # layer4 (512)
    (715, 1, (2, 384)),              # the card tests' ragged case
    (165, 1, (2, 96)),               # fewer pixels than one slice a block
])
def test_m_dw_chunks_are_whole_slices(m, tiles, want):
    """Kernel M's bf16 dW chunks: whole 32-pixel slices of at most 4,608
    pixels, every pixel in exactly one chunk, and a block count (3 x tiles
    a chunk) that fills its last wave of 2 x 132 resident blocks best."""
    chunks, rows = m_dw_chunks(m, tiles)
    assert (chunks, rows) == want
    assert rows % 32 == 0 and 9 * chunks <= 65535
    assert (chunks - 1) * rows < m <= chunks * rows
    assert rows <= 4608 or chunks == 65535 // 9


def test_m_dw_chunks_fill_the_last_wave():
    """At ResNet-50's layers 1-3 the dW blocks are two full waves of 264;
    at layer4 four chunks (768 blocks, 97% of three waves) beat the three
    that 4,608 pixels a chunk would give (576 blocks, 73%)."""
    for m, tiles in ((802816, 1), (200704, 4), (50176, 16)):
        chunks, _ = m_dw_chunks(m, tiles)
        assert chunks * 3 * tiles == 528
    chunks, _ = m_dw_chunks(12544, 64)
    assert chunks * 3 * 64 == 768


@pytest.mark.parametrize("m,k,n,want", [
    (802816, 64, 64, (349, 2304)),     # ResNet-50 layer1 b0 conv1
    (802816, 64, 256, (262, 3072)),    # layer1 conv3
    (200704, 128, 512, (66, 3072)),    # layer2 conv3
    (50176, 256, 1024, (16, 3136)),    # layer3 conv3
    (12544, 2048, 512, (4, 3136)),     # layer4 b1-2 conv1
    (12544, 1024, 2048, (4, 3136)),    # layer4 downsample
    (1000, 20, 36, (2, 512)),          # the card tests' ragged channels
    (4133, 96, 160, (2, 2080)),        # a ragged row count
    (200, 64, 96, (2, 128)),           # fewer rows than one slice a block
])
def test_k_dw_chunks_are_whole_slices(m, k, n, want):
    """Kernel K's bf16 dW chunks: whole 32-row slices of at most 4,608
    rows, every row in exactly one chunk."""
    chunks, rows = k_dw_chunks(m, k, n)
    assert (chunks, rows) == want
    assert rows % 32 == 0 and rows <= 4608
    assert (chunks - 1) * rows < m <= chunks * rows


@pytest.mark.parametrize("m,k,n,tiles,resident,blocks", [
    (802816, 64, 256, 2, 4 * 132, 524),      # layer1 conv3: 64 x 128 tiles
    (12544, 2048, 512, 64, 2 * 132, 256),    # layer4 conv1: 128 x 128
    (12544, 1024, 2048, 128, 2 * 132, 512),  # layer4 downsample
])
def test_k_dw_chunks_fill_the_last_wave(m, k, n, tiles, resident, blocks):
    """At the layer1 conv3, layer4 conv1 and layer4 downsample shapes the
    dW blocks (tiles x chunks) fill at least 97% of their last wave of
    resident blocks; at the downsample four chunks where ``dw_chunks``
    (the f32 path's) gives two."""
    chunks, _ = k_dw_chunks(m, k, n)
    assert chunks * tiles == blocks
    waves = -(-blocks // resident)
    assert blocks / (waves * resident) >= 0.96
    if (k, n) == (1024, 2048):
        assert dw_chunks(m, 16 * 32)[0] == 2


@pytest.mark.parametrize("affine", [True, False])
def test_conv1x1_bwd_scratch_layer1(affine):
    """What Kernel K allocates at ResNet-50's layer1 conv3 shape: in bf16
    the prep pass's dy_eff and (with the affine) z, dW partials per chunk
    and da/db partials per 128-row tile; in f32 ``dw_chunks``'s partials,
    64-row tiles and no prep scratch."""
    m = 256 * 56 * 56
    rows, bf = conv1x1_bwd_scratch(m, 64, 256, affine, torch.bfloat16)
    want = {"dw_partial": ((262, 64, 256), torch.float32),
            "dy_eff": ((m, 256), torch.bfloat16)}
    if affine:
        want["z"] = ((m, 64), torch.bfloat16)
        want["dab_partial"] = ((6272, 2, 64), torch.float32)
    assert (rows, bf) == (3072, want)
    rows, f32 = conv1x1_bwd_scratch(m, 64, 256, affine, torch.float32)
    want = {"dw_partial": ((132, 64, 256), torch.float32)}
    if affine:
        want["dab_partial"] = ((12544, 2, 64), torch.float32)
    assert (rows, f32) == (6082, want)


def test_conv1x1_bwd_scratch_ragged():
    """Ragged rows and channels (the card tests' ``1x1_ragged_channels``):
    the partials cover every row and channel."""
    rows, plan = conv1x1_bwd_scratch(1000, 20, 36, True, torch.bfloat16)
    assert rows == 512
    assert plan == {"dw_partial": ((2, 20, 36), torch.float32),
                    "dab_partial": ((8, 2, 20), torch.float32),
                    "dy_eff": ((1000, 36), torch.bfloat16),
                    "z": ((1000, 20), torch.bfloat16)}


@pytest.mark.parametrize("affine", [True, False])
def test_conv3x3_bwd_scratch_layer1(affine):
    """What Kernel M allocates at ResNet-50's layer1 3x3: in bf16 the
    prep pass's dy_eff and z, dW partials per (chunk, tap) and da/db
    partials per 128-pixel tile; in f32 K's chunking and 64-pixel tiles,
    and no prep scratch."""
    m = 256 * 56 * 56
    rows, bf = conv3x3_bwd_scratch(256, 56, 56, 64, 64, affine,
                                   torch.bfloat16)
    want = {"dw_partial": ((176, 9, 64, 64), torch.float32),
            "dy_eff": ((m, 64), torch.bfloat16)}
    if affine:
        want["z"] = ((m, 64), torch.bfloat16)
        want["dab_partial"] = ((6272, 2, 64), torch.float32)
    assert (rows, bf) == (4576, want)
    rows, f32 = conv3x3_bwd_scratch(256, 56, 56, 64, 64, affine,
                                    torch.float32)
    want = {"dw_partial": ((59, 9, 64, 64), torch.float32)}
    if affine:
        want["dab_partial"] = ((12544, 2, 64), torch.float32)
    assert (rows, f32) == (13608, want)


def test_conv3x3_bwd_scratch_ragged():
    """Ragged pixels and channels (the card tests' ``3x3_ragged``): the
    partials cover every pixel and channel."""
    rows, plan = conv3x3_bwd_scratch(5, 13, 11, 20, 36, True, torch.bfloat16)
    assert rows == 384
    assert plan == {"dw_partial": ((2, 9, 20, 36), torch.float32),
                    "dab_partial": ((6, 2, 20), torch.float32),
                    "dy_eff": ((715, 36), torch.bfloat16),
                    "z": ((715, 20), torch.bfloat16)}


@pytest.mark.parametrize("affine", [True, False])
def test_conv3x3_fwd_scratch_layer1(affine):
    """What Kernel L allocates at ResNet-50's layer1 3x3: in bf16 the
    stats partials per 128-pixel tile and, with the affine, the prep
    pass's z; in f32 partials per 64-pixel tile and no z."""
    m = 256 * 56 * 56
    want = {"partial": ((6272, 2, 64), torch.float32)}
    if affine:
        want["z"] = ((m, 64), torch.bfloat16)
    assert conv3x3_fwd_scratch(256, 56, 56, 64, 64, affine,
                               torch.bfloat16) == want
    assert conv3x3_fwd_scratch(256, 56, 56, 64, 64, affine,
                               torch.float32) == {
        "partial": ((12544, 2, 64), torch.float32)}


@pytest.mark.parametrize("affine", [True, False])
def test_conv3x3_fwd_scratch_ragged(affine):
    """Ragged pixels and channels (the card tests' ``3x3_ragged``): the
    partial rows cover the last, part-filled pixel tile."""
    want = {"partial": ((6, 2, 36), torch.float32)}
    if affine:
        want["z"] = ((715, 20), torch.bfloat16)
    assert conv3x3_fwd_scratch(5, 13, 11, 20, 36, affine,
                               torch.bfloat16) == want
    assert conv3x3_fwd_scratch(5, 13, 11, 20, 36, affine,
                               torch.float32) == {
        "partial": ((12, 2, 36), torch.float32)}


@pytest.mark.parametrize("layer,n_img,hw,c,rows", [
    ("layer2", 256, 28, 128, 3136),
    ("layer3", 256, 14, 256, 784),
    ("layer4", 256, 7, 512, 196),
])
def test_conv3x3_fwd_scratch_wide(layer, n_img, hw, c, rows):
    """From N' = 128 on (ResNet-50's layers 2-4) Kernel L's bf16 GEMM tiles
    64 pixels x 128 channels: a partial row per 64 pixels."""
    plan = conv3x3_fwd_scratch(n_img, hw, hw, c, c, True, torch.bfloat16)
    assert plan == {"partial": ((rows, 2, c), torch.float32),
                    "z": ((n_img * hw * hw, c), torch.bfloat16)}


#: (name, rows M, K, N, affine + relu, Kernel J's bf16 tile rows) of the 16
#: distinct 1x1 convs of a ResNet-50 step at batch 256 (the shapes of
#: ``apex_tpu_torch/tools/conv_timing.py`` ``K_SHAPES``)
J_SHAPES = [
    ("layer1_b0_conv1", 802816, 64, 64, False, 128),
    ("layer1_conv1", 802816, 256, 64, False, 128),
    ("layer1_conv3", 802816, 64, 256, True, 64),
    ("layer1_down", 802816, 64, 256, False, 64),
    ("layer2_b0_conv1", 802816, 256, 128, False, 64),
    ("layer2_conv1", 200704, 512, 128, False, 64),
    ("layer2_conv3", 200704, 128, 512, True, 64),
    ("layer2_down", 200704, 256, 512, False, 64),
    ("layer3_b0_conv1", 200704, 512, 256, False, 64),
    ("layer3_conv1", 50176, 1024, 256, False, 64),
    ("layer3_conv3", 50176, 256, 1024, True, 64),
    ("layer3_down", 50176, 512, 1024, False, 64),
    ("layer4_b0_conv1", 50176, 1024, 512, False, 64),
    ("layer4_conv1", 12544, 2048, 512, False, 64),
    ("layer4_conv3", 12544, 512, 2048, True, 64),
    ("layer4_down", 12544, 1024, 2048, False, 64),
]


@pytest.mark.parametrize("name,m,k,n,affine,rows", J_SHAPES,
                         ids=[s[0] for s in J_SHAPES])
def test_conv1x1_fwd_scratch_resnet50(name, m, k, n, affine, rows):
    """What Kernel J allocates at each 1x1 shape of a ResNet-50 step: in
    bf16 L's tiles at one tap (128 rows x 64 channels, 64 x 128 from N =
    128 on), a stats partial row per row tile and one per 512 of those
    (their chunk sums), and the prep pass's z only with the affine
    (conv3); in f32 a partial row per 64 rows, no z."""
    tiles = -(-m // rows)
    want = {"partial": ((tiles + -(-tiles // 512), 2, n), torch.float32)}
    if affine:
        want["z"] = ((m, k), torch.bfloat16)
    assert conv1x1_fwd_scratch(m, k, n, affine, torch.bfloat16) == want
    assert conv1x1_fwd_scratch(m, k, n, affine, torch.float32) == {
        "partial": ((m // 64, 2, n), torch.float32)}


@pytest.mark.parametrize("affine", [True, False])
def test_conv1x1_fwd_scratch_ragged(affine):
    """Ragged rows and channels (the card tests' ``1x1_ragged_channels``,
    ``1x1_tail``, ``1x1_ragged`` and ``1x1_n1024``): the partial rows cover
    the last, part-filled row tile, and the chunk sums follow them."""
    want = {"partial": ((8 + 1, 2, 36), torch.float32)}
    if affine:
        want["z"] = ((1000, 20), torch.bfloat16)
    assert conv1x1_fwd_scratch(1000, 20, 36, affine, torch.bfloat16) == want
    assert conv1x1_fwd_scratch(1000, 20, 36, affine, torch.float32) == {
        "partial": ((16, 2, 36), torch.float32)}
    assert conv1x1_fwd_scratch(200, 64, 96, affine, torch.bfloat16)[
        "partial"] == ((2 + 1, 2, 96), torch.float32)
    assert conv1x1_fwd_scratch(4133, 96, 160, affine, torch.bfloat16)[
        "partial"] == ((65 + 1, 2, 160), torch.float32)
    assert conv1x1_fwd_scratch(1000, 256, 1024, affine, torch.bfloat16)[
        "partial"] == ((16 + 1, 2, 1024), torch.float32)
