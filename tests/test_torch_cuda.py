"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a CUDA
device; run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

They reach the corners the smoke test (``chip_smoke.py``) does not:
RMSNorm and non-affine LayerNorm forward and backward at widths that are
not a multiple of 32 and row counts over several backward blocks, their
16-byte paths at GPT-2's width in bf16 over fp32 weights (8193 rows, one
row, RMSNorm, rows of 96 two to a warp; two runs bitwise equal), flash
attention with ``kv_lengths`` (one of them 0), ``sq != sk``, GQA, sliding
windows and head_dim 32/36/128, the packed-QKV forward and backward with
GQA, partial and full RoPE, windows, ``kv_lengths`` and dropout (whose
keep mask is read off exactly with ``v = I``, in f32 and bf16, and whose
seed may stay on the card with no host sync), at lengths around the bf16
forward's 64-row tiles (63-65, 127-129), head_dim 36 and 40, a window and
``kv_lengths`` that end inside a tile, T5-like encoder and decoder shapes,
with two bf16 forward runs bitwise equal, paged decode on both of its
paths with GQA (two head chunks at a group of 12), head_dim 128, a sliding
window, a slot at 0 and one at its table's last row, a sentinel inside a
slot's range, and repeated calls bitwise equal, and with w = 2 and 4 query
windows (rows past the table dropped) over bf16/f32 and int8 pools (int8
appends repeated bitwise), the masked softmax forward
and backward (padding masks with fully masked rows read through their
broadcast strides, key masks, causal, rows of 17 to 4097, a scale), and
the 4D flash backward (cross-attention with ``kv_lengths``, a 0 length,
causal with the ``sk - sq`` offset, GQA, windows; bitwise repeatable), and
the fused 1x1 and 3x3 conv + batch-norm kernels forward and backward
(every ``(affine, relu)`` combination, row and channel counts off the
64-wide tiles, images of 1 x 1 to 14 x 14, a stats cotangent; bitwise
repeatable), and the multi-tensor kernels (amp's unscale, the L2 norms,
Adam, LAMB and SGD) over lists with a 1-element tensor, one of ``CHUNK +
1``, an empty one, more tensors and chunks than a launch record holds,
mixed dtypes, per-tensor step counts, ``grad_scale``, a device ``lr`` and
a ``found_inf`` step (scale, Adam, SGD bitwise their plain versions; the
norms 1e-6 relative, LAMB rtol 1e-5), and the optimizers taking them on
CUDA parameters. Kernels A, D, E and F also run in fp16: the LayerNorm
tests and the packed cases above in fp16, the 16-byte LayerNorm paths
with fp16, fp32 or no weight into fp16 or fp32 y (bitwise repeatable),
and the wrappers of B, C, G, H, I and J refusing fp16 before any launch.
Tolerances: f32 atol 1e-4 (summation order only, TF32 off; the softmax
1e-5); bf16 and fp16 1 ulp of an fp32 reference rounded to that type (the
flash backwards, which round ds and p to it where the JAX kernels do: 1
ulp plus one step of each rounded factor, at most 0.1% of the elements
past 1 ulp in bf16 and 0.8% in fp16, whose 2^3 times finer spacing puts
2^3 times as many ds on a rounding boundary); the conv kernels' fp32 sums
(y and dx in f32, stats, dW, da, db) norm-wise 1e-5.
"""

import math

import pytest
import torch

from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.attention import (
    drop_combo,
    flash_attention,
    flash_attention_packed,
    flash_bwd_cuda,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_fwd_cuda,
    flash_fwd_plain,
    flash_packed_bwd_cuda,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_cuda,
    flash_packed_fwd_plain,
    hash_keep,
)
from apex_tpu_torch.ops.conv_fused import (
    conv1x1_bn_act,
    conv1x1_bwd_cuda,
    conv1x1_bwd_plain,
    conv1x1_fwd_cuda,
    conv1x1_fwd_plain,
    conv3x3_bn_act,
    conv3x3_bwd_cuda,
    conv3x3_bwd_plain,
    conv3x3_fwd_cuda,
    conv3x3_fwd_plain,
)
from apex_tpu_torch.ops.decode_attention import (
    _quant_append,
    append_rows,
    decode_plain,
    page_pool,
    paged_decode_cuda,
    paged_decode_cuda_plan,
    scale_pool,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_bwd_cuda,
    layer_norm_bwd_cuda_plan,
    layer_norm_bwd_plain,
    layer_norm_fwd_cuda,
    layer_norm_fwd_cuda_plan,
    layer_norm_fwd_plain,
)
from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    softmax_bwd_cuda,
    softmax_bwd_plain,
    softmax_fwd_cuda,
    softmax_fwd_plain,
)

pytestmark = pytest.mark.cuda


def one_ulp(want, dtype):
    """One rounding step of ``dtype`` at ``want`` (fp32): eps of the
    magnitude (2^-7 in bf16, 2^-10 in fp16), with an absolute floor at the
    magnitude 2^-8 where an output that cancels to near zero carries fp32
    summation noise larger than its own ulp."""
    eps = torch.finfo(dtype).eps
    return 2.0 ** -8 * eps + eps * want.float().abs()


def assert_close_once_rounded(got, want):
    """``want`` is the plain version run on the inputs cast to fp32 and
    rounded to ``got``'s dtype. The kernels also compute in fp32 and round
    once, so f32 differs by summation order only (atol 1e-4) and bf16 or
    fp16 by at most one rounding step: 1 ulp, i.e. 2^-7 (bf16) or 2^-10
    (fp16) of the magnitude, with an absolute floor of 2^-15 or 2^-18
    where the output is near zero. Non-finite values (an fp16 overflow)
    must sit at the same elements."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        eps = torch.finfo(got.dtype).eps
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got.float()[fin], want.float()[fin],
                                   atol=2.0 ** -8 * eps, rtol=eps)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("is_rms,affine,bias", [
    (False, True, True), (False, False, False), (True, True, False),
    (True, False, False)])
@pytest.mark.parametrize("rows,h", [(300, 96), (5, 1000), (1, 4096)])
def test_layer_norm_kernel(gen, rows, h, is_rms, affine, bias, dtype):
    x = (torch.randn(rows, h, device="cuda", generator=gen) + 0.3).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)) \
        if affine else None
    b = 0.1 * torch.randn(h, device="cuda", generator=gen) if bias else None
    before = _support.LAUNCHES["layer_norm_fwd"]
    y, mean, iv = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, torch.float32)
    assert _support.LAUNCHES["layer_norm_fwd"] == before + 1
    ry, rmean, riv = layer_norm_fwd_plain(x, w, b, 1e-5, is_rms,
                                          torch.float32)
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=0)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=0)
    torch.testing.assert_close(iv, riv, atol=1e-4, rtol=1e-5)


FLASH = {
    # (b, h, kvh, sq, sk, d, causal, kv_lengths, window)
    "varlen_with_empty_row": (3, 4, 4, 100, 100, 64, False, [100, 37, 0],
                              None),
    "causal_varlen_gqa": (2, 8, 2, 130, 130, 64, True, [90, 130], None),
    "sq_lt_sk": (2, 4, 4, 40, 200, 64, True, None, None),
    "sq_gt_sk_causal": (1, 4, 4, 96, 64, 64, True, None, None),
    "window": (1, 4, 2, 300, 300, 64, True, None, 50),
    "window_sq_lt_sk": (1, 4, 4, 70, 333, 64, True, [300], 33),
    "head_dim_32": (1, 4, 1, 65, 65, 32, False, None, None),
    "head_dim_128": (2, 4, 4, 129, 129, 128, True, None, None),
    # bf16 copies element by element (d % 8 != 0), GQA, a length
    "head_dim_36_gqa": (2, 4, 2, 77, 100, 36, True, [100, 61], None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FLASH))
def test_flash_kernel(gen, name, dtype):
    b, h, kvh, sq, sk, d, causal, kvl, window = FLASH[name]
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(dtype)
    kvl = None if kvl is None else torch.tensor(kvl, device="cuda")
    scale = 1.0 / math.sqrt(d)
    o, lse = flash_fwd_cuda(q, k, v, kvl, scale, causal, window)
    ref = flash_fwd_plain(q.float(), k.float(), v.float(), kvl, scale,
                          causal, window)[0].to(dtype)
    assert_close_once_rounded(o, ref)
    if kvl is not None and int(kvl.min()) == 0:
        row = int(torch.argmin(kvl))
        assert not o[row].any() and bool((lse[row] == 1e30).all())


PAGED = {
    # (b, heads, group, head_dim, window); slot r at PAGED_POSITIONS[r]
    "mha": (6, 12, 1, 64, None),
    "gqa4": (6, 12, 4, 64, None),
    "gqa3_window": (6, 12, 3, 64, 20),
    "mqa_window_two_chunks": (6, 12, 12, 64, 70),
    "one_slot_at_table_end": (1, 12, 1, 64, None),
    "head_dim_128_gqa4": (6, 16, 4, 128, None),
    "head_dim_60_element_path": (6, 12, 4, 60, None),
}
#: a slot at 0, at a page's last and next row, inside the table, at its
#: last row (127 = 8 pages of 16), and one with a sentinel inside its range
PAGED_POSITIONS = (127, 15, 16, 77, 0, 40)


def _paged_case(gen, b, hl, group, dh, dtype):
    ps, pps, n_pages = 16, 8, 40
    f = hl // group * dh
    positions = torch.tensor(PAGED_POSITIONS[:b], dtype=torch.int32)
    table = torch.full((b, pps), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for r in range(b):
        need = min(pps, int(positions[r]) // ps + 1)
        table[r, :need] = perm[used:used + need]
        used += need
    if b > 5:
        table[5, 1] = n_pages      # a sentinel inside the slot's range
    kp = page_pool(n_pages, ps, f, dtype, "cuda")
    vp = page_pool(n_pages, ps, f, dtype, "cuda")
    kp.copy_(torch.randn(kp.shape, device="cuda", generator=gen))
    vp.copy_(torch.randn(vp.shape, device="cuda", generator=gen))
    q = torch.randn(b, hl, dh, device="cuda", generator=gen).to(dtype)
    rows = torch.randn(2, b, f, device="cuda", generator=gen).to(dtype)
    pt, pos = table.cuda(), positions.cuda()
    append_rows(kp, rows[0], pt, pos, ps)
    append_rows(vp, rows[1], pt, pos, ps)
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PAGED))
def test_paged_decode_kernel(gen, name, dtype):
    b, hl, group, dh, window = PAGED[name]
    q, kp, vp, pt, pos = _paged_case(gen, b, hl, group, dh, dtype)
    plan = paged_decode_cuda_plan(q, kp, vp, pt, group, window)
    vector = dtype == torch.float32 or dh % 8 == 0
    assert plan.path == ("vector" if vector else "element")
    before = _support.LAUNCHES["paged_decode"]
    ctx = paged_decode_cuda(q, kp, vp, pt, pos, group, window)
    assert _support.LAUNCHES["paged_decode"] == before + 1
    ref = decode_plain(q.float(), kp.float(), vp.float(), pt, pos, group,
                       window).to(dtype)
    assert_close_once_rounded(ctx, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mha", "gqa3_window", "head_dim_128_gqa4"])
def test_paged_decode_kernel_bitwise_repeatable(gen, name, dtype):
    """The splits merge in a fixed order whatever block ends last, and the
    counters are left at zero: repeated calls give the same bits."""
    b, hl, group, dh, window = PAGED[name]
    q, kp, vp, pt, pos = _paged_case(gen, b, hl, group, dh, dtype)
    assert paged_decode_cuda_plan(q, kp, vp, pt, group, window).splits > 1
    first = paged_decode_cuda(q, kp, vp, pt, pos, group, window)
    for _ in range(3):
        assert torch.equal(paged_decode_cuda(q, kp, vp, pt, pos, group,
                                             window), first)


def _paged_window_case(gen, name, dtype, w, int8):
    """``_paged_case`` with a ``w``-row window of new rows appended
    (rows past a slot's table dropped) and, for ``int8``, int8 pools with
    random scales that the append rescales. Returns q ``[b, w, heads,
    head_dim]``, the pools, table, positions and scales (or Nones)."""
    b, hl, group, dh, window = PAGED[name]
    q, kp, vp, pt, pos = _paged_case(gen, b, hl, group, dh, dtype)
    n_pages, ps, f = kp.shape
    q = torch.randn(b, w, hl, dh, device="cuda", generator=gen).to(dtype)
    rows = torch.randn(2, b, w, f, device="cuda", generator=gen).to(dtype)
    ks = vs = None
    if int8:
        kvh = f // dh
        pools = []
        for _ in range(2):
            pool = page_pool(n_pages, ps, f, torch.int8, "cuda")
            pool.copy_(torch.randint(-127, 128, pool.shape, device="cuda",
                                     generator=gen))
            sc = scale_pool(n_pages, kvh, "cuda")
            # scales of pages of O(1) values, as the appends make them
            # (absmax / 127)
            sc.copy_(torch.rand(sc.shape, device="cuda", generator=gen)
                     * (4 / 127))
            pools.append((pool, sc))
        (kp, ks), (vp, vs) = pools
        _quant_append(kp, ks, rows[0], pt, pos, ps)
        _quant_append(vp, vs, rows[1], pt, pos, ps)
    else:
        append_rows(kp, rows[0], pt, pos, ps)
        append_rows(vp, rows[1], pt, pos, ps)
    return q, kp, vp, pt, pos, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("name", ["mha", "gqa4", "gqa3_window",
                                  "head_dim_60_element_path"])
def test_paged_decode_kernel_windows_and_int8(gen, name, w, int8, dtype):
    """Windows fold in as more query rows (row t masked to pos + t); int8
    pools are dequantized as int8 * scale in fp32. Held to the plain
    version run in f32 and rounded once; the vector path takes bf16 q over
    int8 pools, the element path f32 q over them and bf16 head_dim 60."""
    b, hl, group, dh, window = PAGED[name]
    q, kp, vp, pt, pos, ks, vs = _paged_window_case(gen, name, dtype, w,
                                                    int8)
    plan = paged_decode_cuda_plan(q, kp, vp, pt, group, window)
    vector = (dh % 4 == 0 and not int8) if dtype == torch.float32 \
        else dh % 8 == 0
    assert plan.path == ("vector" if vector else "element")
    before = _support.LAUNCHES["paged_decode"]
    ctx = paged_decode_cuda(q, kp, vp, pt, pos, group, window, ks, vs)
    assert _support.LAUNCHES["paged_decode"] == before + 1
    assert ctx.shape == (b, w, hl * dh)
    ref = decode_plain(q.float(), kp if int8 else kp.float(),
                       vp if int8 else vp.float(), pt, pos, group, window,
                       ks, vs).to(dtype)
    assert_close_once_rounded(ctx, ref)
    for _ in range(2):
        assert torch.equal(paged_decode_cuda(q, kp, vp, pt, pos, group,
                                             window, ks, vs), ctx)


def test_paged_int8_append_is_bitwise_repeatable(gen):
    """The rescale-on-append writes identical values to duplicate
    destinations, so two runs of the same append give the same pools and
    scales."""
    outs = []
    for _ in range(2):
        g = torch.Generator(device="cuda").manual_seed(5)
        _, kp, _, _, _, ks, _ = _paged_window_case(g, "gqa4",
                                                   torch.bfloat16, 4, True)
        outs.append((kp.clone(), ks.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("is_rms,affine,bias", [
    (False, True, True), (False, False, False), (True, True, False),
    (True, False, False)])
@pytest.mark.parametrize("rows,h", [(300, 96), (5, 1000), (70, 4096)])
def test_layer_norm_bwd_kernel(gen, rows, h, is_rms, affine, bias, dtype):
    x = (torch.randn(rows, h, device="cuda", generator=gen) + 0.3).to(dtype)
    dy = torch.randn(rows, h, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)) \
        if affine else None
    _, mean, iv = layer_norm_fwd_plain(x, w, None, 1e-5, is_rms,
                                       torch.float32)
    before = _support.LAUNCHES["layer_norm_bwd"]
    dx, dw, db = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms, bias)
    assert _support.LAUNCHES["layer_norm_bwd"] == before + 1
    rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean, iv, w,
                                         is_rms, bias)
    assert_close_once_rounded(dx, rdx.to(dtype))
    if affine:
        # fp32 sums over the rows in another order
        torch.testing.assert_close(dw, rdw, atol=1e-4, rtol=1e-5)
        if bias:
            torch.testing.assert_close(db, rdb, atol=1e-4, rtol=1e-5)
        else:
            assert db is None


#: (rows, h, is_rms, bias) of the training block's norms in bf16 over fp32
#: parameters, on the 16-byte kernels: a row past a whole grid, one row,
#: RMSNorm (the T5 decoder's rows), rows of 96 two to a warp
LN_VECTOR = {
    "ln_8193": (8193, 768, False, True),
    "ln_1": (1, 768, False, True),
    "rms_8193": (8193, 768, True, False),
    "rms_1824": (1824, 768, True, False),
    "ln_h96": (300, 96, False, True),
}


def _ln_vector_inputs(gen, name):
    rows, h, is_rms, bias = LN_VECTOR[name]
    x = (2 * torch.randn(rows, h, device="cuda", generator=gen) + 0.5) \
        .bfloat16()
    dy = torch.randn(rows, h, device="cuda", generator=gen).bfloat16()
    w = 1 + 0.1 * torch.randn(h, device="cuda", generator=gen)
    b = 0.1 * torch.randn(h, device="cuda", generator=gen) if bias else None
    return x, dy, w, b, is_rms


@pytest.mark.parametrize("name", list(LN_VECTOR))
def test_layer_norm_vector_paths(gen, name):
    """Kernels A and D on their 16-byte paths: y and dx within 1 bf16 ulp
    of the plain versions run in fp32, mean and invvar within 1e-4, dw and
    db within 1e-4 of 1 + |value| (fp32 sums in another order)."""
    x, dy, w, b, is_rms = _ln_vector_inputs(gen, name)
    y, mean, iv = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, torch.bfloat16)
    assert layer_norm_fwd_cuda_plan(x, y, w, b).path == "vector"
    ry, rmean, riv = layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                          torch.float32)
    assert_close_once_rounded(y, ry.bfloat16())
    torch.testing.assert_close(mean, rmean, atol=1e-4, rtol=0)
    torch.testing.assert_close(iv, riv, atol=1e-4, rtol=0)
    dx, dw, db = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms,
                                     b is not None)
    assert layer_norm_bwd_cuda_plan(dy, x, dx, w, b is not None).path == \
        "vector"
    rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean, iv, w,
                                         is_rms, b is not None)
    assert_close_once_rounded(dx, rdx.bfloat16())
    for got, want in ((dw, rdw), (db, rdb)):
        if want is None:
            assert got is None
        else:
            assert float(((got - want).abs() / (1 + want.abs())).max()) \
                <= 1e-4


#: fp16 rows on the 16-byte kernels: (rows, h, is_rms, bias, w dtype or
#: None, y dtype): amp O2's fp16 weights, O1's fp32 ones (y promoted to
#: fp32, or kept in fp16), no weight; GPT-2's rows, a row past a grid,
#: rows of 96 two to a warp and the T5 decoder's RMSNorm rows
LN_FP16 = {
    "o2_ln_8192": (8192, 768, False, True, torch.float16, torch.float16),
    "o1_ln_8193": (8193, 768, False, True, torch.float32, torch.float32),
    "o1_ln_out16": (300, 768, False, True, torch.float32, torch.float16),
    "o2_rms_1824": (1824, 768, True, False, torch.float16, torch.float16),
    "no_w_h96": (300, 96, False, False, None, torch.float16),
    "rms_no_w_1": (1, 1000, True, False, None, torch.float16),
}


@pytest.mark.parametrize("name", list(LN_FP16))
def test_layer_norm_fp16_vector_paths(gen, name):
    """Kernels A and D on their 16-byte paths in fp16: y and dx within 1
    fp16 ulp of the plain versions run in fp32, mean and invvar within
    1e-4, dw and db within 1e-4 of 1 + |value| (fp32 sums in another
    order), two runs bitwise equal."""
    rows, h, is_rms, bias, wdt, ydt = LN_FP16[name]
    x = (2 * torch.randn(rows, h, device="cuda", generator=gen) + 0.5) \
        .half()
    dy = torch.randn(rows, h, device="cuda", generator=gen).to(ydt)
    w = b = None
    if wdt is not None:
        w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(wdt)
        if bias:
            b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(wdt)
    y, mean, iv = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, ydt)
    assert layer_norm_fwd_cuda_plan(x, y, w, b).path == "vector"
    ry, rmean, riv = layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                          torch.float32)
    assert_close_once_rounded(y, ry.to(ydt))
    torch.testing.assert_close(mean, rmean, atol=1e-4, rtol=0)
    torch.testing.assert_close(iv, riv, atol=1e-4, rtol=0)
    dy16 = dy.half()
    dx, dw, db = layer_norm_bwd_cuda(dy16, x, mean, iv, w, is_rms,
                                     b is not None)
    assert layer_norm_bwd_cuda_plan(dy16, x, dx, w, b is not None).path == \
        "vector"
    rdx, rdw, rdb = layer_norm_bwd_plain(dy16.float(), x.float(), mean, iv,
                                         w, is_rms, b is not None)
    assert_close_once_rounded(dx, rdx.half())
    for got, want in ((dw, rdw), (db, rdb)):
        if want is None:
            assert got is None
        else:
            assert float(((got - want).abs() / (1 + want.abs())).max()) \
                <= 1e-4
    again = (*layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, ydt),
             *layer_norm_bwd_cuda(dy16, x, mean, iv, w, is_rms,
                                  b is not None))
    for one, two in zip((y, mean, iv, dx, dw, db), again):
        assert (one is None and two is None) or torch.equal(one, two)


def test_fp16_reaches_no_kernel_without_an_fp16_path(gen):
    """Kernels B, C, G and J-M have no fp16 path yet: their wrappers raise
    TypeError on fp16 card tensors before any launch."""
    q = torch.randn(1, 2, 64, 64, device="cuda", generator=gen).half()
    before = dict(_support.LAUNCHES)
    with pytest.raises(TypeError, match="float16"):
        flash_fwd_cuda(q, q, q, None, 0.125, True)
    with pytest.raises(TypeError, match="float16"):
        flash_bwd_cuda(q, q, q, q, q, torch.zeros(1, 2, 64, device="cuda"),
                       None, 0.125, True)
    pages = torch.zeros(4, 16, 128, device="cuda").half()
    with pytest.raises(TypeError, match="float16"):
        paged_decode_cuda(q[:, :, 0], pages, pages,
                          torch.zeros(1, 2, dtype=torch.int32, device="cuda"),
                          torch.zeros(1, dtype=torch.int32, device="cuda"), 1,
                          None)
    with pytest.raises(TypeError, match="float16"):
        softmax_fwd_cuda(q, None, 1.0, 64, True)
    with pytest.raises(TypeError, match="float16"):
        softmax_bwd_cuda(q, q, 1.0)
    x = torch.randn(64, 32, device="cuda", generator=gen).half()
    with pytest.raises(TypeError, match="float16"):
        conv1x1_fwd_cuda(x, None, None, x[:32], None, False, False)
    assert _support.LAUNCHES == before


@pytest.mark.parametrize("name", ["ln_8193", "rms_8193", "ln_h96"])
def test_layer_norm_vector_paths_are_bitwise_repeatable(gen, name):
    """Two runs of each 16-byte kernel give the same bits: D's dw/db sums
    take a fixed order (the grid from the occupancy, rows split
    statically, no atomics)."""
    x, dy, w, b, is_rms = _ln_vector_inputs(gen, name)
    y1 = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, torch.bfloat16)
    y2 = layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, torch.bfloat16)
    _, mean, iv = y1
    g1 = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms, b is not None)
    g2 = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms, b is not None)
    for one, two in zip((*y1, *g1), (*y2, *g2)):
        assert (one is None and two is None) or torch.equal(one, two)


PACKED = {
    # (b, s, groups, qpg, d, causal, kv_lengths, window, rot, rate)
    "causal_mha": (2, 200, 3, 1, 64, True, None, None, 0, 0.0),
    "gqa_qpg2": (2, 130, 2, 2, 64, True, None, None, 0, 0.0),
    "rope_half": (1, 100, 2, 1, 64, True, None, None, 32, 0.0),
    "window": (1, 300, 2, 1, 64, True, None, 50, 0, 0.0),
    "kv_lengths_with_zero": (3, 90, 2, 1, 64, False, [90, 37, 0], None, 0,
                             0.0),
    "dropout": (2, 80, 2, 1, 64, True, None, None, 0, 0.1),
    "d128_gqa_rope_varlen_dropout": (1, 129, 2, 3, 128, True, [100], None,
                                     128, 0.2),
    "d32_rope": (1, 65, 1, 4, 32, False, None, None, 16, 0.0),
    # the edges of the bf16 kernel's 64-row query and 64-key tiles
    "s63_causal": (2, 63, 2, 1, 64, True, None, None, 0, 0.0),
    "s64": (1, 64, 2, 1, 64, False, None, None, 0, 0.0),
    "s65_causal_gqa": (2, 65, 2, 2, 64, True, None, None, 0, 0.0),
    "s127_causal_rope": (1, 127, 2, 1, 64, True, None, None, 64, 0.0),
    "s128_dropout": (1, 128, 2, 1, 64, True, None, None, 0, 0.1),
    "s129_causal": (2, 129, 3, 1, 64, True, None, None, 0, 0.0),
    # d 40: 16-byte copies, the last k-step of Q K^T half zero; d 36:
    # element-by-element copies
    "d40_causal": (2, 100, 2, 1, 40, True, None, None, 0, 0.0),
    "d36_rope_varlen": (2, 90, 2, 1, 36, False, [90, 41], None, 20, 0.0),
    "window_70": (1, 300, 2, 1, 64, True, None, 70, 0, 0.0),
    "kv_lengths_in_tile": (3, 200, 2, 1, 64, False, [200, 100, 33], None,
                           0, 0.0),
    "kv_lengths_causal_dropout": (2, 200, 2, 1, 64, True, [150, 70], None,
                                  0, 0.2),
    # T5-like: a padded encoder (not causal) and the s 114 decoder
    "t5_encoder": (4, 160, 2, 1, 64, False, [160, 97, 130, 81], None, 0,
                   0.0),
    "t5_decoder": (2, 114, 3, 1, 64, True, None, None, 0, 0.0),
    # every feature across several of the backward's 64-key blocks
    "s257_gqa_window_rope_dropout": (2, 257, 2, 2, 64, True, None, 100, 64,
                                     0.1),
}


def _packed_inputs(gen, case, dtype):
    b, s, g, qpg, d, causal, kvl, window, rot, rate = case
    qkv = torch.randn(s, b, g * (qpg + 2) * d, device="cuda",
                      generator=gen).to(dtype)
    do = torch.randn(s, b, g * qpg * d, device="cuda",
                     generator=gen).to(dtype)
    kvl = None if kvl is None else torch.tensor(kvl, device="cuda")
    rope = None
    if rot:
        rope = rope_tables(rope_freqs(0, s, rot, 10000.0, device="cuda"),
                           s, d)
    return qkv, do, kvl, rope, -12345 if rate else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", list(PACKED))
def test_flash_packed_kernels(gen, name, dtype):
    case = PACKED[name]
    b, s, g, qpg, d, causal, _, window, _, rate = case
    qkv, do, kvl, rope, seed = _packed_inputs(gen, case, dtype)
    args = (kvl, rope, seed, rate, 1.0 / math.sqrt(d), causal, window, qpg,
            d)
    before = dict(_support.LAUNCHES)
    o, lse = flash_packed_fwd_cuda(qkv, *args)
    # the plain version computes in fp32 past the RoPE rounding (part of
    # the function) and rounds once at the end
    ro, rlse = flash_packed_fwd_plain(qkv, *args)
    assert_close_once_rounded(o, ro)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-6)
    dqkv = flash_packed_bwd_cuda(qkv, do, ro, rlse, *args)
    # the plain backward rounds ds and the dropped p to qkv's dtype where
    # the JAX kernel does, as the bf16 kernel does
    rdqkv = flash_packed_bwd_plain(qkv, do, ro, rlse, *args)
    if dtype == torch.float32:
        assert_close_once_rounded(dqkv, rdqkv)
    else:
        assert_close_up_to_factor_rounding(
            dqkv, rdqkv,
            flash_packed_bwd_rounding_slack(qkv, do, ro, rlse, *args))
    assert _support.LAUNCHES["flash_packed_fwd"] == \
        before["flash_packed_fwd"] + 1
    assert _support.LAUNCHES["flash_packed_bwd"] == \
        before["flash_packed_bwd"] + 1
    if kvl is not None and int(kvl.min()) == 0:
        row = int(torch.argmin(kvl))
        assert not o[:, row].any()
        assert bool((lse[row] == 1e30).all())
        assert not dqkv[:, row].any()


@pytest.mark.parametrize("name", ["causal_mha", "d128_gqa_rope_varlen_dropout",
                                  "d36_rope_varlen"])
def test_flash_packed_forward_is_deterministic(gen, name):
    qkv, _, kvl, rope, seed = _packed_inputs(gen, PACKED[name],
                                             torch.bfloat16)
    b, s, g, qpg, d, causal, _, window, _, rate = PACKED[name]
    args = (kvl, rope, seed, rate, 1.0 / math.sqrt(d), causal, window, qpg,
            d)
    o, lse = flash_packed_fwd_cuda(qkv, *args)
    o2, lse2 = flash_packed_fwd_cuda(qkv, *args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_packed_backward_is_deterministic(gen):
    case = PACKED["gqa_qpg2"]
    qkv, do, kvl, rope, seed = _packed_inputs(gen, case, torch.bfloat16)
    args = (kvl, rope, seed, 0.0, 0.125, True, None, 2, 64)
    o, lse = flash_packed_fwd_cuda(qkv, *args)
    first = flash_packed_bwd_cuda(qkv, do, o, lse, *args)
    assert torch.equal(first, flash_packed_bwd_cuda(qkv, do, o, lse, *args))


def test_flash_packed_device_seed_needs_no_host_sync(gen):
    """A one-element seed tensor on the card goes to the kernels as it is:
    forward and backward make no host sync and give the int seed's
    output and grads bitwise."""
    b, s, g, qpg, d, causal, _, _, _, rate = PACKED["dropout"]
    qkv, do, _, _, seed = _packed_inputs(gen, PACKED["dropout"],
                                         torch.bfloat16)
    device_seed = torch.tensor([seed], dtype=torch.int32, device="cuda")
    outs = []
    for sd in (seed, device_seed):
        x = qkv.clone().requires_grad_()
        torch.cuda.synchronize()
        if isinstance(sd, torch.Tensor):
            torch.cuda.set_sync_debug_mode("error")
        try:
            o = flash_attention_packed(x, queries_per_group=qpg, head_dim=d,
                                       causal=causal, dropout_rate=rate,
                                       dropout_seed=sd)
            o.backward(do)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append((o.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,rate", [(7, 0.1), (-2 ** 31, 0.5),
                                       (123456789, 0.9)])
def test_flash_packed_dropout_mask_is_the_hash(gen, seed, rate, dtype):
    """With v = I per group (s == d) and a non-causal softmax (every p >
    0), o[i, j] = keep[i, j] * p[i, j] / (1 - rate): the kernel's mask is
    read off exactly (in bf16 too, where the kernel hashes each score
    accumulator's (row, col) itself)."""
    b, s, g, d = 2, 64, 2, 64
    q = 0.1 * torch.randn(s, b, g, 1, d, device="cuda", generator=gen)
    k = 0.1 * torch.randn(s, b, g, 1, d, device="cuda", generator=gen)
    eye = torch.eye(s, device="cuda")[:, None, None, None, :].expand(
        s, b, g, 1, d)
    qkv = torch.cat([q, k, eye], dim=3).reshape(s, b, g * 3 * d).to(
        dtype).contiguous()
    o, _ = flash_packed_fwd_cuda(qkv, None, None, seed, rate, 0.125, False,
                                 None, 1, d)
    got = (o.reshape(s, b, g, d) != 0).permute(1, 2, 0, 3)   # [b, h, s, s]
    combo = drop_combo(torch.arange(b)[:, None, None, None],
                       torch.arange(g)[None, :, None, None])
    want = hash_keep(seed, combo, (b, g, s, s), rate)
    assert torch.equal(got.cpu(), want)


SOFTMAX = {
    # (x shape, mask shape or None, causal sq, scale)
    "bert_padding": ((2, 3, 200, 200), "padding", 0, 1.0),
    "key_mask": ((2, 3, 40, 200), (2, 1, 1, 200), 0, 0.5),
    "causal": ((1, 6, 130, 130), None, 130, 1.0),
    "k17": ((1, 2, 9, 17), (1, 1, 9, 17), 0, 1.0),
    "k1000": ((1, 2, 7, 1000), (1, 2, 1, 1000), 0, 0.125),
    "k4097": ((1, 1, 6, 4097), (1, 1, 1, 4097), 0, 1.0),
    "k4097_causal": ((1, 1, 4097, 4097), None, 4097, 2.0),
    # Kernel G's 16-byte path: rows of 64 four to a warp over 300 rows (a
    # part-filled last block), rows of 8 thirty-two to a warp, causal rows
    # of 256; its element path for the encoder-decoder's 114 and for a
    # mask broadcast along the keys (last stride 0)
    "k64_packed": ((2, 3, 50, 64), (2, 1, 1, 64), 0, 1.0),
    "k8": ((1, 1, 37, 8), None, 0, 1.0),
    "causal_256": ((1, 2, 256, 256), None, 256, 1.0),
    "enc_dec_114": ((2, 12, 114, 114), (2, 1, 1, 114), 0, 1.0),
    "mask_per_row": ((1, 2, 7, 64), (1, 2, 7, 1), 0, 1.0),
}


def _softmax_inputs(gen, name, dtype):
    shape, mask, sq, scale = SOFTMAX[name]
    x = (3 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
    if mask == "padding":
        valid = torch.ones(shape[0], shape[-1], dtype=torch.bool,
                           device="cuda")
        valid[1, 150:] = False             # padded rows: every key masked
        mask = ~(valid[:, None, None, :] & valid[:, None, :, None])
    elif mask is not None:
        mask = torch.rand(mask, device="cuda", generator=gen) < 0.3
    return x, mask, sq, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SOFTMAX))
def test_softmax_kernels(gen, name, dtype):
    x, mask, sq, scale = _softmax_inputs(gen, name, dtype)
    causal = sq > 0
    before = dict(_support.LAUNCHES)
    y = softmax_fwd_cuda(x, mask, scale, sq, causal)
    ref = softmax_fwd_plain(x.float(), mask, scale, sq, causal).to(dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=1e-5, rtol=0)
    else:
        assert_close_once_rounded(y, ref)
    dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
    dx = softmax_bwd_cuda(dy, y, scale)
    rdx = softmax_bwd_plain(dy.float(), y.float(), scale).to(dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(dx, rdx, atol=1e-5, rtol=0)
    else:
        assert_close_once_rounded(dx, rdx)
    assert _support.LAUNCHES["softmax_fwd"] == before["softmax_fwd"] + 1
    assert _support.LAUNCHES["softmax_bwd"] == before["softmax_bwd"] + 1
    if name == "bert_padding":
        # a padded query row masks every key: uniform 1/k, not 0
        k = x.shape[-1]
        torch.testing.assert_close(y[1, :, 150:].float(),
                                   torch.full_like(y[1, :, 150:].float(),
                                                   1.0 / k),
                                   atol=0, rtol=2.0 ** -8)


def test_softmax_autograd_launches_both_kernels(gen):
    x, mask, _, _ = _softmax_inputs(gen, "bert_padding", torch.bfloat16)
    x.requires_grad_()
    before = dict(_support.LAUNCHES)
    y = scaled_masked_softmax(x, mask, 0.5)
    y.backward(torch.ones_like(y))
    assert _support.LAUNCHES["softmax_fwd"] == before["softmax_fwd"] + 1
    assert _support.LAUNCHES["softmax_bwd"] == before["softmax_bwd"] + 1
    assert x.grad.shape == x.shape


FLASH_BWD = dict(FLASH, cross_t5=(2, 4, 4, 114, 512, 64, False, [512, 300],
                                  None),
                 cross_zero_length=(3, 4, 2, 50, 130, 64, False, [130, 7, 0],
                                    None))


def assert_close_up_to_factor_rounding(got, want, slack):
    """bf16 or fp16: every element within 1 ulp plus ``slack``
    (:func:`flash_bwd_rounding_slack`: the JAX backward rounds ds and p to
    the input dtype before its products, and a ds on a rounding boundary
    may round to a neighbouring value on one side), and at most a small
    share of the elements past 1 ulp (a boundary flip is rare; a wrong
    tile would move many elements): 0.1% in bf16, and in fp16 eight times
    that, 0.8%, since against the same fp32 differences (the kernel's exp2
    approximation, tensor-core sums) fp16's 2^3 times finer spacing puts
    2^3 times as many ds on a boundary."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulp = one_ulp(w, got.dtype)
    assert bool((err <= ulp + slack).all()), float((err - ulp
                                                    - slack).max())
    share = 1e-3 * 2.0 ** -7 / torch.finfo(got.dtype).eps
    assert float((err > ulp).float().mean()) <= share


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FLASH_BWD))
def test_flash_bwd_kernel(gen, name, dtype):
    """Kernel I against the plain backward on the same inputs: the plain
    version rounds ds and p to the input dtype where the JAX kernels do,
    computes in fp32 and rounds once at the end. f32 atol 1e-4; bf16 see
    :func:`assert_close_up_to_factor_rounding`."""
    b, h, kvh, sq, sk, d, causal, kvl, window = FLASH_BWD[name]
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    kvl = None if kvl is None else torch.tensor(kvl, device="cuda")
    scale = 1.0 / math.sqrt(d)
    o, lse = flash_fwd_cuda(q, k, v, kvl, scale, causal, window)
    before = _support.LAUNCHES["flash_bwd"]
    got = flash_bwd_cuda(q, k, v, do, o, lse, kvl, scale, causal, window)
    assert _support.LAUNCHES["flash_bwd"] == before + 1
    want = flash_bwd_plain(q, k, v, do, o, lse, kvl, scale, causal, window)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    else:
        slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, kvl, scale,
                                         causal, window)
        for g, w, sl in zip(got, want, slack):
            assert_close_up_to_factor_rounding(g, w, sl)
    again = flash_bwd_cuda(q, k, v, do, o, lse, kvl, scale, causal, window)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    if kvl is not None and int(kvl.min()) == 0:
        row = int(torch.argmin(kvl))
        assert not any(t[row].any() for t in got)


def test_flash_attention_autograd_on_the_card(gen):
    """``flash_attention`` under autograd launches Kernel B forward and
    Kernel I backward, and its grads match the plain backward's."""
    b, h, kvh, sq, sk, d, causal, kvl, window = FLASH_BWD["cross_t5"]
    q, k, v = (torch.randn(b, n, s, d, device="cuda",
                           generator=gen).requires_grad_()
               for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
    kvl = torch.tensor(kvl, device="cuda")
    do = torch.randn(b, h, sq, d, device="cuda", generator=gen)
    before = dict(_support.LAUNCHES)
    o = flash_attention(q, k, v, kv_lengths=kvl)
    o.backward(do)
    assert _support.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert _support.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    _, lse = flash_fwd_cuda(q.detach(), k.detach(), v.detach(), kvl,
                            1.0 / math.sqrt(d), False)
    want = flash_bwd_plain(q.detach(), k.detach(), v.detach(), do,
                           o.detach(), lse, kvl, 1.0 / math.sqrt(d), False)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


#: (kind, x shape, w shape): ragged rows and channels (1x1), a 1 x 1 image,
#: odd and ResNet-like images, ragged channels (3x3)
CONV = {
    "1x1_tail": ("1x1", (200, 64), (64, 96)),
    "1x1_ragged": ("1x1", (4133, 96), (96, 160)),
    "1x1_wide": ("1x1", (392, 1024), (1024, 2048)),
    # Kernel J's 128 x 64 tiles over a deep contraction (layer1's conv1,
    # N = 64 over K = 256), and N = 1024 (layer3's conv3) with a ragged
    # last row tile
    "1x1_n64_k256": ("1x1", (6272, 256), (256, 64)),
    "1x1_n1024": ("1x1", (1000, 256), (256, 1024)),
    # channel counts off the 8-channel groups of Kernel K's 16-byte copies
    # (their element-by-element edge), 1,000 rows off its 128-row dx tiles
    "1x1_ragged_channels": ("1x1", (1000, 20), (20, 36)),
    # a layer4 width whose bf16 dW pass sums two 3,136-row chunks
    "1x1_layer4_chunks": ("1x1", (6272, 1024), (1024, 2048)),
    "3x3_odd": ("3x3", (3, 5, 9, 16), (3, 3, 16, 32)),
    "3x3_1x1_image": ("3x3", (4, 1, 1, 24), (3, 3, 24, 40)),
    "3x3_14": ("3x3", (4, 14, 14, 64), (3, 3, 64, 128)),
    "3x3_7_wide": ("3x3", (2, 7, 7, 512), (3, 3, 512, 512)),
    # channel counts off the 8-channel groups of Kernel L's and M's 16-byte
    # copies (their element-by-element edge) and 715 pixels, off their
    # 128-pixel tiles
    "3x3_ragged": ("3x3", (5, 13, 11, 20), (3, 3, 20, 36)),
    # more than one column tile of Kernel L's GEMM, and 351 pixels: a
    # ragged last row tile
    "3x3_wide_rows": ("3x3", (3, 9, 13, 64), (3, 3, 64, 192)),
}
CONV_OPS = {"1x1": (conv1x1_fwd_cuda, conv1x1_fwd_plain, conv1x1_bwd_cuda,
                    conv1x1_bwd_plain),
            "3x3": (conv3x3_fwd_cuda, conv3x3_fwd_plain, conv3x3_bwd_cuda,
                    conv3x3_bwd_plain)}


def _norm_rel(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine,relu", [(False, False), (True, False),
                                         (True, True)])
@pytest.mark.parametrize("name", list(CONV))
def test_conv_kernels(gen, name, affine, relu, dtype):
    """Kernels J-M against their plain versions on the same inputs; two
    runs of each bitwise equal."""
    kind, x_shape, w_shape = CONV[name]
    fwd_c, fwd_p, bwd_c, bwd_p = CONV_OPS[kind]
    k, n = w_shape[-2], w_shape[-1]
    rnd = lambda *shape: torch.randn(shape, device="cuda",  # noqa: E731
                                     generator=gen)
    x = rnd(*x_shape).to(dtype)
    w = (rnd(*w_shape) * (k * (9 if kind == "3x3" else 1)) ** -0.5).to(dtype)
    a = (torch.rand(k, device="cuda", generator=gen) + 0.5) if affine \
        else None
    b = rnd(k) if affine else None
    c = 0.1 * rnd(n)
    dy = rnd(*x_shape[:-1], n).to(dtype)
    ds = 0.1 * rnd(2, n)
    y, st = fwd_c(x, a, b, w, c, affine, relu)
    y2, st2 = fwd_c(x, a, b, w, c, affine, relu)
    ry, rst = fwd_p(x, a, b, w, c, affine, relu)
    got = bwd_c(x, a, b, w, c, ry, dy, ds, affine, relu)
    want = bwd_p(x, a, b, w, c, ry, dy, ds, affine, relu)
    again = bwd_c(x, a, b, w, c, ry, dy, ds, affine, relu)
    for g, h in ((y, ry), (got[0], want[0])):
        if dtype == torch.bfloat16:
            assert_close_once_rounded(g, h)
        else:
            assert _norm_rel(g, h) <= 1e-5
    for g, h in ((st, rst), (got[1], want[1]), (got[2], want[2])):
        if g is None:
            assert h is None and not affine
            continue
        assert _norm_rel(g, h) <= 1e-5
    assert torch.equal(y2, y) and torch.equal(st2, st)
    assert all((g is None and h is None) or torch.equal(g, h)
               for g, h in zip(again, got))


def test_conv_autograd_launches_each_kernel_once(gen):
    """Under autograd a fused conv launches its forward and its backward
    kernel once each (the backward's passes count as one launch), and its
    grads match the plain backward's."""
    x = torch.randn(2, 6, 6, 32, device="cuda", generator=gen,
                    requires_grad=True)
    w1 = (0.2 * torch.randn(32, 48, device="cuda", generator=gen)
          ).requires_grad_()
    w3 = (0.1 * torch.randn(3, 3, 48, 16, device="cuda", generator=gen)
          ).requires_grad_()
    a = (torch.rand(48, device="cuda", generator=gen) + 0.5).requires_grad_()
    b = torch.randn(48, device="cuda", generator=gen).requires_grad_()
    before = dict(_support.LAUNCHES)
    y1, s1 = conv1x1_bn_act(x, w1)
    y3, s3 = conv3x3_bn_act(y1, w3, a, b, relu=True)
    (y3.square().sum() + s3.sum() + s1[1].sum()).backward()
    for name in ("conv1x1_fwd", "conv1x1_bwd", "conv3x3_fwd", "conv3x3_bwd"):
        assert _support.LAUNCHES[name] == before[name] + 1, name
    leaves = [t.detach().cpu().requires_grad_() for t in (x, w1, w3, a, b)]
    cy1, cs1 = conv1x1_bn_act(leaves[0], leaves[1])
    cy3, cs3 = conv3x3_bn_act(cy1, leaves[2], leaves[3], leaves[4],
                              relu=True)
    (cy3.square().sum() + cs3.sum() + cs1[1].sum()).backward()
    for t, ref in zip((x, w1, w3, a, b), leaves):
        assert _norm_rel(t.grad.cpu(), ref.grad) <= 1e-5


# -- multi-tensor kernels (ops/multi_tensor.py) ------------------------------

MT_SIZES = [1, mt.CHUNK + 1, 3 * mt.CHUNK + 17, 0, 767, 5]


def _mt_list(gen, sizes, dtype, scale=1.0):
    return [(scale * torch.randn(n, device="cuda", generator=gen)).to(dtype)
            for n in sizes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_multi_tensor_scale_kernel(gen, dtype):
    """Bitwise the plain version (one fp32 product, rounded once), inf/nan
    zeroed, found_inf from the input; a clean list reports False."""
    grads = _mt_list(gen, MT_SIZES, dtype, 100.0)
    grads[1][mt.CHUNK] = float("inf")
    grads[2][5] = float("nan")
    want = [g.clone() for g in grads]
    scale = torch.tensor(2.0 ** 7, device="cuda")
    before = _support.LAUNCHES["multi_tensor_scale"]
    found = mt.multi_tensor_scale(grads, scale)
    assert _support.LAUNCHES["multi_tensor_scale"] == before + len(
        mt.plan(MT_SIZES))
    assert bool(found) and bool(mt.scale_plain(want, scale))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    clean = _mt_list(gen, MT_SIZES, dtype)
    assert not bool(mt.multi_tensor_scale(clean, scale))
    mixed = [grads[0].float(), grads[1].to(torch.bfloat16), grads[4]]
    want = [g.clone() for g in mixed]
    assert bool(mt.multi_tensor_scale(mixed, scale)) == bool(
        mt.scale_plain(want, scale))
    assert all(torch.equal(g, w) for g, w in zip(mixed, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_tensor_l2norm_kernel(gen, dtype):
    """Total and per-tensor norms within 1e-6 of the plain version (sum
    order), the same with grad_scale, two runs bitwise equal, and a list
    over more tensors and chunks than one record holds."""
    tensors = _mt_list(gen, MT_SIZES + [mt.CHUNK * 5] * 150, dtype)
    total, per = mt.multi_tensor_l2norm(tensors, per_tensor=True)
    again, per2 = mt.multi_tensor_l2norm(tensors, per_tensor=True)
    assert torch.equal(total, again) and torch.equal(per, per2)
    want, want_per = mt.l2norm_plain(tensors)
    assert abs(float(total) / float(want) - 1) <= 1e-6
    torch.testing.assert_close(per, want_per, rtol=1e-6, atol=0)
    scale = torch.tensor(8.0, device="cuda")
    scaled, _ = mt.multi_tensor_l2norm([t * 8 for t in tensors],
                                       grad_scale=scale)
    assert abs(float(scaled) / float(want) - 1) <= 1e-6
    big = torch.randn(mt.CHUNK * mt.MAX_CHUNKS + 3, device="cuda",
                      generator=gen)
    got, _ = mt.multi_tensor_l2norm([big])
    assert abs(float(got) / float(big.double().norm()) - 1) <= 1e-6


def _opt_state(gen, sizes, dtype, master, slots=2, steps0=None):
    params = _mt_list(gen, sizes, dtype)
    state = [[torch.zeros(n, device="cuda") for n in sizes]
             for _ in range(slots)]
    steps = [torch.tensor(s, dtype=torch.int32, device="cuda")
             for s in (steps0 or [0] * len(sizes))]
    masters = [p.float().clone() for p in params] if master else None
    return params, state, steps, masters


def _clone(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.clone()
    return [_clone(t) for t in x]


def _equal(a, b):
    if a is None:
        return b is None
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_equal(x, y) for x, y in zip(a, b))


OPT_KERNELS = {
    "adam": (lambda p, st, s, m, **kw: mt.multi_tensor_adam(
        kw.pop("g"), p, st[0], st[1], s, m, **kw),
        lambda p, st, s, m, **kw: mt.adam_plain(kw.pop("g"), p, st[0], st[1],
                                                s, m, **kw),
        dict(betas=(0.9, 0.999), eps=1e-8, bias_correction=True), 2),
    "sgd": (lambda p, st, s, m, **kw: mt.multi_tensor_sgd(
        kw.pop("g"), p, st[0], s, m, **kw),
        lambda p, st, s, m, **kw: mt.sgd_plain(kw.pop("g"), p, st[0], s, m,
                                               **kw),
        dict(momentum=0.9, dampening=0.0, nesterov=False), 1),
}


@pytest.mark.parametrize("name,variant", [
    ("adam", dict(adam_w_mode=True, weight_decay=0.1)),
    ("adam", dict(adam_w_mode=False, weight_decay=0.1)),
    ("sgd", dict(wd_after_momentum=False, weight_decay=1e-2)),
    ("sgd", dict(wd_after_momentum=True, weight_decay=1e-2,
                 nesterov=True)),
], ids=["adamw", "adam_l2", "sgd", "sgd_nesterov_wd_after"])
@pytest.mark.parametrize("dtype,master", [
    (torch.float32, False), (torch.bfloat16, True), (torch.float16, True)])
def test_adam_and_sgd_kernels_bitwise(gen, name, variant, dtype, master):
    """Three steps against the plain version on the card, bitwise: each
    tensor's own step (counts 0, 4, 1, ...: its bias corrections and
    SGD's first-step rule), grad_scale, lr as a device tensor at step 2,
    and a found_inf step that writes nothing."""
    kernel, plain, fixed, slots = OPT_KERNELS[name]
    steps0 = [i % 5 for i in range(len(MT_SIZES))]
    p, st, s, m = _opt_state(gen, MT_SIZES, dtype, master, slots, steps0)
    q, qst, qs, qm = _clone(p), _clone(st), _clone(s), _clone(m)
    for i in range(4):
        g = _mt_list(gen, MT_SIZES, dtype, 64.0)
        found = torch.tensor(i == 1, device="cuda")
        lr = torch.tensor(1e-2, device="cuda") if i == 2 else 1e-2
        kw = dict(fixed, **variant, lr=lr,
                  grad_scale=torch.tensor(64.0, device="cuda"),
                  found_inf=found)
        before = [_clone(x) for x in (p, st, s, m)]
        kernel(p, st, s, m, g=g, **kw)
        plain(q, qst, qs, qm, g=_clone(g), **kw)
        if i == 1:
            assert all(_equal(a, b) for a, b in zip(before, (p, st, s, m)))
        assert _equal(p, q) and _equal(st, qst) and _equal(s, qs) \
            and _equal(m, qm), i


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.01, adam_w_mode=True),
    dict(weight_decay=0.01, adam_w_mode=False, trust_clip=True),
    dict(weight_decay=0.0, always_adapt=True, max_grad_norm=0.0),
    dict(weight_decay=0.0),
], ids=["adamw", "l2_trust_clip", "always_adapt_no_clip", "no_adapt"])
@pytest.mark.parametrize("dtype,master", [(torch.float32, False),
                                          (torch.bfloat16, True)])
def test_lamb_kernels_against_plain(gen, kw, dtype, master):
    """Three LAMB steps against the plain version on the card: fp32 state
    within rtol 1e-5 (the norms' summation order moves the clip and the
    trust ratio by an ulp or so), found_inf writes nothing, every step
    count equal."""
    full = dict(dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-6,
                     bias_correction=True, grad_averaging=True,
                     max_grad_norm=1.0, trust_clip=False,
                     always_adapt=False, adam_w_mode=True), **kw)
    p, st, s, m = _opt_state(gen, MT_SIZES, dtype, master)
    q, qst, qs, qm = _clone(p), _clone(st), _clone(s), _clone(m)
    upd = [torch.empty(n, device="cuda") for n in MT_SIZES]
    qupd = _clone(upd)
    for i in range(3):
        g = _mt_list(gen, MT_SIZES, dtype, 3.0)
        found = torch.tensor(i == 1, device="cuda")
        gnorm, _ = mt.multi_tensor_l2norm(g)
        pn, _ = mt.l2norm_plain(g)
        before = _clone(p)
        mt.multi_tensor_lamb(g, p, st[0], st[1], upd, s, m, gnorm=gnorm,
                             found_inf=found, **full)
        mt.lamb_plain(_clone(g), q, qst[0], qst[1], qupd, qs, qm, gnorm=pn,
                      found_inf=found, **full)
        if i == 1:
            assert _equal(before, p)
    assert _equal(s, qs)
    for a, b in zip(m or p, qm or q):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(st[0] + st[1], qst[0] + qst[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)


def test_optimizers_take_the_kernels_on_the_card(gen):
    """FusedAdam / FusedLAMB / FusedSGD on CUDA parameters launch their
    kernels and give the per-parameter path's parameters (Adam and SGD
    bitwise, LAMB within rtol 1e-5), a parameter without a grad keeping its
    step, two param groups and a weight-decay mask making separate
    lists."""
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    sizes = [(64, 48), (48,), (48, 3), (7,)]
    for cls, kw, exact, counter in (
            (FusedAdam, dict(lr=1e-2, weight_decay=0.1), True,
             "multi_tensor_adam"),
            (FusedSGD, dict(lr=0.1, momentum=0.9, weight_decay=1e-2), True,
             "multi_tensor_sgd"),
            (FusedLAMB, dict(lr=1e-2, weight_decay=0.01), False,
             "multi_tensor_lamb")):
        init = [torch.randn(*sz, device="cuda", generator=gen)
                for sz in sizes]
        ps = [torch.nn.Parameter(t.clone()) for t in init]
        qs = [torch.nn.Parameter(t.clone()) for t in init]
        groups = lambda x: [{"params": x[:2]}, {"params": x[2:]}]  # noqa: E731
        a = cls(groups(ps), weight_decay_mask=lambda t: t.dim() > 1, **kw)
        b = cls(groups(qs), weight_decay_mask=lambda t: t.dim() > 1, **kw)
        for i in range(3):
            g = [torch.randn(*sz, device="cuda", generator=gen)
                 for sz in sizes]
            for j, (p, q) in enumerate(zip(ps, qs)):
                p.grad = None if (i == 1 and j == 3) else g[j].clone()
                q.grad = None if (i == 1 and j == 3) else g[j].clone()
            before = _support.LAUNCHES[counter]
            a.step()
            assert _support.LAUNCHES[counter] > before
            todo = [(gi, grp, q) for gi, grp in enumerate(b.param_groups)
                    for q in grp["params"] if q.grad is not None]
            b._step_per_parameter(todo, None, None)
        assert int(a.state[ps[3]]["step"]) == 2
        for p, q in zip(ps, qs):
            if exact:
                assert torch.equal(p, q)
            else:
                torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)
