"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a CUDA
device; run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

They reach the corners the serving smoke test (``chip_smoke.py``) does not:
RMSNorm and non-affine LayerNorm at a width that is not a multiple of 32,
flash attention with ``kv_lengths`` (one of them 0), ``sq != sk``, GQA,
sliding windows and head_dim 32/128, paged decode with GQA, a sliding
window and sentinel pages. Tolerances: f32 atol 1e-4 (summation order
only, TF32 off); bf16 1 ulp of an fp32 reference rounded to bf16.
"""

import math

import pytest
import torch

from apex_tpu_torch.ops import _support
from apex_tpu_torch.ops.attention import flash_fwd_cuda, mha_plain
from apex_tpu_torch.ops.decode_attention import (
    append_rows,
    decode_plain,
    page_pool,
    paged_decode_cuda,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_fwd_cuda,
    layer_norm_fwd_plain,
)

pytestmark = pytest.mark.cuda


def assert_close_once_rounded(got, want):
    """``want`` is the plain version run on the inputs cast to fp32 and
    rounded to ``got``'s dtype. The kernels also compute in fp32 and round
    once, so f32 differs by summation order only (atol 1e-4) and bf16 by
    at most one rounding step: 1 bf16 ulp, i.e. 2^-7 of the magnitude,
    with an absolute floor of 2^-15 where the output is near zero."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2.0 ** -15, rtol=2.0 ** -7)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    ref = mha_plain(q.float(), k.float(), v.float(), kvl, scale, causal,
                    window).to(dtype)
    assert_close_once_rounded(o, ref)
    if kvl is not None and int(kvl.min()) == 0:
        row = int(torch.argmin(kvl))
        assert not o[row].any() and bool((lse[row] == 1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,window", [(1, None), (4, None), (3, 20),
                                          (12, 70)])
def test_paged_decode_kernel(gen, group, window, dtype):
    b, hl, dh, ps, pps, n_pages = 6, 12, 64, 16, 8, 40
    kvh = hl // group
    f = kvh * dh
    positions = torch.tensor([0, 15, 16, 77, 127, 40], dtype=torch.int32)
    table = torch.full((b, pps), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for r in range(b):
        need = min(pps, int(positions[r]) // ps + 1)
        table[r, :need] = perm[used:used + need]
        used += need
    table[5, 1] = n_pages          # a sentinel inside the slot's range
    kp = page_pool(n_pages, ps, f, dtype, "cuda")
    vp = page_pool(n_pages, ps, f, dtype, "cuda")
    kp.copy_(torch.randn(kp.shape, device="cuda", generator=gen))
    vp.copy_(torch.randn(vp.shape, device="cuda", generator=gen))
    q = torch.randn(b, hl, dh, device="cuda", generator=gen).to(dtype)
    rows = torch.randn(2, b, f, device="cuda", generator=gen).to(dtype)
    pt, pos = table.cuda(), positions.cuda()
    append_rows(kp, rows[0], pt, pos, ps)
    append_rows(vp, rows[1], pt, pos, ps)
    ctx = paged_decode_cuda(q, kp, vp, pt, pos, group, window)
    ref = decode_plain(q.float(), kp.float(), vp.float(), pt, pos, group,
                       window).to(dtype)
    assert_close_once_rounded(ctx, ref)
