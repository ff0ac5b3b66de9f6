"""The native fp8 products on the card: ``fp8_matmul``'s
``torch._scaled_mm`` (K and N padded to multiples of 16, the second
operand column-major) against its plain version, ``fp8_matmul_plain``
(the fp8 operands upcast, fp32 products with TF32 off), at 16-aligned and
ragged shapes and for every operand pairing the backward uses: each fp32
element within 2^-11 of its sum of |products|. Hopper's fp8 MMA keeps
about 13 fraction bits in its accumulator between fp32 promotions, so the
card's products lie up to 1.6e-4 (2^-12.6) of that sum from float64
(``apex_tpu_torch/tools/fp8_products.py``; ``chip_smoke.py``'s
``FP8_PRODUCT_BAR``). Every test carries the
``cuda`` marker and skips without a CUDA device; run them on a machine
with one:

    python -m pytest tests/test_torch_cuda_fp8.py -q
"""

import pytest
import torch

from apex_tpu_torch.amp import fp8

pytestmark = pytest.mark.cuda

DTYPES = {"e4m3": fp8.E4M3, "e5m2": fp8.E5M2}
#: each product element's bar, a share of its sum of |products|
BAR = 2.0 ** -11


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (3, 100, 520),
                                   (17, 1000, 24), (8192, 1024, 4096)])
@pytest.mark.parametrize("pair", ["e4m3xe4m3", "e5m2xe4m3", "e4m3xe5m2"])
def test_scaled_mm_matches_plain_on_card(m, k, n, pair, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._scaled_mm)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    da, db = (DTYPES[p] for p in pair.split("x"))
    one = torch.tensor(1.0, device="cuda")
    a = fp8.quantize(torch.randn(m, k, device="cuda", generator=gen) * 50,
                     one, da)
    b = fp8.quantize(torch.randn(k, n, device="cuda", generator=gen) * 50,
                     one, db)
    got = fp8.fp8_matmul(a, b)
    want = fp8.fp8_matmul_plain(a, b)
    scale = fp8.fp8_matmul_plain(a.float().abs().to(da),
                                 b.float().abs().to(db))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= BAR * scale).all())


def test_native_fp8_dense_backward_runs_on_card():
    """The native path's forward and backward at a ragged 3-D shape, grads
    finite and of the operands' dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._scaled_mm)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(3, 100, 1000, device="cuda", generator=gen,
                    dtype=torch.bfloat16).requires_grad_(True)
    w = torch.randn(1000, 520, device="cuda", generator=gen,
                    dtype=torch.bfloat16).requires_grad_(True)
    state = fp8.init_fp8_state(["x", "w"])
    y, state = fp8.fp8_dense(x, w, state, native=True)
    y.float().square().sum().backward()
    assert y.shape == (3, 100, 520) and y.dtype == torch.bfloat16
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    assert bool(torch.isfinite(x.grad).all() & torch.isfinite(w.grad).all())
    assert float(state["x"]["scale"]) != 1.0
