"""Kernels B and I at global offsets, and the ring over them, against their
plain versions on the card. Every test carries the ``cuda`` marker and
skips without a CUDA device; run them from the repository root on a
machine with one (they import ``chip_smoke.py``'s checks, and nothing of
JAX):

    python -m pytest --noconftest tests/test_torch_cuda_ring.py -q

- ``flash_chunk_fwd`` / ``flash_chunk_bwd`` (Kernels B and I with
  ``q_start``, ``k_start`` and a given delta) at every corner of
  ``chip_smoke.CHUNK_CASES`` (before, on and straddling the diagonal,
  wholly in the future, a far past that a window cuts and one it skips,
  global ``kv_lengths`` ending inside, before and after the chunk,
  positions past 12288, GQA, head dims 64 to 512) in f32, bf16 and fp16:
  o f32 atol 2e-5 or 1 ulp, lse 1e-4, grads f32 atol 1e-4 or 1 ulp plus
  the rounding slack (at most 0.1% past 1 ulp in bf16, 0.8% in fp16) over
  ``backward_floor(d)``; a chunk that sees no key gives lse 1e30 and
  zeros; two runs bitwise equal;
- the ring (``_ring_attention_local``, cp 4) in bf16 and fp16 against the
  same schedule over the plain chunk versions
  (``chip_smoke.ring_vs_plain_ring``'s derived bars), and in f32 against
  the non-ring ``flash_attention`` (o 2e-5, each grad element 1e-6 of its
  largest |value|), launching B and I cp x cp times each.
"""

import math

import pytest
import torch

from apex_tpu_torch.ops import _support, flash_attention
from apex_tpu_torch.ops.attention import (
    backward_floor,
    flash_bwd_rounding_slack,
    flash_chunk_bwd,
    flash_chunk_bwd_plain,
    flash_chunk_fwd,
    flash_chunk_fwd_plain,
)
from apex_tpu_torch.ops.ring_attention import _ring_attention_local

pytestmark = pytest.mark.cuda

#: (b, h, kvh, sq, sk, d, causal, window, kv_lengths, q_start, k_start) at
#: the corners of chip_smoke.CHUNK_CASES, at smaller sizes
CHUNKS = {
    "before_diagonal": (2, 4, 4, 100, 130, 64, True, None, None, 1024, 512),
    "diagonal_gqa_window": (2, 8, 2, 150, 150, 128, True, 40, [2200, 2180],
                            2100, 2100),
    "straddling_gqa": (1, 8, 2, 96, 140, 256, True, None, None, 1000, 1050),
    "future": (2, 4, 4, 64, 64, 64, True, None, None, 0, 1024),
    "far_past_window_cuts": (1, 4, 2, 128, 128, 128, True, 300, None, 1000,
                             800),
    "far_past_window_skips": (1, 4, 4, 64, 64, 512, True, 300, None, 8192,
                              0),
    "kv_lengths_inside_before_after": (3, 4, 2, 70, 100, 64, True, None,
                                       [560, 300, 2000], 1024, 512),
    "ring_chunk3_of_16k": (2, 4, 2, 128, 128, 128, True, 4096,
                           [16384, 10000], 12288, 8192),
    "full_kv_lengths_end_before_d392": (2, 4, 4, 40, 66, 392, False, None,
                                        [4130, 1000], 0, 4096),
}
EMPTY = ("future", "far_past_window_skips")
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def gen(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CHUNKS))
def test_chunk_kernels_at_offsets(gen, name, dtype):
    from chip_smoke import _half_check
    b, h, kvh, sq, sk, d, causal, window, kvl, q_start, k_start = \
        CHUNKS[name]
    q, do = (torch.randn(b, h, sq, d, device="cuda", generator=gen)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, kvh, sk, d, device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    kvl = None if kvl is None else torch.tensor(kvl, device="cuda")
    args = (kvl, 1.0 / math.sqrt(d), causal, window, q_start, k_start)
    kw = dict(q_start=q_start, k_start=k_start, causal=causal,
              window=window, kv_lengths=kvl, softmax_scale=args[1])
    before = dict(_support.LAUNCHES)
    o, lse = flash_chunk_fwd(q, k, v, **kw)
    ro, rlse = flash_chunk_fwd_plain(q.float(), k.float(), v.float(), *args)
    pad = rlse > 1e29
    lse_g = torch.where(pad, torch.zeros_like(rlse), rlse + 0.25)
    delta_g = 0.75 * (do.float() * ro.to(dtype).float()).sum(-1)
    got = flash_chunk_bwd(q, k, v, do, lse_g, delta_g, **kw)
    assert _support.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert _support.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, atol=2e-5, rtol=0)
    else:
        _half_check("b", name, o, ro.to(dtype), None)
    torch.testing.assert_close(lse[~pad], rlse[~pad], atol=1e-4, rtol=0)
    assert torch.equal(lse > 1e29, pad)
    want = flash_chunk_bwd_plain(q, k, v, do, lse_g, delta_g, *args)
    slack = (flash_bwd_rounding_slack(q, k, v, do, None, lse_g, *args,
                                      delta=delta_g)
             if dtype != torch.float32 else (None,) * 3)
    for g_, w_, sl in zip(got, want, slack):
        _half_check("i", name, g_, w_, sl, backward_floor(d))
    if name in EMPTY:
        assert bool(pad.all()) and not o.any()
        assert not any(g_.any() for g_ in got)
    assert torch.equal(o, flash_chunk_fwd(q, k, v, **kw)[0])
    again = flash_chunk_bwd(q, k, v, do, lse_g, delta_g, **kw)
    assert all(torch.equal(a, g_) for a, g_ in zip(again, got))


def _ring_inputs(gen, dtype, b=2, h=8, kvh=2, s=1024, d=64, cp=4):
    q, do = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, kvh, s, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, sliding_window=300,
              kv_lengths=torch.tensor([1024, 600], device="cuda"))
    return [[c.contiguous() for c in t.chunk(cp, dim=2)]
            for t in (q, k, v, do)], kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_ring_against_the_plain_chunk_ring(gen, dtype):
    from chip_smoke import ring_vs_plain_ring
    (qs, ks, vs, dos), kw = _ring_inputs(gen, dtype)
    use = ring_vs_plain_ring(qs, ks, vs, dos, kw["kv_lengths"],
                             kw["sliding_window"])
    assert max(use.values()) <= 1.0


def test_f32_ring_against_flash_attention(gen):
    (qs, ks, vs, dos), kw = _ring_inputs(gen, torch.float32)
    leaves = [[c.clone().requires_grad_() for c in t] for t in (qs, ks, vs)]
    before = dict(_support.LAUNCHES)
    outs = _ring_attention_local(*leaves, **kw)
    torch.autograd.backward(outs, dos)
    assert _support.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 16
    assert _support.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 16
    whole = [torch.cat(t, dim=2).requires_grad_() for t in (qs, ks, vs)]
    o = flash_attention(*whole, **kw)
    o.backward(torch.cat(dos, dim=2))
    torch.testing.assert_close(torch.cat([t.detach() for t in outs], dim=2),
                               o.detach(), atol=2e-5, rtol=2e-5)
    for chunks, ref in zip(leaves, whole):
        got = torch.cat([c.grad for c in chunks], dim=2)
        bar = 1e-6 * float(ref.grad.abs().max())
        torch.testing.assert_close(got, ref.grad, atol=bar, rtol=0)
