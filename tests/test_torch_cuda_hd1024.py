"""Kernels B, I, E and F past head_dim 512, and Kernel C's element path
with its query rows in chunks, against their plain versions on the card.
Every test carries the ``cuda`` marker and skips without a CUDA device;
run them from the repository root on a machine with one (they import
``chip_smoke.py``'s checks, and nothing of JAX):

    python -m pytest --noconftest tests/test_torch_cuda_hd1024.py -q

- E and F (:data:`WIDE_PACKED`) and B and I (:data:`WIDE_FLASH`) at head
  dims 840 (off 64), 1024, 1030 (off 8: the element-by-element copies),
  1536 (three 512-column parts) and 2048, with MQA and GQA, RoPE over all
  of d and over 640 columns (pairs that straddle two parts), windows,
  ``kv_lengths`` with a 0, ``sq != sk`` and dropout, in f32, bf16 and
  fp16, through ``chip_smoke``'s ``_wide_packed`` and ``_wide_flash``: o
  f32 atol 1e-4 or 1 ulp of the plain version run in fp32, lse 1e-4,
  gradients f32 atol 1e-4 or 1 ulp plus the rounding slack over
  ``backward_floor(d)`` (at most 0.1% past 1 ulp in bf16, 0.8% in fp16),
  a kv_length-0 row zero, two 16-bit runs bitwise equal;
- Kernel C (:data:`WIDE_PAGED`) at head_dim 1024 and 2048 over pools of
  q's dtype and int8, w = 1 and 4, pages of 16 and 64: on the element
  path in the plan's row chunks (one where all of a kv head's rows leave
  a K/V tile, as before), against ``decode_plain`` (1 ulp, f32 atol
  1e-4, two runs bitwise equal).

``apex_tpu_torch/tools/attn_digests.py`` reads these tables too.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

#: (b, s, groups, qpg, d, causal, kv_lengths, window, rot, rate), as
#: tests/test_torch_cuda.py's PACKED
WIDE_PACKED = {
    "d1024_mqa_rope_window_dropout": (2, 100, 1, 4, 1024, True, None, 40,
                                      1024, 0.1),
    "d1024_gqa_rope640_kv_lengths_0": (3, 70, 2, 2, 1024, False, [70, 33, 0],
                                       None, 640, 0.0),
    "d840_gqa_causal": (1, 80, 2, 2, 840, True, None, None, 0, 0.0),
    "d1030_rope_window": (1, 66, 1, 2, 1030, True, None, 20, 1030, 0.0),
    "d1536_kv_lengths_causal": (2, 72, 1, 2, 1536, True, [72, 30], None, 0,
                                0.0),
    "d2048_gqa4_rope_dropout": (2, 66, 1, 4, 2048, True, None, None, 2048,
                                0.2),
}
#: (b, h, kvh, sq, sk, d, causal, kv_lengths, window), as
#: tests/test_torch_cuda.py's FLASH_BWD
WIDE_FLASH = {
    "d1024_gqa4_kv_lengths": (2, 8, 2, 130, 130, 1024, True, [100, 130],
                              None),
    "d1024_sq_gt_sk": (1, 4, 2, 96, 64, 1024, True, None, None),
    "d840_window": (1, 4, 2, 100, 100, 840, True, None, 40),
    "d1030_sq_lt_sk_0_length": (2, 4, 4, 40, 97, 1030, True, [97, 0], None),
    "d1536_cross": (2, 4, 4, 50, 80, 1536, False, [80, 41], None),
    "d2048_mqa": (1, 8, 1, 70, 70, 2048, False, None, None),
}
#: (b, heads, group, head_dim, window), as tests/test_torch_cuda.py's
#: PAGED: 8 query rows a kv head at w = 1 (one chunk: the parent's plan)
#: and 32 at w = 4 (two chunks); 16 and 64 at 2048 with a window; 4 and 16
#: at 1024, where every run keeps the parent's plan
WIDE_PAGED = {
    "d1024_gqa8": (4, 16, 8, 1024, None),
    "d2048_mqa16_window": (3, 16, 16, 2048, 30),
    "d1024_gqa4": (6, 8, 4, 1024, None),
}
#: as tests/test_torch_cuda.py's PAGED_POSITIONS
PAGED_POSITIONS = (127, 15, 16, 77, 0, 40)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cs(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    import chip_smoke
    return chip_smoke


@pytest.fixture
def gen(cs):
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("name", list(WIDE_PACKED))
def test_wide_packed_kernels(cs, gen, name):
    """E and F past 512 against their plain versions (``_wide_packed``:
    f32, bf16 and fp16, bitwise repeatable)."""
    cs._wide_packed(None, gen, "cuda_hd1024", [(name, *WIDE_PACKED[name])],
                    timed="")


@pytest.mark.parametrize("name", list(WIDE_FLASH))
def test_wide_flash_kernels(cs, gen, name):
    """B and I past 512 against their plain versions (``_wide_flash``:
    f32, bf16 and fp16, bitwise repeatable)."""
    cs._wide_flash(None, gen, "cuda_hd1024", [(name, *WIDE_FLASH[name])],
                   timed="")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("w,int8", [(1, False), (4, False), (4, True)],
                         ids=["w1", "w4", "w4_int8"])
@pytest.mark.parametrize("name", list(WIDE_PAGED))
def test_paged_decode_element_row_chunks(cs, gen, name, w, int8, ps, dtype):
    """Kernel C past 512 on its element path, its rows in the fewest equal
    chunks that leave a K/V tile (``element_chunks``), against
    ``decode_plain`` (``_decode_check``)."""
    from apex_tpu_torch.ops.decode_attention import (element_chunks,
                                                     element_tile)
    b, hl, group, dh, window = WIDE_PAGED[name]
    q, kp, vp, pt, pos, ks, vs = cs._decode_window_inputs(
        b, hl, group, dh, ps, 128 // ps, PAGED_POSITIONS[:b], dtype, gen, w,
        int8, sentinel=b > 5)
    if w == 1:
        q = q[:, 0].contiguous()
    _, plan, _ = cs._decode_check(name, q, kp, vp, pt, pos, group, window,
                                  ks, vs)
    rows = w * group
    chunks = element_chunks(rows, dh, ps)
    assert plan.path == "element"
    assert plan.heads == -(-rows // chunks)
    assert plan.grid[0] == hl // group * -(-rows // plan.heads)
    assert (chunks == 1) == (element_tile(rows, dh, ps) > 0)
