#!/usr/bin/env python3
"""How far the card's fp8 products lie from exact, and what they cost.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/fp8_products.py [--out FILE]

For each case (M, K, N; e4m3 or e5m2 operands drawn at scale 50 from a
seed, as ``tests/test_torch_cuda_fp8.py`` draws them) it computes the
product four ways and holds each to float64 on the same fp8 values, as
the largest |difference| over the element's sum of |products|:

- ``scaled_mm``: ``amp.fp8.fp8_matmul``, ``torch._scaled_mm`` on the fp8
  tensor cores (fp32 out, fast accumulation off): the native path;
- ``scaled_mm_fast``: the same with ``use_fast_accum=True``;
- ``plain``: ``fp8_matmul_plain``, the operands upcast, an fp32 product
  (TF32 off);
- ``bf16_f32``: the operands cast to bf16 (exact) and a bf16 GEMM with an
  fp32 output (``torch.mm(..., out_dtype=torch.float32)``).

It prints one JSON line a case, then one of device times (CUDA events,
median of 30 calls, operands warm) at the GEMM of
``benchmarks/fp8_bench.py`` for ``scaled_mm`` with fp32 and bf16 outputs,
``bf16_f32`` and a bf16 GEMM with a bf16 output, each with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from apex_tpu_torch.amp import fp8  # noqa: E402
from apex_tpu_torch.ops._support import round_up  # noqa: E402

#: (M, K, N, a's dtype, b's dtype)
CASES = [(64, 32, 256, "e4m3", "e4m3"), (64, 128, 256, "e4m3", "e4m3"),
         (64, 128, 256, "e5m2", "e4m3"), (300, 1000, 520, "e4m3", "e4m3"),
         (8192, 1024, 4096, "e4m3", "e4m3"),
         (8192, 1024, 4096, "e5m2", "e4m3"),
         (1024, 8192, 4096, "e4m3", "e5m2")]
DTYPES = {"e4m3": fp8.E4M3, "e5m2": fp8.E5M2}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _operands(m, k, n, da, db, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    one = torch.tensor(1.0, device="cuda")
    a = fp8.quantize(torch.randn(m, k, device="cuda", generator=gen) * 50,
                     one, DTYPES[da])
    b = fp8.quantize(torch.randn(k, n, device="cuda", generator=gen) * 50,
                     one, DTYPES[db])
    return a, b


def _scaled_mm(a, b, fast=False, out_dtype=torch.float32):
    """``fp8_matmul``'s call with its padding, ``use_fast_accum`` and the
    output dtype exposed."""
    m, k = a.shape
    n = b.shape[1]
    kp, np_ = round_up(k, 16), round_up(n, 16)
    ap = torch.zeros((m, kp), dtype=a.dtype, device=a.device)
    ap[:, :k] = a
    bp = torch.zeros((kp, np_), dtype=b.dtype, device=b.device)
    bp[:k, :n] = b
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(ap, bp.t().contiguous().t(), one, one,
                            out_dtype=out_dtype,
                            use_fast_accum=fast)[:, :n]


def _bf16_f32(a, b):
    return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                    out_dtype=torch.float32)


def _ms(fn, iters=30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fp8_products: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    lines = []
    for seed, (m, k, n, da, db) in enumerate(CASES):
        a, b = _operands(m, k, n, da, db, seed)
        exact = a.double() @ b.double()
        sums = a.double().abs() @ b.double().abs()
        rec = {"case": f"{m}x{k}x{n}_{da}x{db}", "card": card}
        for name, fn in (("scaled_mm", lambda: fp8.fp8_matmul(a, b)),
                         ("scaled_mm_fast", lambda: _scaled_mm(a, b, True)),
                         ("plain", lambda: fp8.fp8_matmul_plain(a, b)),
                         ("bf16_f32", lambda: _bf16_f32(a, b))):
            got = fn().double()
            rec[name] = float(((got - exact).abs() / sums).max())
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    a, b = _operands(8192, 1024, 4096, "e4m3", "e4m3", 99)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    times = {"card": card, "gemm": "8192x1024x4096",
             "scaled_mm_f32_ms": _ms(lambda: fp8.fp8_matmul(a, b)),
             "scaled_mm_bf16_ms": _ms(
                 lambda: _scaled_mm(a, b, out_dtype=torch.bfloat16)),
             "bf16_f32_ms": _ms(lambda: _bf16_f32(a, b)),
             "bf16_ms": _ms(lambda: ab @ bb)}
    lines.append(times)
    print(json.dumps(times), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
