#!/usr/bin/env python3
"""Kernel E's 16-bit o and its plain version's, each against float64
attention, at head dims 512, 1024 and 2048.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/flash_f64.py [--out FILE]

For each case (b 2, s 66, one K/V group of 4 query heads, causal; RoPE
over all of d or none, dropout 0.2 or none; seeds 0-3) it runs
``flash_packed_fwd_cuda`` and ``flash_packed_fwd_plain`` on the same
random fp16 (or bf16) qkv and computes float64 attention from the same
rotated and rounded q and k, the same keep mask and v. It prints one JSON
line a case: the largest distance of the kernel and of the plain version
from float64, and of the two from each other, in ulps of the output type
at the larger magnitude floored at 2^-8 (``chip_smoke.ulps16``'s units),
with the element where the two differ most. An output that cancels to
near zero carries the fp32 noise of its d-long score sums on both sides;
this shows how that noise grows with d.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

#: (name, d, rot, rate, dtype, seed)
CASES = [(f"d{d}_rope{int(rope)}_drop{int(rate > 0)}_{str(dt)[6:]}_s{seed}",
          d, d if rope else 0, rate, dt, seed)
         for d in (512, 1024, 2048) for rope in (True, False)
         for rate in (0.2, 0.0) for dt in (torch.float16, torch.bfloat16)
         for seed in range(4)]


def _ulp(t: torch.Tensor, bits: int) -> torch.Tensor:
    """The ulp of a ``bits``-fraction type at |t| floored at 2^-8."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2 ** -8)))
                      - bits)


def run(att, rope_mod, d, rot, rate, dtype, seed, b=2, s=66, qpg=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(s, b, (qpg + 2) * d, device="cuda",
                      generator=gen).to(dtype)
    rope = None if not rot else rope_mod.rope_tables(rope_mod.rope_freqs(
        0, s, rot, 10000.0, device="cuda"), s, d)
    seed_v = -12345 if rate else None
    args = (None, rope, seed_v, rate, 1.0 / math.sqrt(d), True, None, qpg, d)
    o = att.flash_packed_fwd_cuda(qkv, *args)[0].double()
    ro = att.flash_packed_fwd_plain(qkv, *args)[0].double()
    q, k, v = att._qk(qkv, qpg, d, rope)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) \
        / math.sqrt(d)
    valid = att._packed_valid(s, None, True, None, qkv.device)
    p = torch.softmax(torch.where(valid, sc, torch.full_like(sc, -1e300)),
                      -1)
    if rate:
        keep = att._packed_keep(seed_v, b, qpg, s, rate, qkv.device)
        p = torch.where(keep, p / (1 - rate), torch.zeros_like(p))
    o64 = torch.einsum("bhqk,bhkd->bhqd", p, v.double()).permute(
        2, 0, 1, 3).reshape(s, b, qpg * d)
    bits = 10 if dtype == torch.float16 else 7
    ulp = _ulp(o64, bits)
    apart = (o - ro).abs() / _ulp(torch.maximum(o.abs(), ro.abs()), bits)
    i = int(apart.argmax())
    return dict(kernel_vs_f64=float(((o - o64).abs() / ulp).max()),
                plain_vs_f64=float(((ro - o64).abs() / ulp).max()),
                kernel_vs_plain=float(apart.max()),
                at=dict(row=i // (b * qpg * d), col=i % d,
                        kernel=float(o.flatten()[i]),
                        plain=float(ro.flatten()[i]),
                        f64=float(o64.flatten()[i])))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_f64: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from apex_tpu_torch.ops import attention as att
    from apex_tpu_torch.ops import rope as rope_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for name, d, rot, rate, dtype, seed in CASES:
        row = dict(case=name, card=card, **run(att, rope_mod, d, rot, rate,
                                               dtype, seed))
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
