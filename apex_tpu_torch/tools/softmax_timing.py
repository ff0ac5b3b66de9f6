#!/usr/bin/env python3
"""Time the masked softmax forward and backward (Kernels G and H) on one
CUDA card.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/softmax_timing.py [--root DIR] [--tag NAME]
        [--out FILE] [--cases NAME,...] [--dtypes bf16,fp16]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file), so one call can time two
versions of the kernel in turns (parent, change, change, parent), each in
its own process. ``softmax_fwd_cuda`` is timed in bf16 and fp16 at the shapes of
``chip_smoke.py``'s ``SOFTMAX_CASES`` (BERT-base's scores with its padding
mask, a [b, 1, 1, s] key mask, causal, odd and long rows, the
encoder-decoder's 114 and rows of 64), beside ``torch.softmax`` on the
same scores (no mask) and beside its bound (the visible scores, the mask
and y at 3.35 TB/s, as ``chip_smoke.py`` counts it). Each case is first
held to the plain version run in fp32 and rounded (within 1 bf16 ulp; a
fully masked row within 2^-8 of 1/k; two runs bitwise equal), its launch
plan (``softmax_fwd_plan``: 16-byte pieces a lane and lanes a row, or the
element path) is printed where the checkout has one, and the digests of
its bf16 and f32 outputs, so that two versions' outputs can be compared
bit for bit. ``softmax_bwd_cuda`` is timed the same way on a seeded dy
and the kernel's own y, beside ``_softmax_backward_data`` and its bound
(dy and y read, dx written), held to its plain version run in fp32 and
rounded (1 ulp, two runs bitwise equal), with its digests (f32 on the
f32 forward's y). ``--dtypes`` names the 16-bit types timed (default
``bf16,fp16``; a checkout without fp16 in G and H runs ``bf16`` alone),
each with its own rows; the f32 digests come with bf16's. Times are
medians of CUDA-event intervals (``conv_timing.median_ms``). Prints one
JSON line per kernel and case and, with ``--out``, appends them to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from conv_timing import HBM_BYTES_S, digest, median_ms, ulps

#: (name, x shape, mask, causal sq, scale), as ``chip_smoke.py``'s
#: ``SOFTMAX_CASES``
CASES = [
    ("bert", (16, 12, 512, 512), "padding", 0, 1.0),
    ("key_mask", (4, 12, 512, 512), "key", 0, 1.0),
    ("causal", (1, 96, 1024, 1024), None, 1024, 1.0),
    ("k17", (8, 12, 64, 17), "key", 0, 1.0),
    ("k1000", (2, 12, 100, 1000), "key", 0, 0.125),
    ("k4097", (1, 4, 64, 4097), "key", 0, 2.0),
    ("enc_dec_key", (16, 12, 114, 114), "key", 0, 1.0),
    ("k64", (16, 12, 512, 64), "key", 0, 1.0),
]


def mask_of(kind, shape, seed=8):
    """``chip_smoke.py``'s ``_softmax_mask``: valid lengths drawn from a
    seed in [s/2, s] (row 0 at s); a key mask [b, 1, 1, s], or BERT's
    padding mask [b, 1, s, s] whose padded query rows mask every key."""
    if kind is None:
        return None
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(shape[-1] // 2, shape[-1] + 1, (shape[0],),
                            generator=g)
    lengths[0] = shape[-1]
    valid = torch.arange(shape[-1], device="cuda")[None, :] < \
        lengths.cuda()[:, None]
    if kind == "key":
        return ~valid[:, None, None, :]
    return ~(valid[:, None, None, :] & valid[:, None, :, None])


DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def time_case(sm, name, shape, kind, sq, scale, gen, emit,
              dtypes=("bf16",)) -> None:
    mask = mask_of(kind, shape)
    causal = sq > 0
    raw = 3 * torch.randn(shape, device="cuda", generator=gen)
    # dy from its own seed, so that x stays what the forward alone drew
    dy_raw = torch.randn(shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(17))
    n = raw.numel()
    seen = n if mask is None else int((~mask).expand(shape).sum())
    for dname in dtypes:
        dtype = DTYPES[dname]
        esz = torch.empty((), dtype=dtype).element_size()
        x = raw.to(dtype)
        run = lambda: sm.softmax_fwd_cuda(x, mask, scale, sq,  # noqa
                                          causal)
        got, again = run(), run()
        want = sm.softmax_fwd_plain(x.float(), mask, scale, sq,
                                    causal).to(dtype)
        err = ulps(got, want)
        uniform = None
        if kind == "padding":
            rows = got.permute(0, 2, 1, 3)[mask[:, 0].all(dim=-1)]
            uniform = float((rows.float() * shape[-1] - 1.0).abs().max())
        ok = (err <= 1.0 and torch.equal(got, again)
              and (uniform is None or uniform <= 2.0 ** -8))
        bound = ((seen + n) * esz + (0 if mask is None else mask.numel())) \
            / HBM_BYTES_S * 1e3
        plan = None
        if hasattr(sm, "softmax_fwd_plan"):
            strides = (0, 0, 0, 1) if mask is None else \
                mask.expand(shape).stride()
            plan = sm.softmax_fwd_plan(
                shape[-1], x.dtype, x.data_ptr(), got.data_ptr(),
                None if mask is None else mask.data_ptr(), strides)
        f32 = {}
        if dtype == torch.bfloat16:
            got32 = sm.softmax_fwd_cuda(x.float(), mask, scale, sq, causal)
            f32 = dict(sha256_f32=digest([got32]))
        emit(kernel="softmax_fwd", case=name, dtype=dname, x=list(shape),
             mask=None if mask is None else list(mask.shape),
             causal=causal, plan=plan, ms=median_ms(run),
             softmax_ms=median_ms(lambda: torch.softmax(x, -1)),
             bound_ms=bound, ok=ok, ulps=err, uniform_rows_err=uniform,
             sha256=digest([got]), **f32)
        # Kernel H on the kernel's own y
        dy = dy_raw.to(dtype)
        run = lambda: sm.softmax_bwd_cuda(dy, got, scale)  # noqa: E731
        dx, again = run(), run()
        want = sm.softmax_bwd_plain(dy.float(), got.float(), scale).to(dtype)
        err = ulps(dx, want)
        ok = err <= 1.0 and torch.equal(dx, again) and \
            bool(torch.isfinite(dx).all())
        if dtype == torch.bfloat16:
            f32 = dict(sha256_f32=digest([sm.softmax_bwd_cuda(
                dy.float(), got32, scale)]))
        emit(kernel="softmax_bwd", case=name, dtype=dname, x=list(shape),
             ms=median_ms(run),
             softmax_bwd_ms=median_ms(
                 lambda: torch.ops.aten._softmax_backward_data(
                     dy, got, -1, dtype)),
             bound_ms=3 * n * esz / HBM_BYTES_S * 1e3, ok=ok, ulps=err,
             sha256=digest([dx]), **f32)
        del x, got, again, want, dy, dx


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--cases", default=None,
                        help="comma-separated case names (default all)")
    parser.add_argument("--dtypes", default="bf16,fp16",
                        help="comma-separated 16-bit types (bf16, fp16)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("softmax_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import softmax as sm
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    only = None if args.cases is None else set(args.cases.split(","))
    rows = []

    def emit(**fields):
        row = dict(tag=args.tag, card=card, **fields)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, shape, kind, sq, scale in CASES:
        if only is None or name in only:
            time_case(sm, name, shape, kind, sq, scale, gen, emit,
                      tuple(args.dtypes.split(",")))
            torch.cuda.empty_cache()
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
