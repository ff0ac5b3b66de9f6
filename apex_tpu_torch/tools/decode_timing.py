#!/usr/bin/env python3
"""Time the paged decode attention kernel (Kernel C) on one CUDA card.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/decode_timing.py [--root DIR] [--tag NAME]
        [--out FILE] [--cases NAME,...] [--serve]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file), so one call can time two
versions of the kernel in turns (parent, change, change, parent), each in
its own process. ``paged_decode_cuda`` is timed at:

- ``table_bf16``, ``table_f32``: GPT-2's serve shape, b 8, 12 heads,
  head_dim 64, pages of 64, 12 pages a slot, positions {63, 64, 200, 700}
  twice;
- ``full``: b 8, every slot at 767 (12 pages each: the serve cell's
  ``max_len`` 768);
- ``one``: b 1 at 767;
- ``gqa``: b 8, 32 heads over 8 kv heads, head_dim 128, pages of 64, every
  slot at 2047 (32 pages each), and ``gqa_window`` with a sliding window of
  512 (8 pages a slot read);
- ``element_dh60``: the table in bf16 at head_dim 60, off the 16-byte
  pieces (the element path, whose sha256 two versions share), and
  ``element_dh260``: 8 query heads over 2 K/V heads at head_dim 260;
- ``int8``, ``w2``, ``w4``, ``int8_w4``: the table in bf16 over int8
  pools (quantized page by page, then the step's rows appended with the
  rescale-on-append) and with 2- and 4-row query windows (a checkout
  without them cannot run these cases);
- ``*_fp16``: the table, full, one, gqa and gqa_window cases and the
  int8, w4 and int8_w4 ones with fp16 q (and fp16 pools where they are
  not int8); a checkout without Kernel C's fp16 path cannot run them.

Each case is first held to its plain version run in f32 and rounded once
(1 ulp of its 16-bit type, atol 1e-4 in f32) and run twice (bitwise
equal);
its launch plan is printed where the checkout has one
(``paged_decode_cuda_plan``: path, pages a split, splits, heads a block,
grid), and the sha256 of its context. Then it is timed with the L2
flushed before each call (cold: a decode step finds its pages in device
memory) and without (warm), as the median of CUDA-event intervals behind
a spin kernel, and by the profiler's kernel records (``kernel_ms``:
device time without the event floor; every kernel whose name holds
``paged_decode``). ``cold`` flushes by writing 100 MB, as the other
``*_timing.py`` tools do, which leaves the L2 full of dirty lines that
the timed call's reads evict to device memory; ``cold_clean`` flushes by
reading 100 MB, as a decode step finds the L2 after the layer's weight
reads. The case ``bandwidth`` times ``torch.sum`` over 19 and 67 MB of
bf16 (the "full" and "gqa" cases' bytes) in the same three modes: what
one plain read of those bytes takes. The bound counts the bytes of the
K/V rows each slot must read (rows ``max(0, pos - window + 1)`` to
``pos + w - 1``; one byte an element in int8, plus the fp32 scales of the
(page, kv head) pairs those rows lie on), q, ctx, the page table and the
positions, at 3.35 TB/s, as ``chip_smoke.py`` does; the inputs are the
ones its ``phase_decode`` builds. ``host_us`` is the wrapper's host time
a call (the median and the least of 30 runs of 100 calls). The case
``floor`` times a one-element fill, the least a timed call takes.

``--serve`` runs the checkout's ``chip_smoke.py`` serve phase with its
checks and profiles its second serve: Kernel C's device ms a decode step
beside the phase's ``decode_ms_per_step``. Prints one JSON line per
measurement and, with ``--out``, appends them to FILE.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import ln_timing
from conv_timing import HBM_BYTES_S, SPIN_CYCLES, digest, ulps

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


def _load_smoke():
    """The ``chip_smoke.py`` of this tool's checkout, whatever ``--root``
    names: its decode inputs and byte count are the card check's."""
    spec = importlib.util.spec_from_file_location(
        "decode_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_smoke()
#: (name, b, heads, group, head_dim, page, pages a slot, positions, window,
#: dtype[, query window rows, int8 pools])
TABLE = (63, 64, 200, 700) * 2
CASES = [
    ("table_bf16", 8, 12, 1, 64, 64, 12, (63, 64, 200, 700) * 2, None, BF16),
    ("table_f32", 8, 12, 1, 64, 64, 12, (63, 64, 200, 700) * 2, None, F32),
    ("full", 8, 12, 1, 64, 64, 12, (767,) * 8, None, BF16),
    ("one", 1, 12, 1, 64, 64, 12, (767,), None, BF16),
    ("gqa", 8, 32, 4, 128, 64, 32, (2047,) * 8, None, BF16),
    ("gqa_window", 8, 32, 4, 128, 64, 32, (2047,) * 8, 512, BF16),
    ("element_dh60", 8, 12, 1, 60, 64, 12, (63, 64, 200, 700) * 2, None,
     BF16),
    ("element_dh260", 8, 8, 4, 260, 64, 12, TABLE, None, BF16),
    ("int8", 8, 12, 1, 64, 64, 12, TABLE, None, BF16, 1, True),
    ("w2", 8, 12, 1, 64, 64, 12, TABLE, None, BF16, 2, False),
    ("w4", 8, 12, 1, 64, 64, 12, TABLE, None, BF16, 4, False),
    ("int8_w4", 8, 12, 1, 64, 64, 12, TABLE, None, BF16, 4, True),
]
CASES += [(f"{c[0].removesuffix('_bf16')}_fp16", *c[1:9], F16, *c[10:])
          for c in CASES
          if c[0] in ("table_bf16", "full", "one", "gqa", "gqa_window",
                      "int8", "w4", "int8_w4")]


class Timer(ln_timing.Timer):
    """``ln_timing.Timer`` (median CUDA-event ms behind a spin kernel),
    with the L2 flushed by a 100 MB write (``cold``), a 100 MB read
    (``cold_clean``) or not at all (``warm``) before each call."""

    def flush(self, mode: str) -> None:
        if mode == "cold":
            self._flush.zero_()
        elif mode == "cold_clean":
            self._flush.sum()

    def __call__(self, fn, mode: str, iters: int = 30) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            self.flush(mode)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


MODES = ("cold", "cold_clean", "warm")


def event_ms(timer, fn) -> dict:
    return {mode: timer(fn, mode) for mode in MODES}


def host_us(fn, calls: int = 100, reps: int = 30) -> dict:
    """Host microseconds until a call of ``fn`` returns, over ``reps``
    runs of ``calls`` calls issued back to back (nothing waits on the
    card in between): the median run, and the least, which other work on
    the host's cores cannot inflate."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    runs.sort()
    return {"median": runs[reps // 2], "min": runs[0]}


def kernel_ms(timer, fn, name="paged_decode", calls=5) -> dict:
    """Device ms a call of the kernels ``fn`` launches whose name holds
    ``name``, from the profiler's kernel records, in each flush mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for mode in MODES:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                timer.flush(mode)
                fn()
            torch.cuda.synchronize()
        out[mode] = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and name in e.name) / calls / 1e3
    return out


def plan_of(da, q, kp, vp, pt, group, window):
    """The plan the checkout's wrapper takes (None where it has none)."""
    fn = getattr(da, "paged_decode_cuda_plan", None)
    if fn is None:
        return None
    p = fn(q, kp, vp, pt, group, window)
    return dict(path=p.path, split_pages=p.split_pages, splits=p.splits,
                heads=p.heads, grid=list(p.grid))


def time_case(da, timer, gen, case, emit) -> None:
    name, b, hl, group, dh, ps, pps, positions, window, dtype = case[:10]
    w, int8 = case[10:] if len(case) > 10 else (1, False)
    if w == 1 and not int8:
        q, kp, vp, pt, pos = SMOKE._decode_inputs(b, hl, group, dh, ps, pps,
                                                  positions, dtype, gen)
        ks = vs = None
        run = lambda: da.paged_decode_cuda(q, kp, vp, pt, pos,  # noqa
                                           group, window)
    else:
        q, kp, vp, pt, pos, ks, vs = SMOKE._decode_window_inputs(
            b, hl, group, dh, ps, pps, positions, dtype, gen, w, int8)
        run = lambda: da.paged_decode_cuda(q, kp, vp, pt, pos,  # noqa
                                           group, window, ks, vs)
    got, again = run(), run()
    if int8:
        want = da.decode_plain(q.float(), kp, vp, pt, pos, group, window,
                               ks, vs)
    else:
        want = da.decode_plain(q.float(), kp.float(), vp.float(), pt, pos,
                               group, window)
    half = dtype != F32
    err = ulps(got, want.to(dtype)) if half else \
        float((got - want).abs().max())
    same = torch.equal(got, again)
    ok = same and err <= (1.0 if half else 1e-4)
    n_bytes = SMOKE._decode_bytes(q, pt, positions, ps, hl // group, window,
                                  1 if int8 else None, int8)
    emit(kernel="paged_decode", case=name, b=b, heads=hl, group=group, dh=dh,
         page=ps, positions=list(positions[:4]), window=window, w=w,
         pool=str(kp.dtype)[6:], dtype=str(dtype)[6:],
         plan=plan_of(da, q, kp, vp, pt, group, window),
         rows_read=SMOKE._decode_rows(positions, ps, pps, window, w),
         ms=event_ms(timer, run), kernel_ms=kernel_ms(timer, run),
         host_us=host_us(run), bound_ms=n_bytes / HBM_BYTES_S * 1e3, ok=ok,
         err=err, tol=f"1 {str(dtype)[6:]} ulp" if half else "atol 1e-4",
         repeat_bitwise=same, sha256=digest([got]))


def time_serve(emit) -> None:
    """The checkout's ``chip_smoke.py`` serve phase with its checks; the
    profiler around its second serve is replaced by one that sums Kernel
    C's device time over the decode steps."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fields = {}
    log = chip_smoke.log

    def keep(phase, **kw):
        if phase == "serve":
            fields.update(kw)
        log(phase, **kw)

    def capture(path, fn, describe=dict):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        steps = describe()["decode_steps"]
        per, total = {}, 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or getattr(
                    e, "is_user_annotation", False):
                continue
            us = e.time_range.elapsed_us()
            total += us
            if "paged_decode" in e.name:
                key = re.split(r"[(]", e.name.replace(
                    "(anonymous namespace)::", "").removeprefix("void "))[0]
                calls, t = per.get(key, (0, 0.0))
                per[key] = (calls + 1, t + us)
        emit(kernel="paged_decode_serve", case=path, decode_steps=steps,
             c_ms_a_decode_step=sum(t for _, t in per.values()) / 1e3
             / steps,
             device_ms_profiled=total / 1e3,
             decode_ms_per_step=float(fields["decode_ms_per_step"]),
             tokens_per_s=float(fields["tokens_per_s"]),
             launches=json.loads(fields["launches"]),
             kernels={k: dict(calls=c, ms=t / 1e3)
                      for k, (c, t) in sorted(per.items())})

    chip_smoke.log = keep
    chip_smoke.profile_device = capture
    chip_smoke.phase_serve(True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--cases", default=None,
                        help="comma-separated case names (default all)")
    parser.add_argument("--serve", action="store_true",
                        help="profile the checkout's serve phase instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import decode_attention as da
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rows = []

    def emit(**fields):
        row = dict(tag=args.tag, card=card, **fields)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if args.serve:
        time_serve(emit)
        return 0
    only = None if args.cases is None else set(args.cases.split(","))
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(14)
    if only is None or "floor" in only:
        # the least a timed call can take: one launch between two events
        z = torch.zeros(1, device="cuda")
        emit(kernel="floor", case="floor", ms=event_ms(timer, z.zero_),
             ok=True)
    if only is None or "bandwidth" in only:
        for mib in (19, 67):
            x = torch.ones(mib * 2 ** 19, dtype=BF16, device="cuda")
            emit(kernel="sum", case="bandwidth", mib=mib,
                 ms=event_ms(timer, x.sum),
                 kernel_ms=kernel_ms(timer, x.sum, name="BFloat16"),
                 bound_ms=x.numel() * 2 / HBM_BYTES_S * 1e3, ok=True)
            del x
    for case in CASES:
        if only is None or case[0] in only:
            time_case(da, timer, gen, case, emit)
            torch.cuda.empty_cache()
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
