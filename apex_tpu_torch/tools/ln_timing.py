#!/usr/bin/env python3
"""Time the LayerNorm kernels (A forward, D backward) on one CUDA card.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/ln_timing.py [--root DIR] [--tag NAME]
        [--out FILE] [--cases NAME,...] [--steps [PHASE,...]]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file), so one call can time two
versions of the kernels in turns (parent, change, change, parent), each in
its own process. Kernel D (``layer_norm_bwd_cuda``) is timed at
[8192, 768] in bf16 over fp32 w and b (GPT-2's and BERT's training
block), in RMSNorm and in f32, at the T5 decoder's [1824, 768] RMSNorm,
and at a bf16 width off the 16-byte path (h = 1020); Kernel A
(``layer_norm_fwd_cuda``) at [8, 768], [768, 768], [6144, 768] and
[8192, 768] in the training mix (bf16 x, fp32 w and b, bf16 y) and in
RMSNorm, in serving's all-bf16 at the first three, and in f32 and at
h = 1020; then the wide rows (past A's element kernel at h 14336 and
D's at 29056), each case's name starting ``a_wide`` or ``d_wide``: A at
Llama-3.1-405B's decode step (8 rows of 16384, RMSNorm, all bf16) and at
2048 rows of 16384 (LayerNorm and RMSNorm), 18432 and 32768 in the
training mix, D at 2048 rows of 16384 (still the element kernel), and of
32768 in LayerNorm and RMSNorm (the wide kernel). A checkout without the
wide paths takes only the cases before them (``--cases``). Every case is
timed with the L2 flushed before each call (cold:
the training step finds its operands in device memory) and without
(warm: dy and x, 25 MB at [8192, 768], fit the 50 MB L2, so a warm time
can read past the HBM bound), beside one PyTorch call of the same work
where there is one (``native_layer_norm_backward``, ``F.layer_norm``,
``F.rms_norm``, and for D's RMSNorm the backward of ``F.rms_norm`` under
autograd; their w and b in x's dtype, as ``chip_smoke.py`` times them) and beside its bound (each input read and each output written once
at 3.35 TB/s). The profiler's kernel records give each kernel's device
time without the event floor, cold and warm (D split into its passes);
the case ``floor`` times a one-element fill, the least a timed call
takes.
Each case is first held to its plain version run in fp32 (y and dx within
1 bf16 ulp, mean and invvar within 1e-4, dw and db within 1e-4 of
1 + |value|, two runs bitwise equal); its launch plan is printed where the
checkout has one (``layer_norm_{fwd,bwd}_plan``: 16-byte pieces a lane,
rows a warp, path, blocks), and the sha256 of its outputs, so that two
versions can be compared bit for bit (the f32 and element-path cases must
match across a change of the 16-byte kernels). Times are medians of
CUDA-event intervals behind a spin kernel (``conv_timing.median_ms``).

``--steps`` runs the checkout's ``chip_smoke.py`` phases ``train``,
``bert_train`` and ``t5_train`` (or those named) with their checks, and
profiles their two extra steps: the LN kernels' device ms a step, by
kernel, beside the step's device ms. Prints one JSON line per
measurement and, with ``--out``, appends them to FILE.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from conv_timing import (HBM_BYTES_S, SPIN_CYCLES, device_split, digest,
                         ulps)

L2_BYTES = 50 * 2 ** 20
BF16, F32 = torch.bfloat16, torch.float32
#: Kernel D: (name, m, h, x and dy dtype, is_rms, bias)
D_CASES = [
    ("d_train", 8192, 768, BF16, False, True),
    ("d_rms", 8192, 768, BF16, True, False),
    ("d_f32", 8192, 768, F32, False, True),
    ("d_t5_decoder", 1824, 768, BF16, True, False),
    ("d_h1020", 2048, 1020, BF16, False, True),
]
#: Kernel A: (name, m, h, x dtype, w/b dtype, y dtype, is_rms, bias)
A_CASES = [
    *[(f"a_train_{m}", m, 768, BF16, F32, BF16, False, True)
      for m in (8, 768, 6144, 8192)],
    *[(f"a_rms_{m}", m, 768, BF16, F32, BF16, True, False)
      for m in (8, 768, 6144, 8192)],
    *[(f"a_serve_{m}", m, 768, BF16, BF16, BF16, False, True)
      for m in (8, 768, 6144)],
    ("a_f32_6144", 6144, 768, F32, F32, F32, False, True),
    ("a_h1020", 2048, 1020, BF16, F32, BF16, False, True),
]
#: the wide rows, timed after every case above (so those keep their
#: seeded inputs): Kernel D, then Kernel A, in the tuples above
D_WIDE_CASES = [
    ("d_wide_16384", 2048, 16384, BF16, False, True),
    ("d_wide_32768", 2048, 32768, BF16, False, True),
    ("d_wide_rms_32768", 2048, 32768, BF16, True, False),
]
A_WIDE_CASES = [
    ("a_wide_decode_16384", 8, 16384, BF16, BF16, BF16, True, False),
    ("a_wide_16384", 2048, 16384, BF16, F32, BF16, False, True),
    ("a_wide_rms_16384", 2048, 16384, BF16, F32, BF16, True, False),
    ("a_wide_18432", 2048, 18432, BF16, F32, BF16, False, True),
    ("a_wide_32768", 2048, 32768, BF16, F32, BF16, False, True),
]
STEP_PHASES = ("train", "bert_train", "t5_train")


class Timer:
    """Median device ms of one call from CUDA events behind a spin kernel;
    with ``cold`` the L2 is flushed (a 100 MB write) before each call."""

    def __init__(self):
        self._flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                  device="cuda")

    def __call__(self, fn, cold: bool, iters: int = 30) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            if cold:
                self._flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


def both(timer, fn) -> dict:
    return {"cold": timer(fn, True), "warm": timer(fn, False)}


def kernel_ms(timer, fn, calls=5) -> dict:
    """Device ms a call of each LayerNorm kernel ``fn`` launches, from the
    profiler's kernel records (no event floor), with the L2 flushed before
    each call (cold) and without (warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for mode in ("cold", "warm"):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if mode == "cold":
                    timer._flush.zero_()
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "layer_norm" in e.name:
                name = re.split(r"[<(]", e.name.replace(
                    "(anonymous namespace)::", "").removeprefix("void "))[0]
                split[name] = split.get(name, 0.0) + \
                    e.time_range.elapsed_us() / calls / 1e3
        out[mode] = split
    return out


def rel_err(got, want) -> float:
    """dw/db against the plain version's fp32 sums: |got - want| over
    1 + |want| (``chip_smoke.py``'s measure)."""
    if want is None:
        return 0.0
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def plan_of(ln, kind, *tensors):
    """The plan the checkout's wrapper takes for these tensors (None where
    the checkout has no plan)."""
    fn = getattr(ln, f"layer_norm_{kind}_cuda_plan", None)
    if fn is None:
        return None
    p = fn(*tensors)
    return dict(pieces=p.pieces, rows_a_warp=p.rows_a_warp, path=p.path,
                blocks=p.blocks, block_rows=p.block_rows)


def time_d(ln, timer, gen, case, emit) -> None:
    name, m, h, dtype, is_rms, bias = case
    x = (2.0 * torch.randn(m, h, device="cuda", generator=gen) + 0.5) \
        .to(dtype)
    dy = torch.randn(m, h, device="cuda", generator=gen).to(dtype)
    w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=gen)
    b = 0.1 * torch.randn(h, device="cuda", generator=gen) if bias else None
    _, mean, iv = ln.layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                          F32)
    run = lambda: ln.layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms,  # noqa
                                         bias)
    got, again = run(), run()
    want = ln.layer_norm_bwd_plain(dy.float(), x.float(), mean, iv, w,
                                   is_rms, bias)
    dx_ulps = ulps(got[0], want[0].to(dtype)) if dtype == BF16 else \
        float((got[0] - want[0]).abs().max())
    dwb = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
    same = all((a is None and c is None) or torch.equal(a, c)
               for a, c in zip(got, again))
    ok = same and dwb <= 1e-4 and (dx_ulps <= 1.0 if dtype == BF16
                                   else dx_ulps <= 1e-4)
    esz = x.element_size()
    n_bytes = 3 * m * h * esz + 2 * m * 4 + h * 4 + (2 if bias else 1) * h * 4
    lib, lib_name = None, None
    if not is_rms:
        wd, bd = w.to(dtype), b.to(dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wd, bd,
                                                           1e-5)
        lib_name = "native_layer_norm_backward"
        lib = both(timer, lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [h], lmean, lrstd, wd, bd, [True, True, True]))
    elif hasattr(F, "rms_norm"):
        # the backward of F.rms_norm under autograd: dx and dw from the
        # graph one forward call records (w in x's dtype)
        xr = x.detach().requires_grad_()
        wr = w.to(dtype).requires_grad_()
        yr = F.rms_norm(xr, (h,), wr, 1e-5)
        lib_name = "F.rms_norm backward (autograd)"
        lib = both(timer, lambda: torch.autograd.grad(
            yr, (xr, wr), dy, retain_graph=True))
    plan = plan_of(ln, "bwd", dy, x, got[0], w, bias)
    emit(kernel="layer_norm_bwd", case=name, m=m, h=h, dtype=str(dtype)[6:],
         rms=is_rms, plan=plan,
         ms=both(timer, run),
         library=lib_name,
         library_ms=lib,
         library_null_reason=None if lib else
         "this PyTorch has no F.rms_norm",
         bound_ms=n_bytes / HBM_BYTES_S * 1e3, ok=ok, dx_ulps=dx_ulps,
         dw_db_rel_err=dwb, repeat_bitwise=same,
         kernel_ms=kernel_ms(timer, run),
         sha256=digest([t for t in got if t is not None]))


def library_call(x, h, wd, bd, is_rms):
    """One PyTorch call of Kernel A's work on these inputs: ``(name,
    callable)``, or ``(None, reason)`` where the installed PyTorch has
    none."""
    if not is_rms:
        return "F.layer_norm", lambda: F.layer_norm(x, (h,), wd, bd, 1e-5)
    if not hasattr(F, "rms_norm"):
        return None, "this PyTorch has no F.rms_norm"
    return "F.rms_norm", lambda: F.rms_norm(x, (h,), wd, 1e-5)


def time_a(ln, timer, gen, case, emit) -> None:
    name, m, h, xdt, wdt, ydt, is_rms, bias = case
    x = (2.0 * torch.randn(m, h, device="cuda", generator=gen) + 0.5) \
        .to(xdt)
    w = (1.0 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(wdt)
    b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(wdt) \
        if bias else None
    run = lambda: ln.layer_norm_fwd_cuda(x, w, b, 1e-5, is_rms, ydt)  # noqa
    got, again = run(), run()
    ry, rmean, riv = ln.layer_norm_fwd_plain(x.float(), w, b, 1e-5, is_rms,
                                             F32)
    y_err = ulps(got[0], ry.to(ydt)) if ydt == BF16 else \
        float((got[0] - ry).abs().max())
    stat = max(float((got[1] - rmean).abs().max()),
               float((got[2] - riv).abs().max()))
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    ok = same and stat <= 1e-4 and (y_err <= 1.0 if ydt == BF16
                                    else y_err <= 1e-4)
    n_bytes = m * h * (x.element_size() + got[0].element_size()) + \
        (2 if bias else 1) * h * w.element_size() + 2 * m * 4
    lib_name, fn = library_call(x, h, w.to(xdt),
                                None if b is None else b.to(xdt), is_rms)
    plan = plan_of(ln, "fwd", x, got[0], w, b)
    emit(kernel="layer_norm_fwd", case=name, m=m, h=h, x=str(xdt)[6:],
         w=str(wdt)[6:], y=str(ydt)[6:], rms=is_rms, plan=plan,
         ms=both(timer, run), library=lib_name,
         library_ms=both(timer, fn) if lib_name else None,
         library_kernels=len(device_split(fn, calls=1)) if lib_name
         else None, library_null_reason=None if lib_name else fn,
         bound_ms=n_bytes / HBM_BYTES_S * 1e3, ok=ok, y_err=y_err,
         stats_err=stat, repeat_bitwise=same, kernel_ms=kernel_ms(timer, run),
         sha256=digest(list(got)))


def time_steps(phases, emit) -> None:
    """The checkout's ``chip_smoke.py`` train phases with their checks;
    the profiler around each phase's two extra steps is replaced by one
    that sums the LN kernels' device time a step (kernels whose name holds
    ``layer_norm``) beside the step's device time."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def capture(path, fn, describe=dict):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        steps = describe().get("steps", 1)
        per, total = {}, 0.0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or getattr(
                    e, "is_user_annotation", False):
                continue
            us = e.time_range.elapsed_us()
            total += us
            if "layer_norm" in e.name:
                key = re.split(r"[(]", e.name.replace(
                    "(anonymous namespace)::", "").removeprefix("void "))[0]
                calls, t = per.get(key, (0, 0.0))
                per[key] = (calls + 1, t + us)
        emit(kernel="ln_step", case=path, steps=steps,
             ln_ms_a_step=sum(t for _, t in per.values()) / 1e3 / steps,
             device_ms_a_step=total / 1e3 / steps,
             kernels={k: dict(calls_a_step=c / steps,
                              ms_a_step=t / 1e3 / steps)
                      for k, (c, t) in sorted(per.items())})

    chip_smoke.profile_device = capture
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for phase in phases:
        getattr(chip_smoke, f"phase_{phase}")(True)
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--cases", default=None,
                        help="comma-separated case names (default all)")
    parser.add_argument("--steps", nargs="?", const=",".join(STEP_PHASES),
                        default=None,
                        help="profile the checkout's train phases instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ln_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import layer_norm as ln
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

    if args.steps:
        time_steps(args.steps.split(","), emit)
        return 0
    only = None if args.cases is None else set(args.cases.split(","))
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(13)
    if only is None or "floor" in only:
        # the least a timed call can take: one launch between two events
        z = torch.zeros(1, device="cuda")
        emit(kernel="floor", case="floor", ms=both(timer, z.zero_), ok=True)
    for case in D_CASES:
        if only is None or case[0] in only:
            time_d(ln, timer, gen, case, emit)
    for case in A_CASES:
        if only is None or case[0] in only:
            time_a(ln, timer, gen, case, emit)
    for case in D_WIDE_CASES:
        if only is None or case[0] in only:
            time_d(ln, timer, gen, case, emit)
    for case in A_WIDE_CASES:
        if only is None or case[0] in only:
            time_a(ln, timer, gen, case, emit)
    torch.cuda.empty_cache()
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
