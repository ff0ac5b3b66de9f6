#!/usr/bin/env python3
"""Time the fused conv kernels on one CUDA card, at ResNet-50's shapes.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/conv_timing.py [--root DIR] [--tag NAME]
        [--out FILE] [--only j,k,l,m] [--rn50]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file), so one call can time two
versions of the kernels in turns (parent, change, change, parent), each in
its own process. Kernels L (``conv3x3_fwd_cuda``) and M
(``conv3x3_bwd_cuda``) are timed in bf16 with the input affine and relu at
the four stride-1 3x3 shapes of ResNet-50 (layers 1-4, batch 256); L at
layer1 also gives the noise between processes. Kernels J
(``conv1x1_fwd_cuda``) and K (``conv1x1_bwd_cuda``) are timed at the 16
distinct 1x1 shapes of one ResNet-50 step (``K_SHAPES``, with or without
the affine as the model runs them). Each case is timed beside cuDNN's conv
forward or backward alone on the same inputs (J also beside its bound) and
split into its device kernels by ``torch.profiler``; J's and K's rows are
then summed with their launches a step (``conv1x1_fwd_step``,
``conv1x1_bwd_step``), to set beside a ``--profile`` breakdown of the
step. Each case is first held to its plain version (J and L: y within 1
bf16 ulp, stats within 1e-5 norm-wise; K and M: dx within 1 bf16 ulp, dW
and da/db within 1e-5 norm-wise; two runs bitwise equal), and its
outputs' digest is printed, so that two versions' outputs can be compared
bit for bit; J's f32 kernel prints its digests at two shapes. Times are medians of CUDA-event intervals, as
``chip_smoke.py``'s ``Timer`` takes them. Prints one JSON line per
measurement and, with ``--out``, writes them all to FILE. With ``--rn50``
it runs the checkout's ``chip_smoke.py`` ``[rn50_train]`` phase instead,
so that the training step can be compared in turns as well.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

SPIN_CYCLES = 200_000_000
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
#: (name, x shape, w shape) of ResNet-50's stride-1 3x3 convs at batch 256
M_SHAPES = [
    ("layer1", (256, 56, 56, 64), (3, 3, 64, 64)),
    ("layer2", (256, 28, 28, 128), (3, 3, 128, 128)),
    ("layer3", (256, 14, 14, 256), (3, 3, 256, 256)),
    ("layer4", (256, 7, 7, 512), (3, 3, 512, 512)),
]
#: (name, image side, K, N, affine + relu, launches a step) of the 1x1
#: convs of one ResNet-50 step at batch 256 (torchvision v1.5 strides:
#: the stride sits on the 3x3, so every block's conv1 reads its input
#: grid and the downsample the block's output grid)
K_SHAPES = [
    ("layer1_b0_conv1", 56, 64, 64, False, 1),
    ("layer1_conv1", 56, 256, 64, False, 2),
    ("layer1_conv3", 56, 64, 256, True, 3),
    ("layer1_down", 56, 64, 256, False, 1),
    ("layer2_b0_conv1", 56, 256, 128, False, 1),
    ("layer2_conv1", 28, 512, 128, False, 3),
    ("layer2_conv3", 28, 128, 512, True, 4),
    ("layer2_down", 28, 256, 512, False, 1),
    ("layer3_b0_conv1", 28, 512, 256, False, 1),
    ("layer3_conv1", 14, 1024, 256, False, 5),
    ("layer3_conv3", 14, 256, 1024, True, 6),
    ("layer3_down", 14, 512, 1024, False, 1),
    ("layer4_b0_conv1", 14, 1024, 512, False, 1),
    ("layer4_conv1", 7, 2048, 512, False, 2),
    ("layer4_conv3", 7, 512, 2048, True, 3),
    ("layer4_down", 7, 1024, 2048, False, 1),
]


def median_ms(fn, iters=20, warmup=3) -> float:
    """Median CUDA-event time of one call; a spin kernel queued first
    keeps the host's launch overhead out of the intervals."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


def device_split(fn, calls=5) -> dict:
    """Device ms per call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", name.removeprefix("void "))[0]
            name = name.split("::")[-1][:60]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: round(v / calls / 1e3, 5) for k, v in split.items()}


def digest(tensors) -> str:
    """sha256 of the outputs' bytes: equal digests in two processes (two
    versions of a kernel on the same seeded inputs) mean bitwise equal
    outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ulps(got, want) -> float:
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -8)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                              - 7)).max())


def rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def inputs(x_shape, w_shape, gen):
    k, n = w_shape[-2], w_shape[-1]
    rnd = lambda *s: torch.randn(s, device="cuda", generator=gen)  # noqa
    x = rnd(*x_shape).bfloat16()
    w = (rnd(*w_shape) * math.prod(w_shape[:-1]) ** -0.5).bfloat16()
    a = torch.rand(k, device="cuda", generator=gen) + 0.5
    b = rnd(k)
    c = 0.1 * rnd(n)
    dy = rnd(*x_shape[:-1], n).bfloat16()
    ds = 0.1 * rnd(2, n)
    return x, a, b, w, c, dy, ds


def time_m(cf, name, x_shape, w_shape, gen, emit) -> None:
    x, a, b, w, c, dy, ds = inputs(x_shape, w_shape, gen)
    y, _ = cf.conv3x3_fwd_plain(x, a, b, w, c, True, True)
    run = lambda: cf.conv3x3_bwd_cuda(x, a, b, w, c, y, dy, ds,  # noqa
                                      True, True)
    got, again = run(), run()
    want = cf.conv3x3_bwd_plain(x, a, b, w, c, y, dy, ds, True, True)
    errs = dict(dx_ulps=ulps(got[0], want[0]), dw_rel=rel(got[1], want[1]),
                dab_rel=rel(got[2], want[2]),
                bitwise_repeat=all(torch.equal(g, h)
                                   for g, h in zip(got, again)))
    ok = (errs["dx_ulps"] <= 1.0 and errs["dw_rel"] <= 1e-5
          and errs["dab_rel"] <= 1e-5 and errs["bitwise_repeat"])
    xv = x.permute(0, 3, 1, 2).detach().requires_grad_()
    wv = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out = F.conv2d(xv, wv, padding=1)
    dyv = dy.permute(0, 3, 1, 2)
    emit(kernel="conv3x3_bwd", case=name, x=list(x_shape), w=list(w_shape),
         ms=median_ms(run), cudnn_bwd_ms=median_ms(
             lambda: torch.autograd.grad(out, (xv, wv), dyv,
                                         retain_graph=True)),
         split_ms=device_split(run), ok=ok, sha256=digest(got), **errs)


def time_l(cf, name, x_shape, w_shape, gen, emit) -> None:
    x, a, b, w, c, _, _ = inputs(x_shape, w_shape, gen)
    run = lambda: cf.conv3x3_fwd_cuda(x, a, b, w, c, True, True)  # noqa
    got, again = run(), run()
    want = cf.conv3x3_fwd_plain(x, a, b, w, c, True, True)
    errs = dict(y_ulps=ulps(got[0], want[0]),
                stats_rel=rel(got[1], want[1]),
                bitwise_repeat=all(torch.equal(g, h)
                                   for g, h in zip(got, again)))
    ok = (errs["y_ulps"] <= 1.0 and errs["stats_rel"] <= 1e-5
          and errs["bitwise_repeat"])
    xv = x.permute(0, 3, 1, 2)
    wv = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    emit(kernel="conv3x3_fwd", case=name, x=list(x_shape), w=list(w_shape),
         ms=median_ms(run), cudnn_fwd_ms=median_ms(
             lambda: F.conv2d(xv, wv, padding=1)),
         split_ms=device_split(run), ok=ok, sha256=digest(got), **errs)


def fwd_bound_ms(m, k, n, affine) -> float:
    """The least time of a fused 1x1 forward on an H100: x, w, a, b and c
    read once, y and the stats written once, at 3.35 TB/s, or its
    products at 989 TFLOP/s, whichever is longer (``chip_smoke.py``'s
    ``_conv_bytes_flops``)."""
    n_bytes = (m * k + k * n + m * n) * 2 + ((2 * k if affine else 0)
                                             + 3 * n) * 4
    return max(n_bytes / HBM_BYTES_S, 2.0 * m * k * n / PEAK_BF16) * 1e3


def time_j(cf, gen, emit) -> None:
    """Kernel J at each of ``K_SHAPES`` in bf16 (with or without the
    affine + relu as the model runs them), beside cuDNN's 1x1 conv alone
    and the bound; then its step total weighted by launches
    (``conv1x1_fwd_step``); then the f32 kernel's digest at two shapes
    (``conv1x1_fwd_f32``), which shows it unchanged between versions."""
    total = {"ms": 0.0, "cudnn_fwd_ms": 0.0, "bound_ms": 0.0,
             "launches": 0}
    split_total = {}
    for name, side, k, n, affine, launches in K_SHAPES:
        x, a, b, w, c, _, _ = inputs((256, side, side, k), (k, n), gen)
        x2 = x.reshape(-1, k)
        if not affine:
            a = b = None
        run = lambda: cf.conv1x1_fwd_cuda(  # noqa: E731
            x2, a, b, w, c, affine, affine)
        got, again = run(), run()
        want = cf.conv1x1_fwd_plain(x2, a, b, w, c, affine, affine)
        errs = dict(y_ulps=ulps(got[0], want[0]),
                    stats_rel=rel(got[1], want[1]),
                    bitwise_repeat=all(torch.equal(g, h)
                                       for g, h in zip(got, again)))
        ok = (errs["y_ulps"] <= 1.0 and errs["stats_rel"] <= 1e-5
              and errs["bitwise_repeat"])
        xv = x.permute(0, 3, 1, 2)
        wv = w.t().reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last)
        row = dict(ms=median_ms(run), cudnn_fwd_ms=median_ms(
            lambda: F.conv2d(xv, wv)),
            bound_ms=fwd_bound_ms(x2.shape[0], k, n, affine),
            split_ms=device_split(run))
        emit(kernel="conv1x1_fwd", case=name, m=x2.shape[0], k=k, n=n,
             affine=affine, launches=launches, **row, ok=ok,
             sha256=digest(got), **errs)
        for key in ("ms", "cudnn_fwd_ms", "bound_ms"):
            total[key] += launches * row[key]
        total["launches"] += launches
        for kname, ms in row["split_ms"].items():
            split_total[kname] = split_total.get(kname, 0.0) + launches * ms
        del x, x2, got, again, want, xv, wv
        torch.cuda.empty_cache()
    emit(kernel="conv1x1_fwd_step", case="resnet50_b256",
         **{key: round(v, 5) for key, v in total.items()},
         split_ms={key: round(v, 5) for key, v in split_total.items()})
    for name, side, k, n, affine, _ in (K_SHAPES[2], K_SHAPES[-1]):
        x, a, b, w, c, _, _ = inputs((256, side, side, k), (k, n), gen)
        x2, w = x.reshape(-1, k).float(), w.float()
        if not affine:
            a = b = None
        got = cf.conv1x1_fwd_cuda(x2, a, b, w, c, affine, affine)
        want = cf.conv1x1_fwd_plain(x2, a, b, w, c, affine, affine)
        errs = dict(y_rel=rel(got[0], want[0]),
                    stats_rel=rel(got[1], want[1]))
        emit(kernel="conv1x1_fwd_f32", case=name, m=x2.shape[0], k=k, n=n,
             affine=affine, ok=max(errs.values()) <= 1e-5,
             sha256=digest(got), **errs)
        del x, x2, w, got, want
        torch.cuda.empty_cache()


def time_k(cf, gen, emit) -> None:
    """Kernel K at each of ``K_SHAPES``, then its step total: each row's
    ms, cuDNN's and device split weighted by its launches a step."""
    total = {"ms": 0.0, "cudnn_bwd_ms": 0.0, "launches": 0}
    split_total = {}
    for name, side, k, n, affine, launches in K_SHAPES:
        x, a, b, w, c, dy, ds = inputs((256, side, side, k), (k, n), gen)
        x2, dy2 = x.reshape(-1, k), dy.reshape(-1, n)
        if not affine:
            a = b = None
        y, _ = cf.conv1x1_fwd_plain(x2, a, b, w, c, affine, affine)
        run = lambda: cf.conv1x1_bwd_cuda(  # noqa: E731
            x2, a, b, w, c, y, dy2, ds, affine, affine)
        got, again = run(), run()
        want = cf.conv1x1_bwd_plain(x2, a, b, w, c, y, dy2, ds, affine,
                                    affine)
        errs = dict(dx_ulps=ulps(got[0], want[0]), dw_rel=rel(got[1], want[1]),
                    dab_rel=rel(got[2], want[2]) if affine else 0.0,
                    bitwise_repeat=all(
                        (g is None and h is None) or torch.equal(g, h)
                        for g, h in zip(got, again)))
        ok = (errs["dx_ulps"] <= 1.0 and errs["dw_rel"] <= 1e-5
              and errs["dab_rel"] <= 1e-5 and errs["bitwise_repeat"])
        xv = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wv = w.t().reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        out = F.conv2d(xv, wv)
        dyv = dy.permute(0, 3, 1, 2)
        row = dict(ms=median_ms(run), cudnn_bwd_ms=median_ms(
            lambda: torch.autograd.grad(out, (xv, wv), dyv,
                                        retain_graph=True)),
            split_ms=device_split(run))
        emit(kernel="conv1x1_bwd", case=name, m=x2.shape[0], k=k, n=n,
             affine=affine, launches=launches, **row, ok=ok,
             sha256=digest([t for t in got if t is not None]), **errs)
        total["ms"] += launches * row["ms"]
        total["cudnn_bwd_ms"] += launches * row["cudnn_bwd_ms"]
        total["launches"] += launches
        for kname, ms in row["split_ms"].items():
            split_total[kname] = split_total.get(kname, 0.0) + launches * ms
        del x, x2, dy, dy2, y, got, again, want, out, xv, wv
        torch.cuda.empty_cache()
    emit(kernel="conv1x1_bwd_step", case="resnet50_b256",
         **{key: round(v, 5) for key, v in total.items()},
         split_ms={key: round(v, 5) for key, v in split_total.items()})


def time_rn50(emit) -> None:
    """``chip_smoke.py``'s ``[rn50_train]`` phase of the ``--root``
    checkout (ResNet-50 at 224 px, batch 256, 2 warm-up and 8 timed steps
    on one seeded batch, its losses and launches checked); its line is
    printed and its step time, images/s, MFU and peak memory emitted."""
    import chip_smoke
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke.phase_rn50_train()
    print(buf.getvalue(), end="", flush=True)
    fields = re.findall(r"(step_ms_median|images_per_s|mfu|peak_mem_gb)="
                        r"([0-9.]+)", buf.getvalue())
    emit(kernel="rn50_train", case="224px_b256",
         **{k: float(v) for k, v in fields})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--only", default="j,k,l,m",
                        help="comma-separated kernels to time (default all)")
    parser.add_argument("--rn50", action="store_true",
                        help="run the checkout's rn50_train phase instead "
                        "of timing the kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("conv_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import conv_fused as cf
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    def emit(**fields):
        row = dict(tag=args.tag, card=card, **fields)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if args.rn50:
        time_rn50(emit)
        return 0
    only = set(args.only.split(","))
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, x_shape, w_shape in M_SHAPES:
        if "l" in only:
            time_l(cf, name, x_shape, w_shape, gen, emit)
        if "m" in only:
            time_m(cf, name, x_shape, w_shape, gen, emit)
        torch.cuda.empty_cache()
    if "j" in only:
        time_j(cf, gen, emit)
    if "k" in only:
        time_k(cf, gen, emit)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
