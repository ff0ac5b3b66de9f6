#!/usr/bin/env python3
"""Chip smoke test of apex_tpu_torch on one NVIDIA GPU (written for an H100).

Usage: ``python3 chip_smoke.py [--profile]`` from the repository
root. It needs one CUDA device and exits non-zero without one. Phases, each
printing its own lines and raising on failure:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel from ``apex_tpu_torch/csrc``;
3. kernel A — LayerNorm forward vs its plain PyTorch version;
4. kernel B — flash attention forward vs its plain version;
5. kernel C — paged decode attention vs its plain version;
6. serve    — GPT-2 124M (bf16, random weights from a seed) serves 16
              greedy requests through ``InferenceEngine``; every kernel's
              launch counter, read over this phase alone, must be > 0;
7. card vs CPU — one f32 request gives the same greedy tokens on the card
              as the plain path on the CPU.

Then one JSON line of per-kernel numbers (launches from phase 6; times from
CUDA events in this run; ``bound_ms`` from this run's shapes over the H100's
published peaks), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2 ** 20
SPIN_CYCLES = 200_000_000          # ~0.1 s at the H100's ~2 GHz

GPT2 = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
            vocab_size=50304, max_position_embeddings=1024)
PROMPT_LENS = (64, 128, 256, 512, 700)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of one call, from CUDA events around each call.
    A spin kernel queued first keeps the card busy while the host enqueues
    every call, so the events time the device work and not the host's
    launch overhead. With ``cold`` the L2 is flushed before every call
    (the caller would find its operands in device memory)."""

    def __init__(self):
        self._flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                                  device="cuda")

    def __call__(self, fn, *, iters=30, warmup=3, cold=False) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            if cold:
                self._flush.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        return times[len(times) // 2]


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the bf16 ulp at the larger of the
    two, that magnitude floored at 2^-8: where ``x_hat * w + b`` cancels
    to near zero, an fp32 rounding difference (a fused multiply-add
    against a separate multiply and add) is larger than the bf16 ulp of
    the tiny result."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def check_close(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """A kernel's output against its plain version's: both compute in
    fp32 and round once to the output dtype (the plain version is run on
    the inputs cast to fp32), so bf16 may differ by one rounding step,
    1 bf16 ulp; f32 by summation order only, atol 1e-4."""
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        return ulps, ulps <= 1.0, "1 bf16 ulp"
    return 0.0, float((got - want).abs().max()) <= 1e-4, "atol 1e-4"


def phase_device() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build() -> None:
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds:.2f}",
        sources=len(_build._sources()))


def phase_layer_norm(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd_cuda,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    h = GPT2["hidden_size"]
    w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
    b = 0.1 * torch.randn(h, device="cuda", generator=g)
    record = None
    # [8, 768]: every decode step (2 per layer + final); [768, 768]: the
    # largest prefill bucket; [8*768, 768]: a bulk shape
    for rows, dtype in ((8, torch.bfloat16), (768, torch.bfloat16),
                        (8 * 768, torch.bfloat16), (8 * 768, torch.float32)):
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        wd, bd = w.to(dtype), b.to(dtype)
        y, mean, iv = layer_norm_fwd_cuda(x, wd, bd, 1e-5, False, dtype)
        ry, rmean, riv = layer_norm_fwd_plain(x, wd, bd, 1e-5, False, dtype)
        torch.cuda.synchronize()
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((iv - riv).abs().max()))
        ulps, ok, tol = check_close(y, ry)
        if not ok or stat_err > 1e-4:
            raise AssertionError(
                f"layer_norm_fwd [{rows},{h}] {dtype}: max err {err} "
                f"({ulps} ulp), stats err {stat_err} — tolerance {tol}")
        esz = x.element_size()
        n_bytes = 2 * rows * h * esz + 2 * h * esz + 2 * rows * 4
        bms, by = bound_ms(n_bytes, 8.0 * rows * h, dtype)
        ms = timer(lambda: layer_norm_fwd_cuda(x, wd, bd, 1e-5, False, dtype))
        plain = timer(lambda: layer_norm_fwd_plain(x, wd, bd, 1e-5, False,
                                                   dtype))
        lib = timer(lambda: F.layer_norm(x, (h,), wd, bd, 1e-5))
        log("kernel_a", shape=f"[{rows},{h}]", dtype=str(dtype)[6:],
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            ms=f"{ms:.5f}",
            plain_ms=f"{plain:.5f}", library_ms=f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by)
        if rows == 8 and dtype == torch.bfloat16:
            record = dict(name="layer_norm_fwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_fwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:50",
                          shape=f"x[{rows},{h}] bf16 affine+bias",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


def _visible_pairs(sq, sk, causal, window, kv_len):
    off = sk - sq
    total = 0
    for r in range(sq):
        hi = min(kv_len, r + off + 1) if causal else kv_len
        lo = max(0, r + off - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def phase_flash(timer: Timer) -> dict:
    from apex_tpu_torch.ops.attention import flash_fwd_cuda, mha_plain
    g = torch.Generator(device="cuda").manual_seed(2)
    record = None
    # (heads, kv_heads, s, window, dtype): the serve buckets at GPT-2
    # widths, a GQA and a sliding-window case, and one f32 check
    cases = [(12, 12, s, None, torch.bfloat16) for s in (64, 128, 256, 512,
                                                         768)]
    cases += [(12, 4, 512, None, torch.bfloat16),
              (12, 12, 768, 256, torch.bfloat16),
              (12, 12, 768, None, torch.float32)]
    for h, kvh, s, window, dtype in cases:
        d = 64
        q = torch.randn(1, h, s, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(1, kvh, s, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(1, kvh, s, d, device="cuda", generator=g).to(dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_fwd_cuda(q, k, v, None, scale, True, window)
        ro = mha_plain(q.float(), k.float(), v.float(), None, scale, True,
                       window).to(dtype)
        torch.cuda.synchronize()
        err = float((o.float() - ro.float()).abs().max())
        ulps, ok, tol = check_close(o, ro)
        if not ok or not torch.isfinite(lse).all():
            raise AssertionError(f"flash_fwd h={h} kvh={kvh} s={s} "
                                 f"window={window} {dtype}: max err {err} "
                                 f"({ulps} ulp) — tolerance {tol}")
        esz = q.element_size()
        pairs = _visible_pairs(s, s, True, window, s)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * esz + h * s * 4
        bms, by = bound_ms(n_bytes, 4.0 * d * h * pairs, dtype)
        ms = timer(lambda: flash_fwd_cuda(q, k, v, None, scale, True, window))
        plain = timer(lambda: mha_plain(q, k, v, None, scale, True, window),
                      iters=10)
        if window is None:
            gqa = {"enable_gqa": True} if kvh != h else {}
            lib = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, **gqa))
        else:
            idx = torch.arange(s, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & \
                (idx[None, :] > idx[:, None] - window)
            lib = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
        log("kernel_b", shape=f"b1 h{h} kvh{kvh} s{s} d{d}",
            window=window, dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
            ulps=ulps, tol=tol.replace(" ", "_"), ms=f"{ms:.5f}",
            plain_ms=f"{plain:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{bms:.5f}", bound_by=by)
        if (h, kvh, s, window, dtype) == (12, 12, 768, None, torch.bfloat16):
            record = dict(name="flash_fwd", route="cuda",
                          source="apex_tpu_torch/csrc/flash_fwd.cu",
                          replaces="apex_tpu/ops/attention.py:266",
                          shape="q,k,v[1,12,768,64] bf16 causal",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


def phase_decode(timer: Timer) -> dict:
    from apex_tpu_torch.ops.decode_attention import (append_rows,
                                                     decode_plain, page_pool,
                                                     paged_decode_cuda)
    g = torch.Generator(device="cuda").manual_seed(3)
    b, hl, dh, ps, max_len = 8, 12, 64, 64, 768
    pps = max_len // ps
    n_pages = b * pps
    f = hl * dh
    positions = torch.tensor([63, 64, 200, 700] * 2, dtype=torch.int32)
    # each slot maps the pages its rows [0, pos] need, from a shuffled
    # pool; the rest of its row is the sentinel n_pages
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(3))
    table = torch.full((b, pps), n_pages, dtype=torch.int32)
    used = 0
    for r in range(b):
        need = int(positions[r]) // ps + 1
        table[r, :need] = perm[used:used + need]
        used += need
    record = None
    for dtype in (torch.bfloat16, torch.float32):
        kp = page_pool(n_pages, ps, f, dtype, "cuda")
        vp = page_pool(n_pages, ps, f, dtype, "cuda")
        kp.copy_(torch.randn(kp.shape, device="cuda", generator=g))
        vp.copy_(torch.randn(vp.shape, device="cuda", generator=g))
        q = torch.randn(b, hl, dh, device="cuda", generator=g).to(dtype)
        rows = torch.randn(2, b, f, device="cuda", generator=g).to(dtype)
        pt, pos = table.cuda(), positions.cuda()
        append_rows(kp, rows[0], pt, pos, ps)
        append_rows(vp, rows[1], pt, pos, ps)
        ctx = paged_decode_cuda(q, kp, vp, pt, pos, 1, None)
        ref = decode_plain(q.float(), kp.float(), vp.float(), pt, pos, 1,
                           None).to(dtype)
        torch.cuda.synchronize()
        err = float((ctx.float() - ref.float()).abs().max())
        ulps, ok, tol = check_close(ctx, ref)
        if not ok:
            raise AssertionError(f"paged_decode {dtype}: max err {err} "
                                 f"({ulps} ulp) — tolerance {tol}")
        mapped = sum(int(p) // ps + 1 for p in positions)
        esz = q.element_size()
        n_bytes = (2 * mapped * ps * f + 2 * b * f) * esz + table.numel() \
            * 4 + b * 4
        visible = sum(int(p) + 1 for p in positions)
        bms, by = bound_ms(n_bytes, 4.0 * dh * hl * visible, dtype)
        ms = timer(lambda: paged_decode_cuda(q, kp, vp, pt, pos, 1, None),
                   cold=True)
        plain = timer(lambda: decode_plain(q, kp, vp, pt, pos, 1, None),
                      cold=True, iters=10)
        log("kernel_c", shape=f"b{b} heads{hl} dh{dh} page{ps}",
            positions=[int(p) for p in positions[:4]], dtype=str(dtype)[6:],
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}", library_ms=None,
            bound_ms=f"{bms:.5f}", bound_by=by, mapped_pages=mapped)
        if dtype == torch.bfloat16:
            record = dict(name="paged_decode", route="cuda",
                          source="apex_tpu_torch/csrc/paged_decode.cu",
                          replaces="apex_tpu/ops/decode_attention.py:272",
                          shape=f"b{b} heads{hl} dh{dh} page{ps} bf16 cold L2",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=None)
    return record


def _requests(n, vocab, max_new, seed):
    from apex_tpu_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(
        0, vocab, (PROMPT_LENS[i % len(PROMPT_LENS)],), generator=g).tolist(),
        max_new_tokens=max_new) for i in range(n)]


def profile_serve(model, ecfg) -> None:
    """Where a serve's time goes: torch.profiler over 8 requests on a fresh
    engine — device-busy share of the wall time and the kernels by device
    time. Costs host time while on, so its wall is not the serve phase's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import InferenceEngine
    engine = InferenceEngine(model, ecfg)
    requests = _requests(8, model.config.vocab_size, 16, 7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels only (operator rows would count their kernels twice)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per_kernel.values()) / 1e6
    log("profile", requests=8, wall_s=f"{wall:.3f}",
        device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.3f}",
        decode_steps=engine.metrics.counters()["decode_steps"])
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (calls, us) in top:
        log("profile_kernel", device_ms=f"{us / 1e3:.3f}", calls=calls,
            name=name[:90].replace(" ", "_"))


def phase_serve(profile: bool = False) -> dict:
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**GPT2, params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    ecfg = EngineConfig(max_slots=8, max_len=768, page_size=64,
                        prefix_cache=False)
    # warm-up on its own engine: cuBLAS handles and first-call costs
    InferenceEngine(model, ecfg).serve(_requests(2, cfg.vocab_size, 4, 9))
    engine = InferenceEngine(model, ecfg)
    requests = _requests(16, cfg.vocab_size, 32, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    bad = [r.finish_reason for r in results
           if r.finish_reason not in ("length", "eos")]
    if len(results) != 16 or bad:
        raise AssertionError(f"serve: {len(results)} results, bad finish "
                             f"reasons {bad}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")
    tokens = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft_s for r in results)
    step = engine.metrics.histogram("decode_step_s")
    steps = engine.metrics.counters()["decode_steps"]
    log("serve", model="gpt2-124m bf16 random-init", requests=16,
        tokens=tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{tokens / wall:.1f}",
        ttft_p50_ms=f"{1e3 * ttft[len(ttft) // 2]:.2f}",
        decode_ms_per_step=f"{1e3 * step.sum / step.count:.3f}",
        decode_steps=steps, prefills=engine.metrics.counters()["prefills"],
        launches=json.dumps(launches).replace(" ", ""))
    if profile:
        profile_serve(model, ecfg)
    return launches


def phase_card_vs_cpu() -> None:
    """Runs with TF32 off (set in ``main``), so the card's f32 GEMMs are
    f32 as on the CPU."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    cfg = TransformerConfig(**GPT2)                       # f32 throughout
    ecfg = EngineConfig(max_slots=1, max_len=128, page_size=64,
                        prefix_cache=False)
    out = {}
    for device in ("cuda", "cpu"):
        model = GPTModel(cfg, device=device,
                         generator=torch.Generator().manual_seed(0))
        req = _requests(1, cfg.vocab_size, 8, 4)[0]
        out[device] = InferenceEngine(model, ecfg, device=device).serve(
            [req])[0].tokens
    if out["cuda"] != out["cpu"] or len(out["cuda"]) != 8:
        raise AssertionError(f"card vs CPU greedy tokens differ: {out}")
    log("card_vs_cpu", prompt_len=64, tokens=out["cuda"], equal=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the serve phase, trace a second serve "
                        "with torch.profiler and print its breakdown")
    args = parser.parse_args()
    phase_device()
    # fp32 comparisons hold to fp32 GEMMs, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    timer = Timer()
    records = [phase_layer_norm(timer), phase_flash(timer),
               phase_decode(timer)]
    launches = phase_serve(args.profile)
    phase_card_vs_cpu()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    kernels = [{k: rec[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}
        for rec in records]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
