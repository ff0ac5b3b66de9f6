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
6. kernel D — LayerNorm backward vs its plain version;
7. kernel E — packed-QKV flash forward vs its plain version (GQA, RoPE,
              window, kv_lengths, and dropout whose keep mask must equal
              ``hash_keep``'s exactly);
8. kernel F — packed-QKV flash backward vs its plain version;
9. serve    — GPT-2 124M (bf16, random weights from a seed) serves 16
              greedy requests through ``InferenceEngine``; the launch
              counters of its kernels (A, B, C), read over this phase
              alone, must be > 0;
10. card vs CPU — one f32 request gives the same greedy tokens on the card
              as the plain path on the CPU;
11. train   — GPT-2 124M in the ``bench.py`` configuration (bf16 compute,
              fp32 params, b 8, s 1024, FusedAdam lr 1e-4) takes 2 + 8
              steps of ``make_train_step`` on a fixed seeded batch; every
              loss finite, the last below the first, and Kernels A, D, E,
              F launched exactly 25, 25, 12 and 12 times a step;
12. train card vs CPU — a small f32 GPT (TF32 off) trains 3 steps on the
              card and on the CPU from the same seed: losses and every
              step-1 gradient leaf agree.

Then one JSON line of per-kernel numbers (launches from the phase that
drives each kernel's slice: serve for A-C, train for D-F, with both paths'
counts in ``launches_by_path``; times from CUDA events in this run;
``bound_ms`` from this run's shapes over the H100's published peaks), and
last ``{"ok": true, "device": {...}}``.
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
SERVE_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_decode")
#: launches a GPT-2 124M training step must make (2 LN per layer + final)
TRAIN_KERNELS = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                 "flash_packed_fwd": 12, "flash_packed_bwd": 12}
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 8


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


def phase_layer_norm_bwd(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    h = GPT2["hidden_size"]
    rows = TRAIN_BATCH * TRAIN_SEQ
    w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
    b = 0.1 * torch.randn(h, device="cuda", generator=g)
    record = None
    # the training block's LN: bf16 x and dy over fp32 weight and bias
    # (out_dtype=x.dtype), then all-f32, then RMSNorm
    for dtype, is_rms in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        dy = torch.randn(rows, h, device="cuda", generator=g).to(dtype)
        bias = None if is_rms else b
        _, mean, iv = layer_norm_fwd_plain(x, w, bias, 1e-5, is_rms, dtype)
        dx, dw, db = layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms,
                                         bias is not None)
        rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean,
                                             iv, w, is_rms, bias is not None)
        torch.cuda.synchronize()
        rdx = rdx.to(dtype)
        err = float((dx.float() - rdx.float()).abs().max())
        ulps, ok, tol = check_close(dx, rdx)
        # dw/db: fp32 sums of 8192 rows in another order
        dw_err = max(float(((dw - rdw).abs() / (1.0 + rdw.abs())).max()),
                     0.0 if db is None else
                     float(((db - rdb).abs() / (1.0 + rdb.abs())).max()))
        if not ok or dw_err > 1e-4:
            raise AssertionError(
                f"layer_norm_bwd [{rows},{h}] {dtype} rms={is_rms}: dx err "
                f"{err} ({ulps} ulp, tolerance {tol}), dw/db rel err "
                f"{dw_err} (tolerance 1e-4)")
        esz = x.element_size()
        n_bytes = 3 * rows * h * esz + 2 * rows * 4 + h * 4 + \
            (1 if is_rms else 2) * h * 4
        bms, by = bound_ms(n_bytes, 12.0 * rows * h, dtype)
        ms = timer(lambda: layer_norm_bwd_cuda(dy, x, mean, iv, w, is_rms,
                                               bias is not None))
        plain = timer(lambda: layer_norm_bwd_plain(dy, x, mean, iv, w,
                                                   is_rms, bias is not None))
        lib = None
        if not is_rms:
            # the library's own saved statistics (their dtype is its choice)
            wd, bd = w.to(dtype), b.to(dtype)
            _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], wd, bd,
                                                               1e-5)
            lib = timer(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [h], lmean, lrstd, wd, bd, [True, True, True]))
        log("kernel_d", shape=f"[{rows},{h}]", dtype=str(dtype)[6:],
            rms=is_rms, max_abs_err=f"{err:.3e}", ulps=ulps,
            tol=tol.replace(" ", "_"), dw_db_rel_err=f"{dw_err:.2e}",
            ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by)
        if dtype == torch.bfloat16 and not is_rms:
            record = dict(name="layer_norm_bwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_bwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:151",
                          shape=f"dy,x[{rows},{h}] bf16, w,b fp32",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


#: (name, b, s, groups, qpg, d, causal, kv_lengths, window, rot, rate,
#: dtype): the GPT-2 training shape in bf16 (the timed record) and f32,
#: then the corner cases at fewer rows
PACKED_CASES = [
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.bfloat16),
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.float32),
    ("gqa_qpg2", 2, 512, 6, 2, 64, True, None, None, 0, 0.0, torch.bfloat16),
    ("rope_half", 2, 512, 12, 1, 64, True, None, None, 32, 0.0,
     torch.bfloat16),
    ("window_256", 2, 1024, 12, 1, 64, True, None, 256, 0, 0.0,
     torch.bfloat16),
    ("kv_lengths_0", 3, 512, 12, 1, 64, False, [512, 200, 0], None, 0, 0.0,
     torch.bfloat16),
    ("dropout_0.1", 2, 512, 12, 1, 64, True, None, None, 0, 0.1,
     torch.bfloat16),
    ("dropout_0.1", 2, 512, 12, 1, 64, True, None, None, 0, 0.1,
     torch.float32),
]
DROPOUT_SEED = -1234567


def _packed_unpacked(qkv, b, s, groups, qpg, d):
    """q [b, H, s, d], k/v [b, G, s, d], contiguous, for the library call."""
    t = qkv.reshape(s, b, groups, qpg + 2, d)
    q = t[:, :, :, :qpg].reshape(s, b, groups * qpg, d)
    return (x.permute(1, 2, 0, 3).contiguous()
            for x in (q, t[:, :, :, qpg], t[:, :, :, qpg + 1]))


def _check_dropout_mask() -> None:
    """With v = I per group (s == d) and a non-causal softmax (every p >
    0), o[i, j] = keep[i, j] * p[i, j] / (1 - rate): Kernel E's keep mask
    is read off and must equal ``hash_keep``'s bit for bit."""
    from apex_tpu_torch.ops.attention import (drop_combo,
                                              flash_packed_fwd_cuda,
                                              hash_keep)
    g = torch.Generator(device="cuda").manual_seed(6)
    b, s, groups, d, rate = 2, 64, 12, 64, 0.1
    q = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    k = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    eye = torch.eye(s, device="cuda")[:, None, None, None, :].expand(
        s, b, groups, 1, d)
    qkv = torch.cat([q, k, eye], dim=3).reshape(s, b, -1).contiguous()
    o, _ = flash_packed_fwd_cuda(qkv, None, None, DROPOUT_SEED, rate, 0.125,
                                 False, None, 1, d)
    got = (o.reshape(s, b, groups, d) != 0).permute(1, 2, 0, 3).cpu()
    combo = drop_combo(torch.arange(b)[:, None, None, None],
                       torch.arange(groups)[None, :, None, None])
    want = hash_keep(DROPOUT_SEED, combo, (b, groups, s, s), rate)
    mismatched = int((got != want).sum())
    if mismatched:
        raise AssertionError(f"dropout keep mask differs from hash_keep at "
                             f"{mismatched} of {want.numel()} positions")
    log("kernel_e_dropout_mask", shape=f"b{b} heads{groups} s{s}",
        rate=rate, seed=DROPOUT_SEED, kept=int(got.sum()),
        positions=want.numel(), mismatched=0)


def phase_packed(timer: Timer) -> tuple:
    """Kernels E and F: every case against the plain versions (the
    forward's o and lse, then the backward's dqkv on the plain forward's
    o and lse); the GPT-2 bf16 case is timed."""
    from apex_tpu_torch.ops.attention import (flash_packed_bwd_cuda,
                                              flash_packed_bwd_plain,
                                              flash_packed_fwd_cuda,
                                              flash_packed_fwd_plain)
    from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
    gen = torch.Generator(device="cuda").manual_seed(5)
    rec_e = rec_f = None
    for (name, b, s, groups, qpg, d, causal, kvl, window, rot, rate,
         dtype) in PACKED_CASES:
        qkv = torch.randn(s, b, groups * (qpg + 2) * d, device="cuda",
                          generator=gen).to(dtype)
        do = torch.randn(s, b, groups * qpg * d, device="cuda",
                         generator=gen).to(dtype)
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        rope = (None if not rot else rope_tables(
            rope_freqs(0, s, rot, 10000.0, device="cuda"), s, d))
        seed = DROPOUT_SEED if rate else None
        args = (kvl_t, rope, seed, rate, 1.0 / math.sqrt(d), causal, window,
                qpg, d)
        # the plain versions compute in fp32 past the RoPE rounding (part
        # of the function) and round once at the end
        o, lse = flash_packed_fwd_cuda(qkv, *args)
        ro, rlse = flash_packed_fwd_plain(qkv, *args)
        dqkv = flash_packed_bwd_cuda(qkv, do, ro, rlse, *args)
        rdqkv = flash_packed_bwd_plain(qkv, do, ro, rlse, *args)
        torch.cuda.synchronize()
        errs = {}
        for kname, got, want in (("e", o, ro), ("f", dqkv, rdqkv)):
            err = float((got.float() - want.float()).abs().max())
            ulps, ok, tol = check_close(got, want)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"kernel {kname} {name} {dtype}: max err {err} "
                    f"({ulps} ulp) — tolerance {tol}")
            errs[kname] = (err, ulps, tol)
        lse_err = float((lse - rlse).abs().max())
        if lse_err > 1e-4:
            raise AssertionError(f"kernel e {name} {dtype}: lse err "
                                 f"{lse_err} — tolerance 1e-4")
        if kvl is not None and 0 in kvl:
            row = kvl.index(0)
            if o[:, row].any() or dqkv[:, row].any() or \
                    not bool((lse[row] == 1e30).all()):
                raise AssertionError(f"kernel e/f {name}: the batch row "
                                     f"with kv_length 0 is not zero")
        timed = name == "gpt2_train" and dtype == torch.bfloat16
        fields = {}
        if timed:
            esz = qkv.element_size()
            pairs = _visible_pairs(s, s, causal, window, s)
            heads = groups * qpg
            fwd_bytes = (qkv.numel() + o.numel()) * esz + lse.numel() * 4
            bwd_bytes = (2 * qkv.numel() + 2 * o.numel()) * esz \
                + lse.numel() * 4
            bms_e, by_e = bound_ms(fwd_bytes, 4.0 * d * heads * b * pairs,
                                   dtype)
            bms_f, by_f = bound_ms(bwd_bytes, 10.0 * d * heads * b * pairs,
                                   dtype)
            ms_e = timer(lambda: flash_packed_fwd_cuda(qkv, *args), iters=10)
            ms_f = timer(lambda: flash_packed_bwd_cuda(qkv, do, ro, rlse,
                                                       *args), iters=10)
            plain_e = timer(lambda: flash_packed_fwd_plain(qkv, *args),
                            iters=5, warmup=1)
            plain_f = timer(lambda: flash_packed_bwd_plain(qkv, do, ro, rlse,
                                                           *args),
                            iters=5, warmup=1)
            q4, k4, v4 = _packed_unpacked(qkv, b, s, groups, qpg, d)
            lib_e = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
            q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            do4 = do.reshape(s, b, heads, d).permute(1, 2, 0, 3).contiguous()
            lib_f = timer(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
            fields = dict(e=(ms_e, plain_e, lib_e, bms_e, by_e),
                          f=(ms_f, plain_f, lib_f, bms_f, by_f))
        for kname in ("e", "f"):
            err, ulps, tol = errs[kname]
            t = fields.get(kname)
            log(f"kernel_{kname}", case=name,
                shape=f"b{b} s{s} groups{groups} qpg{qpg} d{d}",
                causal=causal, window=window, kv_lengths=kvl, rot=rot,
                rate=rate, dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
                ulps=ulps, tol=tol.replace(" ", "_"),
                **({} if t is None else dict(
                    ms=f"{t[0]:.5f}", plain_ms=f"{t[1]:.5f}",
                    library_ms=f"{t[2]:.5f}", bound_ms=f"{t[3]:.5f}",
                    bound_by=t[4])))
        if timed:
            shape = f"qkv[{s},{b},{qkv.shape[-1]}] bf16 causal"
            ms_e, plain_e, lib_e, bms_e, by_e = fields["e"]
            ms_f, plain_f, lib_f, bms_f, by_f = fields["f"]
            rec_e = dict(name="flash_packed_fwd", route="cuda",
                         source="apex_tpu_torch/csrc/flash_packed_fwd.cu",
                         replaces="apex_tpu/ops/attention.py:832",
                         shape=shape, max_abs_err=errs["e"][0], ms=ms_e,
                         plain_ms=plain_e, bound_ms=bms_e, bound_by=by_e,
                         library_ms=lib_e)
            rec_f = dict(name="flash_packed_bwd", route="cuda",
                         source="apex_tpu_torch/csrc/flash_packed_bwd.cu",
                         replaces="apex_tpu/ops/attention.py:885",
                         shape=shape, max_abs_err=errs["f"][0], ms=ms_f,
                         plain_ms=plain_f, bound_ms=bms_f, bound_by=by_f,
                         library_ms=lib_f)
    _check_dropout_mask()
    return rec_e, rec_f


def _requests(n, vocab, max_new, seed):
    from apex_tpu_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(
        0, vocab, (PROMPT_LENS[i % len(PROMPT_LENS)],), generator=g).tolist(),
        max_new_tokens=max_new) for i in range(n)]


def profile_device(path: str, fn, describe=dict) -> None:
    """Where ``fn``'s time goes: torch.profiler around it — device-busy
    share of the wall time and the kernels by device time, printed as
    ``[profile]`` (with the fields ``describe()`` gives after the run) and
    ``[profile_kernel]`` lines tagged with ``path``. Costs host time while
    on, so its wall is not the phase's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels only (operator rows would count their kernels twice, and a
    # user annotation such as ``Optimizer.step`` spans its kernels)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per_kernel.values()) / 1e6
    log("profile", path=path, **describe(), wall_s=f"{wall:.3f}",
        device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.3f}",
        device_launches=sum(c for c, _ in per_kernel.values()))
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    for name, (calls, us) in ranked[:16]:
        log("profile_kernel", path=path, device_ms=f"{us / 1e3:.3f}",
            calls=calls, name=name[:90].replace(" ", "_"))
    rest = ranked[16:]
    log("profile_kernel", path=path,
        device_ms=f"{sum(us for _, (_, us) in rest) / 1e3:.3f}",
        calls=sum(c for _, (c, _) in rest), name=f"{len(rest)}_other_kernels")


def profile_serve(model, ecfg) -> None:
    """8 requests on a fresh engine under the profiler."""
    from apex_tpu_torch.serving import InferenceEngine
    engine = InferenceEngine(model, ecfg)
    requests = _requests(8, model.config.vocab_size, 16, 7)
    profile_device("serve", lambda: engine.serve(requests), lambda: dict(
        requests=8, decode_steps=engine.metrics.counters()["decode_steps"]))


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
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
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


def _train_model(cfg, device, seed=0):
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    model = GPTModel(cfg, device=device,
                     generator=torch.Generator().manual_seed(seed))
    opt = FusedAdam(model.parameters(), lr=1e-4)
    return model, make_train_step(lambda batch: model(*batch), opt)


def _train_batch(cfg, b, s, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    return tokens.to(device), labels.to(device)


def train_mfu(n_params, tokens, layers, seq, hidden, step_s) -> float:
    """Model FLOPs utilization against the H100's bf16 peak: the 6 N
    matmul term plus the causal attention term 6 L s h per token
    (``(6 N T + 6 L s h T) / step_time / 989e12``)."""
    flops = 6.0 * n_params * tokens + 6.0 * layers * seq * hidden * tokens
    return flops / step_s / PEAK_FLOPS[torch.bfloat16]


def phase_train(profile: bool = False) -> dict:
    """GPT-2 124M trains in the bench.py configuration: returns the
    kernels' launches over the phase. With ``profile``, two more steps run
    under the profiler once the counts are read."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    cfg = TransformerConfig(**GPT2, hidden_dropout=0.0, attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _train_model(cfg, "cuda")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    losses = [float(x) for x in losses]
    timed = sorted(times[WARMUP_STEPS:])
    step_s = timed[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wrong = {k: launches[k] for k, n in TRAIN_KERNELS.items()
             if launches[k] != n * steps}
    log("train", model="gpt2-124m bf16/fp32 random-init",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps,
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""),
        step_ms_median=f"{1e3 * step_s:.2f}",
        step_ms=json.dumps([round(1e3 * t, 2) for t in times]).replace(
            " ", ""),
        tokens_per_s=f"{tokens / step_s:.1f}",
        mfu=f"{train_mfu(n_params, tokens, GPT2['num_layers'], TRAIN_SEQ, GPT2['hidden_size'], step_s):.4f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        n_params=n_params,
        launches=json.dumps(launches).replace(" ", ""))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall on the fixed batch: "
                             f"{losses}")
    if wrong:
        raise AssertionError(
            f"train: launches over {steps} steps {wrong}, expected "
            f"{ {k: n * steps for k, n in TRAIN_KERNELS.items()} }")
    if profile:
        profile_device("train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=TRAIN_BATCH,
                                    seq=TRAIN_SEQ))
    return launches


def _grad_tree(model):
    return {name: p.grad.detach().cpu().clone()
            for name, p in model.named_parameters()}


def phase_train_card_vs_cpu() -> None:
    """A small f32 GPT trains 3 steps on the card (TF32 off, set in
    ``main``) and on the CPU from the same seed. Losses agree to 1e-5
    relative; every step-1 gradient leaf to atol 1e-5 + rtol 1e-4 (fp32
    sums in other orders, through the kernels on one side and the plain
    versions on the other)."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(num_layers=2, hidden_size=128,
                            num_attention_heads=2, vocab_size=512,
                            max_position_embeddings=128, hidden_dropout=0.0,
                            attention_dropout=0.0)
    losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        model, step = _train_model(cfg, device, seed=2)
        batch = _train_batch(cfg, 4, 96, device, seed=3)
        losses[device] = [float(step(batch))]
        grads[device] = _grad_tree(model)
        losses[device] += [float(step(batch)) for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    worst, worst_name = 0.0, None
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        excess = float(((got - want).abs() - 1e-4 * want.abs()).max())
        if excess > worst or worst_name is None:
            worst, worst_name = excess, name
    log("train_card_vs_cpu", layers=2, hidden=128, steps=3,
        losses_cuda=json.dumps(losses["cuda"]).replace(" ", ""),
        losses_cpu=json.dumps(losses["cpu"]).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", grad_leaves=len(grads["cpu"]),
        worst_grad_excess=f"{worst:.2e}", worst_leaf=worst_name)
    if rel > 1e-5 or worst > 1e-5:
        raise AssertionError(
            f"train card vs CPU: loss rel err {rel} (tolerance 1e-5), grad "
            f"leaf {worst_name} off by {worst} past atol 1e-5 + rtol 1e-4")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the serve and train phases, trace a "
                        "second serve and two more train steps with "
                        "torch.profiler and print their breakdowns")
    args = parser.parse_args()
    phase_device()
    # fp32 comparisons hold to fp32 GEMMs, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    timer = Timer()
    records = [phase_layer_norm(timer), phase_flash(timer),
               phase_decode(timer), phase_layer_norm_bwd(timer),
               *phase_packed(timer)]
    serve = phase_serve(args.profile)
    phase_card_vs_cpu()
    train = phase_train(args.profile)
    phase_train_card_vs_cpu()
    for rec in records:
        name = rec["name"]
        rec["launches"] = (serve if name in SERVE_KERNELS else train)[name]
        rec["launches_by_path"] = {"serve": serve[name], "train": train[name]}
    kernels = [{k: rec[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
        "launches_by_path")} for rec in records]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
