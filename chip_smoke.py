#!/usr/bin/env python3
"""Chip smoke test of apex_tpu_torch on one NVIDIA GPU (written for an H100).

Usage: ``python3 chip_smoke.py [--profile]`` from the repository
root. It needs one CUDA device and exits non-zero without one. Phases, each
printing its own lines and raising on failure:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel from ``apex_tpu_torch/csrc``;
3. kernel A — LayerNorm forward vs its plain PyTorch version: serving's
              bf16 shapes, f32, and the training block's mix (bf16 x over
              fp32 w and b into bf16 y) at [8192, 768] in LayerNorm and
              RMSNorm; two runs bitwise equal; the launch plan printed;
4. kernel B — flash attention forward vs its plain version;
5. kernel C — paged decode attention vs its plain version;
6. kernel D — LayerNorm backward vs its plain version: GPT-2's training
              rows in bf16 over fp32 w and b, f32 and RMSNorm, the T5
              decoder's [1824, 768] RMSNorm and a bf16 width off the
              16-byte path (h = 1020); two runs bitwise equal (dx, dw, db);
              the launch plan printed;
7. kernel E — packed-QKV flash forward vs its plain version (GQA, RoPE,
              window, kv_lengths, and dropout whose keep mask must equal
              ``hash_keep``'s exactly, in f32 and bf16); timed beside SDPA
              at the GPT-2 and the T5 encoder and decoder shapes, where
              two bf16 runs must be bitwise equal;
8. kernel F — packed-QKV flash backward vs its plain version (f32 atol
              1e-4; bf16, where both round ds and the dropped p as the JAX
              kernel does, 1 ulp plus one bf16 step of each rounded factor,
              at most 0.1% of the elements past 1 ulp); timed beside SDPA's
              backward at the GPT-2 shape, where two bf16 runs must be
              bitwise equal, and the f32 dqkv's sha256 printed;
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
              step-1 gradient leaf agree;
13. kernel G/H — the masked softmax forward and backward vs their plain
              versions: BERT's [16,1,512,512] padding mask with fully
              masked rows (which must be 1/k), a [b,1,1,s] key mask,
              causal [96,1024,1024], rows of 17, 1000 and 4097, scale != 1;
14. kernel I — the 4D flash backward vs its plain version: the T5
              cross-attention shape with kv_lengths, causal GQA at 1024,
              window 256, a kv_lengths row at 0, causal sq != sk; two runs
              bitwise equal; and Kernel B at the cross-attention shape;
15. bert_train — BERT-base (b 16, s 512, seeded padding masks, tokentype
              ids, FusedLAMB lr 1e-3 wd 0.01) takes 2 + 8 steps; every loss
              finite, the last below the first, and the launches a step of
              every kernel as the model's code implies (LN 26/26, softmax
              12/12, the flash kernels 0);
16. t5_train — an encoder-decoder at T5-base widths (12 + 12 layers,
              RMSNorm, ReLU, inputs 512 with seeded enc_lengths, targets
              114, b 16, FusedAdam lr 1e-4), the same checks (LN 62/62,
              packed 24/24, flash 12/12, softmax 0);
17. enc card vs CPU — a small f32 BERT with a padding mask and LAMB, and a
              small encoder-decoder with enc_lengths, train 3 steps on the
              card and on the CPU: losses and every step-1 gradient leaf
              agree;
18. kernel J/K — the fused 1x1 conv forward and backward vs their plain
              versions, f32 and bf16, with a random stats cotangent:
              ResNet-50's layer1 conv3 (affine + relu), layer4 conv1 and
              downsample (no affine; the downsample's 2M weights were
              gated off the TPU), and a 200-row tail in every (affine,
              relu) combination; two forward and two backward runs
              bitwise equal;
19. kernel L/M — the fused 3x3 conv forward and backward, the same checks
              at ResNet-50's four stride-1 3x3 shapes [256,56,56,64],
              [256,28,28,128], [256,14,14,256], [256,7,7,512] (the first
              and last gated off the TPU), an odd [3,5,9,16] -> 32 and a
              ragged [5,13,11,20] -> 36 (channels off L's and M's
              8-channel copies, pixels off their 128-pixel tiles);
20. rn50_train — ResNet-50 (224 px, batch 256, bf16 compute over fp32
              params, fused_conv, FusedSGD lr 0.1 momentum 0.9 wd 1e-4 with
              master weights) takes 2 + 8 steps; every loss finite, the
              last below the first, and Kernels J, K, L, M launched exactly
              36, 36, 13 and 13 times a step, every other kernel 0;
21. rn50 card vs CPU — ResNet-50 at 64 px, batch 4, 8 classes, f32:
              two fused blocks alone (layer1.1 and layer2.0: output, input
              and parameter gradients, new batch-norm state to 2e-5 of each
              leaf's largest magnitude), which with the checks of phases 18
              and 19 decide Kernels K and M; then, as a check of the
              model's wiring, the step-1 loss, every gradient leaf and the
              batch-norm state
              with ``zero_init_residual=False`` (gradients held to the
              noise floor that 1e-7 perturbations of the input show on the
              CPU), then three FusedSGD steps with the recipe's init.

Then one JSON line of per-kernel numbers (launches from the phase that
drives each kernel's slice: serve for A-C, train for D-F, bert_train for G
and H, t5_train for I, rn50_train for J-M, with every path's counts in
``launches_by_path``;
times from CUDA events in this run; ``bound_ms`` from this run's shapes
over the H100's published peaks), and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
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
#: kernels listed by name in a ``--profile`` breakdown (the rest summed)
PROFILE_TOP = 40

GPT2 = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
            vocab_size=50304, max_position_embeddings=1024)
PROMPT_LENS = (64, 128, 256, 512, 700)
SERVE_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_decode")
#: launches a GPT-2 124M training step must make (2 LN per layer + final)
TRAIN_KERNELS = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                 "flash_packed_fwd": 12, "flash_packed_bwd": 12}
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 8
#: every kernel's launch counter
ALL_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd",
               "flash_packed_fwd", "flash_packed_bwd", "paged_decode",
               "softmax_fwd", "softmax_bwd", "conv1x1_fwd", "conv1x1_bwd",
               "conv3x3_fwd", "conv3x3_bwd")
#: BERT-base (benchmarks/bert_lamb.py:20-27) and its launches a step: 2 LN
#: per layer, the final LN and the LM head's; one masked softmax per layer
BERT = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
            vocab_size=30528, max_position_embeddings=512)
BERT_BATCH, BERT_SEQ = 16, 512
BERT_KERNELS = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                "softmax_fwd": 12, "softmax_bwd": 12}
#: T5-base widths (the public t5-base config) with the JAX model's learned
#: positions and biases; encoder 2 norms a layer + final, decoder 3 + final;
#: packed self-attention in both stacks, 4D flash in cross-attention
T5 = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
          ffn_hidden_size=3072, activation="relu", normalization="rmsnorm",
          vocab_size=32128, max_position_embeddings=512)
T5_BATCH, T5_ENC, T5_DEC = 16, 512, 114
T5_KERNELS = {"layer_norm_fwd": 62, "layer_norm_bwd": 62,
              "flash_packed_fwd": 24, "flash_packed_bwd": 24,
              "flash_fwd": 12, "flash_bwd": 12}
#: ResNet-50 as benchmarks/rn50_dp.py:21-31 trains it, on the fused path:
#: 16 bottlenecks run conv1 and conv3 through the 1x1 kernels and the 4
#: downsamples add 4; the 13 stride-1 conv2s take the 3x3 kernels (the 3
#: stride-2 ones keep cuDNN's conv)
RN50_BATCH, RN50_SIZE = 256, 224
RN50_KERNELS = {"conv1x1_fwd": 36, "conv1x1_bwd": 36, "conv3x3_fwd": 13,
                "conv3x3_bwd": 13}


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


def check_rounded_factors(got: torch.Tensor, want: torch.Tensor,
                          slack: torch.Tensor) -> tuple:
    """A bf16 flash backward that rounds ds and p to bf16 where the JAX
    kernels do, against its plain version on the same inputs: every
    element within 1 bf16 ulp plus ``slack``, one bf16 step of each
    rounded factor carried to the output (two fp32 summation orders may
    round a ds on a bf16 boundary to neighbouring values), and at most 0.1%
    of the elements past 1 ulp. Returns (max abs err, ulps, share past 1
    ulp, excess over the bound, ok)."""
    e = (got.float() - want.float()).abs()
    one = 2.0 ** -15 + 2.0 ** -7 * want.float().abs()
    past = float((e > one).float().mean())
    ok = bool((e <= one + slack).all()) and past <= 1e-3
    return (float(e.max()), bf16_ulps(got, want), past,
            float((e - one - slack).max()), ok)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes: equal digests from two versions of a
    kernel on the same seeded inputs mean bitwise equal outputs."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


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


def _plan_text(plan) -> str:
    """A LayerNorm kernel's launch plan as one log field."""
    return (f"{plan.path}:pieces{plan.pieces}:rows_a_warp{plan.rows_a_warp}"
            f":blocks{plan.blocks}")


#: (rows, x dtype, w/b dtype, RMSNorm): [8, 768] every decode step (2 per
#: layer + final); [768, 768] the largest prefill bucket; [8*768, 768] a
#: bulk shape (all with w, b and y in x's dtype, as serving runs them);
#: then the training block's mix, bf16 x over fp32 w and b into bf16 y
#: ([8192, 768]: GPT-2's and BERT's rows), LayerNorm and RMSNorm (T5)
LN_FWD_CASES = [(8, torch.bfloat16, torch.bfloat16, False),
                (768, torch.bfloat16, torch.bfloat16, False),
                (8 * 768, torch.bfloat16, torch.bfloat16, False),
                (8 * 768, torch.float32, torch.float32, False),
                (8192, torch.bfloat16, torch.float32, False),
                (8192, torch.bfloat16, torch.float32, True)]


def phase_layer_norm(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd_cuda,
                                               layer_norm_fwd_cuda_plan,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    h = GPT2["hidden_size"]
    w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
    b = 0.1 * torch.randn(h, device="cuda", generator=g)
    record = None
    for rows, dtype, wdt, is_rms in LN_FWD_CASES:
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        wd, bd = w.to(wdt), None if is_rms else b.to(wdt)
        run = lambda: layer_norm_fwd_cuda(x, wd, bd, 1e-5, is_rms,  # noqa
                                          dtype)
        y, mean, iv = run()
        again = run()
        ry, rmean, riv = layer_norm_fwd_plain(x.float(), wd, bd, 1e-5,
                                              is_rms, torch.float32)
        ry = ry.to(dtype)
        torch.cuda.synchronize()
        err = float((y.float() - ry.float()).abs().max())
        stat_err = max(float((mean - rmean).abs().max()),
                       float((iv - riv).abs().max()))
        ulps, ok, tol = check_close(y, ry)
        same = all(torch.equal(u, v) for u, v in zip((y, mean, iv), again))
        if not ok or stat_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_fwd [{rows},{h}] {dtype} w {wdt} rms={is_rms}: "
                f"max err {err} ({ulps} ulp), stats err {stat_err} — "
                f"tolerance {tol}, stats 1e-4; two runs bitwise equal: "
                f"{same}")
        esz = x.element_size()
        n_bytes = 2 * rows * h * esz + (1 if is_rms else 2) * h * \
            wd.element_size() + 2 * rows * 4
        bms, by = bound_ms(n_bytes, 8.0 * rows * h, dtype)
        ms = timer(run)
        plain = timer(lambda: layer_norm_fwd_plain(x, wd, bd, 1e-5, is_rms,
                                                   dtype))
        # the library call with w and b in x's dtype (F.rms_norm where
        # the installed PyTorch has it)
        lib = None
        if not is_rms:
            lib = timer(lambda: F.layer_norm(x, (h,), wd.to(dtype),
                                             bd.to(dtype), 1e-5))
        elif hasattr(F, "rms_norm"):
            lib = timer(lambda: F.rms_norm(x, (h,), wd.to(dtype), 1e-5))
        log("kernel_a", shape=f"[{rows},{h}]", dtype=str(dtype)[6:],
            w=str(wdt)[6:], rms=is_rms,
            plan=_plan_text(layer_norm_fwd_cuda_plan(x, y, wd, bd)),
            max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol.replace(" ", "_"),
            repeat_bitwise=same, ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by)
        if (rows, dtype, wdt, is_rms) == (8, torch.bfloat16, torch.bfloat16,
                                          False):
            record = dict(name="layer_norm_fwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_fwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:50",
                          shape=f"x[{rows},{h}] bf16 affine+bias",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


def _visible_spans(sq, sk, causal, window, kv_len):
    """The ``[lo, hi)`` keys each query row of one batch row sees."""
    off = sk - sq
    for r in range(sq):
        hi = min(kv_len, r + off + 1) if causal else min(kv_len, sk)
        lo = max(0, r + off - window + 1) if window else 0
        yield lo, hi


def _visible_pairs(sq, sk, causal, window, kv_len):
    return sum(max(0, hi - lo)
               for lo, hi in _visible_spans(sq, sk, causal, window, kv_len))


def _visible_rows_keys(sq, sk, causal, window, kv_len) -> tuple:
    """``(query rows that see a key, keys that some query row sees)`` of
    one batch row: the q and K/V rows the backward must read. Both span
    ends grow with the row, so the keys seen are a union of intervals."""
    rows = keys = end = 0
    for lo, hi in _visible_spans(sq, sk, causal, window, kv_len):
        if hi > lo:
            rows += 1
            keys += max(0, hi - max(lo, end))
            end = max(end, hi)
    return rows, keys


def phase_flash(timer: Timer) -> dict:
    from apex_tpu_torch.ops.attention import flash_fwd_cuda, flash_fwd_plain
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
        ro = flash_fwd_plain(q.float(), k.float(), v.float(), None, scale,
                             True, window)[0].to(dtype)
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
        plain = timer(lambda: flash_fwd_plain(q, k, v, None, scale, True,
                                              window),
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


#: (rows, h, dtype, RMSNorm): the training block's LN, bf16 x and dy over
#: fp32 weight and bias (out_dtype=x.dtype), then all-f32, then RMSNorm;
#: the T5 decoder's RMSNorm rows (16 x 114); a bf16 width off the 16-byte
#: path (h % 8 != 0: the element kernel)
LN_BWD_CASES = [(TRAIN_BATCH * TRAIN_SEQ, 768, torch.bfloat16, False),
                (TRAIN_BATCH * TRAIN_SEQ, 768, torch.float32, False),
                (TRAIN_BATCH * TRAIN_SEQ, 768, torch.bfloat16, True),
                (T5_BATCH * T5_DEC, 768, torch.bfloat16, True),
                (2048, 1020, torch.bfloat16, False)]


def phase_layer_norm_bwd(timer: Timer) -> dict:
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_cuda_plan,
                                               layer_norm_bwd_plain,
                                               layer_norm_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    record = None
    for rows, h, dtype, is_rms in LN_BWD_CASES:
        w = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=g)
        b = 0.1 * torch.randn(h, device="cuda", generator=g)
        x = (2.0 * torch.randn(rows, h, device="cuda", generator=g)
             + 0.5).to(dtype)
        dy = torch.randn(rows, h, device="cuda", generator=g).to(dtype)
        bias = None if is_rms else b
        _, mean, iv = layer_norm_fwd_plain(x, w, bias, 1e-5, is_rms, dtype)
        run = lambda: layer_norm_bwd_cuda(dy, x, mean, iv, w,  # noqa: E731
                                          is_rms, bias is not None)
        dx, dw, db = run()
        again = run()
        rdx, rdw, rdb = layer_norm_bwd_plain(dy.float(), x.float(), mean,
                                             iv, w, is_rms, bias is not None)
        torch.cuda.synchronize()
        rdx = rdx.to(dtype)
        err = float((dx.float() - rdx.float()).abs().max())
        ulps, ok, tol = check_close(dx, rdx)
        # dw/db: fp32 sums of the rows in another order
        dw_err = max(float(((dw - rdw).abs() / (1.0 + rdw.abs())).max()),
                     0.0 if db is None else
                     float(((db - rdb).abs() / (1.0 + rdb.abs())).max()))
        same = all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip((dx, dw, db), again))
        if not ok or dw_err > 1e-4 or not same:
            raise AssertionError(
                f"layer_norm_bwd [{rows},{h}] {dtype} rms={is_rms}: dx err "
                f"{err} ({ulps} ulp, tolerance {tol}), dw/db rel err "
                f"{dw_err} (tolerance 1e-4); two runs bitwise equal: {same}")
        esz = x.element_size()
        n_bytes = 3 * rows * h * esz + 2 * rows * 4 + h * 4 + \
            (1 if is_rms else 2) * h * 4
        bms, by = bound_ms(n_bytes, 12.0 * rows * h, dtype)
        ms = timer(run)
        ms_cold = timer(run, cold=True)
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
            rms=is_rms,
            plan=_plan_text(layer_norm_bwd_cuda_plan(dy, x, dx, w,
                                                     bias is not None)),
            max_abs_err=f"{err:.3e}", ulps=ulps,
            tol=tol.replace(" ", "_"), dw_db_rel_err=f"{dw_err:.2e}",
            repeat_bitwise=same, ms=f"{ms:.5f}", ms_cold=f"{ms_cold:.5f}",
            plain_ms=f"{plain:.5f}",
            library_ms=None if lib is None else f"{lib:.5f}",
            bound_ms=f"{bms:.5f}", bound_by=by, dx_sha256=digest(dx))
        if (rows, h, dtype, is_rms) == LN_BWD_CASES[0]:
            record = dict(name="layer_norm_bwd", route="cuda",
                          source="apex_tpu_torch/csrc/layer_norm_bwd.cu",
                          replaces="apex_tpu/ops/layer_norm.py:151",
                          shape=f"dy,x[{rows},{h}] bf16, w,b fp32",
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=lib)
    return record


#: (name, b, s, groups, qpg, d, causal, kv_lengths, window, rot, rate,
#: dtype): the GPT-2 training shape in bf16 (the timed record) and f32,
#: the T5 encoder (its seeded enc_lengths, as ``t5_train`` draws them) and
#: decoder self-attention shapes in bf16 (E timed beside SDPA), then the
#: corner cases at fewer rows
PACKED_CASES = [
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.bfloat16),
    ("gpt2_train", 8, 1024, 12, 1, 64, True, None, None, 0, 0.0,
     torch.float32),
    ("t5_encoder", 16, 512, 12, 1, 64, False, "enc_lengths", None, 0, 0.0,
     torch.bfloat16),
    ("t5_decoder", 16, 114, 12, 1, 64, True, None, None, 0, 0.0,
     torch.bfloat16),
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
#: cases whose Kernel E is timed beside SDPA (F at the GPT-2 shape only)
TIMED_E = ("gpt2_train", "t5_encoder", "t5_decoder")


def _packed_unpacked(qkv, b, s, groups, qpg, d):
    """q [b, H, s, d], k/v [b, G, s, d], contiguous, for the library call."""
    t = qkv.reshape(s, b, groups, qpg + 2, d)
    q = t[:, :, :, :qpg].reshape(s, b, groups * qpg, d)
    return (x.permute(1, 2, 0, 3).contiguous()
            for x in (q, t[:, :, :, qpg], t[:, :, :, qpg + 1]))


def _check_dropout_mask(dtype) -> None:
    """With v = I per group (s == d) and a non-causal softmax (every p >
    0), o[i, j] = keep[i, j] * p[i, j] / (1 - rate): Kernel E's keep mask
    is read off and must equal ``hash_keep``'s bit for bit (f32 and bf16
    take different kernels, each hashing on its own)."""
    from apex_tpu_torch.ops.attention import (drop_combo,
                                              flash_packed_fwd_cuda,
                                              hash_keep)
    g = torch.Generator(device="cuda").manual_seed(6)
    b, s, groups, d, rate = 2, 64, 12, 64, 0.1
    q = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    k = 0.1 * torch.randn(s, b, groups, 1, d, device="cuda", generator=g)
    eye = torch.eye(s, device="cuda")[:, None, None, None, :].expand(
        s, b, groups, 1, d)
    qkv = torch.cat([q, k, eye], dim=3).reshape(s, b, -1).to(
        dtype).contiguous()
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
        dtype=str(dtype)[6:], rate=rate, seed=DROPOUT_SEED, kept=int(got.sum()),
        positions=want.numel(), mismatched=0)


def phase_packed(timer: Timer) -> tuple:
    """Kernels E and F: every case against the plain versions (the
    forward's o and lse, then the backward's dqkv on the plain forward's
    o and lse). E and f32 F within ``check_close``'s tolerance; bf16 F
    (which rounds ds and the dropped p to bf16 where the JAX kernel does,
    as its plain version does) within 1 ulp plus
    ``flash_packed_bwd_rounding_slack`` with at most 0.1% of the elements
    past 1 ulp (``check_rounded_factors``). In bf16, E's GPT-2 and T5
    cases are timed beside SDPA and must repeat bitwise; F is timed at the
    GPT-2 shape and must repeat bitwise there, and its f32 dqkv digest is
    printed."""
    from apex_tpu_torch.ops.attention import (
        flash_packed_bwd_cuda, flash_packed_bwd_plain,
        flash_packed_bwd_rounding_slack, flash_packed_fwd_cuda,
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
        if kvl == "enc_lengths":
            kvl = _valid_lengths(b, s, 14).tolist()   # _t5_batch's seed 13
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        rope = (None if not rot else rope_tables(
            rope_freqs(0, s, rot, 10000.0, device="cuda"), s, d))
        seed = DROPOUT_SEED if rate else None
        args = (kvl_t, rope, seed, rate, 1.0 / math.sqrt(d), causal, window,
                qpg, d)
        # the plain versions compute in fp32 past the RoPE rounding (part
        # of the function), the backward's rounding of ds and the dropped p
        # as well, and round once at the end
        o, lse = flash_packed_fwd_cuda(qkv, *args)
        ro, rlse = flash_packed_fwd_plain(qkv, *args)
        dqkv = flash_packed_bwd_cuda(qkv, do, ro, rlse, *args)
        rdqkv = flash_packed_bwd_plain(qkv, do, ro, rlse, *args)
        torch.cuda.synchronize()
        errs = {}
        for kname, got, want in (("e", o, ro), ("f", dqkv, rdqkv)):
            err = float((got.float() - want.float()).abs().max())
            past = None
            if kname == "f" and dtype == torch.bfloat16:
                slack = flash_packed_bwd_rounding_slack(qkv, do, ro, rlse,
                                                        *args)
                err, ulps, past, excess, ok = check_rounded_factors(
                    got, want, slack)
                tol = "1 bf16 ulp+factor rounding"
                del slack
            else:
                ulps, ok, tol = check_close(got, want)
                excess = None
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"kernel {kname} {name} {dtype}: max err {err} "
                    f"({ulps} ulp, share past 1 ulp {past}, excess "
                    f"{excess}) — tolerance {tol}")
            errs[kname] = (err, ulps, tol, past)
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
        timed = name in TIMED_E and dtype == torch.bfloat16
        fields = {}
        f32_digest = (digest(dqkv) if name == "gpt2_train"
                      and dtype == torch.float32 else None)
        if timed:
            if not torch.equal(o, flash_packed_fwd_cuda(qkv, *args)[0]):
                raise AssertionError(f"kernel e {name}: two runs differ")
            esz = qkv.element_size()
            pairs = sum(_visible_pairs(s, s, causal, window,
                                       s if kvl is None else kvl[r])
                        for r in range(b))
            heads = groups * qpg
            fwd_bytes = (qkv.numel() + o.numel()) * esz + lse.numel() * 4
            bms_e, by_e = bound_ms(fwd_bytes, 4.0 * d * heads * pairs, dtype)
            ms_e = timer(lambda: flash_packed_fwd_cuda(qkv, *args), iters=10)
            plain_e = timer(lambda: flash_packed_fwd_plain(qkv, *args),
                            iters=5, warmup=1)
            q4, k4, v4 = _packed_unpacked(qkv, b, s, groups, qpg, d)
            mask = (None if kvl_t is None else
                    (torch.arange(s, device="cuda")[None, :]
                     < kvl_t[:, None])[:, None, None, :])
            lib_e = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=causal))
            fields = dict(e=(ms_e, plain_e, lib_e, bms_e, by_e))
        if timed and name == "gpt2_train":
            if not torch.equal(dqkv, flash_packed_bwd_cuda(qkv, do, ro, rlse,
                                                           *args)):
                raise AssertionError(f"kernel f {name}: two runs differ")
            bwd_bytes = (2 * qkv.numel() + 2 * o.numel()) * esz \
                + lse.numel() * 4
            bms_f, by_f = bound_ms(bwd_bytes, 10.0 * d * heads * pairs,
                                   dtype)
            ms_f = timer(lambda: flash_packed_bwd_cuda(qkv, do, ro, rlse,
                                                       *args), iters=10)
            plain_f = timer(lambda: flash_packed_bwd_plain(qkv, do, ro, rlse,
                                                           *args),
                            iters=5, warmup=1)
            q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            do4 = do.reshape(s, b, heads, d).permute(1, 2, 0, 3).contiguous()
            lib_f = timer(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
            fields["f"] = (ms_f, plain_f, lib_f, bms_f, by_f)
        for kname in ("e", "f"):
            err, ulps, tol, past = errs[kname]
            t = fields.get(kname)
            extra = {} if past is None else dict(
                share_past_1_ulp=f"{past:.2e}")
            if kname == "f" and f32_digest is not None:
                extra["dqkv_sha256"] = f32_digest
            if kname == "f" and t is not None:
                extra["bitwise_repeat"] = True
            log(f"kernel_{kname}", case=name,
                shape=f"b{b} s{s} groups{groups} qpg{qpg} d{d}",
                causal=causal, window=window, kv_lengths=kvl, rot=rot,
                rate=rate, dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
                ulps=ulps, tol=tol.replace(" ", "_"), **extra,
                **({} if t is None else dict(
                    ms=f"{t[0]:.5f}", plain_ms=f"{t[1]:.5f}",
                    library_ms=f"{t[2]:.5f}", bound_ms=f"{t[3]:.5f}",
                    bound_by=t[4])))
        if timed and name == "gpt2_train":
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
    for dtype in (torch.float32, torch.bfloat16):
        _check_dropout_mask(dtype)
    return rec_e, rec_f


def _valid_lengths(b, s, seed):
    """``[b]`` valid lengths drawn from a seed in [s/2, s], row 0 at s."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g)
    lengths[0] = s
    return lengths


#: (name, x shape, mask, causal sq, scale): BERT's scores with its padding
#: mask, a [b,1,1,s] key mask, causal [96,1024,1024], odd row lengths, the
#: encoder-decoder's key mask at s 114 (Kernel G's element path) and rows
#: of 64 (its 16-byte path, four rows a warp)
SOFTMAX_CASES = [
    ("bert", (16, 12, 512, 512), "padding", 0, 1.0),
    ("key_mask", (4, 12, 512, 512), "key", 0, 1.0),
    ("causal", (1, 96, 1024, 1024), None, 1024, 1.0),
    ("k17", (8, 12, 64, 17), "key", 0, 1.0),
    ("k1000", (2, 12, 100, 1000), "key", 0, 0.125),
    ("k4097", (1, 4, 64, 4097), "key", 0, 2.0),
    ("enc_dec_key", (16, 12, 114, 114), "key", 0, 1.0),
    ("k64", (16, 12, 512, 64), "key", 0, 1.0),
]


def _softmax_mask(kind, shape, seed):
    if kind is None:
        return None
    lengths = _valid_lengths(shape[0], shape[-1], seed).cuda()
    valid = torch.arange(shape[-1], device="cuda")[None, :] < \
        lengths[:, None]
    if kind == "key":
        return ~valid[:, None, None, :]
    # BertModel.build_attention_mask: a padded query row masks every key
    return ~(valid[:, None, None, :] & valid[:, None, :, None])


def phase_softmax(timer: Timer) -> tuple:
    """Kernels G and H against their plain versions in f32 (atol 1e-5) and
    bf16 (1 ulp of the plain version run in fp32 and rounded); BERT's
    fully masked rows must be 1/k. The BERT bf16 case is timed."""
    from apex_tpu_torch.ops.softmax import (softmax_bwd_cuda,
                                            softmax_bwd_plain,
                                            softmax_fwd_cuda,
                                            softmax_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rec_g = rec_h = None
    for name, shape, kind, sq, scale in SOFTMAX_CASES:
        mask = _softmax_mask(kind, shape, 8)
        causal = sq > 0
        for dtype in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(shape, device="cuda", generator=gen)).to(
                dtype)
            dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            y = softmax_fwd_cuda(x, mask, scale, sq, causal)
            ry = softmax_fwd_plain(x.float(), mask, scale, sq, causal).to(
                dtype)
            dx = softmax_bwd_cuda(dy, y, scale)
            rdx = softmax_bwd_plain(dy.float(), y.float(), scale).to(dtype)
            torch.cuda.synchronize()
            errs = {}
            for kname, got, want in (("g", y, ry), ("h", dx, rdx)):
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.bfloat16:
                    ulps = bf16_ulps(got, want)
                    ok, tol = ulps <= 1.0, "1_bf16_ulp"
                else:
                    ulps, ok, tol = 0.0, err <= 1e-5, "atol_1e-5"
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(f"kernel {kname} {name} {dtype}: "
                                         f"max err {err} ({ulps} ulp) — "
                                         f"tolerance {tol}")
                errs[kname] = (err, ulps, tol)
            uniform = None
            if kind == "padding":
                # the query rows whose every key is masked: [n, heads, k]
                rows = y.permute(0, 2, 1, 3)[mask[:, 0].all(dim=-1)]
                k = shape[-1]
                uniform = float((rows.float() * k - 1.0).abs().max())
                if rows.numel() == 0 or uniform > 2.0 ** -8:
                    raise AssertionError(f"kernel g {name} {dtype}: fully "
                                         f"masked rows are not 1/k "
                                         f"({uniform})")
            fields = {}
            if name == "bert" and dtype == torch.bfloat16:
                esz = x.element_size()
                n = x.numel()
                # G reads x only where the mask leaves a key visible (a
                # fully masked row is 1/k whatever x holds), all of the mask,
                # and writes all of y
                seen = int((~mask).expand(shape).sum())
                bms_g, by_g = bound_ms((seen + n) * esz + mask.numel(),
                                       6.0 * seen, torch.float32)
                bms_h, by_h = bound_ms(3 * n * esz, 4.0 * n, torch.float32)
                ms_g = timer(lambda: softmax_fwd_cuda(x, mask, scale, sq,
                                                      causal))
                ms_h = timer(lambda: softmax_bwd_cuda(dy, y, scale))
                plain_g = timer(lambda: softmax_fwd_plain(x, mask, scale, sq,
                                                          causal),
                                iters=5, warmup=1)
                plain_h = timer(lambda: softmax_bwd_plain(dy, y, scale),
                                iters=5, warmup=1)
                lib_g = timer(lambda: torch.softmax(x, -1))
                lib_h = timer(lambda: torch.ops.aten._softmax_backward_data(
                    dy, y, -1, x.dtype))
                fields = dict(g=(ms_g, plain_g, lib_g, bms_g, by_g),
                              h=(ms_h, plain_h, lib_h, bms_h, by_h))
                shape_s = (f"x[{','.join(map(str, shape))}] bf16, mask "
                           f"[{','.join(map(str, mask.shape))}]")
                rec_g = dict(name="softmax_fwd", route="cuda",
                             source="apex_tpu_torch/csrc/softmax_fwd.cu",
                             replaces="apex_tpu/ops/softmax.py:47",
                             shape=shape_s, max_abs_err=errs["g"][0],
                             ms=ms_g, plain_ms=plain_g, bound_ms=bms_g,
                             bound_by=by_g, library_ms=lib_g)
                rec_h = dict(name="softmax_bwd", route="cuda",
                             source="apex_tpu_torch/csrc/softmax_bwd.cu",
                             replaces="apex_tpu/ops/softmax.py:111",
                             shape=shape_s, max_abs_err=errs["h"][0],
                             ms=ms_h, plain_ms=plain_h, bound_ms=bms_h,
                             bound_by=by_h, library_ms=lib_h)
            for kname in ("g", "h"):
                err, ulps, tol = errs[kname]
                t = fields.get(kname)
                log(f"kernel_{kname}", case=name,
                    shape=f"[{','.join(map(str, shape))}]",
                    mask=None if mask is None
                    else f"[{','.join(map(str, mask.shape))}]",
                    causal=causal, scale=scale, dtype=str(dtype)[6:],
                    max_abs_err=f"{err:.3e}", ulps=ulps, tol=tol,
                    **({"uniform_rows_rel_err": f"{uniform:.2e}"}
                       if kname == "g" and uniform is not None else {}),
                    **({} if t is None else dict(
                        ms=f"{t[0]:.5f}", plain_ms=f"{t[1]:.5f}",
                        library_ms=f"{t[2]:.5f}", bound_ms=f"{t[3]:.5f}",
                        bound_by=t[4])))
            del x, dy, y, ry, dx, rdx
    return rec_g, rec_h


#: (name, b, h, kvh, sq, sk, causal, kv_lengths, window): the T5-base
#: cross-attention of the t5_train phase (kv_lengths as it draws them), a
#: multi-block causal GQA case, a window, an empty row, causal sq != sk
FLASH_BWD_CASES = [
    ("t5_cross", T5_BATCH, 12, 12, T5_DEC, T5_ENC, False, "t5", None),
    ("causal_gqa_1024", 2, 12, 6, 1024, 1024, True, None, None),
    ("window_256", 2, 12, 12, 1024, 1024, True, None, 256),
    ("kv_lengths_0", 3, 12, 12, 128, 512, False, [512, 200, 0], None),
    ("causal_sq_ne_sk", 2, 12, 12, 300, 700, True, None, None),
]


def phase_flash_bwd(timer: Timer) -> dict:
    """Kernel I against its plain version on the same inputs (which rounds
    ds and p to the input dtype where the JAX kernels do): f32 atol 1e-4;
    bf16 every element within 1 ulp plus the slack of one bf16 step of each
    rounded factor (``flash_bwd_rounding_slack``) and at most 0.1% of the
    elements past 1 ulp; two runs bitwise equal. Kernel B is checked at
    each shape on the way (its o within 1 ulp, lse within 1e-4). The T5
    cross-attention bf16 case is timed, B's forward beside SDPA and I
    beside SDPA's backward, each with its bound."""
    from apex_tpu_torch.ops.attention import (flash_bwd_cuda,
                                              flash_bwd_plain,
                                              flash_bwd_rounding_slack,
                                              flash_fwd_cuda,
                                              flash_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    record = None
    for name, b, h, kvh, sq, sk, causal, kvl, window in FLASH_BWD_CASES:
        d = 64
        if kvl == "t5":
            kvl = _valid_lengths(b, sk, 11).tolist()
        kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
        scale = 1.0 / math.sqrt(d)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            k = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(
                dtype)
            v = torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(
                dtype)
            do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(
                dtype)
            args = (kvl_t, scale, causal, window)
            o, lse = flash_fwd_cuda(q, k, v, *args)
            ro, rlse = flash_fwd_plain(q.float(), k.float(), v.float(), *args)
            b_ulps, b_ok, b_tol = check_close(o, ro.to(dtype))
            lse_err = float((lse - rlse).abs().max())
            if not b_ok or lse_err > 1e-4:
                raise AssertionError(f"kernel b {name} {dtype}: o {b_ulps} "
                                     f"ulp ({b_tol}), lse err {lse_err}")
            got = flash_bwd_cuda(q, k, v, do, o, lse, *args)
            want = flash_bwd_plain(q, k, v, do, o, lse, *args)
            again = flash_bwd_cuda(q, k, v, do, o, lse, *args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"kernel i {name} {dtype}: two runs "
                                     f"differ")
            slack = (flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
                     if dtype == torch.bfloat16 else (None,) * 3)
            err, ulps, past, tol = 0.0, 0.0, 0.0, "atol_1e-4"
            for g_, w_, sl in zip(got, want, slack):
                if dtype == torch.bfloat16:
                    tol = "1_bf16_ulp+factor_rounding"
                    e_, u_, p_, excess, ok = check_rounded_factors(g_, w_, sl)
                    err, ulps, past = max(err, e_), max(ulps, u_), \
                        max(past, p_)
                    if not ok:
                        raise AssertionError(
                            f"kernel i {name} bf16: {ulps} ulp, "
                            f"{past:.2e} of elements past 1 ulp, excess "
                            f"{excess} — tolerance {tol}")
                    continue
                err = max(err, float((g_.float() - w_.float()).abs().max()))
                if err > 1e-4:
                    raise AssertionError(f"kernel i {name} f32: max err "
                                         f"{err} — tolerance {tol}")
            if kvl is not None and 0 in kvl:
                row = kvl.index(0)
                if any(t[row].any() for t in got):
                    raise AssertionError(f"kernel i {name}: the batch row "
                                         f"with kv_length 0 has gradients")
            fields = {}
            if name == "t5_cross" and dtype == torch.bfloat16:
                esz = q.element_size()
                pairs = sum(_visible_pairs(sq, sk, causal, window, n)
                            for n in kvl)
                rows, keys = (sum(t) for t in zip(*(
                    _visible_rows_keys(sq, sk, causal, window, n)
                    for n in kvl)))
                # reads: q, o, do and lse of the query rows that see a key,
                # K and V of the keys that some row sees, kv_lengths;
                # writes: all of dq, dk and dv
                n_bytes = (3 * rows * h * d + 2 * keys * kvh * d
                           + q.numel() + 2 * k.numel()) * esz \
                    + rows * h * 4 + b * 4
                bms, by = bound_ms(n_bytes, 10.0 * d * h * pairs, dtype)
                # Kernel B: reads q of the rows that see a key, K and V of
                # the keys some row sees, kv_lengths; writes o and lse
                b_bms, b_by = bound_ms(
                    (rows * h * d + 2 * keys * kvh * d + o.numel()) * esz
                    + lse.numel() * 4 + b * 4, 4.0 * d * h * pairs, dtype)
                b_ms = timer(lambda: flash_fwd_cuda(q, k, v, *args))
                ms = timer(lambda: flash_bwd_cuda(q, k, v, do, o, lse, *args))
                plain = timer(lambda: flash_bwd_plain(q, k, v, do, o, lse,
                                                      *args),
                              iters=5, warmup=1)
                q4, k4, v4 = (t.detach().clone().requires_grad_()
                              for t in (q, k, v))
                keep = (torch.arange(sk, device="cuda")[None, :]
                        < kvl_t[:, None])[:, None, None, :]
                out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=keep)
                lib = timer(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do, retain_graph=True))
                b_lib = timer(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep))
                fields = dict(ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
                              library_ms=f"{lib:.5f}", bound_ms=f"{bms:.5f}",
                              bound_by=by, kernel_b_ms=f"{b_ms:.5f}",
                              kernel_b_library_ms=f"{b_lib:.5f}",
                              kernel_b_bound_ms=f"{b_bms:.5f}",
                              kernel_b_bound_by=b_by)
                record = dict(name="flash_bwd", route="cuda",
                              source="apex_tpu_torch/csrc/flash_bwd.cu",
                              replaces="apex_tpu/ops/attention.py:669",
                              shape=f"q[{b},{h},{sq},{d}] k,v[{b},{kvh},{sk},"
                              f"{d}] bf16 kv_lengths", max_abs_err=err,
                              ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by, library_ms=lib)
            log("kernel_i", case=name,
                shape=f"b{b} h{h} kvh{kvh} sq{sq} sk{sk} d{d}",
                causal=causal, window=window,
                kv_lengths=None if kvl is None else len(kvl),
                dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}", ulps=ulps,
                share_past_1_ulp=f"{past:.2e}", tol=tol, bitwise_repeat=True,
                kernel_b_ulps=b_ulps, kernel_b_lse_err=f"{lse_err:.2e}",
                **fields)
    return record


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in fp32: the norm-wise error of an fp32
    sum taken in another order."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


#: norm-wise tolerance of every fp32 sum of the conv kernels (y and dx in
#: f32; stats, dW, da and db in both dtypes): the same fp32 products summed
#: in another order
CONV_SUM_TOL = 1e-5
#: (name, kind, x shape, w shape, (affine, relu) cases, NHW of a 1x1's rows
#: for the library call, timed as the kernel's record). Kernel J's bf16
#: branches: 64 x 128 tiles with the prep pass (layer1_conv3, layer3_conv3
#: at N = 1024) and without (layer4); 128 x 64 tiles without (layer1_conv1,
#: N = 64 over K = 256) and with (tail_200, 200 rows: a ragged last tile);
#: channels off the 16-byte groups (ragged_1x1: fragment stores)
CONV_CASES = [
    ("layer1_conv3", "1x1", (802816, 64), (64, 256), [(True, True)],
     (256, 56, 56), True),
    ("layer1_conv1", "1x1", (802816, 256), (256, 64), [(False, False)],
     (256, 56, 56), False),
    ("layer3_conv3", "1x1", (50176, 256), (256, 1024), [(True, True)],
     (256, 14, 14), False),
    ("layer4_conv1", "1x1", (12544, 2048), (2048, 512), [(False, False)],
     (256, 7, 7), False),
    ("layer4_down", "1x1", (12544, 1024), (1024, 2048), [(False, False)],
     (256, 7, 7), False),
    ("tail_200", "1x1", (200, 64), (64, 96),
     [(False, False), (True, False), (True, True)], None, False),
    ("ragged_1x1", "1x1", (1000, 20), (20, 36),
     [(False, False), (True, False), (True, True)], None, False),
    ("layer1_3x3", "3x3", (256, 56, 56, 64), (3, 3, 64, 64), [(True, True)],
     None, True),
    ("layer2_3x3", "3x3", (256, 28, 28, 128), (3, 3, 128, 128),
     [(True, True)], None, False),
    ("layer3_3x3", "3x3", (256, 14, 14, 256), (3, 3, 256, 256),
     [(True, True)], None, False),
    ("layer4_3x3", "3x3", (256, 7, 7, 512), (3, 3, 512, 512), [(True, True)],
     None, False),
    ("odd", "3x3", (3, 5, 9, 16), (3, 3, 16, 32),
     [(False, False), (True, False), (True, True)], None, False),
    ("ragged", "3x3", (5, 13, 11, 20), (3, 3, 20, 36),
     [(False, False), (True, False), (True, True)], None, False),
]


def _conv_bytes_flops(kind, x_shape, w_shape, affine, esz) -> tuple:
    """``(fwd bytes, fwd FLOPs, bwd bytes, bwd FLOPs)`` a fused conv must
    move and do: each input read once, each output written once; FLOPs of
    the products only (2 a multiply-add; the backward has two)."""
    m = math.prod(x_shape[:-1])
    k, n = w_shape[-2], w_shape[-1]
    taps = 9 if kind == "3x3" else 1
    wn = taps * k * n
    vec = (2 * k if affine else 0) + n             # a, b and the shift
    fwd = (m * k + wn + m * n) * esz + (vec + 2 * n) * 4
    # reads x, w, y, dy, a, b, c, ds; writes dx, dW (fp32), da and db
    bwd = (2 * m * k + wn + 2 * m * n) * esz + (vec + 2 * n + wn
                                                 + (2 * k if affine else 0)) * 4
    flops = 2.0 * m * taps * k * n
    return fwd, flops, bwd, 2 * flops


def _conv_library(kind, x, w, dy, nhw):
    """cuDNN's convolution alone (no affine, no stats) on bf16
    channels-last views: ``(forward fn, backward fn)``, the backward its
    input and weight gradients."""
    if kind == "1x1":
        b, h, wd = nhw
        x4 = x.reshape(b, h, wd, -1)
        dy4 = dy.reshape(b, h, wd, -1)
        w4 = w.t().reshape(w.shape[1], w.shape[0], 1, 1)
        pad = 0
    else:
        x4, dy4, pad = x, dy, 1
        w4 = w.permute(3, 2, 0, 1)
    xv = x4.permute(0, 3, 1, 2).detach().requires_grad_()
    wv = w4.contiguous(memory_format=torch.channels_last).requires_grad_()
    out = F.conv2d(xv, wv, padding=pad)
    dyv = dy4.permute(0, 3, 1, 2)
    return (lambda: F.conv2d(xv, wv, padding=pad),
            lambda: torch.autograd.grad(out, (xv, wv), dyv,
                                        retain_graph=True))


def phase_conv(timer: Timer) -> tuple:
    """Kernels J-M against their plain versions on the same inputs, with a
    random stats cotangent: bf16 y and dx within 1 ulp of the plain
    version run in fp32 and rounded once; f32 y and dx, and every fp32 sum
    (stats, dW, da, db), norm-wise within ``CONV_SUM_TOL``; two forward
    and two backward runs bitwise equal. The layer1 bf16 cases are the
    records; every bf16 case at a ResNet-50 shape is timed against cuDNN's
    conv alone."""
    from apex_tpu_torch.ops import conv_fused as cf
    ops = {"1x1": (cf.conv1x1_fwd_cuda, cf.conv1x1_fwd_plain,
                   cf.conv1x1_bwd_cuda, cf.conv1x1_bwd_plain),
           "3x3": (cf.conv3x3_fwd_cuda, cf.conv3x3_fwd_plain,
                   cf.conv3x3_bwd_cuda, cf.conv3x3_bwd_plain)}
    names = {"1x1": ("j", "k", "conv1x1"), "3x3": ("l", "m", "conv3x3")}
    replaces = {"conv1x1_fwd": 63, "conv1x1_bwd": 136, "conv3x3_fwd": 356,
                "conv3x3_bwd": 446}
    gen = torch.Generator(device="cuda").manual_seed(16)
    records = {}
    for name, kind, x_shape, w_shape, acts, nhw, record in CONV_CASES:
        fwd_c, fwd_p, bwd_c, bwd_p = ops[kind]
        fk, bk, stem = names[kind]
        k, n = w_shape[-2], w_shape[-1]
        fan_in = math.prod(w_shape[:-1])
        for affine, relu in acts:
            for dtype in (torch.float32, torch.bfloat16):
                rnd = lambda *shape: torch.randn(  # noqa: E731
                    shape, device="cuda", generator=gen)
                x = rnd(*x_shape).to(dtype)
                w = (rnd(*w_shape) * fan_in ** -0.5).to(dtype)
                a = (torch.rand(k, device="cuda", generator=gen) + 0.5
                     if affine else None)
                b = rnd(k) if affine else None
                c = 0.1 * rnd(n)
                dy = rnd(*x_shape[:-1], n).to(dtype)
                ds = 0.1 * rnd(2, n)
                args = (a, b, w, c)
                y, st = fwd_c(x, *args, affine, relu)
                y2, st2 = fwd_c(x, *args, affine, relu)
                ry, rst = fwd_p(x, *args, affine, relu)
                got = bwd_c(x, *args, ry, dy, ds, affine, relu)
                again = bwd_c(x, *args, ry, dy, ds, affine, relu)
                want = bwd_p(x, *args, ry, dy, ds, affine, relu)
                torch.cuda.synchronize()
                if not (torch.equal(y, y2) and torch.equal(st, st2)):
                    raise AssertionError(f"kernel {fk} {name} {dtype}: two "
                                         f"runs differ")
                if not all((g is None and h is None) or torch.equal(g, h)
                           for g, h in zip(got, again)):
                    raise AssertionError(f"kernel {bk} {name} {dtype}: two "
                                         f"runs differ")
                errs = {}
                outs = [("y", y, ry), ("dx", got[0], want[0])]
                sums = [("stats", st, rst), ("dw", got[1], want[1])]
                if affine:
                    sums.append(("da_db", got[2], want[2]))
                for oname, g, h in outs:
                    if dtype == torch.bfloat16:
                        errs[oname] = bf16_ulps(g, h)
                        ok = errs[oname] <= 1.0
                    else:
                        errs[oname] = rel_norm(g, h)
                        ok = errs[oname] <= CONV_SUM_TOL
                    if not ok or not torch.isfinite(g).all():
                        raise AssertionError(
                            f"kernel {fk if oname == 'y' else bk} {name} "
                            f"{dtype} affine={affine} relu={relu}: {oname} "
                            f"err {errs[oname]} (1 bf16 ulp / {CONV_SUM_TOL} "
                            f"norm-wise)")
                for sname, g, h in sums:
                    errs[sname] = rel_norm(g, h)
                    if errs[sname] > CONV_SUM_TOL:
                        raise AssertionError(
                            f"kernel {fk if sname == 'stats' else bk} "
                            f"{name} {dtype} affine={affine} relu={relu}: "
                            f"{sname} norm-wise err {errs[sname]} "
                            f"(tolerance {CONV_SUM_TOL})")
                max_err = {"y": float((y.float() - ry.float()).abs().max()),
                           "dx": float((got[0].float()
                                        - want[0].float()).abs().max())}
                timed = {}
                if dtype == torch.bfloat16 and (nhw or kind == "3x3") \
                        and x.numel() > 10 ** 6:
                    fb, ff, bb, bf = _conv_bytes_flops(kind, x_shape,
                                                       w_shape, affine, 2)
                    timed["fwd_bound"] = bound_ms(fb, ff, dtype)
                    timed["bwd_bound"] = bound_ms(bb, bf, dtype)
                    timed["fwd"] = timer(lambda: fwd_c(x, *args, affine,
                                                       relu), iters=10)
                    timed["bwd"] = timer(lambda: bwd_c(x, *args, ry, dy, ds,
                                                       affine, relu),
                                         iters=10)
                    lib_f, lib_b = _conv_library(kind, x, w, dy, nhw)
                    timed["fwd_lib"] = timer(lib_f, iters=10)
                    timed["bwd_lib"] = timer(lib_b, iters=10)
                    if record:
                        timed["fwd_plain"] = timer(
                            lambda: fwd_p(x, *args, affine, relu), iters=5,
                            warmup=1)
                        timed["bwd_plain"] = timer(
                            lambda: bwd_p(x, *args, ry, dy, ds, affine,
                                          relu), iters=5, warmup=1)
                for kname, which in ((fk, "fwd"), (bk, "bwd")):
                    fields = {}
                    if timed:
                        bms, by = timed[f"{which}_bound"]
                        fields = dict(ms=f"{timed[which]:.5f}",
                                      library_ms=f"{timed[which + '_lib']:.5f}",
                                      bound_ms=f"{bms:.5f}", bound_by=by)
                        if record:
                            fields["plain_ms"] = \
                                f"{timed[which + '_plain']:.5f}"
                    keys = (("y", "stats") if which == "fwd"
                            else ("dx", "dw", "da_db"))
                    log(f"kernel_{kname}", case=name, kind=kind,
                        x=list(x_shape), w=list(w_shape), affine=affine,
                        relu=relu, dtype=str(dtype)[6:],
                        **{f"{e}_err": f"{errs[e]:.3e}" for e in keys
                           if e in errs},
                        tol="1_bf16_ulp/1e-5_normwise", **fields,
                        bitwise_repeat=True)
                if record and dtype == torch.bfloat16:
                    shape = (f"x[{','.join(map(str, x_shape))}] "
                             f"w[{','.join(map(str, w_shape))}] bf16"
                             f"{' affine+relu' if affine and relu else ''}")
                    for which, oname in (("fwd", "y"), ("bwd", "dx")):
                        kname = f"{stem}_{which}"
                        bms, by = timed[f"{which}_bound"]
                        records[kname] = dict(
                            name=kname, route="cuda",
                            source=f"apex_tpu_torch/csrc/{kname}.cu",
                            replaces="apex_tpu/ops/conv_fused.py:"
                                     f"{replaces[kname]}",
                            shape=shape, max_abs_err=max_err[oname],
                            ms=timed[which], plain_ms=timed[which + "_plain"],
                            bound_ms=bms, bound_by=by,
                            library_ms=timed[which + "_lib"])
                del x, w, dy, y, y2, ry, got, again, want
    torch.cuda.empty_cache()
    return tuple(records[k] for k in ("conv1x1_fwd", "conv1x1_bwd",
                                      "conv3x3_fwd", "conv3x3_bwd"))


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
    for name, (calls, us) in ranked[:PROFILE_TOP]:
        log("profile_kernel", path=path, device_ms=f"{us / 1e3:.3f}",
            calls=calls, name=name[:90].replace(" ", "_"))
    rest = ranked[PROFILE_TOP:]
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


def transformer_train_flops(n_params, tokens, num_layers, hidden, seq,
                            causal) -> float:
    """Model FLOPs of one training step (``apex_tpu/utils/flops.py:44-50``):
    ``6 N`` per token plus the attention term ``12 L s h`` per token,
    halved for causal masking."""
    attn = 12 * num_layers * seq * hidden * (0.5 if causal else 1.0)
    return float(tokens) * (6.0 * n_params + attn)


def _timed_steps(step, batch) -> tuple:
    """2 warm-up and 8 timed steps, the launch counters read over all ten:
    ``(losses, step seconds, launches, peak GB)``."""
    from apex_tpu_torch.ops import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return ([float(x) for x in losses], times, dict(LAUNCHES),
            torch.cuda.max_memory_allocated() / 1e9)


def _report_train(phase, model_name, losses, times, launches, peak_gb,
                  per_step, tokens, flops, positions=None, unit="tokens",
                  **extra) -> None:
    """Print the phase's line; raise unless every loss is finite, the last
    below the first, and every kernel launched ``per_step`` times a step
    (0 for a kernel not listed). ``tokens`` are the tokens (or, with
    ``unit``, the images) a step trains (padding left out); ``positions``
    (if padded) and ``flops`` count every position the step computes,
    padding included."""
    steps = len(losses)
    timed = sorted(times[WARMUP_STEPS:])
    step_s = timed[len(timed) // 2]
    log(phase, model=model_name, steps=steps,
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""),
        step_ms_median=f"{1e3 * step_s:.2f}",
        step_ms=json.dumps([round(1e3 * t, 2) for t in times]).replace(
            " ", ""),
        **{f"{unit}_per_s": f"{tokens / step_s:.1f}"},
        **({} if positions is None
           else dict(positions_per_s=f"{positions / step_s:.1f}")),
        mfu=f"{flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f}",
        peak_mem_gb=f"{peak_gb:.3f}", **extra,
        launches=json.dumps(launches).replace(" ", ""))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall on the fixed "
                             f"batch: {losses}")
    want = {k: per_step.get(k, 0) * steps for k in ALL_KERNELS}
    if launches != want:
        raise AssertionError(f"{phase}: launches over {steps} steps "
                             f"{launches}, expected {want}")


def phase_train(profile: bool = False) -> dict:
    """GPT-2 124M trains in the bench.py configuration: returns the
    kernels' launches over the phase. With ``profile``, two more steps run
    under the profiler once the counts are read."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**GPT2, hidden_dropout=0.0, attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _train_model(cfg, "cuda")
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses, times, launches, peak = _timed_steps(step, batch)
    _report_train("train", "gpt2-124m bf16/fp32 random-init", losses, times,
                  launches, peak, TRAIN_KERNELS, tokens,
                  transformer_train_flops(n_params, tokens,
                                          GPT2["num_layers"],
                                          GPT2["hidden_size"], TRAIN_SEQ,
                                          causal=True),
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_params=n_params)
    if profile:
        profile_device("train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=TRAIN_BATCH,
                                    seq=TRAIN_SEQ))
    return launches


def _bert_model(cfg, device, seed=0):
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.training import make_train_step
    model = BertModel(cfg, device=device,
                      generator=torch.Generator().manual_seed(seed))
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    return model, make_train_step(lambda batch: model(*batch)[0], opt)


def _bert_batch(cfg, b, s, device, seed):
    """Tokens, a padding mask with valid lengths in [s/2, s] (row 0 full),
    tokentype ids 0 before a seeded split inside each row's valid part and
    1 after, LM labels."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    lengths = _valid_lengths(b, s, seed + 1)
    split = (torch.rand(b, generator=g) * lengths).long().clamp_min(1)
    pos = torch.arange(s)[None, :]
    padding = pos < lengths[:, None]
    types = (pos >= split[:, None]).long()
    return tuple(t.to(device) for t in (tokens, padding, types, labels))


def phase_bert_train(profile: bool = False) -> dict:
    """BERT-base with padding masks and FusedLAMB: returns the launches."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.transformer.enums import AttnMaskType
    cfg = TransformerConfig(**BERT, hidden_dropout=0.0, attention_dropout=0.0,
                            attn_mask_type=AttnMaskType.padding,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _bert_model(cfg, "cuda")
    batch = _bert_batch(cfg, BERT_BATCH, BERT_SEQ, "cuda", seed=12)
    n_params = sum(p.numel() for p in model.parameters())
    positions = BERT_BATCH * BERT_SEQ
    tokens = int(batch[1].sum())
    losses, times, launches, peak = _timed_steps(step, batch)
    _report_train("bert_train", "bert-base bf16/fp32 random-init", losses,
                  times, launches, peak, BERT_KERNELS, tokens,
                  transformer_train_flops(n_params, positions,
                                          BERT["num_layers"],
                                          BERT["hidden_size"], BERT_SEQ,
                                          causal=False),
                  positions, batch=BERT_BATCH, seq=BERT_SEQ,
                  valid_tokens=tokens, n_params=n_params)
    if profile:
        profile_device("bert_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=BERT_BATCH, seq=BERT_SEQ))
    return launches


def _t5_model(cfg, device, seed=0, lr=1e-4):
    from apex_tpu_torch.models import EncoderDecoderModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    model = EncoderDecoderModel(cfg, device=device,
                                generator=torch.Generator().manual_seed(seed))
    opt = FusedAdam(model.parameters(), lr=lr)
    return model, make_train_step(
        lambda b: model(b[0], b[1], b[2], enc_lengths=b[3]), opt)


def _t5_batch(cfg, b, s_enc, s_dec, device, seed):
    """Encoder and decoder tokens, decoder labels, encoder valid lengths
    in [s_enc/2, s_enc] (row 0 full)."""
    g = torch.Generator().manual_seed(seed)
    enc = torch.randint(0, cfg.vocab_size, (b, s_enc), generator=g)
    dec = torch.randint(0, cfg.vocab_size, (b, s_dec), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (b, s_dec), generator=g)
    lengths = _valid_lengths(b, s_enc, seed + 1)
    return tuple(t.to(device) for t in (enc, dec, labels, lengths))


def enc_dec_train_flops(model, b, s_enc, s_dec) -> float:
    """Encoder tokens through the encoder's parameters (bidirectional
    attention), decoder tokens through the decoder's and the tied LM head's
    (causal self-attention, and cross-attention over ``s_enc`` keys: 12 L
    s_enc h a token), each as ``transformer_train_flops`` counts them."""
    c = model.config
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    n_dec = sum(p.numel() for p in model.decoder.parameters()) + \
        model.embedding.word_embeddings.weight.numel()
    cross = 12.0 * c.num_layers * s_enc * c.hidden_size * b * s_dec
    return (transformer_train_flops(n_enc, b * s_enc, c.num_layers,
                                    c.hidden_size, s_enc, causal=False)
            + transformer_train_flops(n_dec, b * s_dec, c.num_layers,
                                      c.hidden_size, s_dec, causal=True)
            + cross)


def phase_t5_train(profile: bool = False) -> dict:
    """The encoder-decoder at T5-base widths with enc_lengths: returns the
    launches."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**T5, hidden_dropout=0.0, attention_dropout=0.0,
                            params_dtype=torch.float32,
                            compute_dtype=torch.bfloat16)
    model, step = _t5_model(cfg, "cuda")
    batch = _t5_batch(cfg, T5_BATCH, T5_ENC, T5_DEC, "cuda", seed=13)
    n_params = sum(p.numel() for p in model.parameters())
    positions = T5_BATCH * (T5_ENC + T5_DEC)
    tokens = int(batch[3].sum()) + T5_BATCH * T5_DEC
    losses, times, launches, peak = _timed_steps(step, batch)
    _report_train("t5_train", "t5-base-widths enc-dec bf16/fp32 random-init",
                  losses, times, launches, peak, T5_KERNELS, tokens,
                  enc_dec_train_flops(model, T5_BATCH, T5_ENC, T5_DEC),
                  positions, batch=T5_BATCH, enc_seq=T5_ENC, dec_seq=T5_DEC,
                  valid_tokens=tokens,
                  enc_lengths=json.dumps(batch[3].tolist()).replace(" ", ""),
                  n_params=n_params)
    if profile:
        profile_device("t5_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=T5_BATCH, enc_seq=T5_ENC,
                                    dec_seq=T5_DEC))
    return launches


def _grad_tree(model):
    return {name: p.grad.detach().cpu().clone()
            for name, p in model.named_parameters()}


def _card_vs_cpu(phase, build, **fields) -> None:
    """``build(device) -> (model, step, batch)`` from fixed seeds; three
    steps on the card (TF32 off, set in ``main``) and on the CPU. Losses
    agree to 1e-5 relative; every step-1 gradient leaf to atol 1e-5 + rtol
    1e-4 (fp32 sums in other orders, through the kernels on one side and
    the plain versions on the other)."""
    losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        model, step, batch = build(device)
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
    log(phase, **fields, steps=3,
        losses_cuda=json.dumps(losses["cuda"]).replace(" ", ""),
        losses_cpu=json.dumps(losses["cpu"]).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", grad_leaves=len(grads["cpu"]),
        worst_grad_excess=f"{worst:.2e}", worst_leaf=worst_name)
    if rel > 1e-5 or worst > 1e-5:
        raise AssertionError(
            f"{phase}: loss rel err {rel} (tolerance 1e-5), grad leaf "
            f"{worst_name} off by {worst} past atol 1e-5 + rtol 1e-4")


SMALL = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
             vocab_size=512, max_position_embeddings=128, hidden_dropout=0.0,
             attention_dropout=0.0)


def phase_train_card_vs_cpu() -> None:
    """A small f32 GPT trains 3 steps on the card and on the CPU."""
    from apex_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(**SMALL)

    def build(device):
        model, step = _train_model(cfg, device, seed=2)
        return model, step, _train_batch(cfg, 4, 96, device, seed=3)

    _card_vs_cpu("train_card_vs_cpu", build, layers=2, hidden=128)


def phase_enc_card_vs_cpu() -> None:
    """A small f32 BERT (padding mask, LAMB) and a small f32
    encoder-decoder (enc_lengths, Adam) train 3 steps on the card and on
    the CPU."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.transformer.enums import AttnMaskType
    bert = TransformerConfig(**SMALL, attn_mask_type=AttnMaskType.padding)
    t5 = TransformerConfig(**SMALL, normalization="rmsnorm",
                           activation="relu")

    def build_bert(device):
        model, step = _bert_model(bert, device, seed=4)
        return model, step, _bert_batch(bert, 4, 96, device, seed=5)

    def build_t5(device):
        model, step = _t5_model(t5, device, seed=6, lr=1e-3)
        return model, step, _t5_batch(t5, 4, 96, 40, device, seed=7)

    _card_vs_cpu("enc_card_vs_cpu", build_bert, model="bert_padding_lamb",
                 layers=2, hidden=128)
    _card_vs_cpu("enc_card_vs_cpu", build_t5,
                 model="enc_dec_enc_lengths_adam", layers=2, hidden=128)


def _rn50_model(cfg_kw, device, seed=0, master_weights=False):
    """ResNet with weights from ``seed``, trained with cross entropy on
    the fp32 logits (benchmarks/rn50_dp.py's loss) and FusedSGD as
    rn50_dp configures it."""
    from apex_tpu_torch.models import ResNet, ResNetConfig
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.training import make_train_step
    model = ResNet(ResNetConfig(**cfg_kw), device=device,
                   generator=torch.Generator().manual_seed(seed))
    opt = FusedSGD(model.parameters(), lr=0.1, momentum=0.9,
                   weight_decay=1e-4, master_weights=master_weights)
    return model, make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]), opt)


def _rn50_batch(b, size, classes, device, seed):
    """NHWC images and labels from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, size, size, 3, generator=g)
    y = torch.randint(0, classes, (b,), generator=g)
    return x.to(device), y.to(device)


def phase_rn50_train(profile: bool = False) -> dict:
    """ResNet-50 on the fused conv + batch-norm path: returns the
    launches."""
    from apex_tpu_torch.utils.flops import resnet50_train_flops
    cfg = dict(depth=50, num_classes=1000, compute_dtype=torch.bfloat16,
               fused_conv=True)
    model, step = _rn50_model(cfg, "cuda", master_weights=True)
    batch = _rn50_batch(RN50_BATCH, RN50_SIZE, 1000, "cuda", seed=14)
    n_params = sum(p.numel() for p in model.parameters())
    losses, times, launches, peak = _timed_steps(step, batch)
    _report_train("rn50_train", "resnet50 bf16/fp32 fused_conv random-init",
                  losses, times, launches, peak, RN50_KERNELS, RN50_BATCH,
                  resnet50_train_flops(RN50_BATCH, RN50_SIZE), unit="images",
                  batch=RN50_BATCH, image=RN50_SIZE, n_params=n_params)
    if profile:
        profile_device("rn50_train", lambda: [step(batch) for _ in range(2)],
                       lambda: dict(steps=2, batch=RN50_BATCH,
                                    image=RN50_SIZE))
    return launches


def _leaf_norm(t) -> float:
    return float(t.double().norm())


def _rn50_blocks_card_vs_cpu(cfg) -> None:
    """Two fused bottlenecks of the model, where the gradient is well
    conditioned: layer1.1 (Kernels J, L, K, M) and layer2.0 (stride 2 with
    the downsample: J and K beside cuDNN's conv2). Output, new batch-norm
    buffers and the gradients of the input and every parameter agree to
    2e-5 of each leaf's largest magnitude (+ 1e-6 for the buffers)."""
    worst = 0.0
    for si, bi in ((0, 1), (1, 0)):
        got = {}
        for device in ("cuda", "cpu"):
            model, _ = _rn50_model(cfg, device, seed=3)
            blk = model.stages()[si][bi]
            g = torch.Generator().manual_seed(5)
            x = torch.randn(4, 8, 8, blk.conv1.shape[2], generator=g)
            hw = 8 // blk.stride
            r = torch.randn(4, hw, hw, blk.conv3.shape[3], generator=g)
            xt = x.to(device).requires_grad_()
            out = model._block_apply_fused(blk, xt)
            (out * r.to(device)).sum().backward()
            leaves = {"out": out, "grad x": xt.grad}
            leaves.update({f"grad {n}": p.grad
                           for n, p in blk.named_parameters()})
            leaves.update({f"buffer {n}": b for n, b in blk.named_buffers()})
            got[device] = {n: t.detach().cpu().clone() for n, t in
                           leaves.items()}
        for n, want in got["cpu"].items():
            atol = 1e-6 if n.startswith("buffer") else 0.0
            err = float((got["cuda"][n] - want).abs().max())
            ratio = err / (2e-5 * float(want.abs().max()) + atol + 1e-30)
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"rn50_card_vs_cpu: block layer{si + 1}.{bi} leaf {n} "
                    f"off by {err} (2e-5 of max {float(want.abs().max())})")
    log("rn50_card_vs_cpu", part="fused_blocks_layer1.1_layer2.0",
        leaves_per_block=len(got["cpu"]), worst_over_tol=f"{worst:.3f}")


def phase_rn50_card_vs_cpu() -> None:
    """ResNet-50 at 64 px, batch 4, 8 classes, f32 (TF32 off), on the card
    and on the CPU from one seed. Kernels K and M are decided by
    ``phase_conv``'s checks at the main path's shapes and by part 0 here;
    parts 1 and 2 check the model's wiring, since the whole model's
    gradient is too chaotic to catch a dW that is off by a few percent.

    0. Two fused blocks in isolation (``_rn50_blocks_card_vs_cpu``), to
       2e-5 of each leaf's largest magnitude.
    1. ``zero_init_residual=False``, one step: the loss to rtol 2e-4, the
       batch-norm buffers to 1e-3 of each leaf's largest magnitude + 1e-5.
       This model's f32 gradient is chaotic at batch 4 (a 1e-7 relative
       perturbation of the input moves it by ~2% of its norm), so each
       gradient leaf is held within 8x, and the whole tree within 3x, the
       largest change that three such perturbations make on the CPU (or
       1e-5 of the leaf's norm).
    2. The recipe's ``zero_init_residual=True``, three FusedSGD steps: the
       losses to rtol 1e-4, then every parameter and buffer to 1e-4 of its
       leaf's largest magnitude + 1e-6."""
    cfg = dict(depth=50, num_classes=8, fused_conv=True,
               zero_init_residual=False)
    _rn50_blocks_card_vs_cpu(cfg)
    x, y = _rn50_batch(4, 64, 8, "cpu", seed=15)

    def one_step(device, xx):
        model, _ = _rn50_model(cfg, device, seed=3)
        loss = F.cross_entropy(model(xx.to(device)), y.to(device))
        loss.backward()
        return (float(loss.detach()), _grad_tree(model),
                {n: b.detach().cpu().clone()
                 for n, b in model.named_buffers()})

    loss_c, grads_c, bufs_c = one_step("cuda", x)
    loss_h, grads_h, bufs_h = one_step("cpu", x)
    floors = []
    for seed in (9, 10, 11):
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed))
        floors.append(one_step("cpu", x * (1 + 1e-7 * noise))[1])
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    buf_excess = max(float((bufs_c[n] - v).abs().max()
                           - 1e-3 * v.abs().max() - 1e-5)
                     for n, v in bufs_h.items())
    worst_ratio, worst_leaf = 0.0, None
    for n, want in grads_h.items():
        floor = max(_leaf_norm(f[n] - want) for f in floors)
        ratio = _leaf_norm(grads_c[n] - want) / max(
            floor, 1e-5 * _leaf_norm(want), 1e-30)
        if ratio >= worst_ratio:
            worst_ratio, worst_leaf = ratio, n
    tree = math.sqrt(sum(_leaf_norm(grads_c[n] - v) ** 2
                         for n, v in grads_h.items()))
    tree_floor = max(math.sqrt(sum(_leaf_norm(f[n] - v) ** 2
                                   for n, v in grads_h.items()))
                     for f in floors)
    log("rn50_card_vs_cpu", part="step1_zero_init_residual_false",
        image=64, batch=4, loss_cuda=f"{loss_c:.7f}", loss_cpu=f"{loss_h:.7f}",
        loss_rel_err=f"{loss_rel:.2e}", grad_leaves=len(grads_h),
        worst_leaf_over_floor=f"{worst_ratio:.3f}", worst_leaf=worst_leaf,
        tree_err=f"{tree:.3e}", tree_floor=f"{tree_floor:.3e}",
        buffer_excess=f"{buf_excess:.2e}")
    if loss_rel > 2e-4 or worst_ratio > 8.0 or tree > 3 * tree_floor \
            or buf_excess > 0:
        raise AssertionError(
            f"rn50_card_vs_cpu: loss rel {loss_rel} (2e-4), leaf "
            f"{worst_leaf} at {worst_ratio}x its noise floor (8x), tree "
            f"{tree} vs floor {tree_floor} (3x), buffers {buf_excess} past "
            f"1e-3 rel + 1e-5")
    cfg3 = dict(cfg, zero_init_residual=True)
    losses, states = {}, {}
    for device in ("cuda", "cpu"):
        model, step = _rn50_model(cfg3, device, seed=3)
        batch = (x.to(device), y.to(device))
        losses[device] = [float(step(batch)) for _ in range(3)]
        states[device] = {n: t.detach().cpu().clone()
                          for n, t in model.state_dict().items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    excess = max(float((states["cuda"][n].float() - v.float()).abs().max()
                       - 1e-4 * v.float().abs().max() - 1e-6)
                 for n, v in states["cpu"].items())
    log("rn50_card_vs_cpu", part="three_sgd_steps_zero_init_residual_true",
        losses_cuda=json.dumps(losses["cuda"]).replace(" ", ""),
        losses_cpu=json.dumps(losses["cpu"]).replace(" ", ""),
        loss_rel_err=f"{rel:.2e}", state_leaves=len(states["cpu"]),
        state_excess=f"{excess:.2e}")
    if rel > 1e-4 or excess > 0 or not losses["cuda"][-1] < \
            losses["cuda"][0]:
        raise AssertionError(f"rn50_card_vs_cpu: three steps, loss rel "
                             f"{rel} (1e-4), state excess {excess}")


#: the phase whose run is each kernel's main path
MAIN_PATH = {"layer_norm_fwd": "serve", "flash_fwd": "serve",
             "paged_decode": "serve", "layer_norm_bwd": "train",
             "flash_packed_fwd": "train", "flash_packed_bwd": "train",
             "softmax_fwd": "bert_train", "softmax_bwd": "bert_train",
             "flash_bwd": "t5_train", "conv1x1_fwd": "rn50_train",
             "conv1x1_bwd": "rn50_train", "conv3x3_fwd": "rn50_train",
             "conv3x3_bwd": "rn50_train"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the serve and train phases, trace a "
                        "second serve and two more steps of each train "
                        "phase with torch.profiler and print their "
                        "breakdowns")
    args = parser.parse_args()
    phase_device()
    # fp32 comparisons hold to fp32 GEMMs, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    timer = Timer()
    records = [phase_layer_norm(timer), phase_flash(timer),
               phase_decode(timer), phase_layer_norm_bwd(timer),
               *phase_packed(timer), *phase_softmax(timer),
               phase_flash_bwd(timer), *phase_conv(timer)]
    paths = {"serve": phase_serve(args.profile)}
    phase_card_vs_cpu()
    paths["train"] = phase_train(args.profile)
    phase_train_card_vs_cpu()
    paths["bert_train"] = phase_bert_train(args.profile)
    paths["t5_train"] = phase_t5_train(args.profile)
    phase_enc_card_vs_cpu()
    paths["rn50_train"] = phase_rn50_train(args.profile)
    phase_rn50_card_vs_cpu()
    for rec in records:
        name = rec["name"]
        rec["launches"] = paths[MAIN_PATH[name]][name]
        rec["launches_by_path"] = {path: counts[name]
                                   for path, counts in paths.items()}
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
