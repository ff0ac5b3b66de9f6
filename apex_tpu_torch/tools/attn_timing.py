#!/usr/bin/env python3
"""Time the flash attention kernels on one CUDA card: the packed-QKV
forward and backward (Kernels E and F) and the 4D forward and backward
(Kernels B and I).

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/attn_timing.py [--root DIR] [--tag NAME]
        [--out FILE] [--cases NAME,...] [--train [train|t5_train]]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file), so one call can time two
versions of the kernel in turns (parent, change, change, parent), each in
its own process. ``flash_packed_fwd_cuda`` is timed in bf16 at the
self-attention shapes of the training cells: GPT-2 124M (qkv [1024, 8,
2304], causal), the T5-base-width encoder (b 16, s 512, not causal, with
``chip_smoke.py``'s seeded enc_lengths) and decoder (b 16, s 114,
causal), each beside ``scaled_dot_product_attention`` on the same q, k, v
(a bool key mask for the encoder's lengths) and beside its bound
(``chip_smoke.bound_ms`` of qkv, o and lse and of 4 d FLOPs a visible
pair). Each case is first held to the plain version (o within
1 bf16 ulp, lse within 1e-4, two runs bitwise equal), and a digest of o
and lse is printed, so that two versions' outputs can be compared bit for
bit; the f32 GPT-2 case gives the f32 kernel's digest.
``flash_packed_bwd_cuda`` is timed at the same shapes on a
seeded do and the plain forward's o and lse, beside SDPA's backward on the
same q, k, v, do (``torch.autograd.grad`` through
``scaled_dot_product_attention``) and beside its bound (qkv, do, o and lse
read, dqkv written; 10 d FLOPs a visible pair, the five products). Each
case is first held to the plain backward (f32 atol 1e-4; bf16 within 1 ulp
plus ``flash_packed_bwd_rounding_slack`` and at most 0.1% of the elements
past 1 ulp, or 1 ulp of its own plain version in a checkout older than the
slack; two runs bitwise equal), its dqkv digest is printed (bf16 and f32),
and in bf16 its passes are split by the profiler.
``flash_fwd_cuda`` and ``flash_bwd_cuda`` (Kernels B and I) are timed the
same way at 12 heads of 64 over ``[b, h, s, d]``: the serving prefill's
two largest buckets (GPT-2 124M, b 1, s 512 and 768, causal) and the
T5-base cross-attention of ``[t5_train]`` (q [16, 12, 114, 64], k and v
[16, 12, 512, 64], not causal, ``chip_smoke.py`` ``phase_flash_bwd``'s
seeded kv_lengths), in bf16 beside SDPA and SDPA's backward (a bool key
mask for the lengths), and in f32 at s 768 and the T5 shape for the f32
kernels' digests. B is held to its plain version run in f32 (o within 1
bf16 ulp, lse within 1e-4), I to its plain version on B's o and lse
(bf16 within 1 ulp plus ``flash_bwd_rounding_slack``, at most 0.1% past
1 ulp; f32 atol 1e-4), both bitwise repeatable; their bounds count the
query rows that see a key and the K/V rows that some row sees, as
``chip_smoke.py`` does. Times are medians of CUDA-event intervals
(``conv_timing.median_ms``).
Prints one JSON line per measurement and, with ``--out``, appends them to
FILE. With ``--train`` it runs the checkout's ``chip_smoke.py`` phase
``[train]`` (GPT-2, the default) or ``[t5_train]`` instead, so that
training steps can be compared in turns as well.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from conv_timing import device_split, digest, median_ms, ulps

#: (name, b, s, causal, kv_lengths, dtype) at 12 heads of 64
CASES = [
    ("gpt2_train", 8, 1024, True, None, torch.bfloat16),
    ("t5_encoder", 16, 512, False, "enc_lengths", torch.bfloat16),
    ("t5_decoder", 16, 114, True, None, torch.bfloat16),
    ("gpt2_train_f32", 8, 1024, True, None, torch.float32),
]
HEADS, HEAD_DIM = 12, 64
#: (name, b, h, kvh, sq, sk, causal, kv_lengths, dtype) of Kernels B and I
FLASH_CASES = [
    ("serve_s512", 1, 12, 12, 512, 512, True, None, torch.bfloat16),
    ("serve_s768", 1, 12, 12, 768, 768, True, None, torch.bfloat16),
    ("t5_cross", 16, 12, 12, 114, 512, False, "t5", torch.bfloat16),
    ("serve_s768_f32", 1, 12, 12, 768, 768, True, None, torch.float32),
    ("t5_cross_f32", 16, 12, 12, 114, 512, False, "t5", torch.float32),
]


def time_case(att, name, b, s, causal, kvl, dtype, gen, emit) -> None:
    from chip_smoke import _valid_lengths, _visible_pairs, bound_ms
    d, heads = HEAD_DIM, HEADS
    if kvl == "enc_lengths":
        kvl = _valid_lengths(b, s, 14).tolist()   # chip_smoke's _t5_batch
    qkv = torch.randn(s, b, heads * 3 * d, device="cuda",
                      generator=gen).to(dtype)
    kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
    args = (kvl_t, None, None, 0.0, 1.0 / math.sqrt(d), causal, None, 1, d)
    run = lambda: att.flash_packed_fwd_cuda(qkv, *args)  # noqa: E731
    (o, lse), (o2, lse2) = run(), run()
    ro, rlse = att.flash_packed_fwd_plain(qkv, *args)
    err = dict(o_ulps=ulps(o, ro) if dtype == torch.bfloat16 else 0.0,
               o_abs=float((o.float() - ro.float()).abs().max()),
               lse_abs=float((lse - rlse).abs().max()),
               bitwise_repeat=torch.equal(o, o2) and torch.equal(lse, lse2))
    ok = (err["lse_abs"] <= 1e-4 and err["bitwise_repeat"]
          and (err["o_ulps"] <= 1.0 if dtype == torch.bfloat16
               else err["o_abs"] <= 1e-4))
    pairs = sum(_visible_pairs(s, s, causal, None,
                               s if kvl is None else kvl[r])
                for r in range(b))
    flops = 4.0 * d * heads * pairs
    n_bytes = (qkv.numel() + o.numel()) * qkv.element_size() + \
        lse.numel() * 4
    bound = bound_ms(n_bytes, flops, dtype)[0]
    t = qkv.reshape(s, b, heads, 3, d)
    q4, k4, v4 = (t[:, :, :, i].permute(1, 2, 0, 3).contiguous()
                  for i in range(3))
    mask = (None if kvl_t is None else
            (torch.arange(s, device="cuda")[None, :]
             < kvl_t[:, None])[:, None, None, :])
    ms = median_ms(run, iters=30)
    emit(kernel="flash_packed_fwd", case=name, b=b, s=s, causal=causal,
         kv_lengths=kvl, dtype=str(dtype)[6:], ms=ms,
         sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
             q4, k4, v4, attn_mask=mask, is_causal=causal), iters=30),
         bound_ms=bound, tflops=flops / ms / 1e9, ok=ok,
         sha256=digest([o, lse]), **err)
    time_bwd(att, name, b, s, causal, kvl, dtype, qkv, ro, rlse, args,
             (q4, k4, v4, mask), pairs, gen, emit)


def time_bwd(att, name, b, s, causal, kvl, dtype, qkv, o, lse, args, sdpa,
             pairs, gen, emit) -> None:
    """Kernel F at one case (see the module's docstring)."""
    from chip_smoke import bound_ms
    d, heads = HEAD_DIM, HEADS
    do = torch.randn(s, b, heads * d, device="cuda", generator=gen).to(dtype)
    run = lambda: att.flash_packed_bwd_cuda(qkv, do, o, lse, *args)  # noqa
    got, again = run(), run()
    want = att.flash_packed_bwd_plain(qkv, do, o, lse, *args)
    err = dict(dqkv_abs=float((got.float() - want.float()).abs().max()),
               bitwise_repeat=torch.equal(got, again))
    if dtype == torch.float32:
        ok = err["dqkv_abs"] <= 1e-4
    elif hasattr(att, "flash_packed_bwd_rounding_slack"):
        from chip_smoke import check_rounded_factors
        slack = att.flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
        _, err["dqkv_ulps"], err["share_past_1_ulp"], _, ok = \
            check_rounded_factors(got, want, slack)
        del slack
    else:
        err["dqkv_ulps"] = ulps(got, want)
        ok = err["dqkv_ulps"] <= 1.0
    del want
    ok = ok and err["bitwise_repeat"]
    flops = 10.0 * d * heads * pairs
    n_bytes = (2 * qkv.numel() + 2 * o.numel()) * qkv.element_size() + \
        lse.numel() * 4
    bound = bound_ms(n_bytes, flops, dtype)[0]
    q4, k4, v4, mask = (t if t is None or t.dtype == torch.bool
                        else t.detach().clone().requires_grad_()
                        for t in sdpa)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                          is_causal=causal)
    do4 = do.reshape(s, b, heads, d).permute(1, 2, 0, 3).contiguous()
    ms = median_ms(run, iters=30)
    emit(kernel="flash_packed_bwd", case=name, b=b, s=s, causal=causal,
         kv_lengths=kvl, dtype=str(dtype)[6:], ms=ms,
         sdpa_bwd_ms=median_ms(lambda: torch.autograd.grad(
             out4, (q4, k4, v4), do4, retain_graph=True), iters=30),
         bound_ms=bound, tflops=flops / ms / 1e9, ok=ok,
         sha256=digest([got]),
         split=device_split(run) if dtype == torch.bfloat16 else None, **err)


def time_flash(att, name, b, h, kvh, sq, sk, causal, kvl, dtype, gen,
               emit) -> None:
    """Kernels B and I at one case (see the module's docstring)."""
    from chip_smoke import (_valid_lengths, _visible_pairs,
                            _visible_rows_keys, bound_ms)
    d = HEAD_DIM
    gen.manual_seed(11)  # inputs that do not depend on the cases run before
    if kvl == "t5":
        kvl = _valid_lengths(b, sk, 11).tolist()  # phase_flash_bwd's
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, kvh, sk, d, device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
    args = (kvl_t, 1.0 / math.sqrt(d), causal, None)
    run = lambda: att.flash_fwd_cuda(q, k, v, *args)  # noqa: E731
    (o, lse), (o2, lse2) = run(), run()
    ro, rlse = att.flash_fwd_plain(q.float(), k.float(), v.float(), *args)
    bf16 = dtype == torch.bfloat16
    err = dict(o_ulps=ulps(o, ro.to(dtype)) if bf16 else 0.0,
               o_abs=float((o.float() - ro).abs().max()),
               lse_abs=float((lse - rlse).abs().max()),
               bitwise_repeat=torch.equal(o, o2) and torch.equal(lse, lse2))
    ok = (err["lse_abs"] <= 1e-4 and err["bitwise_repeat"]
          and (err["o_ulps"] <= 1.0 if bf16 else err["o_abs"] <= 1e-4))
    lengths = [sk] * b if kvl is None else kvl
    pairs = sum(_visible_pairs(sq, sk, causal, None, n) for n in lengths)
    rows, keys = (sum(t) for t in zip(*(
        _visible_rows_keys(sq, sk, causal, None, n) for n in lengths)))
    esz = q.element_size()
    # reads: q rows that see a key, K/V rows some row sees, kv_lengths;
    # writes: o and lse whole
    n_bytes = (rows * h * d + 2 * keys * kvh * d + o.numel()) * esz + \
        lse.numel() * 4 + (0 if kvl is None else 4 * b)
    flops = 4.0 * d * h * pairs
    mask = (None if kvl_t is None else
            (torch.arange(sk, device="cuda")[None, :]
             < kvl_t[:, None])[:, None, None, :])
    ms = median_ms(run, iters=30)
    emit(kernel="flash_fwd", case=name, b=b, h=h, kvh=kvh, sq=sq, sk=sk,
         causal=causal, kv_lengths=kvl, dtype=str(dtype)[6:], ms=ms,
         sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, attn_mask=mask, is_causal=causal), iters=30),
         bound_ms=bound_ms(n_bytes, flops, dtype)[0],
         tflops=flops / ms / 1e9, ok=ok, sha256=digest([o, lse]), **err)
    del ro, rlse, o2, lse2

    do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    run = lambda: att.flash_bwd_cuda(q, k, v, do, o, lse, *args)  # noqa
    got, again = run(), run()
    want = att.flash_bwd_plain(q, k, v, do, o, lse, *args)
    err = dict(bitwise_repeat=all(torch.equal(a, g)
                                  for a, g in zip(again, got)),
               abs=max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(got, want)))
    ok = err["bitwise_repeat"]
    if bf16:
        from chip_smoke import check_rounded_factors
        slack = att.flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
        checks = [check_rounded_factors(g, w, sl)
                  for g, w, sl in zip(got, want, slack)]
        err["ulps"] = max(c[1] for c in checks)
        err["share_past_1_ulp"] = max(c[2] for c in checks)
        ok = ok and all(c[4] for c in checks)
        del slack
    else:
        ok = ok and err["abs"] <= 1e-4
    del want, again
    # reads: q, o, do and lse of the rows that see a key, K/V rows some
    # row sees, kv_lengths; writes: dq, dk and dv whole
    n_bytes = (3 * rows * h * d + 2 * keys * kvh * d + q.numel()
               + 2 * k.numel()) * esz + rows * h * 4 + \
        (0 if kvl is None else 4 * b)
    flops = 10.0 * d * h * pairs
    q4, k4, v4 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                          is_causal=causal)
    ms = median_ms(run, iters=30)
    emit(kernel="flash_bwd", case=name, b=b, h=h, kvh=kvh, sq=sq, sk=sk,
         causal=causal, kv_lengths=kvl, dtype=str(dtype)[6:], ms=ms,
         sdpa_bwd_ms=median_ms(lambda: torch.autograd.grad(
             out4, (q4, k4, v4), do, retain_graph=True), iters=30),
         bound_ms=bound_ms(n_bytes, flops, dtype)[0],
         tflops=flops / ms / 1e9, ok=ok, sha256=digest(got),
         split=device_split(run) if bf16 else None, **err)


def time_train(phase, emit) -> None:
    """``chip_smoke.py``'s ``[train]`` or ``[t5_train]`` phase of the
    ``--root`` checkout (2 warm-up and 8 timed steps on one seeded batch,
    its losses and launches checked); its line is printed and its step
    time, throughput, MFU and peak memory emitted."""
    import chip_smoke
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        getattr(chip_smoke, f"phase_{phase}")()
    print(buf.getvalue(), end="", flush=True)
    fields = re.findall(r"(step_ms_median|tokens_per_s|mfu|peak_mem_gb)="
                        r"([0-9.]+)", buf.getvalue())
    emit(kernel=phase, case=phase, **{k: float(v) for k, v in fields})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--train", nargs="?", const="train", default=None,
                        choices=("train", "t5_train"),
                        help="run the checkout's train (or t5_train) phase "
                        "instead of timing the kernel")
    parser.add_argument("--cases", default=None,
                        help="comma-separated case names (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attn_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import attention as att
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def emit(**fields):
        row = dict(tag=args.tag, card=card, **fields)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if args.train:
        time_train(args.train, emit)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(9)
    for cases, time_fn in ((CASES, time_case), (FLASH_CASES, time_flash)):
        for case in cases:
            if args.cases and case[0] not in args.cases.split(","):
                continue
            time_fn(att, *case, gen, emit)
            torch.cuda.empty_cache()
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
