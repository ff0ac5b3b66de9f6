#!/usr/bin/env python3
"""Digests of the attention kernels' outputs, so that two versions of
Kernels B, I, E, F and C can be compared bit for bit.

Usage (from a checkout's root, on a machine with one GPU)::

    python3 apex_tpu_torch/tools/attn_digests.py [--root DIR] [--tag NAME]
        [--out FILE]

``--root`` names the checkout whose ``apex_tpu_torch`` is imported and
built (default: the one holding this file). The cases are those of
``tests/test_torch_cuda.py``, read from its tables (``FLASH_BWD``,
``PACKED``, ``PAGED``) in this tool's checkout, then those of
``tests/test_torch_cuda_hd1024.py`` (``WIDE_PACKED``, ``WIDE_FLASH``,
``WIDE_PAGED``: head dims past 512) where this checkout has it; a case
that the imported checkout refuses (a parent without them) prints its
error in place of digests. Every
case draws its inputs from a generator seeded by its name and dtype,
runs the kernel's wrapper once and prints one JSON line with the sha256
(16 hex digits) of its outputs: Kernels E and F
(``flash_packed_fwd_cuda``, then ``flash_packed_bwd_cuda`` on E's o and
lse) and B and I (``flash_fwd_cuda``, then ``flash_bwd_cuda`` on B's o
and lse), in f32, bf16 and fp16; Kernel C (``paged_decode_cuda``) at
w = 1 and 4 query rows, over pools of q's dtype and int8, at pages of 16
and 64, on whichever path its plan takes. Run it on two checkouts and
compare the lines by ``case``: equal digests mean bitwise equal outputs.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the card tests whose case tables this tool runs
TESTS = Path(__file__).resolve().parents[2] / "tests" / "test_torch_cuda.py"
WIDE_TESTS = TESTS.with_name("test_torch_cuda_hd1024.py")
#: Kernel C's cases run at each (w, int8 pools, page size)
PAGED_RUNS = [(w, int8, ps) for ps in (16, 64) for int8 in (False, True)
              for w in (1, 4)]


def _tables(path: Path = TESTS) -> dict:
    """The literal case tables of the card tests (``FLASH_BWD``,
    ``PACKED``, ``PAGED``, ``PAGED_POSITIONS``), read from their source
    without importing it (the tests import this checkout's package, which
    ``--root`` may not name): ``FLASH_BWD = dict(FLASH, name=case, ...)``
    is FLASH with its keywords added."""
    values = {}
    for node in ast.parse(path.read_text()).body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name, value = node.targets[0].id, node.value
        if isinstance(value, ast.Call) and getattr(value.func, "id", "") \
                == "dict" and value.args:
            table = dict(values[value.args[0].id])
            table.update({k.arg: ast.literal_eval(k.value)
                          for k in value.keywords})
            values[name] = table
        elif name in ("FLASH", "PACKED", "PAGED", "PAGED_POSITIONS",
                      "WIDE_PACKED", "WIDE_FLASH", "WIDE_PAGED"):
            values[name] = ast.literal_eval(value)
    return values


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _gen(name: str, dtype) -> torch.Generator:
    """A generator seeded from the case and dtype alone."""
    seed = int(hashlib.sha256(f"{name}/{dtype}".encode()).hexdigest()[:8],
               16)
    return torch.Generator(device="cuda").manual_seed(seed)


def packed_case(att, rope_mod, name, case, dtype) -> dict:
    b, s, g, qpg, d, causal, kvl, window, rot, rate = case
    gen = _gen(name, dtype)
    qkv = torch.randn(s, b, g * (qpg + 2) * d, device="cuda",
                      generator=gen).to(dtype)
    do = torch.randn(s, b, g * qpg * d, device="cuda",
                     generator=gen).to(dtype)
    kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
    rope = None
    if rot:
        rope = rope_mod.rope_tables(rope_mod.rope_freqs(
            0, s, rot, 10000.0, device="cuda"), s, d)
    args = (kvl_t, rope, -12345 if rate else None, rate, 1.0 / math.sqrt(d),
            causal, window, qpg, d)
    o, lse = att.flash_packed_fwd_cuda(qkv, *args)
    dqkv = att.flash_packed_bwd_cuda(qkv, do, o, lse, *args)
    return dict(kernels="e,f", o=digest([o, lse]), grads=digest([dqkv]))


def flash_case(att, name, case, dtype) -> dict:
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    gen = _gen(name, dtype)
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, kvh, sk, d, device="cuda", generator=gen).to(
        dtype) for _ in range(2))
    do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    kvl_t = None if kvl is None else torch.tensor(kvl, device="cuda")
    args = (kvl_t, 1.0 / math.sqrt(d), causal, window)
    o, lse = att.flash_fwd_cuda(q, k, v, *args)
    grads = att.flash_bwd_cuda(q, k, v, do, o, lse, *args)
    return dict(kernels="b,i", o=digest([o, lse]), grads=digest(grads))


def paged_case(da, name, case, positions, dtype, w, int8, ps) -> dict:
    """Kernel C over 128 rows a slot in pages of ``ps``, slot r at
    ``positions[r]``."""
    b, hl, group, dh, window = case
    gen = _gen(name, dtype)
    pps, n_pages = 128 // ps, 40 * 16 // ps
    f = hl // group * dh
    pos_t = torch.tensor(positions[:b], dtype=torch.int32)
    table = torch.full((b, pps), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(1))
    used = 0
    for r in range(b):
        need = min(pps, int(pos_t[r]) // ps + 1)
        table[r, :need] = perm[used:used + need]
        used += need
    if b > 5:
        table[5, 1] = n_pages      # a sentinel (in slot 5's range at 16)
    pt, pos = table.cuda(), pos_t.cuda()
    q = torch.randn(b, w, hl, dh, device="cuda", generator=gen).to(dtype)
    ks = vs = None
    if int8:
        kp, vp = (da.page_pool(n_pages, ps, f, torch.int8, "cuda")
                  for _ in range(2))
        ks, vs = (da.scale_pool(n_pages, hl // group, "cuda")
                  for _ in range(2))
        for pool, sc in ((kp, ks), (vp, vs)):
            pool.copy_(torch.randint(-127, 128, pool.shape, device="cuda",
                                     generator=gen))
            sc.copy_(torch.rand(sc.shape, device="cuda", generator=gen)
                     * (4 / 127))
    else:
        kp, vp = (da.page_pool(n_pages, ps, f, dtype, "cuda")
                  for _ in range(2))
        kp.copy_(torch.randn(kp.shape, device="cuda", generator=gen))
        vp.copy_(torch.randn(vp.shape, device="cuda", generator=gen))
    if w == 1:
        q = q[:, 0]
    plan = da.paged_decode_cuda_plan(q, kp, vp, pt, group, window)
    ctx = da.paged_decode_cuda(q, kp, vp, pt, pos, group, window, ks, vs)
    return dict(kernels="c", path=plan.path, o=digest([ctx]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attn_digests: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from apex_tpu_torch.ops import attention as att
    from apex_tpu_torch.ops import decode_attention as da
    from apex_tpu_torch.ops import rope as rope_mod
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(case, dtype, run):
        try:
            fields = run()
        except (RuntimeError, ValueError) as exc:
            fields = dict(error=str(exc).splitlines()[0][:120])
        row = dict(tag=args.tag, card=card, case=f"{case}/{str(dtype)[6:]}",
                   **fields)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")

    tables = _tables()
    if WIDE_TESTS.exists():
        wide = _tables(WIDE_TESTS)
        for key, wide_key in (("PACKED", "WIDE_PACKED"),
                              ("FLASH_BWD", "WIDE_FLASH"),
                              ("PAGED", "WIDE_PAGED")):
            tables[key] = dict(tables[key], **wide[wide_key])
    for dtype in DTYPES:
        for name, case in tables["PACKED"].items():
            emit(name, dtype, lambda: packed_case(att, rope_mod, name, case,
                                                  dtype))
        for name, case in tables["FLASH_BWD"].items():
            emit(name, dtype, lambda: flash_case(att, name, case, dtype))
        for name, case in tables["PAGED"].items():
            for w, int8, ps in PAGED_RUNS:
                emit(f"{name}_w{w}{'_int8' if int8 else ''}_page{ps}",
                     dtype, lambda: paged_case(
                         da, name, case, tables["PAGED_POSITIONS"], dtype, w,
                         int8, ps))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
