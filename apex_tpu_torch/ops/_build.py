"""Build and load the port's CUDA kernels.

The sources under ``apex_tpu_torch/csrc/*.cu`` have a plain C interface
(no PyTorch headers), so each compiles in seconds. On first use
:func:`library` runs one ``nvcc`` per source, all started together, links
the objects into ``build/apex_tpu_torch/libapex_tpu_torch_kernels.so``
and loads it with :mod:`ctypes`. A content stamp over the sources and
flags skips the build when nothing changed. Pointer and stream arguments
are ``c_void_p``; every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["library", "check", "build_seconds", "SOURCE_DIR", "BUILD_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
LIB_NAME = "libapex_tpu_torch_kernels.so"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
#: C signature of every entry point (see the ``extern "C"`` blocks)
_SIGNATURES = {
    # x, w, b, y, mean, invvar, stream, m, h, eps, is_rms, x/w/y dtypes,
    # then the plan: pieces a lane, lanes a row, blocks, rows a block, wide
    "apex_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    # pieces a lane, x/w/y dtypes, out: resident blocks an SM
    "apex_layer_norm_fwd_blocks_per_sm": [_I, _I, _I, _I, _P],
    # dy, x, mean, invvar, w, dx, partial, dw, db, stream, m, h, is_rms,
    # dy/x/w dtypes, then the plan as the forward's
    "apex_layer_norm_bwd": [_P] * 10 + [_I] * 11,
    # h, pieces a lane, x/w dtypes, affine (0, 1 weight, 2 and bias), out:
    # resident blocks an SM
    "apex_layer_norm_bwd_blocks_per_sm": [_I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse, kv_lengths, stream, b, h, kvh, sq, sk, d, scale,
    # causal, window, q_start, k_start, dtype
    "apex_flash_fwd": [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I],
    # q, k, v, o, do, lse, delta, dq, dk, dv, kv_lengths, stream, b, h, kvh,
    # sq, sk, d, scale, causal, window, q_start, k_start, delta_given, dtype
    "apex_flash_bwd": [_P] * 12 + [_I] * 6 + [_F] + [_I] * 6,
    # q, k_pages, v_pages, page_table, positions, ctx, workspace, counters,
    # stream, b, hl, kvh, dh, n_pages, page_size, pages_per_slot, window,
    # dtype, then the plan: pieces a lane, lanes a row, query heads a block,
    # pages a split, splits
    "apex_paged_decode": [_P] * 11 + [_I] * 16,
    # dtype, pieces a lane, query heads a block, head_dim, out: resident
    # blocks an SM
    "apex_paged_decode_blocks_per_sm": [_I] * 6 + [_P],
    # qkv, o, lse, kv_lengths, cos, sin, seed, stream, s, b, groups, qpg,
    # d, scale, causal, window, rot, keep_thresh, inv_keep, dtype
    "apex_flash_packed_fwd": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _I, _U, _F,
                                                    _I],
    # qkv, do, o, lse, delta, dqkv, kv_lengths, cos, sin, seed, stream,
    # then as the forward
    "apex_flash_packed_bwd": [_P] * 11 + [_I] * 5 + [_F, _I, _I, _I, _U, _F,
                                                     _I],
    # x, mask, y, stream, rows, k, d1, d2, mask strides (4), scale, sq,
    # causal, dtype, pieces a lane, lanes a row
    "apex_softmax_fwd": [_P, _P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _L, _F,
                         _I, _I, _I, _I, _I],
    # dy, y, dx, stream, rows, k, scale, dtype
    "apex_softmax_bwd": [_P, _P, _P, _P, _L, _I, _F, _I],
    # x, a, b, w, c, y, partial, stats, z (bf16 scratch), stream, m, k, n,
    # affine, relu, dtype
    "apex_conv1x1_fwd": [_P] * 10 + [_I] * 6,
    # x, a, b, w, c, y, partial, stats, z (bf16 scratch), stream, images, h,
    # w, k, n, affine, relu, dtype
    "apex_conv3x3_fwd": [_P] * 10 + [_I] * 8,
    # x, a, b, w, c, y, dy, ds, dx, dw_partial, dw, dab_partial, dab, dy_eff,
    # z (bf16 scratch), stream, m, k, n, chunk_rows, affine, relu, dtype
    "apex_conv1x1_bwd": [_P] * 16 + [_I] * 7,
    # as the 1x1 with images, h, w in place of m
    "apex_conv3x3_bwd": [_P] * 16 + [_I] * 9,
    # multi-tensor kernels: records (device), chunk counts (host), records,
    # stream, then each kernel's own (csrc/multi_tensor.cu)
    # scale, found_inf
    "apex_mt_scale": [_P, _P, _I, _P, _P, _P],
    # list, scale, partial
    "apex_mt_l2norm": [_P, _P, _I, _P, _I, _P, _P],
    # chunk_start, partial, n, per_tensor, total, stream
    "apex_mt_l2norm_finish": [_P, _P, _I, _P, _P, _P],
    # master list, lr, lr_ptr, scale, found_inf, wd, b1, b2, 1 - b1, 1 - b2,
    # eps, adam_w, bias_correction
    "apex_mt_adam": [_P, _P, _I, _P, _I, _F, _P, _P, _P] + [_F] * 6
    + [_I, _I],
    # master list, scale, found_inf, wd, b1, b2, beta3, 1 - b2, eps, adam_w,
    # bias_correction, gnorm, max_grad_norm, 1 / max_grad_norm
    "apex_mt_lamb_stage1": [_P, _P, _I, _P, _I, _P, _P] + [_F] * 6
    + [_I, _I, _P, _F, _F],
    # master list, lr, lr_ptr, found_inf, w_norm, u_norm, adapt, trust_clip
    "apex_mt_lamb_stage2": [_P, _P, _I, _P, _I, _F, _P, _P, _P, _P, _I, _I],
    # buf list, master list, lr, lr_ptr, scale, found_inf, wd, momentum,
    # 1 - dampening, nesterov, wd_after_momentum
    "apex_mt_sgd": [_P, _P, _I, _P, _I, _I, _F, _P, _P, _P, _F, _F, _F, _I,
                    _I],
    # step addresses, n, stream, found_inf
    "apex_mt_bump": [_P, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall seconds the last build took (0.0 when the stamp matched)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "are built from source on first use")


def _sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _stamp() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, stamp_path: Path, stamp: str) -> None:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *_FLAGS, "-Xptxas=-v", "-I", str(SOURCE_DIR), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors, logs = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        text = f"{src.name}:\n{out.decode(errors='replace')}"
        logs.append(text)
        if proc.returncode:
            errors.append(text)
    # ptxas registers / shared memory / spills of every kernel
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError(
            "nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)
    stamp_path.write_text(stamp)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / LIB_NAME
        stamp_path = BUILD_DIR / (LIB_NAME + ".stamp")
        stamp = _stamp()
        if not (lib_path.exists() and stamp_path.exists()
                and stamp_path.read_text() == stamp):
            _build(lib_path, stamp_path, stamp)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.apex_error_string.argtypes = [ctypes.c_int]
        lib.apex_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(name: str, status: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if status != 0:
        text = library().apex_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")
