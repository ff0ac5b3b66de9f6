"""Fused 1x1 and 3x3 convolutions with the input batch-norm affine/ReLU and
the output's batch statistics, forward and backward.

Counterpart of ``apex_tpu/ops/conv_fused.py``: ``y = conv(relu(x * a +
b), w)`` with per-channel shifted sums ``stats = (sum(y - c), sum((y -
c)^2))`` of the output, the statistics the next batch norm closes. The
backward folds the statistics cotangent into ``dy`` and recomputes ``z``
from the saved input. Layout: NHWC activations, HWIO weights (a 1x1 conv
is the GEMM ``x [M, K] @ w [K, N]``).

A CUDA tensor launches the hand-written kernels — ``csrc/conv1x1_fwd.cu``
(Kernel J), ``csrc/conv1x1_bwd.cu`` (K), ``csrc/conv3x3_fwd.cu`` (L) and
``csrc/conv3x3_bwd.cu`` (M); a CPU tensor runs the plain versions beside
them, which write the kernels' math out term by term (z and ``dy_eff``
rounded to w's dtype, then fp32 products; each output rounded once).

The TPU's VMEM gates (``k * n <= 3 << 19`` for the 1x1, ``54 k n <= 8 MiB``
and ``H W <= 1024`` for the 3x3) are not carried over: every shape takes
the kernel. One consequence, by design: in bf16 at the shapes the TPU
gated off, the JAX package's ``_c3_ref_impl`` reduces the statistics from
the bf16-rounded output, the port (as every kernel) from the fp32
accumulator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import _build, _support

__all__ = ["conv1x1_bn_act", "conv3x3_bn_act", "conv1x1_fwd_plain",
           "conv1x1_fwd_cuda", "conv1x1_bwd_plain", "conv1x1_bwd_cuda",
           "conv3x3_fwd_plain", "conv3x3_fwd_cuda", "conv3x3_bwd_plain",
           "conv3x3_bwd_cuda", "dw_chunks"]

#: rows per block of every pass (``kBM`` in csrc/conv_fused.cuh)
_BM = 64
#: the dW passes aim at four blocks per SM of an H100 (132 SMs) ...
_FILL_BLOCKS = 4 * 132
#: ... with at least this many rows of M a chunk
_MIN_CHUNK_ROWS = 256
#: the 3x3 dW grid's z extent is 9 x chunks <= 65535
_MAX_CHUNKS_3X3 = 65535 // 9


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def dw_chunks(m: int, tiles: int, max_chunks: int = 65535) -> Tuple[int, int]:
    """``(chunks, rows per chunk)`` of a dW pass over ``m`` rows whose
    output has ``tiles`` 64 x 64 tiles: enough blocks (tiles x chunks) to
    fill the card, at least 256 rows a chunk. Layer1 of ResNet-50 (m =
    802,816, K N = 16k: 4 tiles) takes 132 chunks; layer4 (m = 12,544,
    K N = 1M: 256 tiles) takes 3."""
    chunks = max(1, min(_support.cdiv(_FILL_BLOCKS, tiles),
                        _support.cdiv(m, _MIN_CHUNK_ROWS), max_chunks))
    rows = _support.cdiv(m, chunks)
    return _support.cdiv(m, rows), rows


def _tiles(k: int, n: int) -> int:
    return _support.cdiv(k, _BM) * _support.cdiv(n, _BM)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _z(x, a, b, affine: bool, relu: bool, dtype: torch.dtype):
    """The product's left operand: ``relu?(x * a + b)`` in fp32 rounded to
    ``dtype``, or ``x`` cast to it."""
    if not affine:
        return x.to(dtype)
    z = x.float() * a + b
    if relu:
        z = z.clamp_min(0.0)
    return z.to(dtype)


def _pre_z(x32, a, b, affine: bool, relu: bool):
    """``(pre, z)`` of the backward in fp32: ``pre = x * a + b`` (None
    without the affine) and z before its rounding."""
    if not affine:
        return None, x32
    pre = x32 * a + b
    return pre, (pre.clamp_min(0.0) if relu else pre)


def _dy_eff(dy, y, shift, ds, dtype: torch.dtype):
    """``dy + ds0 + 2 (y - c) ds1`` in fp32, rounded to ``dtype`` and
    widened again: the statistics cotangent folded into ``dy``."""
    d = (dy.float() + ds[0]) + 2.0 * (y.float() - shift) * ds[1]
    return d.to(dtype).float()


def _stats(y32, shift):
    yc = y32 - shift
    return torch.stack([yc.sum(0), (yc * yc).sum(0)])


def _dx_dab(dz, x32, a, pre, affine: bool, relu: bool, dims):
    """``(dx in fp32, [da; db] or None)`` from dz: the relu mask of
    ``pre``, ``da = sum(dg x)``, ``db = sum(dg)`` over ``dims``."""
    if not affine:
        return dz, None
    dg = torch.where(pre > 0.0, dz, torch.zeros_like(dz)) if relu else dz
    dab = torch.stack([(dg * x32).sum(dims), dg.sum(dims)])
    return dg * a, dab


def conv1x1_fwd_plain(x2, a, b, w, shift, affine: bool, relu: bool):
    """Plain version of Kernel J over ``x2 [M, K]``, ``w [K, N]``: ``(y in
    x's dtype, stats [2, N] fp32)`` — the JAX package's ``_ref_impl``."""
    z = _z(x2, a, b, affine, relu, w.dtype).float()
    y = z @ w.float()
    return y.to(x2.dtype), _stats(y, shift)


def conv1x1_bwd_plain(x2, a, b, w, shift, y, dy, ds, affine: bool,
                      relu: bool):
    """Plain version of Kernel K, ``_bwd_kernel``'s math written out:
    ``(dx in x's dtype, dW [K, N] fp32, [da; db] [2, K] fp32 or None)``."""
    dyc = _dy_eff(dy, y, shift, ds, w.dtype)
    x32 = x2.float()
    pre, z = _pre_z(x32, a, b, affine, relu)
    zc = z.to(w.dtype).float()
    dw = zc.t() @ dyc
    dz = dyc @ w.float().t()
    dx, dab = _dx_dab(dz, x32, a, pre, affine, relu, 0)
    return dx.to(x2.dtype), dw, dab


def _taps(t, h: int, wd: int):
    """``(dr, dc, tap)``: the nine ``[n h w, c]`` slices of ``t [n, h, w,
    c]`` zero-padded by one pixel; tap (dr, dc) reads t at (row + dr - 1,
    column + dc - 1)."""
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    for dr in range(3):
        for dc in range(3):
            yield dr, dc, p[:, dr:dr + h, dc:dc + wd, :].reshape(
                -1, t.shape[-1])


def conv3x3_fwd_plain(x, a, b, w, shift, affine: bool, relu: bool):
    """Plain version of Kernel L over ``x [N, H, W, K]``, ``w [3, 3, K,
    N']``: z zero-padded after the affine, nine shifted fp32 products,
    stats from the fp32 sum; ``(y in x's dtype, stats [2, N'])``."""
    n_img, h, wd, _ = x.shape
    n = w.shape[-1]
    z = _z(x, a, b, affine, relu, w.dtype).float()
    w32 = w.float()
    y = torch.zeros((n_img * h * wd, n), dtype=torch.float32, device=x.device)
    for dr, dc, tap in _taps(z, h, wd):
        y += tap @ w32[dr, dc]
    return y.reshape(n_img, h, wd, n).to(x.dtype), _stats(y, shift)


def conv3x3_bwd_plain(x, a, b, w, shift, y, dy, ds, affine: bool,
                      relu: bool):
    """Plain version of Kernel M, ``_c3_bwd_kernel``'s math written out:
    dW[dr, dc] from the shifted z, dz as the transposed convolution of
    ``dy_eff`` (nine products added into a padded buffer), then Kernel K's
    epilogue. ``(dx, dW [3, 3, K, N'] fp32, [da; db] or None)``."""
    n_img, h, wd, k = x.shape
    n = w.shape[-1]
    dyc = _dy_eff(dy, y, shift, ds, w.dtype).reshape(-1, n)
    x32 = x.float()
    pre, z = _pre_z(x32, a, b, affine, relu)
    zc = z.to(w.dtype).float()
    w32 = w.float()
    dw = torch.empty((3, 3, k, n), dtype=torch.float32, device=x.device)
    dzp = torch.zeros((n_img, h + 2, wd + 2, k), dtype=torch.float32,
                      device=x.device)
    for dr, dc, tap in _taps(zc, h, wd):
        dw[dr, dc] = tap.t() @ dyc
        dzp[:, dr:dr + h, dc:dc + wd, :] += (dyc @ w32[dr, dc].t()).reshape(
            n_img, h, wd, k)
    dz = dzp[:, 1:h + 1, 1:wd + 1, :]
    dx, dab = _dx_dab(dz, x32, a, pre, affine, relu, (0, 1, 2))
    return dx.to(x.dtype), dw, dab


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(op: str, x, w, a, b, shift, k: int, n: int, affine: bool,
           relu: bool, *more):
    """Raise on what the kernels do not take; returns the dtype code."""
    if x.dtype != w.dtype or any(t.dtype != x.dtype for t in more):
        raise TypeError(f"{op}: x, w (and y, dy) must share one dtype, got "
                        f"{x.dtype}, {w.dtype}"
                        f"{''.join(', ' + str(t.dtype) for t in more)}")
    code = _support.dtype_code(x.dtype)
    if k <= 0 or n <= 0:
        raise ValueError(f"{op}: channel counts must be positive, got K={k} "
                         f"N={n}")
    if relu and not affine:
        raise ValueError(f"{op}: relu requires the input affine")
    for name, t, size in (("a", a, k), ("b", b, k), ("stats_shift", shift,
                                                     n)):
        if t is None:
            if name != "stats_shift" and affine:
                raise ValueError(f"{op}: the affine needs both a and b")
            continue
        if t.dtype != torch.float32 or t.numel() != size:
            raise ValueError(f"{op}: {name} must be fp32 with {size} "
                             f"elements, got {t.dtype} {tuple(t.shape)}")
    return code


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def conv1x1_fwd_cuda(x2, a, b, w, shift, affine: bool, relu: bool):
    """Launch Kernel J on ``x2 [M, K]``, ``w [K, N]`` (one CUDA device)."""
    m, k = x2.shape
    n = w.shape[1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"conv1x1: w {tuple(w.shape)} is not [{k}, N]")
    code = _check("conv1x1_fwd", x2, w, a, b, shift, k, n, affine, relu)
    x2, a, b, w, shift = _contig(x2, a, b, w, shift)
    dev = x2.device
    y = torch.empty((m, n), dtype=x2.dtype, device=dev)
    stats = torch.zeros((2, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y, stats
    partial = torch.empty((_support.cdiv(m, _BM), 2, n), dtype=torch.float32,
                          device=dev)
    status = _build.library().apex_conv1x1_fwd(
        _ptr(x2), _ptr(a), _ptr(b), _ptr(w), _ptr(shift), _ptr(y),
        _ptr(partial), _ptr(stats), _stream(dev), m, k, n, int(affine),
        int(relu), code)
    _build.check("apex_conv1x1_fwd", status)
    _support.count_launch("conv1x1_fwd")
    return y, stats


def conv1x1_bwd_cuda(x2, a, b, w, shift, y, dy, ds, affine: bool,
                     relu: bool):
    """Launch Kernel K: the dx pass, the chunked dW pass and the partial
    reductions; ``(dx, dW fp32, [da; db] or None)``."""
    m, k = x2.shape
    n = w.shape[1]
    code = _check("conv1x1_bwd", x2, w, a, b, shift, k, n, affine, relu, y,
                  dy)
    x2, a, b, w, shift, y, dy, ds = _contig(x2, a, b, w, shift, y, dy,
                                            ds.float())
    dev = x2.device
    dx = torch.empty((m, k), dtype=x2.dtype, device=dev)
    dw = torch.zeros((k, n), dtype=torch.float32, device=dev)
    dab = (torch.zeros((2, k), dtype=torch.float32, device=dev) if affine
           else None)
    if m == 0:
        return dx, dw, dab
    chunks, rows = dw_chunks(m, _tiles(k, n))
    dw_partial = torch.empty((chunks, k, n), dtype=torch.float32, device=dev)
    dab_partial = (torch.empty((_support.cdiv(m, _BM), 2, k),
                               dtype=torch.float32, device=dev)
                   if affine else None)
    status = _build.library().apex_conv1x1_bwd(
        _ptr(x2), _ptr(a), _ptr(b), _ptr(w), _ptr(shift), _ptr(y), _ptr(dy),
        _ptr(ds), _ptr(dx), _ptr(dw_partial), _ptr(dw), _ptr(dab_partial),
        _ptr(dab), _stream(dev), m, k, n, rows, int(affine), int(relu), code)
    _build.check("apex_conv1x1_bwd", status)
    _support.count_launch("conv1x1_bwd")
    return dx, dw, dab


def _c3_shapes(x, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [N, H, W, K] and "
                         f"[3, 3, K, N']")
    return (*x.shape, w.shape[3])


def conv3x3_fwd_cuda(x, a, b, w, shift, affine: bool, relu: bool):
    """Launch Kernel L on ``x [N, H, W, K]``, ``w [3, 3, K, N']``."""
    n_img, h, wd, k, n = _c3_shapes(x, w)
    code = _check("conv3x3_fwd", x, w, a, b, shift, k, n, affine, relu)
    x, a, b, w, shift = _contig(x, a, b, w, shift)
    dev = x.device
    m = n_img * h * wd
    y = torch.empty((n_img, h, wd, n), dtype=x.dtype, device=dev)
    stats = torch.zeros((2, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y, stats
    partial = torch.empty((_support.cdiv(m, _BM), 2, n), dtype=torch.float32,
                          device=dev)
    status = _build.library().apex_conv3x3_fwd(
        _ptr(x), _ptr(a), _ptr(b), _ptr(w), _ptr(shift), _ptr(y),
        _ptr(partial), _ptr(stats), _stream(dev), n_img, h, wd, k, n,
        int(affine), int(relu), code)
    _build.check("apex_conv3x3_fwd", status)
    _support.count_launch("conv3x3_fwd")
    return y, stats


def conv3x3_bwd_cuda(x, a, b, w, shift, y, dy, ds, affine: bool, relu: bool):
    """Launch Kernel M: the dx pass (transposed convolution), the dW pass
    over (tap, chunk) and the partial reductions."""
    n_img, h, wd, k, n = _c3_shapes(x, w)
    code = _check("conv3x3_bwd", x, w, a, b, shift, k, n, affine, relu, y,
                  dy)
    x, a, b, w, shift, y, dy, ds = _contig(x, a, b, w, shift, y, dy,
                                           ds.float())
    dev = x.device
    m = n_img * h * wd
    dx = torch.empty((n_img, h, wd, k), dtype=x.dtype, device=dev)
    dw = torch.zeros((3, 3, k, n), dtype=torch.float32, device=dev)
    dab = (torch.zeros((2, k), dtype=torch.float32, device=dev) if affine
           else None)
    if m == 0:
        return dx, dw, dab
    chunks, rows = dw_chunks(m, 9 * _tiles(k, n), _MAX_CHUNKS_3X3)
    dw_partial = torch.empty((chunks, 9, k, n), dtype=torch.float32,
                             device=dev)
    dab_partial = (torch.empty((_support.cdiv(m, _BM), 2, k),
                               dtype=torch.float32, device=dev)
                   if affine else None)
    status = _build.library().apex_conv3x3_bwd(
        _ptr(x), _ptr(a), _ptr(b), _ptr(w), _ptr(shift), _ptr(y), _ptr(dy),
        _ptr(ds), _ptr(dx), _ptr(dw_partial), _ptr(dw), _ptr(dab_partial),
        _ptr(dab), _stream(dev), n_img, h, wd, k, n, rows, int(affine),
        int(relu), code)
    _build.check("apex_conv3x3_bwd", status)
    _support.count_launch("conv3x3_bwd")
    return dx, dw, dab


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _fused_forward(plain, cuda, ctx, x, a, b, w, shift, affine, relu):
    fwd = plain if _support.is_cpu(x, a, b, w, shift) else cuda
    y, stats = fwd(x, a, b, w, shift, affine, relu)
    ctx.save_for_backward(x, a, b, w, shift, y)
    ctx.affine, ctx.relu = affine, relu
    return y, stats


def _fused_backward(plain, cuda, ctx, dy, ds):
    """dx, da and db (fp32), dw in w's dtype, and nothing for the shift
    (statistics-driven, as in the JAX custom VJP)."""
    x, a, b, w, shift, y = ctx.saved_tensors
    bwd = plain if _support.is_cpu(x, dy, ds) else cuda
    dx, dw, dab = bwd(x, a, b, w, shift, y, dy, ds, ctx.affine, ctx.relu)
    da = db = None
    if ctx.affine:
        da, db = dab[0], dab[1]
    return dx, da, db, dw.to(w.dtype), None, None, None


class _Conv1x1(torch.autograd.Function):
    """``(y, stats)`` of the fused 1x1 conv (Kernels J and K on the card);
    the backward takes both cotangents, one the loss does not reach
    arriving as zeros."""

    @staticmethod
    def forward(ctx, x2, a, b, w, shift, affine: bool, relu: bool):
        return _fused_forward(conv1x1_fwd_plain, conv1x1_fwd_cuda, ctx, x2,
                              a, b, w, shift, affine, relu)

    @staticmethod
    def backward(ctx, dy, ds):
        return _fused_backward(conv1x1_bwd_plain, conv1x1_bwd_cuda, ctx, dy,
                               ds)


class _Conv3x3(torch.autograd.Function):
    """``(y, stats)`` of the fused 3x3 conv (Kernels L and M on the
    card)."""

    @staticmethod
    def forward(ctx, x, a, b, w, shift, affine: bool, relu: bool):
        return _fused_forward(conv3x3_fwd_plain, conv3x3_fwd_cuda, ctx, x, a,
                              b, w, shift, affine, relu)

    @staticmethod
    def backward(ctx, dy, ds):
        return _fused_backward(conv3x3_bwd_plain, conv3x3_bwd_cuda, ctx, dy,
                               ds)


def _inputs(a, b, relu: bool, stats_shift, n: int, device):
    """``(affine, a fp32, b fp32, shift)`` with the JAX argument checks;
    the shift is detached fp32 (zeros when omitted)."""
    affine = a is not None
    if not affine and (b is not None or relu):
        raise ValueError("b/relu require the input affine: pass both a and "
                         "b, or neither")
    if affine and b is None:
        raise ValueError("the input affine needs both a and b")
    if stats_shift is None:
        shift = torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        shift = stats_shift.detach().float()
    return (affine, a.float() if affine else None,
            b.float() if affine else None, shift)


def conv1x1_bn_act(x, w, a: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None, *, relu: bool = False,
                   stats_shift: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``y = relu(x * a + b) @ w`` with per-channel output
    statistics.

    ``x: [..., K]`` (flattened to [M, K]), ``w: [K, N]``; ``a``/``b`` are
    the input BN's per-channel normalize coefficients ([K], used in fp32) —
    omit both for an identity input transform. Returns ``(y [..., N],
    stats [2, N])`` with ``stats = (sum(y - c), sum((y - c)^2))`` over
    rows, ``c = stats_shift`` (fp32 [N], typically the running mean; zeros
    when omitted). The shift is saved for the backward: pass a tensor that
    is not updated in place before then.
    """
    k = x.shape[-1]
    n = w.shape[1]
    affine, af, bf, shift = _inputs(a, b, relu, stats_shift, n, x.device)
    y, s = _Conv1x1.apply(x.reshape(-1, k), af, bf, w, shift, affine,
                          bool(relu))
    return y.reshape(*x.shape[:-1], n), s


def conv3x3_bn_act(x, w, a: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None, *, relu: bool = False,
                   stats_shift: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 3x3 stride-1 SAME conv with the input BN affine/ReLU and
    output statistics — the :func:`conv1x1_bn_act` contract on ``x: [N, H,
    W, K]`` and ``w: [3, 3, K, N']``; the zero padding is applied to z,
    after the affine."""
    n = w.shape[-1]
    affine, af, bf, shift = _inputs(a, b, relu, stats_shift, n, x.device)
    return _Conv3x3.apply(x, af, bf, w, shift, affine, bool(relu))
