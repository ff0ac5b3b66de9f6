"""Fused LayerNorm / RMSNorm, forward and backward.

Counterpart of ``apex_tpu/ops/layer_norm.py``. Every public function is a
:class:`torch.autograd.Function` mirroring the JAX package's ``_norm``
custom VJP: the forward saves the fp32 row statistics, the backward turns
them into ``dx`` (in x's dtype) and fp32 ``dw``/``db`` cast to the
parameters' dtypes. A CUDA tensor runs the hand-written kernels,
``csrc/layer_norm_fwd.cu`` (Kernel A) and ``csrc/layer_norm_bwd.cu``
(Kernel D); a CPU tensor runs :func:`layer_norm_fwd_plain` and
:func:`layer_norm_bwd_plain`, which mirror ``_fwd_jnp`` and ``_bwd_jnp``.
``memory_efficient=True`` saves the output instead of the input and
rebuilds x from it in plain PyTorch before the backward kernel, as
``_norm_vjp_bwd`` does outside its Pallas kernel.

:func:`layer_norm_fwd_plan` and :func:`layer_norm_bwd_plan` pick each
kernel's path on the host: bf16 or fp16 rows (dy and x of that one type
for the backward) of ``h % 8 == 0`` up to 1024 at 16-byte aligned
addresses take the 16-byte kernels, whose rows live in registers and
whose grid is the card's resident blocks; every other call takes the
element kernels.

Both kernels take x in f32, bf16 or fp16, and w, b, y (and dy) each in
f32 or the 16-bit type that x pairs with: bf16 beside f32 or bf16 x,
fp16 beside fp16 x (:func:`_kernel_dtypes`). A mix of bf16 and fp16
raises TypeError before any launch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["fused_layer_norm", "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "layer_norm_fwd", "layer_norm_fwd_plain",
           "layer_norm_fwd_cuda", "layer_norm_bwd_plain", "layer_norm_bwd_cuda",
           "LayerNormPlan", "layer_norm_fwd_plan", "layer_norm_bwd_plan",
           "layer_norm_fwd_cuda_plan", "layer_norm_bwd_cuda_plan"]

Shape = Union[int, Sequence[int]]
#: the 16-byte kernels hold at most four 16-byte pieces a lane of a warp
_VEC_MAX_H = 4 * 8 * 32
#: rows a block of the element kernels: Kernel A's one warp a row in blocks
#: of four warps, Kernel D's pass-1 blocks of 32 rows
_FWD_ELEMENT_ROWS = 4
_BWD_ELEMENT_ROWS = 32
#: the row dtypes of the 16-byte kernels
_VEC_DTYPES = (torch.bfloat16, torch.float16)


class LayerNormPlan(NamedTuple):
    """How one call of Kernel A or D runs (csrc/layer_norm_vec.cuh)."""
    #: 16-byte pieces a lane holds; 0 is the element path
    pieces: int
    #: lanes a row: ``32 // lanes`` rows share a warp (0 on the element path)
    lanes: int
    #: the grid; Kernel D writes one fp32 partial row of dw/db per block
    blocks: int
    #: consecutive rows a block takes
    block_rows: int

    @property
    def path(self) -> str:
        return "vector" if self.pieces else "element"

    @property
    def rows_a_warp(self) -> int:
        return 32 // self.lanes if self.lanes else 1


def _vector_rows(h: int, ptrs: Sequence[Optional[int]]) -> bool:
    """Rows of h 16-bit elements that the 16-byte kernels take: ``h % 8 ==
    0``, at most ``_VEC_MAX_H``, every given address 16-byte aligned."""
    return (0 < h <= _VEC_MAX_H and h % 8 == 0
            and all(p % 16 == 0 for p in ptrs if p is not None))


def _vector_plan(m: int, h: int, blocks_per_sm: Callable[[int], int],
                 n_sms: int) -> LayerNormPlan:
    """A lane holds one piece where the row has at most 32 (h <= 256),
    the row's lanes the power of two that covers its pieces; longer rows
    take a whole warp, ``ceil(pieces / 32)`` a lane (3 at h = 768). The
    grid is at most the card's resident blocks, the rows split statically
    into runs of ``block_rows`` (at least a warp's worth): a few rows, as
    in a decode step, spread over as many SMs."""
    n = h // 8
    pieces, lanes = ((1, 1 << (n - 1).bit_length()) if n <= 32
                     else (_support.cdiv(n, 32), 32))
    block_rows = max(32 // lanes,
                     _support.cdiv(m, n_sms * blocks_per_sm(pieces)))
    return LayerNormPlan(pieces, lanes, _support.cdiv(m, block_rows),
                         block_rows)


def layer_norm_fwd_plan(m: int, h: int, x_dtype: torch.dtype,
                        ptrs: Sequence[Optional[int]],
                        blocks_per_sm: Callable[[int], int],
                        n_sms: int) -> LayerNormPlan:
    """Kernel A's path and grid for ``x [m, h]``: the 16-byte kernel for
    bf16 or fp16 x whose rows :func:`_vector_rows` takes (``ptrs``: the
    addresses of x, y, w and b, None where absent), else the element
    kernel. ``blocks_per_sm(pieces)`` is the 16-byte kernel's resident
    blocks an SM at that many pieces a lane, ``n_sms`` the card's SMs."""
    if x_dtype not in _VEC_DTYPES or not _vector_rows(h, ptrs):
        return LayerNormPlan(0, 0, _support.cdiv(m, _FWD_ELEMENT_ROWS),
                             _FWD_ELEMENT_ROWS)
    return _vector_plan(m, h, blocks_per_sm, n_sms)


def layer_norm_bwd_plan(m: int, h: int, dy_dtype: torch.dtype,
                        x_dtype: torch.dtype, ptrs: Sequence[Optional[int]],
                        blocks_per_sm: Callable[[int], int],
                        n_sms: int) -> LayerNormPlan:
    """Kernel D's path and grid, as :func:`layer_norm_fwd_plan`: the
    16-byte kernel needs dy and x of one 16-bit type (``ptrs``: dy, x, dx
    and w); its ``blocks`` are also the partial rows pass 2 sums."""
    if x_dtype not in _VEC_DTYPES or dy_dtype != x_dtype or \
            not _vector_rows(h, ptrs):
        return LayerNormPlan(0, 0, _support.cdiv(m, _BWD_ELEMENT_ROWS),
                             _BWD_ELEMENT_ROWS)
    return _vector_plan(m, h, blocks_per_sm, n_sms)


def _blocks_per_sm(device: int, kernel: str, *args: int) -> int:
    """The card's occupancy of a 16-byte kernel (its C query's ``args``
    before the out pointer), asked once per configuration."""
    return _support.blocks_per_sm(
        device, f"apex_layer_norm_{kernel}_blocks_per_sm", *args)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _kernel_dtypes(kernel: str, x_dtype: torch.dtype,
                   **others: Optional[torch.dtype]) -> Tuple[int, ...]:
    """The C dtype codes of x and then of ``others`` (w, y or dy; 0, fp32,
    where one is absent) for the LayerNorm kernels: x f32, bf16 or fp16,
    each of the others f32 or the 16-bit type x pairs with (fp16 beside
    fp16 x, bf16 beside f32 or bf16 x), the combinations the C entry
    points instantiate. Raises TypeError on any other."""
    x_code = _support.dtype_code(x_dtype, _support.F32_BF16_F16, kernel)
    half = torch.float16 if x_dtype == torch.float16 else torch.bfloat16
    codes = [x_code]
    for name, dt in others.items():
        if dt is None:
            codes.append(0)
        elif dt in (torch.float32, half):
            codes.append(_support.dtype_code(dt, _support.F32_BF16_F16,
                                             kernel))
        else:
            raise TypeError(f"{kernel}: {name} in {dt} beside x in "
                            f"{x_dtype}; it takes float32 or {half}")
    return tuple(codes)


def _dt(t: Optional[torch.Tensor]) -> Optional[torch.dtype]:
    return None if t is None else t.dtype


def layer_norm_fwd_cuda_plan(x2, y, w, b) -> LayerNormPlan:
    """The plan :func:`layer_norm_fwd_cuda` takes for ``x2 [m, h]`` into
    ``y`` on their card (its occupancy and SM count)."""
    m, h = x2.shape
    dev = x2.device.index
    codes = _kernel_dtypes("Kernel A (layer_norm_fwd_cuda)", x2.dtype,
                           w=_dt(w), y=y.dtype)
    return layer_norm_fwd_plan(
        m, h, x2.dtype, (x2.data_ptr(), y.data_ptr(), _ptr(w), _ptr(b)),
        lambda pieces: _blocks_per_sm(dev, "fwd", pieces, *codes),
        _support.sm_count(dev))


def layer_norm_bwd_cuda_plan(dy2, x2, dx, w, has_bias: bool
                             ) -> LayerNormPlan:
    """The plan :func:`layer_norm_bwd_cuda` takes for these rows on their
    card: its ``blocks`` are the partial rows it allocates."""
    m, h = x2.shape
    dev = x2.device.index
    affine = 0 if w is None else (2 if has_bias else 1)
    x_code, _, w_code = _kernel_dtypes("Kernel D (layer_norm_bwd_cuda)",
                                       x2.dtype, dy=dy2.dtype, w=_dt(w))
    return layer_norm_bwd_plan(
        m, h, dy2.dtype, x2.dtype,
        (dy2.data_ptr(), x2.data_ptr(), dx.data_ptr(), _ptr(w)),
        lambda pieces: _blocks_per_sm(dev, "bwd", h, pieces, x_code, w_code,
                                      affine),
        _support.sm_count(dev))


def _as_shape(s: Shape) -> Tuple[int, ...]:
    return (s,) if isinstance(s, int) else tuple(s)


def layer_norm_fwd_plain(x2, w, b, eps: float, is_rms: bool,
                         out_dtype: torch.dtype):
    """Plain PyTorch version over ``x2 [m, h]``: ``(y, mean, invvar)``,
    statistics in fp32 (the JAX package's ``_fwd_jnp``)."""
    xf = x2.float()
    if is_rms:
        mean = torch.zeros(x2.shape[0], dtype=torch.float32, device=x2.device)
        var = (xf * xf).mean(dim=1)
    else:
        mean = xf.mean(dim=1)
        var = (xf - mean[:, None]).square().mean(dim=1)
    invvar = torch.rsqrt(var + eps)
    y = (xf - mean[:, None]) * invvar[:, None]
    if w is not None:
        y = y * w.reshape(1, -1).float()
    if b is not None:
        y = y + b.reshape(1, -1).float()
    return y.to(out_dtype), mean, invvar


def layer_norm_fwd_cuda(x2, w, b, eps: float, is_rms: bool,
                        out_dtype: torch.dtype):
    """Launch Kernel A on ``x2 [m, h]`` (contiguous, on one CUDA device)."""
    m, h = x2.shape
    if w is not None and b is not None and w.dtype != b.dtype:
        raise TypeError(f"weight ({w.dtype}) and bias ({b.dtype}) dtypes "
                        f"must match")
    codes = _kernel_dtypes("Kernel A (layer_norm_fwd_cuda)", x2.dtype,
                           w=_dt(w), y=out_dtype)
    if h > 14336:
        raise ValueError(f"hidden size {h} exceeds the kernel's "
                         f"shared-memory row stage (14336)")
    x2 = x2.contiguous()
    w = None if w is None else w.reshape(-1).contiguous()
    b = None if b is None else b.reshape(-1).contiguous()
    for name, t in (("weight", w), ("bias", b)):
        if t is not None and t.numel() != h:
            raise ValueError(f"{name} has {t.numel()} elements, expected {h}")
    y = torch.empty((m, h), dtype=out_dtype, device=x2.device)
    mean = torch.empty(m, dtype=torch.float32, device=x2.device)
    invvar = torch.empty(m, dtype=torch.float32, device=x2.device)
    if m == 0:
        return y, mean, invvar
    lib = _build.library()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    plan = layer_norm_fwd_cuda_plan(x2, y, w, b)
    status = lib.apex_layer_norm_fwd(
        x2.data_ptr(), _ptr(w), _ptr(b), y.data_ptr(), mean.data_ptr(),
        invvar.data_ptr(), stream, m, h, float(eps), int(is_rms), *codes,
        *plan)
    _build.check("apex_layer_norm_fwd", status)
    _support.count_launch("layer_norm_fwd")
    return y, mean, invvar


def layer_norm_bwd_plain(dy2, x2, mean, invvar, w, is_rms: bool,
                         has_bias: bool):
    """Plain PyTorch backward over ``[m, h]`` rows: ``(dx, dw, db)`` with
    dx in x's dtype and dw/db fp32 (None where absent) — the JAX
    package's ``_bwd_jnp``."""
    dy = dy2.float()
    xhat = (x2.float() - mean[:, None]) * invvar[:, None]
    dyw = dy * w.reshape(1, -1).float() if w is not None else dy
    c2 = (dyw * xhat).mean(dim=1, keepdim=True)
    if is_rms:
        dx = invvar[:, None] * (dyw - xhat * c2)
    else:
        c1 = dyw.mean(dim=1, keepdim=True)
        dx = invvar[:, None] * (dyw - c1 - xhat * c2)
    dw = (dy * xhat).sum(dim=0) if w is not None else None
    db = dy.sum(dim=0) if (w is not None and has_bias) else None
    return dx.to(x2.dtype), dw, db


def layer_norm_bwd_cuda(dy2, x2, mean, invvar, w, is_rms: bool,
                        has_bias: bool):
    """Launch Kernel D on ``[m, h]`` rows (one CUDA device): dx and the
    fp32 per-block dw/db partials, then their column sums."""
    m, h = x2.shape
    codes = _kernel_dtypes("Kernel D (layer_norm_bwd_cuda)", x2.dtype,
                           dy=dy2.dtype, w=_dt(w))
    dy2, x2 = dy2.contiguous(), x2.contiguous()
    mean, invvar = mean.contiguous(), invvar.contiguous()
    dev = x2.device
    dx = torch.empty((m, h), dtype=x2.dtype, device=dev)
    dw = db = None
    if w is not None:
        w = w.reshape(-1).contiguous()
        if w.numel() != h:
            raise ValueError(f"weight has {w.numel()} elements, expected {h}")
        dw = torch.empty(h, dtype=torch.float32, device=dev)
        db = (torch.empty(h, dtype=torch.float32, device=dev) if has_bias
              else None)
    if m == 0:
        return dx, None if dw is None else dw.zero_(), \
            None if db is None else db.zero_()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = layer_norm_bwd_cuda_plan(dy2, x2, dx, w, has_bias)
    partial = None if w is None else torch.empty(
        (plan.blocks, 2, h), dtype=torch.float32, device=dev)
    status = lib.apex_layer_norm_bwd(
        dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
        _ptr(w), dx.data_ptr(), _ptr(partial), _ptr(dw), _ptr(db), stream, m,
        h, int(is_rms), codes[1], codes[0], codes[2], *plan)
    _build.check("apex_layer_norm_bwd", status)
    _support.count_launch("layer_norm_bwd")
    return dx, dw, db


def _out_dtype(x, weight, out_dtype):
    if out_dtype is not None:
        return out_dtype
    # promote semantics: bf16 x with fp32 weight gives fp32 y
    out = x.dtype if weight is None else torch.promote_types(x.dtype,
                                                             weight.dtype)
    return torch.float32 if out == torch.float64 else out


class _Norm(torch.autograd.Function):
    """``(y, mean, invvar)``; mean and invvar carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, h: int, eps: float, is_rms: bool,
                memory_efficient: bool, out_dtype: torch.dtype):
        x2 = x.reshape(-1, h)
        fwd = (layer_norm_fwd_plain if _support.is_cpu(x, weight, bias)
               else layer_norm_fwd_cuda)
        y, mean, invvar = fwd(x2, weight, bias, eps, is_rms, out_dtype)
        y = y.reshape(x.shape)
        ctx.mark_non_differentiable(mean, invvar)
        ctx.h, ctx.is_rms, ctx.x_dtype = h, is_rms, x.dtype
        ctx.memory_efficient = memory_efficient
        ctx.has_bias = bias is not None
        # y saved instead of x: x is rebuilt from it in the backward
        ctx.save_for_backward(y if memory_efficient else x, mean, invvar,
                              weight, bias)
        return y, mean, invvar

    @staticmethod
    def backward(ctx, dy, _dmean, _dinvvar):
        saved, mean, invvar, weight, bias = ctx.saved_tensors
        h = ctx.h
        if ctx.memory_efficient:
            # _norm_vjp_bwd: xhat = (y - b) / w (w guarded near 0), then
            # x = xhat / invvar + mean, in y's dtype
            y2 = saved.reshape(-1, h).float()
            if weight is not None:
                wf = weight.reshape(1, -1).float()
                safe_w = torch.where(wf.abs() < 1e-12,
                                     torch.ones_like(wf), wf)
                if bias is not None:
                    y2 = y2 - bias.reshape(1, -1).float()
                y2 = y2 / safe_w
            x2 = (y2 / invvar[:, None] + mean[:, None]).to(saved.dtype)
        else:
            x2 = saved.reshape(-1, h)
        dy2 = dy.reshape(-1, h)
        bwd = (layer_norm_bwd_plain if _support.is_cpu(dy2, x2, weight)
               else layer_norm_bwd_cuda)
        dx, dw, db = bwd(dy2, x2, mean, invvar, weight, ctx.is_rms,
                         ctx.has_bias)
        dx = dx.reshape(dy.shape).to(ctx.x_dtype)
        dw = None if weight is None else dw.reshape(weight.shape).to(
            weight.dtype)
        db = None if bias is None else db.reshape(bias.shape).to(bias.dtype)
        return dx, dw, db, None, None, None, None, None


def layer_norm_fwd(x, weight, bias, normalized_shape: Shape, eps: float,
                   is_rms: bool, out_dtype: Optional[torch.dtype] = None,
                   memory_efficient: bool = False):
    """``(y, mean, invvar)`` over the trailing ``normalized_shape`` dims —
    the counterpart of ``_norm_fwd_impl``, differentiable in ``y`` (the
    JAX ``_norm`` custom VJP). ``out_dtype=None`` keeps the promote
    semantics (bf16 x with fp32 weight gives fp32 y)."""
    shape = _as_shape(normalized_shape)
    h = 1
    for n in shape:
        h *= n
    if tuple(x.shape[x.dim() - len(shape):]) != shape:
        raise ValueError(f"input {tuple(x.shape)} does not end in "
                         f"normalized_shape {shape}")
    if weight is not None and weight.numel() != h:
        raise ValueError(f"weight has {weight.numel()} elements, expected "
                         f"{h}")
    return _Norm.apply(x, weight, bias, h, float(eps), bool(is_rms),
                       bool(memory_efficient),
                       _out_dtype(x, weight, out_dtype))


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-5, memory_efficient: bool = False,
                            out_dtype=None):
    """Reference: ``fused_layer_norm_affine``. ``out_dtype=None`` keeps
    promote semantics; pass ``x.dtype`` when the consumer runs in the
    compute dtype anyway."""
    return layer_norm_fwd(x, weight, bias, normalized_shape, eps, False,
                          out_dtype, memory_efficient)[0]


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                     memory_efficient: bool = False, out_dtype=None):
    """Non-affine LayerNorm."""
    return layer_norm_fwd(x, None, None, normalized_shape, eps, False,
                          out_dtype, memory_efficient)[0]


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-5, memory_efficient: bool = False,
                          out_dtype=None):
    """Reference: ``fused_rms_norm_affine``."""
    return layer_norm_fwd(x, weight, None, normalized_shape, eps, True,
                          out_dtype, memory_efficient)[0]


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                   memory_efficient: bool = False, out_dtype=None):
    """Non-affine RMSNorm."""
    return layer_norm_fwd(x, None, None, normalized_shape, eps, True,
                          out_dtype, memory_efficient)[0]
