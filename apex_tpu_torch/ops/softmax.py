"""Fused scale + mask + softmax, forward and backward.

Counterpart of ``apex_tpu/ops/softmax.py`` (the four Megatron softmax
extensions): ``softmax(scale * x)`` with masked logits filled with
``-10000.0`` after the scale, and the backward
``dx = scale * y * (dy - rowsum(dy * y))``. The custom VJP ``_softmax_core``
is :class:`_SoftmaxCore` here: the forward saves y, the backward reads only
y and dy, so the mask is not applied again (a fully masked row, uniform at
``1/k`` in the forward, gets the non-zero ``y * (dy - s)`` gradient, as in
the JAX package).

A CUDA tensor runs ``csrc/softmax_fwd.cu`` (Kernel G) and
``csrc/softmax_bwd.cu`` (Kernel H); a CPU tensor runs
:func:`softmax_fwd_plain` (``_fwd_jnp``) and :func:`softmax_bwd_plain`
(``_bwd_jnp``). Rows are the last axis of ``x`` at any length. The boolean
mask (True = masked out) broadcasts against ``x``: Kernel G reads it through
its broadcast strides, so a ``[b, 1, s, s]`` or ``[b, 1, 1, s]`` mask is
never expanded in memory. :func:`softmax_fwd_plan` picks Kernel G's path:
16-byte loads for bf16 and fp16 rows whose length is a multiple of 8 up
to 1024, else element by element. Both kernels take f32, bf16 and fp16;
each computes in fp32 and rounds its output once to the input's dtype
(an fp16 dx past 65504 is inf, as the plain version's cast gives it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["scaled_softmax", "scaled_masked_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "softmax_fwd_plain",
           "softmax_bwd_plain", "softmax_fwd_cuda", "softmax_bwd_cuda",
           "softmax_fwd_plan"]

#: the fill value of a masked logit (softmax.py ``_MASK_FILL``)
_MASK_FILL = -10000.0
#: Kernel G's 16-byte path: rows of at most four 16-byte pieces a lane of a
#: warp
_VEC_MAX_K = 4 * 8 * 32
#: the dtypes of Kernel G's 16-byte path: 8 elements a piece
_VEC_DTYPES = (torch.bfloat16, torch.float16)


def softmax_fwd_plan(k: int, dtype: torch.dtype, x_ptr: int, y_ptr: int,
                     mask_ptr: Optional[int] = None,
                     mask_strides: Tuple[int, ...] = (0, 0, 0, 1)
                     ) -> Tuple[int, int]:
    """``(pieces a lane, lanes a row)`` of Kernel G's 16-byte path
    (csrc/softmax_fwd.cu), or ``(0, 0)`` for its element path.

    The 16-byte path takes bf16 or fp16 rows of ``k % 8 == 0``, ``k <=
    1024``, x and y at 16-byte aligned addresses and, with a mask, one
    whose last stride is 1 and whose other strides and base are multiples
    of 8 bytes (its 8 bytes beside a lane's 8 elements are one load). A
    lane holds one 16-byte piece where the row has at most 32 (k <= 256),
    else two or four; a row takes the power of two of lanes that covers its
    pieces, so ``32 // lanes`` rows share a warp (four at k = 64)."""
    if dtype not in _VEC_DTYPES or k % 8 or k > _VEC_MAX_K or \
            (x_ptr | y_ptr) % 16:
        return 0, 0
    if mask_ptr is not None and (mask_strides[-1] != 1 or mask_ptr % 8 or
                                 any(st % 8 for st in mask_strides[:-1])):
        return 0, 0
    pieces = k // 8
    cpl = next(c for c in (1, 2, 4) if pieces <= 32 * c)
    return cpl, 1 << (_support.cdiv(pieces, cpl) - 1).bit_length()


def softmax_fwd_plain(x4: torch.Tensor, mask4: Optional[torch.Tensor],
                      scale: float, sq: int, causal: bool) -> torch.Tensor:
    """Plain PyTorch forward (``_fwd_jnp``) over ``x4 [d0, d1, d2, k]``:
    fp32 logits ``x * scale``, masked positions set to -10000 (``mask4``
    broadcastable to ``x4``; with ``causal``, column ``c > row % sq`` of the
    flattened rows), softmax in fp32, result in x's dtype."""
    k = x4.shape[-1]
    logits = x4.float() * scale
    if mask4 is not None:
        logits = torch.where(mask4, _MASK_FILL, logits)
    if causal:
        rows = logits.reshape(-1, k)
        q_pos = (torch.arange(rows.shape[0], device=x4.device) % sq)[:, None]
        col = torch.arange(k, device=x4.device)[None, :]
        logits = torch.where(col > q_pos, _MASK_FILL, rows).reshape(x4.shape)
    return torch.softmax(logits, dim=-1).to(x4.dtype)


def softmax_bwd_plain(dy: torch.Tensor, y: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Plain PyTorch backward (``_bwd_jnp``): ``scale * y * (dy - s)`` with
    ``s = rowsum(dy * y)``, in fp32, cast to dy's dtype."""
    dyf, yf = dy.float(), y.float()
    s = (dyf * yf).sum(dim=-1, keepdim=True)
    return (scale * yf * (dyf - s)).to(dy.dtype)


def softmax_fwd_cuda(x4: torch.Tensor, mask4: Optional[torch.Tensor],
                     scale: float, sq: int, causal: bool) -> torch.Tensor:
    """Launch Kernel G on ``x4 [d0, d1, d2, k]``; ``mask4`` (bool,
    broadcastable to x4) is read through its broadcast strides."""
    code = _support.dtype_code(x4.dtype, "Kernel G (softmax_fwd_cuda)")
    x4 = x4.contiguous()
    k = x4.shape[-1]
    y = torch.empty_like(x4)
    if y.numel() == 0:
        return y
    strides = (0, 0, 0, 0)
    if mask4 is not None:
        if mask4.dtype != torch.bool:
            raise TypeError(f"the mask must be bool, got {mask4.dtype}")
        mask4 = mask4.expand(x4.shape)       # a view: zero strides
        strides = mask4.stride()
    mask_ptr = None if mask4 is None else mask4.data_ptr()
    cpl, lpr = softmax_fwd_plan(k, x4.dtype, x4.data_ptr(), y.data_ptr(),
                                mask_ptr, strides)
    lib = _build.library()
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    status = lib.apex_softmax_fwd(
        x4.data_ptr(), mask_ptr, y.data_ptr(), stream, x4.numel() // k, k,
        x4.shape[1], x4.shape[2], *strides, float(scale), max(sq, 1),
        int(causal), code, cpl, lpr)
    _build.check("apex_softmax_fwd", status)
    _support.count_launch("softmax_fwd")
    return y


def softmax_bwd_cuda(dy: torch.Tensor, y: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Launch Kernel H: dx in dy's dtype (dy and y share it)."""
    if dy.dtype != y.dtype:
        raise TypeError(f"dy ({dy.dtype}) and y ({y.dtype}) dtypes differ")
    code = _support.dtype_code(y.dtype, "Kernel H (softmax_bwd_cuda)")
    dy, y = dy.contiguous(), y.contiguous()
    k = y.shape[-1]
    dx = torch.empty_like(dy)
    if dx.numel() == 0:
        return dx
    lib = _build.library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    status = lib.apex_softmax_bwd(
        dy.data_ptr(), y.data_ptr(), dx.data_ptr(), stream, y.numel() // k,
        k, float(scale), code)
    _build.check("apex_softmax_bwd", status)
    _support.count_launch("softmax_bwd")
    return dx


class _SoftmaxCore(torch.autograd.Function):
    """The JAX package's ``_softmax_core`` custom VJP over ``[d0, d1, d2,
    k]``: y from Kernel G (or its plain version), dx from Kernel H (or its
    plain version) with no mask."""

    @staticmethod
    def forward(ctx, x4, mask4, scale, sq, causal):
        cpu = _support.is_cpu(x4, mask4)
        y = (softmax_fwd_plain if cpu else softmax_fwd_cuda)(
            x4, mask4, scale, sq, causal)
        ctx.save_for_backward(y)
        ctx.scale, ctx.cpu = scale, cpu
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        bwd = softmax_bwd_plain if ctx.cpu else softmax_bwd_cuda
        return bwd(dy.to(y.dtype), y, ctx.scale), None, None, None, None


def _as4d(x: torch.Tensor, mask: torch.Tensor):
    """``x`` as a ``[d0, d1, d2, k]`` view and ``mask`` broadcast to it (a
    zero-stride view where x has at most 4 dims)."""
    try:
        fits = torch.broadcast_shapes(x.shape, mask.shape) == x.shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"mask {tuple(mask.shape)} does not broadcast to "
                         f"x {tuple(x.shape)}")
    m = mask.to(torch.bool).expand(x.shape)
    if x.dim() > 4:
        x4 = x.reshape(-1, *x.shape[-3:])
        return x4, m.reshape(x4.shape)
    for _ in range(4 - x.dim()):
        x, m = x.unsqueeze(0), m.unsqueeze(0)
    return x, m


def scaled_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``softmax(scale * x)`` over the last axis."""
    k = x.shape[-1]
    y = _SoftmaxCore.apply(x.reshape(1, 1, -1, k), None, float(scale), 0,
                           False)
    return y.reshape(x.shape)


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0) -> torch.Tensor:
    """``softmax(scale * x.masked_fill(mask, -10000))``; ``x`` is ``(b, np,
    sq, sk)`` and ``mask`` a bool broadcastable to it, True = masked out."""
    if mask is None:
        return scaled_softmax(x, scale)
    x4, m4 = _as4d(x, mask)
    return _SoftmaxCore.apply(x4, m4, float(scale), 0, False).reshape(x.shape)


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """Causal softmax over ``(attn_batches, sq, sk)`` with ``sq == sk``."""
    sq, sk = x.shape[-2], x.shape[-1]
    if sq != sk:
        raise ValueError(
            f"scaled_upper_triang_masked_softmax requires sq == sk, got "
            f"{sq} != {sk}; use scaled_masked_softmax with an explicit "
            f"causal mask instead")
    y = _SoftmaxCore.apply(x.reshape(1, 1, -1, sk), None, float(scale), sq,
                           True)
    return y.reshape(x.shape)


def generic_scaled_masked_softmax(x: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  scale: float = 1.0) -> torch.Tensor:
    """No shape constraints: the same kernels take any row length."""
    return scaled_masked_softmax(x, mask, scale)
