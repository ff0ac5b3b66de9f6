"""Fused LayerNorm / RMSNorm forward.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (forward only; the backward
comes with the training slice, so these functions raise if autograd would
need it). A CUDA tensor runs the hand-written kernel in
``csrc/layer_norm_fwd.cu``; a CPU tensor runs :func:`layer_norm_fwd_plain`,
which mirrors the JAX package's ``_fwd_jnp``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["fused_layer_norm", "fused_layer_norm_affine", "fused_rms_norm",
           "fused_rms_norm_affine", "layer_norm_fwd", "layer_norm_fwd_plain",
           "layer_norm_fwd_cuda"]

Shape = Union[int, Sequence[int]]


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
    w_dtype = _support.dtype_code(w.dtype) if w is not None else 0
    status = lib.apex_layer_norm_fwd(
        x2.data_ptr(), None if w is None else w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), mean.data_ptr(),
        invvar.data_ptr(), stream, m, h, float(eps), int(is_rms),
        _support.dtype_code(x2.dtype), w_dtype, _support.dtype_code(out_dtype))
    _build.check("apex_layer_norm_fwd", status)
    _support.count_launch("layer_norm_fwd")
    return y, mean, invvar


def layer_norm_fwd(x, weight, bias, normalized_shape: Shape, eps: float,
                   is_rms: bool, out_dtype: Optional[torch.dtype] = None):
    """``(y, mean, invvar)`` over the trailing ``normalized_shape`` dims —
    the counterpart of ``_norm_fwd_impl``. ``out_dtype=None`` keeps the
    promote semantics (bf16 x with fp32 weight gives fp32 y)."""
    _support.forward_only("layer_norm_fwd", x, weight, bias)
    shape = _as_shape(normalized_shape)
    h = 1
    for n in shape:
        h *= n
    if tuple(x.shape[x.dim() - len(shape):]) != shape:
        raise ValueError(f"input {tuple(x.shape)} does not end in "
                         f"normalized_shape {shape}")
    if out_dtype is None:
        out_dtype = (x.dtype if weight is None
                     else torch.promote_types(x.dtype, weight.dtype))
        if out_dtype == torch.float64:
            out_dtype = torch.float32
    x2 = x.reshape(-1, h)
    fwd = (layer_norm_fwd_plain if _support.is_cpu(x, weight, bias)
           else layer_norm_fwd_cuda)
    y, mean, invvar = fwd(x2, weight, bias, eps, is_rms, out_dtype)
    return y.reshape(x.shape), mean, invvar


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-5, out_dtype=None):
    """Reference: ``fused_layer_norm_affine``. ``out_dtype=None`` keeps
    promote semantics; pass ``x.dtype`` when the consumer runs in the
    compute dtype anyway."""
    return layer_norm_fwd(x, weight, bias, normalized_shape, eps, False,
                          out_dtype)[0]


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                     out_dtype=None):
    """Non-affine LayerNorm."""
    return layer_norm_fwd(x, None, None, normalized_shape, eps, False,
                          out_dtype)[0]


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-5, out_dtype=None):
    """Reference: ``fused_rms_norm_affine``."""
    return layer_norm_fwd(x, weight, None, normalized_shape, eps, True,
                          out_dtype)[0]


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-5,
                   out_dtype=None):
    """Non-affine RMSNorm."""
    return layer_norm_fwd(x, None, None, normalized_shape, eps, True,
                          out_dtype)[0]
