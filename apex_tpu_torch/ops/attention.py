"""Flash attention forward.

Counterpart of ``apex_tpu/ops/attention.py`` :func:`flash_attention`
(forward only; the backward kernels come with the training slice). A
CUDA tensor runs the hand-written kernel in ``csrc/flash_fwd.cu``, which
covers both TPU forward kernels (multi-block ``_fwd_kernel`` and
single-block ``_fwd_single_kernel``); a CPU tensor runs
:func:`mha_plain`, which mirrors the JAX package's ``_mha_reference``.

Layout ``[batch, heads, seq, head_dim]``; ``kv_heads`` may divide
``heads`` (GQA/MQA). Masks: ``causal`` with the ``seq_k - seq_q`` offset,
``kv_lengths`` per batch, ``sliding_window`` (causal only).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["flash_attention", "flash_fwd", "mha_plain", "flash_fwd_cuda"]

_NEG_INF = -1e30
#: lse of a query row that sees no key (attention.py ``_LSE_PAD``)
_LSE_PAD = 1e30


def mha_plain(q, k, v, kv_lengths, scale: float, causal: bool,
              window: Optional[int] = None):
    """Plain PyTorch attention (``_mha_reference``): fp32 scores and
    softmax, fully masked rows give zeros, output in ``q.dtype``."""
    sq, sk = q.shape[2], k.shape[2]
    if k.shape[1] != q.shape[1]:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    col = torch.arange(sk, device=q.device)[None, None, None, :]
    row = torch.arange(sq, device=q.device)[None, None, :, None]
    valid = torch.ones(s.shape, dtype=torch.bool, device=q.device)
    if kv_lengths is not None:
        valid = valid & (col < kv_lengths.to(q.device)[:, None, None, None])
    if causal:
        valid = valid & (col <= row + (sk - sq))
    if window is not None:
        valid = valid & (col > row + (sk - sq) - window)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_fwd_cuda(q, k, v, kv_lengths, scale: float, causal: bool,
                   window: Optional[int] = None):
    """Launch Kernel B; returns ``(o, lse)`` with ``lse [b, h, sq]`` fp32."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported by the kernel")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_lengths is not None:
        kv_lengths = kv_lengths.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None if kv_lengths is None else kv_lengths.data_ptr(),
        stream, b, h, kvh, sq, sk, d, float(scale), int(causal),
        int(window or 0), _support.dtype_code(q.dtype))
    _build.check("apex_flash_fwd", status)
    _support.count_launch("flash_fwd")
    return o, lse


def flash_fwd(q, k, v, kv_lengths=None, *, scale: float, causal: bool,
              window: Optional[int] = None):
    """``(o, lse)`` on the card; on the CPU ``(o, None)`` — the plain
    version has no lse, and nothing on the serving path reads it."""
    if _support.is_cpu(q, k, v):
        return mha_plain(q, k, v, kv_lengths, scale, causal, window), None
    return flash_fwd_cuda(q, k, v, kv_lengths, scale, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    kv_lengths: Optional[torch.Tensor] = None,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention ``softmax(scale * q @ k^T + mask) @ v``.

    Args:
      q: ``[batch, heads, seq_q, head_dim]``.
      k, v: ``[batch, kv_heads, seq_k, head_dim]``; ``kv_heads`` divides
        ``heads`` (grouped heads read the same K/V, no broadcast copy on
        the card).
      causal: mask with the ``seq_k - seq_q`` offset.
      softmax_scale: defaults to ``1/sqrt(head_dim)``.
      kv_lengths: optional int ``[batch]`` valid key lengths.
      sliding_window: keep only the last ``sliding_window`` keys per query
        (incl. self; requires ``causal``).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects [batch, heads, seq, dim]")
    if k.shape[1] != v.shape[1] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"kv_heads ({k.shape[1]}) must divide query heads "
            f"({q.shape[1]}) for GQA/MQA")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal attention")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got "
                             f"{sliding_window}")
    _support.forward_only("flash_attention", q, k, v)
    scale = float(softmax_scale if softmax_scale is not None
                  else 1.0 / math.sqrt(q.shape[-1]))
    return flash_fwd(q, k, v, kv_lengths, scale=scale, causal=causal,
                     window=sliding_window)[0]
