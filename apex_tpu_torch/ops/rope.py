"""Rotary positional embedding (counterpart of ``apex_tpu/ops/rope.py``).

RoPE has no Pallas kernel in the JAX package (XLA fuses it), so this is
plain PyTorch: :func:`rope_freqs` builds the angles in the Megatron
``concat(f, f)`` layout and :func:`fused_rope` applies them;
:func:`fused_rope_cached` takes precomputed cos/sin tables,
:func:`fused_rope_thd` packed variable-length sequences and
:func:`fused_rope_2d` image rows and columns. Each has the JAX package's
custom backward: the incoming gradient rotated by the negated angle
(``cos``, ``-sin``), rounded to its dtype. :func:`rope_tables` builds the
fp32 ``(cos, sin)`` tables that the packed attention kernels rotate q and
k with in-kernel.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["rope_freqs", "fused_rope", "fused_rope_cached", "fused_rope_thd",
           "fused_rope_2d", "rope_tables"]


def rope_freqs(start: Union[int, torch.Tensor], length: int, rot_dim: int,
               theta: float, device=None) -> torch.Tensor:
    """Angles for positions ``[start, start + length)``: ``[s, 1, 1,
    rot_dim]``, or ``[s, b, 1, rot_dim]`` when ``start`` is a ``[b]``
    tensor of per-row offsets (continuous-batching decode); a 0-dim
    ``start`` reads as an int."""
    if isinstance(start, torch.Tensor) and start.dim() == 0:
        start = int(start)
    if isinstance(start, torch.Tensor):
        device = start.device
    inv = 1.0 / theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                       device=device) / rot_dim)
    steps = torch.arange(length, dtype=torch.float32, device=device)
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        pos = start.float()[None, :] + steps[:, None]          # [s, b]
        f = pos[:, :, None] * inv[None, None, :]
        return torch.cat([f, f], dim=-1)[:, :, None, :]
    pos = start + steps
    f = pos[:, None] * inv[None, :]
    return torch.cat([f, f], dim=-1)[:, None, None, :]


def _rotate_half(t: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def _apply(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """``t`` rotated over its first ``cos.shape[-1]`` channels in fp32,
    the rest passed through, rounded once to ``t``'s dtype."""
    rot_dim = cos.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    out = t_rot * cos + _rotate_half(t_rot) * sin
    if t_pass.shape[-1]:
        out = torch.cat([out, t_pass], dim=-1)
    return out.to(t.dtype)


class _RopeCached(torch.autograd.Function):
    """``_apply(t, cos, sin)`` with the JAX package's VJP: the gradient is
    ``_apply(g, cos, -sin)`` (no gradient for the tables)."""

    @staticmethod
    def forward(ctx, t, cos, sin):
        cos, sin = cos.float(), sin.float()
        ctx.save_for_backward(cos, sin)
        return _apply(t, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _apply(g, cos, -sin), None, None


def fused_rope(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to ``t [s, b, h, d]`` with ``freqs`` from
    :func:`rope_freqs`; channels past ``rot_dim`` pass through."""
    f = freqs.float()
    return _RopeCached.apply(t, torch.cos(f), torch.sin(f))


def fused_rope_cached(t: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """RoPE from precomputed ``cos``/``sin`` tables that broadcast against
    ``t``'s rotated channels (taken in fp32)."""
    return _RopeCached.apply(t, cos, sin)


def fused_rope_thd(t: torch.Tensor, cu_seqlens: torch.Tensor,
                   freqs: torch.Tensor) -> torch.Tensor:
    """Packed variable-length RoPE: ``t [total, h, d]``, ``cu_seqlens
    [batch + 1]`` the cumulative lengths, ``freqs [max_seq, 1, 1, rot]``;
    each token rotates by its position within its own sequence."""
    total = t.shape[0]
    idx = torch.arange(total, device=t.device)
    cu = cu_seqlens.to(device=t.device, dtype=torch.int64)
    seq = torch.searchsorted(cu, idx, right=True) - 1
    f = freqs[idx - cu[seq], 0, 0, :].float()
    return _RopeCached.apply(t, torch.cos(f)[:, None, :],
                             torch.sin(f)[:, None, :])


def fused_rope_2d(t: torch.Tensor, img_h: int, img_w: int,
                  freqs_h: torch.Tensor, freqs_w: torch.Tensor
                  ) -> torch.Tensor:
    """RoPE over an image's pixels: ``t [b, img_h * img_w, h, d]``, the
    first half of d rotated by the row's angles (``freqs_h [>= img_h, 1,
    1, d / 2]``), the second half by the column's."""
    half = t.shape[-1] // 2
    fh = freqs_h[:img_h, 0, 0, :].expand(img_h, half)
    fw = freqs_w[:img_w, 0, 0, :].expand(img_w, half)
    fh2 = fh[:, None, :].expand(img_h, img_w, half).reshape(-1, half)
    fw2 = fw[None, :, :].expand(img_h, img_w, half).reshape(-1, half)
    f = torch.cat([fh2, fw2], dim=-1)[None, :, None, :].float()
    return _RopeCached.apply(t, torch.cos(f), torch.sin(f))


def rope_tables(freqs: torch.Tensor, s: int, head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(cos, sin, rot)`` for in-kernel RoPE over ``s`` positions:
    fp32 ``[s, head_dim]`` tables padded past the rotary dim with cos 1 and
    sin 0, so the channels past ``rot`` pass through (the JAX package's
    ``flash_attention_packed``). ``freqs`` is ``[s, rot]`` or the
    ``[s, 1, 1, rot]`` layout of :func:`rope_freqs`."""
    f = freqs.reshape(s, -1).float()
    rot = f.shape[-1]
    if rot % 2 or rot > head_dim:
        raise ValueError(f"rotary dim {rot} must be even and <= head_dim "
                         f"{head_dim}")
    pad = (0, head_dim - rot)
    cos = torch.nn.functional.pad(torch.cos(f), pad, value=1.0)
    sin = torch.nn.functional.pad(torch.sin(f), pad)
    return cos.contiguous(), sin.contiguous(), rot
