"""Rotary positional embedding (counterpart of ``apex_tpu/ops/rope.py``).

RoPE has no Pallas kernel in the JAX package (XLA fuses it), so this is
plain PyTorch: :func:`rope_freqs` builds the angles in the Megatron
``concat(f, f)`` layout and :func:`fused_rope` applies them.
:func:`rope_tables` builds the fp32 ``(cos, sin)`` tables that the packed
attention kernels rotate q and k with in-kernel.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["rope_freqs", "fused_rope", "rope_tables"]


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


def fused_rope(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to ``t [s, b, h, d]`` with ``freqs`` from
    :func:`rope_freqs`; channels past ``rot_dim`` pass through."""
    f = freqs.float()
    cos, sin = torch.cos(f), torch.sin(f)
    rot_dim = cos.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    out = t_rot * cos + _rotate_half(t_rot) * sin
    if t_pass.shape[-1]:
        out = torch.cat([out, t_pass], dim=-1)
    return out.to(t.dtype)


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
