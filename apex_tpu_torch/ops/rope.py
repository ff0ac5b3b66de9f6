"""Rotary positional embedding (counterpart of ``apex_tpu/ops/rope.py``).

RoPE has no Pallas kernel in the JAX package (XLA fuses it), so this is
plain PyTorch: :func:`rope_freqs` builds the angles in the Megatron
``concat(f, f)`` layout and :func:`fused_rope` applies them.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["rope_freqs", "fused_rope"]


def rope_freqs(start: Union[int, torch.Tensor], length: int, rot_dim: int,
               theta: float, device=None) -> torch.Tensor:
    """Angles for positions ``[start, start + length)``: ``[s, 1, 1,
    rot_dim]``, or ``[s, b, 1, rot_dim]`` when ``start`` is a ``[b]``
    tensor of per-row offsets (continuous-batching decode)."""
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
