"""MLP activation helpers (counterpart of ``apex_tpu/utils/activations.py``).

Gated activations take the unit-interleaved ``2*ffn`` layout (column
``2i`` = gate_i, ``2i+1`` = up_i) and halve the last dim. GELU is the tanh
approximation, matching ``jax.nn.gelu(approximate=True)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = ("gelu", "relu", "swiglu", "geglu")
GATED = ("swiglu", "geglu")

__all__ = ["ACTIVATIONS", "GATED", "is_gated", "validate_activation",
           "apply_activation"]


def is_gated(activation: str) -> bool:
    return activation in GATED


def validate_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"activation must be one of {ACTIVATIONS}, got {activation!r}")


def apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Apply ``activation`` to an FFN pre-activation."""
    if is_gated(activation):
        x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
        gate, up = x[..., 0], x[..., 1]
        act = (F.silu(gate) if activation == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        return act * up
    if activation == "relu":
        return F.relu(x)
    return F.gelu(x, approximate="tanh")
