"""Functional batch-norm primitives for the vision models.

Counterpart of ``apex_tpu/utils/batch_norm.py``. Statistics are fp32
whatever the activation dtype; the moments are one pass of **shifted**
sums ``(sum(x - c), sum((x - c)^2))`` with ``c`` the running mean (centred,
so ``E[x^2] - E[x]^2`` does not cancel); the normalize is the per-channel
affine ``x * a + b`` applied in the activation dtype, with only the [C]
vectors in fp32.

``p`` holds ``scale`` and ``bias``, ``s`` holds ``mean`` and ``var``
(mappings of tensors, as the JAX dicts). The functions are pure: the new
running statistics come back as tensors, and a module that keeps them as
buffers copies them in. ``axis_name`` (the JAX SyncBN mesh axis) raises
``NotImplementedError`` until the data-parallel slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

__all__ = ["bn_init", "bn_apply", "bn_sums", "bn_from_sums"]

Tensors = Mapping[str, torch.Tensor]


def _local(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"synchronized batch norm over axis {axis_name!r} comes with the "
            f"data-parallel slice of the port")


def bn_init(c: int, device=None):
    """``(params, state)`` of a ``c``-channel batch norm: scale 1, bias 0,
    mean 0, var 1, all fp32."""
    kw = dict(dtype=torch.float32, device=device)
    return ({"scale": torch.ones(c, **kw), "bias": torch.zeros(c, **kw)},
            {"mean": torch.zeros(c, **kw), "var": torch.ones(c, **kw)})


def bn_sums(x, shift, sample_mask=None):
    """Per-channel fp32 ``[2, C]`` shifted sums of NHWC ``x`` over (N, H,
    W): row 0 ``sum(x - shift)``, row 1 ``sum((x - shift)^2)``. The shift
    carries no gradient. ``sample_mask`` (``[N]`` bool) leaves padded batch
    rows out of both sums."""
    xc = x.float() - shift.detach().float()
    if sample_mask is not None:
        # where, not multiply: 0 * NaN in a padded row would poison the sums
        xc = torch.where((sample_mask != 0)[:, None, None, None], xc,
                         torch.zeros_like(xc))
    return torch.stack([xc.sum((0, 1, 2)), xc.square().sum((0, 1, 2))])


def bn_from_sums(p: Tensors, s: Tensors, sums, n, *, shift, momentum: float,
                 eps: float, axis_name: Optional[str]):
    """Close a batch norm from shifted sums built with ``shift``. Returns
    ``(a, b, new_state)``: the normalize is ``y = x * a + b``, and
    ``new_state`` holds the updated running mean and the running var (from
    the unbiased batch variance), detached."""
    _local(axis_name)
    n = torch.as_tensor(n, dtype=torch.float32, device=sums.device)
    shift = shift.detach()
    # an all-padded batch degrades to the shift instead of 0/0
    n_safe = n.clamp_min(1.0)
    d = sums[0] / n_safe
    mean = shift + d
    var = (sums[1] / n_safe - d.square()).clamp_min(0.0)
    with torch.no_grad():
        new_s: Dict[str, torch.Tensor] = {
            "mean": (1 - momentum) * s["mean"] + momentum * mean,
            "var": (1 - momentum) * s["var"]
            + momentum * var * n / (n - 1).clamp_min(1.0),
        }
    inv = torch.rsqrt(var + eps)
    a = inv * p["scale"]
    b = p["bias"] - mean * a
    return a, b, new_s


def bn_apply(p: Tensors, s: Tensors, x, *, train: bool, momentum: float,
             eps: float, axis_name: Optional[str], sample_mask=None):
    """NHWC batch norm: ``(y, new_state)``. Training normalizes with the
    batch statistics (``sample_mask`` rows left out of them and of the
    count), eval with the running ones (the state comes back as it was)."""
    if train:
        if sample_mask is None:
            n = x.shape[0] * x.shape[1] * x.shape[2]
        else:
            n = sample_mask.float().sum() * (x.shape[1] * x.shape[2])
        a, b, new_s = bn_from_sums(p, s, bn_sums(x, s["mean"], sample_mask),
                                   n, shift=s["mean"], momentum=momentum,
                                   eps=eps, axis_name=axis_name)
    else:
        _local(axis_name)
        new_s = dict(s)
        inv = torch.rsqrt(s["var"] + eps)
        a = inv * p["scale"]
        b = p["bias"] - s["mean"] * a
    return x * a.to(x.dtype) + b.to(x.dtype), new_s
