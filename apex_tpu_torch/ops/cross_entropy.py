"""Softmax cross entropy with label smoothing and an ignored index.

Counterpart of ``apex_tpu/ops/cross_entropy.py`` (the contrib xentropy
extension's function): the forward keeps only the row's log-sum-exp, and
the backward, a :class:`torch.autograd.Function` as the JAX package's
custom VJP (``_vjp_bwd``), recomputes the probabilities from it. Plain
PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy_loss", "SoftmaxCrossEntropyLoss"]


def _fwd_math(logits, labels, smoothing: float, ignore_index: int):
    """Per-example fp32 loss and log-sum-exp (``_fwd_math``)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    picked = lf.gather(-1, safe[:, None].long())[:, 0]
    nll = lse - picked
    if smoothing > 0.0:
        # uniform smoothing: smoothing * the mean over classes of -log p
        nll = (1.0 - smoothing) * nll + smoothing * (lse - lf.mean(dim=-1))
    return torch.where(valid, nll, torch.zeros_like(nll)), lse


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, ignore_index):
        loss, lse = _fwd_math(logits, labels, smoothing, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.ignore_index = smoothing, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        smoothing = ctx.smoothing
        probs = torch.exp(logits.float() - lse[:, None])
        v = logits.shape[-1]
        valid = labels != ctx.ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        onehot = torch.nn.functional.one_hot(safe.long(), v).float()
        target = ((1.0 - smoothing) * onehot + smoothing / v
                  if smoothing > 0.0 else onehot)
        dlogits = (probs - target) * g[:, None]
        dlogits = torch.where(valid[:, None], dlogits,
                              torch.zeros_like(dlogits))
        return dlogits.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               ignore_index: int = -100) -> torch.Tensor:
    """Per-example loss ``[N]`` (fp32) of ``logits [N, V]`` (any float
    dtype) against ``labels [N]``; rows labelled ``ignore_index`` give 0
    and no gradient."""
    return _SoftmaxXent.apply(logits, labels, float(smoothing),
                              int(ignore_index))


class SoftmaxCrossEntropyLoss:
    """The contrib module's API (``SoftmaxCrossEntropyLoss.apply``)."""

    @staticmethod
    def apply(logits, labels, smoothing: float = 0.0,
              padding_idx: int = -100):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx)
