"""Vocab-parallel cross entropy at tensor-parallel size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
with the world size fixed at 1 (the three all-reduces become identities).
Plain PyTorch: the JAX package has no Pallas kernel here. The math is
fp32 whatever the logits' dtype; the backward reads the softmax saved in
the LOGITS' dtype (bf16 logits keep a bf16 residual) and returns the grad
in that dtype.

Label smoothing follows the reference formulation
``loss = (1 - s') * nll - s' * mean(log_probs)`` with
``s' = label_smoothing * V / (V - 1)``; ``z_loss`` adds
``z_loss * log(Z)^2`` per token after the smoothing rescale.
"""

from __future__ import annotations

import torch

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing: float, z_loss: float):
        in_dtype = logits.dtype
        vocab = logits.shape[-1]
        lf = logits.float()
        logits_max = lf.amax(dim=-1)
        shifted = lf - logits_max[..., None]
        # ids outside [0, V) have no logit here (another rank's, under
        # tensor parallelism): their predicted logit is 0
        in_range = (target >= 0) & (target < vocab)
        masked_target = torch.where(in_range, target,
                                    torch.zeros_like(target)).long()
        predicted = torch.gather(shifted, -1, masked_target[..., None])[..., 0]
        predicted = torch.where(in_range, predicted,
                                torch.zeros_like(predicted))
        exp_logits = torch.exp(shifted)
        sum_exp = exp_logits.sum(dim=-1)
        loss = torch.log(sum_exp) - predicted
        softmax = exp_logits / sum_exp[..., None]
        smoothing = 0.0
        if label_smoothing > 0:
            smoothing = label_smoothing * vocab / (vocab - 1)
            log_probs = shifted - torch.log(sum_exp)[..., None]
            mean_log_probs = log_probs.sum(dim=-1) / vocab
            loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
        log_z = None
        if z_loss > 0.0:
            log_z = torch.log(sum_exp) + logits_max
            loss = loss + z_loss * log_z * log_z
        # residual in the logits' dtype (half the bytes for bf16 logits)
        ctx.save_for_backward(softmax.to(in_dtype), in_range, masked_target,
                              log_z)
        ctx.smoothing, ctx.vocab, ctx.z_loss = smoothing, vocab, z_loss
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, in_range, masked_target, log_z = ctx.saved_tensors
        grad = softmax.float()
        onehot = torch.zeros_like(grad)
        onehot.scatter_(-1, masked_target[..., None],
                        in_range[..., None].float())
        if ctx.smoothing > 0:
            grad = grad - (1.0 - ctx.smoothing) * onehot \
                - ctx.smoothing / ctx.vocab
        else:
            grad = grad - onehot
        if ctx.z_loss > 0.0:
            # d/dlogits [z * logZ^2] = 2 z logZ * softmax
            grad = grad + (2.0 * ctx.z_loss) * log_z[..., None] \
                * softmax.float()
        grad = grad * g[..., None].float()
        return grad.to(softmax.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 z_loss: float = 0.0) -> torch.Tensor:
    """Per-token loss (fp32) from logits ``[..., V]`` and integer ids
    ``[...]``; differentiable in ``logits``."""
    if target.shape != logits.shape[:-1]:
        raise ValueError(f"target {tuple(target.shape)} does not match "
                         f"logits {tuple(logits.shape)} without the vocab "
                         f"dim")
    return _VocabParallelCrossEntropy.apply(logits, target,
                                            float(label_smoothing),
                                            float(z_loss))
