"""GPT: embeddings -> transformer stack -> weight-tied LM head and loss.

Counterpart of ``apex_tpu/models/gpt.py`` at tensor-parallel size 1:
``GPTModel.forward(tokens)`` returns logits, and with ``labels`` the
scalar (optionally loss-masked) mean LM loss through
:func:`lm_head_loss`, differentiable for training. The word embedding is
tied to the LM head, so its gradient sums the lookup's and the head's.
The model owns its parameters, initialised from a ``torch.Generator`` the
way the JAX package's ``init`` draws them: normal with
``init_method_std`` (residual-output projections scaled by
``1/sqrt(2 L)``), norms at one / zero, biases at zero. Dropout
(``deterministic=False`` with an ``rng`` key) splits the key into the
embedding's and the stack's, as the JAX ``apply`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.models.transformer import (
    Embedding,
    ParallelTransformer,
    TransformerConfig,
    embed_tokens,
)
from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.transformer.tensor_parallel import (
    checkpoint,
    linear,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.utils import prng

__all__ = ["GPTModel", "lm_head", "lm_head_loss", "init_weights"]


def lm_head_loss(embedding_weight: torch.Tensor, hidden: torch.Tensor,
                 labels: Optional[torch.Tensor],
                 loss_mask: Optional[torch.Tensor],
                 config: TransformerConfig) -> torch.Tensor:
    """Weight-tied LM head + vocab-parallel loss (the JAX package's
    ``lm_head_loss``): the head matmul runs in the compute dtype (the
    weight is cast to it), the cross entropy in fp32. Returns logits
    ``[s, b, V]`` when ``labels`` is None, else the scalar mean loss over
    ``labels [b, s]`` — masked by ``loss_mask [b, s]`` when given. With
    ``loss_seq_chunks`` > 1 dividing the sequence, the head and the cross
    entropy run a chunk of positions at a time, each recomputed in the
    backward, so only one chunk's logits exist at once."""

    def head(hid, weight):
        return linear(hid.to(config.compute_dtype), weight, None)

    if labels is None:
        return head(hidden, embedding_weight)
    labels_sb = labels.t()
    nc = config.loss_seq_chunks
    if nc > 1 and hidden.shape[0] % nc == 0:
        def chunk_losses(hid, lab, weight):
            return vocab_parallel_cross_entropy(head(hid, weight), lab)

        losses = torch.cat([
            checkpoint(chunk_losses, hid, lab, embedding_weight)
            for hid, lab in zip(hidden.chunk(nc), labels_sb.chunk(nc))])
    else:
        losses = vocab_parallel_cross_entropy(head(hidden, embedding_weight),
                                              labels_sb)     # [s, b]
    if loss_mask is None:
        return losses.mean()
    mask = loss_mask.t().to(losses.dtype)
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


def lm_head(model: "GPTModel", hidden: torch.Tensor) -> torch.Tensor:
    """Weight-tied LM head in the compute dtype: ``[s, b, V]`` logits."""
    return lm_head_loss(model.embedding.word_embeddings.weight, hidden, None,
                        None, model.config)


@torch.no_grad()
def init_weights(model: "GPTModel",
                 generator: Optional[torch.Generator] = None) -> None:
    """Draw every weight from ``generator`` on the generator's device (a
    CPU generator, so the same seed gives the same weights on any device;
    a CUDA generator draws a large model's weights on the card): norms at
    one, biases at zero, the residual-output projections (every
    attention's ``dense`` and the MLP's ``dense_4h_to_h``) at
    ``output_init_std``, the rest at ``init_method_std``."""
    c = model.config
    out_proj = ("attention.dense.weight", "mlp.dense_4h_to_h.weight")
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            std = (c.output_init_std if name.endswith(out_proj)
                   else c.init_method_std)
            draw = torch.randn(p.shape, generator=generator,
                               dtype=torch.float32,
                               device=None if generator is None
                               else generator.device)
            p.copy_(draw * std)


class GPTModel(nn.Module):
    """GPT: embeddings -> :class:`ParallelTransformer` (causal) -> tied LM
    head. Built on ``device`` (``"cuda"`` unless the caller asks for the
    CPU) with weights drawn from ``generator``."""

    def __init__(self, config: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embedding = Embedding(config, device=device)
        self.transformer = ParallelTransformer(config, device=device)
        init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return self.embedding.word_embeddings.weight.device

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None, *,
                loss_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        """``tokens [b, s]`` -> logits ``[s, b, V]``, or with ``labels
        [b, s]`` the scalar mean loss (masked by ``loss_mask``). Dropout is
        active with ``deterministic=False``, a rate > 0 and ``rng``, a
        :mod:`~apex_tpu_torch.utils.prng` key (moved to the model's
        device)."""
        c = self.config
        rngs = (None, None) if rng is None else \
            tuple(prng.split(rng.to(self.device)))
        hidden = embed_tokens(self.embedding, tokens, c, rng=rngs[0],
                              deterministic=deterministic)
        hidden = self.transformer(hidden, rng=rngs[1],
                                  deterministic=deterministic)
        return lm_head_loss(self.embedding.word_embeddings.weight, hidden,
                            labels, loss_mask, c)
