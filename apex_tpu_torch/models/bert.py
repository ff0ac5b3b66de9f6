"""BERT: a bidirectional encoder with the MLM head and the binary head.

Counterpart of ``apex_tpu/models/bert.py`` at tensor-parallel size 1:
embeddings (word + learned position + tokentype) -> a padding-mask
:class:`ParallelTransformer` -> the LM head (dense, tanh GELU, LayerNorm and
the projection tied to the word embedding, all in the compute dtype) and,
with ``add_binary_head``, the pooler and binary classifier in fp32.

With a ``padding_mask`` the attention takes the masked path: the mask from
:meth:`BertModel.build_attention_mask` sends every layer's scores through
the fused masked softmax (Kernels G and H on the card). The LM loss is the
vocab-parallel cross entropy, averaged over the valid tokens of the
padding mask. Under an LM-only loss the binary head takes no part in the
loss; :func:`~apex_tpu_torch.training.make_train_step` gives it zero
gradients, as the JAX gradient has, so an optimizer still updates it.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.models.gpt import init_weights
from apex_tpu_torch.models.transformer import (
    Embedding,
    ParallelTransformer,
    TransformerConfig,
    _norm,
    embed_tokens,
)
from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    linear,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.utils import prng

__all__ = ["BertModel"]


class _LMHead(nn.Module):
    """``BertLMHead``: dense and norm before the tied projection."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.dense = ColumnParallelLinear(
            config.hidden_size, config.hidden_size,
            params_dtype=config.params_dtype, device=device)
        self.layernorm = _norm(config, device)


class _BinaryHead(nn.Module):
    """The pooler over the first token and the 2-way classifier."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        kw = dict(params_dtype=config.params_dtype, device=device)
        self.pooler = ColumnParallelLinear(config.hidden_size,
                                           config.hidden_size, **kw)
        self.classifier = ColumnParallelLinear(config.hidden_size, 2, **kw)


class BertModel(nn.Module):
    """BERT on ``device`` (``"cuda"`` unless the caller asks for the CPU),
    weights drawn from ``generator`` (the classifier starts at zero, as in
    the JAX ``init``). A causal ``config`` becomes a padding one."""

    def __init__(self, config: TransformerConfig, *, num_tokentypes: int = 2,
                 add_binary_head: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if config.attn_mask_type == AttnMaskType.causal:
            config = replace(config, attn_mask_type=AttnMaskType.padding)
        self.config = config
        self.add_binary_head = add_binary_head
        self.embedding = Embedding(config, num_tokentypes, device=device)
        self.transformer = ParallelTransformer(config, device=device)
        self.lm_head = _LMHead(config, device)
        self.binary_head = (_BinaryHead(config, device) if add_binary_head
                            else None)
        init_weights(self, generator)
        if add_binary_head:
            with torch.no_grad():
                self.binary_head.classifier.weight.zero_()

    @staticmethod
    def build_attention_mask(padding_mask: torch.Tensor) -> torch.Tensor:
        """``[b, s]`` (True = valid token) -> ``[b, 1, s, s]`` bool, True =
        masked out: a pair is visible when both its tokens are valid, so a
        padded query row masks every key."""
        m = padding_mask.to(torch.bool)
        return ~(m[:, None, None, :] & m[:, None, :, None])

    def forward(self, tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                tokentype_ids: Optional[torch.Tensor] = None,
                lm_labels: Optional[torch.Tensor] = None, *,
                rng: Optional[torch.Tensor] = None,
                deterministic: bool = True):
        """``tokens``, ``padding_mask``, ``tokentype_ids``, ``lm_labels``:
        ``[b, s]``. Returns ``(lm_loss or logits [s, b, V], binary_logits
        [b, 2] or None)``, the JAX ``apply``'s pair. Dropout, with
        ``deterministic=False`` and an ``rng`` key: the key split into the
        embedding's and the stack's, as the JAX ``apply`` splits it (the
        heads drop nothing)."""
        c = self.config
        rngs = (None, None) if rng is None else tuple(prng.split(
            rng.to(self.embedding.word_embeddings.weight.device)))
        hidden = embed_tokens(self.embedding, tokens, c, tokentype_ids,
                              rng=rngs[0], deterministic=deterministic)
        mask = (None if padding_mask is None
                else self.build_attention_mask(padding_mask))
        hidden = self.transformer(hidden, attention_mask=mask, rng=rngs[1],
                                  deterministic=deterministic)
        binary_logits = None
        if self.add_binary_head:
            pooler = self.binary_head.pooler
            pooled = torch.tanh(hidden[0].float() @ pooler.weight.t().float()
                                + pooler.bias)
            cls = self.binary_head.classifier
            # fp32 as jnp promotes it: under amp O2 the classifier is 16-bit
            binary_logits = pooled @ cls.weight.t().to(pooled.dtype) + \
                cls.bias
        h = self.lm_head.dense(hidden.to(c.compute_dtype))
        h = F.gelu(h, approximate="tanh")
        h = self.lm_head.layernorm(h, out_dtype=h.dtype)
        logits = linear(h.to(c.compute_dtype),
                        self.embedding.word_embeddings.weight, None)
        if lm_labels is None:
            return logits, binary_logits
        losses = vocab_parallel_cross_entropy(logits, lm_labels.t())
        if padding_mask is None:
            return losses.mean(), binary_logits
        m = padding_mask.t().to(losses.dtype)
        return (losses * m).sum() / m.sum().clamp_min(1.0), binary_logits
