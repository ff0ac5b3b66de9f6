"""GPT: embeddings -> transformer stack -> weight-tied LM head.

Counterpart of ``apex_tpu/models/gpt.py`` at tensor-parallel size 1 for
inference (``labels=None``: the model returns logits; the loss comes with
the training slice). The model owns its parameters, initialised from a
``torch.Generator`` the way the JAX package's ``init`` draws them: normal
with ``init_method_std`` (residual-output projections scaled by
``1/sqrt(2 L)``), norms at one / zero, biases at zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.models.transformer import (
    ParallelTransformer,
    TransformerConfig,
)
from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    linear,
)

__all__ = ["GPTModel", "lm_head", "init_weights"]


class _Embedding(nn.Module):
    """The JAX tree's ``embedding`` node: word table and (learned
    positions only) the position table."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            params_dtype=config.params_dtype, device=device)
        self.position_embeddings = (nn.Parameter(torch.empty(
            (config.max_position_embeddings, config.hidden_size),
            dtype=config.params_dtype, device=device))
            if config.position_embedding_type == "learned" else None)


def lm_head(model: "GPTModel", hidden: torch.Tensor) -> torch.Tensor:
    """Weight-tied LM head in the compute dtype: ``[s, b, V]`` logits."""
    return linear(hidden.to(model.config.compute_dtype),
                  model.embedding.word_embeddings.weight, None)


@torch.no_grad()
def init_weights(model: "GPTModel",
                 generator: Optional[torch.Generator] = None) -> None:
    """Draw every weight from ``generator`` (a CPU generator, so the same
    seed gives the same weights on any device)."""
    c = model.config
    out_proj = ("self_attention.dense.weight", "mlp.dense_4h_to_h.weight")
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            std = (c.output_init_std if name.endswith(out_proj)
                   else c.init_method_std)
            draw = torch.randn(p.shape, generator=generator,
                               dtype=torch.float32)
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
        self.embedding = _Embedding(config, device)
        self.transformer = ParallelTransformer(config, device)
        init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return self.embedding.word_embeddings.weight.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [b, s]`` -> logits ``[s, b, V]`` (cache-free causal
        forward; inference only)."""
        c = self.config
        emb = self.embedding.word_embeddings(tokens)
        if c.position_embedding_type == "learned":
            emb = emb + self.embedding.position_embeddings[:tokens.shape[1]]
        hidden = emb.transpose(0, 1).to(c.compute_dtype)
        return lm_head(self, self.transformer(hidden))
