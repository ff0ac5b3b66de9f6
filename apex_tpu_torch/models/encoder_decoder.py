"""Encoder-decoder LM (T5-style) on the transformer blocks.

Counterpart of ``apex_tpu/models/encoder_decoder.py`` at tensor-parallel
size 1: a bidirectional encoder stack, a causal decoder stack whose layers
cross-attend the encoder output, input embeddings tied to the LM head, and
the vocab-parallel LM loss of :func:`~apex_tpu_torch.models.gpt.lm_head_loss`.

Right-padded encoder batches pass ``enc_lengths`` (``[b]`` valid lengths):
the encoder's self-attention then runs the packed flash kernels with
``kv_lengths`` and the decoder's cross-attention the 4D flash forward and
backward (Kernels B and I on the card). A boolean ``enc_padding_mask``
(``[b, s_enc]``, True = pad) sends both through the fused masked softmax
(Kernels G and H) instead.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.models.gpt import init_weights, lm_head_loss
from apex_tpu_torch.models.transformer import (
    Embedding,
    ParallelTransformer,
    TransformerConfig,
    embed_tokens,
)
from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.transformer.enums import AttnMaskType, LayerType
from apex_tpu_torch.utils import prng

__all__ = ["EncoderDecoderModel"]


class EncoderDecoderModel(nn.Module):
    """``forward(enc_tokens, dec_tokens, labels=None)``. ``config``
    describes the decoder; the encoder has its sizes with padding
    attention and ``num_encoder_layers`` depth (default
    ``config.num_layers``). Built on ``device`` (``"cuda"`` unless the
    caller asks for the CPU) with weights drawn from ``generator``."""

    def __init__(self, config: TransformerConfig, *,
                 num_encoder_layers: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        n_enc = (config.num_layers if num_encoder_layers is None
                 else num_encoder_layers)
        if n_enc < 1:
            raise ValueError(f"num_encoder_layers must be >= 1, got {n_enc}")
        self.config = config
        self.enc_config = replace(config, attn_mask_type=AttnMaskType.padding,
                                  num_layers=n_enc)
        self.dec_config = replace(config, attn_mask_type=AttnMaskType.causal)
        self.embedding = Embedding(config, device=device)
        self.encoder = ParallelTransformer(self.enc_config, device=device)
        self.decoder = ParallelTransformer(
            self.dec_config, layer_type=LayerType.decoder, device=device)
        init_weights(self, generator)

    def forward(self, enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None, *,
                enc_padding_mask: Optional[torch.Tensor] = None,
                enc_lengths: Optional[torch.Tensor] = None,
                loss_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        """Tokens and labels ``[b, s]``. Returns the scalar LM loss with
        ``labels`` (masked by ``loss_mask``), else decoder logits ``[s_dec,
        b, V]``. Pass ``enc_padding_mask`` or ``enc_lengths``, not both.
        Dropout, with ``deterministic=False`` and an ``rng`` key: the key
        split in 4 (encoder embedding, encoder, decoder embedding,
        decoder), as the JAX ``apply`` splits it."""
        c = self.config
        if enc_padding_mask is not None and enc_lengths is not None:
            raise ValueError("pass enc_padding_mask or enc_lengths, not both")
        rngs = (None,) * 4 if rng is None else tuple(prng.split(
            rng.to(self.embedding.word_embeddings.weight.device), 4))
        enc_hidden = embed_tokens(self.embedding, enc_tokens, self.enc_config,
                                  rng=rngs[0], deterministic=deterministic)
        enc_mask = (None if enc_padding_mask is None
                    else enc_padding_mask.to(torch.bool)[:, None, None, :])
        enc_out = self.encoder(enc_hidden, attention_mask=enc_mask,
                               kv_lengths=enc_lengths, rng=rngs[1],
                               deterministic=deterministic)
        dec_hidden = embed_tokens(self.embedding, dec_tokens, self.dec_config,
                                  rng=rngs[2], deterministic=deterministic)
        dec_out = self.decoder(dec_hidden, encoder_output=enc_out,
                               enc_dec_attn_mask=enc_mask,
                               enc_kv_lengths=enc_lengths, rng=rngs[3],
                               deterministic=deterministic)
        return lm_head_loss(self.embedding.word_embeddings.weight, dec_out,
                            labels, loss_mask, c)
