"""Cached forward and decode step for :class:`GPTModel`.

Counterpart of the serving half of ``apex_tpu/models/generation.py``.
Caches are plain Python LISTS of per-layer ``(k, v)`` tensor pairs and
are updated IN PLACE (the JAX package returns new arrays; the returned
caches here are the same tensors that were passed in):

- :func:`init_kv_caches` — 4D ``[b, kv_heads, S, head_dim]`` pairs, the
  prefill form (the JAX ``stacked=False`` form);
- :func:`init_paged_kv_caches` — ``[n_pages, page_size, kv_heads *
  head_dim]`` page pools, the paged decode form; with ``quantized=True``
  int8 pools, each nested as a ``(pages, scales)`` pair with its float32
  ``[n_pages, kv_heads]`` scale sidecar.

Everything here runs under ``torch.no_grad()``: the path is inference.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.models.gpt import GPTModel, lm_head
from apex_tpu_torch.ops.decode_attention import page_pool, scale_pool

__all__ = ["cast_decode_params", "flatten_decode_caches", "init_kv_caches",
           "init_paged_kv_caches", "decode_step"]

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def cast_decode_params(model: GPTModel, compute_dtype: torch.dtype
                       ) -> GPTModel:
    """A copy of ``model`` whose float32 parameters are cast to
    ``compute_dtype`` once, for decoding. ``model`` is left as it was (the
    JAX function likewise returns new parameters); tied parameters stay
    tied in the copy, and the float32 ones are never copied at full
    width."""
    memo = {id(p): nn.Parameter(p.to(compute_dtype),
                                requires_grad=p.requires_grad)
            for p in model.parameters() if p.dtype == torch.float32}
    return copy.deepcopy(model, memo)


def flatten_decode_caches(caches: Caches) -> Caches:
    """4D ``[b, h, S, d]`` per-layer pairs -> flat ``[b, S, h*d]`` pairs."""

    def fl(x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    return [(fl(k), fl(v)) for k, v in caches]


def init_kv_caches(model: GPTModel, batch_size: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Caches:
    """Zeroed per-layer 4D caches ``[batch, kv_heads, max_len, head_dim]``
    on the model's device."""
    c = model.config
    shape = (batch_size, c.kv_heads, max_len, c.head_dim)
    dtype = dtype or c.compute_dtype
    return [(torch.zeros(shape, dtype=dtype, device=model.device),
             torch.zeros(shape, dtype=dtype, device=model.device))
            for _ in range(c.num_layers)]


def init_paged_kv_caches(model: GPTModel, n_pages: int, page_size: int,
                         dtype: Optional[torch.dtype] = None, *,
                         quantized: bool = False) -> list:
    """Zeroed per-layer page pools ``[n_pages, page_size, kv_heads *
    head_dim]`` on the model's device. Each pool's storage holds one spare
    page past ``n_pages`` that dropped appends land in (see
    :mod:`apex_tpu_torch.ops.decode_attention`).

    ``quantized=True`` (``kv_dtype="int8"``): the pools are int8 and each
    of k/v nests as a ``(pages, scales)`` pair, ``scales`` the float32
    per-(page, kv-head) sidecar ``[n_pages, kv_heads]`` (with its spare
    row) that the decode op dequantizes from, as in the JAX package."""
    c = model.config
    dtype = torch.int8 if quantized else dtype or c.compute_dtype

    def pool():
        pages = page_pool(n_pages, page_size, c.kv_heads * c.head_dim, dtype,
                          model.device)
        if quantized:
            return pages, scale_pool(n_pages, c.kv_heads, model.device)
        return pages

    return [(pool(), pool()) for _ in range(c.num_layers)]


@torch.no_grad()
def _cached_forward(model: GPTModel, caches: Caches, tokens: torch.Tensor,
                    index, last_only: bool = False, last_index=None,
                    paged_state=None):
    """Run ``tokens [b, s]`` at cache offset ``index`` -> (fp32 logits
    ``[s, b, V]``, caches). ``index`` is an int (prefill at 0) or a
    ``[b]`` tensor of per-slot positions (paged decode). ``last_only`` /
    ``last_index`` compute the LM head for one position only — the
    bucketed prefill reads row ``prompt_len - 1`` of a right-padded
    prompt."""
    c = model.config
    s = tokens.shape[1]
    emb = model.embedding.word_embeddings(tokens)                # [b, s, h]
    if c.position_embedding_type == "learned":
        table = model.embedding.position_embeddings
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            positions = index.long()[:, None] + torch.arange(
                s, device=index.device)[None, :]
            # a position past the table reads NaN, as the JAX gather's
            # fill does (a verify window's padding rows can reach past it)
            n = table.shape[0]
            pos_emb = table[positions.clamp(max=n - 1)]
            emb = emb + torch.where((positions < n)[..., None], pos_emb,
                                    torch.full_like(pos_emb, float("nan")))
        else:
            emb = emb + table[index:index + s][None]
    hidden = emb.transpose(0, 1).to(c.compute_dtype)             # [s, b, h]
    hidden, caches = model.transformer(hidden, kv_caches=caches,
                                       cache_index=index,
                                       paged_state=paged_state)
    if last_only:
        hidden = hidden[-1:]
    elif last_index is not None:
        hidden = hidden[last_index:last_index + 1]
    return lm_head(model, hidden).float(), caches


def decode_step(model: GPTModel, caches: Caches, tokens: torch.Tensor,
                index, paged_state=None):
    """One step: ``tokens [b]`` at positions ``index`` -> (fp32 logits
    ``[b, V]``, caches). With ``paged_state`` (``[b, pages_per_slot]``
    page table) ``caches`` are the page pools (``(pages, scales)`` pairs
    when quantized) and ``index`` the ``[b]`` position vector."""
    logits, caches = _cached_forward(model, caches, tokens[:, None], index,
                                     paged_state=paged_state)
    return logits[0], caches
