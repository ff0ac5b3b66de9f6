"""Cached forward and decode step for :class:`GPTModel`.

Counterpart of the serving half of ``apex_tpu/models/generation.py``.
Caches are plain Python LISTS of per-layer ``(k, v)`` tensor pairs and
are updated IN PLACE (the JAX package returns new arrays; the returned
caches here are the same tensors that were passed in):

- :func:`init_kv_caches` — 4D ``[b, kv_heads, S, head_dim]`` pairs, the
  prefill form (the JAX ``stacked=False`` form), or with ``flat=True``
  ``[b, S, kv_heads * head_dim]`` pairs, the flat decode form;
- :func:`init_paged_kv_caches` — ``[n_pages, page_size, kv_heads *
  head_dim]`` page pools, the paged decode form; with ``quantized=True``
  int8 pools, each nested as a ``(pages, scales)`` pair with its float32
  ``[n_pages, kv_heads]`` scale sidecar.

Everything here runs under ``torch.no_grad()``: the path is inference.
:func:`generate` is the batch primitive: one prefill, then a Python decode
loop over the flat caches, greedy or sampled with the port's threefry
(:mod:`apex_tpu_torch.utils.prng`), token-exact against the JAX package.
The JAX ``preslice_layer_params`` has no counterpart: the port's layers
are already one module each (there is no stacked ``[L, ...]`` parameter
form to slice).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.models.gpt import GPTModel, lm_head
from apex_tpu_torch.ops.decode_attention import page_pool, scale_pool
from apex_tpu_torch.utils.prng import categorical, fold_in, prng_key

__all__ = ["cast_decode_params", "flatten_decode_caches", "init_kv_caches",
           "init_paged_kv_caches", "decode_step", "generate"]

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def cast_decode_params(model: GPTModel, compute_dtype: torch.dtype
                       ) -> GPTModel:
    """A copy of ``model`` whose float32 parameters are cast to
    ``compute_dtype`` once, for decoding. ``model`` is left as it was (the
    JAX function likewise returns new parameters); tied parameters stay
    tied in the copy, the float32 ones are never copied at full width, and
    the others are shared, not copied (as JAX's cast returns them as they
    are): a model already in a 16-bit type costs no second copy of its
    weights."""
    memo = {id(p): (nn.Parameter(p.to(compute_dtype),
                                 requires_grad=p.requires_grad)
                    if p.dtype == torch.float32 else p)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def flatten_decode_caches(caches: Caches) -> Caches:
    """4D ``[b, h, S, d]`` per-layer pairs -> flat ``[b, S, h*d]`` pairs."""

    def fl(x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    return [(fl(k), fl(v)) for k, v in caches]


def init_kv_caches(model: GPTModel, batch_size: int, max_len: int,
                   dtype: Optional[torch.dtype] = None, *,
                   flat: bool = False) -> Caches:
    """Zeroed per-layer 4D caches ``[batch, kv_heads, max_len, head_dim]``
    on the model's device; ``flat=True`` gives the flat decode form
    ``[batch, max_len, kv_heads * head_dim]`` (the JAX ``stacked=False,
    flat=True`` form)."""
    c = model.config
    shape = (batch_size, c.kv_heads, max_len, c.head_dim)
    if flat:
        shape = (batch_size, max_len, c.kv_heads * c.head_dim)
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
                    paged_state=None, lora=None):
    """Run ``tokens [b, s]`` at cache offset ``index`` -> (fp32 logits
    ``[s, b, V]``, caches). ``index`` is an int (prefill at 0) or a
    ``[b]`` tensor of per-slot positions (paged decode). ``last_only`` /
    ``last_index`` compute the LM head for one position only — the
    bucketed prefill reads row ``prompt_len - 1`` of a right-padded
    prompt. ``lora`` is the per-slot adapter factors ``[L, b, ...]`` the
    serving engine gathers (see :class:`~apex_tpu_torch.models.transformer.\
ParallelTransformer`)."""
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
                                       paged_state=paged_state, lora=lora)
    if last_only:
        hidden = hidden[-1:]
    elif last_index is not None:
        hidden = hidden[last_index:last_index + 1]
    return lm_head(model, hidden).float(), caches


def decode_step(model: GPTModel, caches: Caches, tokens: torch.Tensor,
                index, paged_state=None, lora=None):
    """One step: ``tokens [b]`` at positions ``index`` -> (fp32 logits
    ``[b, V]``, caches). With ``paged_state`` (``[b, pages_per_slot]``
    page table) ``caches`` are the page pools (``(pages, scales)`` pairs
    when quantized) and ``index`` the ``[b]`` position vector; ``lora``
    as :func:`_cached_forward` takes it."""
    logits, caches = _cached_forward(model, caches, tokens[:, None], index,
                                     paged_state=paged_state, lora=lora)
    return logits[0], caches


@torch.no_grad()
def generate(model: GPTModel, prompt: torch.Tensor, max_new_tokens: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: Optional[int] = None,
             rng: Optional[torch.Tensor] = None,
             eos_token: Optional[int] = None) -> torch.Tensor:
    """Generate ``[batch, prompt_len + max_new_tokens]`` token ids from
    ``prompt [batch, prompt_len]`` (on the model's device).

    ``temperature == 0`` is greedy; otherwise softmax sampling, truncated to
    the ``top_k`` largest logits (``torch.topk``, as JAX's ``lax.top_k``)
    when given, with ``rng`` (a threefry key, :func:`~apex_tpu_torch.utils.\
prng.prng_key`): the token after position ``i`` is drawn with
    ``fold_in(rng, i)`` over the whole ``[batch, V]`` logits, as the JAX
    ``generate`` draws it. ``eos_token`` freezes finished rows (they keep
    emitting it). The prompt prefills in one batched forward on the 4D
    caches (the flash kernel), whose caches then flatten for a Python loop
    of single-token decode steps over the flat caches."""
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if temperature > 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng")
    c = model.config
    if c.compute_dtype != torch.float32:
        model = cast_decode_params(model, c.compute_dtype)
    b, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if (c.position_embedding_type == "learned"
            and total > c.max_position_embeddings):
        raise ValueError(
            f"prompt + new tokens ({total}) exceeds max_position_embeddings "
            f"({c.max_position_embeddings}); the clamped position lookup "
            f"would silently repeat the last row")
    S = max_len or total
    if S < total:
        raise ValueError(f"max_len {S} < prompt+new tokens {total}")
    dev = model.device
    prompt = prompt.to(dev)
    rng = prng_key(0, dev) if rng is None else rng.to(dev)
    out = torch.zeros((b, total), dtype=prompt.dtype, device=dev)
    out[:, :prompt_len] = prompt
    # a device tensor, never a Python scalar: CUDA divides by a host scalar
    # through its reciprocal, which is not the CPU's (nor XLA's) division
    temp = torch.tensor(temperature, dtype=torch.float32, device=dev)

    def pick_next(logits, key):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits = logits / temp
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, float("-inf"), logits)
        return categorical(key, logits).to(prompt.dtype)

    caches = init_kv_caches(model, b, S)
    prefill_logits, caches = _cached_forward(model, caches, prompt, 0,
                                             last_only=True)
    caches = flatten_decode_caches(caches)
    first = pick_next(prefill_logits[-1], fold_in(rng, 0))
    out[:, prompt_len] = first
    done = (first == eos_token) if eos_token is not None else None
    for i in range(prompt_len, total - 1):
        logits, caches = decode_step(model, caches, out[:, i], i)
        nxt = pick_next(logits, fold_in(rng, i))
        if eos_token is not None:
            nxt = torch.where(done, eos_token, nxt)
            done = done | (nxt == eos_token)
        out[:, i + 1] = nxt
    return out
