"""Megatron-style transformer blocks in PyTorch, for training and serving.

Counterpart of ``apex_tpu/models/transformer.py`` at tensor-parallel size
1: ``TransformerConfig``, the embedding (``Embedding``, ``embed_tokens``),
``ParallelMLP``, ``ParallelAttention`` (self- and cross-attention),
``ParallelTransformerLayer`` (encoder and decoder layers) and
``ParallelTransformer`` (a layer loop; the per-layer LIST cache loop when
decoding). Layout is Megatron's ``[seq, batch, hidden]``. Module and
parameter names follow the JAX parameter tree, so ``state_dict`` keys read
like its paths (:mod:`apex_tpu_torch.convert`).

What runs here:

- self-attention without a cache or mask (training, and the cache-free
  forward): the packed-QKV attention
  :func:`~apex_tpu_torch.ops.attention.flash_attention_packed` on the fused
  projection, differentiable, with RoPE in-kernel and ``kv_lengths`` — the
  JAX package's packed path;
- otherwise ``_core_attention`` over ``[b, heads, s, head_dim]``: with no
  mask the differentiable 4D
  :func:`~apex_tpu_torch.ops.flash_attention` (cross-attention, with the
  encoder's ``kv_lengths``); with a boolean mask the unfused product, the
  scores divided by ``sqrt(head_dim)`` in the compute dtype and
  :class:`~apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`
  (the masked softmax kernels; ``kv_lengths`` and the window are folded
  into the mask);
- a 4D ``[b, kv_heads, S, head_dim]`` cache: K/V written into the cache
  in place at ``cache_index``; at ``cache_index == 0`` (a Python int, no
  mask or ``kv_lengths``) the prefill fast path, causal flash over the
  filled prefix; otherwise (a prefix-cache suffix prefill, a prefill
  chunk; ``cache_index`` a tensor) an explicit offset-causal mask over the
  whole cache and the unfused masked softmax (inference);
- a FLAT ``[b, S, kv_heads * head_dim]`` cache (``generate()`` and the
  engine's ``kv_layout="flat"``): ``cache_index`` an int or a ``[b]``
  vector of per-row offsets, each row written at its own offset and
  masked offset-causally, within the window and below ``kv_lengths``; one
  token runs two GEMMs and an fp32 softmax, more run the grouped product
  and the masked softmax (``_flat_cache_attention``);
- ``paged_state`` (a page table) with a ``[b]`` position vector: the paged
  decode step, or an ``s``-row speculative verify window, through
  :func:`~apex_tpu_torch.ops.fused_paged_decode_attention`, over bf16/f32
  pools or int8 ``(pages, scales)`` pairs.

Dropout (``deterministic=False`` with a rate > 0 and an ``rng`` key) draws
the JAX package's masks bitwise: keys are :mod:`apex_tpu_torch.utils.prng`
keys split and folded as the JAX layers split theirs, hidden and
embedding dropout is ``bernoulli(key, 1 - rate)`` over the tensor, the
packed attention's in-kernel hash dropout takes one seed a layer (one
``randint`` base draw plus ``idx * 0x9E3779B9``), and the masked softmax
path drops the probabilities. ``recompute`` (``True``/``'full'``: the
whole layer under :func:`~apex_tpu_torch.transformer.tensor_parallel.checkpoint`;
``'selective'``: the outputs of the non-batched matmuls saved, everything
else recomputed, JAX's ``dots_with_no_batch_dims_saveable``) gives the
same masks on recompute, since no mask reads a global generator.

Not ported: sequence/context parallelism and MoE. ``scan_unroll`` is
accepted and has no effect (the layers run as a Python loop).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.ops import (
    flash_attention,
    fused_paged_decode_attention,
    fused_rope,
    rope_freqs,
)
from apex_tpu_torch.ops.attention import (
    flash_attention_packed,
    packed_attention_supported,
)
from apex_tpu_torch.transformer.enums import AttnMaskType, AttnType, LayerType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    checkpoint,
    model_parallel_rng_key,
)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.activations import (
    apply_activation,
    is_gated,
    validate_activation,
)

__all__ = ["TransformerConfig", "Embedding", "embed_tokens", "ParallelMLP",
           "ParallelAttention", "ParallelTransformerLayer",
           "ParallelTransformer"]


@dataclass(frozen=True)
class TransformerConfig:
    """The model-shaping subset of the JAX package's ``TransformerConfig``
    (same names and defaults; dtypes are torch dtypes)."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    num_query_groups: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    vocab_size: int = 32000
    max_position_embeddings: int = 2048
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_epsilon: float = 1e-5
    position_embedding_type: str = "learned"
    rotary_percent: float = 1.0
    rope_theta: float = 10000.0
    activation: str = "gelu"
    normalization: str = "layernorm"
    attn_mask_type: AttnMaskType = AttnMaskType.causal
    sliding_window: Optional[int] = None
    # False, or True/'full' (the whole layer recomputed) or 'selective'
    # (the non-batched matmuls' outputs saved, the rest recomputed)
    recompute: Any = False
    # the JAX layer scan's unroll factor: no effect on the Python loop
    scan_unroll: int = 1
    # LM-head loss in this many sequence chunks, each recomputed in the
    # backward (skipped when the sequence does not divide)
    loss_seq_chunks: int = 1
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    init_method_std: float = 0.02

    def __post_init__(self):
        if self.position_embedding_type not in ("learned", "rope", "none"):
            raise ValueError(
                f"position_embedding_type must be 'learned', 'rope', or "
                f"'none', got {self.position_embedding_type!r}")
        if not 0.0 < self.rotary_percent <= 1.0:
            raise ValueError(f"rotary_percent must be in (0, 1], got "
                             f"{self.rotary_percent}")
        validate_activation(self.activation)
        if self.normalization not in ("layernorm", "rmsnorm"):
            raise ValueError(f"normalization must be 'layernorm' or "
                             f"'rmsnorm', got {self.normalization!r}")
        if self.sliding_window is not None:
            if self.sliding_window < 1:
                raise ValueError(f"sliding_window must be >= 1, got "
                                 f"{self.sliding_window}")
            if self.attn_mask_type != AttnMaskType.causal:
                raise ValueError("sliding_window requires causal attention")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size ({self.hidden_size}) must be "
                             f"divisible by num_attention_heads "
                             f"({self.num_attention_heads})")
        if self.num_attention_heads % self.kv_heads:
            raise ValueError(f"num_query_groups ({self.kv_heads}) must "
                             f"divide num_attention_heads "
                             f"({self.num_attention_heads})")

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_attention_heads if self.num_query_groups is None
                else self.num_query_groups)

    @property
    def rotary_dim(self) -> int:
        rot = int(self.head_dim * self.rotary_percent)
        rot -= rot % 2
        if rot < 2:
            raise ValueError(
                f"rotary_percent ({self.rotary_percent}) rotates fewer than "
                f"2 of {self.head_dim} head-dim channels")
        return rot

    @property
    def output_init_std(self) -> float:
        """Megatron's residual-output init scale, std / sqrt(2 L)."""
        return self.init_method_std / math.sqrt(2.0 * self.num_layers)


def _norm(config: TransformerConfig, device) -> nn.Module:
    cls = FusedRMSNorm if config.normalization == "rmsnorm" \
        else FusedLayerNorm
    return cls(config.hidden_size, config.layernorm_epsilon,
               params_dtype=config.params_dtype, device=device)


class Embedding(nn.Module):
    """The JAX tree's ``embedding`` node: the word table, the position table
    (learned positions only) and, with ``num_tokentypes``, the tokentype
    table."""

    def __init__(self, config: TransformerConfig, num_tokentypes: int = 0,
                 device=None):
        super().__init__()
        kw = dict(dtype=config.params_dtype, device=device)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            params_dtype=config.params_dtype, device=device)
        self.position_embeddings = (nn.Parameter(torch.empty(
            (config.max_position_embeddings, config.hidden_size), **kw))
            if config.position_embedding_type == "learned" else None)
        self.tokentype_embeddings = (nn.Parameter(torch.empty(
            (num_tokentypes, config.hidden_size), **kw))
            if num_tokentypes else None)


def _dropout(x: torch.Tensor, rate: float, key: Optional[torch.Tensor],
             deterministic: bool) -> torch.Tensor:
    """The JAX package's ``_dropout``: keep each element with probability
    ``1 - rate`` (``jax.random.bernoulli`` over ``x``'s shape, bitwise)
    and scale the kept ones by ``1 / (1 - rate)`` in ``x``'s dtype; a
    no-op when deterministic, at rate 0 or without a key. At
    tensor-parallel size 1 a model-parallel region draws from the key
    itself."""
    if deterministic or rate == 0.0 or key is None:
        return x
    keep = prng.bernoulli(model_parallel_rng_key(key), 1.0 - rate, x.shape)
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


def embed_tokens(embedding: Embedding, tokens: torch.Tensor,
                 config: TransformerConfig,
                 tokentype_ids: Optional[torch.Tensor] = None, *,
                 rng: Optional[torch.Tensor] = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Word + learned position (+ tokentype) lookups in the params' dtype,
    ``[b, s, h] -> [s, b, h]`` in the compute dtype, then the embedding
    dropout with ``hidden_dropout`` (the JAX package's ``embed_tokens``)."""
    emb = embedding.word_embeddings(tokens)
    if config.position_embedding_type == "learned":
        emb = emb + embedding.position_embeddings[:tokens.shape[1]]
    if tokentype_ids is not None:
        emb = emb + embedding.tokentype_embeddings[tokentype_ids]
    hidden = emb.transpose(0, 1).to(config.compute_dtype)
    return _dropout(hidden, config.hidden_dropout, rng, deterministic)


def _lora_delta(x: torch.Tensor, lora) -> torch.Tensor:
    """Per-slot low-rank delta of one target projection, ``(x @ A) @ B``
    with per-batch-element factors: ``x [s, b, h]``, ``A [b, h, r]``, ``B
    [b, r, out]`` -> fp32 ``[s, b, out]`` (the JAX package's
    ``_lora_delta``). The serving engine gathers each slot's factors from
    the adapter bank (:mod:`apex_tpu_torch.lora`; the null row is all
    zeros, so a base-traffic slot adds an exact 0). Both products run in
    fp32 and the caller rounds once, to the projection's dtype."""
    d = torch.bmm(x.float().transpose(0, 1), lora["A"].float())  # [b, s, r]
    return torch.bmm(d, lora["B"].float()).transpose(0, 1)


class ParallelMLP(nn.Module):
    """h -> ffn (column) -> activation -> h (row); gated activations widen
    the column projection to ``2*ffn``, unit-interleaved and bias-free."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        gated = is_gated(c.activation)
        kw = dict(params_dtype=c.params_dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(
            c.hidden_size, (2 if gated else 1) * c.ffn_size, bias=not gated,
            **kw)
        self.dense_4h_to_h = RowParallelLinear(c.ffn_size, c.hidden_size,
                                               **kw)

    def forward(self, hidden: torch.Tensor, *, lora=None) -> torch.Tensor:
        """``lora``: this layer's per-slot ``dense_h_to_4h`` factors (see
        :func:`_lora_delta`), added before the activation."""
        x = self.dense_h_to_4h(hidden)
        if lora is not None:
            x = x + _lora_delta(hidden, lora).to(x.dtype)
        return self.dense_4h_to_h(apply_activation(x, self.config.activation))


class ParallelAttention(nn.Module):
    """Self-attention with the fused, grouped QKV projection
    ``[g0: qpg*dh q | dh k | dh v | g1: ...]``, or cross-attention with a
    ``query`` (h -> h) and a ``key_value`` (h -> 2h, each head's k before its
    v) projection over the encoder output; then the output projection."""

    def __init__(self, config: TransformerConfig, *,
                 attn_type: AttnType = AttnType.self_attn, device=None):
        super().__init__()
        c = config
        self.config = c
        self.attn_type = attn_type
        kw = dict(params_dtype=c.params_dtype, device=device)
        if attn_type == AttnType.self_attn:
            qpg = c.num_attention_heads // c.kv_heads
            self.query_key_value = ColumnParallelLinear(
                c.hidden_size, c.kv_heads * (qpg + 2) * c.head_dim, **kw)
        else:
            self.query = ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                              **kw)
            self.key_value = ColumnParallelLinear(c.hidden_size,
                                                  2 * c.hidden_size, **kw)
        self.dense = RowParallelLinear(c.hidden_size, c.hidden_size, **kw)
        self.scale_mask_softmax = FusedScaleMaskSoftmax(
            attn_mask_type=(AttnMaskType.padding
                            if attn_type == AttnType.cross_attn
                            else c.attn_mask_type),
            scaled_masked_softmax_fusion=True, softmax_in_fp32=True)

    def _core_attention(self, q, k, v, attention_mask, kv_lengths, window,
                        rng=None, deterministic=True):
        """``q [b, heads, sq, dh]``, ``k``/``v [b, kv_heads, sk, dh]`` ->
        context ``[b, heads, sq, dh]``: flash with no mask and no active
        dropout, else the unfused scores through the fused masked softmax
        and dropout on the probabilities (``rng``)."""
        c = self.config
        causal = (self.attn_type == AttnType.self_attn
                  and c.attn_mask_type == AttnMaskType.causal)
        if attention_mask is None and (deterministic
                                       or c.attention_dropout == 0.0):
            return flash_attention(q, k, v, causal=causal,
                                   kv_lengths=kv_lengths,
                                   sliding_window=window)
        b, heads, sq, dh = q.shape
        kvh, sk = k.shape[1], k.shape[2]

        def masked(extra):
            return extra if attention_mask is None else attention_mask | extra

        if kv_lengths is not None:
            # varlen lengths folded into the mask (True = masked out)
            col = torch.arange(sk, device=q.device)[None, None, None, :]
            attention_mask = masked(
                col >= kv_lengths.to(q.device)[:, None, None, None])
        if window is not None and causal:
            row = torch.arange(sq, device=q.device)[None, None, :, None]
            col = torch.arange(sk, device=q.device)[None, None, None, :]
            attention_mask = masked(col <= row + (sk - sq) - window)
        # sqrt(head_dim) in fp32, rounded to the compute dtype
        inv_scale = float(torch.tensor(float(c.head_dim)).sqrt().to(q.dtype))
        if kvh != heads:
            # grouped product: q heads fold into [kv_heads, group], so K/V
            # are read once per group with no broadcast copy
            g = heads // kvh
            qg = q.reshape(b, kvh, g, sq, dh)
            scores = torch.matmul(qg, k.unsqueeze(2).transpose(-1, -2)) \
                / inv_scale
            probs = self.scale_mask_softmax(
                scores.reshape(b, heads, sq, sk), attention_mask)
            probs = _dropout(probs, c.attention_dropout, rng, deterministic)
            ctx = torch.matmul(probs.reshape(b, kvh, g, sq, sk).to(v.dtype),
                               v.unsqueeze(2))
            return ctx.reshape(b, heads, sq, dh)
        scores = torch.matmul(q, k.transpose(-1, -2)) / inv_scale
        probs = self.scale_mask_softmax(scores, attention_mask)
        probs = _dropout(probs, c.attention_dropout, rng, deterministic)
        return torch.matmul(probs.to(v.dtype), v)

    def _offset_causal(self, sk: int, s: int, cache_index, device):
        """``[b|1, 1, s, sk]`` True where query ``i`` of a slice written at
        ``cache_index`` (an int, or a ``[b]`` tensor of per-row offsets)
        may not see cache slot ``j``: ``j > cache_index + i``, or outside
        the sliding window."""
        slots = torch.arange(sk, device=device)[None, None, None, :]
        if isinstance(cache_index, torch.Tensor):
            ci = cache_index.to(device=device, dtype=torch.long).reshape(
                -1, 1, 1, 1)
        else:
            ci = cache_index
        allowed = ci + torch.arange(s, device=device)[None, None, :, None]
        invalid = slots > allowed
        if self.config.sliding_window is not None:
            invalid = invalid | (slots <= allowed - self.config.sliding_window)
        return invalid

    def _flat_cache_attention(self, q, k, v, ck, cv, cache_index,
                              attention_mask, kv_lengths, rng=None,
                              deterministic=True):
        """Cached attention over a FLAT ``[b, S, kv_heads * head_dim]``
        cache pair (the JAX package's ``_flat_cache_attention``), written
        in place. ``q``/``k``/``v`` arrive as ``[b, heads, s, head_dim]``;
        ``cache_index`` is an int or a ``[b]`` vector of per-row offsets
        (continuous batching: each row an independent request at its own
        position). Each row's ``s`` new K/V rows land at its offset
        (clamped into the cache, as ``dynamic_update_slice`` does); query
        ``i`` sees slots ``<= cache_index + i``, within the window and below
        ``kv_lengths``. One token: the scores as one GEMM in q's dtype,
        masked with ``-1e30`` and softmaxed in fp32, the probabilities
        rounded to q's dtype for the context GEMM — where JAX rounds. More
        tokens: the grouped product and the masked softmax."""
        c = self.config
        dh = c.head_dim
        b, hl, s, _ = q.shape
        kvh = k.shape[1]
        S = ck.shape[1]
        kf = k.transpose(1, 2).reshape(b, s, kvh * dh)
        vf = v.transpose(1, 2).reshape(b, s, kvh * dh)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim():
            start = cache_index.to(device=ck.device, dtype=torch.long) \
                .clamp(0, S - s)
            rows = start[:, None] + torch.arange(s, device=ck.device)
            bi = torch.arange(b, device=ck.device)[:, None]
            ck[bi, rows] = kf.to(ck.dtype)
            cv[bi, rows] = vf.to(cv.dtype)
        else:
            start = min(max(int(cache_index), 0), S - s)
            ck[:, start:start + s] = kf.to(ck.dtype)
            cv[:, start:start + s] = vf.to(cv.dtype)
        invalid = self._offset_causal(S, s, cache_index, q.device)
        if kv_lengths is not None:
            slots = torch.arange(S, device=q.device)
            invalid = invalid | (slots >= kv_lengths.to(q.device).reshape(
                -1, 1, 1, 1))
        if attention_mask is not None:
            invalid = invalid | attention_mask
        # sqrt(head_dim) in fp32, rounded to the compute dtype
        inv_scale = float(torch.tensor(float(dh)).sqrt().to(q.dtype))
        g = hl // kvh
        k4 = ck.reshape(b, S, kvh, dh).transpose(1, 2).to(q.dtype)
        v4 = cv.reshape(b, S, kvh, dh).transpose(1, 2).to(q.dtype)
        if s == 1:
            scores = torch.matmul(q.reshape(b, kvh, g, dh),
                                  k4.transpose(-1, -2)) / inv_scale
            # the mask of head 0, as JAX reads it
            sf = torch.where(invalid[:, 0, 0][:, None, None, :],
                             torch.tensor(-1e30, device=q.device),
                             scores.float())           # [b, kvh, g, S]
            sf = sf - sf.amax(dim=-1, keepdim=True)
            e = torch.exp(sf)
            probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
            probs = _dropout(probs, c.attention_dropout, rng, deterministic)
            ctx = torch.matmul(probs, v4)              # [b, kvh, g, dh]
            return self.dense(ctx.reshape(1, b, hl * dh)), (ck, cv)
        ctx = self._core_attention(q, k4, v4, invalid, None, None, rng,
                                   deterministic)
        out = self.dense(ctx.permute(2, 0, 1, 3).reshape(s, b, hl * dh))
        return out, (ck, cv)

    def forward(self, hidden: torch.Tensor, *,
                encoder_output: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_lengths: Optional[torch.Tensor] = None,
                kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index=None,
                paged_state: Optional[torch.Tensor] = None,
                rng: Optional[torch.Tensor] = None,
                deterministic: bool = True, dropout_seed=None, lora=None):
        """``hidden [s, b, h] -> [s, b, h]``, or ``(out, cache)`` with a
        ``kv_cache`` (updated in place and returned). Cross-attention reads
        K/V from ``encoder_output [s_enc, b, h]``. ``attention_mask`` is a
        bool broadcastable to ``[b, heads, sq, sk]``, True = masked out;
        ``kv_lengths [b]`` bounds the keys of each batch row. Attention
        dropout (``deterministic=False``): the packed path's hash seed is
        ``dropout_seed`` (the stack's per-layer seed) or a ``randint``
        drawn from ``rng``; the other paths drop the probabilities with
        masks from ``rng``. ``lora`` (self-attention): this layer's
        per-slot ``query_key_value`` factors, whose delta is added to the
        fused projection before any split, on every path."""
        c = self.config
        dh = c.head_dim
        if self.attn_type == AttnType.self_attn:
            qpg = c.num_attention_heads // c.kv_heads
            qkv = self.query_key_value(hidden)
            if lora is not None:
                qkv = qkv + _lora_delta(hidden, lora).to(qkv.dtype)
            s, b = qkv.shape[0], qkv.shape[1]
            causal = c.attn_mask_type == AttnMaskType.causal
            drop_active = not deterministic and c.attention_dropout > 0.0
            if (kv_cache is None and cache_index is None
                    and paged_state is None and attention_mask is None
                    and (not drop_active or rng is not None)
                    and packed_attention_supported(s, c.kv_heads, qpg, dh)):
                # layout-native: the fused projection goes straight to the
                # kernel and the context comes back in [s, b, h*dh]
                freqs = None
                if c.position_embedding_type == "rope":
                    freqs = rope_freqs(0, s, c.rotary_dim, c.rope_theta,
                                       device=hidden.device)
                seed = None
                if drop_active:
                    seed = (dropout_seed if dropout_seed is not None
                            else prng.randint(model_parallel_rng_key(rng),
                                              (1,), -2 ** 31, 2 ** 31 - 1))
                ctx = flash_attention_packed(
                    qkv, queries_per_group=qpg, head_dim=dh, causal=causal,
                    kv_lengths=kv_lengths, sliding_window=c.sliding_window,
                    rope_freqs=freqs,
                    dropout_rate=c.attention_dropout if drop_active else 0.0,
                    dropout_seed=seed)
                return self.dense(ctx)
            qkv = qkv.reshape(s, b, c.kv_heads, qpg + 2, dh)
            q = qkv[:, :, :, :qpg].reshape(s, b, c.num_attention_heads, dh)
            k = qkv[:, :, :, qpg]
            v = qkv[:, :, :, qpg + 1]
            if c.position_embedding_type == "rope":
                start = 0 if cache_index is None else cache_index
                freqs = rope_freqs(start, s, c.rotary_dim, c.rope_theta,
                                   device=hidden.device)
                q = fused_rope(q, freqs)
                k = fused_rope(k, freqs)
        else:
            if encoder_output is None:
                raise ValueError("cross-attention needs encoder_output")
            if kv_cache is not None or paged_state is not None:
                raise NotImplementedError(
                    "kv_cache is for self-attention decode; cross-attention "
                    "K/V are static — precompute them once instead")
            q = self.query(hidden)
            kv = self.key_value(encoder_output)
            s, b = q.shape[0], q.shape[1]
            heads = q.shape[-1] // dh
            q = q.reshape(s, b, heads, dh)
            k, v = kv.reshape(kv.shape[0], b, heads, 2 * dh).split(dh, dim=-1)
        if paged_state is not None:
            # paged decode: append each slot's K/V rows at its position and
            # attend over its mapped pages (one kernel). ``s > 1`` is a
            # speculative verify window: window row t lands at
            # cache_index + t and attends up to it. An int8 pool comes as
            # ``(pages, scales)`` pairs, carried through.
            if kv_cache is None:
                raise ValueError("paged decode takes the page-pool kv_cache "
                                 "pair")
            if attention_mask is not None or kv_lengths is not None:
                raise NotImplementedError(
                    "paged decode derives validity from cache_index; "
                    "attention_mask/kv_lengths are not supported")
            ck, cv = kv_cache
            k_scales = v_scales = None
            if isinstance(ck, (tuple, list)):
                (ck, k_scales), (cv, v_scales) = ck, cv
            res = fused_paged_decode_attention(
                q.transpose(0, 1), k.transpose(0, 1).reshape(b, s, -1),
                v.transpose(0, 1).reshape(b, s, -1), ck, cv, paged_state,
                cache_index, queries_per_group=qpg,
                sliding_window=c.sliding_window, k_scales=k_scales,
                v_scales=v_scales)
            new = ((ck, k_scales), (cv, v_scales)) if k_scales is not None \
                else (ck, cv)
            # ctx [b, s, heads * dh] -> [s, b, heads * dh]
            return self.dense(res[0].transpose(0, 1)), new
        # [s, b, heads, dh] -> [b, heads, s, dh]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        if kv_cache is not None:
            ck, cv = kv_cache
            if ck.dim() == 3:
                return self._flat_cache_attention(
                    q, k, v, ck, cv, cache_index, attention_mask, kv_lengths,
                    rng, deterministic)
            if isinstance(cache_index, torch.Tensor) and cache_index.dim():
                raise NotImplementedError(
                    "per-row cache_index (continuous-batching decode) needs "
                    "the FLAT cache form (init_kv_caches(flat=True)) or "
                    "paged_state")
            # K/V written in place at the cache offset (clamped into the
            # cache, as dynamic_update_slice does)
            start = min(max(int(cache_index), 0), ck.shape[2] - s)
            ck[:, :, start:start + s] = k.to(ck.dtype)
            cv[:, :, start:start + s] = v.to(cv.dtype)
            if (isinstance(cache_index, int) and cache_index == 0
                    and attention_mask is None and kv_lengths is None
                    and (deterministic or c.attention_dropout == 0.0)):
                # prefill: queries fill [0, s), so causal flash over the
                # filled prefix
                ctx = flash_attention(q, ck[:, :, :s].to(q.dtype),
                                      cv[:, :, :s].to(q.dtype), causal=True,
                                      sliding_window=c.sliding_window)
            else:
                # any other offset (a suffix prefill, a prefill chunk; a
                # tensor offset even at 0): query i sees slots <=
                # cache_index + i, encoded as an explicit mask over the
                # whole cache (the causal kernels assume the queries sit at
                # the cache's end), so the unfused softmax runs, as in the
                # JAX package
                invalid = self._offset_causal(ck.shape[2], s,
                                              int(cache_index), q.device)
                if attention_mask is not None:
                    invalid = invalid | attention_mask
                ctx = self._core_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                           invalid, kv_lengths, None, rng,
                                           deterministic)
        else:
            window = (c.sliding_window if self.attn_type == AttnType.self_attn
                      else None)
            ctx = self._core_attention(q, k, v, attention_mask, kv_lengths,
                                       window, rng, deterministic)
        out = self.dense(ctx.permute(2, 0, 1, 3).reshape(s, b, -1))
        return out if kv_cache is None else (out, (ck, cv))


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: ln -> self-attention -> add -> [decoder: ln ->
    cross-attention over the encoder output -> add] -> ln -> mlp -> add."""

    def __init__(self, config: TransformerConfig, *,
                 layer_type: LayerType = LayerType.encoder, device=None):
        super().__init__()
        self.config = config
        self.layer_type = layer_type
        self.input_layernorm = _norm(config, device)
        self.self_attention = ParallelAttention(config, device=device)
        self.post_attention_layernorm = _norm(config, device)
        self.mlp = ParallelMLP(config, device)
        if layer_type == LayerType.decoder:
            self.inter_attention = ParallelAttention(
                config, attn_type=AttnType.cross_attn, device=device)
            self.post_inter_attention_layernorm = _norm(config, device)

    def forward(self, hidden: torch.Tensor, *, encoder_output=None,
                enc_dec_attn_mask=None, enc_kv_lengths=None,
                attention_mask=None, kv_lengths=None, kv_cache=None,
                cache_index=None, paged_state=None, rng=None,
                deterministic: bool = True, attention_seed=None, lora=None):
        """``encoder_output`` (decoder layers) is the full encoder sequence
        ``[s_enc, b, h]``; ``enc_kv_lengths`` keeps padded cross-attention
        on flash, ``enc_dec_attn_mask`` sends it through the masked
        softmax. Dropout keys: ``rng`` split in 3 (4 in a decoder layer) as
        the JAX layer splits it: 0 after the attention, 1 after the MLP, 2
        inside the self-attention, 3 folded with 0 and 1 for the
        cross-attention and the dropout after it; ``attention_seed`` is the
        packed path's hash seed. ``lora``: this layer's per-slot factors
        ``{target: {"A", "B"}}`` (:mod:`apex_tpu_torch.lora`)."""
        c = self.config
        decoder = self.layer_type == LayerType.decoder
        n_keys = 4 if decoder else 3
        rngs = ((None,) * n_keys if rng is None
                else tuple(prng.split(rng, n_keys)))
        # out_dtype=x.dtype: the consumers run in the compute dtype
        x = self.input_layernorm(hidden, out_dtype=hidden.dtype)
        attn = self.self_attention(
            x.to(c.compute_dtype), attention_mask=attention_mask,
            kv_lengths=kv_lengths, kv_cache=kv_cache,
            cache_index=cache_index, paged_state=paged_state, rng=rngs[2],
            deterministic=deterministic, dropout_seed=attention_seed,
            lora=None if lora is None else lora.get("query_key_value"))
        new_cache = None
        if kv_cache is not None:
            attn, new_cache = attn
        hidden = hidden + _dropout(attn, c.hidden_dropout, rngs[0],
                                   deterministic)
        norm = self.post_attention_layernorm
        if decoder:
            r_attn = r_drop = None
            if rngs[3] is not None:
                r_attn, r_drop = (prng.fold_in(rngs[3], i) for i in (0, 1))
            x = self.post_attention_layernorm(hidden, out_dtype=hidden.dtype)
            inter = self.inter_attention(
                x.to(c.compute_dtype), encoder_output=encoder_output,
                attention_mask=enc_dec_attn_mask, kv_lengths=enc_kv_lengths,
                rng=r_attn, deterministic=deterministic)
            hidden = hidden + _dropout(inter, c.hidden_dropout, r_drop,
                                       deterministic)
            norm = self.post_inter_attention_layernorm
        x = norm(hidden, out_dtype=hidden.dtype)
        mlp_out = _dropout(
            self.mlp(x.to(c.compute_dtype),
                     lora=None if lora is None else lora.get("dense_h_to_4h")),
            c.hidden_dropout, rngs[1], deterministic)
        out = hidden + mlp_out
        return out if kv_cache is None else (out, new_cache)


_GOLDEN = -1640531527  # 0x9E3779B9 as an int32: odd, so injective mod 2**32


def _layer_seed(base: Optional[torch.Tensor], idx: int):
    """Layer ``idx``'s packed-attention seed: ``base + idx * 0x9E3779B9``
    with int32 wrap-around (structurally distinct masks across layers)."""
    if base is None:
        return None
    v = (base.long() + idx * _GOLDEN) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


#: the non-batched matmuls whose outputs ``recompute='selective'`` saves
#: (JAX's ``dots_with_no_batch_dims_saveable``): the projections and the
#: MLP; attention's batched products and every kernel are recomputed
_SAVED_MATMULS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _selective_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _recompute(layer, hidden, kw, mode):
    """``layer(hidden, **kw)`` with its activations recomputed in the
    backward: the whole layer (``True``/``'full'``) or all but the saved
    matmul outputs (``'selective'``). Every dropout key is explicit, so the
    recompute draws the forward's masks."""
    if mode == "selective":
        return checkpoint(layer, hidden, context_fn=lambda:
                          create_selective_checkpoint_contexts(
                              _selective_policy), **kw)
    return checkpoint(layer, hidden, **kw)


class ParallelTransformer(nn.Module):
    """The layer stack plus the final norm. Layers are a
    :class:`~torch.nn.ModuleList`, so the JAX package's stacked ``[L, ...]``
    parameters map onto per-layer modules."""

    def __init__(self, config: TransformerConfig, *,
                 layer_type: LayerType = LayerType.encoder, device=None):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(config, layer_type=layer_type,
                                     device=device)
            for _ in range(config.num_layers))
        self.final_layernorm = _norm(config, device)

    def forward(self, hidden: torch.Tensor, *, encoder_output=None,
                enc_dec_attn_mask=None, enc_kv_lengths=None,
                attention_mask=None, kv_lengths=None,
                kv_caches: Optional[List] = None, cache_index=None,
                paged_state=None, final_norm: bool = True,
                rng: Optional[torch.Tensor] = None,
                deterministic: bool = True, lora=None):
        """``hidden``, or ``(hidden, new_caches)`` with ``kv_caches`` — a
        LIST of per-layer ``(k, v)`` pairs (4D caches or page pools),
        updated in place. The masks, lengths and encoder output reach every
        layer. Layer ``idx`` draws its dropout from ``fold_in(rng, idx)``
        and its packed-attention seed from one base draw (``randint`` of
        ``fold_in(rng, num_layers)``) plus ``idx * 0x9E3779B9``, as the JAX
        stack does; without caches, a truthy ``recompute`` recomputes each
        layer in the backward (``'selective'``: all but the saved
        non-batched matmul outputs). ``lora`` (serving): per-slot adapter
        factors ``{target: {"A": [L, b, in, r], "B": [L, b, r, out]}}``,
        gathered by the engine from the bank; layer ``idx`` reads the
        ``[idx]`` views. They need the per-layer cache list, as in JAX: a
        cache-free or training forward merges adapters into the weights
        (:func:`apex_tpu_torch.lora.merge_adapter`) instead."""
        c = self.config
        if lora is not None and kv_caches is None:
            raise NotImplementedError(
                "lora (per-slot adapter factors) needs the per-layer LIST "
                "kv_caches form — merge adapters into the weights for "
                "cache-free forwards")
        if lora is not None and getattr(c, "sequence_parallel", False):
            raise NotImplementedError(
                "lora deltas read the layer input pre-gather; sequence "
                "parallelism is not supported on the adapter path")
        seed_base = None
        if rng is not None and not deterministic and c.attention_dropout > 0:
            seed_base = prng.randint(model_parallel_rng_key(
                prng.fold_in(rng, c.num_layers)), (1,), -2 ** 31,
                2 ** 31 - 1)
        if kv_caches is not None and (
                not isinstance(kv_caches, list)
                or len(kv_caches) != len(self.layers)):
            raise ValueError(
                f"kv_caches must be a list of {len(self.layers)} per-layer "
                f"(k, v) pairs")
        new_caches = []
        for idx, layer in enumerate(self.layers):
            kw = dict(encoder_output=encoder_output,
                      enc_dec_attn_mask=enc_dec_attn_mask,
                      enc_kv_lengths=enc_kv_lengths,
                      attention_mask=attention_mask, kv_lengths=kv_lengths,
                      cache_index=cache_index, paged_state=paged_state,
                      rng=None if rng is None else prng.fold_in(rng, idx),
                      deterministic=deterministic,
                      attention_seed=_layer_seed(seed_base, idx))
            if kv_caches is not None:
                layer_lora = (None if lora is None else
                              {t: {k: v[idx] for k, v in f.items()}
                               for t, f in lora.items()})
                hidden, cache = layer(hidden, kv_cache=kv_caches[idx],
                                      lora=layer_lora, **kw)
                new_caches.append(cache)
            elif c.recompute and torch.is_grad_enabled():
                hidden = _recompute(layer, hidden, kw, c.recompute)
            else:
                hidden = layer(hidden, **kw)
        if final_norm:
            hidden = self.final_layernorm(hidden, out_dtype=hidden.dtype)
        return hidden if kv_caches is None else (hidden, new_caches)
