"""Fused decode-step attention over a PAGED KV cache.

Counterpart of ``apex_tpu/ops/decode_attention.py`` for bf16/f32 pools and
a one-row query window (int8 pools and ``w > 1`` verify windows come with
later slices and raise ``NotImplementedError``).

Layouts, as in the JAX package: pool ``[n_pages, page_size, kv_heads *
head_dim]`` per layer (heads minor); page table ``[b, pages_per_slot]``
int32 whose unmapped entries hold the sentinel ``n_pages``.

The step's K/V rows are appended first, as a torch op (in place — the
JAX package's donation has no counterpart here), then the attention runs:
on a CUDA tensor the hand-written kernel in ``csrc/paged_decode.cu``, on a
CPU tensor :func:`decode_plain`, which mirrors the JAX ``_reference``.
:func:`paged_decode_plan` picks the kernel's path and grid on the host
from the shapes alone (never the positions, which stay on the card): the
vector path, whose blocks each take a run of a slot's pages as 16-byte
pieces and merge in the same launch, for bf16/f32 rows of such pieces at
aligned addresses; the element path for the rest.

Dropped rows. JAX scatters with ``mode="drop"``: rows whose destination
is a sentinel page (or past the table) vanish. Torch has no dropping
scatter, and masking rows out on the device would cost a host sync per
layer. So the pools :func:`~apex_tpu_torch.models.generation.\
init_paged_kv_caches` makes carry one spare page past ``n_pages`` in their
storage, and :func:`append_rows` sends every dropped row there. Nothing
reads that page: reads clamp sentinels to ``n_pages - 1`` and mask them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["fused_paged_decode_attention", "paged_pages_for", "append_rows",
           "decode_plain", "paged_decode_cuda", "page_pool",
           "spare_page_view", "DecodePlan", "paged_decode_plan",
           "paged_decode_cuda_plan"]

#: masked-score floor, shared with the flat decode formulation
_NEG = -1e30
#: query heads one block of the vector path holds in registers (its cap)
_MAX_HEADS = 8
#: head_dim the vector path takes at most (one 16-byte piece a lane at 256
#: bf16, two at 256 f32)
_MAX_HEAD_DIM = 256
#: pages a split may hold (``kMaxSplitPages`` in csrc/paged_decode.cu)
_MAX_SPLIT_PAGES = 64
#: elements of a 16-byte piece, for the dtypes the vector path takes
_PIECE_ELEMS = {torch.bfloat16: 8, torch.float32: 4}


def paged_pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache rows."""
    return _support.cdiv(tokens, page_size)


def page_pool(n_pages: int, page_size: int, features: int,
              dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed pool ``[n_pages, page_size, features]`` whose storage
    holds the spare page past ``n_pages`` that dropped rows land in."""
    return torch.zeros((n_pages + 1, page_size, features), dtype=dtype,
                       device=device)[:n_pages]


def spare_page_view(pages: torch.Tensor) -> torch.Tensor:
    """``pages`` ``[n_pages, ps, f]`` widened to ``[n_pages + 1, ps, f]``
    over the same storage: row ``n_pages`` is the spare page dropped rows
    land in. Raises when the storage has no spare page."""
    n, ps, f = pages.shape
    if not pages.is_contiguous():
        raise ValueError("page pools must be contiguous")
    need = (pages.storage_offset() + (n + 1) * ps * f) * pages.element_size()
    if pages.untyped_storage().nbytes() < need:
        raise ValueError(
            "page pool has no spare page past n_pages in its storage; build "
            "pools with apex_tpu_torch.models.generation.init_paged_kv_caches")
    return pages.as_strided((n + 1, ps, f), pages.stride(),
                            pages.storage_offset())


def append_rows(pages, rows, page_table, positions, page_size: int) -> None:
    """Write each slot's new row ``rows [b, f]`` at cache position
    ``positions[r]``, in place. A row whose page is unmapped (sentinel) or
    past the table is dropped: it lands in the spare page (see the module
    docstring). Sync-free: no value is read back to the host."""
    n_pages = pages.shape[0]
    pps = page_table.shape[1]
    page_idx = positions.long() // page_size                    # [b]
    dest = torch.gather(page_table.long(), 1,
                        page_idx.clamp(0, pps - 1)[:, None])[:, 0]
    in_table = page_idx < pps
    dest = torch.where(in_table & (dest >= 0) & (dest < n_pages), dest,
                       torch.full_like(dest, n_pages))
    dest_row = positions.long() % page_size
    spare_page_view(pages).index_put_((dest, dest_row),
                                      rows.to(pages.dtype))


def decode_plain(q, k_pages, v_pages, page_table, positions, group: int,
                 sliding_window: Optional[int]):
    """Plain PyTorch attention of the JAX ``_reference`` (``w == 1``),
    over pools that already hold the step's rows: the gathered logical
    view ``pool[page_table]``, scores through the block-masked query GEMM
    in ``q.dtype``, fp32 softmax, context through the second GEMM and the
    head selector. Returns ``ctx [b, heads * head_dim]``."""
    n_pages, page_size, f = k_pages.shape
    b, hl, dh = q.shape
    kvh = f // dh
    pt = page_table.long().clamp(max=n_pages - 1)
    ck = k_pages[pt].reshape(b, -1, f)
    cv = v_pages[pt].reshape(b, -1, f)
    S = ck.shape[1]
    slots = torch.arange(S, device=q.device)[None, :, None]
    lim = positions.long().to(q.device)[:, None, None]
    invalid = slots > lim                                       # [b, S, 1]
    if sliding_window is not None:
        invalid = invalid | (slots <= lim - sliding_window)
    inv_scale = torch.sqrt(torch.tensor(float(dh))).to(q.dtype)
    q_tiled = q.transpose(1, 2).repeat(1, kvh, 1)               # [b, f, hl]
    frow = torch.arange(kvh * dh, device=q.device)[:, None]
    jcol = torch.arange(hl, device=q.device)[None, :]
    blockmask = (frow // dh == jcol // group).to(q.dtype)
    qblock = q_tiled * blockmask
    scores = torch.einsum("bsf,bfh->bsh", ck.to(q.dtype), qblock) / inv_scale
    sf = torch.where(invalid, torch.tensor(_NEG, device=q.device),
                     scores.float())
    sf = sf - sf.amax(dim=1, keepdim=True)
    e = torch.exp(sf)
    probs = (e / e.sum(dim=1, keepdim=True)).to(q.dtype)
    ctx_big = torch.einsum("bsh,bsf->bhf", probs, cv.to(q.dtype))
    sel = (torch.arange(kvh, device=q.device)[None, :]
           == (torch.arange(hl, device=q.device) // group)[:, None]
           ).to(q.dtype)
    ctx = torch.einsum("bjkd,jk->bjd", ctx_big.reshape(b, hl, kvh, dh), sel)
    return ctx.reshape(b, hl * dh)


class DecodePlan(NamedTuple):
    """How one call of Kernel C runs (csrc/paged_decode.cu)."""
    #: 16-byte pieces a lane holds of a K/V row; 0 is the element path
    pieces: int
    #: lanes a row (0 on the element path)
    lanes: int
    #: query heads a block serves, at most ``_MAX_HEADS`` (the whole group
    #: on the element path)
    heads: int
    #: logical pages a split holds
    split_pages: int
    #: splits of a slot's pages
    splits: int
    #: (kv heads x head chunks, slots, splits)
    grid: tuple

    @property
    def path(self) -> str:
        return "vector" if self.pieces else "element"


def paged_decode_plan(b: int, hl: int, kvh: int, dh: int, page_size: int,
                      pages_per_slot: int, dtype: torch.dtype,
                      aligned: bool,
                      blocks_per_sm: Callable[[int, int], int],
                      n_sms: int,
                      sliding_window: Optional[int] = None) -> DecodePlan:
    """Kernel C's path and grid for ``q [b, hl, dh]`` over pools of
    ``kvh`` heads, from the shapes alone: it never reads the positions.

    The vector path takes bf16/f32 with ``dh`` a multiple of one 16-byte
    piece (8 bf16, 4 f32) up to 256 with q, the pools and ctx at 16-byte
    aligned addresses (``aligned``); the rest takes the element path. A row's
    ``dh / piece`` pieces spread over the power of two of lanes that
    covers them (at most 32, two pieces a lane at 256 f32). A block holds
    at most ``_MAX_HEADS`` query heads; a larger group is cut into equal
    chunks. The grid is one wave of the card's resident blocks
    (``blocks_per_sm(pieces, heads)`` an SM, ``n_sms`` SMs) over
    (kv head, chunk, slot) triples, counted as if every slot were full:
    the pages a slot may read (``pages_per_slot``, or the pages a window
    of ``sliding_window`` rows spans) are cut into that many splits, of at
    most ``_MAX_SPLIT_PAGES`` pages each, and the splits cover the whole
    table."""
    group = hl // kvh
    elems = _PIECE_ELEMS.get(dtype, 0)
    if not elems or dh % elems or not 0 < dh <= _MAX_HEAD_DIM or \
            not aligned:
        return DecodePlan(0, 0, group, pages_per_slot, 1, (kvh, b, 1))
    n = dh // elems
    lanes = 1 << (min(n, 32) - 1).bit_length()
    pieces = _support.cdiv(n, 32)
    chunks = _support.cdiv(group, _MAX_HEADS)
    heads = _support.cdiv(group, chunks)
    reach = pages_per_slot
    if sliding_window:
        reach = min(reach, _support.cdiv(sliding_window - 1, page_size) + 1)
    triples = b * kvh * chunks
    wave = n_sms * blocks_per_sm(pieces, heads)
    splits = max(1, min(reach, wave // triples))
    split_pages = min(_support.cdiv(reach, splits), _MAX_SPLIT_PAGES)
    splits = _support.cdiv(pages_per_slot, split_pages)
    return DecodePlan(pieces, lanes, heads, split_pages, splits,
                      (kvh * chunks, b, splits))


def paged_decode_cuda_plan(q, k_pages, v_pages, page_table, group: int,
                           sliding_window: Optional[int] = None,
                           ctx=None) -> DecodePlan:
    """The plan :func:`paged_decode_cuda` takes for these tensors on their
    card (its occupancy and SM count); ``ctx`` is the output, when it is
    already allocated."""
    b, hl, dh = q.shape
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (q, k_pages, v_pages, ctx) if t is not None)
    return _card_plan(b, hl, hl // group, dh, k_pages.shape[1],
                      page_table.shape[1], q.dtype, aligned, sliding_window,
                      q.device.index)


@functools.lru_cache(maxsize=256)
def _card_plan(b: int, hl: int, kvh: int, dh: int, page_size: int,
               pages_per_slot: int, dtype: torch.dtype, aligned: bool,
               sliding_window: Optional[int], dev: int) -> DecodePlan:
    """:func:`paged_decode_plan` on CUDA device ``dev``, made once per
    configuration: the plan is a function of these arguments alone."""
    code = _support.dtype_code(dtype)
    return paged_decode_plan(
        b, hl, kvh, dh, page_size, pages_per_slot, dtype, aligned,
        lambda pieces, heads: _support.blocks_per_sm(
            dev, "apex_paged_decode_blocks_per_sm", code, pieces, heads, dh),
        _support.sm_count(dev), sliding_window)


#: per (card, stream, dtype), the vector path's buffers, the newest last.
#: An outgrown buffer is kept, since a captured CUDA graph may still point
#: at it; each new one is at least twice the last, so there are few.
_BUFFERS: Dict[Tuple[int, int, torch.dtype], List[torch.Tensor]] = {}


def _stream_buffer(device: torch.device, stream: int, dtype: torch.dtype,
                   n: int) -> torch.Tensor:
    """At least ``n`` elements of ``dtype`` for calls on CUDA stream
    ``stream`` of ``device``, zeroed when made: the split counters (int32,
    which every launch leaves at 0) and the splits' fp32 partials. Calls
    on one stream run in order and share them; each stream has its own,
    so calls running at once on two streams never share a cell."""
    bufs = _BUFFERS.setdefault((device.index, stream, dtype), [])
    if not bufs or bufs[-1].numel() < n:
        size = max(n, 1024, 2 * bufs[-1].numel() if bufs else 0)
        bufs.append(torch.zeros(size, dtype=dtype, device=device))
    return bufs[-1]


def paged_decode_cuda(q, k_pages, v_pages, page_table, positions, group: int,
                      sliding_window: Optional[int]):
    """Launch Kernel C; returns ``ctx [b, heads * head_dim]``. No host
    sync and no allocation outside torch's caching allocator, so the call
    can be captured in a CUDA graph."""
    n_pages, page_size, f = k_pages.shape
    b, hl, dh = q.shape
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q ({q.dtype}) and pools ({k_pages.dtype}, "
                        f"{v_pages.dtype}) must share a dtype")
    q = q.contiguous()
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    page_table = page_table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    ctx = torch.empty((b, hl * dh), dtype=q.dtype, device=q.device)
    if b == 0:
        return ctx
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = paged_decode_cuda_plan(q, k_pages, v_pages, page_table, group,
                                  sliding_window, ctx)
    ws = counters = None
    if plan.splits > 1:
        ws = _stream_buffer(q.device, stream, torch.float32,
                            b * hl * plan.splits * (dh + 2))
        counters = _stream_buffer(q.device, stream, torch.int32,
                                  plan.grid[0] * b)
    status = lib.apex_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), ctx.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
        b, hl, hl // group, dh, n_pages, page_size, page_table.shape[1],
        int(sliding_window or 0), _support.dtype_code(q.dtype), plan.pieces,
        plan.lanes, plan.heads, plan.split_pages, plan.splits)
    _build.check("apex_paged_decode", status)
    _support.count_launch("paged_decode")
    return ctx


def fused_paged_decode_attention(q, k_new, v_new, k_pages, v_pages,
                                 page_table, positions, *,
                                 queries_per_group: int = 1,
                                 sliding_window=None,
                                 k_scales=None, v_scales=None):
    """One decode step for one layer over the paged KV pool.

    Args:
      q: ``[b, heads, head_dim]`` query vectors, rope already applied
        (``[b, 1, heads, head_dim]`` is accepted; ``w > 1`` is not yet).
      k_new, v_new: ``[b, kv_heads * head_dim]`` — this step's K/V rows.
      k_pages, v_pages: ``[n_pages, page_size, kv_heads * head_dim]``
        bf16/f32 pools from ``init_paged_kv_caches``; updated IN PLACE.
      page_table: ``[b, pages_per_slot]`` int — unmapped entries hold the
        sentinel ``n_pages``.
      positions: ``[b]`` int — each slot's append index; query ``r``
        attends over logical rows ``[0, positions[r]]``.
      queries_per_group: query heads per K/V head.
      sliding_window: optional local-attention window.

    Returns ``(ctx, k_pages, v_pages)`` — ``ctx [b, heads * head_dim]``
    (``[b, 1, heads * head_dim]`` for a rank-4 ``q``), the pools the same
    objects that were passed in.
    """
    if k_scales is not None or v_scales is not None or \
            k_pages.dtype == torch.int8:
        raise NotImplementedError(
            "int8 page pools are not ported yet (later slice)")
    window = q.dim() == 4
    if window:
        if q.shape[1] != 1:
            raise NotImplementedError(
                f"query windows w > 1 (speculative verify) are not ported "
                f"yet; got w = {q.shape[1]}")
        q, k_new, v_new = q[:, 0], k_new[:, 0], v_new[:, 0]
    if q.dim() != 3:
        raise ValueError(f"q must be [b, heads, head_dim] or "
                         f"[b, 1, heads, head_dim], got {tuple(q.shape)}")
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pools must be matching [n_pages, page_size, kv_heads * "
            f"head_dim], got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, hl, dh = q.shape
    if hl % queries_per_group:
        raise ValueError(f"heads ({hl}) not divisible by queries_per_group "
                         f"({queries_per_group})")
    kvh = hl // queries_per_group
    if k_pages.shape[-1] != kvh * dh:
        raise ValueError(f"pool minor dim {k_pages.shape[-1]} != kv_heads * "
                         f"head_dim ({kvh} * {dh})")
    _support.forward_only(
        "fused_paged_decode_attention",
        "decode is inference only, as in apex_tpu: no slice adds a backward",
        q, k_new, v_new)
    cpu = _support.is_cpu(q, k_new, v_new, k_pages, v_pages, page_table,
                          positions)
    page_size = k_pages.shape[1]
    append_rows(k_pages, k_new, page_table, positions, page_size)
    append_rows(v_pages, v_new, page_table, positions, page_size)
    attend = decode_plain if cpu else paged_decode_cuda
    ctx = attend(q, k_pages, v_pages, page_table, positions,
                 queries_per_group, sliding_window)
    if window:
        ctx = ctx[:, None]
    return ctx, k_pages, v_pages
