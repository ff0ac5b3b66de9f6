"""Fused decode-step attention over a PAGED KV cache.

Counterpart of ``apex_tpu/ops/decode_attention.py``: bf16/fp16/f32 pools,
int8 pools with per-(page, kv-head) float32 scales, and ``w``-row query windows
(the verify step of speculative decoding: window row ``t`` of a slot lands
at ``positions[r] + t`` and attends over rows ``[0, positions[r] + t]``).

Layouts, as in the JAX package: pool ``[n_pages, page_size, kv_heads *
head_dim]`` per layer (heads minor); scale sidecar ``[n_pages, kv_heads]``
float32 per int8 pool; page table ``[b, pages_per_slot]`` int32 whose
unmapped entries hold the sentinel ``n_pages``.

The step's K/V rows are appended first, as torch ops (in place — the JAX
package's donation has no counterpart here): a copy into bf16/fp16/f32 pools,
the rescale-on-append quantization (:func:`paged_quant_scatter`) into int8
pools, whose values and scales are bitwise JAX's. Then the attention runs:
on a CUDA tensor the hand-written kernel in ``csrc/paged_decode.cu``, on a
CPU tensor :func:`decode_plain`, which mirrors the JAX ``_reference``.
:func:`paged_decode_plan` picks the kernel's path and grid on the host
from the shapes alone (never the positions, which stay on the card): the
vector path, whose blocks each take a run of a slot's pages as 16-byte
pieces and merge in the same launch, for bf16/fp16/f32 rows of such pieces
at aligned addresses; the element path for the rest.

Dropped rows. JAX scatters with ``mode="drop"``: rows whose destination
is a sentinel page (or past the table) vanish. Torch has no dropping
scatter, and selecting the valid rows on the device would cost a host sync
per layer. So the pools and scale sidecars that
:func:`~apex_tpu_torch.models.generation.init_paged_kv_caches` makes carry
one spare page (one spare scale row) past ``n_pages`` in their storage,
and every scatter here sends its dropped rows there, masked out of the
real pages explicitly. Nothing reads the spare: reads clamp sentinels to
``n_pages - 1`` and mask them.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["fused_paged_decode_attention", "paged_pages_for", "append_rows",
           "paged_quant_scatter", "paged_quant_fill", "decode_plain",
           "paged_decode_cuda", "page_pool", "scale_pool", "spare_page_view",
           "DecodePlan", "paged_decode_plan", "paged_decode_cuda_plan",
           "element_tile", "element_chunks", "paged_decode_smem"]

#: masked-score floor, shared with the flat decode formulation
_NEG = -1e30
#: int8 quantization range: symmetric, -127..127 (as the JAX package)
_QMAX = 127.0
#: query rows (heads x window rows) one block of the vector path holds in
#: registers (its cap at 8 columns a lane; 4 at 16)
_MAX_HEADS = 8
#: head_dim the vector path takes at most (one 16-byte piece a lane at 256
#: bf16 or fp16, two at 512; two at 256 f32, four at 512)
_MAX_HEAD_DIM = 512
#: pages a split may hold (``kMaxSplitPages`` in csrc/paged_decode.cu)
_MAX_SPLIT_PAGES = 64
#: an H100 block's shared memory (``kSmemBytes`` in csrc/paged_decode.cu)
_SMEM_BYTES = 232448
#: elements of a 16-byte piece of q, for the dtypes the vector path takes
_PIECE_ELEMS = {torch.bfloat16: 8, torch.float16: 8, torch.float32: 4}
#: the widest head the element path takes: one query row and one K/V row
#: (``_element_floats(1, dh, 1) = 4 dh + 5`` floats) in a block's shared
#: memory
ELEMENT_MAX_HEAD_DIM = (_SMEM_BYTES // 4 - 5) // 4


def paged_pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache rows."""
    return _support.cdiv(tokens, page_size)


def page_pool(n_pages: int, page_size: int, features: int,
              dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed pool ``[n_pages, page_size, features]`` whose storage
    holds the spare page past ``n_pages`` that dropped rows land in."""
    return torch.zeros((n_pages + 1, page_size, features), dtype=dtype,
                       device=device)[:n_pages]


def scale_pool(n_pages: int, kv_heads: int, device) -> torch.Tensor:
    """A zeroed float32 scale sidecar ``[n_pages, kv_heads]`` for an int8
    pool, whose storage holds the spare row past ``n_pages`` that the
    scales of dropped rows land in."""
    return torch.zeros((n_pages + 1, kv_heads), dtype=torch.float32,
                       device=device)[:n_pages]


def spare_page_view(pages: torch.Tensor) -> torch.Tensor:
    """``pages`` ``[n_pages, ...]`` (a pool or a scale sidecar) widened to
    ``[n_pages + 1, ...]`` over the same storage: row ``n_pages`` is the
    spare that dropped rows land in. Raises when the storage has none."""
    n, rest = pages.shape[0], tuple(pages.shape[1:])
    if not pages.is_contiguous():
        raise ValueError("page pools and scale sidecars must be contiguous")
    row = 1
    for d in rest:
        row *= d
    need = (pages.storage_offset() + (n + 1) * row) * pages.element_size()
    if pages.untyped_storage().nbytes() < need:
        raise ValueError(
            "page pool has no spare page past n_pages in its storage; build "
            "pools with apex_tpu_torch.models.generation.init_paged_kv_caches")
    return pages.as_strided((n + 1,) + rest, pages.stride(),
                            pages.storage_offset())


def _dropped_to_spare(dest: torch.Tensor, n_pages: int) -> torch.Tensor:
    """``dest`` as int64 with every destination outside ``[0, n_pages)``
    (a sentinel, a row past the table) sent to the spare page
    ``n_pages`` — JAX's ``mode="drop"``, masked explicitly."""
    dest = dest.long()
    return torch.where((dest >= 0) & (dest < n_pages), dest,
                       torch.full_like(dest, n_pages))


def _window_dest(page_table, positions, w: int, page_size: int,
                 n_pages: int):
    """Scatter coordinates ``(page, row)`` ``[b, w]`` for a ``w``-row
    append window per slot: row ``t`` of slot ``r`` lands at logical
    position ``positions[r] + t``. Rows whose page is unmapped or past the
    table's span go to the spare page (a plain gather would CLAMP to the
    table's last column and corrupt the slot's own final page)."""
    pps = page_table.shape[1]
    idx = positions.long()[:, None] + torch.arange(
        w, device=positions.device)[None, :]                    # [b, w]
    page_idx = idx // page_size
    dest = torch.gather(page_table.long(), 1, page_idx.clamp(0, pps - 1))
    dest = torch.where(page_idx < pps, dest, torch.full_like(dest, n_pages))
    return _dropped_to_spare(dest, n_pages), idx % page_size


def append_rows(pages, rows, page_table, positions, page_size: int) -> None:
    """Write each slot's new rows ``rows [b, f]`` (or a window ``[b, w,
    f]``) at cache positions ``positions[r] + t``, in place. A row whose
    page is unmapped (sentinel) or past the table is dropped: it lands in
    the spare page (see the module docstring). Sync-free: no value is read
    back to the host."""
    if rows.dim() == 2:
        rows = rows[:, None]
    b, w, f = rows.shape
    dest, dest_row = _window_dest(page_table, positions, w, page_size,
                                  pages.shape[0])
    spare_page_view(pages).index_put_(
        (dest.reshape(-1), dest_row.reshape(-1)),
        rows.reshape(b * w, f).to(pages.dtype))


# -- int8 page quantization ---------------------------------------------------


def paged_quant_scatter(pages, scales, rows, dest_page, dest_row):
    """Rescale-on-append row scatter into an int8 pool, in place; the
    counterpart of the JAX ``paged_quant_scatter``, bitwise.

    ``rows`` ``[n, kv_heads * head_dim]`` land at ``(dest_page[i],
    dest_row[i])``; a ``dest_page`` outside the pool drops the row (to the
    spare page). A page's per-kv-head scale grows monotonically to cover
    the incoming rows' absmax (a scatter-max, ``index_reduce_`` with
    ``"amax"``), the resident int8 rows of touched pages are rescaled by
    ``old / new`` (duplicate destinations write identical values, so the
    scatter stays deterministic), and the new rows quantize at the final
    scale, ``round(x / scale)`` half to even as ``jnp.round``. Returns
    ``(pages, scales)``, the tensors passed in."""
    dest = _dropped_to_spare(dest_page, pages.shape[0]).reshape(-1)
    _quant_scatter(pages, scales, rows, dest, dest_row.long().reshape(-1))
    return pages, scales


def _quant_scatter(pages, scales, rows, dest, dest_row) -> None:
    """:func:`paged_quant_scatter` to int64 destinations already in
    ``[0, n_pages]`` (``n_pages`` the spare page)."""
    n_pages, ps, f = pages.shape
    kvh = scales.shape[1]
    dh = f // kvh
    sp, ss = spare_page_view(pages), spare_page_view(scales)
    rf = rows.float().reshape(-1, kvh, dh)
    want = rf.abs().amax(dim=-1) / _QMAX                        # [n, kvh]
    old = ss[dest]
    with warnings.catch_warnings():     # index_reduce_ is marked beta
        warnings.simplefilter("ignore", UserWarning)
        ss.index_reduce_(0, dest, want, "amax", include_self=True)
    ns = ss[dest]
    safe = torch.where(ns > 0.0, ns, torch.ones_like(ns))
    ratio = old / safe                                          # old/new <= 1
    resident = sp[dest].float() * ratio.repeat_interleave(dh, dim=-1)[:, None]
    sp.index_put_((dest,), torch.round(resident).clamp(-_QMAX, _QMAX)
                  .to(pages.dtype))
    q = torch.round(rf / safe[:, :, None]).clamp(-_QMAX, _QMAX)
    sp.index_put_((dest, dest_row), q.reshape(-1, f).to(pages.dtype))


def paged_quant_fill(pages, scales, chunks, dest_page):
    """Whole-page overwrite into an int8 pool (the prefill path), in
    place: ``chunks [n, page_size, f]`` REPLACE pages ``dest_page``,
    content and scale alike (a freshly mapped page owes nothing to its
    previous occupant). Out-of-pool destinations drop. Returns ``(pages,
    scales)``; bitwise the JAX ``paged_quant_fill``."""
    n, ps, f = chunks.shape
    kvh = scales.shape[1]
    dh = f // kvh
    dest = _dropped_to_spare(dest_page, pages.shape[0]).reshape(-1)
    cf = chunks.float().reshape(n, ps, kvh, dh)
    scale = cf.abs().amax(dim=(1, 3)) / _QMAX                  # [n, kvh]
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round(cf / safe[:, None, :, None]).clamp(-_QMAX, _QMAX)
    spare_page_view(pages).index_put_((dest,),
                                      q.reshape(n, ps, f).to(pages.dtype))
    spare_page_view(scales).index_put_((dest,), scale)
    return pages, scales


def _quant_append(pages, scales, rows, page_table, positions,
                  page_size: int):
    """Windowed rescale-on-append (``rows [b, w, f]``): the int8
    counterpart of :func:`append_rows`."""
    b, w, f = rows.shape
    dest, dest_row = _window_dest(page_table, positions, w, page_size,
                                  pages.shape[0])
    _quant_scatter(pages, scales, rows.reshape(b * w, f), dest.reshape(-1),
                   dest_row.reshape(-1))
    return pages, scales


def _dequant_view(pages_g, scales_g, dh: int, dtype: torch.dtype):
    """Gathered int8 pages ``[b, pps, ps, f]`` and their scales ``[b, pps,
    kvh]`` -> dequantized ``[b, pps, ps, f]`` in ``dtype`` (fp32 product,
    rounded once)."""
    sc = scales_g.repeat_interleave(dh, dim=-1)[:, :, None, :]
    return (pages_g.float() * sc).to(dtype)


def decode_plain(q, k_pages, v_pages, page_table, positions, group: int,
                 sliding_window: Optional[int], k_scales=None,
                 v_scales=None):
    """Plain PyTorch attention of the JAX ``_reference`` over pools that
    already hold the step's rows: the gathered logical view
    ``pool[page_table]`` (int8 pools dequantized through their scales in
    q's dtype), the ``w`` window queries folded into the query-head axis
    with window row ``t`` masked to ``positions + t``, scores through the
    block-masked query GEMM in ``q.dtype``, fp32 softmax, context through
    the second GEMM and the head selector. ``q`` is ``[b, heads,
    head_dim]`` -> ``ctx [b, heads * head_dim]``, or ``[b, w, heads,
    head_dim]`` -> ``[b, w, heads * head_dim]``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    n_pages, page_size, f = k_pages.shape
    b, w, hl, dh = q.shape
    kvh = f // dh
    pt = page_table.long().clamp(max=n_pages - 1)
    if k_scales is not None:
        ck = _dequant_view(k_pages[pt], k_scales[pt], dh, q.dtype)
        cv = _dequant_view(v_pages[pt], v_scales[pt], dh, q.dtype)
        ck, cv = ck.reshape(b, -1, f), cv.reshape(b, -1, f)
    else:
        ck = k_pages[pt].reshape(b, -1, f)
        cv = v_pages[pt].reshape(b, -1, f)
    S = ck.shape[1]
    dev = q.device
    slots = torch.arange(S, device=dev)[None, :, None]
    t = (torch.arange(w * hl, device=dev) // hl)[None, None, :]
    lim = positions.long().to(dev)[:, None, None] + t           # [b, 1, w*hl]
    invalid = slots > lim                                       # [b, S, w*hl]
    if sliding_window is not None:
        invalid = invalid | (slots <= lim - sliding_window)
    inv_scale = torch.sqrt(torch.tensor(float(dh))).to(q.dtype)
    qq = q.reshape(b, w * hl, dh)
    q_tiled = qq.transpose(1, 2).repeat(1, kvh, 1)              # [b, f, w*hl]
    frow = torch.arange(kvh * dh, device=dev)[:, None]
    jcol = torch.arange(w * hl, device=dev)[None, :]
    blockmask = (frow // dh == (jcol % hl) // group).to(q.dtype)
    qblock = q_tiled * blockmask
    scores = torch.einsum("bsf,bfh->bsh", ck.to(q.dtype), qblock) / inv_scale
    sf = torch.where(invalid, torch.tensor(_NEG, device=dev),
                     scores.float())
    sf = sf - sf.amax(dim=1, keepdim=True)
    e = torch.exp(sf)
    probs = (e / e.sum(dim=1, keepdim=True)).to(q.dtype)
    ctx_big = torch.einsum("bsh,bsf->bhf", probs, cv.to(q.dtype))
    sel = (torch.arange(kvh, device=dev)[None, :]
           == (torch.arange(hl, device=dev) // group)[:, None]).to(q.dtype)
    ctx = torch.einsum("bwjkd,jk->bwjd",
                       ctx_big.reshape(b, w, hl, kvh, dh), sel)
    ctx = ctx.reshape(b, w, hl * dh)
    return ctx[:, 0] if squeeze else ctx


class DecodePlan(NamedTuple):
    """How one call of Kernel C runs (csrc/paged_decode.cu)."""
    #: 16-byte pieces of q a lane holds of a row; 0 is the element path
    pieces: int
    #: lanes a row (0 on the element path)
    lanes: int
    #: query rows (heads x window rows) a block serves, at most
    #: ``_MAX_HEADS`` (on the element path all of a kv head's rows, or an
    #: equal chunk of them where all leave no K/V tile)
    heads: int
    #: logical pages a split holds
    split_pages: int
    #: splits of a slot's pages
    splits: int
    #: (kv heads x row chunks, slots, splits)
    grid: tuple

    @property
    def path(self) -> str:
        return "vector" if self.pieces else "element"


def paged_decode_plan(b: int, hl: int, kvh: int, dh: int, page_size: int,
                      pages_per_slot: int, dtype: torch.dtype,
                      aligned: bool,
                      blocks_per_sm: Callable[[int, int], int],
                      n_sms: int,
                      sliding_window: Optional[int] = None, *,
                      window: int = 1,
                      pool_dtype: Optional[torch.dtype] = None
                      ) -> DecodePlan:
    """Kernel C's path and grid for ``q [b, window, hl, dh]`` over pools
    of ``kvh`` heads in ``pool_dtype`` (q's dtype unless given), from the
    shapes alone: it never reads the positions.

    The vector path takes bf16/fp16/f32 q with ``dh`` a multiple of one
    16-byte piece of q (8 bf16 or fp16, 4 f32) up to 512, pools in q's
    dtype or int8 under 16-bit q (read as 8-byte pieces of 8 elements, so
    q's map of elements to lanes holds), with q, the pools and ctx at
    16-byte aligned addresses (``aligned``); the rest takes the element
    path, whose blocks take all of a kv head's ``window x group`` query
    rows, or where those leave no K/V tile in shared memory
    (:func:`element_tile`) the fewest equal chunks of them that do
    (:func:`element_chunks`; ``ValueError`` past
    :data:`ELEMENT_MAX_HEAD_DIM`). A
    row's ``dh / piece`` pieces spread over the power of two of lanes that
    covers them, at most 32, each lane holding a power of two of pieces
    (two at 512 bf16 or 256 f32, four at 512 f32). A kv head's ``window x
    group`` query rows fold together; a block holds at most ``_MAX_HEADS``
    of them at 8 columns a lane or fewer, 4 at 16 (the registers of q and
    P V), and more are cut into equal chunks. The grid
    is one wave of the card's resident blocks (``blocks_per_sm(pieces,
    heads)`` an SM, ``n_sms`` SMs) over (kv head, chunk, slot) triples,
    counted as if every slot were full: the pages a slot may read
    (``pages_per_slot``, or the pages that ``sliding_window + window - 1``
    rows span) are cut into that many splits, of at most
    ``_MAX_SPLIT_PAGES`` pages each, and the splits cover the whole
    table."""
    group = hl // kvh
    rows = window * group
    pool_dtype = pool_dtype or dtype
    elems = _PIECE_ELEMS.get(dtype, 0)
    pool_ok = pool_dtype == dtype or (pool_dtype == torch.int8
                                      and elems == 8)
    if not elems or dh % elems or not 0 < dh <= _MAX_HEAD_DIM or \
            not aligned or not pool_ok:
        chunks = element_chunks(rows, dh, page_size)
        if not chunks:
            raise ValueError(
                f"head_dim {dh} leaves Kernel C's element path no room for "
                f"one query row and one K/V row (at most "
                f"{ELEMENT_MAX_HEAD_DIM})")
        heads = _support.cdiv(rows, chunks)
        return DecodePlan(0, 0, heads, pages_per_slot, 1,
                          (kvh * _support.cdiv(rows, heads), b, 1))
    n = dh // elems
    lanes = 1 << (min(n, 32) - 1).bit_length()
    pieces = 1 << (_support.cdiv(n, 32) - 1).bit_length()
    max_heads = _MAX_HEADS if pieces * elems <= 8 else _MAX_HEADS // 2
    chunks = _support.cdiv(rows, max_heads)
    heads = _support.cdiv(rows, chunks)
    reach = pages_per_slot
    if sliding_window:
        reach = min(reach, _support.cdiv(sliding_window + window - 2,
                                         page_size) + 1)
    triples = b * kvh * chunks
    wave = n_sms * blocks_per_sm(pieces, heads)
    splits = max(1, min(reach, wave // triples))
    split_pages = min(_support.cdiv(reach, splits), _MAX_SPLIT_PAGES)
    splits = _support.cdiv(pages_per_slot, split_pages)
    return DecodePlan(pieces, lanes, heads, split_pages, splits,
                      (kvh * chunks, b, splits))


def element_tile(rows: int, dh: int, page_size: int) -> int:
    """The K/V rows the element path stages at once for ``rows`` query
    rows (a kv head's ``window x group``): the first of ``page_size``,
    ``page_size // 2``, ``// 4``, ... whose K and V rows fit side by side
    in an H100 block's shared memory, 0 when none does (``element_tile`` in
    csrc/paged_decode.cu)."""
    t = page_size
    while t >= 1:
        if _element_floats(rows, dh, t) * 4 <= _SMEM_BYTES:
            return t
        t //= 2
    return 0


def element_chunks(rows: int, dh: int, page_size: int) -> int:
    """How many equal chunks, across blocks, the element path cuts a kv
    head's ``rows`` query rows into: 1 wherever :func:`element_tile` finds
    a tile for all of them (those shapes keep their plan and bits), else the
    fewest whose ``cdiv(rows, chunks)`` rows leave a tile; 0 when one row
    leaves none (head_dim past :data:`ELEMENT_MAX_HEAD_DIM`)."""
    for chunks in range(1, rows + 1):
        if element_tile(_support.cdiv(rows, chunks), dh, page_size):
            return chunks
    return 0


def _element_floats(rows: int, dh: int, tile: int) -> int:
    """The element path's shared floats: q and acc, ``tile`` rows of K and
    of V, the tile's scores and the softmax state (``smem_floats`` in
    csrc/paged_decode.cu)."""
    return rows * dh * 2 + tile * (2 * dh + 1) + rows * tile + 3 * rows


def paged_decode_smem(plan: DecodePlan, dh: int, page_size: int,
                      pool_int8: bool = False) -> int:
    """The shared memory in bytes a block of Kernel C takes under
    ``plan``: the vector path's cp.async ring (4 stages, 2 at 4 pieces a
    lane), the split's page entries (and int8 scales) and the warps'
    partials; the element path's :func:`element_tile` rows."""
    if plan.path == "element":
        tile = element_tile(plan.heads, dh, page_size)
        return 4 * _element_floats(plan.heads, dh, tile)
    stages = 2 if plan.pieces >= 4 else 4
    ring = stages * 2 * 2 * plan.pieces * 256 * 16
    return ring + 4 * (_MAX_SPLIT_PAGES * (3 if pool_int8 else 1)
                       + 8 * plan.heads * (dh + 2))


def paged_decode_cuda_plan(q, k_pages, v_pages, page_table, group: int,
                           sliding_window: Optional[int] = None,
                           ctx=None) -> DecodePlan:
    """The plan :func:`paged_decode_cuda` takes for these tensors on their
    card (its occupancy and SM count); ``q`` is ``[b, heads, head_dim]``
    or a window ``[b, w, heads, head_dim]``; ``ctx`` is the output, when
    it is already allocated."""
    w = 1 if q.dim() == 3 else q.shape[1]
    b, hl, dh = q.shape[0], q.shape[-2], q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (q, k_pages, v_pages, ctx) if t is not None)
    return _card_plan(b, hl, hl // group, dh, k_pages.shape[1],
                      page_table.shape[1], q.dtype, aligned, sliding_window,
                      q.device.index, w, k_pages.dtype)


@functools.lru_cache(maxsize=256)
def _card_plan(b: int, hl: int, kvh: int, dh: int, page_size: int,
               pages_per_slot: int, dtype: torch.dtype, aligned: bool,
               sliding_window: Optional[int], dev: int, window: int = 1,
               pool_dtype: Optional[torch.dtype] = None) -> DecodePlan:
    """:func:`paged_decode_plan` on CUDA device ``dev``, made once per
    configuration: the plan is a function of these arguments alone."""
    code = _support.dtype_code(dtype, "Kernel C (paged_decode_cuda)")
    int8 = int(pool_dtype == torch.int8)
    return paged_decode_plan(
        b, hl, kvh, dh, page_size, pages_per_slot, dtype, aligned,
        lambda pieces, heads: _support.blocks_per_sm(
            dev, "apex_paged_decode_blocks_per_sm", code, int8,
            int(window > 1), pieces, heads, dh),
        _support.sm_count(dev), sliding_window, window=window,
        pool_dtype=pool_dtype)


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
                      sliding_window: Optional[int], k_scales=None,
                      v_scales=None):
    """Launch Kernel C; returns ``ctx [b, heads * head_dim]`` for ``q [b,
    heads, head_dim]``, or ``[b, w, heads * head_dim]`` for a window ``q
    [b, w, heads, head_dim]``. int8 pools take their ``[n_pages,
    kv_heads]`` float32 scales. No host sync and no allocation outside
    torch's caching allocator, so the call can be captured in a CUDA
    graph."""
    code = _support.dtype_code(q.dtype, "Kernel C (paged_decode_cuda)")
    n_pages, page_size, f = k_pages.shape
    # a rank-3 q is one window row: the same memory as [b, 1, hl, dh]
    w = 1 if q.dim() == 3 else q.shape[1]
    b, hl, dh = q.shape[0], q.shape[-2], q.shape[-1]
    quantized = k_pages.dtype == torch.int8
    if v_pages.dtype != k_pages.dtype or \
            k_pages.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"pools ({k_pages.dtype}, {v_pages.dtype}) must "
                        f"share q's dtype ({q.dtype}) or be int8")
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pools take k_scales and v_scales; other "
                         "pools take neither")
    q = q.contiguous()
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    if quantized:
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or not sc.is_contiguous() or \
                    tuple(sc.shape) != (n_pages, f // dh):
                raise ValueError(f"scales must be contiguous float32 "
                                 f"[n_pages, kv_heads], got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    page_table = page_table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    ctx = torch.empty(q.shape[:-2] + (hl * dh,), dtype=q.dtype,
                      device=q.device)
    if b == 0:
        return ctx
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = paged_decode_cuda_plan(q, k_pages, v_pages, page_table, group,
                                  sliding_window, ctx)
    ws = counters = None
    if plan.splits > 1:
        ws = _stream_buffer(q.device, stream, torch.float32,
                            b * w * hl * plan.splits * (dh + 2))
        counters = _stream_buffer(q.device, stream, torch.int32,
                                  plan.grid[0] * b)
    status = lib.apex_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        page_table.data_ptr(), positions.data_ptr(), ctx.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
        b, w, hl, hl // group, dh, n_pages, page_size, page_table.shape[1],
        int(sliding_window or 0), code,
        int(quantized), plan.pieces, plan.lanes, plan.heads,
        plan.split_pages, plan.splits)
    _build.check("apex_paged_decode", status)
    _support.count_launch("paged_decode")
    _support.DECODE_PLANS[plan] += 1
    return ctx


def fused_paged_decode_attention(q, k_new, v_new, k_pages, v_pages,
                                 page_table, positions, *,
                                 queries_per_group: int = 1,
                                 sliding_window=None,
                                 k_scales=None, v_scales=None):
    """One decode step for one layer over the paged KV pool.

    Args:
      q: ``[b, heads, head_dim]`` (single-token decode) or ``[b, w, heads,
        head_dim]`` (a ``w``-row verify window) query vectors, rope
        already applied.
      k_new, v_new: ``[b, kv_heads * head_dim]`` (or ``[b, w, kv_heads *
        head_dim]``) — this step's K/V rows.
      k_pages, v_pages: ``[n_pages, page_size, kv_heads * head_dim]``
        pools in q's dtype (bf16/fp16/f32), or int8 with scales, from
        ``init_paged_kv_caches``; updated IN PLACE.
      page_table: ``[b, pages_per_slot]`` int — unmapped entries hold the
        sentinel ``n_pages``.
      positions: ``[b]`` int — each slot's append index. Window row ``t``
        lands at ``positions[r] + t`` (rows past the table drop) and
        attends over logical rows ``[0, positions[r] + t]``.
      queries_per_group: query heads per K/V head.
      sliding_window: optional local-attention window.
      k_scales, v_scales: ``[n_pages, kv_heads]`` float32 scale sidecars
        (updated in place) — required with int8 pools, refused otherwise.

    Returns ``(ctx, k_pages, v_pages)`` — plus ``k_scales, v_scales``
    when quantized, all the objects that were passed in. ``ctx`` is ``[b,
    heads * head_dim]`` for rank-3 ``q``, else ``[b, w, heads *
    head_dim]``.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q, k_new, v_new = q[:, None], k_new[:, None], v_new[:, None]
    if q.dim() != 4:
        raise ValueError(f"q must be [b, heads, head_dim] or "
                         f"[b, w, heads, head_dim], got {tuple(q.shape)}")
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pools must be matching [n_pages, page_size, kv_heads * "
            f"head_dim], got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, w, hl, dh = q.shape
    if hl % queries_per_group:
        raise ValueError(f"heads ({hl}) not divisible by queries_per_group "
                         f"({queries_per_group})")
    kvh = hl // queries_per_group
    if k_pages.shape[-1] != kvh * dh:
        raise ValueError(f"pool minor dim {k_pages.shape[-1]} != kv_heads * "
                         f"head_dim ({kvh} * {dh})")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    quantized = k_scales is not None
    if (k_pages.dtype == torch.int8) != quantized:
        raise ValueError(
            f"int8 pools need scale sidecars (and only int8 pools take "
            f"them); pool dtype {k_pages.dtype}, scales "
            f"{'set' if quantized else 'None'}")
    if quantized and tuple(k_scales.shape) != (k_pages.shape[0], kvh):
        raise ValueError(f"scales must be [n_pages, kv_heads] = "
                         f"({k_pages.shape[0]}, {kvh}), got "
                         f"{tuple(k_scales.shape)}")
    _support.forward_only(
        "fused_paged_decode_attention",
        "decode is inference only, as in apex_tpu: no slice adds a backward",
        q, k_new, v_new)
    cpu = _support.is_cpu(q, k_new, v_new, k_pages, v_pages, page_table,
                          positions, k_scales, v_scales)
    # the append, its destinations worked out once for K and V
    dest, dest_row = _window_dest(page_table, positions, w, k_pages.shape[1],
                                  k_pages.shape[0])
    dest, dest_row = dest.reshape(-1), dest_row.reshape(-1)
    for pages, scales, rows in ((k_pages, k_scales, k_new),
                                (v_pages, v_scales, v_new)):
        rows = rows.reshape(b * w, -1)
        if quantized:
            _quant_scatter(pages, scales, rows, dest, dest_row)
        else:
            spare_page_view(pages).index_put_((dest, dest_row),
                                              rows.to(pages.dtype))
    attend = decode_plain if cpu else paged_decode_cuda
    ctx = attend(q, k_pages, v_pages, page_table, positions,
                 queries_per_group, sliding_window, k_scales, v_scales)
    if squeeze:
        ctx = ctx[:, 0]
    if quantized:
        return ctx, k_pages, v_pages, k_scales, v_scales
    return ctx, k_pages, v_pages
