"""Flash attention: 4D and packed-QKV, forward and backward.

Counterpart of ``apex_tpu/ops/attention.py``:

- :func:`flash_attention` over ``[batch, heads, seq, head_dim]`` is
  differentiable, the JAX package's ``_flash`` custom VJP: the forward
  saves ``(q, k, v, kv_lengths, o, lse)``. A CUDA tensor runs
  ``csrc/flash_fwd.cu`` (Kernel B, both TPU forward kernels) and
  ``csrc/flash_bwd.cu`` (Kernel I, the three TPU backward kernels); a CPU
  tensor runs :func:`flash_fwd_plain` (``_mha_reference`` with the lse) and
  :func:`flash_bwd_plain`. ``kv_heads`` may divide ``heads`` (GQA/MQA);
  masks: ``causal`` with the ``seq_k - seq_q`` offset, ``kv_lengths`` per
  batch, ``sliding_window``.
- :func:`flash_chunk_fwd` and :func:`flash_chunk_bwd` are the JAX
  package's chunk API (ring attention's building blocks, not
  differentiable): one (q chunk, kv chunk) pair whose first query and key
  sit at the global positions ``q_start`` and ``k_start``, so that causal,
  window and (global) ``kv_lengths`` masks are exact across chunks. A CUDA
  tensor runs Kernels B and I with those offsets, the backward on the
  caller's global lse and delta; a CPU tensor runs
  :func:`flash_chunk_fwd_plain` and :func:`flash_chunk_bwd_plain`.
- Every kernel takes any head dim: past 512 Kernels B, I, E and F walk it
  in parts of 512 output columns (``csrc/flash_wide.cuh``).
- :func:`flash_attention_packed` takes the fused QKV projection
  ``[s, b, G*(qpg+2)*d]`` as it comes out of ``ParallelAttention`` and is
  differentiable: the forward is ``csrc/flash_packed_fwd.cu`` (Kernel E),
  the backward ``csrc/flash_packed_bwd.cu`` (Kernel F), with RoPE and the
  hash dropout in-kernel; their plain versions are
  :func:`flash_packed_fwd_plain` and :func:`flash_packed_bwd_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch.ops import _build, _support
from apex_tpu_torch.ops.rope import rope_tables

__all__ = ["flash_attention", "flash_fwd_plain",
           "flash_fwd_cuda", "flash_bwd_factors", "flash_bwd_plain",
           "flash_bwd_rounding_slack", "flash_bwd_cuda", "flash_chunk_fwd",
           "flash_chunk_bwd", "flash_chunk_fwd_plain",
           "flash_chunk_bwd_plain",
           "flash_attention_packed", "packed_attention_supported",
           "packed_geometry", "drop_combo", "hash_keep",
           "flash_packed_fwd_plain", "flash_packed_bwd_plain",
           "flash_packed_bwd_rounding_slack", "flash_packed_fwd_cuda",
           "flash_packed_bwd_cuda", "rounding_step", "backward_floor",
           "forward_floor"]

_NEG_INF = -1e30
#: the widest head of the kernels' DMAX 64, 128, 256 and 512 instances;
#: past it B, I, E and F walk the head dim in parts of 512 columns
#: (csrc/flash_wide.cuh), and E and F take scratch
_TILED_HEAD_DIM = 512
#: lse of a query row that sees no key (attention.py ``_LSE_PAD``)
_LSE_PAD = 1e30


def rounding_step(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One rounding step of the fp32 values ``t`` to ``dtype``, as the
    rounding slack counts it: ``eps / 2`` of the magnitude (2^-8 for bf16,
    2^-11 for fp16), and at least the spacing of ``dtype``'s subnormals
    (2^-24 for fp16), where a small value's step no longer shrinks with
    it. Non-negative fp32."""
    fi = torch.finfo(dtype)
    return torch.clamp_min(t.abs() * (fi.eps / 2), fi.tiny * fi.eps)


def backward_floor(d: int) -> float:
    """The magnitude floor of the 1-ulp bar that holds a bf16 or fp16
    flash backward to its plain version at head_dim ``d``: 2^-8, times
    d / 256 past 256. A row that sees one key has p = 1 and o = v, so
    ds = p (dp - delta) cancels to the fp32 summation noise of two d-long
    sums, which grows with d: at d 512 in fp16 a dq element landed 0.95e-6
    past the 2^-18 floor's bound, both on an H100 and with JAX's
    interpret-mode kernel on the CPU. The same line holds past 512 (d
    840 to 2048 against JAX's interpret kernels on the CPU,
    tests/test_torch_hd1024.py)."""
    return 2.0 ** -8 * max(1.0, d / 256)


def forward_floor(d: int) -> float:
    """The magnitude floor of the 1-ulp bar that holds a bf16 or fp16
    flash forward to its plain version at head_dim ``d``: 2^-8 up to 512,
    :func:`backward_floor` past it. An output that cancels to near zero
    carries the fp32 noise of its d-long score sums on both sides: at d
    2048 in fp16 the plain version and the wide kernel each lie more than
    one 2^-8-floored ulp from float64 attention there, and up to two from
    each other (on an H100, ``tools/flash_f64.py``)."""
    return 2.0 ** -8 if d <= 512 else backward_floor(d)


def _offsets(sq: int, sk: int, q_start, k_start) -> tuple:
    """The global positions of the first query row and key column
    (``_offsets``): ``sk - sq`` and 0 unless given (a ring's chunk pair)."""
    return (sk - sq if q_start is None else int(q_start),
            0 if k_start is None else int(k_start))


def _visible(sq: int, sk: int, kv_lengths, causal: bool, window, device,
             q_start=None, k_start=None):
    """``[b or 1, 1, sq, sk]`` visibility of (query row, key col), as
    ``_mask_block`` at global positions: row r at ``q_start + r``, column c
    at ``k_start + c`` (:func:`_offsets`); ``kv_lengths`` are global."""
    q_start, k_start = _offsets(sq, sk, q_start, k_start)
    col = torch.arange(sk, device=device)[None, None, None, :] + k_start
    row = torch.arange(sq, device=device)[None, None, :, None] + q_start
    valid = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if kv_lengths is not None:
        valid = valid & (col < kv_lengths.to(device)[:, None, None, None])
    if causal:
        valid = valid & (col <= row)
    if window is not None:
        valid = valid & (col > row - window)
    return valid


def flash_fwd_plain(q, k, v, kv_lengths, scale: float, causal: bool,
                    window: Optional[int] = None, q_start=None, k_start=None):
    """Plain PyTorch forward (``_mha_reference``) with the lse the
    backward reads: fp32 scores and softmax, output in ``q.dtype``, lse
    ``[b, h, sq]`` fp32. A row that sees no key gives o = 0 and lse = 1e30
    (``_LSE_PAD``). ``q_start``, ``k_start``: :func:`_visible`."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _visible(q.shape[2], k.shape[2], kv_lengths, causal, window,
                     q.device, q_start, k_start)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    any_valid = valid.any(dim=-1, keepdim=True)
    lse = torch.where(any_valid, torch.logsumexp(s, dim=-1, keepdim=True),
                      torch.full_like(s[..., :1], _LSE_PAD))
    p = torch.softmax(s, dim=-1)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return o, lse[..., 0]


def _check_offsets(q_start, k_start) -> tuple:
    """``(q_start, k_start)`` as C ints (the kernels' positions are int32)."""
    for x in (q_start, k_start):
        if not -2 ** 30 <= x < 2 ** 30:
            raise ValueError(f"chunk offset {x} out of the kernels' range")
    return q_start, k_start


def flash_fwd_cuda(q, k, v, kv_lengths, scale: float, causal: bool,
                   window: Optional[int] = None, q_start=None, k_start=None):
    """Launch Kernel B; returns ``(o, lse)`` with ``lse [b, h, sq]`` fp32.
    ``q_start``, ``k_start``: the chunk's global offsets (:func:`_offsets`)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    code = _support.dtype_code(q.dtype, "Kernel B (flash_fwd_cuda)")
    q_start, k_start = _check_offsets(*_offsets(sq, sk, q_start, k_start))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_lengths is not None:
        kv_lengths = kv_lengths.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None if kv_lengths is None else kv_lengths.data_ptr(),
        stream, b, h, kvh, sq, sk, d, float(scale), int(causal),
        int(window or 0), q_start, k_start, code)
    _build.check("apex_flash_fwd", status)
    _support.count_launch("flash_fwd")
    return o, lse


def flash_bwd_factors(q, k, v, do, o, lse, kv_lengths, scale: float,
                      causal: bool, window: Optional[int] = None,
                      q_start=None, k_start=None, delta=None):
    """The fp32 factors of the plain backward (``_recompute_p_ds`` over
    whole matrices): ``p [b, h, sq, sk]`` from lse with masked scores at
    -1e30, and ``ds = p * (dp - delta)`` with ``delta = rowsum(do * o)``,
    or the given fp32 ``delta [b, h, sq]`` (a ring's, from its merged o;
    o is not read then). Returns ``(p, ds)``."""
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    valid = _visible(q.shape[2], k.shape[2], kv_lengths, causal, window,
                     q.device, q_start, k_start)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    if delta is None:
        delta = (dof * o.float()).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr.float())
    return p, p * (dp - delta.float()[..., None])


def flash_bwd_plain(q, k, v, do, o, lse, kv_lengths, scale: float,
                    causal: bool, window: Optional[int] = None,
                    q_start=None, k_start=None, delta=None):
    """Plain PyTorch backward, the algebra of ``_dq_kernel`` and
    ``_dkv_kernel`` over whole matrices on :func:`flash_bwd_factors`:
    ``dq = scale * ds k`` with ds rounded to k's dtype,
    ``dk = scale * ds^T q`` with ds rounded to q's dtype, ``dv = p^T do``
    with p rounded to do's dtype; dk and dv summed over each group's query
    heads in fp32, then one rounding to the input dtype. Returns
    ``(dq, dk, dv)``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    group = h // kvh
    p, ds = flash_bwd_factors(q, k, v, do, o, lse, kv_lengths, scale,
                              causal, window, q_start, k_start, delta)
    kr = k.repeat_interleave(group, dim=1)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                              kr.float())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                              q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, kvh, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, kvh, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_rounding_slack(q, k, v, do, o, lse, kv_lengths, scale: float,
                             causal: bool, window: Optional[int] = None,
                             q_start=None, k_start=None, delta=None):
    """How far one rounding step of every factor the backward rounds to the
    input dtype (ds before ``ds k`` and ``ds^T q``, p before ``p^T do``) can
    move dq, dk and dv: ``step(ds) * scale * |k|`` and so on, in fp32, with
    :func:`rounding_step` in q's dtype (``2^-8 |ds|`` in bf16). Two correct
    16-bit backwards that form ds in other fp32 summation orders may round
    a ds on a rounding boundary to neighbouring values; this bounds what
    that does to each output element."""
    p, ds = flash_bwd_factors(q, k, v, do, o, lse, kv_lengths, scale,
                              causal, window, q_start, k_start, delta)
    b, kvh, sk, d = k.shape
    group = q.shape[1] // kvh
    ds_step = rounding_step(ds, q.dtype)
    ka = k.float().abs().repeat_interleave(group, dim=1)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds_step, ka)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds_step, q.float().abs())
    dv = torch.einsum("bhqk,bhqd->bhkd", rounding_step(p, q.dtype),
                      do.float().abs())
    return (dq, dk.reshape(b, kvh, group, sk, d).sum(dim=2),
            dv.reshape(b, kvh, group, sk, d).sum(dim=2))


def flash_bwd_cuda(q, k, v, do, o, lse, kv_lengths, scale: float,
                   causal: bool, window: Optional[int] = None,
                   q_start=None, k_start=None, delta=None):
    """Launch Kernel I (bf16 and fp16: delta prep, dk/dv pass, dq pass;
    f32: dq pass, then dk/dv pass); returns ``(dq, dk, dv)`` in the
    inputs' dtype. ``q_start``, ``k_start``: the chunk's global offsets
    (:func:`_offsets`). With an fp32 ``delta [b, h, sq]`` the kernel reads
    it in place of rowsum(do * o), and o (which may be None) is not read."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype or (
            o is not None and o.dtype != q.dtype):
        raise TypeError(f"q/k/v/o dtypes differ: {q.dtype} {k.dtype} "
                        f"{v.dtype} {None if o is None else o.dtype}")
    code = _support.dtype_code(q.dtype, "Kernel I (flash_bwd_cuda)")
    if o is None and delta is None:
        raise ValueError("flash_bwd_cuda needs o or delta")
    q_start, k_start = _check_offsets(*_offsets(sq, sk, q_start, k_start))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.contiguous().to(q.dtype)
    lse = lse.contiguous()
    if kv_lengths is not None:
        kv_lengths = kv_lengths.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if delta is None:
        o = o.contiguous()
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        given = 0
    else:
        delta = delta.to(dtype=torch.float32).contiguous()
        given = 1
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.apex_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if given else o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if kv_lengths is None else kv_lengths.data_ptr(), stream, b, h,
        kvh, sq, sk, d, float(scale), int(causal), int(window or 0),
        q_start, k_start, given, code)
    _build.check("apex_flash_bwd", status)
    _support.count_launch("flash_bwd")
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: o and lse from Kernel B (or
    the plain forward), dq/dk/dv from Kernel I (or the plain backward)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, scale, causal, window):
        cpu = _support.is_cpu(q, k, v)
        fwd = flash_fwd_plain if cpu else flash_fwd_cuda
        o, lse = fwd(q, k, v, kv_lengths, scale, causal, window)
        ctx.save_for_backward(q, k, v, kv_lengths, o, lse)
        ctx.args = (scale, causal, window)
        ctx.cpu = cpu
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lengths, o, lse = ctx.saved_tensors
        bwd = flash_bwd_plain if ctx.cpu else flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, do, o, lse, kv_lengths, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    kv_lengths: Optional[torch.Tensor] = None,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention ``softmax(scale * q @ k^T + mask) @ v``,
    differentiable in q, k and v.

    Args:
      q: ``[batch, heads, seq_q, head_dim]``.
      k, v: ``[batch, kv_heads, seq_k, head_dim]``; ``kv_heads`` divides
        ``heads`` (grouped heads read the same K/V, no broadcast copy on
        the card; dk/dv sum over the group).
      causal: mask with the ``seq_k - seq_q`` offset.
      softmax_scale: defaults to ``1/sqrt(head_dim)``.
      kv_lengths: optional int ``[batch]`` valid key lengths; a row with
        length 0 gives zero output and zero gradients.
      sliding_window: keep only the last ``sliding_window`` keys per query
        (incl. self; requires ``causal``).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects [batch, heads, seq, dim]")
    if k.shape[1] != v.shape[1] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"kv_heads ({k.shape[1]}) must divide query heads "
            f"({q.shape[1]}) for GQA/MQA")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal attention")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got "
                             f"{sliding_window}")
    scale = float(softmax_scale if softmax_scale is not None
                  else 1.0 / math.sqrt(q.shape[-1]))
    return _Flash.apply(q, k, v, kv_lengths, scale, causal, sliding_window)


# ---------------------------------------------------------------------------
# chunk API (ring attention's building blocks)
# ---------------------------------------------------------------------------

def flash_chunk_fwd_plain(q, k, v, kv_lengths, scale: float, causal: bool,
                          window: Optional[int], q_start: int, k_start: int):
    """Plain version of one chunk pair's forward (``_chunk_reference_fwd``):
    fp32 scores and p, o in q's dtype, the fp32 lse; a row that sees no key
    of this chunk (wholly in its causal future, past its window, or past
    its kv_length) gives o = 0 and lse = 1e30. Returns ``(o, lse)``."""
    return flash_fwd_plain(q, k, v, kv_lengths, scale, causal, window,
                           q_start, k_start)


def flash_chunk_bwd_plain(q, k, v, do, lse, delta, kv_lengths, scale: float,
                          causal: bool, window: Optional[int], q_start: int,
                          k_start: int):
    """Plain version of one chunk pair's backward (``_chunk_reference_bwd``)
    from the GLOBAL fp32 ``lse`` and ``delta``: p = exp(scale s - lse) and
    ds = p (dp - delta) in fp32, rounded to the input dtype before their
    products where the JAX kernels (and Kernel I) round them
    (:func:`flash_bwd_plain`; a no-op in f32); grads in the inputs' dtype.
    Returns ``(dq, dk, dv)``."""
    return flash_bwd_plain(q, k, v, do, None, lse, kv_lengths, scale, causal,
                           window, q_start, k_start, delta)


def _chunk_args(q, k, v, softmax_scale):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash chunks expect [batch, heads, seq, dim]")
    if k.shape[1] != v.shape[1] or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"kv_heads ({k.shape[1]}) must divide query heads "
            f"({q.shape[1]}) for GQA/MQA")
    return float(softmax_scale if softmax_scale is not None
                 else 1.0 / math.sqrt(q.shape[-1]))


def flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_start: int, k_start: int, causal: bool = False,
                    window: Optional[int] = None,
                    kv_lengths: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None):
    """One flash forward over a (q chunk, kv chunk) pair -> ``(o, lse)``.

    ``q_start``/``k_start`` place the chunks at GLOBAL sequence positions,
    so causal masks, sliding windows and ``kv_lengths`` (global valid
    lengths) are exact across chunk boundaries; a chunk wholly in the
    causal future costs only the launch (every key tile is skipped) and
    gives ``lse = 1e30`` rows that merge with weight zero. Not
    differentiable: ring attention composes it per hop with its own
    backward. A CUDA tensor launches Kernel B, a CPU tensor runs
    :func:`flash_chunk_fwd_plain`."""
    scale = _chunk_args(q, k, v, softmax_scale)
    args = (kv_lengths, scale, causal, window, q_start, k_start)
    if _support.is_cpu(q, k, v):
        return flash_chunk_fwd_plain(q, k, v, *args)
    return flash_fwd_cuda(q, k, v, *args)


def flash_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    *, q_start: int, k_start: int, causal: bool = False,
                    window: Optional[int] = None,
                    kv_lengths: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None):
    """Flash backward over one chunk pair with the GLOBAL fp32 ``lse`` and
    ``delta [b, h, sq]`` -> ``(dq, dk, dv)``: with the global log-sum-exp,
    the chunk pairs' contributions sum to the whole sequence's gradients.
    A CUDA tensor launches Kernel I (its delta prep skipped), a CPU tensor
    runs :func:`flash_chunk_bwd_plain`."""
    scale = _chunk_args(q, k, v, softmax_scale)
    args = (kv_lengths, scale, causal, window, q_start, k_start)
    if _support.is_cpu(q, k, v, do):
        return flash_chunk_bwd_plain(q, k, v, do, lse, delta, *args)
    return flash_bwd_cuda(q, k, v, do, None, lse, *args, delta=delta)


# ---------------------------------------------------------------------------
# packed-QKV path (``flash_attention_packed``)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def packed_geometry(num_groups: int, qpg: int, head_dim: int):
    """The JAX package's 128-lane cell geometry ``(gpc, in_w, out_w)``, or
    None. The port's kernels do not need it (they address heads directly);
    it is kept so the tests can hold the two gates side by side."""
    for gpc in (1, 2):
        if num_groups % gpc:
            continue
        in_w = gpc * (qpg + 2) * head_dim
        out_w = gpc * qpg * head_dim
        if in_w % 128 == 0 and out_w % 128 == 0:
            return gpc, in_w, out_w
    return None


def packed_attention_supported(s: int, num_groups: int,
                               queries_per_group: int,
                               head_dim: int) -> bool:
    """Whether :func:`flash_attention_packed` takes this shape: True for
    every shape the port's kernels take (any head_dim, length and group
    count), on any device — as the JAX package's plain path takes any
    shape."""
    return head_dim > 0 and s > 0 and num_groups > 0 \
        and queries_per_group > 0


def drop_combo(b, head):
    """The (batch, global head) -> hash key every dropout mask shares
    (the JAX package's ``_drop_combo``): kernels and plain versions."""
    return b * 4096 + head


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` without
    overflowing int64: split x into 16-bit halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_keep(seed, combo, shape, rate: float) -> torch.Tensor:
    """Dropout keep mask of ``shape`` (``[..., rows, cols]``): the JAX
    package's ``_hash_keep`` bit for bit. A murmur3-style hash of (seed,
    combo, row, col) in uint32 arithmetic, done here in int64 masked to
    32 bits (torch has no full uint32 math on the CPU). ``seed`` is an
    int32 (it wraps to uint32), ``combo`` an int or an int tensor
    broadcastable against ``shape[:-2]`` (see :func:`drop_combo`); rows and
    cols are absolute positions. Keeps with probability ``1 - rate``."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    combo = torch.as_tensor(combo, dtype=torch.int64, device=seed.device)
    dev = seed.device
    lead = (1,) * (len(shape) - 2)
    r = torch.arange(shape[-2], dtype=torch.int64, device=dev).reshape(
        lead + (shape[-2], 1))
    c = torch.arange(shape[-1], dtype=torch.int64, device=dev).reshape(
        lead + (1, shape[-1]))
    k = ((seed & _M32) + _mul32(combo & _M32, 0x27D4EB2F)) & _M32
    x = ((_mul32(r, 0x9E3779B1) + k) & _M32) ^ _mul32(c, 0x85EBCA77)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= _keep_threshold(rate)


def _keep_threshold(rate: float) -> int:
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _unpack(t: torch.Tensor, qpg: int, d: int):
    """``[s, b, G*(qpg+2)*d]`` -> q ``[b, G*qpg, s, d]``, k and v
    ``[b, G, s, d]`` (views)."""
    s, b, w = t.shape
    g = w // ((qpg + 2) * d)
    t5 = t.reshape(s, b, g, qpg + 2, d)
    q = t5[:, :, :, :qpg].reshape(s, b, g * qpg, d).permute(1, 2, 0, 3)
    return q, t5[:, :, :, qpg].permute(1, 2, 0, 3), \
        t5[:, :, :, qpg + 1].permute(1, 2, 0, 3)


def _rotate(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            rot: int) -> torch.Tensor:
    """``_rope_block`` over ``t [..., s, d]`` with fp32 ``cos``/``sin``
    ``[s, d]`` (1 and 0 past ``rot``): fp32 math, result in fp32 (the
    caller rounds). ``sin`` negated gives the inverse rotation."""
    tf = t.float()
    half = torch.cat([-tf[..., rot // 2:rot], tf[..., :rot // 2],
                      torch.zeros_like(tf[..., rot:])], dim=-1)
    return tf * cos + half * sin


def _rotate_bound(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rot: int) -> torch.Tensor:
    """What :func:`_rotate` (either sign of sin) can make of a per-element
    bound ``t >= 0``: ``t |cos| + t' |sin|``, t' the partner column."""
    half = torch.cat([t[..., rot // 2:rot], t[..., :rot // 2],
                      torch.zeros_like(t[..., rot:])], dim=-1)
    return t * cos.abs() + half * sin.abs()


def _packed_valid(s: int, kv_lengths, causal: bool, window, device):
    """``[b or 1, 1, s, s]`` visibility of (query row, key col)."""
    row = torch.arange(s, device=device)[:, None]
    col = torch.arange(s, device=device)[None, :]
    valid = torch.ones((1, 1, s, s), dtype=torch.bool, device=device)
    if kv_lengths is not None:
        valid = valid & (col < kv_lengths.to(device)[:, None, None, None])
    if causal:
        valid = valid & (col <= row)
    if window is not None:
        valid = valid & (col > row - window)
    return valid


def _packed_keep(seed, b: int, h: int, s: int, rate: float, device):
    combo = drop_combo(torch.arange(b, device=device)[:, None, None, None],
                       torch.arange(h, device=device)[None, :, None, None])
    return hash_keep(torch.as_tensor(seed, device=device).reshape(()), combo,
                     (b, h, s, s), rate)


def _qk(qkv, qpg, d, rope):
    """Unpacked q, k (rotated and rounded to qkv's dtype when ``rope``)
    and v, with k and v repeated over each group's query heads."""
    q, k, v = _unpack(qkv, qpg, d)
    if rope is not None:
        cos, sin, rot = rope
        q = _rotate(q, cos, sin, rot).to(qkv.dtype)
        k = _rotate(k, cos, sin, rot).to(qkv.dtype)
    return q, k.repeat_interleave(qpg, dim=1), v.repeat_interleave(qpg, dim=1)


def flash_packed_fwd_plain(qkv, kv_lengths, rope, seed, rate: float,
                           scale: float, causal: bool, window, qpg: int,
                           d: int):
    """Plain PyTorch forward: unpack, rotate, then ``_mha_reference`` with
    the hash dropout. Returns ``(o [s, b, H*d], lse [b, H, s])``; lse is
    taken from the undropped probabilities and is 1e30 on a row that sees
    no key. ``rope`` is None or ``(cos, sin, rot)`` from
    :func:`~apex_tpu_torch.ops.rope.rope_tables`."""
    s, b, _ = qkv.shape
    q, k, v = _qk(qkv, qpg, d, rope)
    h = q.shape[1]
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _packed_valid(s, kv_lengths, causal, window, qkv.device)
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
    any_valid = valid.any(dim=-1, keepdim=True)
    lse = torch.where(any_valid, torch.logsumexp(sc, dim=-1, keepdim=True),
                      torch.full_like(sc[..., :1], _LSE_PAD))
    p = torch.softmax(sc, dim=-1)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    if rate > 0.0:
        keep = _packed_keep(seed, b, h, s, rate, qkv.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(qkv.dtype)
    return o.permute(2, 0, 1, 3).reshape(s, b, h * d), lse[..., 0]


def _packed_bwd_factors(qkv, do, o, lse, kv_lengths, rope, seed,
                        rate: float, scale: float, causal: bool, window,
                        qpg: int, d: int):
    """The fp32 factors of the packed backward (``_recompute_p_ds`` over
    whole heads): q and k as the forward rotates and rounds them (k
    repeated over each group's query heads), do ``[b, H, s, d]``, the
    dropped p (``pd``) from lse with masked scores at -1e30, and
    ``ds = p * (dp - delta)`` with ``delta = rowsum(do * o)`` and dp masked
    and rescaled by the dropout keep mask. Returns ``(q, k, do, pd, ds)``."""
    s, b, _ = qkv.shape
    q, k, v = _qk(qkv, qpg, d, rope)
    h = q.shape[1]
    dof = do.reshape(s, b, h, d).permute(1, 2, 0, 3).float()
    of = o.reshape(s, b, h, d).permute(1, 2, 0, 3).float()
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _packed_valid(s, kv_lengths, causal, window, qkv.device)
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
    p = torch.exp(sc - lse[..., None])
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    pd = p
    if rate > 0.0:
        keep = _packed_keep(seed, b, h, s, rate, qkv.device)
        inv_keep = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv_keep, torch.zeros_like(dp))
        pd = torch.where(keep, p * inv_keep, torch.zeros_like(p))
    return q, k, dof, pd, p * (dp - delta)


def _pack_dqkv(dq, dk, dv, qpg: int, dtype):
    """dq ``[b, H, s, d]``, dk and dv ``[b, G, s, d]`` -> the packed
    ``[s, b, G*(qpg+2)*d]`` layout in ``dtype``."""
    b, g, s, d = dk.shape
    dqkv = torch.empty((s, b, g, qpg + 2, d), dtype=dtype, device=dk.device)
    dqkv[:, :, :, :qpg] = dq.permute(2, 0, 1, 3).reshape(s, b, g, qpg, d)
    dqkv[:, :, :, qpg] = dk.permute(2, 0, 1, 3)
    dqkv[:, :, :, qpg + 1] = dv.permute(2, 0, 1, 3)
    return dqkv.reshape(s, b, g * (qpg + 2) * d)


def flash_packed_bwd_plain(qkv, do, o, lse, kv_lengths, rope, seed,
                           rate: float, scale: float, causal: bool, window,
                           qpg: int, d: int):
    """Plain PyTorch backward, the algebra of ``_dqkv_packed_kernel`` on
    the factors of :func:`_packed_bwd_factors`, rounded where that kernel
    rounds them: ``dq = scale * ds k`` with ds rounded to qkv's dtype,
    ``dk = scale * ds^T q`` with ds rounded likewise, ``dv = pd^T do`` with
    the dropped p rounded likewise; dk and dv summed over each group's
    query heads in fp32; dq and dk un-rotated in fp32 with -sin; ``dqkv``
    written in the packed layout in qkv's dtype (one rounding)."""
    s, b, w = qkv.shape
    q, k, dof, pd, ds = _packed_bwd_factors(qkv, do, o, lse, kv_lengths,
                                            rope, seed, rate, scale, causal,
                                            window, qpg, d)
    g = q.shape[1] // qpg
    ds = ds.to(qkv.dtype).float()
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(qkv.dtype).float(), dof)
    dk = dk.reshape(b, g, qpg, s, d).sum(dim=2)
    dv = dv.reshape(b, g, qpg, s, d).sum(dim=2)
    if rope is not None:
        cos, sin, rot = rope
        dq = _rotate(dq, cos, -sin, rot)
        dk = _rotate(dk, cos, -sin, rot)
    return _pack_dqkv(dq, dk, dv, qpg, qkv.dtype)


def flash_packed_bwd_rounding_slack(qkv, do, o, lse, kv_lengths, rope, seed,
                                    rate: float, scale: float, causal: bool,
                                    window, qpg: int, d: int):
    """How far one rounding step of every factor the packed backward
    rounds to qkv's dtype (ds before ``ds k`` and ``ds^T q``, the dropped p
    before ``pd^T do``) can move each element of dqkv: ``step(ds) * scale *
    |k|`` and so on (:func:`rounding_step` in qkv's dtype: ``2^-8 |ds|`` in
    bf16, ``2^-11 |ds|`` but at least 2^-24 in fp16), summed over the
    group's query heads and carried through the un-rotation (``|cos|`` and
    ``|sin|``), in fp32 and the packed layout. Two correct backwards that
    form ds in other fp32 summation orders may round a ds on a rounding
    boundary to neighbouring values; this bounds what that does to each
    output element (the packed counterpart of
    :func:`flash_bwd_rounding_slack`)."""
    s, b, _ = qkv.shape
    q, k, dof, pd, ds = _packed_bwd_factors(qkv, do, o, lse, kv_lengths,
                                            rope, seed, rate, scale, causal,
                                            window, qpg, d)
    g = q.shape[1] // qpg
    ds = rounding_step(ds, qkv.dtype)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs())
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs())
    dv = torch.einsum("bhqk,bhqd->bhkd", rounding_step(pd, qkv.dtype),
                      dof.abs())
    dk = dk.reshape(b, g, qpg, s, d).sum(dim=2)
    dv = dv.reshape(b, g, qpg, s, d).sum(dim=2)
    if rope is not None:
        cos, sin, rot = rope
        dq = _rotate_bound(dq, cos, sin, rot)
        dk = _rotate_bound(dk, cos, sin, rot)
    return _pack_dqkv(dq, dk, dv, qpg, torch.float32)


def _packed_args(qkv, kv_lengths, rope, seed, rate):
    """Device pointers and scalars shared by the Kernel E/F launches."""
    dev = qkv.device
    kvl = (None if kv_lengths is None else kv_lengths.to(
        device=dev, dtype=torch.int32).contiguous())
    cos = sin = None
    rot = 0
    if rope is not None:
        cos, sin, rot = rope
        cos = cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    seed_t = None
    if rate > 0.0:
        seed_t = torch.as_tensor(seed, dtype=torch.int32).reshape(1).to(
            dev).contiguous()
    held = (kvl, cos, sin, seed_t)       # the caller keeps these alive
    ptrs = tuple(None if t is None else t.data_ptr() for t in held)
    return ptrs, rot, _keep_threshold(rate), float(1.0 / (1.0 - rate)), held


def _rot_scratch(qkv, d: int, rot: int):
    """Past :data:`_TILED_HEAD_DIM` with RoPE, E and F first write q and k
    rotated into a copy of qkv's layout (csrc/flash_wide.cuh): that
    scratch, else None."""
    return torch.empty_like(qkv) if d > _TILED_HEAD_DIM and rot else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_packed_fwd_cuda(qkv, kv_lengths, rope, seed, rate: float,
                          scale: float, causal: bool, window, qpg: int,
                          d: int):
    """Launch Kernel E; returns ``(o [s, b, H*d], lse [b, H, s])``."""
    s, b, w = qkv.shape
    g = w // ((qpg + 2) * d)
    code = _support.dtype_code(qkv.dtype, "Kernel E (flash_packed_fwd_cuda)")
    qkv = qkv.contiguous()
    o = torch.empty((s, b, g * qpg * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, g * qpg, s), dtype=torch.float32,
                      device=qkv.device)
    if o.numel() == 0:
        return o, lse
    ptrs, rot, thresh, inv_keep, _held = _packed_args(qkv, kv_lengths, rope,
                                                      seed, rate)
    rot_qkv = _rot_scratch(qkv, d, rot)
    lib = _build.library()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    status = lib.apex_flash_packed_fwd(
        qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), *ptrs, _ptr(rot_qkv),
        stream, s, b, g, qpg, d, float(scale), int(causal), int(window or 0),
        rot, thresh, inv_keep, code)
    _build.check("apex_flash_packed_fwd", status)
    _support.count_launch("flash_packed_fwd")
    return o, lse


def flash_packed_bwd_cuda(qkv, do, o, lse, kv_lengths, rope, seed,
                          rate: float, scale: float, causal: bool, window,
                          qpg: int, d: int):
    """Launch Kernel F (dq pass, then dk/dv pass); returns ``dqkv``."""
    s, b, w = qkv.shape
    g = w // ((qpg + 2) * d)
    code = _support.dtype_code(qkv.dtype, "Kernel F (flash_packed_bwd_cuda)")
    if o.dtype != qkv.dtype:
        raise TypeError(f"o ({o.dtype}) and qkv ({qkv.dtype}) dtypes differ")
    qkv, do, o = qkv.contiguous(), do.contiguous().to(qkv.dtype), \
        o.contiguous()
    lse = lse.contiguous()
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    delta = torch.empty((b, g * qpg, s), dtype=torch.float32,
                        device=qkv.device)
    ptrs, rot, thresh, inv_keep, _held = _packed_args(qkv, kv_lengths, rope,
                                                      seed, rate)
    # past the DMAX instances: dq and dk in fp32 before their un-rotation
    grad32 = None if d <= _TILED_HEAD_DIM else torch.empty(
        (s, b, g * (qpg + 1), d), dtype=torch.float32, device=qkv.device)
    rot_qkv = _rot_scratch(qkv, d, rot)
    lib = _build.library()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    status = lib.apex_flash_packed_bwd(
        qkv.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), *ptrs, _ptr(grad32),
        _ptr(rot_qkv), stream, s, b, g, qpg, d, float(scale), int(causal),
        int(window or 0), rot, thresh, inv_keep, code)
    _build.check("apex_flash_packed_bwd", status)
    _support.count_launch("flash_packed_bwd")
    return dqkv


class _FlashPacked(torch.autograd.Function):
    """The JAX package's ``_flash_packed`` custom VJP: o from Kernel E (or
    its plain version), dqkv from Kernel F (or its plain version)."""

    @staticmethod
    def forward(ctx, qkv, kv_lengths, cos, sin, rot, seed, rate, scale,
                causal, window, qpg, d):
        rope = None if rot == 0 else (cos, sin, rot)
        cpu = _support.is_cpu(qkv, kv_lengths, cos, sin)
        fwd = flash_packed_fwd_plain if cpu else flash_packed_fwd_cuda
        o, lse = fwd(qkv, kv_lengths, rope, seed, rate, scale, causal,
                     window, qpg, d)
        ctx.save_for_backward(qkv, kv_lengths, cos, sin, o, lse)
        ctx.args = (rot, seed, rate, scale, causal, window, qpg, d)
        ctx.cpu = cpu
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, kv_lengths, cos, sin, o, lse = ctx.saved_tensors
        rot, seed, rate, scale, causal, window, qpg, d = ctx.args
        rope = None if rot == 0 else (cos, sin, rot)
        bwd = flash_packed_bwd_plain if ctx.cpu else flash_packed_bwd_cuda
        dqkv = bwd(qkv, do, o, lse, kv_lengths, rope, seed, rate, scale,
                   causal, window, qpg, d)
        return (dqkv,) + (None,) * 11


def flash_attention_packed(
    qkv: torch.Tensor, *,
    queries_per_group: int,
    head_dim: int,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    rope_freqs: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """Self-attention over a packed QKV projection, layout-native.

    Args:
      qkv: ``[s, b, G*(qpg+2)*head_dim]`` — the fused QKV projection
        output, each group's columns ordered ``q_0..q_{qpg-1} | k | v``.
      queries_per_group: query heads per K/V group (``qpg``).
      rope_freqs: optional RoPE angles for positions ``0..s-1``
        (``[s, rot]`` or ``[s, 1, 1, rot]``, Megatron ``concat(f, f)``):
        q and k rotate in-kernel and the backward un-rotates dq/dk.
      dropout_rate / dropout_seed: attention dropout on the softmax
        probabilities from the position-deterministic hash mask
        (:func:`hash_keep`), regenerated in the backward; the seed is an
        int32 (a Python int or a one-element integer tensor, which stays on
        its device).

    Returns ``[s, b, G*qpg*head_dim]`` context in model layout;
    differentiable in ``qkv``.
    """
    s, b, w = qkv.shape
    qpg, d = queries_per_group, head_dim
    g = w // ((qpg + 2) * d)
    if w != g * (qpg + 2) * d:
        raise ValueError(f"packed width {w} is not a multiple of the group "
                         f"block {(qpg + 2) * d}")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal attention")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got "
                             f"{sliding_window}")
    if not packed_attention_supported(s, g, qpg, d):
        raise ValueError(f"packed attention unsupported for s={s}, "
                         f"groups={g}, qpg={qpg}, d={d} — gate on "
                         f"packed_attention_supported()")
    if dropout_rate < 0.0 or dropout_rate >= 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    scale = float(softmax_scale if softmax_scale is not None
                  else 1.0 / math.sqrt(d))
    cos = sin = None
    rot = 0
    if rope_freqs is not None:
        cos, sin, rot = rope_tables(rope_freqs.to(qkv.device), s, d)
    seed = None if dropout_rate == 0.0 else _seed_value(dropout_seed)
    return _FlashPacked.apply(qkv, kv_lengths, cos, sin, rot, seed,
                              float(dropout_rate), scale, causal,
                              sliding_window, qpg, d)


def _seed_value(seed):
    """The dropout seed as the kernels and plain versions take it: a Python
    int in the int32 range (a 32-bit value wraps, as the JAX package's
    int32 seed does), or, for a tensor seed, a one-element int32 tensor on
    the seed's own device, so a seed on the card never syncs with the host
    (an int64 value keeps its low 32 bits). The kernels read it from a
    one-element device buffer as uint32."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1:
            raise ValueError(f"dropout_seed must hold one value, got shape "
                             f"{tuple(seed.shape)}")
        if seed.is_floating_point() or seed.is_complex():
            raise TypeError(f"dropout_seed must be an integer tensor, got "
                            f"{seed.dtype}")
        return seed.reshape(1).to(torch.int32)
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"dropout_seed {seed} is not a 32-bit value")
    return (seed + 2 ** 31) % 2 ** 32 - 2 ** 31
