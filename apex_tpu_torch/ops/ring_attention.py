"""Context-parallel ring attention.

Counterpart of ``apex_tpu/ops/ring_attention.py``'s :func:`ring_attention`
(``ulysses_attention`` is not ported yet). Every rank of a process group
keeps its query chunk; the K/V chunks rotate to rank + 1 one hop at a time
(``torch.distributed.batch_isend_irecv``). Each hop runs one chunk pair
through :func:`~apex_tpu_torch.ops.attention.flash_chunk_fwd` (Kernel B
with global offsets on the card) and merges it by log-sum-exp weights in
fp32; rank r's hop t meets chunk ``(r - t) mod cp``. Under a causal mask
a chunk wholly in the future, or past a sliding window, skips every key
tile inside the kernel.

The backward is the JAX package's ``_ring_vjp_bwd``: delta = rowsum(do *
o) in fp32 from the ring's rounded o, lse -inf -> 1e30, then a second
rotation in which every rank runs :func:`flash_chunk_bwd` (Kernel I on the
global lse and delta) per chunk pair; dq, dk and dv are summed in fp32 from
each chunk's grads in the input dtype, the dk/dv accumulators travel with
their chunk, and a last rotation sends them home.

:func:`ring_attention` takes ``group`` (a process group, or None) where
the JAX function takes a mesh axis; without a group, or with one of size
1, it is plain :func:`flash_attention`. :func:`_ring_attention_local` runs
the same schedule for all cp ranks in one process, holding every rank's
chunk: the same chunk calls in the same order as each rank of a group
makes them, so its result is the group ring's bit for bit (the JAX tests'
ring over virtual CPU devices has the same role).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.attention import (
    _LSE_PAD,
    flash_attention,
    flash_chunk_bwd,
    flash_chunk_fwd,
)

__all__ = ["ring_attention"]

#: rows whose lse reaches this are the kernels' no-key sentinel (1e30)
_PAD_THRESH = _LSE_PAD / 10


def _merge(o_a, lse_a, o_b, lse_b):
    """Two normalised partial attentions combined by log-sum-exp weights
    (``_merge``): fp32 o, rows at the 1e30 sentinel weigh zero, the chunk's
    o cast from q's dtype."""
    ninf = torch.tensor(float("-inf"), device=lse_a.device)
    la = torch.where(lse_a > _PAD_THRESH, ninf, lse_a)
    lb = torch.where(lse_b > _PAD_THRESH, ninf, lse_b)
    lnew = torch.logaddexp(la, lb)
    zero = torch.zeros((), device=lse_a.device)
    wa = torch.where(torch.isneginf(la), zero, torch.exp(la - lnew))
    wb = torch.where(torch.isneginf(lb), zero, torch.exp(lb - lnew))
    return wa[..., None] * o_a + wb[..., None] * o_b.float(), lnew


class _GroupRing:
    """The ranks of a process group, this process holding one of them;
    ``fwd`` and ``bwd`` are the chunk functions each hop calls."""

    def __init__(self, group):
        self.fwd, self.bwd = flash_chunk_fwd, flash_chunk_bwd
        self.group = group
        self.cp = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.ranks = [rank]
        self._next = dist.get_global_rank(group, (rank + 1) % self.cp)
        self._prev = dist.get_global_rank(group, (rank - 1) % self.cp)

    def rotate(self, carries: List[tuple]) -> List[tuple]:
        """Send this rank's tensors to rank + 1, take rank - 1's."""
        sent = [t.contiguous() for t in carries[0]]
        got = [torch.empty_like(t) for t in sent]
        ops = []
        for s, r in zip(sent, got):
            ops.append(dist.P2POp(dist.isend, s, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(got)]


class _LocalRing:
    """All cp ranks in one process: a rotation hands rank r - 1's
    tensors to rank r; ``fwd`` and ``bwd`` are the chunk functions each
    hop calls."""

    def __init__(self, cp: int):
        self.fwd, self.bwd = flash_chunk_fwd, flash_chunk_bwd
        self.cp = cp
        self.ranks = list(range(cp))

    def rotate(self, carries: List[tuple]) -> List[tuple]:
        return [carries[(r - 1) % self.cp] for r in self.ranks]


def _ring_fwd(ring, qs, ks, vs, kv_lengths, causal, window, scale):
    """``_ring_fwd_impl`` for the ranks ``ring`` holds: their o (q's dtype)
    and merged fp32 lse (-inf where a row sees no key)."""
    sc = qs[0].shape[2]

    def chunk(i, kc, vc, j):
        return ring.fwd(qs[i], kc, vc, q_start=ring.ranks[i] * sc,
                        k_start=j * sc, causal=causal, window=window,
                        kv_lengths=kv_lengths, softmax_scale=scale)

    os, lses = [], []
    for i, r in enumerate(ring.ranks):
        o0, lse0 = chunk(i, ks[i], vs[i], r)
        os.append(o0.float())
        lses.append(torch.where(lse0 > _PAD_THRESH,
                                torch.tensor(float("-inf"),
                                             device=lse0.device), lse0))
    kv = list(zip(ks, vs))
    for t in range(1, ring.cp):
        kv = ring.rotate(kv)
        for i, r in enumerate(ring.ranks):
            o_j, lse_j = chunk(i, *kv[i], (r - t) % ring.cp)
            os[i], lses[i] = _merge(os[i], lses[i], o_j, lse_j)
    return [o.to(q.dtype) for o, q in zip(os, qs)], lses


def _ring_bwd(ring, qs, ks, vs, kv_lengths, os, lses, dos, causal, window,
              scale):
    """``_ring_vjp_bwd`` for the ranks ``ring`` holds: ``(dqs, dks, dvs)``
    in the inputs' dtypes."""
    sc = qs[0].shape[2]
    deltas = [(do.float() * o.float()).sum(dim=-1) for do, o in zip(dos, os)]
    lse_b = [torch.where(torch.isneginf(lse),
                         torch.tensor(_LSE_PAD, device=lse.device), lse)
             for lse in lses]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    carry = [(k, v, torch.zeros(k.shape, dtype=torch.float32,
                                device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
             for k, v in zip(ks, vs)]
    for t in range(ring.cp):
        for i, r in enumerate(ring.ranks):
            kc, vc, dk, dv = carry[i]
            dq_j, dk_j, dv_j = ring.bwd(
                qs[i], kc, vc, dos[i], lse_b[i], deltas[i],
                q_start=r * sc, k_start=((r - t) % ring.cp) * sc,
                causal=causal, window=window, kv_lengths=kv_lengths,
                softmax_scale=scale)
            dqs[i] = dqs[i] + dq_j.float()
            carry[i] = (kc, vc, dk + dk_j.float(), dv + dv_j.float())
        # dK/dV travel with their chunk; the last rotation sends only them
        # home, the K/V chunks' would be discarded traffic
        carry = ring.rotate(carry if t < ring.cp - 1
                            else [c[2:] for c in carry])
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [c[0].to(k.dtype) for c, k in zip(carry, ks)],
            [c[1].to(v.dtype) for c, v in zip(carry, vs)])


class _Ring(torch.autograd.Function):
    """The JAX package's ``_ring`` custom VJP over the ranks ``ring``
    holds: ``tensors`` are their q chunks, then k, then v; the outputs
    their o chunks."""

    @staticmethod
    def forward(ctx, ring, kv_lengths, causal, window, scale, *tensors):
        n = len(ring.ranks)
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        os, lses = _ring_fwd(ring, qs, ks, vs, kv_lengths, causal, window,
                             scale)
        ctx.save_for_backward(kv_lengths, *tensors, *os, *lses)
        ctx.args = (ring, causal, window, scale)
        return tuple(os)

    @staticmethod
    def backward(ctx, *dos):
        ring, causal, window, scale = ctx.args
        n = len(ring.ranks)
        kv_lengths, *saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        os, lses = saved[3 * n:4 * n], saved[4 * n:]
        dqs, dks, dvs = _ring_bwd(ring, qs, ks, vs, kv_lengths, os, lses,
                                  dos, causal, window, scale)
        return (None, None, None, None, None, *dqs, *dks, *dvs)


def _checked_scale(qs: Sequence[torch.Tensor], ks, softmax_scale, causal,
                   sliding_window) -> float:
    if sliding_window is not None and not causal:
        raise ValueError("sliding_window requires causal attention")
    sc = qs[0].shape[2]
    if any(t.shape[2] != sc for t in (*qs, *ks)):
        raise ValueError("every rank's q and k/v chunks must share one "
                         "length")
    return float(softmax_scale if softmax_scale is not None
                 else 1.0 / math.sqrt(qs[0].shape[-1]))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   kv_lengths: Optional[torch.Tensor] = None,
                   sliding_window: Optional[int] = None,
                   group=None) -> torch.Tensor:
    """Exact attention over a context-sharded sequence, differentiable in
    q, k and v.

    Args:
      q, k, v: ``[batch, heads, s_local, head_dim]``, this rank's
        contiguous sequence chunk; the global sequence is the rank-order
        concatenation over ``group``. ``kv_heads`` may divide ``heads``
        (GQA/MQA): the smaller K/V chunks are what rotates.
      causal: global causal mask: rank i's queries see chunks j < i fully,
        chunk i triangularly, chunks j > i not at all.
      kv_lengths: optional int ``[batch]``, GLOBAL valid key lengths.
      sliding_window: causal local attention, exact across chunk
        boundaries (requires ``causal``).
      group: the ``torch.distributed`` process group of the ring (every
        rank calls with its own chunk); None, or a group of size 1, gives
        :func:`flash_attention`.
    """
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale,
                               kv_lengths=kv_lengths,
                               sliding_window=sliding_window)
    scale = _checked_scale([q], [k], softmax_scale, causal, sliding_window)
    return _Ring.apply(_GroupRing(group), kv_lengths, causal,
                       sliding_window, scale, q, k, v)[0]


def _ring_attention_local(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], *,
                          causal: bool = False,
                          softmax_scale: Optional[float] = None,
                          kv_lengths: Optional[torch.Tensor] = None,
                          sliding_window: Optional[int] = None
                          ) -> List[torch.Tensor]:
    """:func:`ring_attention`'s schedule for all ``len(qs)`` ranks in one
    process: ``qs[r]``, ``ks[r]``, ``vs[r]`` are rank r's chunks; returns
    their o chunks, differentiable."""
    scale = _checked_scale(qs, ks, softmax_scale, causal, sliding_window)
    return list(_Ring.apply(_LocalRing(len(qs)), kv_lengths, causal,
                            sliding_window, scale, *qs, *ks, *vs))

