"""Multi-tensor kernels: amp's unscale, L2 norms, and the Adam, LAMB and
SGD steps over a whole list of tensors.

They have no Pallas counterpart: the JAX package's optimizers and amp
unscale are ``jnp`` tree math that XLA fuses into a few loops over the
whole parameter set. Run eagerly, the same math is ~15 launches a tensor;
``csrc/multi_tensor.cu`` does it in a few launches a list (apex's amp_C
design). A CUDA tensor list launches those kernels, or the wrapper raises;
a CPU list takes the plain version, the per-tensor torch ops the
optimizers run on the CPU (``FusedAdam._update`` and its kin call the same
math functions below). Mixed devices raise, as :func:`_support.is_cpu`
does.

The lists a kernel reads are described to it by a :class:`TensorTable`:
launch records in device memory (pointers, sizes, dtype codes, step
counters, a chunk -> tensor map; layout in ``csrc/multi_tensor.cuh``),
made once for a fixed list and kept in a :class:`TableCache` that callers
own, rebuilt only when a pointer, size or dtype changes. :func:`plan` is
the pure-Python cut into records: at most ``MAX_TENSORS`` tensors and
``MAX_CHUNKS`` chunks of ``CHUNK`` elements each, a larger tensor
continuing in the next record. Each wrapper adds its launches to
``LAUNCHES`` (one a record, plus the l2norm's finishing pass and the
optimizers' step-counter pass).

Rounding: the kernels repeat the plain version's fp32 operations in its
order with round-to-nearest intrinsics, so scale, Adam and SGD match the
plain version run on the card bitwise; the norms (and so LAMB) differ in
summation order only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops import _build, _support

__all__ = ["CHUNK", "MAX_TENSORS", "MAX_CHUNKS", "plan", "TensorTable",
           "TableCache", "unscaled_fp32", "commit", "adam_update",
           "lamb_update", "sgd_update", "scale_plain", "l2norm_plain",
           "adam_plain", "lamb_plain", "sgd_plain", "lamb_clip",
           "multi_tensor_scale", "multi_tensor_l2norm", "multi_tensor_adam",
           "multi_tensor_lamb", "multi_tensor_sgd", "optimizer_launches"]

#: elements a block covers, and a record's capacity (csrc/multi_tensor.cuh)
CHUNK = 16384
MAX_LISTS = 6
MAX_TENSORS = 128
MAX_CHUNKS = 2048
_ADDR = 4
_CODE = _ADDR + MAX_LISTS * MAX_TENSORS
_SIZE = _CODE + MAX_LISTS * MAX_TENSORS
_STEP = _SIZE + MAX_TENSORS
_CHUNKS = _STEP + MAX_TENSORS
WORDS = _CHUNKS + MAX_CHUNKS

#: dtype codes of csrc/common.cuh (the multi-tensor kernels take all three)
_CODES = _support._DTYPE_CODES

Tensors = Sequence[torch.Tensor]


def plan(sizes: Sequence[int]) -> List[Tuple[int, int, List[Tuple[int, int]]]]:
    """The launch records of a list of tensors of ``sizes`` elements:
    ``(first tensor, tensors, [(tensor index in the record, chunk index in
    the tensor), ...])``. A record holds at most ``MAX_TENSORS`` tensors
    (consecutive, empty ones included) and ``MAX_CHUNKS`` chunks; a tensor
    whose chunks do not fit continues in the next record. Chunks are
    numbered in list order, so each tensor's are one run."""
    records = []
    first, count, chunks = 0, 0, []
    for t, n in enumerate(sizes):
        if count == MAX_TENSORS:
            if chunks:
                records.append((first, count, chunks))
            first, count, chunks = t, 0, []
        count += 1
        for c in range(_support.cdiv(int(n), CHUNK)):
            if len(chunks) == MAX_CHUNKS:
                records.append((first, count, chunks))
                first, count, chunks = t, 1, []
            chunks.append((count - 1, c))
    if chunks:
        records.append((first, count, chunks))
    return records


def optimizer_launches(sizes: Sequence[int], kernel: str,
                       adapt: bool = True) -> Dict[str, int]:
    """Launches one call of ``kernel`` makes over a list of ``sizes``: a
    launch a record, plus the step-counter pass of the optimizer kernels
    and the l2norm's finishing pass (LAMB: two l2norms where ``adapt``)."""
    r = len(plan(sizes))
    if kernel == "multi_tensor_scale":
        return {kernel: r}
    if kernel == "multi_tensor_l2norm":
        return {kernel: r + 1}
    if kernel == "multi_tensor_lamb":
        return {kernel: 2 * r + 1,
                "multi_tensor_l2norm": 2 * (r + 1) if adapt else 0}
    return {kernel: r + 1}


def _check_lists(lists: Sequence[Tensors], fp32_from: int) -> None:
    n = len(lists[0])
    for k, lst in enumerate(lists):
        if len(lst) != n:
            raise ValueError(f"list {k} holds {len(lst)} tensors, list 0 {n}")
        for t, ref in zip(lst, lists[0]):
            if t.numel() != ref.numel():
                raise ValueError(f"list {k}: a tensor of {t.numel()} elements "
                                 f"beside one of {ref.numel()}")
            if not t.is_contiguous():
                raise ValueError("the multi-tensor kernels take contiguous "
                                 "tensors")
            if t.dtype not in _CODES or (k >= fp32_from
                                         and t.dtype != torch.float32):
                raise TypeError(f"list {k}: dtype {t.dtype} (grads and "
                                f"params float32, bfloat16 or float16; "
                                f"slots, masters and updates float32)")


class TensorTable:
    """The launch records of up to ``MAX_LISTS`` parallel lists of tensors
    (and, optionally, each position's int32 step counter) on their CUDA
    device: one int64 buffer holding the records, each tensor's first
    global chunk (``n + 1`` words) and the step counters' addresses."""

    def __init__(self, lists: Sequence[Tensors],
                 steps: Optional[Tensors] = None):
        if not 1 <= len(lists) <= MAX_LISTS:
            raise ValueError(f"1 to {MAX_LISTS} lists, got {len(lists)}")
        self.device = lists[0][0].device
        sizes = [t.numel() for t in lists[0]]
        self.n = len(sizes)
        records = plan(sizes)
        self.n_records = len(records)
        chunk_counts = [_support.cdiv(s, CHUNK) for s in sizes]
        chunk_start = np.zeros(self.n + 1, np.int64)
        np.cumsum(chunk_counts, out=chunk_start[1:])
        self.n_chunks = int(chunk_start[-1])
        ptrs = np.array([[t.data_ptr() for t in lst] for lst in lists],
                        np.int64).reshape(len(lists), self.n)
        codes = np.array([[_CODES[t.dtype] for t in lst] for lst in lists],
                         np.int64).reshape(len(lists), self.n)
        step_ptrs = np.array([s.data_ptr() for s in steps] if steps
                             else [0] * self.n, np.int64)
        words = np.zeros((self.n_records, WORDS), np.int64)
        chunk0 = 0
        for r, (t0, nt, chunks) in enumerate(records):
            w = words[r]
            w[:4] = (nt, len(chunks), t0, chunk0)
            for k in range(len(lists)):
                base = k * MAX_TENSORS
                w[_ADDR + base:_ADDR + base + nt] = ptrs[k, t0:t0 + nt]
                w[_CODE + base:_CODE + base + nt] = codes[k, t0:t0 + nt]
            w[_SIZE:_SIZE + nt] = sizes[t0:t0 + nt]
            w[_STEP:_STEP + nt] = step_ptrs[t0:t0 + nt]
            cm = np.array(chunks, np.int64)
            w[_CHUNKS:_CHUNKS + len(chunks)] = (cm[:, 0] << 32) | cm[:, 1]
            chunk0 += len(chunks)
        flat = np.concatenate([words.ravel(), chunk_start, step_ptrs])
        self.buffer = torch.from_numpy(flat).to(self.device)
        self.records = self.buffer.data_ptr()
        self.chunk_start = self.records + 8 * words.size
        self.steps = self.chunk_start + 8 * (self.n + 1)
        self._counts = (ctypes.c_int * max(self.n_records, 1))(
            *[len(c) for _, _, c in records])
        self.counts = ctypes.addressof(self._counts)


def _key(lists: Sequence[Tensors], steps: Optional[Tensors]) -> tuple:
    return (tuple((t.data_ptr(), t.numel(), t.dtype)
                  for lst in lists for t in lst),
            tuple(s.data_ptr() for s in steps) if steps else None)


class TableCache:
    """The table of one caller's lists, rebuilt when any tensor's pointer,
    size or dtype (or a step counter's pointer) changes."""

    def __init__(self):
        self._key = None
        self._table: Optional[TensorTable] = None

    def get(self, lists: Sequence[Tensors],
            steps: Optional[Tensors] = None) -> TensorTable:
        key = _key(lists, steps)
        if self._table is None or key != self._key:
            self._table = TensorTable(lists, steps)
            self._key = key
        return self._table


# -- the per-tensor math (plain versions; the optimizers' _update) --------

def unscaled_fp32(grad: torch.Tensor,
                  grad_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """A gradient as fp32, multiplied by ``1 / grad_scale``."""
    g32 = grad.float()
    return g32 if grad_scale is None else g32 * (1.0 / grad_scale)


def commit(p: torch.Tensor, p32: torch.Tensor, step: torch.Tensor,
           new_step: torch.Tensor, master: Optional[torch.Tensor],
           slots: Dict[str, torch.Tensor], new_p: torch.Tensor,
           new_slots: Dict[str, torch.Tensor],
           skip: Optional[torch.Tensor]) -> None:
    """Write one tensor's update back in place: slots, step counter,
    master and the parameter in its own dtype; where ``skip`` (a device
    bool) is set, every value stays as it was."""
    if skip is not None:
        new_p = torch.where(skip, p32, new_p)
        new_slots = {k: torch.where(skip, slots[k], v)
                     for k, v in new_slots.items()}
        new_step = torch.where(skip, step, new_step)
    for k, v in new_slots.items():
        slots[k].copy_(v)
    step.copy_(new_step)
    if master is not None:
        master.copy_(new_p)
    p.copy_(new_p.to(p.dtype))


def _bias_corrections(betas, t, on: bool):
    b1, b2 = betas
    return (1.0 - b1 ** t, 1.0 - b2 ** t) if on else (1.0, 1.0)


def adam_update(g32, p32, m, v, t, lr, wd, betas, eps, adam_w_mode: bool,
                bias_correction: bool):
    """One Adam step of an fp32 tensor at step ``t`` (fp32, from 1):
    ``(new p, new exp_avg, new exp_avg_sq)``."""
    b1, b2 = betas
    bc1, bc2 = _bias_corrections(betas, t, bias_correction)
    if not adam_w_mode and wd != 0.0:
        g32 = g32 + wd * p32
    m = b1 * m + (1.0 - b1) * g32
    v = b2 * v + (1.0 - b2) * g32 * g32
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode and wd != 0.0:
        update = update + wd * p32
    return p32 - lr * update, m, v


def lamb_update(g32, p32, m, v, t, lr, wd, clip, betas, eps,
                adam_w_mode: bool, bias_correction: bool,
                grad_averaging: bool, adapt: bool, trust_clip: bool):
    """One LAMB step of an fp32 tensor, its gradient divided by ``clip``:
    ``(new p, new exp_avg, new exp_avg_sq, update)``; the trust ratio
    ``||p|| / ||update||`` applies where ``adapt``."""
    b1, b2 = betas
    bc1, bc2 = _bias_corrections(betas, t, bias_correction)
    beta3 = 1.0 - b1 if grad_averaging else 1.0
    g = g32 / clip
    if not adam_w_mode and wd != 0.0:
        g = g + wd * p32
    m = b1 * m + beta3 * g
    v = b2 * v + (1.0 - b2) * g * g
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode and wd != 0.0:
        update = update + wd * p32
    ratio = 1.0
    if adapt:
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        u_norm = torch.sqrt(torch.sum(update * update))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        if trust_clip:
            ratio = torch.clamp_max(ratio, 1.0)
    return p32 - lr * ratio * update, m, v, update


def lamb_clip(gnorm: Optional[torch.Tensor], max_grad_norm: float):
    """LAMB's divisor of every gradient: ``gnorm / max_grad_norm`` where the
    global norm exceeds it (``max_grad_norm > 0``), else 1."""
    if gnorm is None or max_grad_norm <= 0.0:
        return 1.0
    return torch.where(gnorm > max_grad_norm, gnorm / max_grad_norm,
                       torch.ones_like(gnorm))


def sgd_update(g32, p32, buf, t, lr, wd, momentum, dampening,
               nesterov: bool, wd_after_momentum: bool):
    """One SGD step of an fp32 tensor: ``(new p, new momentum buffer or
    None)``; at ``t == 1`` the buffer is set to the direction itself."""
    d_p = g32
    if wd != 0.0 and not wd_after_momentum:
        d_p = d_p + wd * p32
    if momentum != 0.0:
        buf = torch.where(t == 1, d_p,
                          momentum * buf + (1.0 - dampening) * d_p)
        d_p = d_p + momentum * buf if nesterov else buf
    if wd != 0.0 and wd_after_momentum:
        d_p = d_p + wd * p32
    return p32 - lr * d_p, buf


def scale_plain(grads: Tensors, scale: torch.Tensor) -> torch.Tensor:
    """amp's unscale in place (``LossScaler.unscale``): every finite
    gradient times ``1 / scale`` in fp32, a non-finite one 0, each cast
    back to its dtype; returns ``found_inf``, whether any input element
    was not finite (a device bool)."""
    inv = torch.reciprocal(scale.float())
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for g in grads:
        finite = torch.isfinite(g)
        found = found | ~finite.all()
        g.copy_(torch.where(finite, g.float() * inv, 0.0).to(g.dtype))
    return found


def l2norm_plain(tensors: Tensors,
                 grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(global L2 norm, per-tensor L2 norms)`` in fp32 (``global_norm``,
    ``utils/tree.py:35``), of the tensors times ``1 / grad_scale``."""
    sums = torch.stack([unscaled_fp32(t, grad_scale).square().sum()
                        for t in tensors])
    return sums.sum().sqrt(), sums.sqrt()


def _skip(found_inf):
    return None if found_inf is None else found_inf.to(torch.bool)


def adam_plain(grads, params, exp_avgs, exp_avg_sqs, steps, masters=None, *,
               lr, weight_decay, betas, eps, adam_w_mode, bias_correction,
               grad_scale=None, found_inf=None) -> None:
    """The plain version of :func:`multi_tensor_adam`: per tensor,
    :func:`adam_update` and :func:`commit` (torch ops on any device)."""
    skip = _skip(found_inf)
    for i, (g, p, m, v, s) in enumerate(zip(grads, params, exp_avgs,
                                            exp_avg_sqs, steps)):
        master = None if masters is None else masters[i]
        p32 = p.float() if master is None else master
        new_step = s + 1
        new_p, new_m, new_v = adam_update(
            unscaled_fp32(g, grad_scale), p32, m, v, new_step.float(), lr,
            weight_decay, betas, eps, adam_w_mode, bias_correction)
        commit(p, p32, s, new_step, master, {"exp_avg": m, "exp_avg_sq": v},
               new_p, {"exp_avg": new_m, "exp_avg_sq": new_v}, skip)


def lamb_plain(grads, params, exp_avgs, exp_avg_sqs, updates, steps,
               masters=None, *, lr, weight_decay, betas, eps, adam_w_mode,
               bias_correction, grad_averaging, gnorm, max_grad_norm,
               trust_clip, always_adapt, grad_scale=None,
               found_inf=None) -> None:
    """The plain version of :func:`multi_tensor_lamb`: per tensor,
    :func:`lamb_update` (clip :func:`lamb_clip`), the update into
    ``updates``, and :func:`commit`."""
    skip = _skip(found_inf)
    clip = lamb_clip(gnorm, max_grad_norm)
    adapt = weight_decay != 0.0 or always_adapt
    for i, (g, p, m, v, u, s) in enumerate(zip(grads, params, exp_avgs,
                                               exp_avg_sqs, updates, steps)):
        master = None if masters is None else masters[i]
        p32 = p.float() if master is None else master
        new_step = s + 1
        new_p, new_m, new_v, upd = lamb_update(
            unscaled_fp32(g, grad_scale), p32, m, v, new_step.float(), lr,
            weight_decay, clip, betas, eps, adam_w_mode, bias_correction,
            grad_averaging, adapt, trust_clip)
        u.copy_(upd)
        commit(p, p32, s, new_step, master, {"exp_avg": m, "exp_avg_sq": v},
               new_p, {"exp_avg": new_m, "exp_avg_sq": new_v}, skip)


def sgd_plain(grads, params, momentum_buffers, steps, masters=None, *, lr,
              weight_decay, momentum, dampening, nesterov, wd_after_momentum,
              grad_scale=None, found_inf=None) -> None:
    """The plain version of :func:`multi_tensor_sgd`: per tensor,
    :func:`sgd_update` and :func:`commit`."""
    skip = _skip(found_inf)
    for i, (g, p, s) in enumerate(zip(grads, params, steps)):
        master = None if masters is None else masters[i]
        buf = None if momentum_buffers is None else momentum_buffers[i]
        p32 = p.float() if master is None else master
        new_step = s + 1
        new_p, new_buf = sgd_update(
            unscaled_fp32(g, grad_scale), p32, buf, new_step.float(), lr,
            weight_decay, momentum, dampening, nesterov, wd_after_momentum)
        slots = {} if buf is None else {"momentum_buffer": buf}
        new_slots = {} if buf is None else {"momentum_buffer": new_buf}
        commit(p, p32, s, new_step, master, slots, new_p, new_slots, skip)


# -- the kernel wrappers -------------------------------------------------

def _cpu(*lists) -> bool:
    return _support.is_cpu(*(t for lst in lists if lst for t in lst))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _device_scalar(t: Optional[torch.Tensor], dtype, device):
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{t.device} scalar for tensors on {device}")
    return t.detach().to(dtype).contiguous()


def _lr(lr, device):
    """``(value, device tensor or None)`` of a group's lr: a Python number,
    or a 0-dim tensor the kernel reads on the device."""
    if isinstance(lr, torch.Tensor):
        return 0.0, _device_scalar(lr, torch.float32, device)
    return float(lr), None


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _l2norm_table(table: TensorTable, list_index: int,
                  scale: Optional[torch.Tensor], per_tensor: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    lib = _build.library()
    dev = table.device
    partial = torch.empty(max(table.n_chunks, 1), dtype=torch.float32,
                          device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    norms = (torch.empty(table.n, dtype=torch.float32, device=dev)
             if per_tensor else None)
    stream = _stream(dev)
    status = lib.apex_mt_l2norm(table.records, table.counts,
                                table.n_records, stream, list_index,
                                _ptr(scale), partial.data_ptr())
    _build.check("apex_mt_l2norm", status)
    status = lib.apex_mt_l2norm_finish(table.chunk_start, partial.data_ptr(),
                                       table.n, _ptr(norms),
                                       total.data_ptr(), stream)
    _build.check("apex_mt_l2norm_finish", status)
    _support.count_launch("multi_tensor_l2norm", table.n_records + 1)
    return total, norms


def _bump(table: TensorTable, found: Optional[torch.Tensor],
          counter: str) -> None:
    status = _build.library().apex_mt_bump(table.steps, table.n,
                                           _stream(table.device),
                                           _ptr(found))
    _build.check("apex_mt_bump", status)
    _support.count_launch(counter)


def multi_tensor_scale(grads: Tensors, scale: torch.Tensor, *,
                       cache: Optional[TableCache] = None) -> torch.Tensor:
    """Unscale ``grads`` in place by the loss scale ``scale`` (a 0-dim
    fp32 tensor) and return ``found_inf``; see :func:`scale_plain`."""
    grads = list(grads)
    if not grads or _cpu(grads, [scale]):
        return scale_plain(grads, scale)
    _check_lists([grads], 1)
    dev = grads[0].device
    table = (cache or TableCache()).get([grads])
    found = torch.zeros((), dtype=torch.bool, device=dev)
    scale = _device_scalar(scale, torch.float32, dev)
    status = _build.library().apex_mt_scale(
        table.records, table.counts, table.n_records, _stream(dev),
        scale.data_ptr(), found.data_ptr())
    _build.check("apex_mt_scale", status)
    _support.count_launch("multi_tensor_scale", table.n_records)
    return found


def multi_tensor_l2norm(tensors: Tensors, *,
                        grad_scale: Optional[torch.Tensor] = None,
                        per_tensor: bool = False,
                        cache: Optional[TableCache] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(global norm, per-tensor norms or None)`` of ``tensors`` (times
    ``1 / grad_scale``), fp32 on their device; see :func:`l2norm_plain`."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("multi_tensor_l2norm of an empty list")
    if _cpu(tensors, [grad_scale] if grad_scale is not None else []):
        total, norms = l2norm_plain(tensors, grad_scale)
        return total, norms if per_tensor else None
    _check_lists([tensors], 1)
    dev = tensors[0].device
    table = (cache or TableCache()).get([tensors])
    return _l2norm_table(table, 0,
                         _device_scalar(grad_scale, torch.float32, dev),
                         per_tensor)


def _prepare(lists, fp32_from, steps, grad_scale, found_inf, cache):
    _check_lists(lists, fp32_from)
    dev = lists[0][0].device
    table = (cache or TableCache()).get(lists, steps)
    scale = _device_scalar(grad_scale, torch.float32, dev)
    found = _device_scalar(found_inf, torch.bool, dev)
    return dev, table, scale, found


def multi_tensor_adam(grads: Tensors, params: Tensors, exp_avgs: Tensors,
                      exp_avg_sqs: Tensors, steps: Tensors,
                      masters: Optional[Tensors] = None, *, lr, weight_decay,
                      betas, eps, adam_w_mode: bool, bias_correction: bool,
                      grad_scale: Optional[torch.Tensor] = None,
                      found_inf: Optional[torch.Tensor] = None,
                      cache: Optional[TableCache] = None) -> None:
    """One FusedAdam step of every tensor in place (``exp_avgs``,
    ``exp_avg_sqs`` and ``masters`` fp32; ``steps`` each tensor's int32
    counter, bumped unless ``found_inf``), as :func:`adam_update` and
    :func:`commit` do it per tensor."""
    lists = [list(grads), list(params), list(exp_avgs), list(exp_avg_sqs)]
    if masters is not None:
        lists.append(list(masters))
    if not lists[0]:
        return
    if _cpu(*lists, steps):
        return adam_plain(grads, params, exp_avgs, exp_avg_sqs, steps,
                          masters, lr=lr, weight_decay=weight_decay,
                          betas=betas, eps=eps, adam_w_mode=adam_w_mode,
                          bias_correction=bias_correction,
                          grad_scale=grad_scale, found_inf=found_inf)
    dev, table, scale, found = _prepare(lists, 2, steps, grad_scale,
                                        found_inf, cache)
    lr_v, lr_t = _lr(lr, dev)
    b1, b2 = betas
    status = _build.library().apex_mt_adam(
        table.records, table.counts, table.n_records, _stream(dev),
        4 if masters is not None else -1, lr_v, _ptr(lr_t), _ptr(scale),
        _ptr(found), float(weight_decay), b1, b2, 1.0 - b1, 1.0 - b2,
        float(eps), int(adam_w_mode), int(bias_correction))
    _build.check("apex_mt_adam", status)
    _support.count_launch("multi_tensor_adam", table.n_records)
    _bump(table, found, "multi_tensor_adam")


def multi_tensor_lamb(grads: Tensors, params: Tensors, exp_avgs: Tensors,
                      exp_avg_sqs: Tensors, updates: Tensors, steps: Tensors,
                      masters: Optional[Tensors] = None, *, lr, weight_decay,
                      betas, eps, adam_w_mode: bool, bias_correction: bool,
                      grad_averaging: bool, gnorm: Optional[torch.Tensor],
                      max_grad_norm: float, trust_clip: bool,
                      always_adapt: bool,
                      grad_scale: Optional[torch.Tensor] = None,
                      found_inf: Optional[torch.Tensor] = None,
                      cache: Optional[TableCache] = None) -> None:
    """One FusedLAMB step of every tensor in place, as
    :func:`lamb_update` does it per tensor: ``gnorm`` is the global norm of
    the unscaled gradients (:func:`multi_tensor_l2norm`), the clip
    :func:`lamb_clip`; ``updates`` are fp32 buffers that receive each
    tensor's update. On the card: stage 1 (moments and update), the
    l2norms of p and of the update per tensor where the ratio applies,
    stage 2 (the trust-ratio step), then the step counters."""
    lists = [list(grads), list(params), list(exp_avgs), list(exp_avg_sqs),
             list(updates)]
    if masters is not None:
        lists.append(list(masters))
    if not lists[0]:
        return
    adapt = weight_decay != 0.0 or always_adapt
    if _cpu(*lists, steps):
        return lamb_plain(grads, params, exp_avgs, exp_avg_sqs, updates,
                          steps, masters, lr=lr, weight_decay=weight_decay,
                          betas=betas, eps=eps, adam_w_mode=adam_w_mode,
                          bias_correction=bias_correction,
                          grad_averaging=grad_averaging, gnorm=gnorm,
                          max_grad_norm=max_grad_norm, trust_clip=trust_clip,
                          always_adapt=always_adapt, grad_scale=grad_scale,
                          found_inf=found_inf)
    dev, table, scale, found = _prepare(lists, 2, steps, grad_scale,
                                        found_inf, cache)
    gnorm = (None if max_grad_norm <= 0.0
             else _device_scalar(gnorm, torch.float32, dev))
    lib = _build.library()
    stream = _stream(dev)
    master_list = 5 if masters is not None else -1
    b1, b2 = betas
    max_f = float(np.float32(max_grad_norm))
    inv_max = float(np.float32(1.0) / np.float32(max_grad_norm)) \
        if max_grad_norm > 0.0 else 0.0
    status = lib.apex_mt_lamb_stage1(
        table.records, table.counts, table.n_records, stream, master_list,
        _ptr(scale), _ptr(found), float(weight_decay), b1, b2,
        1.0 - b1 if grad_averaging else 1.0, 1.0 - b2, float(eps),
        int(adam_w_mode), int(bias_correction), _ptr(gnorm), max_f, inv_max)
    _build.check("apex_mt_lamb_stage1", status)
    w_norm = u_norm = None
    if adapt:
        _, w_norm = _l2norm_table(table, 1 if masters is None else 5, None,
                                  True)
        _, u_norm = _l2norm_table(table, 4, None, True)
    lr_v, lr_t = _lr(lr, dev)
    status = lib.apex_mt_lamb_stage2(
        table.records, table.counts, table.n_records, stream, master_list,
        lr_v, _ptr(lr_t), _ptr(found), _ptr(w_norm), _ptr(u_norm),
        int(adapt), int(trust_clip))
    _build.check("apex_mt_lamb_stage2", status)
    _support.count_launch("multi_tensor_lamb", 2 * table.n_records)
    _bump(table, found, "multi_tensor_lamb")


def multi_tensor_sgd(grads: Tensors, params: Tensors,
                     momentum_buffers: Optional[Tensors], steps: Tensors,
                     masters: Optional[Tensors] = None, *, lr, weight_decay,
                     momentum: float, dampening: float, nesterov: bool,
                     wd_after_momentum: bool,
                     grad_scale: Optional[torch.Tensor] = None,
                     found_inf: Optional[torch.Tensor] = None,
                     cache: Optional[TableCache] = None) -> None:
    """One FusedSGD step of every tensor in place, as :func:`sgd_update`
    does it per tensor (``momentum_buffers`` fp32, None without
    momentum)."""
    lists = [list(grads), list(params)]
    if momentum_buffers is not None:
        lists.append(list(momentum_buffers))
    if masters is not None:
        lists.append(list(masters))
    if not lists[0]:
        return
    buf_list = 2 if momentum_buffers is not None else -1
    master_list = len(lists) - 1 if masters is not None else -1
    if _cpu(*lists, steps):
        return sgd_plain(grads, params, momentum_buffers, steps, masters,
                         lr=lr, weight_decay=weight_decay, momentum=momentum,
                         dampening=dampening, nesterov=nesterov,
                         wd_after_momentum=wd_after_momentum,
                         grad_scale=grad_scale, found_inf=found_inf)
    dev, table, scale, found = _prepare(lists, 2, steps, grad_scale,
                                        found_inf, cache)
    lr_v, lr_t = _lr(lr, dev)
    status = _build.library().apex_mt_sgd(
        table.records, table.counts, table.n_records, _stream(dev), buf_list,
        master_list, lr_v, _ptr(lr_t), _ptr(scale), _ptr(found),
        float(weight_decay), float(momentum), 1.0 - dampening,
        int(nesterov), int(wd_after_momentum))
    _build.check("apex_mt_sgd", status)
    _support.count_launch("multi_tensor_sgd", table.n_records)
    _bump(table, found, "multi_tensor_sgd")
