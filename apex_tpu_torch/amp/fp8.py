"""fp8 delayed scaling: amax tracking, scales, quantize hooks and
``fp8_dense`` (counterpart of ``apex_tpu/amp/fp8.py``).

The recipe is TransformerEngine's delayed scaling, as the JAX package
implements it:

- per-tensor state ``{"amax_history": [H] f32, "scale": [] f32}``, a plain
  dict of tensors on the device, threaded through the step by the caller;
- quantization clips ``x * scale`` to the storage dtype's range in fp32
  and casts: e4m3 (``E4M3``) for forward operands, e5m2 (``E5M2``) for
  gradients;
- :func:`fp8_dense` runs either the qdq simulation (values round-trip
  through fp8 and come back in ``x``'s dtype before an ordinary matmul) or
  the native path, where the products run on the fp8 storage values with
  fp32 accumulation. On a CUDA tensor the native products are
  ``torch._scaled_mm`` on Hopper's fp8 tensor cores, with unit scales and
  an fp32 output; the division by the scales follows in torch, in the JAX
  package's order. On a CPU tensor they are the plain version:
  :func:`fp8_matmul_plain`, the fp8 operands upcast to fp32 and multiplied.
  The JAX package computes these products with ``lax.dot_general``, outside
  any Pallas kernel, so no hand kernel stands here. Hopper's fp8 MMA keeps
  about 13 fraction bits in its accumulator between fp32 promotions, so
  on the card the native products lie up to ~2^-12.6 of their sums of
  |products| from the plain version's (``tools/fp8_products.py``).

``reduce_amaxes`` is the identity: the port has no mesh or process group
yet, as the JAX function is the identity outside ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops._support import is_cpu, resolve_device, round_up

__all__ = [
    "Fp8Recipe",
    "E4M3",
    "E5M2",
    "fp8_max",
    "init_fp8_state",
    "compute_amax",
    "reduce_amaxes",
    "update_fp8_state",
    "quantize",
    "dequantize",
    "qdq",
    "fp8_dense",
    "fp8_matmul",
    "fp8_matmul_plain",
    "native_fp8_dot_supported",
]

# Storage dtypes: e4m3 for forward activations/weights (more mantissa),
# e5m2 for backward gradients (more range) — the standard hybrid recipe.
E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

_FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}

#: ``torch._scaled_mm`` takes the contraction and output widths in
#: multiples of 16; ragged dims are padded with zeros (exact)
_MM_ALIGN = 16


def fp8_max(dtype) -> float:
    """Largest finite value representable in the fp8 storage dtype."""
    return _FP8_MAX[dtype]


@dataclasses.dataclass(frozen=True)
class Fp8Recipe:
    """Delayed-scaling hyperparameters (TE ``DelayedScaling`` semantics)."""

    margin: int = 0                    # scale headroom: 2**margin
    amax_history_len: int = 16         # rolling window of per-step amaxes
    amax_compute_algo: str = "max"     # "max" over window | "most_recent"
    fwd_dtype: Any = E4M3
    bwd_dtype: Any = E5M2

    def __post_init__(self):
        if self.amax_history_len < 1:
            raise ValueError("amax_history_len must be >= 1")
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError(
                f"amax_compute_algo must be 'max' or 'most_recent', got "
                f"{self.amax_compute_algo!r}")


def init_fp8_state(names: Sequence[str],
                   recipe: Fp8Recipe = Fp8Recipe(), *,
                   device: Union[str, torch.device, None] = "cuda"
                   ) -> Dict[str, Any]:
    """State dict: one ``{"amax_history": [H], "scale": []}`` per tensor
    name on ``device``. Scales start at 1.0 (identity until the first
    update)."""
    dev = resolve_device(device)
    return {
        n: {
            "amax_history": torch.zeros(recipe.amax_history_len,
                                        dtype=torch.float32, device=dev),
            "scale": torch.ones((), dtype=torch.float32, device=dev),
        }
        for n in names
    }


def compute_amax(x: torch.Tensor) -> torch.Tensor:
    """Current-step absolute maximum (fp32 scalar)."""
    return x.detach().abs().max().to(torch.float32)


def reduce_amaxes(amaxes, axis_names: Optional[Sequence[str]] = None):
    """The identity. The JAX function takes the max of each amax over the
    amax-reduction mesh axes inside ``shard_map`` and is the identity
    outside it; the port has no mesh or process group yet (ROADMAP §1,
    parallelism), so every amax is already the whole tensor's."""
    del axis_names
    return amaxes


def _over(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` in fp32, correctly rounded. (A Python number over a
    tensor is the tensor's reciprocal times the number in torch, which can
    be an ulp off IEEE division.)"""
    return torch.full_like(den, num) / den


def _new_scale(history: torch.Tensor, old_scale: torch.Tensor,
               recipe: Fp8Recipe, dtype) -> torch.Tensor:
    amax = (history.max() if recipe.amax_compute_algo == "max"
            else history[0])
    sf = _over(fp8_max(dtype), amax * (2.0 ** recipe.margin))
    # amax == 0 (nothing observed yet) or non-finite keeps the previous
    # scale; requiring sf > 0 also rejects amax = inf -> sf = 0.0
    return torch.where(torch.isfinite(amax) & (sf > 0.0) & torch.isfinite(sf),
                       sf, old_scale)


@torch.no_grad()
def update_fp8_state(state: Dict[str, Any], amaxes: Dict[str, torch.Tensor],
                     recipe: Fp8Recipe = Fp8Recipe(), *,
                     axis_names: Optional[Sequence[str]] = None,
                     dtypes: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One delayed-scaling step: reduce this step's ``amaxes``, roll each
    history window, recompute scales. Returns new tensors; ``state`` is
    left as it was.

    ``dtypes`` optionally maps tensor name -> storage dtype (default:
    ``recipe.fwd_dtype``; pass ``recipe.bwd_dtype`` for gradient tensors).
    """
    amaxes = reduce_amaxes(amaxes, axis_names)
    new = {}
    for name, s in state.items():
        # an overflow step records 0, not inf: an inf would pin the window
        # max (the scale frozen for the whole history) and fp8_max / inf
        # = 0 would NaN every dequantize
        a = torch.as_tensor(amaxes[name], dtype=torch.float32,
                            device=s["amax_history"].device)
        a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        hist = torch.roll(s["amax_history"], 1)
        hist[0] = a
        dt = (dtypes or {}).get(name, recipe.fwd_dtype)
        new[name] = {
            "amax_history": hist,
            "scale": _new_scale(hist, s["scale"], recipe, dt),
        }
    return new


def quantize(x: torch.Tensor, scale: torch.Tensor,
             dtype=E4M3) -> torch.Tensor:
    """Scale into the fp8 representable range and cast to storage dtype."""
    clipped = torch.clamp(x.to(torch.float32) * scale,
                          -fp8_max(dtype), fp8_max(dtype))
    return clipped.to(dtype)


def dequantize(xq: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (xq.to(torch.float32) / scale).to(dtype)


def qdq(x: torch.Tensor, scale: torch.Tensor, dtype=E4M3) -> torch.Tensor:
    """Quantize-dequantize: fp8 rounding applied, original dtype
    returned."""
    return dequantize(quantize(x, scale, dtype), scale, x.dtype)


@functools.lru_cache(maxsize=None)
def _native_supported(device: torch.device) -> bool:
    if device.type == "cpu":
        return True
    return (hasattr(torch, "_scaled_mm")
            and torch.cuda.get_device_capability(device) >= (8, 9))


def native_fp8_dot_supported(device: Union[str, torch.device, None] = "cuda"
                             ) -> bool:
    """Whether products on fp8 storage dtypes run on ``device``: True on
    the CPU, where :func:`fp8_matmul_plain` computes the native path's
    numbers (as XLA's CPU backend does for the JAX package), and on a card
    with fp8 tensor cores (compute capability 8.9 or later: Ada, Hopper),
    where ``torch._scaled_mm`` runs. Cached per device."""
    return _native_supported(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _log_fp8_path_once(native: bool) -> None:
    """One-time notice of which fp8 dot path the auto-probe selected: the
    native and qdq paths round at different points, so the same model
    gives tolerance-level different losses on the two. Pass ``native=``
    explicitly to pin a path and silence this."""
    from apex_tpu_torch.utils.logging import get_logger

    get_logger().warning(
        "fp8_dense auto-probe selected the %s path on this backend "
        "(native and qdq round at different points; pass native= to pin)",
        "native-fp8 dot" if native else "qdq simulation")


def fp8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of an fp8 product: ``a [M, K] @ b [K, N]`` on fp8
    storage values, upcast to fp32 and multiplied in fp32."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:r, :c] = t
    return out


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` on fp8 storage values with fp32 accumulation
    and an fp32 result. On the CPU: :func:`fp8_matmul_plain`. On a card:
    ``torch._scaled_mm`` at unit scales, K and N padded with zeros to
    multiples of 16 and ``b`` laid out column-major, as it requires."""
    if is_cpu(a, b):
        return fp8_matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    kp, np_ = round_up(k, _MM_ALIGN), round_up(n, _MM_ALIGN)
    a = _pad(a, m, kp).contiguous()
    b = _pad(b, kp, np_).t().contiguous().t()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(a, b, one, one, out_dtype=torch.float32)
    return out[:, :n]


class _NativeFp8Matmul(torch.autograd.Function):
    """``y = (q(x) @ q(w)) / (xs * ws)`` with the product on the fp8
    storage dtypes (the native path). Forward operands are e4m3; the
    backward quantizes the incoming cotangent to e5m2 with current scaling
    and runs both grad products on fp8 operands too (TE hybrid recipe)."""

    @staticmethod
    def forward(ctx, x, w, xs, ws, recipe):
        xq = quantize(x, xs, recipe.fwd_dtype)
        wq = quantize(w, ws, recipe.fwd_dtype)
        x2 = xq.reshape(-1, x.shape[-1])
        y = fp8_matmul(x2, wq).reshape(*x.shape[:-1], w.shape[-1])
        ctx.save_for_backward(x2, wq, xs, ws)
        ctx.recipe = recipe
        ctx.dtypes = (x.dtype, w.dtype)
        return (y / (xs * ws)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, wq, xs, ws = ctx.saved_tensors
        recipe = ctx.recipe
        xdt, wdt = ctx.dtypes
        amax = g.abs().max().to(torch.float32)
        gs = torch.where((amax > 0.0) & torch.isfinite(amax),
                         _over(fp8_max(recipe.bwd_dtype), amax),
                         torch.ones_like(amax))
        gq = quantize(g, gs, recipe.bwd_dtype)
        g2 = gq.reshape(-1, g.shape[-1])
        # dx = g @ w^T ; dw = x^T @ g over the flattened lead dims — both
        # on fp8 operands
        dx = fp8_matmul(g2, wq.t()).reshape(*g.shape[:-1], wq.shape[0])
        dx = (dx / (gs * ws)).to(xdt)
        dw = fp8_matmul(x2.t(), g2)
        dw = (dw / (xs * gs)).to(wdt)
        return dx, dw, None, None, None


class _SteQdq(torch.autograd.Function):
    """qdq with a straight-through backward: d qdq/dx ~= 1 (no cotangent
    into the scale, which is statistics-driven, not loss-driven). The
    cotangent itself is e5m2-simulated with current scaling when a
    ``bwd_dtype`` is set."""

    @staticmethod
    def forward(ctx, x, scale, dtype, bwd_dtype):
        ctx.bwd_dtype = bwd_dtype
        return qdq(x, scale, dtype)

    @staticmethod
    def backward(ctx, g):
        bwd_dtype = ctx.bwd_dtype
        if bwd_dtype is not None:
            amax = g.abs().max().to(torch.float32)
            gs = torch.where((amax > 0.0) & torch.isfinite(amax),
                             _over(fp8_max(bwd_dtype), amax),
                             torch.ones_like(amax))
            g = qdq(g, gs, bwd_dtype)
        return g, None, None, None


def _ste_qdq(x, scale, dtype, bwd_dtype=None):
    return _SteQdq.apply(x, scale, dtype, bwd_dtype)


def fp8_dense(x: torch.Tensor, w: torch.Tensor, state: Dict[str, Any],
              *, x_name: str = "x", w_name: str = "w",
              recipe: Fp8Recipe = Fp8Recipe(),
              axis_names: Optional[Sequence[str]] = None,
              native: Optional[bool] = None
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """fp8 delayed-scaling matmul hook: ``y = qdq(x) @ qdq(w)`` with the
    CURRENT scales, returning ``(y, new_state)`` where the state absorbed
    this step's amaxes. Scales trail the data by one step, exactly TE
    delayed scaling:

        y, fp8_state = fp8.fp8_dense(x, w, fp8_state)

    The backward: quantization itself is straight-through, and the
    incoming cotangent is quantized to ``recipe.bwd_dtype`` (e5m2) with
    *current* scaling — its scale from the cotangent's own amax on the
    spot, since the backward cannot thread delayed state out.

    ``native`` routes the product through the fp8 storage dtypes
    (:func:`fp8_matmul`: ``torch._scaled_mm`` on a card) instead of the
    qdq simulation; ``None`` asks :func:`native_fp8_dot_supported` for
    ``x``'s device. Both paths share the state machinery and accumulate in
    fp32.
    """
    xs = state[x_name]["scale"]
    ws = state[w_name]["scale"]
    if native is None:
        native = native_fp8_dot_supported(x.device)
        _log_fp8_path_once(native)
    if native:
        y = _NativeFp8Matmul.apply(x, w, xs, ws, recipe)
    else:
        xq = _ste_qdq(x, xs, recipe.fwd_dtype, recipe.bwd_dtype)
        wq = _ste_qdq(w, ws, recipe.fwd_dtype, recipe.bwd_dtype)
        y = xq @ wq
    new_state = dict(state)
    upd = update_fp8_state(
        {x_name: state[x_name], w_name: state[w_name]},
        {x_name: compute_amax(x), w_name: compute_amax(w)},
        recipe, axis_names=axis_names)
    new_state.update(upd)
    return y, new_state
