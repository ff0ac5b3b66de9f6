"""Kernel dispatch support for the PyTorch port.

Counterpart of ``apex_tpu/ops/_support.py``. The JAX package picks Pallas
or a plain ``jnp`` path from the backend (or ``APEX_TPU_FORCE_PALLAS``);
here the choice follows the tensors alone:

- a tensor on the CPU takes the op's plain PyTorch version;
- a tensor on a CUDA device launches the hand-written Hopper kernel, or
  the wrapper raises. There is no fallback from a failed launch and no
  switch that forces the plain path on the card.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run
can show that its main path went through the kernels; Kernel C's also
counts them by launch plan in :data:`DECODE_PLANS`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Union

import torch

from apex_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "DECODE_PLANS", "reset_launches", "count_launch", "resolve_device",
           "is_cpu", "forward_only", "cdiv", "round_up", "dtype_code",
           "sm_count", "blocks_per_sm"]

#: launches per kernel since the last :func:`reset_launches` — a wrapper
#: adds one where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {"layer_norm_fwd": 0, "layer_norm_bwd": 0,
                            "flash_fwd": 0, "flash_bwd": 0,
                            "flash_packed_fwd": 0, "flash_packed_bwd": 0,
                            "paged_decode": 0, "softmax_fwd": 0,
                            "softmax_bwd": 0, "conv1x1_fwd": 0,
                            "conv1x1_bwd": 0, "conv3x3_fwd": 0,
                            "conv3x3_bwd": 0, "multi_tensor_scale": 0,
                            "multi_tensor_l2norm": 0, "multi_tensor_adam": 0,
                            "multi_tensor_lamb": 0, "multi_tensor_sgd": 0}
#: Kernel C's launches since the last :func:`reset_launches`, by the
#: ``DecodePlan`` each took (ops/decode_attention.py), so a run can show
#: which of its paths (vector or element) it went through
DECODE_PLANS: collections.Counter = collections.Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    DECODE_PLANS.clear()


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.
    A CUDA device on a machine without one raises instead of quietly
    running on the CPU — pass ``device="cpu"`` to ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" means the current card: name it, so a tensor's device
        # (always indexed) compares equal to the one asked for
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on the CPU, False when every one
    lies on one CUDA device; raises on a mix or on another device type."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")


def forward_only(op: str, why: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need a backward that does not exist:
    paged decode is inference only, in the JAX package too. ``why`` says
    so."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward-only in apex_tpu_torch ({why}); call it under "
            f"torch.no_grad()")


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


#: dtype codes shared with the C entry points in ``csrc/common.cuh``
#: (``DType``: kF32, kBF16, kF16), which every kernel takes (Kernels A-M)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype, kernel: str) -> int:
    """The C dtype code of ``dtype`` (a key of ``_DTYPE_CODES``). Raises
    TypeError for any other dtype (and names ``kernel``): a tensor never
    reaches a kernel without a path for its type, where its bytes would
    be read as another type's."""
    if dtype in _DTYPE_CODES:
        return _DTYPE_CODES[dtype]
    names = ", ".join(str(d).replace("torch.", "") for d in _DTYPE_CODES)
    raise TypeError(f"{kernel} takes {names}, got {dtype}")


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: int, name: str, *args: int) -> int:
    """Resident blocks an SM of a kernel on CUDA device ``device``, from
    its C occupancy query ``name`` (``args`` before the out pointer),
    asked once per configuration."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = getattr(_build.library(), name)(*args, ctypes.addressof(out))
    _build.check(name, status)
    if out.value < 1:
        raise RuntimeError(f"{name}{args}: no block fits on an SM")
    return out.value
