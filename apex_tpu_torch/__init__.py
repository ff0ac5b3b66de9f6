"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

A package beside ``apex_tpu`` with the same module layout
(``ops/``, ``normalization/``, ``models/``, ``serving/``, ...). Every
Pallas kernel of the JAX package becomes a hand-written Hopper kernel under
``csrc/``, built with ``nvcc`` on first use (:mod:`apex_tpu_torch.ops._build`)
and launched through ctypes; a plain PyTorch version sits beside each
kernel and runs for tensors on the CPU.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
This package imports neither ``jax`` nor ``apex_tpu``.
"""

from apex_tpu_torch import (
    amp,
    checkpoint,
    fp16_utils,
    multi_tensor_apply,
    resilience,
)

__version__ = "0.1.0"

__all__ = ["amp", "checkpoint", "fp16_utils", "multi_tensor_apply",
           "resilience", "__version__"]
