"""FusedMixedPrecisionLamb.

Counterpart of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py`` (the
semantics of ``apex.optimizers.FusedMixedPrecisionLamb``): LAMB with fp32
master weights held by the optimizer and the grads unscaled inside the step
(``grad_scale`` / ``found_inf``). ``use_nvlamb`` adapts every tensor
(``always_adapt``). On the card it runs FusedLAMB's multi-tensor kernels.
``step`` and ``reduced_precision_dtype`` are accepted for the reference's
signature: each tensor's step lives in its state, and the parameters keep
their own dtype.
"""

from __future__ import annotations

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedMixedPrecisionLamb"]


class FusedMixedPrecisionLamb(FusedLAMB):
    def __init__(self, params, lr: float = 1e-3, step: int = 0,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 reduced_precision_dtype=None):
        super().__init__(
            params, lr=lr, bias_correction=bias_correction, betas=betas,
            eps=eps, weight_decay=weight_decay, amsgrad=amsgrad,
            grad_averaging=grad_averaging, max_grad_norm=max_grad_norm,
            always_adapt=use_nvlamb, master_weights=True)
        self.reduced_precision_dtype = reduced_precision_dtype
