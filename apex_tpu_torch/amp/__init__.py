"""Mixed-precision training (counterpart of ``apex_tpu.amp``): a precision
policy applied at function boundaries, a dynamic loss scaler whose state
stays on the device, the O0-O3 frontend and the loss-scaling flow. On the
card the unscale is the ``multi_tensor_scale`` kernel and the optimizers'
steps are multi-tensor kernels that take its ``found_inf``. ``amp.fp8``
is fp8 delayed scaling and ``fp8_dense``."""

from apex_tpu_torch.amp.frontend import (
    OPT_LEVELS,
    AmpState,
    Properties,
    initialize,
    load_state_dict,
    state_dict,
)
from apex_tpu_torch.amp.handle import (
    apply_if_finite,
    scale_loss,
    unscale_and_update,
)
from apex_tpu_torch.amp.policy import (
    Policy,
    disable_casts,
    float_function,
    half_function,
    master_params,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState, all_finite
from apex_tpu_torch.amp import fp8

__all__ = ["fp8", "Policy", "disable_casts", "half_function", "float_function",
           "master_params", "promote_function", "register_float_function",
           "register_half_function", "register_promote_function",
           "LossScaler", "LossScalerState", "all_finite", "AmpState",
           "Properties", "initialize", "state_dict", "load_state_dict",
           "OPT_LEVELS", "scale_loss", "unscale_and_update",
           "apply_if_finite"]
