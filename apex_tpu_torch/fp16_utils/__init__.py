"""Manual mixed precision (counterpart of ``apex_tpu.fp16_utils``)."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.fp16util import (
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
)
from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, LossScaler

__all__ = ["convert_network", "network_to_half", "prep_param_lists",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "FP16_Optimizer", "LossScaler", "DynamicLossScaler"]
