"""The amp opt-level frontend.

Counterpart of ``apex_tpu/amp/frontend.py``: :func:`initialize` returns
an :class:`AmpState` bundling the precision :class:`Policy`, a loss scaler
with one state per loss (``num_losses``) and the opt level's properties,
with apex's override rules (explicit keywords win over the level's
defaults). The levels, with bf16 the default half type:

- **O0** — fp32 everything; loss scale 1.
- **O1** — fp32 params, half compute at function boundaries (the policy's
  ``wrap``); dynamic loss scale.
- **O2** — half params and compute, fp32 master weights in the optimizer,
  fp32 batch norm, dynamic loss scale.
- **O3** — half everything, no master weights, loss scale 1.

The scaler states live on ``device`` (the card unless asked for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.utils.logging import get_logger

__all__ = ["Properties", "OPT_LEVELS", "AmpState", "initialize",
           "state_dict", "load_state_dict"]

logger = get_logger(__name__)


@dataclasses.dataclass
class Properties:
    """apex's amp ``Properties``."""

    enabled: bool = False
    opt_level: Optional[str] = None
    cast_model_type: Optional[Any] = None
    cast_ops: bool = False              # "patch_torch_functions"
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Any = 1.0


def _o0() -> Properties:
    return Properties(enabled=True, opt_level="O0",
                      cast_model_type=torch.float32, cast_ops=False,
                      keep_batchnorm_fp32=None, master_weights=False,
                      loss_scale=1.0)


def _o1() -> Properties:
    return Properties(enabled=True, opt_level="O1", cast_model_type=None,
                      cast_ops=True, keep_batchnorm_fp32=None,
                      master_weights=False, loss_scale="dynamic")


def _o2() -> Properties:
    return Properties(enabled=True, opt_level="O2",
                      cast_model_type=torch.bfloat16, cast_ops=False,
                      keep_batchnorm_fp32=True, master_weights=True,
                      loss_scale="dynamic")


def _o3() -> Properties:
    return Properties(enabled=True, opt_level="O3",
                      cast_model_type=torch.bfloat16, cast_ops=False,
                      keep_batchnorm_fp32=False, master_weights=False,
                      loss_scale=1.0)


OPT_LEVELS = {"O0": _o0, "O1": _o1, "O2": _o2, "O3": _o3}


@dataclasses.dataclass
class AmpState:
    properties: Properties
    policy: Policy
    scaler: LossScaler
    scaler_states: List[LossScalerState]

    @property
    def loss_scale(self) -> torch.Tensor:
        return self.scaler_states[0].loss_scale


def initialize(opt_level: str = "O1", *, half_dtype=torch.bfloat16,
               cast_model_type=None, keep_batchnorm_fp32: Optional[bool] = None,
               master_weights: Optional[bool] = None, loss_scale: Any = None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24, num_losses: int = 1,
               device=None) -> AmpState:
    """Amp state for an opt level; explicit keywords override the level's
    properties."""
    if opt_level not in OPT_LEVELS:
        raise ValueError(f"Unexpected optimization level {opt_level!r}; "
                         f"options are 'O0', 'O1', 'O2', 'O3'")
    props = OPT_LEVELS[opt_level]()
    if cast_model_type is not None:
        props.cast_model_type = cast_model_type
    if keep_batchnorm_fp32 is not None:
        props.keep_batchnorm_fp32 = keep_batchnorm_fp32
    if master_weights is not None:
        props.master_weights = master_weights
    if loss_scale is not None:
        props.loss_scale = loss_scale
    if props.cast_model_type == torch.bfloat16 and \
            half_dtype != torch.bfloat16:
        props.cast_model_type = half_dtype

    if props.opt_level == "O0":
        policy = Policy(torch.float32, torch.float32, torch.float32)
    elif props.opt_level == "O1":
        policy = Policy(torch.float32, half_dtype, torch.float32)
    else:  # O2, O3
        policy = Policy(half_dtype, half_dtype, half_dtype)
    scaler = LossScaler(props.loss_scale, min_loss_scale=min_loss_scale,
                        max_loss_scale=max_loss_scale)
    states = [scaler.init(device) for _ in range(num_losses)]
    logger.info("amp initialized: %s (policy=%s)", props, policy)
    return AmpState(properties=props, policy=policy, scaler=scaler,
                    scaler_states=states)


def state_dict(amp_state: AmpState) -> Dict[str, dict]:
    """One entry per loss scaler."""
    return {f"loss_scaler{i}": amp_state.scaler.state_dict(s)
            for i, s in enumerate(amp_state.scaler_states)}


def load_state_dict(amp_state: AmpState, d: Dict[str, dict]) -> AmpState:
    """The state with the entries of ``d`` loaded, each on the device of
    the state it replaces."""
    states = list(amp_state.scaler_states)
    for i, st in enumerate(states):
        key = f"loss_scaler{i}"
        if key in d:
            states[i] = amp_state.scaler.load_state_dict(
                d[key], st.loss_scale.device)
    return dataclasses.replace(amp_state, scaler_states=states)
