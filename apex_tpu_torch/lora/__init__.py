"""Multi-LoRA: adapter fine-tuning and per-request multi-tenant serving
(counterpart of ``apex_tpu.lora``).

Train side: :func:`lora_finetune` — batched multi-job fine-tuning of
several rank-r adapters against one frozen base model, the factors
stepped by FusedAdam over one flat buffer. Serve side:
:class:`AdapterStore` — a device-resident stacked adapter bank the
serving engine gathers per slot each step, so one batched decode step
serves every tenant.
"""

from apex_tpu_torch.lora.adapter import (
    LORA_TARGETS,
    AdapterStore,
    UnknownAdapterError,
    init_adapter,
    merge_adapter,
    random_adapter,
    target_dims,
)
from apex_tpu_torch.lora.finetune import lora_finetune

__all__ = [
    "LORA_TARGETS",
    "AdapterStore",
    "UnknownAdapterError",
    "init_adapter",
    "merge_adapter",
    "random_adapter",
    "target_dims",
    "lora_finetune",
]
