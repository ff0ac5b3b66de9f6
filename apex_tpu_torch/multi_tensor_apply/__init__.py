"""Flat-bucket multi-tensor dispatch (counterpart of
``apex_tpu.multi_tensor_apply``)."""

from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (
    BucketMeta,
    MultiTensorApply,
    flatten_by_dtype,
    multi_tensor_applier,
    unflatten_by_dtype,
)

__all__ = ["MultiTensorApply", "multi_tensor_applier", "BucketMeta",
           "flatten_by_dtype", "unflatten_by_dtype"]
