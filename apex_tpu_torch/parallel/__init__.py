"""Parallel-training helpers (counterpart of ``apex_tpu.parallel``): LARC so
far; data parallelism and SyncBatchNorm come with the parallelism slice."""

from apex_tpu_torch.parallel.larc import LARC

__all__ = ["LARC"]
