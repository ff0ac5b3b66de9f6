"""Continuous-batching serving over the paged or flat KV layout, the
engine supervisor, and the replica fleet (counterpart of
``apex_tpu.serving``; the fleet's controllers live in
:mod:`apex_tpu_torch.serving.fleet`)."""

from apex_tpu_torch.lora import UnknownAdapterError
from apex_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from apex_tpu_torch.serving.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_REASONS,
    FINISH_REJECTED,
    FINISH_TIMEOUT,
    Request,
    RequestResult,
    SamplingParams,
)
from apex_tpu_torch.serving.scheduler import (
    DeadlineExpiredError,
    FCFSScheduler,
    QueueFullError,
    SchedulerConfig,
    bucket_for,
    prefill_buckets,
)
from apex_tpu_torch.serving.slots import PageError, PagePool, SlotError, \
    SlotPool
from apex_tpu_torch.serving.supervisor import (
    EngineSupervisor,
    EngineUnavailableError,
    SupervisorConfig,
)
from apex_tpu_torch.serving.fleet import (
    FleetConfig,
    FleetUnavailableError,
    ReplicaFleet,
    Router,
)

__all__ = ["EngineConfig", "InferenceEngine", "Request", "RequestResult",
           "SamplingParams", "FINISH_CANCELLED", "FINISH_EOS", "FINISH_ERROR",
           "FINISH_LENGTH", "FINISH_REASONS", "FINISH_REJECTED",
           "FINISH_TIMEOUT", "DeadlineExpiredError", "FCFSScheduler",
           "QueueFullError", "SchedulerConfig", "bucket_for",
           "prefill_buckets", "PageError", "PagePool", "SlotError",
           "SlotPool", "EngineSupervisor", "EngineUnavailableError",
           "SupervisorConfig", "UnknownAdapterError", "ReplicaFleet",
           "Router", "FleetConfig", "FleetUnavailableError"]
