"""apex_tpu_torch.serving.fleet — horizontally scaled serving
(counterpart of ``apex_tpu.serving.fleet``).

The fleet layer turns one supervised engine into a serving tier:
:class:`ReplicaFleet` runs N
:class:`~apex_tpu_torch.serving.EngineSupervisor` replicas behind a
single ``submit()`` front door with least-loaded dispatch
(:class:`Router`), fleet-wide admission control (an open breaker removes
a replica from the dispatch set; :class:`FleetUnavailableError` only when
none remain), and draining restarts that migrate in-flight work
token-exact to peers so a rebuild never drops capacity below N−1.

On top of the fleet sit the two halves of the train->serve loop:
:class:`Autoscaler` grows and shrinks the fleet between
``min_replicas``/``max_replicas`` under live SLO pressure, and
:class:`Deployment` rolls sharded checkpoints or LoRA adapters through
canary-scored draining restarts with automatic rollback; per-tenant
quotas (:class:`QuotaLedger`) and the brownout ladder
(:class:`BrownoutController`) guard the front door.

The JAX package's ``ShardedEngine`` (tensor-parallel replicas over the
device mesh) needs ``parallel_state`` and the tensor-parallel layers and
comes with them (ROADMAP §1 item 6); it plugs into the fleet through
``engine_factory=``.
"""

from apex_tpu_torch.serving.fleet.autoscale import AutoscaleConfig, Autoscaler
from apex_tpu_torch.serving.fleet.brownout import (
    BROWNOUT_RUNGS,
    BrownoutConfig,
    BrownoutController,
)
from apex_tpu_torch.serving.fleet.deploy import (
    DEPLOY_CANARY,
    DEPLOY_COMPLETE,
    DEPLOY_DRAINING,
    DEPLOY_REJECTED,
    DEPLOY_ROLLED_BACK,
    DEPLOY_ROLLING,
    DEPLOY_ROLLING_BACK,
    DEPLOY_UNLOADING,
    CanaryConfig,
    Deployment,
)
from apex_tpu_torch.serving.fleet.router import (
    REPLICA_ACTIVE,
    REPLICA_DRAINING,
    REPLICA_FAILED,
    REPLICA_PROBING,
    FleetConfig,
    FleetUnavailableError,
    ReplicaFleet,
    Router,
)
from apex_tpu_torch.serving.fleet.quota import (
    QuotaConfig,
    QuotaExceededError,
    QuotaLedger,
    TenantQuota,
)

__all__ = [
    "ReplicaFleet",
    "Router",
    "FleetConfig",
    "FleetUnavailableError",
    "AutoscaleConfig",
    "Autoscaler",
    "CanaryConfig",
    "Deployment",
    "REPLICA_ACTIVE",
    "REPLICA_DRAINING",
    "REPLICA_PROBING",
    "REPLICA_FAILED",
    "DEPLOY_ROLLING",
    "DEPLOY_DRAINING",
    "DEPLOY_CANARY",
    "DEPLOY_ROLLING_BACK",
    "DEPLOY_UNLOADING",
    "DEPLOY_COMPLETE",
    "DEPLOY_ROLLED_BACK",
    "DEPLOY_REJECTED",
    "TenantQuota",
    "QuotaConfig",
    "QuotaLedger",
    "QuotaExceededError",
    "BrownoutConfig",
    "BrownoutController",
    "BROWNOUT_RUNGS",
]
