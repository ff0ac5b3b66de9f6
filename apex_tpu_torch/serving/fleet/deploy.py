"""Continuous deployment: rolling canary weight updates with
auto-rollback for :class:`~apex_tpu_torch.serving.fleet.ReplicaFleet`
(counterpart of ``apex_tpu/serving/fleet/deploy.py``).

Closes the train half of the ROADMAP's train->serve loop: a freshly
trained checkpoint (or LoRA adapter) reaches the serving fleet without
a restart, through :meth:`ReplicaFleet.deploy`:

- **Checkpoint rollout** — the committed step is fsck-verified through
  the fsck path (:meth:`~apex_tpu_torch.checkpoint.ShardedCheckpointManager.\
verify_step`, deep) BEFORE any replica is touched: a corrupt
  checkpoint rejects the deploy outright. The state is then restored
  once and rolled replica-by-replica via draining restarts — the
  same quiesce/migrate/rebuild/probe machinery as ``drain_restart``,
  so in-flight requests survive every transition token-exact and
  capacity never drops below N-1.
- **Canary scoring** — each rebuilt replica serves live traffic for a
  configurable window (:class:`CanaryConfig`) and is scored on its
  per-replica SLO metrics: error rate over scored terminals, TTFT/TPOT
  p99 against the incumbents' same-window p99. Integrity machinery
  cannot catch weights that are *numerically* poisoned (checksums pass
  on poisoned bytes; the one-token health probe emits argmax of NaN
  logits, a valid token) — the canary's live-traffic error rate is
  genuinely the first detector. Pass promotes the rollout to the next
  replica; fail freezes the rollout and auto-rolls the canary back to
  the incumbent weights through another draining restart — zero
  requests dropped, migrated requests keep their original
  ``trace_id``, exactly one terminal record each.
- **LoRA adapter canary** — ``deploy(adapter=(adapter_id, factors))``
  hot-loads the adapter into the shared
  :class:`~apex_tpu_torch.lora.AdapterStore`, pins the tenant's traffic to
  one canary replica, and scores ONLY that tenant's results (the
  per-tenant ``slo_by_adapter`` slice). Fail quiesces the tenant's
  in-flight work, then unloads the adapter — base traffic never sees
  the canary at all.

Every decision is a typed ``kind="deploy"`` record plus an
event+counter pair (``deploy_start``/``deploys_started``,
``canary_promoted``/``canary_promotions``,
``deploy_rollback``/``deploys_rolled_back``,
``deploy_complete``/``deploys_completed``,
``deploy_rejected``/``deploys_rejected``) the monitor reconciles
key-for-key.

Where the port differs from the JAX deploy: the checkpoint's tree is the
JAX package's parameter tree (:func:`model_params_tree`: the model's
parameters through :func:`~apex_tpu_torch.convert.params_to_jax`, layers
stacked ``[L, ...]``), so one step directory deploys onto either
package's fleet. The port's restore writes into its template in place,
so the deploy restores into a FRESH template (:func:`checkpoint_template`)
and builds the canary's model from it (:func:`model_from_tree`: a copy of
the incumbent model with the restored weights) — the incumbents' live
parameters are never a restore target, so a poisoned step and its
rollback leave them bitwise as they were.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch

from apex_tpu_torch.checkpoint import (
    CheckpointCorruptionError,
    ShardedCheckpointManager,
)
from apex_tpu_torch.convert import load_jax_params, params_to_jax
from apex_tpu_torch.observability.registry import percentile
from apex_tpu_torch.serving import clock
from apex_tpu_torch.serving.fleet.router import (
    REPLICA_ACTIVE,
    REPLICA_FAILED,
    Router,
)
from apex_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    Request,
    RequestResult,
)
from apex_tpu_torch.utils.logging import get_logger, log_event

__all__ = ["CanaryConfig", "Deployment", "model_params_tree",
           "checkpoint_template", "model_from_tree",
           "DEPLOY_ROLLING", "DEPLOY_DRAINING", "DEPLOY_CANARY",
           "DEPLOY_ROLLING_BACK", "DEPLOY_UNLOADING",
           "DEPLOY_COMPLETE", "DEPLOY_ROLLED_BACK", "DEPLOY_REJECTED"]

_LOG = get_logger(__name__)

#: deployment lifecycle states (``Deployment.state``)
DEPLOY_ROLLING = "rolling"            # waiting to drain the next replica
DEPLOY_DRAINING = "draining"          # canary rebuilding on new weights
DEPLOY_CANARY = "canary"              # scoring window open
DEPLOY_ROLLING_BACK = "rolling_back"  # canary draining back to incumbent
DEPLOY_UNLOADING = "unloading"        # adapter rollback: tenant quiescing
DEPLOY_COMPLETE = "complete"          # every replica promoted
DEPLOY_ROLLED_BACK = "rolled_back"    # canary failed; incumbent restored
DEPLOY_REJECTED = "rejected"          # fsck failed before the first drain

_TERMINAL = (DEPLOY_COMPLETE, DEPLOY_ROLLED_BACK, DEPLOY_REJECTED)

#: finish reasons a canary score counts: successes + engine faults.
#: cancelled/timeout/rejected are caller- or load-caused, not evidence
#: about the canary's weights
_SCORED = (FINISH_EOS, FINISH_LENGTH, FINISH_ERROR)


@dataclass(frozen=True)
class CanaryConfig:
    """Canary scoring knobs (docs/serving.md#continuous-deployment).

    A promoted replica's window closes when BOTH ``window_s`` wall
    seconds have elapsed AND at least ``min_requests`` scored terminals
    landed on the canary — but never later than ``max_window_s``, at
    which point whatever evidence exists is scored (zero scored
    requests fails closed: an unobservable canary must not promote).

    ``max_error_rate`` bounds the canary's error share of scored
    terminals (0.0 = any engine error fails). ``latency_ratio`` gates
    the canary's TTFT/TPOT p99 at that multiple of the incumbents'
    same-window p99 (0 disables; only applied when both sides
    measured).
    """

    window_s: float = 0.5
    min_requests: int = 3
    max_window_s: float = 10.0
    max_error_rate: float = 0.0
    latency_ratio: float = 0.0

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError(
                f"window_s must be > 0, got {self.window_s}")
        if self.min_requests < 0:
            raise ValueError(
                f"min_requests must be >= 0, got {self.min_requests}")
        if self.max_window_s < self.window_s:
            raise ValueError(
                f"max_window_s ({self.max_window_s}) must be >= "
                f"window_s ({self.window_s})")
        if not 0.0 <= self.max_error_rate <= 1.0:
            raise ValueError(
                f"max_error_rate must be in [0, 1], got "
                f"{self.max_error_rate}")
        if self.latency_ratio < 0:
            raise ValueError(
                f"latency_ratio must be >= 0, got {self.latency_ratio}")


def _map_tree(fn, tree):
    """``fn`` over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def model_params_tree(model) -> Dict[str, Any]:
    """The model's parameters as the JAX package's parameter tree of CPU
    tensors (each its own copy, layers stacked ``[L, ...]``, bf16 widened
    to fp32) — what a deploy's checkpoint step holds, and what the JAX
    package's ``ShardedCheckpointManager`` writes for the same model's
    JAX params."""
    return _map_tree(lambda a: torch.from_numpy(np.array(a)),
                     params_to_jax(dict(model.named_parameters())))


def checkpoint_template(model) -> Dict[str, Any]:
    """A fresh restore target shaped as :func:`model_params_tree` (new
    CPU tensors; nothing of the live model is written by a restore)."""
    return _map_tree(lambda a: torch.empty(a.shape, dtype=torch.float32),
                     params_to_jax(dict(model.named_parameters())))


def model_from_tree(model, tree: Dict[str, Any]):
    """A copy of ``model`` (same config, device and dtypes) carrying the
    weights of a :func:`model_params_tree`-shaped tree."""
    new = copy.deepcopy(model)
    load_jax_params(new, _map_tree(lambda t: t.numpy(), tree))
    return new


def _p99(results: List[RequestResult], attr: str) -> Optional[float]:
    values = [getattr(r, attr) for r in results
              if getattr(r, attr) is not None]
    if not values:
        return None
    return percentile(values, 99)


class Deployment:
    """One rolling canary deployment; construct via
    :meth:`ReplicaFleet.deploy`, driven by :meth:`step` from the fleet
    tick loop. Exactly one of ``checkpoint_dir`` / ``adapter``."""

    def __init__(self, checkpoint_dir: Optional[str] = None, *,
                 step: Optional[int] = None, adapter=None,
                 canary: Optional[CanaryConfig] = None):
        if (checkpoint_dir is None) == (adapter is None):
            raise ValueError(
                "deploy exactly one of checkpoint_dir or adapter")
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_step = step
        self.adapter_id: Optional[str] = None
        self._adapter_factors = None
        if adapter is not None:
            try:
                self.adapter_id, self._adapter_factors = adapter
            except (TypeError, ValueError):
                raise ValueError(
                    "adapter must be an (adapter_id, factors) pair")
        self.canary = canary or CanaryConfig()
        self.state: Optional[str] = None     # None until start()
        self.rollback_reason: Optional[str] = None
        #: replica ids promoted onto the new weights, in order
        self.promoted: List[int] = []
        self.scores: List[dict] = []         # one entry per closed window
        self._queue: List[int] = []
        self._canary_rid: Optional[int] = None
        self._new_model: Any = None
        self._window_start: Optional[float] = None
        self._seen: Set[int] = set()
        self._canary_results: List[RequestResult] = []
        self._incumbent_results: List[RequestResult] = []

    # -- introspection -----------------------------------------------------

    @property
    def done(self) -> bool:
        return self.state in _TERMINAL

    @property
    def canary_replica(self) -> Optional[int]:
        return self._canary_rid

    def describe(self) -> str:
        if self.adapter_id is not None:
            return f"adapter:{self.adapter_id}"
        return f"checkpoint:{self.checkpoint_dir}@{self.checkpoint_step}"

    def pin_replica(self, request: Request) -> Optional[int]:
        """Replica to pin ``request`` to, or None. Only an adapter
        canary pins, only its own tenant, only while scoring — base
        traffic routes normally throughout."""
        if (self.adapter_id is not None
                and self.state == DEPLOY_CANARY
                and request.sampling.adapter_id == self.adapter_id):
            return self._canary_rid
        return None

    # -- record/event emission --------------------------------------------

    def _record(self, fleet, action: str, **fields) -> None:
        rec = {"kind": "deploy", "action": action,
               "target": self.describe(), "wall": clock.wall()}
        rec.update(fields)
        fleet.metrics.emit_record(rec)

    def _incident(self, fleet, event: str, counter: str,
                  **fields) -> None:
        """One counter increment co-sited with its same-named event —
        the serving telemetry contract the monitor reconciles."""
        fleet.metrics.inc(counter)
        log_event(_LOG, event, target=self.describe(), **fields)
        fleet.metrics.event(event, target=self.describe(), **fields)

    # -- lifecycle ---------------------------------------------------------

    def start(self, fleet) -> None:
        """Verify and stage the new weights; called from
        ``ReplicaFleet.deploy`` before the deployment is installed.
        Raises (after recording ``deploy_rejected``) when the
        checkpoint fails its fsck or the adapter cannot load — no
        replica has been touched yet in either case."""
        now = clock.now()
        if self.adapter_id is not None:
            self._start_adapter(fleet, now)
            return
        mgr = ShardedCheckpointManager(self.checkpoint_dir)
        step = self.checkpoint_step
        if step is None:
            step = mgr.latest_step()
        if step is None:
            self._reject(fleet, "no committed checkpoint step")
            raise CheckpointCorruptionError(
                f"{self.checkpoint_dir}: no committed step to deploy")
        self.checkpoint_step = int(step)
        try:
            # the fsck path: per-shard checksums, manifest sha,
            # commit marker — BEFORE the first drain
            mgr.verify_step(self.checkpoint_step, deep=True)
        except CheckpointCorruptionError as e:
            self._reject(fleet, str(e))
            raise
        # restore once, into a fresh template — every replica rebuilds on
        # this same new model; the incumbents' tensors are never written
        tree = mgr.restore_step(self.checkpoint_step,
                                checkpoint_template(fleet._model))
        self._new_model = model_from_tree(fleet._model, tree)
        self._queue = [r.replica_id for r in fleet.replicas
                       if r.state != REPLICA_FAILED]
        self.state = DEPLOY_ROLLING
        self._incident(fleet, "deploy_start", "deploys_started",
                       replicas=len(self._queue))
        self._record(fleet, "start", replicas=list(self._queue))

    def _start_adapter(self, fleet, now: float) -> None:
        if fleet._adapters is None:
            raise ValueError(
                "fleet has no AdapterStore — construct it with "
                "adapters= to deploy a LoRA adapter")
        try:
            fleet._adapters.load(self.adapter_id, self._adapter_factors)
        except Exception as e:
            self._reject(fleet, str(e))
            raise
        # least-loaded ACTIVE replica hosts the pinned tenant traffic
        candidates = [r for r in fleet.replicas
                      if r.state == REPLICA_ACTIVE]
        if not candidates:
            fleet._adapters.unload(self.adapter_id)
            self._reject(fleet, "no active replica to canary on")
            raise RuntimeError("no active replica to canary the "
                               "adapter on")
        target = min(candidates,
                     key=lambda r: (Router.depth(r), r.replica_id))
        self._canary_rid = target.replica_id
        self._incident(fleet, "deploy_start", "deploys_started",
                       replica_id=self._canary_rid)
        self._record(fleet, "start", replica_id=self._canary_rid)
        self._open_window(fleet, now)

    def _reject(self, fleet, reason: str) -> None:
        self.state = DEPLOY_REJECTED
        self.rollback_reason = reason
        self._incident(fleet, "deploy_rejected", "deploys_rejected",
                       reason=reason)
        self._record(fleet, "rejected", reason=reason)

    # -- the tick-driven state machine ------------------------------------

    def step(self, fleet, now: float) -> None:
        """Advance one tick; called from ``ReplicaFleet.tick``."""
        if self.done:
            return
        if self.state == DEPLOY_ROLLING:
            self._step_rolling(fleet, now)
        elif self.state == DEPLOY_DRAINING:
            self._step_draining(fleet, now)
        elif self.state == DEPLOY_CANARY:
            self._step_canary(fleet, now)
        elif self.state == DEPLOY_ROLLING_BACK:
            self._step_rolling_back(fleet)
        elif self.state == DEPLOY_UNLOADING:
            self._step_unloading(fleet)

    def _step_rolling(self, fleet, now: float) -> None:
        if fleet.topology_busy is not None:
            return
        while self._queue:
            rid = self._queue[0]
            replica = fleet._replica(rid)
            if replica is None or replica.state != REPLICA_ACTIVE:
                self._queue.pop(0)   # retired/failed since start: skip
                continue
            break
        if not self._queue:
            self._complete(fleet)
            return
        rid = self._queue.pop(0)
        self._canary_rid = rid
        fleet._replica_models[rid] = self._new_model
        fleet.drain_restart(rid)
        self.state = DEPLOY_DRAINING

    def _step_draining(self, fleet, now: float) -> None:
        # unreachable for adapter deploys (no drain in that flow)
        replica = fleet._replica(self._canary_rid)
        if replica is None:
            self._begin_rollback(fleet, None, "replica_lost")
            return
        if replica.state == REPLICA_FAILED:
            # new weights cannot even pass the one-token probe
            self._begin_rollback(fleet, None, "probe_failed")
            return
        if replica.state == REPLICA_ACTIVE:
            self._open_window(fleet, now)

    def _open_window(self, fleet, now: float) -> None:
        self.state = DEPLOY_CANARY
        self._window_start = now
        self._seen = set(fleet.completed)
        self._canary_results = []
        self._incumbent_results = []

    def _collect(self, fleet) -> None:
        fresh = set(fleet.completed) - self._seen
        self._seen |= fresh
        for rid in fresh:
            res = fleet.completed[rid]
            if self.adapter_id is not None:
                if res.adapter_id == self.adapter_id:
                    self._canary_results.append(res)
                elif res.replica_id is not None:
                    self._incumbent_results.append(res)
            elif res.replica_id == self._canary_rid:
                self._canary_results.append(res)
            elif res.replica_id is not None:
                self._incumbent_results.append(res)

    def _step_canary(self, fleet, now: float) -> None:
        self._collect(fleet)
        elapsed = now - (self._window_start or now)
        if elapsed < self.canary.window_s:
            return
        scored = [r for r in self._canary_results
                  if r.finish_reason in _SCORED]
        if (len(scored) < self.canary.min_requests
                and elapsed < self.canary.max_window_s):
            return              # keep the window open for more evidence
        score = self._score(scored)
        self.scores.append(score)
        if score["pass"]:
            self.promoted.append(self._canary_rid)
            self._incident(fleet, "canary_promoted",
                           "canary_promotions",
                           replica_id=self._canary_rid)
            self._record(fleet, "canary_pass",
                         replica_id=self._canary_rid, score=score)
            if self.adapter_id is not None:
                self._complete(fleet)
            else:
                self.state = DEPLOY_ROLLING
            return
        self._begin_rollback(fleet, score, score["reason"])

    def _score(self, scored: List[RequestResult]) -> dict:
        cfg = self.canary
        errors = sum(1 for r in scored
                     if r.finish_reason == FINISH_ERROR)
        error_rate = errors / len(scored) if scored else None
        c_ttft = _p99(scored, "ttft_s")
        c_tpot = _p99(scored, "tpot_s")
        inc_scored = [r for r in self._incumbent_results
                      if r.finish_reason in _SCORED]
        i_ttft = _p99(inc_scored, "ttft_s")
        i_tpot = _p99(inc_scored, "tpot_s")
        verdict, reason = True, None
        if not scored:
            # fail closed: a canary no traffic reached is unprovable
            verdict, reason = False, "no_traffic"
        elif error_rate > cfg.max_error_rate:
            verdict, reason = False, "error_rate"
        elif cfg.latency_ratio > 0:
            if (c_ttft is not None and i_ttft is not None
                    and c_ttft > i_ttft * cfg.latency_ratio):
                verdict, reason = False, "ttft_p99"
            elif (c_tpot is not None and i_tpot is not None
                    and c_tpot > i_tpot * cfg.latency_ratio):
                verdict, reason = False, "tpot_p99"
        return {"pass": verdict, "reason": reason,
                "replica_id": self._canary_rid,
                "requests": len(scored), "errors": errors,
                "error_rate": error_rate,
                "max_error_rate": cfg.max_error_rate,
                "canary_ttft_p99_s": c_ttft,
                "incumbent_ttft_p99_s": i_ttft,
                "canary_tpot_p99_s": c_tpot,
                "incumbent_tpot_p99_s": i_tpot,
                "latency_ratio": cfg.latency_ratio,
                "incumbent_requests": len(inc_scored)}

    def _begin_rollback(self, fleet, score: Optional[dict],
                        reason: str) -> None:
        """Freeze the rollout and return the canary to the incumbent
        weights (checkpoint) or quiesce-and-unload (adapter)."""
        self.rollback_reason = reason
        self._incident(fleet, "deploy_rollback", "deploys_rolled_back",
                       replica_id=self._canary_rid, reason=reason)
        self._record(fleet, "rollback", replica_id=self._canary_rid,
                     reason=reason, score=score)
        if self.adapter_id is not None:
            self.state = DEPLOY_UNLOADING
            self._step_unloading(fleet)
            return
        fleet._replica_models.pop(self._canary_rid, None)
        replica = fleet._replica(self._canary_rid)
        if replica is None:
            self.state = DEPLOY_ROLLED_BACK
            return
        if replica.state == REPLICA_ACTIVE:
            # mid-canary fail: drain back — in-flight work migrates
            # token-exact with its original trace_ids
            fleet.drain_restart(self._canary_rid)
        elif replica.state == REPLICA_FAILED:
            # probe-failed on the NEW weights: rebuild directly onto
            # the incumbent model (the override is already popped)
            replica.probe_attempts = 0
            fleet._rebuild(replica)
        self.state = DEPLOY_ROLLING_BACK

    def _step_rolling_back(self, fleet) -> None:
        replica = fleet._replica(self._canary_rid)
        if replica is None or replica.state in (REPLICA_ACTIVE,
                                                 REPLICA_FAILED):
            # active: incumbent weights restored and probed. failed:
            # already recorded as replica_failed — a fleet incident,
            # not a deploy state; the rollout is over either way.
            self.state = DEPLOY_ROLLED_BACK

    def _step_unloading(self, fleet) -> None:
        """Adapter rollback: wait until no in-flight request of the
        tenant remains (unloading earlier would silently degrade their
        streams to base-model output mid-decode), then unload."""
        inflight = any(
            tr.request.sampling.adapter_id == self.adapter_id
            for tr in fleet._tracked.values())
        if inflight:
            return
        fleet._adapters.unload(self.adapter_id)
        self.state = DEPLOY_ROLLED_BACK

    def _complete(self, fleet) -> None:
        if self.adapter_id is None:
            # the new weights are now the fleet's baseline: future
            # rebuilds/scale-ups build from them with no override
            fleet._model = self._new_model
            for rid in list(fleet._replica_models):
                if fleet._replica_models[rid] is self._new_model:
                    fleet._replica_models.pop(rid)
        self.state = DEPLOY_COMPLETE
        self._incident(fleet, "deploy_complete", "deploys_completed",
                       promoted=len(self.promoted))
        self._record(fleet, "complete", promoted=list(self.promoted))
