"""Resilient training loop: watchdog, rollback, retrying checkpoints.

Counterpart of ``apex_tpu/resilience.py``, with its semantics: a run that
survives faults around a train step of the port's models and optimizers.

- :class:`Watchdog` — NaN/divergence detection: consecutive-skip abort,
  plus loss-spike and grad-norm anomaly detection against rolling
  medians. The step leaves its metrics **on the device**; the loop
  reads them in batches every ``poll_interval_steps`` (one host copy of
  the pending metrics), so the host never blocks the step loop on a
  per-step sync.
- **rollback-to-last-good** — on a verdict, restore the newest checkpoint
  from *before* the first bad step (suspect newer ones are deleted),
  decay the loss scale, advance the data "retry epoch" so the poisoned
  window is re-seeded, and retry under a bounded ``max_rollbacks`` budget.
- **retrying, atomic, async checkpoint I/O** —
  :class:`apex_tpu_torch.checkpoint.RetryingCheckpointManager` over the
  sharded format (default, the JAX package's on-disk format): the step
  loop blocks only for the device->host snapshot, serialization + fsync
  + checksum run on a background writer inside the retry loop; restore
  verifies every shard and falls back to older steps on corruption
  (``ResilienceConfig.checkpoint_format="orbax"`` selects the
  whole-state format, which the port writes with ``torch.save``).
- **preemption hook** — SIGTERM flips a flag; the loop flushes an
  emergency (forced) save and returns cleanly with
  ``status="preempted"``, resumable by the next invocation.
- **observability** — attach an :class:`apex_tpu_torch.observability.
  MetricsRegistry` (``ResilienceConfig.metrics``) and the loop mirrors
  every telemetry counter into it, emits incident events next to
  ``log_event``, and records step-time/tokens-per-s/MFU/memory metrics;
  ``python -m apex_tpu_torch.monitor`` folds a JSONL sink's log into a
  run report that reconciles with :attr:`TrainingResult.telemetry`.

Where the port differs by design:

- the train state is the LIVE tensors (:func:`make_train_state`): the
  model's parameters, the optimizer's per-parameter state, a step
  counter and the scaler state, all updated in place by the step. A
  restore copies a checkpoint into them in place, after verifying the
  whole step, so ``state`` stays the one dict the step works on;
- nothing is compiled, so ``retrace_budget`` is accepted and
  ``telemetry["retraces"]`` stays 0;
- the step runs on one device: ``mesh`` and the specs of
  :func:`make_resilient_train_step` raise ``NotImplementedError`` until
  the port has process groups.

Every recovery path is exercised deterministically in CPU tests via
:class:`apex_tpu_torch.testing_faults.FaultInjector`.
"""

from __future__ import annotations

import inspect
import math
import signal
import statistics
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState, all_finite
from apex_tpu_torch.checkpoint import (
    CheckpointManager,
    RetryingCheckpointManager,
    ShardedCheckpointManager,
)
from apex_tpu_torch.observability.step_metrics import StepMetrics
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.logging import get_logger, log_event
from apex_tpu_torch.utils.tree import global_norm

__all__ = [
    "ResilienceConfig",
    "Watchdog",
    "WatchdogVerdict",
    "TrainingDiverged",
    "TrainingResult",
    "make_train_state",
    "make_resilient_train_step",
    "run_training",
]

#: the JAX package's data-parallel mesh axis name
DATA_AXIS = "data"


class TrainingDiverged(RuntimeError):
    """Raised when the rollback retry budget is exhausted or no healthy
    checkpoint exists to roll back to. Carries ``telemetry``."""

    def __init__(self, message: str, telemetry: Optional[dict] = None):
        super().__init__(message)
        self.telemetry = dict(telemetry or {})


@dataclass
class ResilienceConfig:
    """Knobs for :func:`run_training`. Defaults are conservative; tests
    shrink the windows to trip every path in a few steps."""

    # -- watchdog ---------------------------------------------------------
    #: consecutive skipped/non-finite steps before declaring divergence
    #: (the reference amp's repeated-overflow abort).
    max_consecutive_skips: int = 8
    #: loss deviation above the rolling median, in units of
    #: ``max(|median|, spike_floor)``, that counts as an anomaly.
    loss_spike_factor: float = 10.0
    #: same for the gradient norm (norms drift more; keep this loose).
    grad_spike_factor: float = 100.0
    spike_floor: float = 1e-3
    #: consecutive anomalous (but finite) steps before declaring divergence.
    anomaly_patience: int = 2
    history_window: int = 64
    #: spike detection stays silent until this much healthy history exists.
    min_history: int = 8
    #: device→host metric sync cadence; larger = cheaper, slower detection.
    poll_interval_steps: int = 8
    # -- rollback ---------------------------------------------------------
    max_rollbacks: int = 3
    #: divide the restored loss scale by this on every rollback (floored
    #: at 1.0) — re-diverging at the same scale is the common failure.
    rollback_scale_decay: float = 2.0
    #: pass an incremented retry-epoch to ``batch_fn(step, epoch)`` so the
    #: data pipeline can re-seed past the poisoned window.
    reseed_data_on_rollback: bool = True
    # -- checkpointing ----------------------------------------------------
    save_interval_steps: int = 50
    max_to_keep: int = 5
    save_final: bool = True
    resume: bool = True
    save_retries: int = 3
    save_backoff_base: float = 0.5
    save_backoff_max: float = 8.0
    delete_corrupt: bool = True
    #: on-disk format when the loop builds the manager from
    #: ``checkpoint_dir``: ``"sharded"`` (the JAX package's sharded
    #: format: per-shard checksums, async-capable) or ``"orbax"`` (the
    #: whole-state format; in the port one ``torch.save`` file a step).
    checkpoint_format: str = "sharded"
    #: with the sharded format, run serialization + fsync + checksum on a
    #: background writer — the step loop blocks only for the device→host
    #: snapshot. ``False`` forces fully synchronous saves.
    checkpoint_async: bool = True
    #: emergency (preemption) saves first quiesce the async writer:
    #: ``True`` drains pending writes to commit, ``False`` abandons
    #: queued ones (the running write still commits atomically).
    preemption_drain: bool = True
    # -- retrace watchdog -------------------------------------------------
    #: accepted for the JAX package's configs; the port compiles nothing,
    #: so ``telemetry["retraces"]`` stays 0.
    retrace_budget: Optional[int] = 8
    # -- observability ----------------------------------------------------
    #: a :class:`apex_tpu_torch.observability.MetricsRegistry`; when
    #: attached, the loop mirrors every ``TrainingResult.telemetry``
    #: counter into it, emits incident events alongside ``log_event``, and
    #: feeds a :class:`~apex_tpu_torch.observability.StepMetrics` layer
    #: (step time, tokens/s, MFU, memory gauges).
    metrics: Optional[Any] = None
    #: global tokens per step — enables the ``tokens_per_s`` metric.
    tokens_per_step: Optional[int] = None
    #: model FLOPs per step (see :mod:`apex_tpu_torch.utils.flops`) —
    #: enables ``model_tflops`` and, with a known/overridden peak, ``mfu``.
    model_flops_per_step: Optional[float] = None
    #: per-card peak FLOP/s override; default from the card table (None
    #: on the CPU — MFU then stays unset).
    peak_flops: Optional[float] = None
    #: device memory gauge cadence in steps (0 disables).
    memory_stats_interval_steps: int = 50
    #: a :class:`apex_tpu_torch.observability.ProfilerCapture`; the loop
    #: advances its schedule each step and triggers a capture on watchdog
    #: verdicts.
    profiler: Optional[Any] = None
    # -- preemption -------------------------------------------------------
    handle_sigterm: bool = True
    record_history: bool = True


@dataclass
class WatchdogVerdict:
    reason: str          # "consecutive_skips" | "loss_spike" | "grad_spike"
    step: int            # step at which the verdict fired
    first_bad_step: int  # first step of the bad window (rollback bound)
    detail: str = ""


class Watchdog:
    """Host-side divergence detector over polled per-step metrics.

    ``observe(step, loss, grad_norm, skipped)`` returns a
    :class:`WatchdogVerdict` when training is deemed diverged, else None.
    Skipped or non-finite steps never enter the rolling history, so the
    spike baselines only reflect healthy steps; a healthy step resets the
    consecutive-skip and anomaly counters (the scaler's own hysteresis
    handles isolated overflows — the watchdog only fires on runs of them).
    """

    def __init__(self, config: Optional[ResilienceConfig] = None):
        self.config = config or ResilienceConfig()
        self._loss_hist: deque = deque(maxlen=self.config.history_window)
        self._gnorm_hist: deque = deque(maxlen=self.config.history_window)
        self.reset()

    def reset(self) -> None:
        self._loss_hist.clear()
        self._gnorm_hist.clear()
        self._skips = 0
        self._anomalies = 0
        self._first_bad: Optional[int] = None

    def _bad(self, step: int) -> int:
        if self._first_bad is None:
            self._first_bad = step
        return self._first_bad

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None,
                skipped: bool = False) -> Optional[WatchdogVerdict]:
        cfg = self.config
        nonfinite = not math.isfinite(loss) or (
            grad_norm is not None and not math.isfinite(grad_norm))
        if skipped or nonfinite:
            self._skips += 1
            first = self._bad(step)
            if self._skips >= cfg.max_consecutive_skips:
                return WatchdogVerdict(
                    "consecutive_skips", step, first,
                    detail=f"{self._skips} consecutive skipped/non-finite "
                           f"steps")
            return None

        spike = None
        if len(self._loss_hist) >= cfg.min_history:
            med = statistics.median(self._loss_hist)
            if loss - med > cfg.loss_spike_factor * max(abs(med),
                                                        cfg.spike_floor):
                spike = ("loss_spike",
                         f"loss {loss:.4g} vs median {med:.4g}")
        if (spike is None and grad_norm is not None
                and len(self._gnorm_hist) >= cfg.min_history):
            med = statistics.median(self._gnorm_hist)
            if grad_norm > cfg.grad_spike_factor * max(med, cfg.spike_floor):
                spike = ("grad_spike",
                         f"grad_norm {grad_norm:.4g} vs median {med:.4g}")

        if spike is not None:
            self._anomalies += 1
            first = self._bad(step)
            if self._anomalies >= cfg.anomaly_patience:
                return WatchdogVerdict(spike[0], step, first,
                                       detail=spike[1])
            return None

        self._skips = 0
        self._anomalies = 0
        self._first_bad = None
        self._loss_hist.append(loss)
        if grad_norm is not None:
            self._gnorm_hist.append(grad_norm)
        return None


@dataclass
class TrainingResult:
    state: Any
    status: str               # "completed" | "preempted"
    steps_completed: int
    rollbacks: int
    telemetry: Dict[str, int]
    history: List[dict] = field(default_factory=list)


def _trainable(optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def make_train_state(model: torch.nn.Module, optimizer,
                     scaler_state: Optional[LossScalerState] = None,
                     step: int = 0) -> dict:
    """The train state :func:`run_training` drives: one dict of the LIVE
    tensors a resume needs, which one checkpoint call pair round-trips:

    - ``"params"``: name -> parameter, for every parameter of ``model``
      that ``optimizer`` updates;
    - ``"opt_state"``: name -> that parameter's optimizer state (``step``,
      its slots and ``master``), made now for every one of them: the
      port's optimizers make state on their first step, and a fresh
      run's template must hold every tensor a checkpoint holds;
    - ``"step"``: an int32 0-dim tensor on the parameters' device;
    - ``"scaler"``, when ``scaler_state`` is given.
    """
    owned = {id(p) for p in _trainable(optimizer)}
    params = {name: p for name, p in model.named_parameters()
              if id(p) in owned}
    if len(params) != len(owned):
        raise ValueError("the optimizer updates tensors that are not "
                         "parameters of the model")
    opt_state = {name: optimizer._state(p) for name, p in params.items()}
    device = next(iter(params.values())).device
    state = {
        "params": params,
        "opt_state": opt_state,
        "step": torch.tensor(step, dtype=torch.int32, device=device),
    }
    if scaler_state is not None:
        state["scaler"] = scaler_state
    return state


def make_resilient_train_step(
    loss_fn: Callable,
    optimizer,
    scaler: Optional[LossScaler] = None,
    *,
    mesh=None,
    param_spec=None,
    batch_spec=None,
    opt_state_spec=None,
    params_template=None,
    data_axes: Sequence[str] = (DATA_AXIS,),
    donate: bool = True,
) -> Callable:
    """Build ``step(state, batch, rng) -> (state, metrics)`` — the
    amp-aware sibling of :func:`apex_tpu_torch.training.make_train_step`
    with :func:`run_training`'s contract: ``state`` is a
    :func:`make_train_state` dict over ``optimizer``'s parameters,
    updated in place and returned;
    ``metrics`` carries device tensors ``loss`` / ``grad_norm`` /
    ``skipped`` (and ``loss_scale`` when a scaler is wired) for the
    watchdog to poll.

    ``loss_fn(batch, rng)`` computes the loss over the optimizer's
    parameters. ``rng`` (a :mod:`~apex_tpu_torch.utils.prng` key, or
    None) gets index 0 folded in once per data axis first, as the JAX
    step folds in each rank's index, so a dropout model draws the JAX
    package's masks from the same seed.

    With ``scaler`` the loss is scaled before the backward, the grads are
    unscaled in place with non-finites zeroed (``multi_tensor_scale`` on
    the card), the optimizer skips on overflow through its ``found_inf``
    and the scaler state updates in place. Without a scaler, ``skipped``
    reports a finiteness check of the raw grads. ``grad_norm`` is the
    global norm of the unscaled grads (``multi_tensor_l2norm`` on the
    card). ``donate`` is accepted and changes nothing (the state is
    updated in place anyway); ``mesh`` and the specs raise
    ``NotImplementedError`` until the port has process groups.
    """
    if any(x is not None for x in (mesh, param_spec, batch_spec,
                                   opt_state_spec)):
        raise NotImplementedError(
            "make_resilient_train_step runs on one device in "
            "apex_tpu_torch: mesh and partition specs come with the "
            "port's process groups")
    del params_template, donate
    params = _trainable(optimizer)
    data_axes = tuple(data_axes)

    def step(state: dict, batch: Any, rng: Optional[torch.Tensor]):
        sstate = state.get("scaler")
        if rng is not None:
            for _ in data_axes:
                rng = prng.fold_in(rng, 0)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, rng)
        scaled = loss if sstate is None else scaler.scale(loss, sstate)
        scaled.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if sstate is not None:
            _, found_inf = scaler.unscale(grads, sstate)
        else:
            found_inf = torch.logical_not(all_finite(grads))
        gnorm = global_norm(grads)
        optimizer.step(found_inf=found_inf)
        with torch.no_grad():
            state["step"].add_(1)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "skipped": found_inf}
        if sstate is not None:
            new = scaler.update(sstate, found_inf)
            with torch.no_grad():
                for name in ("loss_scale", "growth_tracker",
                             "hysteresis_tracker", "unskipped"):
                    getattr(sstate, name).copy_(getattr(new, name))
            metrics["loss_scale"] = new.loss_scale
        return state, metrics

    return step


class _SigtermGuard:
    """Scoped SIGTERM hook: sets ``triggered`` instead of killing the
    process, restores the previous handler on exit. Installation is a
    no-op off the main thread (signal API restriction) or when handling
    is disabled — ``triggered`` then only reflects injected preemptions."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.triggered = False
        self._prev = None
        self._installed = False

    def __enter__(self):
        if (self.enabled
                and threading.current_thread() is threading.main_thread()):
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        return self

    def _on_signal(self, signum, frame):
        self.triggered = True

    def __exit__(self, *exc):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
        return False


def _batch_caller(batch_fn: Callable) -> Callable[[int, int], Any]:
    """Normalize ``batch_fn`` to ``(step, retry_epoch) -> batch``.
    A single-parameter callable ignores the retry epoch (its data cannot
    be re-seeded past a poisoned window — fine when faults are transient).
    """
    try:
        sig = inspect.signature(batch_fn)
        takes_epoch = len([
            p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]) >= 2 or any(p.kind == p.VAR_POSITIONAL
                       for p in sig.parameters.values())
    except (TypeError, ValueError):
        takes_epoch = False
    if takes_epoch:
        return batch_fn
    return lambda step, epoch: batch_fn(step)


def _host_metrics(pending: List[Tuple[int, dict]]) -> List[dict]:
    """The pending steps' device metrics on the host, in ONE copy: every
    value stacked as float64 (exact for the fp32 losses and norms, the
    flags and the scale), then moved with a single ``.cpu()``."""
    keys = [sorted(m) for _, m in pending]
    flat = [torch.as_tensor(m[k]).reshape(()).to(torch.float64)
            for (_, m), ks in zip(pending, keys) for k in ks]
    values = torch.stack(flat).cpu().tolist() if flat else []
    out, i = [], 0
    for ks in keys:
        out.append(dict(zip(ks, values[i:i + len(ks)])))
        i += len(ks)
    return out


def run_training(
    step_fn: Callable,
    state: dict,
    batch_fn: Callable,
    num_steps: int,
    *,
    rng: Optional[torch.Tensor] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_manager=None,
    config: Optional[ResilienceConfig] = None,
    fault_injector=None,
) -> TrainingResult:
    """Drive ``step_fn`` for ``num_steps`` with watchdog, rollback,
    retrying checkpoints and preemption handling.

    Args:
      step_fn: ``(state, batch, rng) -> (state, metrics)`` — what
        :func:`make_resilient_train_step` builds. ``metrics`` may carry
        ``loss`` (scalar), ``grad_norm`` and ``skipped``; missing keys
        simply disable the corresponding watchdog checks.
      state: a :func:`make_train_state` dict (must hold a 0-dim ``step``
        tensor — it is the resume/rollback anchor). Restores write into
        its tensors in place.
      batch_fn: ``(step) -> batch`` or ``(step, retry_epoch) -> batch``.
        Must be a pure function of its arguments: rollback re-reads past
        steps, and the epoch increments per rollback to re-seed the
        poisoned window.
      rng: optional base :mod:`~apex_tpu_torch.utils.prng` key; the
        per-step key is ``fold_in(rng, step)`` so a rolled-back or
        resumed run replays identical streams.
      checkpoint_dir / checkpoint_manager: where to save. Pass a directory
        (a :class:`RetryingCheckpointManager` is built from the config
        knobs, wired to the fault injector's save hook) or a ready-made
        manager. With neither, the run still watches for divergence but
        cannot roll back — a verdict raises :class:`TrainingDiverged`.
      fault_injector: a :class:`apex_tpu_torch.testing_faults.
        FaultInjector`.

    Returns a :class:`TrainingResult`; raises :class:`TrainingDiverged`
    when recovery is impossible within the budget.
    """
    cfg = config or ResilienceConfig()
    log = get_logger(__name__)
    if not (isinstance(state, dict) and "step" in state):
        raise ValueError("state must be a make_train_state-style dict with "
                         "a scalar 'step' leaf")

    def _wrap(base) -> RetryingCheckpointManager:
        return RetryingCheckpointManager(
            base, max_retries=cfg.save_retries,
            backoff_base=cfg.save_backoff_base,
            backoff_max=cfg.save_backoff_max,
            delete_corrupt=cfg.delete_corrupt,
            async_writes=cfg.checkpoint_async,
            drain_on_force=cfg.preemption_drain,
            metrics=cfg.metrics,
            before_save=getattr(fault_injector, "before_checkpoint_save",
                                None))

    mgr = None
    own_mgr = False
    if checkpoint_manager is not None:
        mgr = checkpoint_manager
        if isinstance(mgr, (CheckpointManager, ShardedCheckpointManager)):
            mgr = _wrap(mgr)
        elif (isinstance(mgr, RetryingCheckpointManager)
                and cfg.metrics is not None and mgr.metrics is None):
            # a pre-wrapped manager still reports into the attached
            # registry, else the monitor's ckpt_* counters cannot
            # reconcile with the merged telemetry
            mgr.metrics = cfg.metrics
    elif checkpoint_dir is not None:
        # manager-level interval gating stays at 1: the loop decides
        # when to save, and rollback/emergency saves must never be
        # swallowed
        if cfg.checkpoint_format == "sharded":
            base = ShardedCheckpointManager(
                checkpoint_dir, max_to_keep=cfg.max_to_keep,
                save_interval_steps=1)
        elif cfg.checkpoint_format == "orbax":
            base = CheckpointManager(checkpoint_dir,
                                     max_to_keep=cfg.max_to_keep,
                                     save_interval_steps=1)
        else:
            raise ValueError(
                f"unknown checkpoint_format {cfg.checkpoint_format!r} "
                f"(expected 'sharded' or 'orbax')")
        mgr = _wrap(base)
        own_mgr = True

    watchdog = Watchdog(cfg)
    get_batch = _batch_caller(batch_fn)
    telemetry = {"steps": 0, "skips": 0, "rollbacks": 0, "preemptions": 0,
                 "emergency_saves": 0, "resumes": 0, "verdicts": 0,
                 "retraces": 0}
    reg = cfg.metrics
    prof = cfg.profiler
    step_metrics = None
    if reg is not None:
        # every telemetry key exists in the registry from step 0, so the
        # final counters snapshot reconciles key-for-key even for
        # incident types that never fired
        reg.declare_counters(*telemetry)
        ckpt_telemetry = getattr(mgr, "telemetry", None) or {}
        reg.declare_counters(*("ckpt_" + k for k in ckpt_telemetry))
        for k, v in ckpt_telemetry.items():
            if v:
                # a pre-used manager arrives with history: seed the
                # registry so the final snapshot still equals the merged
                # telemetry key-for-key
                reg.inc("ckpt_" + k, v)
        step_metrics = StepMetrics(
            reg, tokens_per_step=cfg.tokens_per_step,
            model_flops_per_step=cfg.model_flops_per_step,
            peak_flops=cfg.peak_flops,
            memory_interval_steps=cfg.memory_stats_interval_steps)

    def _tick(key: str, n: int = 1) -> None:
        """One incident, two ledgers: the TrainingResult telemetry dict
        and (when attached) the registry counter of the same name."""
        telemetry[key] += n
        if reg is not None:
            reg.inc(key, n)

    history: List[dict] = []
    pending: List[Tuple[int, Any]] = []

    host_step = int(state["step"])
    rollbacks = 0
    data_epoch = 0

    if mgr is not None and cfg.resume:
        restored = mgr.restore_latest(state)
        if restored is not None:
            ckpt_step, state = restored
            host_step = int(state["step"])
            _tick("resumes")
            log_event(log, "training_resumed", step=host_step,
                      checkpoint=ckpt_step, level="info")
            if reg is not None:
                reg.event("training_resumed", step=host_step,
                          checkpoint=ckpt_step)

    def _flush() -> Optional[WatchdogVerdict]:
        """Copy pending device metrics to host and feed the watchdog —
        the ONLY place the loop blocks on the device, so the step loop
        runs ``poll_interval_steps`` ahead of the anomaly checks."""
        nonlocal pending
        if not pending:
            return None
        values = _host_metrics(pending)
        verdict = None
        for (step_i, _), vals in zip(pending, values):
            loss = float(vals["loss"]) if "loss" in vals else float("nan")
            gnorm = vals.get("grad_norm")
            gnorm = None if gnorm is None else float(gnorm)
            skipped = bool(vals.get("skipped", False))
            _tick("skips", int(skipped))
            if cfg.record_history:
                history.append({"step": step_i, "loss": loss,
                                "grad_norm": gnorm, "skipped": skipped})
            if step_metrics is not None:
                scale = vals.get("loss_scale")
                step_metrics.record_polled(
                    step_i, loss=loss, grad_norm=gnorm, skipped=skipped,
                    loss_scale=None if scale is None else float(scale))
                if skipped:
                    reg.event("skip", step=step_i)
            if verdict is None:
                verdict = watchdog.observe(step_i, loss, gnorm, skipped)
        pending = []
        return verdict

    def _rollback(verdict: WatchdogVerdict) -> None:
        nonlocal state, host_step, data_epoch, rollbacks
        _tick("verdicts")
        log_event(log, "watchdog_verdict", reason=verdict.reason,
                  step=verdict.step, first_bad_step=verdict.first_bad_step,
                  detail=verdict.detail, level="error")
        if reg is not None:
            reg.event("watchdog_verdict", reason=verdict.reason,
                      step=verdict.step,
                      first_bad_step=verdict.first_bad_step,
                      detail=verdict.detail)
        if prof is not None:
            prof.on_incident(verdict.reason, verdict.step)
        if mgr is None:
            raise TrainingDiverged(
                f"watchdog verdict '{verdict.reason}' at step "
                f"{verdict.step} and no checkpoint manager to roll back "
                f"with: {verdict.detail}", telemetry)
        rollbacks += 1
        _tick("rollbacks")
        if rollbacks > cfg.max_rollbacks:
            raise TrainingDiverged(
                f"rollback budget exhausted ({cfg.max_rollbacks}) after "
                f"verdict '{verdict.reason}' at step {verdict.step}",
                telemetry)
        restored = mgr.restore_before(verdict.first_bad_step, state)
        if restored is None:
            raise TrainingDiverged(
                f"no healthy checkpoint older than step "
                f"{verdict.first_bad_step} to roll back to", telemetry)
        ckpt_step, state = restored
        # checkpoints newer than the restore point were written inside the
        # undetected window — delete them so neither a later rollback nor
        # a crash-resume can land on suspect state
        for s in mgr.manager.all_steps():
            if s > ckpt_step:
                try:
                    mgr.manager.delete(s)
                except Exception:  # noqa: BLE001
                    pass
        if "scaler" in state:
            sc = state["scaler"]
            with torch.no_grad():
                # IEEE division by the decay (a tensor divisor: torch
                # multiplies by the reciprocal of a Python number)
                decayed = sc.loss_scale / torch.full_like(
                    sc.loss_scale, cfg.rollback_scale_decay)
                sc.loss_scale.copy_(torch.clamp_min(decayed, 1.0))
                sc.growth_tracker.zero_()
                sc.unskipped.zero_()
        host_step = int(state["step"])
        if cfg.reseed_data_on_rollback:
            data_epoch += 1
        watchdog.reset()
        log_event(log, "rollback", to_step=ckpt_step, attempt=rollbacks,
                  budget=cfg.max_rollbacks, data_epoch=data_epoch,
                  level="warning")
        if reg is not None:
            reg.event("rollback", to_step=ckpt_step, attempt=rollbacks,
                      budget=cfg.max_rollbacks, data_epoch=data_epoch)

    status = "completed"
    try:
        with _SigtermGuard(cfg.handle_sigterm) as guard:
            while True:
                while host_step < num_steps:
                    faults = (fault_injector.begin_step()
                              if fault_injector is not None else None)
                    if guard.triggered or (faults is not None
                                           and faults.preempt):
                        source = ("sigterm" if guard.triggered
                                  else "injected")
                        _flush()
                        _tick("preemptions")
                        status = "preempted"
                        if mgr is not None:
                            saved = mgr.save(host_step, state, force=True)
                            _tick("emergency_saves", int(saved))
                            log_event(log, "preemption_save",
                                      step=host_step, saved=saved,
                                      source=source, level="warning")
                            if reg is not None:
                                reg.event("preemption_save",
                                          step=host_step, saved=saved,
                                          source=source)
                        break
                    batch = get_batch(host_step, data_epoch)
                    if faults is not None and faults.nan_grads:
                        from apex_tpu_torch.testing_faults import (
                            poison_batch,
                        )
                        batch = poison_batch(batch)
                    step_rng = (None if rng is None
                                else prng.fold_in(rng, host_step))
                    if step_metrics is not None:
                        step_metrics.begin_step()
                    state, metrics = step_fn(state, batch, step_rng)
                    host_step += 1
                    _tick("steps")
                    if step_metrics is not None:
                        step_metrics.end_step(host_step)
                    if prof is not None:
                        prof.on_step(host_step)
                    pending.append((host_step, metrics))

                    at_save = (mgr is not None
                               and host_step % cfg.save_interval_steps == 0)
                    if len(pending) >= cfg.poll_interval_steps or at_save:
                        # vet before saving: a checkpoint is only written
                        # once every step it contains passed the watchdog
                        verdict = _flush()
                        if verdict is not None:
                            _rollback(verdict)
                            continue
                    if at_save:
                        mgr.save(host_step, state)

                if status == "preempted":
                    break
                # the tail of the run may not land on a poll boundary —
                # flush, and if the LAST window diverged, roll back and
                # take another pass over the remaining steps
                verdict = _flush()
                if verdict is not None:
                    _rollback(verdict)
                    continue
                if mgr is not None and cfg.save_final:
                    # settle in-flight async writes before deciding
                    # whether the final step still needs a (sync) save
                    mgr.wait_until_finished()
                    if mgr.manager.latest_step() != host_step:
                        mgr.save(host_step, state, force=True)
                break
    finally:
        if prof is not None and prof.active:
            prof.stop(host_step)
        if mgr is not None:
            try:
                mgr.wait_until_finished()
            finally:
                if own_mgr:
                    mgr.close()
            # merge the (now-quiesced) checkpoint ledger into the run
            # telemetry under a ckpt_ prefix — the same names the
            # registry counters carry, so the monitor reconciles both
            for k, v in (getattr(mgr, "telemetry", None) or {}).items():
                telemetry["ckpt_" + k] = v
        if reg is not None:
            # the final snapshot is the monitor CLI's reconciliation
            # anchor — flush even on the TrainingDiverged exit paths
            reg.flush()

    return TrainingResult(state, status, host_step, rollbacks, telemetry,
                          history)
