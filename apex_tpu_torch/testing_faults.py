"""Deterministic fault injection for the resilience layer and the engine.

Counterpart of ``apex_tpu/testing_faults.py`` (torch, numpy and the
stdlib), kept in the port so it never imports the JAX package. Every
recovery path of :mod:`apex_tpu_torch.resilience` is driven
deterministically by a scripted :class:`FaultInjector`:

- **NaN gradients** — scheduled step calls get their batch poisoned to
  NaN (:func:`poison_batch`), which propagates to NaN loss/grads through
  the model's own backward, exactly as a numeric blow-up would (the
  scaler sees ``found_inf``, the optimizer skips, the watchdog counts);
- **checkpoint write failures** — scheduled save steps raise ``IOError``
  from the save hook for the first N attempts, exercising the
  retry/backoff loop (N < retry budget) or terminal save failure
  (N >= budget);
- **simulated preemption** — a scheduled step call reports "preempt now",
  driving the same emergency-save-and-exit flow as a real SIGTERM;
- **post-commit corruption** — :func:`corrupt_checkpoint` garbles a
  committed step directory on disk, so restore must fall back to an
  older step;
- **shard-level corruption** — :func:`corrupt_shard` (bit-flip, truncate,
  or delete ONE shard file of a committed sharded-format step) and
  :func:`tear_manifest` (garble the manifest after commit): damage the
  per-shard sha256 / manifest-sha256 verification must catch;
- **value-level poisoning** — :func:`corrupt_checkpoint_weights`
  overwrites a committed step's floating-point shards with non-finite
  values AND re-checksums the manifest + commit marker, so every
  integrity check passes on the poisoned bytes;
- **slow writes** — ``save_delays`` stretches a scheduled save attempt by
  sleeping in the save hook, pinning an async background write in flight
  while the test preempts/drains/abandons around it.

Fault schedules key on the injector's own **call counter** (one tick per
train-step invocation), not on the training-state step number: after a
rollback the re-run of the same state steps proceeds clean, modelling
transient faults.

:class:`ServingFaultInjector` is the serving-side sibling: pass it as
``faults=`` to :class:`~apex_tpu_torch.serving.InferenceEngine` or
:class:`~apex_tpu_torch.serving.supervisor.EngineSupervisor`; the engine
calls its hooks from fixed host-side points. Its counters keep advancing
across engine rebuilds, so a schedule fires once and the restarted engine
proceeds clean.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.utils.tree import tree_map

__all__ = ["FaultInjector", "StepFaults", "poison_batch",
           "corrupt_checkpoint", "corrupt_shard",
           "corrupt_checkpoint_weights", "tear_manifest",
           "InjectedEngineFault", "ServingFaultInjector"]


@dataclass
class StepFaults:
    """What the injector wants done to one train-step invocation."""
    call: int
    nan_grads: bool = False
    preempt: bool = False


def _poison(x):
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan")) if x.is_floating_point() \
            else x
    if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        return np.full_like(x, np.nan)
    return x


def poison_batch(batch: Any) -> Any:
    """NaN every floating leaf of ``batch`` — the injected fault that turns
    into NaN gradients through the model's own backward pass (a GPT
    batch's ``loss_mask`` is its one floating leaf)."""
    return tree_map(_poison, batch)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(os.fspath(directory)), str(step))


def corrupt_checkpoint(directory: str, step: int) -> int:
    """Overwrite every file of a *committed* step directory with garbage,
    simulating storage corruption that the commit protocol cannot catch.
    Returns the number of files garbled (0 means the step directory was
    not found — a test bug, assert on it)."""
    count = 0
    for root, _, files in os.walk(_step_dir(directory, step)):
        for name in files:
            with open(os.path.join(root, name), "wb") as f:
                f.write(b"corrupt")
            count += 1
    return count


def corrupt_shard(directory: str, step: int, *, leaf: int = 0,
                  shard: int = 0, kind: str = "bitflip") -> str:
    """Damage exactly ONE shard file of a committed sharded-format step
    (layout of :class:`apex_tpu_torch.checkpoint.ShardedCheckpointManager`):
    ``"bitflip"`` flips a single bit mid-file, ``"truncate"`` cuts the
    file in half, ``"missing"`` deletes it. All three leave the manifest
    and commit marker intact — the step still *claims* to be healthy, so
    only per-shard checksum/size verification can catch it. Returns the
    damaged file's path; raises ``FileNotFoundError`` when the addressed
    shard does not exist (a test bug)."""
    path = os.path.join(_step_dir(directory, step),
                        f"leaf{int(leaf):04d}_s{int(shard):02d}.npy")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no shard file {path}")
    if kind == "missing":
        os.remove(path)
    elif kind == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif kind == "bitflip":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)[0]
            f.seek(size // 2)
            f.write(bytes([byte ^ 0x40]))
    else:
        raise ValueError(f"kind must be 'bitflip', 'truncate' or "
                         f"'missing', got {kind!r}")
    return path


def _is_floating(name: str) -> bool:
    return name == "bfloat16" or np.issubdtype(np.dtype(name), np.floating)


def corrupt_checkpoint_weights(directory: str, step: int, *,
                               value: float = float("nan")) -> int:
    """Poison the VALUES of a committed sharded-format step while
    keeping every integrity check green: each floating-point shard file
    is rewritten as ``value`` (non-finite by default) in the original
    shape/dtype/format, then the manifest's per-shard ``bytes``/
    ``sha256`` entries and the commit marker's manifest sha are
    re-stamped to match the poisoned bytes. ``verify_step(deep=True)``
    reports healthy and restore succeeds; only serving the weights shows
    the damage. Returns the number of shard files poisoned (0 ⇒ no
    floating leaves — a test bug, assert on it). Integer leaves are left
    untouched."""
    from apex_tpu_torch.checkpoint.manifest import (
        load_manifest,
        sha256_bytes,
        write_commit,
        write_manifest,
    )
    from apex_tpu_torch.checkpoint.sharded import npy_bytes

    step_dir = _step_dir(directory, step)
    manifest = load_manifest(step_dir)
    count = 0
    for _, leaf in sorted(manifest["leaves"].items()):
        name = leaf["dtype"]
        if not _is_floating(name):
            continue
        for shard in leaf["shards"]:
            path = os.path.join(step_dir, shard["file"])
            shape = tuple(b - a for a, b in zip(shard["start"],
                                                shard["stop"]))
            if name == "bfloat16":
                poisoned = torch.full(shape, value, dtype=torch.bfloat16
                                      ).view(torch.int16).numpy()
            else:
                poisoned = np.full(shape, value, dtype=np.dtype(name))
            header, body = npy_bytes(poisoned, name)
            data = header + body.tobytes()
            with open(path, "wb") as f:
                f.write(data)
            shard["bytes"] = len(data)
            shard["sha256"] = sha256_bytes(data)
            count += 1
    sha = write_manifest(step_dir, manifest)
    write_commit(step_dir, sha, int(manifest.get("step", step)))
    return count


def tear_manifest(directory: str, step: int) -> str:
    """Truncate a committed step's ``manifest.json`` to half its length —
    a manifest torn *after* commit (partial overwrite, bit rot). The
    commit marker still pins the original manifest sha256, so loading
    must detect the mismatch and treat the step as corrupt. Returns the
    manifest path."""
    path = os.path.join(_step_dir(directory, step), "manifest.json")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    return path


class FaultInjector:
    """Scripted fault schedule for
    :func:`apex_tpu_torch.resilience.run_training`.

    Args:
      nan_grad_calls: call indices (0-based ticks of the train-step loop)
        whose batch is poisoned to NaN.
      preempt_at_call: first call index at which the injector reports a
        preemption (the loop then emergency-saves and exits cleanly).
      save_failures: ``{checkpoint_step: n}`` — the save hook raises
        ``IOError`` for the first ``n`` attempts at that step.
      save_delays: ``{checkpoint_step: seconds}`` — the save hook sleeps
        before the first attempt at that step (one-shot), holding an
        async background write in flight for preemption-mid-save tests.
    """

    def __init__(self, *, nan_grad_calls: Iterable[int] = (),
                 preempt_at_call: Optional[int] = None,
                 save_failures: Optional[Dict[int, int]] = None,
                 save_delays: Optional[Dict[int, float]] = None):
        self.nan_grad_calls = frozenset(int(c) for c in nan_grad_calls)
        self.preempt_at_call = preempt_at_call
        self._save_failures = dict(save_failures or {})
        self._save_delays = dict(save_delays or {})
        self._call = 0
        self.log = []  # list[StepFaults] — what actually fired, for tests

    # -- train-step loop ---------------------------------------------------
    def begin_step(self) -> StepFaults:
        """Advance the call counter and report this invocation's faults."""
        call = self._call
        self._call += 1
        faults = StepFaults(
            call=call,
            nan_grads=call in self.nan_grad_calls,
            preempt=(self.preempt_at_call is not None
                     and call >= self.preempt_at_call),
        )
        if faults.nan_grads or faults.preempt:
            self.log.append(faults)
        return faults

    @property
    def calls(self) -> int:
        return self._call

    # -- checkpoint layer --------------------------------------------------
    def before_checkpoint_save(self, step: int) -> None:
        """Hook for ``RetryingCheckpointManager(before_save=...)``: delay
        and/or fail the first scheduled attempts at ``step``. For async
        saves this runs on the background writer thread — a delay holds
        that write in flight without stalling the train loop."""
        delay = self._save_delays.pop(step, 0.0)
        if delay > 0:
            time.sleep(delay)
        remaining = self._save_failures.get(step, 0)
        if remaining > 0:
            self._save_failures[step] = remaining - 1
            raise IOError(
                f"injected checkpoint write failure at step {step} "
                f"({remaining - 1} failures remaining)")


class InjectedEngineFault(RuntimeError):
    """Deterministic serving-path fault raised by
    :class:`ServingFaultInjector` — the stand-in for a real decode/prefill
    blow-up (a CUDA error, device OOM, a lost collective)."""


class ServingFaultInjector:
    """Scripted serving faults for ``InferenceEngine``/``EngineSupervisor``.

    Args:
      poison_decode: ``{decode_call: (slot, kind)}`` — corrupt the decode
        OUTPUT for one slot after the step returns. ``kind``
        ``"nonfinite"`` clears the slot's ``isfinite`` flag (what NaN
        logits look like to the host); ``"oov"`` replaces the sampled
        token with an out-of-vocab id. Both drive the engine's quarantine
        path.
      decode_raise_calls: decode call indices that raise
        :class:`InjectedEngineFault` before the step runs.
      prefill_raise_calls: prefill call indices that raise likewise.
      decode_hang: ``{decode_call: seconds}`` — sleep before the step,
        simulating a hung tick for the supervisor's wall-clock budget.
    """

    def __init__(self, *,
                 poison_decode: Optional[Dict[int, Tuple[int, str]]] = None,
                 decode_raise_calls: Iterable[int] = (),
                 prefill_raise_calls: Iterable[int] = (),
                 decode_hang: Optional[Dict[int, float]] = None):
        self.poison_decode = dict(poison_decode or {})
        for call, (_, kind) in self.poison_decode.items():
            if kind not in ("nonfinite", "oov"):
                raise ValueError(
                    f"poison_decode[{call}] kind must be 'nonfinite' or "
                    f"'oov', got {kind!r}")
        self.decode_raise_calls = frozenset(
            int(c) for c in decode_raise_calls)
        self.prefill_raise_calls = frozenset(
            int(c) for c in prefill_raise_calls)
        self.decode_hang = dict(decode_hang or {})
        self.decode_calls = 0
        self.prefill_calls = 0
        self.log = []   # what actually fired, in order, for tests

    # -- engine hook points ------------------------------------------------
    def before_decode(self) -> None:
        """Called right before the decode step; may sleep (hung tick) or
        raise (decode failure)."""
        call = self.decode_calls
        self.decode_calls += 1
        hang = self.decode_hang.get(call)
        if hang:
            self.log.append(("hang", call, hang))
            time.sleep(hang)
        if call in self.decode_raise_calls:
            self.log.append(("decode_raise", call))
            raise InjectedEngineFault(
                f"injected decode failure at decode call {call}")

    def corrupt_decode(self, tokens: np.ndarray, finite: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Called with the decode step's host-side outputs; returns the
        (possibly corrupted) pair the engine's integrity check consumes."""
        spec = self.poison_decode.get(self.decode_calls - 1)
        if spec is not None:
            slot, kind = spec
            tokens = np.array(tokens)
            finite = np.array(finite)
            if kind == "nonfinite":
                finite[slot] = False
            else:
                tokens[slot] = -1        # out-of-vocab sentinel
            self.log.append(("poison", self.decode_calls - 1, slot, kind))
        return tokens, finite

    def before_prefill(self) -> None:
        """Called right before each prefill (or prefill chunk); may
        raise."""
        call = self.prefill_calls
        self.prefill_calls += 1
        if call in self.prefill_raise_calls:
            self.log.append(("prefill_raise", call))
            raise InjectedEngineFault(
                f"injected prefill failure at prefill call {call}")
