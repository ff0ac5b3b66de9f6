"""Deterministic serving faults for the engine and its supervisor.

The serving half of ``apex_tpu/testing_faults.py`` (stdlib and numpy),
kept in the port so it never imports the JAX package. Pass a
:class:`ServingFaultInjector` as ``faults=`` to
:class:`~apex_tpu_torch.serving.InferenceEngine` or
:class:`~apex_tpu_torch.serving.supervisor.EngineSupervisor`; the engine
calls its hooks from fixed host-side points. Schedules key on the
injector's own monotonically advancing call counters, so a restarted
engine re-running the same positions proceeds clean (transient faults).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["InjectedEngineFault", "ServingFaultInjector"]


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
