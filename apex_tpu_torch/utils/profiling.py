"""Tracing / profiling helpers (counterpart of
``apex_tpu/utils/profiling.py``).

The reference's NVTX plumbing (DDP's ``prof`` flag wraps hooks in
``torch.cuda.nvtx`` ranges; the imagenet example calls
``cudaProfilerStart`` at a chosen iteration), on the port:

- :func:`nvtx_range` — a ``torch.cuda.nvtx`` push/pop where a card is
  present, inside a ``torch.profiler.record_function`` scope, so the name
  shows in Nsight and in ``torch.profiler`` traces alike; pass a
  :class:`~apex_tpu_torch.observability.registry.MetricsRegistry` and the
  scope also records its host-side wall duration into the
  ``span/<name>_s`` histogram;
- :func:`profiler_start` / :func:`profiler_stop` / :func:`trace` —
  ``torch.profiler`` capture (CPU and, where a card is present, CUDA
  activity) to a TensorBoard-readable directory;
- :func:`annotate_fn` — decorator form of :func:`nvtx_range`;
- :func:`device_memory_stats` — a card's live/peak byte counts from
  ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from apex_tpu_torch.ops._support import resolve_device

__all__ = ["nvtx_range", "annotate_fn", "profiler_start", "profiler_stop",
           "trace", "device_memory_stats"]

#: the capture :func:`profiler_start` opened, until :func:`profiler_stop`
_ACTIVE: Optional[torch.profiler.profile] = None


@contextlib.contextmanager
def nvtx_range(name: str, registry=None):
    """``with nvtx_range("fwd"):`` — names the enclosed work in the
    profiler timeline (an NVTX range where a card is present, and a
    ``torch.profiler`` scope). With ``registry`` (a ``MetricsRegistry``),
    the scope's host-side wall duration is also observed into the
    ``span/<name>_s`` histogram: dispatch time, not device time — in a
    saturated pipeline they converge; either way it costs no sync."""
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if registry is not None:
            registry.observe(f"span/{name}_s", time.perf_counter() - t0)


def annotate_fn(name: Optional[str] = None, registry=None) -> Callable:
    """Decorator: run the function under a named scope (optionally timed
    into ``registry``, as :func:`nvtx_range`)."""

    def deco(fn: Callable) -> Callable:
        scope = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with nvtx_range(scope, registry=registry):
                return fn(*a, **kw)

        return wrapped

    return deco


def profiler_start(log_dir: str) -> None:
    """Begin a ``torch.profiler`` trace written to ``log_dir`` when
    stopped (role of ``cudaProfilerStart`` at iteration N, reference
    ``examples/imagenet/main_amp.py:335-339``)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a profiler capture is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    _ACTIVE = prof


def profiler_stop() -> None:
    """End the capture :func:`profiler_start` began and write its trace."""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("no profiler capture is running")
    prof, _ACTIVE = _ACTIVE, None
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Context-manager form: profile exactly the enclosed iterations."""
    profiler_start(log_dir)
    try:
        yield
    finally:
        profiler_stop()


#: ``torch.cuda.memory_stats`` keys under the JAX package's names
_MEMORY_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
                "peak_bytes_in_use": "allocated_bytes.all.peak"}


def device_memory_stats(device: Union[str, torch.device, None] = "cuda"
                        ) -> Dict[str, Any]:
    """Live/peak byte counts of one card from ``torch.cuda.memory_stats``
    under the JAX package's names, with ``bytes_limit`` its memory; an
    empty dict for the CPU, which keeps no such stats."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {}
    stats = torch.cuda.memory_stats(dev)
    out = {name: stats[key] for name, key in _MEMORY_KEYS.items()
           if key in stats}
    out["bytes_limit"] = torch.cuda.get_device_properties(dev).total_memory
    return out
