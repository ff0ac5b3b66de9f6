"""Library logging with rank context and structured incident lines.

Adapted from ``apex_tpu/utils/logging.py`` (stdlib only), kept in the port
so it never imports the JAX package. The rank prefix reads the
``torch.distributed`` launcher's ``RANK`` variable (the JAX package reads
its process index and mesh coordinates).
"""

from __future__ import annotations

import itertools
import logging
import os
import time

__all__ = ["RankInfoFormatter", "get_logger", "log_event"]


def _rank_info() -> str:
    """A compact rank string: the process rank."""
    return f"rank={os.environ.get('RANK', '0')}"


class RankInfoFormatter(logging.Formatter):
    """Formatter injecting ``%(rank_info)s`` into every record."""

    def format(self, record: logging.LogRecord) -> str:
        record.rank_info = _rank_info()
        return super().format(record)


_LOGGER_NAME = "apex_tpu_torch"

#: process-wide event ordering.  ``next()`` on a count is atomic under
#: the GIL, so concurrent emitters get strictly increasing, gap-free
#: sequence numbers.
_EVENT_SEQ = itertools.count()


def log_event(logger: logging.Logger, event: str, *, level: str = "warning",
              **fields) -> str:
    """Structured failure/recovery telemetry: one ``logfmt``-style line
    (``event=<name> seq=<n> ts=<monotonic> wall=<epoch> key=value ...``)
    per incident, machine-greppable by event name. ``seq`` is a
    process-wide strictly increasing counter and ``ts`` a monotonic-clock
    stamp, so events can be totally ordered and rate-measured even when the
    logging backend reorders or batches lines; ``wall`` is epoch seconds,
    the only stamp comparable across processes. Returns the formatted line
    (callers embed it in exceptions)."""
    parts = [f"event={event}", f"seq={next(_EVENT_SEQ)}",
             f"ts={time.monotonic():.6f}", f"wall={time.time():.6f}"]
    for k in sorted(fields):
        v = fields[k]
        v = f"{v:.6g}" if isinstance(v, float) else str(v)
        if any(c.isspace() for c in v):
            v = '"' + v.replace('"', "'") + '"'
        parts.append(f"{k}={v}")
    line = " ".join(parts)
    logger.log(getattr(logging, level.upper(), logging.WARNING), "%s", line)
    return line


def get_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not getattr(logger, "_apex_tpu_torch_configured", False):
        handler = logging.StreamHandler()
        handler.setFormatter(
            RankInfoFormatter(
                "%(asctime)s [%(levelname)s] [%(rank_info)s] %(name)s: "
                "%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("APEX_TPU_LOG_LEVEL", "WARNING"))
        logger.propagate = False
        logger._apex_tpu_torch_configured = True  # type: ignore[attr-defined]
    return logger
