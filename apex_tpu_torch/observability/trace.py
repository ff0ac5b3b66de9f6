"""Request trace ids.

From ``apex_tpu/observability/trace.py``, only :func:`new_trace_id` is
copied: the port stamps every request with a trace id, and span emission
comes with a later slice.
"""

from __future__ import annotations

import uuid

__all__ = ["new_trace_id"]


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id, unique across processes."""
    return uuid.uuid4().hex[:16]
