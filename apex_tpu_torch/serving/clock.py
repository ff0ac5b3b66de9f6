"""The serving clock seam: every time read in the engine goes through
this module.

Adapted from ``apex_tpu/serving/clock.py`` (stdlib only), kept in the port
so it never imports the JAX package. :func:`now` is the monotonic clock
(durations, deadlines), :func:`wall` the epoch stamp on records,
:func:`sleep` the loadtest runner's pacing between arrivals. The JAX
package's virtual clock serves its model checker and comes with it
(ROADMAP §1 item 10).
"""

from __future__ import annotations

import time as _time  # the ONE sanctioned wall-clock import in serving/

__all__ = ["now", "wall", "sleep"]


def now() -> float:
    """Monotonic seconds — durations, deadlines."""
    return _time.monotonic()


def wall() -> float:
    """Epoch seconds — the ``"wall"`` stamp on telemetry records."""
    return _time.time()


def sleep(seconds: float) -> None:
    """Pause the caller for ``seconds`` (open-loop pacing)."""
    if seconds > 0:
        _time.sleep(seconds)
