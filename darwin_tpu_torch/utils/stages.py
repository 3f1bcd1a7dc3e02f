"""Stage telemetry: host wall seconds per named stage, summed into a
caller's dict (darwin_tpu's ``stage_seconds`` sinks)."""

from __future__ import annotations

import time


def mark(stage_seconds: dict | None, key: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``stage_seconds[key]`` (when a dict
    is given); returns the time now, the next stage's ``t0``."""
    t = time.perf_counter()
    if stage_seconds is not None:
        stage_seconds[key] = stage_seconds.get(key, 0.0) + t - t0
    return t
