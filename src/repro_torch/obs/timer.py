"""The port's one wall-clock API (counterpart of ``repro.obs.timer``).

``timed`` gives the median wall time over ``repeats`` calls and the last
result; :class:`Stopwatch` covers start/stop sites; :func:`now` is the raw
monotonic clock for code that stamps events (the serving scheduler's
injectable default). A host clock measures device work only when the
caller synchronises inside the timed block.
"""
from __future__ import annotations

import time

import numpy as np


def now() -> float:
    """Monotonic wall-clock timestamp in seconds (``perf_counter``)."""
    return time.perf_counter()


def timed(fn, *args, repeats: int = 3, **kw):
    """Median wall time (s) over ``repeats`` calls + last result (no
    implicit warm-up)."""
    ts, out = [], None
    for _ in range(repeats):
        t0 = now()
        out = fn(*args, **kw)
        ts.append(now() - t0)
    return float(np.median(ts)), out


class Stopwatch:
    """Context manager measuring one block: ``elapsed`` in seconds, also
    readable mid-block (the running time)."""

    def __init__(self):
        self._t0: float | None = None
        self._t1: float | None = None

    def __enter__(self) -> "Stopwatch":
        self._t0 = now()
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = now()

    @property
    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return (now() if self._t1 is None else self._t1) - self._t0
