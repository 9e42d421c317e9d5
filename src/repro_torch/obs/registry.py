"""Metrics registry: counters, gauges, histograms; JSON + Prometheus text
(counterpart of ``repro.obs.registry``, the same names and formats).

A :class:`MetricsRegistry` publishes metrics under dotted names
(``serving.latency_s``, ``serving.completed``); ``snapshot()`` and
``to_prometheus()`` render the same state as a JSON report or Prometheus
text exposition.

Every histogram keeps exact lifetime aggregates (count, sum, min, max)
updated on each observation, plus a bounded window of recent values for the
percentile estimates; reports label the windowed fields with the window's
size. ``Counter.inc`` / ``Gauge.set`` / ``Histogram.observe`` take no lock:
they serve the single-threaded serving loop.
"""
from __future__ import annotations

import json
from collections import deque

import numpy as np

DEFAULT_WINDOW = 4096


class Counter:
    """Monotone event count (int or float increments)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, busy lanes)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Value distribution: exact lifetime aggregates + a bounded window.

    ``count``/``sum``/``min``/``max`` are exact over every observation ever
    made; percentiles come from the last ``window`` observations only (a
    long-lived server cannot grow host memory per event). The exact and
    windowed views are reported side by side, never silently substituted —
    ``tests/test_obs.py`` holds the exactness property under windowing.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", window: int = DEFAULT_WINDOW):
        if window < 1:
            raise ValueError(f"histogram window must be >= 1; got {window}")
        self.name = name
        self.help = help
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._window: deque = deque(maxlen=window)

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self._window.append(v)

    @property
    def mean(self) -> float:
        """Exact lifetime mean (sum/count), 0.0 before any observation."""
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Windowed percentile estimate (exact only until the window wraps)."""
        if not self._window:
            return 0.0
        return float(np.percentile(
            np.fromiter(self._window, dtype=np.float64), q
        ))

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            # exact lifetime aggregates (never forget)
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            # windowed estimates (bounded memory; labeled as such)
            "window": self._window.maxlen,
            "window_count": len(self._window),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and exposition."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get(Histogram, name, help, window=window)

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- exposition ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serialisable report: name -> metric snapshot (sorted)."""
        return {nm: self._metrics[nm].snapshot() for nm in self.names()}

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters/gauges as-is,
        histograms as summaries (windowed quantiles + exact sum/count) with
        ``_min``/``_max`` gauges alongside (exact lifetime extrema have no
        standard summary slot, and dropping them is the windowed-max bug
        again)."""
        out: list[str] = []
        for nm in self.names():
            m = self._metrics[nm]
            pname = prom_name(nm)
            if m.help:
                out.append(f"# HELP {pname} {m.help}")
            if isinstance(m, (Counter, Gauge)):
                kind = "counter" if isinstance(m, Counter) else "gauge"
                out.append(f"# TYPE {pname} {kind}")
                out.append(f"{pname} {_prom_num(m.value)}")
            else:
                out.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.9, 0.99):
                    out.append(
                        f'{pname}{{quantile="{q}"}} '
                        f"{_prom_num(m.percentile(q * 100))}"
                    )
                out.append(f"{pname}_sum {_prom_num(m.sum)}")
                out.append(f"{pname}_count {m.count}")
                for suffix, v in (("_min", m.min), ("_max", m.max)):
                    out.append(f"# TYPE {pname}{suffix} gauge")
                    out.append(
                        f"{pname}{suffix} "
                        f"{_prom_num(0.0 if v is None else v)}"
                    )
        return "\n".join(out) + "\n"


def prom_name(name: str) -> str:
    """Dotted metric name -> Prometheus-legal name (dots/dashes -> '_')."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if not safe or safe[0].isdigit():
        safe = "_" + safe
    return safe


def _prom_num(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    return repr(float(v))
