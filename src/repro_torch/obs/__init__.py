"""Observability of the port: metrics registry, span tracer, timer
(counterpart of ``repro.obs``; the trace and metrics formats are the
reference's).

:class:`Observability` is the handle the serving layer takes: a registry +
tracer pair. ``Observability.disabled()`` is safe to plumb through hot
loops: every recording call returns on one attribute check. The telemetry
rings' decoder and the command line wait for ROADMAP Queue 1 items 5 and 9.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import timer
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer, validate_events


@dataclasses.dataclass
class Observability:
    """Registry + tracer bundle, the injection point for instrumented code."""

    registry: MetricsRegistry
    tracer: Tracer

    @classmethod
    def enabled(cls, clock=timer.now, max_events: int | None = None,
                registry: MetricsRegistry | None = None) -> "Observability":
        return cls(
            registry=MetricsRegistry() if registry is None else registry,
            tracer=Tracer(enabled=True, clock=clock, max_events=max_events),
        )

    @classmethod
    def disabled(cls) -> "Observability":
        """A no-op bundle: metrics land in a throwaway registry, the tracer
        records nothing."""
        return cls(registry=MetricsRegistry(), tracer=NULL_TRACER)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Observability",
    "Tracer",
    "timer",
    "validate_events",
]
