"""Observability of the port: metrics registry, span tracer, timer and the
decoder of the stepper's telemetry rings (counterpart of ``repro.obs``; the
trace, metrics and telemetry formats are the reference's).

:class:`Observability` is the handle the serving layer takes: a registry +
tracer pair. ``Observability.disabled()`` is safe to plumb through hot
loops: every recording call returns on one attribute check.
:mod:`~repro_torch.obs.telemetry` turns a ``telemetry=True`` state into
per-phase records and publishes them. ``python -m repro_torch.obs``
validates and normalises trace files and renders a text dashboard from a
registry snapshot or a saved tuning ledger (the portfolio view).
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import timer
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    set_default_registry,
)
from repro_torch.obs.telemetry import (
    PhaseTelemetry,
    attribution_terms,
    phase_telemetry,
    publish_phase_telemetry,
    trace_phase_telemetry,
)
from repro_torch.obs.tracer import (
    NULL_TRACER,
    Tracer,
    load_trace,
    validate_events,
    validate_trace_file,
)


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
    "PhaseTelemetry",
    "Tracer",
    "attribution_terms",
    "default_registry",
    "load_trace",
    "phase_telemetry",
    "publish_phase_telemetry",
    "set_default_registry",
    "timer",
    "trace_phase_telemetry",
    "validate_events",
    "validate_trace_file",
]
