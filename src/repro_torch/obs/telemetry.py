"""Per-phase engine telemetry decoded from the stepper's rings (counterpart
of ``repro.obs.telemetry``; the record, metric and event formats are the
reference's).

The rings (``BatchState.settled_trace`` and, with ``telemetry=True``,
``fringe_trace`` / ``relax_trace`` / ``attr_trace``) are written on the
device, one slot a phase; this module reads a state on the host and turns
it into :class:`PhaseTelemetry` records, then publishes them into a
metrics registry and a tracer.

Attribution: each settled vertex is credited to exactly one member of the
criterion plan, the first in canonical term order whose settle mask
proves it, so the per-term counts partition the settled set and sum to
``settled``. A bare-``oracle`` plan has one more slot, ``dijk_fallback``,
for vertices its DIJK progress guard settled. The ``"delta"`` policy
records light, heavy and bucket slots instead.

(The core import is deferred into the function, as in the reference.)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PhaseTelemetry:
    """One engine phase of one lane, decoded.

    ``attribution`` maps attribution term -> count for this phase. For
    criterion plans the values sum to ``settled``; for the ``"delta"``
    policy they are light / heavy / bucket (see
    :func:`attribution_terms`).
    """

    lane: int
    phase: int  # 0-based phase index within the lane's current query
    fringe: int  # |F| at phase entry
    settled: int  # vertices settled this phase
    relax_edges: int  # out-edges relaxed this phase
    attribution: dict[str, int]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def attribution_terms(criterion: str) -> tuple[str, ...]:
    """The policy's attribution slot names, in recorded order."""
    from repro_torch.core import policies as P

    return P.policy_for(criterion).attribution_terms()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def phase_telemetry(state, lanes=None) -> list[PhaseTelemetry]:
    """Decode a telemetry-enabled ``BatchState`` into per-phase records.

    Needs a state built with ``init_batch_state(..., telemetry=True)`` and a
    ring no live lane wrapped (``trace_len >=`` the lane's phase count): a
    wrapped ring has overwritten the early phases. ``lanes`` restricts the
    decoding to a subset (default all).
    """
    if getattr(state, "attr_trace", None) is None:
        raise ValueError(
            "state carries no telemetry rings — build it with "
            "init_batch_state(..., telemetry=True, trace_len>=expected phases)"
        )
    phases = _host(state.phases)
    settled = _host(state.settled_trace)
    trace_len = settled.shape[1]
    fringe = _host(state.fringe_trace)
    relax = _host(state.relax_trace)
    attr = _host(state.attr_trace)  # (B, trace_len, T)
    terms = attribution_terms(state.criterion)
    out: list[PhaseTelemetry] = []
    for lane in range(phases.shape[0]) if lanes is None else lanes:
        p = int(phases[lane])
        if p > trace_len:
            raise ValueError(
                f"lane {lane} ran {p} phases but the ring holds only "
                f"{trace_len} — early phases were overwritten; re-run with "
                f"trace_len >= {p}"
            )
        for ph in range(p):
            out.append(PhaseTelemetry(
                lane=lane,
                phase=ph,
                fringe=int(fringe[lane, ph]),
                settled=int(settled[lane, ph]),
                relax_edges=int(relax[lane, ph]),
                attribution={
                    t: int(attr[lane, ph, k]) for k, t in enumerate(terms)
                },
            ))
    return out


def publish_phase_telemetry(records, registry, prefix: str = "engine") -> None:
    """Fold phase records into a registry: per-phase histograms
    (``engine.phase.fringe`` / ``.settled`` / ``.relax_edges``), the phase
    counter, and one counter per attribution term
    (``engine.settled.<term>``)."""
    h_fringe = registry.histogram(f"{prefix}.phase.fringe",
                                  "fringe size |F| per phase")
    h_settled = registry.histogram(f"{prefix}.phase.settled",
                                   "vertices settled per phase")
    h_relax = registry.histogram(f"{prefix}.phase.relax_edges",
                                 "out-edges relaxed per phase")
    c_phases = registry.counter(f"{prefix}.phases", "engine phases executed")
    for rec in records:
        h_fringe.observe(rec.fringe)
        h_settled.observe(rec.settled)
        h_relax.observe(rec.relax_edges)
        c_phases.inc()
        for term, count in rec.attribution.items():
            registry.counter(
                f"{prefix}.settled.{term}",
                f"vertices settled by criterion member {term!r}",
            ).inc(count)


def trace_phase_telemetry(records, tracer, lane_prefix: str = "engine lane",
                          us_per_phase: float = 1000.0) -> None:
    """Render phase records as synthetic trace spans: one row a lane, one
    fixed-width slice a phase, its counts as the slice's args (the device
    loop has no per-phase host timestamps)."""
    if not tracer.enabled:
        return
    for rec in records:
        tid = f"lane {rec.lane}"
        tracer.name_thread(tid, f"{lane_prefix} {rec.lane}")
        ev = {
            "ph": "X", "name": f"phase {rec.phase}", "cat": "phase",
            "pid": tracer.pid, "tid": tid, "ts": rec.phase * us_per_phase,
            "dur": us_per_phase,
            "args": {
                "fringe": rec.fringe, "settled": rec.settled,
                "relax_edges": rec.relax_edges, **rec.attribution,
            },
        }
        tracer._emit(ev)  # synthetic timestamps bypass the wall clock
