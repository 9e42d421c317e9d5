"""The generic phased SSSP algorithm (counterpart of ``repro.core.phased``).

Per phase: (1) evaluate the criterion over the fringe
(``criteria.evaluate``, the dense semantics over the COO arcs), (2) settle
every matching vertex at once, (3) relax all their outgoing edges as one
masked gather and segment-min, (4) update fringe and unexplored status.
This is the reference path the stepper's plans are held against, not a
fast one: each phase runs on the graph's device and the host reads
``any(status == F)`` once a phase (the reference runs a device loop).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import criteria as C
from repro_torch.core.graph import Graph, f32_rows, graph_device, out_degrees
from repro_torch.kernels import ref as kref

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PhasedResult:
    dist: torch.Tensor  # (n,) f32 final distances (inf = unreachable)
    status: torch.Tensor  # (n,) int8
    phases: torch.Tensor  # scalar int32: number of phases executed
    sum_fringe: np.int64  # sum over phases of |F| (paper Table 2)
    settled_per_phase: torch.Tensor | None  # (trace_len,) int32 (0 beyond
    #   `phases`), or None when tracing was disabled (trace_len=1)
    relax_edges: np.int64  # total out-edges relaxed (work)


def _phase_step(g: Graph, names, dist_true, out_deg, d, status):
    """One phase: ``(new_d, new_status, |F|, settled, relaxed out-edges)``."""
    fringe = status == C.F
    ctx = C.CritContext(
        src=g.src, dst=g.dst, w=g.w,
        in_min_static=g.in_min_static, out_min_static=g.out_min_static,
        d=d, status=status, fringe=fringe,
        min_fringe_d=kref.amin(torch.where(fringe, d, INF)),
        dist_true=dist_true,
    )
    settle = C.evaluate(names, ctx)
    src = g.src.long()
    # the push form: one masked gather and a segment-min (padding arcs
    # carry w = +inf)
    cand = torch.where(settle[src], d[src] + g.w, INF)
    upd = kref.segment_min(cand, g.dst, g.n)
    new_d = kref.nan_min(d, upd)
    new_status = torch.where(
        settle, C.S,
        torch.where((status == C.U) & (upd < INF), C.F, status),
    ).to(torch.int8)
    relaxed = torch.where(settle, out_deg, 0).sum(dtype=torch.int64)
    return (new_d, new_status, fringe.sum(dtype=torch.int64),
            settle.sum(dtype=torch.int32), relaxed)


def run_phased(
    g: Graph,
    source: int = 0,
    criterion: str = "instatic|outstatic",
    dist_true=None,
    trace_len: int = 1,
    max_phases: int | None = None,
    device=None,
) -> PhasedResult:
    """Run the generic phased SSSP algorithm on ``device`` (None = the CUDA
    card; the graph's).

    ``criterion`` is any '|'-joined criterion string; ``dist_true`` the
    (n,) true distances, required iff it includes 'oracle' (zeros
    otherwise, as in the reference). ``trace_len`` sizes the
    settled-per-phase trace: phase p writes slot ``min(p, trace_len - 1)``
    (1 disables it). ``max_phases`` caps the loop (default n + 1: every
    criterion settles at least one vertex a phase).
    """
    dev = graph_device(g, device)
    names = C.parse(criterion)
    if "oracle" in names and dist_true is None:
        raise ValueError("criterion 'oracle' requires dist_true")
    if dist_true is None:
        dt = torch.zeros((g.n,), dtype=torch.float32, device=dev)
    else:
        dt = f32_rows(dist_true, dev)
    cap = int(max_phases) if max_phases is not None else g.n + 1
    d = torch.full((g.n,), INF, dtype=torch.float32, device=dev)
    d[int(source)] = 0.0
    status = torch.zeros((g.n,), dtype=torch.int8, device=dev)
    status[int(source)] = C.F
    out_deg = out_degrees(g)
    trace = torch.zeros((int(trace_len),), dtype=torch.int32, device=dev)
    sum_f = torch.zeros((), dtype=torch.int64, device=dev)
    redges = torch.zeros((), dtype=torch.int64, device=dev)
    phases = 0
    while phases < cap and bool(torch.any(status == C.F)):
        d, status, n_f, n_settled, relaxed = _phase_step(
            g, names, dt, out_deg, d, status)
        trace[min(phases, trace.shape[0] - 1)] = n_settled
        sum_f, redges = sum_f + n_f, redges + relaxed
        phases += 1
    return PhasedResult(
        dist=d,
        status=status,
        phases=torch.tensor(phases, dtype=torch.int32, device=dev),
        sum_fringe=np.int64(sum_f.item()),
        settled_per_phase=trace,
        relax_edges=np.int64(redges.item()),
    )
