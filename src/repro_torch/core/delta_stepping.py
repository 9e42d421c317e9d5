"""Dense, vectorised delta-stepping (Meyer & Sanders), the paper's baseline
(counterpart of ``repro.core.delta_stepping``).

Buckets of width ``delta``; the lowest non-empty bucket is drained by
light-edge (w <= delta) rounds, reprocessing a vertex whose tentative
distance drops below the one it was last processed at, then everything
removed from the bucket relaxes its heavy edges once and settles. Each
light round and each heavy round is one phase, as in the phased engines.
A relax is one masked gather and a segment-min over the COO arcs.

This is the legacy loop the stepper's ``DeltaPolicy`` is held against: each
phase runs on the graph's device and the host reads the loop conditions
once a phase (the reference runs device loops).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import Graph, graph_device, out_degrees
from repro_torch.kernels import ref as kref

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    dist: torch.Tensor  # (n,) f32
    phases: torch.Tensor  # scalar int32 (light rounds + heavy rounds)
    buckets_processed: torch.Tensor  # scalar int32
    relax_edges: np.int64  # out-edges scanned from processed sets; a
    #   vertex is rescanned every light round it re-enters its bucket, so
    #   this is not bounded by m


def default_delta(g: Graph) -> float:
    """Meyer-Sanders heuristic delta = Theta(1 / average degree), in Python
    floats (a state stores it rounded to f32 once)."""
    m = float(g.num_real_edges)
    return max(float(g.n) / max(m, 1.0), 1e-3)


def _run(g: Graph, source: int, delta: torch.Tensor, max_phases: int):
    n, dev = g.n, g.device
    real = torch.isfinite(g.w)
    light_e = real & (g.w <= delta)
    heavy_e = real & (g.w > delta)
    out_deg = out_degrees(g)
    src = g.src.long()
    tent = torch.full((n,), INF, dtype=torch.float32, device=dev)
    tent[source] = 0.0
    settled = torch.zeros((n,), dtype=torch.bool, device=dev)
    phases = buckets = 0
    work = torch.zeros((), dtype=torch.int64, device=dev)

    def relax(tent, from_mask, edge_mask):
        cand = torch.where(from_mask[src] & edge_mask, tent[src] + g.w, INF)
        return kref.nan_min(tent, kref.segment_min(cand, g.dst, n))

    def scanned(mask):
        return torch.where(mask, out_deg, 0).sum(dtype=torch.int64)

    while phases < max_phases:
        active = ~settled & torch.isfinite(tent)
        if not bool(active.any()):
            break
        bidx = torch.where(active, torch.floor(tent / delta), INF)
        b = kref.amin(bidx)  # the lowest non-empty bucket
        lo, hi = b * delta, (b + 1.0) * delta
        # drain bucket b with light-edge rounds
        last_proc = torch.full((n,), INF, dtype=torch.float32, device=dev)
        removed = torch.zeros((n,), dtype=torch.bool, device=dev)
        while phases < max_phases:
            cur = (~settled & (tent >= lo) & (tent < hi)
                   & (tent < last_proc))
            if not bool(cur.any()):
                break
            last_proc = torch.where(cur, tent, last_proc)
            removed = removed | cur
            tent = relax(tent, cur, light_e)
            work = work + scanned(cur)
            phases += 1
        # one heavy round for everything removed from the bucket
        tent = relax(tent, removed, heavy_e)
        work = work + scanned(removed)
        settled = settled | removed
        phases += 1
        buckets += 1
    return tent, phases, buckets, work


def run_delta_stepping(g: Graph, source: int = 0, delta: float | None = None,
                       max_phases: int | None = None,
                       device=None) -> DeltaResult:
    """Solve one SSSP query by delta-stepping on ``device`` (None = the
    CUDA card; the graph's).

    The reference's input checks: a graph built outside ``from_coo`` may
    carry NaN, -inf or negative weights, which would poison the min-plus
    reductions, and a bad source would read as an all-inf solve. ``delta``
    defaults to :func:`default_delta`; ``max_phases`` to 4n + 16.

    Like the reference's, this loop can stop making progress at a bucket
    edge: a tentative distance ``t == fl(k * delta)`` whose f32 quotient
    ``t / delta`` rounds below ``k`` makes bucket ``k - 1`` the lowest one,
    while the interval compare puts ``t`` in bucket ``k``; every later
    phase is then an empty heavy round, up to ``max_phases``. With the
    default cap on a large graph that is millions of phases, so pass a
    ``max_phases`` near the expected count (the stepper's ``DeltaPolicy``
    compares bucket ids and does not stall).
    """
    dev = graph_device(g, device)
    w = g.w  # checked where it lives: a host copy of 10^8 arcs is slow
    if bool(torch.any(w < 0)):
        raise ValueError("edge costs must be non-negative")
    if bool(torch.any(~torch.isfinite(w) & (w != INF))):
        raise ValueError(
            "edge costs must be finite (or +inf for padding); got NaN/-inf"
        )
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source must be in [0, {g.n}); got {source}")
    if delta is None:
        delta = default_delta(g)
    if not (np.isfinite(delta) and delta > 0):
        raise ValueError(
            f"delta must be a positive finite bucket width; got {delta}"
        )
    cap = int(max_phases) if max_phases is not None else 4 * g.n + 16
    tent, phases, buckets, work = _run(
        g, int(source), torch.tensor(float(delta), dtype=torch.float32,
                                     device=dev), cap)
    return DeltaResult(
        dist=tent,
        phases=torch.tensor(phases, dtype=torch.int32, device=dev),
        buckets_processed=torch.tensor(buckets, dtype=torch.int32,
                                       device=dev),
        relax_edges=np.int64(work.item()),
    )


# the short name, as the "delta" policy spec reads
run_delta = run_delta_stepping
