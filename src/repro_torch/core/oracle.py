"""Reference sequential SSSP solvers (counterpart of ``repro.core.oracle``).

``dijkstra_numpy`` is the textbook binary-heap Dijkstra the tests hold the
engine against, on the host in f64. ``bellman_ford`` is the port's twin of
the reference's ``bellman_ford_jnp``: a min-plus fixed point over the COO
arcs on the graph's device, an independent path to the same f32 answers.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.graph import Graph, graph_device, to_numpy_csr
from repro_torch.kernels import ref as kref

INF = float("inf")


def dijkstra_numpy(g: Graph, source: int) -> np.ndarray:
    """Textbook binary-heap Dijkstra; O((n+m) log n). Returns dist (n,) f64."""
    indptr, indices, weights = to_numpy_csr(g)
    n = g.n
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    done = np.zeros(n, bool)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(indptr[u], indptr[u + 1]):
            v = indices[e]
            nd = d + weights[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def dijkstra_phase_counts(g: Graph, source: int) -> np.ndarray:
    """Distances plus settle order, used to sanity check phase traces (the
    reference's function of this name returns the distances)."""
    return dijkstra_numpy(g, source)


def bellman_ford(g: Graph, source: int, device=None) -> torch.Tensor:
    """Bellman-Ford fixed point (label-correcting min-plus) over the COO
    arcs: (n,) f32 on ``device`` (None = the CUDA card; the graph's).

    Each iteration runs on the device, and the host reads ``changed`` once
    an iteration, with the reference's cap of n + 1 iterations.
    """
    graph_device(g, device)
    n = g.n
    dist = torch.full((n,), INF, dtype=torch.float32, device=g.device)
    dist[int(source)] = 0.0
    real = torch.isfinite(g.w)
    src = g.src.long()
    changed, it = True, 0
    while changed and it < n + 1:
        cand = torch.where(real, dist[src] + g.w, INF)
        new = kref.nan_min(dist, kref.segment_min(cand, g.dst, n))
        changed = bool(torch.any(new < dist))
        dist, it = new, it + 1
    return dist
