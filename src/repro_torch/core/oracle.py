"""Reference sequential SSSP solver (counterpart of ``repro.core.oracle``).

``dijkstra_numpy`` is the textbook binary-heap Dijkstra the tests hold the
engine against, on the host in f64.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.graph import Graph, to_numpy_csr


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
