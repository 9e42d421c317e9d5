"""Input-graph generators matching the paper's experimental families.

The port's own copy of ``repro.graphs.generators``: the same numpy RNG
calls in the same order, so the same seed gives the same COO arrays in both
packages. Only the last step differs: the graph is built by the port's
:func:`~repro_torch.core.graph.from_coo` on ``device`` (None = the CUDA
card).

Families:
  * ``uniform_gnp``  — G(n, p) directed Erdos-Renyi (paper Sec. 4, and the
    G(1e6, 1e-4) benchmark graphs of Sec. 6).
  * ``kronecker``    — Graph500 initiator ``2.5 * [[.57, .19], [.19, .05]]``
    sampled edge by edge.
  * ``grid_road``    — 4-neighbour grid with bidirected edges, a structural
    stand-in for the SNAP road networks.
  * ``webgraph``     — preferential-attachment directed graph with a
    heavy-tail in-degree, a stand-in for the SNAP web graphs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, from_coo

GRAPH500_INITIATOR = 2.5 * np.array([[0.57, 0.19], [0.19, 0.05]])


def _weights(m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 0x5EED)
    return rng.uniform(0.0, 1.0, size=m).astype(np.float32)


def _finish(src, dst, n, seed, weights=None, pad_to=None,
            device=None) -> Graph:
    w = _weights(len(src), seed) if weights is None else weights
    return from_coo(src, dst, w, n, pad_to=pad_to, device=device)


def uniform_gnp(n: int, p: float, seed: int = 0, pad_to: int | None = None,
                device=None) -> Graph:
    """Directed G(n, p): edge count ~ Binomial(n(n-1), p), endpoints uniform,
    self-loops resampled by drawing from n-1 and shifting."""
    rng = np.random.default_rng(seed)
    m = int(rng.binomial(n * (n - 1), p))
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n - 1, size=m, dtype=np.int64)
    dst = np.where(dst >= src, dst + 1, dst)
    return _finish(src.astype(np.int32), dst.astype(np.int32), n, seed,
                   pad_to=pad_to, device=device)


def kronecker(k: int, seed: int = 0, initiator: np.ndarray | None = None,
              pad_to: int | None = None, device=None) -> Graph:
    """Stochastic-Kronecker (R-MAT) graph on n = 2**k vertices."""
    src, dst, w, n = kronecker_coo(k, seed, initiator)
    return from_coo(src, dst, w, n, pad_to=pad_to, device=device)


def kronecker_coo(k: int, seed: int = 0,
                  initiator: np.ndarray | None = None) -> tuple:
    """:func:`kronecker`'s host part: its COO arrays ``(src, dst, w, n)``
    in numpy, before ``from_coo``."""
    init = (GRAPH500_INITIATOR if initiator is None
            else np.asarray(initiator, np.float64))
    n = 2 ** k
    total = init.sum()
    rng = np.random.default_rng(seed)
    m = int(rng.poisson(total ** k))
    probs = (init / total).reshape(-1)  # quadrant probs [a, b; c, d]
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(k):
        q = rng.choice(4, size=m, p=probs)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return (src.astype(np.int32), dst.astype(np.int32),
            _weights(len(src), seed), n)


def grid_road(rows: int, cols: int, seed: int = 0, diag_frac: float = 0.05,
              pad_to: int | None = None, device=None) -> Graph:
    """Bidirected ``rows x cols`` grid plus a few diagonal shortcuts."""
    n = rows * cols
    vid = np.arange(n).reshape(rows, cols)
    e = []
    e.append((vid[:, :-1].ravel(), vid[:, 1:].ravel()))  # right
    e.append((vid[:-1, :].ravel(), vid[1:, :].ravel()))  # down
    src = np.concatenate([a for a, _ in e])
    dst = np.concatenate([b for _, b in e])
    rng = np.random.default_rng(seed)
    if diag_frac > 0 and rows > 1 and cols > 1:
        nd = int(diag_frac * n)
        r = rng.integers(0, rows - 1, nd)
        c = rng.integers(0, cols - 1, nd)
        src = np.concatenate([src, vid[r, c]])
        dst = np.concatenate([dst, vid[r + 1, c + 1]])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return _finish(src.astype(np.int32), dst.astype(np.int32), n, seed,
                   pad_to=pad_to, device=device)


def webgraph(n: int, out_deg: int = 8, seed: int = 0, alpha: float = 0.7,
             pad_to: int | None = None, device=None) -> Graph:
    """Directed preferential-attachment graph (heavy-tail in-degree): each
    target is, with probability ``alpha``, the endpoint of a uniformly
    chosen existing arc, and otherwise uniform."""
    rng = np.random.default_rng(seed)
    m = n * out_deg
    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    dst = np.zeros(m, np.int64)
    block = max(out_deg * 4, 16)
    dst[: block * out_deg] = rng.integers(0, block, size=block * out_deg)
    for start in range(block, n, block):
        end = min(start + block, n)
        cnt = (end - start) * out_deg
        pick_pref = rng.random(cnt) < alpha
        prior = start * out_deg
        via_edge = dst[rng.integers(0, prior, size=cnt)]
        uniform = rng.integers(0, end, size=cnt)
        dst[start * out_deg : end * out_deg] = np.where(pick_pref, via_edge,
                                                        uniform)
    keep = src != dst
    return _finish(src[keep].astype(np.int32), dst[keep].astype(np.int32), n,
                   seed, pad_to=pad_to, device=device)
