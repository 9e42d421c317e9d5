"""Graph representation for the port (counterpart of ``repro.core.graph``).

Graphs are fixed-shape COO edge arrays (``src``, ``dst``, ``w``) plus the
static per-vertex edge-weight minima the Crauser criteria read:

  ``in_min_static[v]  = min_{(w,v) in E} c(w,v)``   (M'[v] in the paper)
  ``out_min_static[v] = min_{(v,w) in E} c(v,w)``   (M[v]  in the paper)

Padding convention as in the reference: edge arrays may be padded with
``w = +inf`` and ``src = dst = 0``; +inf is neutral for every min-plus
reduction. Every tensor of a :class:`Graph` lives on one device.

The input checks run on the host (numpy), then the arrays move to the
device once and the minima and the ELL views are built there with torch
ops, so the scatter-min, sort and search passes over 10^8 arcs run on the
card instead of in host numpy. Minima are exact (f32 min has no rounding)
and the ELL slot order is the reference's stable sort by row, so both
builders give the reference's arrays element for element.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.config import resolve_device

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph with non-negative edge costs, as device tensors."""

    n: int
    m: int  # padded edge-array length (>= true edge count)
    src: torch.Tensor  # (m,) int32
    dst: torch.Tensor  # (m,) int32
    w: torch.Tensor  # (m,) float32, +inf on padding
    in_min_static: torch.Tensor  # (n,) float32
    out_min_static: torch.Tensor  # (n,) float32

    @property
    def device(self) -> torch.device:
        return self.w.device

    @property
    def num_real_edges(self) -> int:
        return int(torch.isfinite(self.w).sum())


def _static_min(index: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.full((n,), INF, dtype=torch.float32, device=w.device)
    return out.scatter_reduce_(0, index.long(), w, reduce="amin",
                               include_self=True)


def from_coo(src, dst, w, n: int, pad_to: int | None = None,
             device=None) -> Graph:
    """Build a :class:`Graph` from COO arrays (numpy or anything numpy
    reads), with the reference's input checks, on ``device`` (None = the
    CUDA card)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    if not src.shape == dst.shape == w.shape:
        raise ValueError(
            f"src, dst and w must have one shape; got {src.shape}, "
            f"{dst.shape}, {w.shape}"
        )
    if np.any(w < 0):
        raise ValueError("edge costs must be non-negative")
    # `w < 0` is False for NaN: a NaN weight would poison every min-plus
    # reduction, so non-finite values other than the +inf padding go too
    if np.any(~np.isfinite(w) & ~(w == np.inf)):
        raise ValueError(
            "edge costs must be finite (or +inf for padding); got NaN/-inf"
        )
    m = src.shape[0]
    if pad_to is not None and pad_to > m:
        pad = pad_to - m
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        w = np.concatenate([w, np.full(pad, np.inf, np.float32)])
        m = pad_to
    src_t = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    return Graph(
        n=n, m=m, src=src_t, dst=dst_t, w=w_t,
        in_min_static=_static_min(dst_t, w_t, n),
        out_min_static=_static_min(src_t, w_t, n),
    )


def to_numpy_csr(g: Graph):
    """(indptr, indices, weights) CSR over outgoing edges; drops padding."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    w = g.w.cpu().numpy()
    real = np.isfinite(w)
    src, dst, w = src[real], dst[real], w[real]
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(g.n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst, w


def _build_ell(from_ids, to_ids, w, n, pad_multiple):
    """(n, D) ELL rows keyed by ``to_ids`` holding (from_id, weight) pairs.

    The reference's slot of an edge is its rank within its row after a
    stable sort by row; here the rank is ``position - row start``, with the
    row starts from a prefix sum of the degrees, which is the same number.
    """
    real = torch.isfinite(w)
    from_ids, to_ids, w = from_ids[real], to_ids[real], w[real]
    to_long = to_ids.long()
    deg = torch.bincount(to_long, minlength=n)
    max_deg = int(deg.max()) if n > 0 else 0
    max_deg = max(max_deg, 1)
    d_pad = -(-max_deg // pad_multiple) * pad_multiple
    dev = w.device
    cols = torch.full((n, d_pad), n, dtype=torch.int32, device=dev)
    ws = torch.full((n, d_pad), INF, dtype=torch.float32, device=dev)
    order = torch.sort(to_long, stable=True).indices
    to_s = to_long[order]
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(to_s.numel(), device=dev) - start[to_s]
    cols[to_s, slot] = from_ids[order]
    ws[to_s, slot] = w[order]
    return cols, ws


def to_ell_in(g: Graph, pad_multiple: int = 8):
    """ELL layout of *incoming* adjacency: (n, D) source ids and weights.

    Rows are destination vertices; columns hold (source, weight) pairs
    padded with ``src = n`` (a sentinel slot the consumers append) and
    ``w = +inf``. ``D`` is the max in-degree rounded up to
    ``pad_multiple`` (at least one slot). Memoised per :class:`Graph`
    instance, keyed by ``pad_multiple``: a server answers many queries
    against one long-lived graph.
    """
    cache = g.__dict__.setdefault("_ell_in_cache", {})
    hit = cache.get(pad_multiple)
    if hit is None:
        hit = cache[pad_multiple] = _build_ell(g.src, g.dst, g.w, g.n,
                                               pad_multiple)
    return hit


def to_ell_out(g: Graph, pad_multiple: int = 8):
    """ELL layout of *outgoing* adjacency (the transpose twin of
    :func:`to_ell_in`), memoised per Graph instance like it."""
    cache = g.__dict__.setdefault("_ell_out_cache", {})
    hit = cache.get(pad_multiple)
    if hit is None:
        hit = cache[pad_multiple] = _build_ell(g.dst, g.src, g.w, g.n,
                                               pad_multiple)
    return hit


def out_degrees(g: Graph) -> torch.Tensor:
    """(n,) int32 real out-degrees (padding edges excluded), memoised."""
    hit = g.__dict__.get("_out_deg_cache")
    if hit is None:
        real_src = g.src[torch.isfinite(g.w)].long()
        hit = torch.bincount(real_src, minlength=g.n).to(torch.int32)
        g.__dict__["_out_deg_cache"] = hit
    return hit


def transpose(g: Graph) -> Graph:
    """The reverse graph (incoming edges become outgoing)."""
    return Graph(
        n=g.n, m=g.m, src=g.dst, dst=g.src, w=g.w,
        in_min_static=g.out_min_static, out_min_static=g.in_min_static,
    )
