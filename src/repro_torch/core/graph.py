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
from typing import NamedTuple

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
    """``out[v] = min w`` over the arcs with ``index == v``, with the
    reference's tie rule (``np.minimum.at``: the later arc in COO order
    wins). Only a tie of -0 and +0 shows in the bits, so the amin decides
    everything else, and a zero minimum takes the sign of the zero arc with
    the largest COO index: both reductions are exact in any order, so no
    atomic order on the card decides a bit."""
    idx = index.long()
    dev = w.device
    out = torch.full((n,), INF, dtype=torch.float32, device=dev)
    out.scatter_reduce_(0, idx, w, reduce="amin", include_self=True)
    zero = torch.nonzero(w == 0).squeeze(1)
    if zero.numel() == 0:
        return out
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, idx[zero], zero, reduce="amax", include_self=True)
    signed = torch.where(torch.signbit(w[last.clamp(min=0)]), -0.0, 0.0)
    return torch.where((out == 0) & (last >= 0), signed, out)


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


def _rank_in_group(keys: torch.Tensor, n: int):
    """Stable sort of ``keys`` (ids in [0, n)): returns the order, the
    sorted keys and each element's rank within its run of equal keys (the
    reference's ``arange - searchsorted(sorted, sorted, 'left')``), as
    ``position - run start`` with the run starts from a prefix sum of the
    counts, which is the same number."""
    order = torch.sort(keys, stable=True).indices
    srt = keys[order]
    count = torch.bincount(srt, minlength=n)
    start = torch.cumsum(count, 0) - count
    rank = torch.arange(srt.numel(), device=keys.device) - start[srt]
    return order, srt, rank


def _build_ell(from_ids, to_ids, w, n, pad_multiple):
    """(n, D) ELL rows keyed by ``to_ids`` holding (from_id, weight) pairs.

    The reference's slot of an edge is its rank within its row after a
    stable sort by row (:func:`_rank_in_group`).
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
    order, to_s, slot = _rank_in_group(to_long, n)
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


class EllSlice(NamedTuple):
    """One degree bucket of a sliced ELL view.

    ``rows[i]`` is the vertex that slice-row ``i`` belongs to; a *split*
    heavy vertex contributes several rows (same ``rows`` id, disjoint edge
    chunks), merged back by the consumer's min, which is exact in any
    order (f32 min has no rounding).
    """

    rows: torch.Tensor  # (R_b,) int32 vertex ids (repeats: split rows)
    cols: torch.Tensor  # (R_b, D_b) int32 neighbour ids (sentinel id = n)
    ws: torch.Tensor  # (R_b, D_b) f32, +inf padding


class SlicedEll(NamedTuple):
    """A degree-sliced ELL adjacency view: one :class:`EllSlice` per bucket.

    Buckets pad rows only to their own width, and rows beyond the widest
    bucket split into chunks, so one hub no longer makes every row pay
    ``D_max`` slots. Zero-degree vertices appear in no slice: the merge's
    +inf identity is their empty-min value.

    ``merge_idx[v, c]`` is the position of v's c-th slice-row in the
    row-major concatenation of all slices (sentinel = total rows, which
    reads +inf), so ``merged[v] = min_c concat[merge_idx[v, c]]``; it is
    the reference's array element for element. ``merge_ptr`` /
    ``merge_pos`` are its compact form for the CUDA merge pass: the
    non-sentinel entries of each row, in row-major order (CSR). A sentinel
    reads +inf, the identity of min, so dropping it gives the same answer
    for any ``merge_idx``.

    The write-through plan of the fused scans, derived from that form: a
    vertex whose only entry is a row no other vertex lists ("direct") has
    ``merged[v] = concat[that row]`` exactly (its other columns are the +inf
    sentinel, and min(x, +inf) is x, NaN and -0 included), so the row's
    result is written to v in place. ``row_owner[r]`` is that vertex for
    the row of a direct vertex, else ``-1 - k``, k the row's slot in a
    compact scratch of the remaining rows (``split_rows`` of them, in row
    order). ``merge_short`` lists the other vertices, those with several
    rows first (``merge_multi`` of them: split hubs), then those with none;
    a short merge folds the first from the scratch through ``merge_ptr`` /
    ``merge_pos`` and gives the rest +inf. Build one with
    :func:`sliced_ell`.
    """

    slices: tuple[EllSlice, ...]
    merge_idx: torch.Tensor  # (n, C) int32 positions into concat(slices)+[inf]
    merge_ptr: torch.Tensor  # (n + 1,) int64 row starts into merge_pos
    merge_pos: torch.Tensor  # (nnz,) int32 non-sentinel merge_idx entries
    row_owner: torch.Tensor  # (R_total,) int32 direct vertex, or -1 - slot
    merge_short: torch.Tensor  # (S,) int32 vertices the short merge writes
    merge_multi: int  # the leading vertices of merge_short that have rows
    split_rows: int  # rows the compact scratch holds (row_owner < 0)

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(int(s.cols.shape[1]) for s in self.slices)

    @property
    def padded_slots(self) -> int:
        return sum(int(s.cols.numel()) for s in self.slices)

    @property
    def total_rows(self) -> int:
        return sum(int(s.rows.shape[0]) for s in self.slices)


def sliced_ell(slices, merge_idx: torch.Tensor) -> SlicedEll:
    """A :class:`SlicedEll` from its slices and ``merge_idx``, with the
    compact merge form derived once. Raises when a ``merge_idx`` entry lies
    outside [0, total rows] (the sentinel is total rows)."""
    slices = tuple(slices)
    total = sum(int(s.rows.shape[0]) for s in slices)
    if merge_idx.dim() != 2 or merge_idx.dtype != torch.int32:
        raise ValueError(
            f"want an (n, C) int32 merge_idx; got {tuple(merge_idx.shape)} "
            f"{merge_idx.dtype}"
        )
    if merge_idx.numel() and (int(merge_idx.min()) < 0
                              or int(merge_idx.max()) > total):
        raise ValueError(
            f"merge_idx entries must lie in [0, {total}] (total slice rows)"
        )
    keep = merge_idx != total
    counts = keep.sum(dim=1)
    dev = merge_idx.device
    merge_ptr = torch.zeros(merge_idx.shape[0] + 1, dtype=torch.int64,
                            device=dev)
    torch.cumsum(counts, 0, out=merge_ptr[1:])
    merge_pos = merge_idx[keep].contiguous()
    # write-through: a vertex with one row that no other vertex lists
    pos = merge_pos.long()
    direct = counts == 1
    first = torch.zeros_like(counts)
    if pos.numel():  # else no vertex has a row
        first = pos[merge_ptr[:-1].clamp(max=pos.numel() - 1)]
        direct &= torch.bincount(pos, minlength=total)[first] == 1
    verts = torch.nonzero(direct).squeeze(1)
    row_owner = torch.full((total,), -1, dtype=torch.int32, device=dev)
    row_owner[first[verts]] = verts.to(torch.int32)
    split = torch.nonzero(row_owner < 0).squeeze(1)
    row_owner[split] = (-1 - torch.arange(split.numel(), device=dev)).to(
        torch.int32)
    multi = torch.nonzero(~direct & (counts > 0)).squeeze(1)
    none = torch.nonzero(counts == 0).squeeze(1)
    return SlicedEll(slices=slices, merge_idx=merge_idx, merge_ptr=merge_ptr,
                     merge_pos=merge_pos, row_owner=row_owner,
                     merge_short=torch.cat([multi, none]).to(torch.int32),
                     merge_multi=int(multi.numel()),
                     split_rows=int(split.numel()))


def default_slice_boundaries(deg: np.ndarray, pad_multiple: int = 8,
                             max_slices: int = 4) -> tuple[int, ...]:
    """Bucket widths for :func:`to_ell_in_sliced`: geometric (x4) from
    ``pad_multiple`` up to the 95th-percentile degree, at most
    ``max_slices`` buckets. Rows beyond the last width are split into
    chunks of that width, so hubs never widen a bucket."""
    deg = deg[deg > 0]
    if deg.size == 0:
        return (pad_multiple,)
    p95 = int(np.percentile(deg, 95))
    widths = [pad_multiple]
    while widths[-1] < p95 and len(widths) < max_slices:
        widths.append(widths[-1] * 4)
    return tuple(widths)


def _build_ell_sliced(from_ids, to_ids, w, n, pad_multiple, boundaries,
                      split) -> SlicedEll:
    """Slice rows keyed by ``to_ids`` into per-degree-bucket ELL tiles, on
    the edges' device; the reference's arrays element for element."""
    dev = w.device
    real = torch.isfinite(w)
    from_ids, to_ids, w = from_ids[real], to_ids[real], w[real]
    deg = torch.bincount(to_ids.long(), minlength=n)
    if boundaries is None:
        boundaries = default_slice_boundaries(deg.cpu().numpy(), pad_multiple)
    widths = sorted(
        {max(pad_multiple, -(-int(b) // pad_multiple) * pad_multiple)
         for b in boundaries}
    )
    if split is None:
        split = widths[-1]
    split = max(pad_multiple, -(-int(split) // pad_multiple) * pad_multiple)
    if split < widths[-1]:
        raise ValueError(
            f"split threshold {split} below the widest bucket {widths[-1]}"
        )
    # per-edge slot within its row, after the reference's stable sort
    order, to_s, slot = _rank_in_group(to_ids.long(), n)
    from_s, w_s = from_ids[order], w[order]
    slices = []
    lo = 0
    for width in widths:
        last = width == widths[-1]
        # the widest bucket also owns the split rows
        vmask = (deg > lo) if last else (deg > lo) & (deg <= width)
        verts = torch.nonzero(vmask).squeeze(1)
        if verts.numel() == 0:
            lo = width
            continue
        use_w = split if last else width
        # vertex v of degree d gets ceil(d / use_w) rows; the edge in slot s
        # lands in chunk s // use_w
        chunks = (-(-deg[verts] // use_w) if last
                  else torch.ones_like(verts))
        rows = torch.repeat_interleave(verts, chunks).to(torch.int32)
        first = torch.zeros(n, dtype=torch.int64, device=dev)
        first[verts] = torch.cumsum(chunks, 0) - chunks
        emask = vmask[to_s]
        e_to, e_slot = to_s[emask], slot[emask]
        r = first[e_to] + e_slot // use_w
        c = e_slot % use_w
        cols_b = torch.full((rows.numel(), use_w), n, dtype=torch.int32,
                            device=dev)
        ws_b = torch.full((rows.numel(), use_w), INF, dtype=torch.float32,
                          device=dev)
        cols_b[r, c] = from_s[emask]
        ws_b[r, c] = w_s[emask]
        slices.append(EllSlice(rows=rows, cols=cols_b, ws=ws_b))
        lo = width
    if not slices:  # edgeless graph: one empty well-formed slice
        slices.append(EllSlice(
            rows=torch.zeros((0,), dtype=torch.int32, device=dev),
            cols=torch.full((0, widths[0]), n, dtype=torch.int32, device=dev),
            ws=torch.full((0, widths[0]), INF, dtype=torch.float32,
                          device=dev),
        ))
    # gather-based merge plan: position of each vertex's slice-rows in the
    # row-major concatenation (sentinel = total rows -> the +inf slot)
    all_rows = torch.cat([s.rows for s in slices]).long()
    total = all_rows.numel()
    order, srt, rank = _rank_in_group(all_rows, n)
    occ = torch.bincount(all_rows, minlength=n)
    c_max = max(int(occ.max()) if n > 0 else 1, 1)
    merge_idx = torch.full((n, c_max), total, dtype=torch.int32, device=dev)
    merge_idx[srt, rank] = order.to(torch.int32)
    return sliced_ell(slices, merge_idx)


def _sliced_view(g: Graph, side: str, pad_multiple, boundaries, split):
    cache = g.__dict__.setdefault(f"_ell_{side}_sliced_cache", {})
    key = (pad_multiple,
           None if boundaries is None else tuple(int(b) for b in boundaries),
           None if split is None else int(split))
    hit = cache.get(key)
    if hit is None:
        from_ids, to_ids = (g.src, g.dst) if side == "in" else (g.dst, g.src)
        hit = cache[key] = _build_ell_sliced(from_ids, to_ids, g.w, g.n,
                                             pad_multiple, boundaries, split)
    return hit


def to_ell_in_sliced(g: Graph, pad_multiple: int = 8, boundaries=None,
                     split: int | None = None) -> SlicedEll:
    """Degree-sliced ELL view of the *incoming* adjacency.

    ``boundaries`` are bucket widths (rounded up to ``pad_multiple``). The
    port has no tuning ledger yet, so when they are omitted the view uses
    :func:`default_slice_boundaries` of the in-degree distribution (the
    reference reads its ledger first, and falls back to the same default
    when the ledger holds nothing). Rows with degree beyond ``split``
    (default: the widest bucket) are split into width-``split`` chunks
    merged by the consumer. Memoised per Graph instance keyed by the full
    parameter tuple, like :func:`to_ell_in`.
    """
    return _sliced_view(g, "in", pad_multiple, boundaries, split)


def to_ell_out_sliced(g: Graph, pad_multiple: int = 8, boundaries=None,
                      split: int | None = None) -> SlicedEll:
    """Degree-sliced ELL view of the *outgoing* adjacency (the transpose
    twin of :func:`to_ell_in_sliced`), memoised per Graph instance."""
    return _sliced_view(g, "out", pad_multiple, boundaries, split)


def transpose(g: Graph) -> Graph:
    """The reverse graph (incoming edges become outgoing)."""
    return Graph(
        n=g.n, m=g.m, src=g.dst, dst=g.src, w=g.w,
        in_min_static=g.out_min_static, out_min_static=g.in_min_static,
    )
