"""Plain PyTorch twins of the CUDA kernels (the correctness contract).

Each ``*_ref`` computes the same function as its kernel with the same f32
operations: one add per candidate and an exact min, so a kernel and its
twin agree bit for bit. ``torch.amin`` / ``torch.minimum`` propagate NaN as
``jnp.min`` / ``jnp.minimum`` do. Gather indices are widened to int64 here
(``torch`` indexing needs them); the kernels read the int32 ``cols``.
"""
from __future__ import annotations

import torch

INF = float("inf")


def ell_relax_ref(dmask: torch.Tensor, cols: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """upd[v] = min_j dmask[cols[v, j]] + ws[v, j]."""
    return torch.amin(dmask[cols.long()] + ws, dim=1)


def ell_relax_batch_ref(dmask: torch.Tensor, cols: torch.Tensor,
                        ws: torch.Tensor) -> torch.Tensor:
    """upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]."""
    return torch.amin(dmask[:, cols.long()] + ws[None], dim=-1)


def push_buckets(out_view):
    """``(owner, cols, ws)`` per bucket of an outgoing view: the padded
    ``(cols, ws)`` pair is one bucket whose row r belongs to vertex r; a
    ``SlicedEll``'s bucket rows belong to ``rows``."""
    if hasattr(out_view, "slices"):
        return [(s.rows, s.cols, s.ws) for s in out_view.slices]
    cols, ws = out_view
    owner = torch.arange(cols.shape[0], dtype=torch.int32, device=cols.device)
    return [(owner, cols, ws)]


def ell_push_relax_batch_ref(dmask: torch.Tensor, out_view) -> torch.Tensor:
    """The relax as a push along the outgoing view: (B, n) f32
    ``upd[b, v] = min dmask[b, u] + ws[r, j]`` over the out-rows r of every
    owner u (:func:`push_buckets`) and their slots j with
    ``cols[r, j] = v``; +inf where v has no candidate.

    A lane pushes from u only where ``dmask[b, u]`` is not +inf, and a row
    ends at its first id outside [0, n) (the builders left-pack rows, so
    that is the sentinel n); an owner outside [0, n) pushes nothing. Only
    the rows of owners with some such lane are visited, so the plain solve
    never materialises more than this phase's candidates. The same f32 add
    as the pull twin, and ``scatter_reduce_``'s ``amin``, which keeps a NaN.
    """
    b, n = dmask.shape
    live = dmask != INF  # (B, n): lanes that push from u
    any_live = live.any(dim=0)
    upd = torch.full((b, n + 1), INF, dtype=torch.float32, device=dmask.device)
    for owner, cols, ws in push_buckets(out_view):
        own = owner.long()
        in_range = (own >= 0) & (own < n)
        act = torch.nonzero(in_range & any_live[own.clamp(0, max(n - 1, 0))])
        act = act.squeeze(1)
        if act.numel() == 0:
            continue
        u, c, w = own[act], cols[act].long(), ws[act]
        in_row = torch.cummin(((c >= 0) & (c < n)).to(torch.int8), dim=1)
        c = torch.where(in_row.values.bool(), c, n)  # the dropped slots' bin
        cand = torch.where(live[:, u, None], dmask[:, u, None] + w[None], INF)
        upd.scatter_reduce_(1, c.reshape(1, -1).expand(b, -1),
                            cand.reshape(b, -1), "amin", include_self=True)
    return upd[:, :n].contiguous()


def ell_key_min_ref(gate: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """key[v] = min_j gate[cols[v, j]] + ws[v, j] (dynamic criterion key)."""
    return torch.amin(gate[cols.long()] + ws, dim=1)


def ell_key_min_batch_ref(gate: torch.Tensor, cols: torch.Tensor,
                          ws: torch.Tensor) -> torch.Tensor:
    """key[b, v] = min_j gate[b, cols[v, j]] + ws[v, j]; adjacency shared."""
    return torch.amin(gate[:, cols.long()] + ws[None], dim=-1)


def pad_idx(vec: torch.Tensor, idx_pad: int) -> torch.Tensor:
    """The fused kernels' index-space convention: the trailing axis padded
    with min-neutral +inf up to ``idx_pad`` (the sentinel id n reads +inf)."""
    pad = idx_pad - vec.shape[-1]
    if pad <= 0:
        return vec
    fill = torch.full(vec.shape[:-1] + (pad,), INF, dtype=vec.dtype,
                      device=vec.device)
    return torch.cat([vec, fill], dim=-1)


def ell_gather_min_batch_ref(vecs: torch.Tensor, cols: torch.Tensor,
                             ws: torch.Tensor) -> torch.Tensor:
    """out[v, b, r] = min_j vecs[v, b, cols[r, j]] + ws[r, j].

    Takes the UNPADDED (V, B, n) vectors, as the kernel wrapper does, and
    appends the +inf column of the sentinel id n here.
    """
    vecs = pad_idx(vecs, vecs.shape[-1] + 1)
    return torch.amin(vecs[:, :, cols.long()] + ws[None, None], dim=-1)


def ell_relax_keys_batch_ref(dmask, ga, gb, gc, cols, ws):
    """Fused in-scan twin: (upd (B, n), keys (K, B, n)).

    ``upd`` is :func:`ell_relax_batch_ref` on ``dmask``; ``keys[k]`` is the
    key-min over the post-phase gate ``min(ga[k], gb[k], gc[k] + fin)``,
    ``fin`` 0 where ``upd`` is finite and +inf elsewhere, the sentinel
    included. Inputs are unpadded (B, n) / (K, B, n).
    """
    n_rows = cols.shape[0]
    idx_pad = dmask.shape[-1] + 1
    dmask, ga, gb, gc = (pad_idx(x, idx_pad) for x in (dmask, ga, gb, gc))
    c = cols.long()
    upd = torch.amin(dmask[:, c] + ws[None], dim=-1)  # (B, n)
    fin = torch.full(dmask.shape, INF, dtype=torch.float32,
                     device=dmask.device)
    fin[:, :n_rows] = torch.where(upd < INF, 0.0, INF)
    gate = torch.minimum(ga, torch.minimum(gb, gc + fin[None]))
    keys = torch.amin(gate[:, :, c] + ws[None, None], dim=-1)
    return upd, keys


def ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws):
    """Fused out-scan twin: keys (K0 + 1, B, n); row K0 is the dependent key
    reduced through ``min(dga, dgb + keys[dep_idx])``. Inputs unpadded."""
    n_rows = cols.shape[0]
    idx_pad = gates.shape[-1] + 1
    c = cols.long()
    keys0 = torch.amin(pad_idx(gates, idx_pad)[:, :, c] + ws[None, None],
                       dim=-1)
    dep = torch.full((gates.shape[1], idx_pad), INF, dtype=torch.float32,
                     device=gates.device)
    dep[:, :n_rows] = keys0[dep_idx]
    gate = torch.minimum(pad_idx(dga, idx_pad), pad_idx(dgb, idx_pad) + dep)
    dep_key = torch.amin(gate[:, c] + ws[None], dim=-1)
    return torch.cat([keys0, dep_key[None]], dim=0)


def merge_parts(parts, merge_idx: torch.Tensor, lead) -> torch.Tensor:
    """(..., R_b) bucket partials -> (..., n) through the gather-merge plan:
    ``out[..., v] = min_c concat(parts, +inf)[..., merge_idx[v, c]]``.

    The reference takes ``(..., n, C)`` at once; at C in the hundreds that
    is tens of GB, so this loops over the columns and, in column c, reads
    only the vertices whose entry is not the sentinel (it reads +inf, the
    identity of min). A column holds each vertex once, so its update has
    no conflicts; min is exact, so the order gives the same bits. ``lead``
    is the leading shape (``parts`` may be empty: an edgeless graph).
    """
    dev = merge_idx.device
    flat = torch.cat(
        list(parts) + [torch.full(tuple(lead) + (1,), INF,
                                  dtype=torch.float32, device=dev)], dim=-1)
    sentinel = flat.shape[-1] - 1
    out = torch.full(tuple(lead) + (merge_idx.shape[0],), INF,
                     dtype=torch.float32, device=dev)
    verts, col = torch.nonzero(merge_idx != sentinel, as_tuple=True)
    by_col = torch.sort(col, stable=True).indices
    verts = verts[by_col]
    pos = merge_idx[verts, col[by_col]].long()
    start = 0
    for count in torch.bincount(col, minlength=merge_idx.shape[1]).tolist():
        v, p = verts[start:start + count], pos[start:start + count]
        # the kernel's nan_min, which keeps a NaN's bits (torch.minimum's
        # vectorised CPU form returns another NaN payload)
        m, x = out[..., v], flat[..., p]
        out[..., v] = torch.where((x < m) | torch.isnan(x), x, m)
        start += count
    return out


def ell_sliced_gather_min_batch_ref(vecs, sliced):
    """(V, B, n) row-mins of ``vecs`` over every bucket of a sliced view,
    merged by :func:`merge_parts`; buckets without rows are skipped, which
    keeps the concatenation order."""
    parts = [ell_gather_min_batch_ref(vecs, s.cols, s.ws)
             for s in sliced.slices if s.rows.shape[0]]
    return merge_parts(parts, sliced.merge_idx, vecs.shape[:-1])


def ell_sliced_relax_keys_batch_ref(dmask, ga, gb, gc, sliced):
    """Sliced fused in-scan twin: ``(upd (B, n), keys (K, B, n))``, the
    relax merge, then the key gather of ``min(ga, gb, gc + fin(upd))``."""
    upd = ell_sliced_gather_min_batch_ref(dmask[None], sliced)[0]
    fin = torch.where(upd < INF, 0.0, INF)
    gates = torch.minimum(ga, torch.minimum(gb, gc + fin[None]))
    return upd, ell_sliced_gather_min_batch_ref(gates, sliced)


def ell_sliced_keys_dep_batch_ref(gates, dga, dgb, dep_idx, sliced):
    """Sliced fused out-scan twin: keys (K0 + 1, B, n); row K0 is the
    gather-min of ``min(dga, dgb + keys[dep_idx])``."""
    keys0 = ell_sliced_gather_min_batch_ref(gates, sliced)
    gate = torch.minimum(dga, dgb + keys0[dep_idx])
    dep = ell_sliced_gather_min_batch_ref(gate[None], sliced)
    return torch.cat([keys0, dep], dim=0)


def frontier_crit_ref(d: torch.Tensor, status: torch.Tensor,
                      out_min: torch.Tensor):
    """(min_F d, min_F (d + out_min), |F|) over one (n,) row."""
    fringe = status == 1
    min_fd = torch.amin(torch.where(fringe, d, INF))
    l_out = torch.amin(torch.where(fringe, d + out_min, INF))
    n_f = fringe.sum(dtype=torch.int32)
    return min_fd, l_out, n_f


def frontier_crit_batch_ref(d: torch.Tensor, status: torch.Tensor,
                            out_min: torch.Tensor):
    """Per-row (min_F d, L_out, |F|) over (B, n) state; out_min shared."""
    fringe = status == 1
    min_fd = torch.amin(torch.where(fringe, d, INF), dim=1)
    l_out = torch.amin(torch.where(fringe, d + out_min[None], INF), dim=1)
    n_f = fringe.sum(dim=1, dtype=torch.int32)
    return min_fd, l_out, n_f


def frontier_crit_lanes_batch_ref(d: torch.Tensor, status: torch.Tensor,
                                  keys: torch.Tensor | None):
    """Per-row plan-lane thresholds: (mins (1+K, B), |F| (B,)).

    ``keys`` is ``(K, n)`` (shared static keys), ``(K, B, n)`` (per-lane
    dynamic keys) or None (K = 0); mins[0] = min_F d, mins[1+k] =
    min_F (d + keys[k]).
    """
    fringe = status == 1
    rows = [torch.amin(torch.where(fringe, d, INF), dim=1)]
    if keys is not None:
        for k in range(keys.shape[0]):
            kk = keys[k]
            term = d + (kk if kk.dim() == 2 else kk[None, :])
            rows.append(torch.amin(torch.where(fringe, term, INF), dim=1))
    n_f = fringe.sum(dim=1, dtype=torch.int32)
    return torch.stack(rows), n_f
