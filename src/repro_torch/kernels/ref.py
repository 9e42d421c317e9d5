"""Plain PyTorch twins of the CUDA kernels (the correctness contract).

Each ``*_ref`` computes the same function as its kernel with the same f32
operations: one add per candidate and an exact min, so a kernel and its
twin agree bit for bit. Every min goes through :func:`amin` (a reduction)
or :func:`nan_min` (two operands): a NaN wins, as in ``jnp.min`` /
``jnp.minimum``, and -0 wins a tie with +0 in either order, as XLA's min
does (``torch.amin`` and ``torch.minimum`` keep either zero, by operand
order and vector width).
Gather indices are widened to int64 here (``torch`` indexing needs them);
the kernels read the int32 ``cols``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.config import lane_tile

INF = float("inf")
_NEG_ZERO_BITS = -(2 ** 31)  # the int32 view of -0.0


def _neg_zero(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) == _NEG_ZERO_BITS


def amin(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.amin`` (NaN wins) with -0 over +0 on a tie, in any order."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    m = torch.amin(x, dim=dim)
    return torch.where((m == 0) & _neg_zero(x).any(dim=dim), -0.0, m)


def nan_min(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``min(m, x)`` as the kernels fold it: x where it is below m, NaN, or
    -0 beside a +0; m's bits otherwise (so a NaN keeps its payload, which
    ``torch.minimum``'s vectorised CPU form does not)."""
    take = (x < m) | torch.isnan(x) | ((x == m) & torch.signbit(x))
    return torch.where(take, x, m)


def segment_min(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_min(vals, idx, num_segments=n)`` over 1-D f32
    ``vals`` and ids in [0, n): (n,) f32, +inf where a segment is empty,
    the canonical NaN where any of its values is NaN, else its min with -0
    over +0 on a tie in either order (``tests/test_torch_oracle.py`` holds
    the rule against JAX). ``scatter_reduce_``'s ``amin`` keeps either zero
    and on the card is an atomic min, so the zero's sign and the NaN are
    decided by a second scatter of flags (an ``amax``, exact in any order).
    """
    idx = idx.long()
    out = torch.full((n,), INF, dtype=torch.float32, device=vals.device)
    out.scatter_reduce_(0, idx, vals, "amin", include_self=True)
    flag = torch.zeros((n,), dtype=torch.int8, device=vals.device)
    flag.scatter_reduce_(
        0, idx, (2 * torch.isnan(vals) + _neg_zero(vals)).to(torch.int8),
        "amax", include_self=True)
    out = torch.where((out == 0) & (flag == 1), -0.0, out)
    return torch.where(flag == 2, float("nan"), out)


def ell_relax_ref(dmask: torch.Tensor, cols: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """upd[v] = min_j dmask[cols[v, j]] + ws[v, j]."""
    return amin(dmask[cols.long()] + ws, dim=1)


def ell_relax_batch_ref(dmask: torch.Tensor, cols: torch.Tensor,
                        ws: torch.Tensor) -> torch.Tensor:
    """upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]."""
    return amin(dmask[:, cols.long()] + ws[None], dim=-1)


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
    as the pull twin, and ``scatter_reduce_``'s ``amin``, which keeps a NaN;
    a target whose min is a zero that some candidate gives as -0 gets -0,
    as the pull's fold does (the scatter's amin keeps either zero).
    """
    b, n = dmask.shape
    live = dmask != INF  # (B, n): lanes that push from u
    any_live = live.any(dim=0)
    dev = dmask.device
    upd = torch.full((b, n + 1), INF, dtype=torch.float32, device=dev)
    neg0 = torch.zeros((b, n + 1), dtype=torch.int8, device=dev)
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
        at = c.reshape(1, -1).expand(b, -1)
        upd.scatter_reduce_(1, at, cand.reshape(b, -1), "amin",
                            include_self=True)
        neg0.scatter_reduce_(1, at, _neg_zero(cand).reshape(b, -1).to(
            torch.int8), "amax", include_self=True)
    upd = torch.where((upd == 0) & neg0.bool(), -0.0, upd)
    return upd[:, :n].contiguous()


def push_coo_batch_ref(dmask: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, ws: torch.Tensor,
                       n_targets: int) -> torch.Tensor:
    """The push as the reference's shard-local scan over a COO edge list:
    (B, n_targets) f32 ``upd[b, v]`` = :func:`segment_min` over the edges e
    with ``cols[e] = v`` of ``dmask[b, rows[e]] + ws[e]``, where a lane
    takes an edge only if ``dmask[b, rows[e]]`` is not +inf (where it is,
    the reference's candidate is +inf too: its +inf masks and weights are
    never -inf). ``rows`` index dmask's columns, ``cols`` lie in
    [0, n_targets). Only the edges of owners with some such lane are
    visited, so no more than this call's candidates are materialised."""
    b = dmask.shape[0]
    live = dmask != INF
    rows = rows.long()
    act = torch.nonzero(live.any(dim=0)[rows]).squeeze(1)
    r, c, w = rows[act], cols.long()[act], ws[act]
    cand = torch.where(live[:, r], dmask[:, r] + w[None], INF)
    at = c[None] + torch.arange(b, device=dmask.device)[:, None] * n_targets
    return segment_min(cand.reshape(-1), at.reshape(-1),
                       b * n_targets).reshape(b, n_targets)


def ell_push_rect_batch_ref(dmask: torch.Tensor, cols: torch.Tensor,
                            ws: torch.Tensor, n_targets: int) -> torch.Tensor:
    """The rectangular push (``ell_push_rect_batch``): the left-packed rows
    of ``(cols, ws)`` (row u holds owner u's out-edges, ended by the first
    id outside [0, n_targets)) as a COO edge list, through
    :func:`push_coo_batch_ref`."""
    c = cols.long()
    in_row = torch.cummin(((c >= 0) & (c < n_targets)).to(torch.int8),
                          dim=1).values.bool()
    owner = torch.arange(c.shape[0], device=c.device)[:, None].expand_as(c)
    return push_coo_batch_ref(dmask, owner[in_row], c[in_row], ws[in_row],
                              n_targets)


def ell_key_min_ref(gate: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """key[v] = min_j gate[cols[v, j]] + ws[v, j] (dynamic criterion key)."""
    return amin(gate[cols.long()] + ws, dim=1)


def ell_key_min_batch_ref(gate: torch.Tensor, cols: torch.Tensor,
                          ws: torch.Tensor) -> torch.Tensor:
    """key[b, v] = min_j gate[b, cols[v, j]] + ws[v, j]; adjacency shared."""
    return amin(gate[:, cols.long()] + ws[None], dim=-1)


def status_gate_table(status: torch.Tensor, n_idx: int) -> torch.Tensor:
    """The status-gate table of the "unsettled" key gate of ``status``
    (lanes, n_src), as the kernel's pack writes it (``csrc/ell_gather.cu``):
    uint8 (tiles, n_idx), byte c of tile t with bit k set where lane
    t * W + k has status < 2 (its gate is +0), W = ``lane_tile(lanes)``;
    the columns past n_src (the sentinel) and the lanes past the last are
    clear."""
    lanes, n_src = status.shape
    w = lane_tile(lanes)
    tiles = -(-lanes // w)
    on = torch.zeros((tiles * w, n_idx), dtype=torch.int32,
                     device=status.device)
    on[:lanes, :n_src] = (status < 2).to(torch.int32)
    shift = torch.arange(w, dtype=torch.int32, device=status.device)
    return (on.view(tiles, w, n_idx) << shift[None, :, None]).sum(
        dim=1).to(torch.uint8)


def status_gate_rows(table: torch.Tensor, lanes: int) -> torch.Tensor:
    """The gates a status-gate table stands for: (lanes, n_idx) f32, +0
    where a lane's bit is set, +inf elsewhere."""
    tiles, n_idx = table.shape
    w = lane_tile(lanes)
    shift = torch.arange(w, dtype=torch.int32, device=table.device)
    bit = (table.to(torch.int32)[:, None, :] >> shift[None, :, None]) & 1
    return torch.where(bit == 1, 0.0, INF).to(torch.float32).reshape(
        tiles * w, n_idx)[:lanes]


def ell_key_min_status_batch_ref(status: torch.Tensor, cols: torch.Tensor,
                                 ws: torch.Tensor) -> torch.Tensor:
    """key[b, v] = min_j gate[b, cols[v, j]] + ws[v, j] for the "unsettled"
    gate of ``status`` (B, n) (+0 where status < 2, +inf elsewhere and at
    the sentinel id n), read through the status-gate table as the kernel
    reads it."""
    lanes, n = status.shape
    gate = status_gate_rows(status_gate_table(status, n + 1), lanes)
    return ell_key_min_batch_ref(gate, cols, ws)


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
    return amin(vecs[:, :, cols.long()] + ws[None, None], dim=-1)


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
    upd = amin(dmask[:, c] + ws[None], dim=-1)  # (B, n)
    fin = torch.full(dmask.shape, INF, dtype=torch.float32,
                     device=dmask.device)
    fin[:, :n_rows] = torch.where(upd < INF, 0.0, INF)
    gate = nan_min(ga, nan_min(gb, gc + fin[None]))
    keys = amin(gate[:, :, c] + ws[None, None], dim=-1)
    return upd, keys


def ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws):
    """Fused out-scan twin: keys (K0 + 1, B, n); row K0 is the dependent key
    reduced through ``min(dga, dgb + keys[dep_idx])``. Inputs unpadded."""
    n_rows = cols.shape[0]
    idx_pad = gates.shape[-1] + 1
    c = cols.long()
    keys0 = amin(pad_idx(gates, idx_pad)[:, :, c] + ws[None, None],
                       dim=-1)
    dep = torch.full((gates.shape[1], idx_pad), INF, dtype=torch.float32,
                     device=gates.device)
    dep[:, :n_rows] = keys0[dep_idx]
    gate = nan_min(pad_idx(dga, idx_pad), pad_idx(dgb, idx_pad) + dep)
    dep_key = amin(gate[:, c] + ws[None], dim=-1)
    return torch.cat([keys0, dep_key[None]], dim=0)


def merge_parts(parts, merge_idx: torch.Tensor, lead) -> torch.Tensor:
    """(..., R_b) bucket partials -> (..., n) through the gather-merge plan:
    ``out[..., v] = min_c concat(parts, +inf)[..., merge_idx[v, c]]``.

    The reference takes ``(..., n, C)`` at once; at C in the hundreds that
    is tens of GB, so this reads only the entries that are not the sentinel
    (it reads +inf, the identity of min) and reduces them per vertex with
    scatters that are exact in any order: an ``amin`` of the values that
    are not NaN, an ``amax`` flag for a -0 among them, and an ``amax`` of
    the column of the vertex's last NaN, whose bits then win. That is the
    :func:`nan_min` fold over the columns in order, bit for bit. ``lead``
    is the leading shape (``parts`` may be empty: an edgeless graph).
    """
    dev = merge_idx.device
    n = merge_idx.shape[0]
    flat = torch.cat(
        list(parts) + [torch.full(tuple(lead) + (1,), INF,
                                  dtype=torch.float32, device=dev)], dim=-1)
    sentinel = flat.shape[-1] - 1
    rows = flat.reshape(-1, flat.shape[-1])  # (L, R + 1)
    verts, col = torch.nonzero(merge_idx != sentinel, as_tuple=True)
    vals = rows[:, merge_idx[verts, col].long()]  # (L, E)
    idx = verts.expand_as(vals)
    nan = torch.isnan(vals)
    out = torch.full((rows.shape[0], n), INF, dtype=torch.float32,
                     device=dev)
    out.scatter_reduce_(1, idx, torch.where(nan, INF, vals), "amin")
    neg = torch.zeros(out.shape, dtype=torch.int8, device=dev)
    neg.scatter_reduce_(1, idx, _neg_zero(vals).to(torch.int8), "amax")
    out = torch.where((out == 0) & (neg == 1), -0.0, out)
    last = torch.full(out.shape, -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(1, idx, torch.where(nan, col, -1), "amax")
    nan_pos = merge_idx[torch.arange(n, device=dev)[None],
                        last.clamp(min=0)].long()
    out = torch.where(last >= 0, rows.gather(1, nan_pos), out)
    return out.reshape(tuple(lead) + (n,))


def ell_sliced_gather_min_batch_ref(vecs, sliced):
    """(V, B, n) row-mins of ``vecs`` over every bucket of a sliced view,
    merged by :func:`merge_parts`; buckets without rows are skipped, which
    keeps the concatenation order."""
    parts = [ell_gather_min_batch_ref(vecs, s.cols, s.ws)
             for s in sliced.slices if s.rows.shape[0]]
    return merge_parts(parts, sliced.merge_idx, vecs.shape[:-1])


def ell_sliced_relax_keys_batch_ref(dmask, ga, gb, gc, sliced,
                                    out_view=None):
    """Sliced fused in-scan twin: ``(upd (B, n), keys (K, B, n))``, the
    relax merge (or, given the sliced outgoing view ``out_view``, the push
    twin along it: the same bits), then the key gather of
    ``min(ga, gb, gc + fin(upd))``."""
    upd = (ell_sliced_gather_min_batch_ref(dmask[None], sliced)[0]
           if out_view is None else ell_push_relax_batch_ref(dmask, out_view))
    fin = torch.where(upd < INF, 0.0, INF)
    gates = nan_min(ga, nan_min(gb, gc + fin[None]))
    return upd, ell_sliced_gather_min_batch_ref(gates, sliced)


def ell_sliced_keys_dep_batch_ref(gates, dga, dgb, dep_idx, sliced):
    """Sliced fused out-scan twin: keys (K0 + 1, B, n); row K0 is the
    gather-min of ``min(dga, dgb + keys[dep_idx])``."""
    keys0 = ell_sliced_gather_min_batch_ref(gates, sliced)
    gate = nan_min(dga, dgb + keys0[dep_idx])
    dep = ell_sliced_gather_min_batch_ref(gate[None], sliced)
    return torch.cat([keys0, dep], dim=0)


def frontier_crit_ref(d: torch.Tensor, status: torch.Tensor,
                      out_min: torch.Tensor):
    """(min_F d, min_F (d + out_min), |F|) over one (n,) row."""
    fringe = status == 1
    min_fd = amin(torch.where(fringe, d, INF))
    l_out = amin(torch.where(fringe, d + out_min, INF))
    n_f = fringe.sum(dtype=torch.int32)
    return min_fd, l_out, n_f


def frontier_crit_batch_ref(d: torch.Tensor, status: torch.Tensor,
                            out_min: torch.Tensor):
    """Per-row (min_F d, L_out, |F|) over (B, n) state; out_min shared."""
    fringe = status == 1
    min_fd = amin(torch.where(fringe, d, INF), dim=1)
    l_out = amin(torch.where(fringe, d + out_min[None], INF), dim=1)
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
    rows = [amin(torch.where(fringe, d, INF), dim=1)]
    if keys is not None:
        for k in range(keys.shape[0]):
            kk = keys[k]
            term = d + (kk if kk.dim() == 2 else kk[None, :])
            rows.append(amin(torch.where(fringe, term, INF), dim=1))
    n_f = fringe.sum(dim=1, dtype=torch.int32)
    return torch.stack(rows), n_f



def embed_runs(ids: torch.Tensor, num_rows: int):
    """``(perm, starts)`` of an embedding gradient's fixed order: ``perm``
    the flat positions sorted by token id, each token's run in position
    order (a stable sort), ``starts`` the (num_rows + 1,) int64 offsets of
    the runs (row v's run is ``perm[starts[v]:starts[v + 1]]``); ids past
    ``num_rows`` sort after every run and negative ids before it, and
    neither is read. No step reads a
    value back to the host (a bincount would, for its length)."""
    flat = ids.reshape(-1).to(torch.int64)
    keys, perm = torch.sort(flat, stable=True)
    rows = torch.arange(num_rows + 1, dtype=torch.int64, device=flat.device)
    return perm, torch.searchsorted(keys, rows)


def embed_grad_ref(grad: torch.Tensor, ids: torch.Tensor,
                   num_rows: int, row0: int | None = None) -> torch.Tensor:
    """The gradient of ``table[ids]`` for a ``(num_rows, D)`` table:
    ``grad`` (N, D) for the N flat ids, summed into each id's row in
    position order, from +0, each add rounded to ``grad``'s type (the
    bits of a sequential ``index_add_``); rows no id names are +0. Step k
    adds the k-th row of every run that has one, so the order is fixed on
    any device. With ``row0`` the table is rows [row0, row0 + num_rows)
    of a larger one that the ids index, and ids outside it are skipped."""
    grad = grad.reshape(-1, grad.shape[-1])
    perm, starts = embed_runs(ids if row0 is None else ids - row0, num_rows)
    counts = starts[1:] - starts[:-1]
    out = torch.zeros((num_rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    rows = torch.nonzero(counts).squeeze(1)
    longest = int(counts.max()) if num_rows else 0
    for k in range(longest):
        rows = rows[counts[rows] > k]
        out[rows] = out[rows] + grad[perm[starts[rows] + k]]
    return out


def register_kernels(reg):
    """Bind each contract's plain twin as its oracle.

    This module is last in ``registry.KERNEL_MODULES``, so every contract
    exists already; ``collect()`` then refuses any left unbound. An oracle
    takes the wrapper's arguments: the launch keyword ``sparse`` changes no
    value and is dropped, the others (``dep_idx``, ``out_view``) are the
    twin's own. The ops wrappers'
    oracles are the wrappers themselves on the twin path.
    """
    import functools

    from repro_torch.kernels import ops

    def gather_ref(vecs, sliced, sparse=False):
        return ell_sliced_gather_min_batch_ref(vecs, sliced)

    def push_ref(dmask, cols, ws):
        return ell_push_relax_batch_ref(dmask, (cols, ws))

    def keys_dep_ref(gates, dga, dgb, cols, ws, dep_idx=0):
        return ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws)

    def sliced_keys_dep_ref(gates, dga, dgb, sliced, dep_idx=0):
        return ell_sliced_keys_dep_batch_ref(gates, dga, dgb, dep_idx, sliced)

    twin = functools.partial
    for name, oracle in (
        ("ell_relax", ell_relax_ref),
        ("ell_relax_batch", ell_relax_batch_ref),
        ("ell_push_relax_batch", push_ref),
        ("ell_push_rect_batch", ell_push_rect_batch_ref),
        ("ell_key_min", ell_key_min_ref),
        ("ell_key_min_batch", ell_key_min_batch_ref),
        ("ell_key_min_status_batch", ell_key_min_status_batch_ref),
        ("ell_gather_min_batch", ell_gather_min_batch_ref),
        ("ell_relax_keys_batch", ell_relax_keys_batch_ref),
        ("ell_keys_dep_batch", keys_dep_ref),
        ("ell_sliced_gather_min_batch", gather_ref),
        ("ell_sliced_relax_keys_batch", ell_sliced_relax_keys_batch_ref),
        ("ell_sliced_relax_keys_batch_push", ell_sliced_relax_keys_batch_ref),
        ("ell_sliced_keys_dep_batch", sliced_keys_dep_ref),
        ("ell_sliced_push_relax_batch", ell_push_relax_batch_ref),
        ("frontier_crit", frontier_crit_ref),
        ("frontier_crit_batch", frontier_crit_batch_ref),
        ("frontier_crit_lanes_batch", frontier_crit_lanes_batch_ref),
        ("embed_grad", embed_grad_ref),
        ("relax_settled", twin(ops.relax_settled, use_kernels=False)),
        ("static_thresholds", frontier_crit_ref),
        ("relax_settled_batch", twin(ops.relax_settled_batch,
                                     use_kernels=False)),
        ("relax_settled_batch_sliced",
         twin(ops.relax_settled_batch_sliced, use_kernels=False)),
        ("push_settled_batch", twin(ops.push_settled_batch,
                                    use_kernels=False)),
        ("push_settled_batch_sliced",
         twin(ops.push_settled_batch_sliced, use_kernels=False)),
        ("gather_min_batch_sliced",
         twin(ops.gather_min_batch_sliced, use_kernels=False)),
        ("static_thresholds_batch", frontier_crit_batch_ref),
        ("crit_thresholds_batch", frontier_crit_lanes_batch_ref),
        ("key_min_batch", twin(ops.key_min_batch, use_kernels=False)),
        ("key_min_batch_any", twin(ops.key_min_batch_any, use_kernels=False)),
        ("delta_relax_batch", twin(ops.delta_relax_batch, use_kernels=False)),
        ("relax_settled_gated_batch",
         twin(ops.relax_settled_gated_batch, use_kernels=False)),
        ("in_scan_relax_keys_gated_batch",
         twin(ops.in_scan_relax_keys_gated_batch, use_kernels=False)),
        ("in_scan_relax_keys_batch",
         twin(ops.in_scan_relax_keys_batch, use_kernels=False)),
        ("out_scan_keys_batch", twin(ops.out_scan_keys_batch,
                                     use_kernels=False)),
    ):
        reg.bind_oracle(name, oracle)
