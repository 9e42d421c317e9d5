"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

Every wrapper accepts ``use_kernels`` (the port's name for the reference's
``use_pallas``): the False path runs the plain twin from ``ref.py`` through
the same padding and masking code as the kernel path, so the two can never
drift apart bitwise. Engines select the path and never pad themselves:
this module is the one home of the sentinel convention.

Adjacency layouts: the wrappers that take an ``ell`` accept the padded
``(cols, ws)`` pair (``to_ell_in``) or a degree-sliced ``SlicedEll``
(``to_ell_in_sliced``); f32 min is exact, so both give the same bits. The
batched relax has two forms of one function: the reference's pull over
the incoming view (:func:`relax_settled_batch`,
:func:`relax_settled_batch_sliced`), and the push the engines run
(:func:`push_settled_batch`, :func:`push_settled_batch_sliced`), which
takes the *outgoing* view (``to_ell_out[_sliced]``), reads only the
settled vertices' out-rows and needs no sentinel pad.

The bound-gated wrappers (``*_gated_batch``) are the reference's surface
for s->t target lanes: the same kernels over a settle mask with the
sources at or beyond the lane's bound removed (:func:`_bound_gate`). The
engine gates the mask once itself and calls the plain wrappers.

The engines consume the batched entry points; the 1-D ``relax_settled`` /
``static_thresholds`` wrappers are the reference surfaces the tests pin the
batched ones against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.ell_key_min import (
    ell_key_min_batch,
    ell_key_min_status_batch,
)
from repro_torch.kernels.ell_relax import (
    ell_push_relax_batch,
    ell_relax,
    ell_relax_batch,
)
from repro_torch.kernels.ell_relax_keys import (
    ell_gather_min_batch,
    ell_keys_dep_batch,
    ell_relax_keys_batch,
)
from repro_torch.kernels.ell_sliced import (
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_push_relax_batch,
    ell_sliced_relax_keys_batch,
)
from repro_torch.kernels.frontier_crit import (
    frontier_crit,
    frontier_crit_batch,
    frontier_crit_lanes_batch,
)

INF = float("inf")


def pad_lane_batch(x: torch.Tensor, fill=INF) -> torch.Tensor:
    """(B, n) -> (B, n + 1) with ``fill`` in column n.

    THE sentinel convention of the ELL gather kernels: one extra slot for
    the sentinel neighbour id n, carrying a min-neutral fill. (The
    reference also rounds to a 128-lane multiple, a TPU layout artifact the
    card does not need; the values read are the same.)
    """
    b, n = x.shape
    out = torch.full((b, n + 1), fill, dtype=torch.float32, device=x.device)
    out[:, :n] = x
    return out


def _is_sliced(ell) -> bool:
    """Layout test: a ``SlicedEll`` has ``slices``; the padded view is a
    ``(cols, ws)`` pair."""
    return hasattr(ell, "slices")


def relax_settled(d, settle_mask, ell_cols, ell_ws, *, use_kernels=True):
    """Candidate-update vector (n,): upd[v] = min over in-edges from
    settled sources."""
    dmask = pad_lane_batch(torch.where(settle_mask, d, INF)[None])[0]
    if not use_kernels:
        return kref.ell_relax_ref(dmask, ell_cols, ell_ws)
    return ell_relax(dmask, ell_cols, ell_ws)


def static_thresholds(d, status, out_min_static, *, use_kernels=True):
    """(min_F d, L_out, |F|) for the INSTATIC/OUTSTATIC criteria, fused."""
    if not use_kernels:
        return kref.frontier_crit_ref(d, status, out_min_static)
    return frontier_crit(d, status, out_min_static)


def relax_settled_batch(d, settle_mask, ell_cols, ell_ws, *,
                        use_kernels=True):
    """Batched candidate updates (B, n), the reference's contract: the pull
    over the padded INCOMING ELL ``(ell_cols, ell_ws)`` (``to_ell_in``) on
    kernel #1, one adjacency load serving all B rows. No engine path calls
    it: the engines relax by :func:`push_settled_batch`, the same bits."""
    dmask = pad_lane_batch(torch.where(settle_mask, d, INF))
    if not use_kernels:
        return kref.ell_relax_batch_ref(dmask, ell_cols, ell_ws)
    return ell_relax_batch(dmask, ell_cols, ell_ws)


def relax_settled_batch_sliced(d, settle_mask, sliced, *, use_kernels=True):
    """Sliced-layout twin of :func:`relax_settled_batch`: the pull over a
    degree-sliced INCOMING view (``to_ell_in_sliced``) on kernel #9, with
    its skip of all-+inf columns on; bit-identical."""
    dmask = torch.where(settle_mask, d, INF)[None]
    if not use_kernels:
        return kref.ell_sliced_gather_min_batch_ref(dmask, sliced)[0]
    return ell_sliced_gather_min_batch(dmask, sliced, sparse=True)[0]


def push_settled_batch(d, settle_mask, out_cols, out_ws, *,
                       use_kernels=True):
    """The relax of :func:`relax_settled_batch` pushed along the padded
    OUTGOING ELL ``(out_cols, out_ws)`` (``to_ell_out``): upd[b, v] = min
    over out-edges (u, v) of the vertices u settled in lane b; one read of
    a settled vertex's out-row serves all its lanes. The same bits as the
    pull over the incoming ELL."""
    dmask = torch.where(settle_mask, d, INF)
    if not use_kernels:
        return kref.ell_push_relax_batch_ref(dmask, (out_cols, out_ws))
    return ell_push_relax_batch(dmask, out_cols, out_ws)


def push_settled_batch_sliced(d, settle_mask, sliced_out, *,
                              use_kernels=True):
    """Sliced-layout twin of :func:`push_settled_batch`, pushed along a
    degree-sliced outgoing view (``to_ell_out_sliced``); bit-identical."""
    dmask = torch.where(settle_mask, d, INF)
    if not use_kernels:
        return kref.ell_push_relax_batch_ref(dmask, sliced_out)
    return ell_sliced_push_relax_batch(dmask, sliced_out)


def _bound_gate(d, settle_mask, bound):
    """The s->t gate: prune relax sources at or beyond the lane's bound.

    ``bound`` is (B,) f32, the target's current tentative distance (+inf on
    full-solve lanes, where the gate changes nothing). A settled vertex
    with ``d >= bound`` can only emit candidates ``>= bound`` (adding a
    non-negative f32 weight is monotone), and the bound never drops below
    the target's final distance, so dropping these sources never changes
    ``dist[target]``.
    """
    return settle_mask & (d < bound[:, None])


def relax_settled_gated_batch(d, settle_mask, bound, ell, *,
                              use_kernels=True):
    """Bound-gated twin of :func:`relax_settled_batch`, the reference's
    contract: the pull over the INCOMING view of either layout, with
    settled sources at or beyond ``bound`` masked out."""
    gated = _bound_gate(d, settle_mask, bound)
    if _is_sliced(ell):
        return relax_settled_batch_sliced(d, gated, ell,
                                          use_kernels=use_kernels)
    return relax_settled_batch(d, gated, ell[0], ell[1],
                               use_kernels=use_kernels)


def push_settled_gated_batch(d, settle_mask, bound, out_cols, out_ws, *,
                             use_kernels=True):
    """Bound-gated :func:`push_settled_batch` (the padded outgoing view):
    the gate is the push's settle mask and nothing else."""
    return push_settled_batch(d, _bound_gate(d, settle_mask, bound),
                              out_cols, out_ws, use_kernels=use_kernels)


def push_settled_gated_batch_sliced(d, settle_mask, bound, sliced_out, *,
                                    use_kernels=True):
    """Bound-gated :func:`push_settled_batch_sliced` (the sliced outgoing
    view)."""
    return push_settled_batch_sliced(d, _bound_gate(d, settle_mask, bound),
                                     sliced_out, use_kernels=use_kernels)


def gather_min_batch_sliced(vecs, sliced, *, use_kernels=True):
    """(V, B, n) per-vector row-mins over a degree-sliced adjacency, merged
    per vertex. On the card it is always the one-launch-per-pass kernel
    (pack, gather over every bucket, merge), never per-bucket calls of
    the padded gather. Its callers gather dense key gates, so the kernel's
    skip of all-+inf columns stays off."""
    if not use_kernels:
        return kref.ell_sliced_gather_min_batch_ref(vecs, sliced)
    return ell_sliced_gather_min_batch(vecs, sliced)


def static_thresholds_batch(d, status, out_min_static, *, use_kernels=True):
    """Per-lane (min_F d, L_out, |F|), each (B,), in one fused pass."""
    if not use_kernels:
        return kref.frontier_crit_batch_ref(d, status, out_min_static)
    return frontier_crit_batch(d, status, out_min_static)


def crit_thresholds_batch(d, status, keys, *, use_kernels=True):
    """Plan-lane thresholds: (mins (1+K, B), |F| (B,)) in one fused pass.

    ``keys`` is (K, n) shared, (K, B, n) per-lane or None; ``mins[0]`` is
    min_F d, ``mins[1+k]`` the OUT lane for ``keys[k]``.
    """
    if not use_kernels:
        return kref.frontier_crit_lanes_batch_ref(d, status, keys)
    return frontier_crit_lanes_batch(d, status, keys)


def key_min_batch(gate, ell_cols, ell_ws, *, use_kernels=True):
    """Dynamic criterion key (B, n): per-lane min of gate[neighbour] + w.

    Pads the gate with the +inf sentinel slot (both paths), as
    :func:`relax_settled` pads ``dmask``.
    """
    padded = pad_lane_batch(gate)
    if not use_kernels:
        return kref.ell_key_min_batch_ref(padded, ell_cols, ell_ws)
    return ell_key_min_batch(padded, ell_cols, ell_ws)


def key_min_batch_any(gate, ell, *, use_kernels=True):
    """:func:`key_min_batch` over either adjacency layout."""
    if _is_sliced(ell):
        return gather_min_batch_sliced(gate[None], ell,
                                       use_kernels=use_kernels)[0]
    return key_min_batch(gate, ell[0], ell[1], use_kernels=use_kernels)


def key_min_batch_for(kind, status, make_gate, ell, *, use_kernels=True):
    """A dynamic key (B, n) over either layout for the current ``status``,
    its gate of ``KeySpec.gate`` kind ``kind`` (``core/criteria.py``).

    An ``"unsettled"`` gate (+0 where status < 2, +inf elsewhere) on the
    padded layout is read from ``status`` itself as the status-gate table
    (one byte of lane bits a column, :func:`ell_key_min_status_batch`);
    every other kind, and the sliced layout, gather the f32 gate
    ``make_gate()`` (called only then). The kind decides, never the gate's
    values; both paths give the same bits.
    """
    if kind == "unsettled" and not _is_sliced(ell):
        cols, ws = ell
        if not use_kernels:
            return kref.ell_key_min_status_batch_ref(status, cols, ws)
        return ell_key_min_status_batch(status, cols, ws)
    return key_min_batch_any(make_gate(), ell, use_kernels=use_kernels)


def in_scan_relax_keys_batch(d, settle_mask, gate_parts, ell, *,
                             out_view=None, use_kernels=True):
    """The fused in-scan: ``(upd (B, n), keys (K, B, n))``.

    ``upd`` is this phase's relax update; ``keys[k]`` is the k-th in-side
    dynamic key on the *post-phase* status through the gate
    ``min(ga, gb, gc + fin(upd))`` (``criteria.in_scan_gate_parts``).
    ``gate_parts`` holds one ``(ga, gb, gc)`` triple per key. On the card
    the two sweeps always run as one kernel call, on either layout; it is
    bit-identical to the split form the reference may choose.

    ``out_view``: on the sliced layout, the sliced outgoing view; the
    kernel then computes ``upd`` by the push along it (the same bits). The
    padded in-scan keeps its pull and takes none. The plain twins are the
    same either way.
    """
    dmask = torch.where(settle_mask, d, INF)
    ga, gb, gc = (torch.stack([p[i] for p in gate_parts]) for i in range(3))
    if _is_sliced(ell):
        if not use_kernels:
            return kref.ell_sliced_relax_keys_batch_ref(dmask, ga, gb, gc, ell)
        return ell_sliced_relax_keys_batch(dmask, ga, gb, gc, ell,
                                           out_view=out_view)
    if out_view is not None:
        raise ValueError("the padded in-scan relaxes by its pull: out_view "
                         "is for the sliced layout")
    cols, ws = ell
    if not use_kernels:
        return kref.ell_relax_keys_batch_ref(dmask, ga, gb, gc, cols, ws)
    return ell_relax_keys_batch(dmask, ga, gb, gc, cols, ws)


def in_scan_relax_keys_gated_batch(d, settle_mask, bound, gate_parts, ell,
                                   *, out_view=None, use_kernels=True):
    """Bound-gated twin of :func:`in_scan_relax_keys_batch`.

    Only the relax sources are gated; the key gates (built by the caller
    from the full post-settle status) pass through, and the kernel's
    ``fin(upd)`` term then reads the pruned update, so the emitted keys are
    what re-deriving them from the pruned state's status would give. The
    kernels read the settle mask only as ``dmask``, so the gate reaches the
    relax alone on either layout, the push form (``out_view``) included.
    """
    return in_scan_relax_keys_batch(
        d, _bound_gate(d, settle_mask, bound), gate_parts, ell,
        out_view=out_view, use_kernels=use_kernels)


def out_scan_keys_batch(gates, dep_parts, ell, *, use_kernels=True):
    """The fused out-scan: keys ``(K0 [+1], B, n)``.

    Every independent out-side key rides one multi-vector gather; a
    dependent key (``dep_parts = (dga, dgb, dep_idx)``, the ``out_full``
    of paper Eq. 2) adds the second sweep of the same kernel call.
    """
    if _is_sliced(ell):
        if dep_parts is None:
            return gather_min_batch_sliced(gates, ell, use_kernels=use_kernels)
        dga, dgb, dep_idx = dep_parts
        if not use_kernels:
            return kref.ell_sliced_keys_dep_batch_ref(gates, dga, dgb,
                                                      dep_idx, ell)
        return ell_sliced_keys_dep_batch(gates, dga, dgb, ell,
                                         dep_idx=dep_idx)
    cols, ws = ell
    if dep_parts is None:
        if not use_kernels:
            return kref.ell_gather_min_batch_ref(gates, cols, ws)
        return ell_gather_min_batch(gates, cols, ws)
    dga, dgb, dep_idx = dep_parts
    if not use_kernels:
        return kref.ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws)
    return ell_keys_dep_batch(gates, dga, dgb, cols, ws, dep_idx=dep_idx)
