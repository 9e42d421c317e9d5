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
settled vertices' out-rows and needs no sentinel pad. Delta-stepping's
relax has the same two forms: the reference's two gathers over the
weight-gated incoming views (:func:`delta_relax_batch`) and the push the
delta policy runs (:func:`delta_push_relax_batch`).

The push plans' phase itself commits through the settle mark and the
worklist push (:func:`commit_phase`, ``kernels/settle_push.py``), which
take #2's thresholds and write ``dist`` and ``status`` in place; the
``push_settled_batch*`` functions stay for the callers that need ``upd``
(the oracle plans, the sharded stepper's rectangular form, the tools).
Delta's phase commits the same way after its own threshold
(:func:`delta_thresholds`, then :func:`commit_delta_phase`);
:func:`delta_push_relax_batch` stays as the counterpart of the reference's
``delta_relax_batch``, off the engine path.

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
    ell_delta_push_batch,
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
    ell_sliced_delta_push_batch,
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_push_relax_batch,
    ell_sliced_relax_keys_batch,
)
from repro_torch.kernels.frontier_crit import (
    delta_thresholds_batch,
    frontier_crit,
    frontier_crit_batch,
    frontier_crit_lanes_batch,
)
from repro_torch.kernels.settle_push import (  # noqa: F401 (the ops surface)
    CommitBuffers,
    DeltaRule,
    SettleRule,
    commit_delta_phase,
    commit_phase,
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


def weight_gated_ell(ell, delta):
    """Light and heavy weight-gated twins of an adjacency view, the
    reference's delta-stepping lowering: ``light`` keeps the weights
    ``w <= delta`` and masks the rest to +inf (min-neutral, as padding is),
    ``heavy`` keeps ``w > delta``. ``delta`` is a 0-dim f32 tensor (an f32
    compare). The twins share every index array with ``ell`` and replace
    only the weights: ``(cols, ws)`` pairs on the padded layout, and on a
    ``SlicedEll`` each bucket's ``ws`` (``cols``, ``rows``, the merge and
    write-through plans are the view's own). Padding (+inf) lands in the
    heavy twin unchanged. No delta path builds them: the delta policy's
    push (:func:`delta_push_relax_batch`) gates each weight as it reads it.
    """
    return kref.weight_gated(ell, delta)


def delta_relax_batch(d, light_from, heavy_from, ell_light, ell_heavy, *,
                      use_kernels=True):
    """Delta-stepping candidate updates (B, n), the reference's contract:
    the light relax of ``light_from`` over ``ell_light`` and the heavy
    relax of ``heavy_from`` over ``ell_heavy`` (:func:`weight_gated_ell`
    of the incoming view), min-merged. Each is a key-min gather of the
    +inf-masked ``d`` (``ell_key_min_batch``, or
    ``ell_sliced_gather_min_batch`` on the sliced layout), with the
    gathers of all-+inf columns not skipped, as the reference computes it.
    No engine path calls it: the delta policy relaxes by
    :func:`delta_push_relax_batch`, the same bits."""
    upd_light = key_min_batch_any(torch.where(light_from, d, INF), ell_light,
                                  use_kernels=use_kernels)
    upd_heavy = key_min_batch_any(torch.where(heavy_from, d, INF), ell_heavy,
                                  use_kernels=use_kernels)
    return kref.nan_min(upd_light, upd_heavy)


def delta_thresholds(d, status, last_proc, delta: float, *,
                     use_kernels=True):
    """Delta's threshold of one phase, ``(mins (2, B), counts (2, B))``
    (``frontier_crit.delta_thresholds_batch``, one launch): each lane's
    bucket, the least bucket id below ``last_proc``, and the two sets'
    sizes; the first count is |F|."""
    if not use_kernels:
        return kref.delta_thresholds_ref(d, status, last_proc, delta)
    return delta_thresholds_batch(d, status, last_proc, delta)


def delta_push_relax_batch(d, light_from, heavy_from, ell_out, delta, *,
                           use_kernels=True):
    """The relax of :func:`delta_relax_batch` in one push along the
    OUTGOING view of either layout (``to_ell_out``, or a sliced out-view
    with or without its merge plan): the light sources push their arcs of
    weight ``<= delta``, the heavy ones the others, each weight gated as
    it is read (``ell_delta_push_batch`` / ``ell_sliced_delta_push_batch``:
    one launch of each pass, the light and heavy sets of every lane
    together). ``delta`` is the f32 bucket width as a Python float (the
    kernel takes it by value: no read-back). The same bits as the two
    gathers over the weight-gated incoming views."""
    if not use_kernels:
        return kref.ell_delta_push_batch_ref(d, light_from, heavy_from,
                                             ell_out, delta)
    if _is_sliced(ell_out):
        return ell_sliced_delta_push_batch(d, light_from, heavy_from, ell_out,
                                           delta)
    return ell_delta_push_batch(d, light_from, heavy_from, ell_out[0],
                                ell_out[1], delta)


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


def register_kernels(reg):
    """Register the engine-facing wrapper contracts (``kernels/registry.py``):
    the callables the engines invoke, so the audit also covers the padding,
    masking and layout dispatch the raw kernels' contracts cannot see. They
    launch through the kernels' wrappers (no kernels of their own)."""
    from repro_torch.kernels import registry as R

    n, b, k = R.FIXTURE_N, R.FIXTURE_B, R.FIXTURE_K

    def rows(shape, seed, **kw):
        return R.fixture_rows(shape, seed=seed, **kw)

    def settle(shape, seed):
        return R.fixture_status(shape, seed) == 1

    def cases_relax_settled():
        return (R.SpecCase("default", (rows((n,), 30), settle((n,), 31),
                                       *R.fixture_ell())),)

    def cases_static_thresholds():
        return (R.SpecCase("default", (rows((n,), 32), R.fixture_status(
            (n,), 33), rows((n,), 34))),)

    def cases_relax_settled_batch():
        return (
            R.SpecCase("default", (rows((b, n), 35), settle((b, n), 36),
                                   *R.fixture_ell())),
            R.SpecCase("b40_n13", (rows((40, 13), 135, nan=True),
                                   settle((40, 13), 136),
                                   *R.fixture_ell(13, 5, 137, signed=True))),
        )

    def cases_relax_settled_sliced():
        return (
            R.SpecCase("sliced", (rows((b, n), 37), settle((b, n), 38),
                                  R.fixture_sliced(side="in"))),
            R.SpecCase("groups_b8", (rows((8, 60), 137, nan=True),
                                     settle((8, 60), 138),
                                     R.fixture_sliced_groups("in"))),
        )

    def cases_push_settled():
        return (R.SpecCase("default", (rows((b, n), 39), settle((b, n), 40),
                                       *R.fixture_out_ell())),)

    def cases_push_settled_sliced():
        return (R.SpecCase("sliced", (rows((b, n), 41), settle((b, n), 42),
                                      R.fixture_sliced(side="out"))),)

    def cases_gather_sliced():
        return (R.SpecCase("sliced", (rows((k, b, n), 39),
                                      R.fixture_sliced(side="in"))),)

    def cases_static_thresholds_batch():
        return (R.SpecCase("default", (rows((b, n), 40), R.fixture_status(
            (b, n), 41), rows((n,), 42))),)

    def cases_crit_thresholds():
        d, status = rows((b, n), 43), R.fixture_status((b, n), 44)
        return (
            R.SpecCase("nokeys", (d, status, None)),
            R.SpecCase("shared_keys", (d, status, rows((k, n), 45))),
            R.SpecCase("per_lane_keys", (d, status, rows((k, b, n), 46))),
        )

    def cases_key_min():
        return (R.SpecCase("default", (rows((b, n), 47), *R.fixture_ell())),)

    def cases_key_min_any():
        gate = rows((b, n), 48)
        return (
            R.SpecCase("padded", (gate, R.fixture_ell())),
            R.SpecCase("sliced", (gate, R.fixture_sliced(side="in"))),
        )

    def _gate_parts(seed0):
        return tuple((rows((b, n), seed0 + 3 * i),
                      rows((b, n), seed0 + 3 * i + 1),
                      rows((b, n), seed0 + 3 * i + 2)) for i in range(k))

    def cases_in_scan():
        d, st = rows((b, n), 49), settle((b, n), 50)
        gp = _gate_parts(51)
        return (
            R.SpecCase("padded", (d, st, gp, R.fixture_ell())),
            R.SpecCase("sliced", (d, st, gp, R.fixture_sliced(side="in"))),
            R.SpecCase("sliced_push", (d, st, gp, R.fixture_sliced(
                side="in")), {"out_view": R.fixture_sliced(side="out")}),
        )

    def cases_delta_relax():
        delta = torch.tensor(0.5, dtype=torch.float32)
        ell_l, ell_h = weight_gated_ell(R.fixture_ell(), delta)
        sl_l, sl_h = weight_gated_ell(R.fixture_sliced(side="in"), delta)
        d = rows((b, n), 70)
        light = R.fixture_status((b, n), 71) == 1
        heavy = R.fixture_status((b, n), 72) == 2
        return (
            R.SpecCase("padded", (d, light, heavy, ell_l, ell_h)),
            R.SpecCase("sliced", (d, light, heavy, sl_l, sl_h)),
        )

    def cases_delta_push():
        gates = R.fixture_delta_gates(b, n, 73, signed=True)
        return (
            R.SpecCase("padded", (*gates, R.fixture_out_ell(signed=True),
                                  R.FIXTURE_DELTA)),
            R.SpecCase("sliced", (*gates, R.fixture_sliced(side="out"),
                                  R.FIXTURE_DELTA)),
        )

    def cases_relax_gated():
        d, st = rows((b, n), 80), settle((b, n), 81)
        bound = rows((b,), 82, inf_frac=0.4)
        return (
            R.SpecCase("padded", (d, st, bound, R.fixture_ell())),
            R.SpecCase("sliced", (d, st, bound, R.fixture_sliced(side="in"))),
        )

    def cases_in_scan_gated():
        d, st = rows((b, n), 83), settle((b, n), 84)
        bound = rows((b,), 85, inf_frac=0.4)
        gp = _gate_parts(86)
        return (
            R.SpecCase("padded", (d, st, bound, gp, R.fixture_ell())),
            R.SpecCase("sliced", (d, st, bound, gp,
                                  R.fixture_sliced(side="in"))),
        )

    def cases_out_scan():
        gates = rows((k, b, n), 60)
        dga, dgb = rows((b, n), 61), rows((b, n), 62)
        return (
            R.SpecCase("independent", (gates, None, R.fixture_ell())),
            R.SpecCase("dep_0", (gates, (dga, dgb, 0), R.fixture_ell())),
            R.SpecCase("dep_1", (gates, (dga, dgb, 1), R.fixture_ell())),
            R.SpecCase("dep_sliced", (gates, (dga, dgb, 0),
                                      R.fixture_sliced(side="out"))),
        )

    def cases_delta_thresholds():
        args, _ = R.fixture_delta()
        d, st, keys = args[:3]
        return (R.SpecCase("ref", (d, st, keys[0].contiguous(), args[-1])),)

    for name, fn, cases, counters in (
        ("relax_settled", relax_settled, cases_relax_settled, ()),
        ("static_thresholds", static_thresholds, cases_static_thresholds,
         (2,)),
        ("relax_settled_batch", relax_settled_batch,
         cases_relax_settled_batch, ()),
        ("relax_settled_batch_sliced", relax_settled_batch_sliced,
         cases_relax_settled_sliced, ()),
        ("push_settled_batch", push_settled_batch, cases_push_settled, ()),
        ("push_settled_batch_sliced", push_settled_batch_sliced,
         cases_push_settled_sliced, ()),
        ("gather_min_batch_sliced", gather_min_batch_sliced,
         cases_gather_sliced, ()),
        ("static_thresholds_batch", static_thresholds_batch,
         cases_static_thresholds_batch, (2,)),
        ("crit_thresholds_batch", crit_thresholds_batch,
         cases_crit_thresholds, (1,)),
        ("delta_thresholds", delta_thresholds, cases_delta_thresholds, (1,)),
        ("key_min_batch", key_min_batch, cases_key_min, ()),
        ("key_min_batch_any", key_min_batch_any, cases_key_min_any, ()),
        ("delta_relax_batch", delta_relax_batch, cases_delta_relax, ()),
        ("delta_push_relax_batch", delta_push_relax_batch, cases_delta_push,
         ()),
        ("relax_settled_gated_batch", relax_settled_gated_batch,
         cases_relax_gated, ()),
        ("in_scan_relax_keys_gated_batch", in_scan_relax_keys_gated_batch,
         cases_in_scan_gated, ()),
        ("in_scan_relax_keys_batch", in_scan_relax_keys_batch,
         cases_in_scan, ()),
        ("out_scan_keys_batch", out_scan_keys_batch, cases_out_scan, ()),
    ):
        reg.register(R.KernelContract(
            name=name, module=__name__, wrapper=fn, make_cases=cases,
            counter_outputs=counters))
