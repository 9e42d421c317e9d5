"""Min-plus edge relaxation, pull and push (CUDA kernels).

    upd[b, v] = min over edges (u, v, w) of dmask[b, u] + w

where ``dmask[b, u]`` is ``d[b, u]`` if u was settled this phase in lane b
and +inf otherwise. The kernels of this module:

  * :func:`ell_relax_batch`, the pull over the incoming ELL,
    ``min_j dmask[b, cols[v, j]] + ws[v, j]`` (the ops layer masks and pads
    dmask): the gather body of ``csrc/ell_gather.cu`` with one dmask row per
    lane and the skip of all-+inf columns on. The counterpart of the
    reference's ``ell_relax_batch``; no engine path runs it any more.
  * :func:`ell_push_relax_batch`, the push over the outgoing ELL: only the
    out-rows of the vertices settled in some lane are read, and candidates
    land in ``upd`` through an f32 atomic min (``csrc/ell_push.cu``). The
    relax of every plan without in-side dynamic keys. The same bits as the
    pull (every NaN taken as one value).
  * :func:`ell_push_rect_batch`, the same push in a rectangular form: the
    rows are one rank's vertex block of a sharded graph and the targets
    global ids, so ``dmask`` is (B, n_rows) and ``upd`` (B, n_targets). The
    sharded stepper's relax and dynamic key scans
    (``core/distributed.py``).
  * :func:`ell_delta_push_batch`, delta-stepping's relax as one push over
    the padded outgoing ELL: the light sources push their arcs of weight
    ``<= delta``, the heavy ones the others, with the weight gate formed in
    the kernel (``csrc/ell_push.cu``, its delta form). The same bits as the
    reference's two gathers over the weight-gated incoming views.

Each source's note says what bounds its kernel on the card and how the
design answers. A tensor on the CPU runs the plain twin in
``kernels/ref.py``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import runs_twin
from repro_torch.kernels.ell_relax_keys import check_inputs, gather_rows, launch

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
PUSH_SIGNATURES = {
    "ell_push_relax_launch": ([_P, _LL, _I, _P, _I, _P, _P, _P, _P], _I),
    "ell_push_rect_launch": ([_P, _LL, _LL, _I, _P, _I, _P, _P, _P, _P], _I),
    "ell_delta_push_launch": ([_P, _P, _P, _F, _LL, _I, _P, _I, _P, _P, _P,
                               _P], _I),
    # the phase-committing pair (kernels/settle_push.py)
    "settle_phase_launch": ([_I, _P, _P, _I, _P], _I),
}
MAX_PUSH_LANES = 32 * 65535  # lane tiles ride the grid's second axis


def ell_relax_batch(dmask: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """Returns upd (B, n) f32 = per-lane row-min of dmask[b, cols] + ws.

    ``dmask`` is (B, n_pad) f32 with +inf at masked, padded and sentinel
    slots; ``cols`` (n, D) int32 ids into [0, n_pad); ``ws`` (n, D) f32.
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n_pad); got {tuple(dmask.shape)}")
    check_inputs({"dmask": dmask}, cols, ws)
    if dmask.shape[1] < 1:
        raise ValueError("dmask rows need at least one slot")
    if runs_twin(dmask):
        return ref.ell_relax_batch_ref(dmask, cols, ws)
    out = torch.empty((dmask.shape[0], cols.shape[0]), dtype=torch.float32,
                      device=dmask.device)
    if out.numel() == 0:
        return out
    gather_rows(dmask, dmask.shape[1], cols, ws, out, sparse=True)
    ell_relax_batch.launches += 1
    return out


ell_relax_batch.launches = 0  # kernel launches since the last reset


def ell_relax(dmask: torch.Tensor, cols: torch.Tensor,
              ws: torch.Tensor) -> torch.Tensor:
    """1-D form: returns upd (n,) f32 = row-min of dmask[cols] + ws.

    The B = 1 view of :func:`ell_relax_batch`, through the same kernel
    (its launches count there).
    """
    if dmask.dim() != 1:
        raise ValueError(f"want dmask (n_pad,); got {tuple(dmask.shape)}")
    return ell_relax_batch(dmask[None], cols, ws)[0]


def push_library():
    """The loaded ``ell_push`` library (built at first use)."""
    return _build.load("ell_push", PUSH_SIGNATURES)


def _push_setup(b: int, m: int, dev, stats):
    """The output ``upd`` (B, m) of a push launch, after the checks every
    form shares."""
    upd = torch.empty((b, m), dtype=torch.float32, device=dev)
    if upd.numel() and b > MAX_PUSH_LANES:
        raise ValueError(f"{b} lanes; the push takes at most {MAX_PUSH_LANES}")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.shape != (2,)):
        raise ValueError("want stats as a (2,) int64 tensor on the card")
    return upd


def _push_table(out_view):
    """The host bucket table of ``out_view`` (five int64 a bucket: cols,
    ws, rows or 0, row count, width) and its bucket count."""
    buckets = ([(s.rows, s.cols, s.ws) for s in out_view.slices]
               if hasattr(out_view, "slices") else [(None, *out_view)])
    entries = []
    for rows, cols, ws in buckets:
        entries += [cols.data_ptr(), ws.data_ptr(),
                    0 if rows is None else rows.data_ptr(), cols.shape[0],
                    cols.shape[1]]
    return (ctypes.c_longlong * max(len(entries), 1))(*entries), len(buckets)


def push_rows(dmask: torch.Tensor, out_view, stats=None,
              lib=None, n_targets: int | None = None) -> torch.Tensor:
    """Launch the push (``csrc/ell_push.cu``) along ``out_view``, a padded
    ``(cols, ws)`` pair or a sliced view, already checked; returns upd
    (B, n), or (B, n_targets) through the rectangular entry point when
    ``n_targets`` is given. ``stats``, a (2,) int64 tensor on the card or
    None, gets [candidates, atomics issued] added. ``lib`` is a build of
    the source with the same C interface (default :func:`push_library`)."""
    b, n = dmask.shape
    dev = dmask.device
    m = n if n_targets is None else int(n_targets)
    upd = _push_setup(b, m, dev, stats)
    if upd.numel() == 0:
        return upd
    table, n_buckets = _push_table(out_view)
    mask = torch.empty((-(-b // 32), n), dtype=torch.int32, device=dev)
    sizes = ((n,) if n_targets is None else (n, m))
    launch("ell_push_relax_batch" if n_targets is None
           else "ell_push_rect_batch",
           "ell_push_relax_launch" if n_targets is None
           else "ell_push_rect_launch", dev,
           dmask.data_ptr(), *sizes, b, ctypes.addressof(table),
           n_buckets, mask.data_ptr(), upd.data_ptr(),
           None if stats is None else stats.data_ptr(),
           lib=push_library() if lib is None else lib)
    return upd


def delta_push_rows(d: torch.Tensor, light: torch.Tensor,
                    heavy: torch.Tensor, out_view, delta: float,
                    stats=None, lib=None) -> torch.Tensor:
    """Launch the delta form of the push along ``out_view`` (padded or
    sliced, already checked): returns upd (B, n). ``delta`` is rounded to
    f32 once, here. ``stats`` and ``lib`` as in :func:`push_rows`."""
    b, n = d.shape
    dev = d.device
    upd = _push_setup(b, n, dev, stats)
    if upd.numel() == 0:
        return upd
    table, n_buckets = _push_table(out_view)
    mask = torch.empty((-(-b // 32), 2 * n), dtype=torch.int32, device=dev)
    launch("ell_delta_push_batch", "ell_delta_push_launch", dev,
           d.data_ptr(), light.data_ptr(), heavy.data_ptr(), float(delta),
           n, b, ctypes.addressof(table), n_buckets, mask.data_ptr(),
           upd.data_ptr(), None if stats is None else stats.data_ptr(),
           lib=push_library() if lib is None else lib)
    return upd


def check_gates(d: torch.Tensor, light: torch.Tensor, heavy: torch.Tensor):
    """The delta push's checks on its lane inputs: (B, n) f32 ``d`` and
    bool ``light`` / ``heavy`` of its shape, one device, contiguous."""
    if d.dim() != 2:
        raise ValueError(f"want d (B, n); got {tuple(d.shape)}")
    for name, gate in (("light_from", light), ("heavy_from", heavy)):
        if gate.dtype != torch.bool or gate.shape != d.shape:
            raise ValueError(f"want a bool {name} of d's shape "
                             f"{tuple(d.shape)}; got {gate.dtype} "
                             f"{tuple(gate.shape)}")
        if gate.device != d.device:
            raise ValueError(f"inputs on different devices: d on {d.device}, "
                             f"{name} on {gate.device}")
        if not gate.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ell_push_relax_batch(dmask: torch.Tensor, cols: torch.Tensor,
                         ws: torch.Tensor, *, stats=None) -> torch.Tensor:
    """Returns upd (B, n) f32: the relax pushed along the padded outgoing
    ELL, ``min dmask[b, u] + ws[u, j]`` over the rows u and slots j with
    ``cols[u, j] = v``, +inf where v has no candidate.

    ``dmask`` is (B, n) f32, unpadded; ``cols`` (n, D) int32 ids in [0, n]
    and ``ws`` (n, D) f32 are ``to_ell_out``'s view: row u holds u's
    out-edges left-packed, and a row ends at its first id outside [0, n)
    (the sentinel n). Where ``dmask[b, u]`` is +inf, u pushes nothing in
    lane b. ``stats``: see :func:`push_rows` (the kernel only).
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n); got {tuple(dmask.shape)}")
    check_inputs({"dmask": dmask}, cols, ws)
    if cols.shape[0] != dmask.shape[1]:
        raise ValueError(
            f"the padded out-view needs one row per vertex: cols has "
            f"{cols.shape[0]} rows for n = {dmask.shape[1]}"
        )
    if runs_twin(dmask):
        return ref.ell_push_relax_batch_ref(dmask, (cols, ws))
    upd = push_rows(dmask, (cols, ws), stats)
    ell_push_relax_batch.launches += 1
    return upd


ell_push_relax_batch.launches = 0  # kernel launches since the last reset


def ell_push_rect_batch(dmask: torch.Tensor, cols: torch.Tensor,
                        ws: torch.Tensor, n_targets: int, *,
                        stats=None) -> torch.Tensor:
    """Returns upd (B, n_targets) f32: the push of
    :func:`ell_push_relax_batch` from ``n_rows`` owners to ``n_targets``
    global targets, ``min dmask[b, u] + ws[u, j]`` over the rows u and
    slots j with ``cols[u, j] = v``, +inf where v has no candidate.

    ``dmask`` is (B, n_rows) f32; ``cols`` (n_rows, D) int32 ids in
    [0, n_targets] and ``ws`` (n_rows, D) f32 are one rank's outgoing view
    of its vertex block (row u holds local vertex u's out-edges
    left-packed, and a row ends at its first id outside [0, n_targets),
    the sentinel n_targets). Where ``dmask[b, u]`` is +inf, u pushes
    nothing in lane b. ``stats``: see :func:`push_rows` (the kernel only).
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n_rows); got {tuple(dmask.shape)}")
    check_inputs({"dmask": dmask}, cols, ws)
    if cols.shape[0] != dmask.shape[1]:
        raise ValueError(
            f"the out-view needs one row per owner: cols has "
            f"{cols.shape[0]} rows for {dmask.shape[1]} dmask columns"
        )
    if int(n_targets) < 1:
        raise ValueError(f"n_targets must be >= 1; got {n_targets}")
    if runs_twin(dmask):
        return ref.ell_push_rect_batch_ref(dmask, cols, ws, int(n_targets))
    upd = push_rows(dmask, (cols, ws), stats, n_targets=int(n_targets))
    ell_push_rect_batch.launches += 1
    return upd


ell_push_rect_batch.launches = 0  # kernel launches since the last reset


def ell_delta_push_batch(d: torch.Tensor, light_from: torch.Tensor,
                         heavy_from: torch.Tensor, cols: torch.Tensor,
                         ws: torch.Tensor, delta: float, *,
                         stats=None) -> torch.Tensor:
    """Returns upd (B, n) f32, delta-stepping's relax pushed along the
    padded outgoing ELL: the nan_min of ``d[b, u] + (w <= delta ? w :
    +inf)`` over the out-arcs (u, v, w) with ``light_from[b, u]`` and of
    ``d[b, u] + (w > delta ? w : +inf)`` over those with
    ``heavy_from[b, u]``; +inf where v has no candidate. The reference's
    ``delta_relax_batch`` over the ``weight_gated_ell`` twins of the
    incoming view, bit for bit (every NaN taken as one value).

    ``d`` is (B, n) f32; ``light_from`` / ``heavy_from`` (B, n) bool, which
    may overlap; ``cols`` / ``ws`` ``to_ell_out``'s view (rows end at their
    first id outside [0, n)). ``delta`` is a Python float, rounded to f32
    as the reference's ``jnp.float32(delta)`` is; a source whose ``d`` is
    +inf pushes nothing. ``stats``: see :func:`push_rows` (the kernel
    only).
    """
    check_gates(d, light_from, heavy_from)
    check_inputs({"d": d}, cols, ws)
    if cols.shape[0] != d.shape[1]:
        raise ValueError(
            f"the padded out-view needs one row per vertex: cols has "
            f"{cols.shape[0]} rows for n = {d.shape[1]}"
        )
    if runs_twin(d):
        return ref.ell_delta_push_batch_ref(d, light_from, heavy_from,
                                            (cols, ws), delta)
    upd = delta_push_rows(d, light_from, heavy_from, (cols, ws), delta, stats)
    ell_delta_push_batch.launches += 1
    return upd


ell_delta_push_batch.launches = 0  # kernel launches since the last reset


def register_kernels(reg):
    """Register this module's kernel contracts (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    pull = ((R.SRC_GATHER, "pack_kernel"), (R.SRC_GATHER, "gather_min_kernel"))
    push = ((R.SRC_PUSH, "push_mark_kernel"), (R.SRC_PUSH, "push_kernel"))

    def cases_1d():
        return (
            R.SpecCase("one_row", (R.fixture_lane_batch(1)[0],
                                   *R.fixture_ell())),
            R.SpecCase("signed_nan", (
                R.fixture_lane_batch(1, 13, seed=7, nan=True,
                                     signed=True)[0],
                *R.fixture_ell(13, 5, seed=8, signed=True))),
        )

    def cases_batch():
        dmask, ell = R.fixture_lane_batch(), R.fixture_ell()
        return (
            R.SpecCase("ref", (dmask, *ell)),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}",
                (R.fixture_lane_batch(b, n, seed, nan=True, signed=signed),
                 *R.fixture_ell(n, 5, seed, signed)))),
        )

    def cases_push():
        return (
            R.SpecCase("ref", (R.fixture_rows(
                (R.FIXTURE_B, R.FIXTURE_N), seed=2, inf_frac=0.5),
                *R.fixture_out_ell())),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}",
                (R.fixture_rows((b, n), seed, inf_frac=0.5, nan=True,
                                signed=signed),
                 *R.fixture_out_ell(n, seed, signed)))),
        )

    reg.register(R.KernelContract(
        name="ell_relax", module=__name__, wrapper=ell_relax,
        make_cases=cases_1d, kernels=pull,
        notes="#3: #1 at B = 1, through the same kernel"))
    reg.register(R.KernelContract(
        name="ell_relax_batch", module=__name__, wrapper=ell_relax_batch,
        make_cases=cases_batch, kernels=pull,
        notes="#1: the pull over the incoming ELL, single-sweep body"))
    def cases_rect():
        return (
            R.SpecCase("ref", R.fixture_rect()),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}", R.fixture_rect(b, n, seed, signed))),
        )

    reg.register(R.KernelContract(
        name="ell_push_relax_batch", module=__name__,
        wrapper=ell_push_relax_batch, make_cases=cases_push, kernels=push,
        notes="#1b: the relax pushed along the outgoing ELL (f32 atomic "
              "min)"))
    def cases_delta_push():
        return (
            R.SpecCase("ref", (*R.fixture_delta_gates(), *R.fixture_out_ell(),
                               R.FIXTURE_DELTA)),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}",
                (*R.fixture_delta_gates(b, n, seed, signed),
                 *R.fixture_out_ell(n, seed, signed), R.FIXTURE_DELTA))),
        )

    reg.register(R.KernelContract(
        name="ell_delta_push_batch", module=__name__,
        wrapper=ell_delta_push_batch, make_cases=cases_delta_push,
        kernels=R.DELTA_PUSH,
        notes="#5c: delta's relax, both turns, pushed along the outgoing "
              "ELL"))
    reg.register(R.KernelContract(
        name="ell_push_rect_batch", module=__name__,
        wrapper=ell_push_rect_batch, make_cases=cases_rect, kernels=push,
        notes="#1b in its rectangular form: one rank's vertex block pushed "
              "to global targets (the sharded stepper)"))
