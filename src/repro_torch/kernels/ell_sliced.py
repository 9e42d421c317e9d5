"""Gather-min, the fused scans and the push relax over a degree-sliced
adjacency (CUDA kernels).

Five kernels over a :class:`~repro_torch.core.graph.SlicedEll`, each with
a ``.launches`` count (one per call that launched its kernels):

  * :func:`ell_sliced_gather_min_batch`: V vectors x B lanes,
    ``out[v, b, x] = min_c part[v, b, merge_idx[x, c]]`` where ``part`` is
    the row-min ``min_j vecs[v, b, cols[r, j]] + ws[r, j]`` of every row of
    every bucket (a split vertex owns several rows). With ``sparse`` (the
    relax's ``dmask``) the gathers of all-+inf columns are skipped.
  * :func:`ell_sliced_relax_keys_batch`: the fused in-scan, the sliced twin
    of ``ell_relax_keys_batch``; given the sliced outgoing view, its relax
    sweep is the push along it (counted in ``.push_launches``).
  * :func:`ell_sliced_keys_dep_batch`: the fused out-scan, the sliced twin
    of ``ell_keys_dep_batch``;
  * :func:`ell_sliced_push_relax_batch`: the relax pushed along a sliced
    *outgoing* view, the sliced twin of ``ell_push_relax_batch``
    (``csrc/ell_push.cu``); it needs no merge, since the atomic min lands
    each split row's candidates in the vertex's slot directly.
  * :func:`ell_sliced_delta_push_batch`: delta-stepping's relax pushed
    along a sliced outgoing view, the sliced twin of
    ``ell_delta_push_batch``; it reads only the buckets, so it also takes
    a view without a merge plan (``to_ell_out_buckets``).

Vectors come unpadded, ``(..., n)``: the sentinel id n reads +inf. The
gather, and the in-scan's relax sweep where no push takes its place, run
on the single-sweep body of ``csrc/ell_gather.cu`` (one pack, one gather
launch over a bucket table, a merge pass over every vertex); the fused
scans' dense sweeps on its pipelined scan body, over a unit list that
spans the buckets (:func:`scan_units`, built here on the host), writing
each single-row vertex's result in place and merging only the vertices of
``merge_short``. The notes in that file say what bounds them on the card.
A view takes any number of buckets: one launch of a pass takes a group of
``SLICED_GROUP_BUCKETS`` (:func:`bucket_groups`), and a view with more runs
the pass once a group, in order. A tensor on the CPU runs the plain twin in
``kernels/ref.py``; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.config import (
    RELAX_THREADS,
    SCAN_CAP,
    SCAN_SKIP_WARPS,
    SCAN_WARPS,
    SLICED_GROUP_BUCKETS,
    relax_threads_per_row,
    runs_twin,
)
from repro_torch.kernels.ell_relax import (
    check_gates,
    delta_push_rows,
    push_rows,
)
from repro_torch.kernels.ell_relax_keys import (
    check_inputs,
    lane_tile,
    launch,
    live_bits_scratch,
    packed_scratch,
)

MAX_GRID_Y = 65535  # lanes of one merge launch (its grid's second axis)


def check_buckets(vecs: dict, sliced):
    """:func:`check_inputs` for every bucket of ``sliced``, and its rows:
    (R,) int32 owner ids on the vectors' device."""
    if not sliced.slices:
        raise ValueError("a sliced view needs at least one bucket")
    dev = next(iter(vecs.values())).device
    for s in sliced.slices:
        check_inputs(vecs, s.cols, s.ws)
        if s.rows.dtype != torch.int32 or s.rows.shape != s.cols.shape[:1]:
            raise ValueError(
                f"want int32 rows ({s.cols.shape[0]},); got "
                f"{tuple(s.rows.shape)} {s.rows.dtype}"
            )
        if s.rows.device != dev:
            raise ValueError("a bucket's rows and the vectors are on "
                             "different devices")


def check_sliced(vecs: dict, sliced, n: int):
    """:func:`check_buckets`, plus the view's merge plan: ``merge_idx``
    (n, C) int32 with its compact form and write-through plan, on the
    vectors' device."""
    check_buckets(vecs, sliced)
    midx = sliced.merge_idx
    if midx.dim() != 2 or midx.shape[0] != n or midx.dtype != torch.int32:
        raise ValueError(
            f"want an ({n}, C) int32 merge_idx; got {tuple(midx.shape)} "
            f"{midx.dtype}"
        )
    ptr, pos = sliced.merge_ptr, sliced.merge_pos
    if ptr.shape != (n + 1,) or ptr.dtype != torch.int64 \
            or pos.dim() != 1 or pos.dtype != torch.int32:
        raise ValueError("want the compact merge plan of sliced_ell: "
                         "(n + 1,) int64 merge_ptr, (nnz,) int32 merge_pos")
    owner, short = sliced.row_owner, sliced.merge_short
    if owner.shape != (sliced.total_rows,) or owner.dtype != torch.int32 \
            or short.dim() != 1 or short.dtype != torch.int32:
        raise ValueError("want the write-through plan of sliced_ell: "
                         "(R_total,) int32 row_owner, (S,) int32 merge_short")
    plan = (midx, ptr, pos, owner, short)
    dev = next(iter(vecs.values())).device
    if any(t.device != dev for t in plan):
        raise ValueError("the merge plan and the vectors are on different "
                         "devices")


class _Plan:
    """What every gather launch over one sliced view passes to the C side:
    the bucket table (host int64, five entries a bucket), the total rows
    and the compact merge plan."""

    def __init__(self, sliced):
        live = [s for s in sliced.slices if s.rows.shape[0]]
        entries = []
        for s in live:
            d_pad = s.cols.shape[1]
            entries += [s.cols.data_ptr(), s.ws.data_ptr(), s.rows.shape[0],
                        d_pad, relax_threads_per_row(d_pad)]
        self.n_slices = len(live)
        self.table = (ctypes.c_longlong * max(len(entries), 1))(*entries)
        self.r_total = sliced.total_rows
        self.merge_ptr = sliced.merge_ptr.data_ptr()
        self.merge_pos = sliced.merge_pos.data_ptr()

    def args(self):
        return (ctypes.addressof(self.table), self.n_slices, self.r_total,
                self.merge_ptr, self.merge_pos, RELAX_THREADS)

    def partials(self, lanes: int, dev) -> torch.Tensor:
        return torch.empty((max(lanes * self.r_total, 1),),
                           dtype=torch.float32, device=dev)


def scan_geometry(d_pad: int, lanes: int, skip: bool, *, cap: int = SCAN_CAP,
                  warps: int = SCAN_WARPS,
                  skip_warps: int = SCAN_SKIP_WARPS) -> tuple:
    """``(tpr, rows, chunk, chunks)`` of a bucket of width ``d_pad`` on the
    pipelined scan body, for a sweep over ``lanes`` gather lanes (``skip``:
    the sparse relax sweep's larger block): the rule of ``scan_geometry`` in
    ``csrc/ell_gather.cu``. ``tpr`` threads a row start at the threads that
    share one slot's sector and double while a unit's rows hold more than
    ``cap`` slots; rows still wider than a stage go chunk by chunk. The
    keywords are the build's constants (a variant of the body may change
    them)."""
    threads = 32 * (skip_warps if skip else warps)
    w = lane_tile(lanes)
    tpr = w // 4 if w > 4 else 1
    while tpr < 32 and (threads // tpr) * d_pad > cap:
        tpr *= 2
    rows = threads // tpr
    chunk = d_pad if rows * d_pad <= cap else (cap // rows - 8) & ~3
    return tpr, rows, chunk, -(-d_pad // chunk)


def bucket_groups(sliced) -> list[list]:
    """The buckets with rows of ``sliced``, in the concatenation's order, in
    groups of at most ``SLICED_GROUP_BUCKETS``: each pass of a sliced kernel
    launches once a group, in this order (``csrc/ell_gather.cu`` and
    ``csrc/ell_push.cu`` group the same way)."""
    live = [s for s in sliced.slices if s.rows.shape[0]]
    return [live[i:i + SLICED_GROUP_BUCKETS]
            for i in range(0, len(live), SLICED_GROUP_BUCKETS)]


def scan_units(sliced, lanes: int, skip: bool, **shape) -> list[tuple]:
    """The unit table of one sweep over ``sliced``: a row of ten ints for
    each bucket with rows, in the concatenation's order: cols and ws
    addresses, rows, width, then :func:`scan_geometry`'s four, the bucket's
    first unit in its group of :func:`bucket_groups` (one launch a group; a
    bucket's units follow the previous bucket's of the group) and its first
    row in the concatenation. The kernel checks every row against its
    build."""
    table, first_row = [], 0
    for group in bucket_groups(sliced):
        unit = 0
        for s in group:
            n_rows = int(s.rows.shape[0])
            d_pad = int(s.cols.shape[1])
            tpr, rows, chunk, chunks = scan_geometry(d_pad, lanes, skip,
                                                     **shape)
            table.append((s.cols.data_ptr(), s.ws.data_ptr(), n_rows, d_pad,
                          tpr, rows, chunk, chunks, unit, first_row))
            unit += -(-n_rows // rows)
            first_row += n_rows
    return table


class _ScanPlan:
    """What a fused scan over one sliced view passes to the C side: unit
    tables on demand (host int64, ten a bucket) and the merge plan (eight
    int64: row_owner, merge_ptr, merge_pos, merge_short, total rows, the
    short list's length, merge_multi, split_rows). ``shape``: see
    :func:`scan_geometry`."""

    def __init__(self, sliced, **shape):
        self.sliced, self.shape = sliced, shape
        self.n_buckets = len(scan_units(sliced, 1, False, **shape))
        self.plan = (ctypes.c_longlong * 8)(
            sliced.row_owner.data_ptr(), sliced.merge_ptr.data_ptr(),
            sliced.merge_pos.data_ptr(), sliced.merge_short.data_ptr(),
            sliced.total_rows, sliced.merge_short.numel(),
            sliced.merge_multi, sliced.split_rows)

    def table(self, lanes: int, skip: bool):
        flat = [x for row in scan_units(self.sliced, lanes, skip,
                                        **self.shape) for x in row]
        return (ctypes.c_longlong * max(len(flat), 1))(*flat)

    def split(self, lanes: int, dev) -> torch.Tensor:
        """The compact scratch of the rows the short merge folds."""
        return torch.empty((max(lanes * self.sliced.split_rows, 1),),
                           dtype=torch.float32, device=dev)


def _check_lanes(lanes: int):
    if lanes > MAX_GRID_Y:
        raise ValueError(f"{lanes} gather lanes; the merge takes at most "
                         f"{MAX_GRID_Y}")


def ell_sliced_gather_min_batch(vecs: torch.Tensor, sliced, *,
                                sparse: bool = False) -> torch.Tensor:
    """Returns (V, B, n) f32: per-vector per-lane mins of
    ``vecs[v, b, cols] + ws`` over every bucket of ``sliced``, merged per
    vertex.

    ``vecs`` is (V, B, n) f32, unpadded; ids in [0, n] (n is the sentinel
    and reads +inf). ``sparse`` (``vecs`` is +inf almost everywhere, as the
    relax's ``dmask`` is) skips the gathers of all-+inf columns.
    """
    if vecs.dim() != 3:
        raise ValueError(f"want vecs (V, B, n); got {tuple(vecs.shape)}")
    v, b, n = vecs.shape
    check_sliced({"vecs": vecs}, sliced, n)
    if runs_twin(vecs):
        return ref.ell_sliced_gather_min_batch_ref(vecs, sliced)
    out = torch.empty((v, b, n), dtype=torch.float32, device=vecs.device)
    if out.numel() == 0:
        return out
    lanes, dev = v * b, vecs.device
    _check_lanes(lanes)
    plan = _Plan(sliced)
    # scratch held in locals until the launch returns: a freed temporary
    # could hand its memory to the next allocation while still in use
    packed = packed_scratch(lanes, n + 1, dev)
    live_bits = live_bits_scratch(n + 1, dev) if sparse else None
    partials = plan.partials(lanes, dev)
    launch("ell_sliced_gather_min_batch", "ell_sliced_gather_min_launch",
           dev, vecs.data_ptr(), n, lanes, *plan.args(), packed.data_ptr(),
           None if live_bits is None else live_bits.data_ptr(),
           partials.data_ptr(), out.data_ptr())
    ell_sliced_gather_min_batch.launches += 1
    return out


ell_sliced_gather_min_batch.launches = 0  # kernel launches since the last reset


def ell_sliced_relax_keys_batch(dmask, ga, gb, gc, sliced, *,
                                out_view=None):
    """Fused in-scan over a sliced view: ``(upd (B, n), keys (K, B, n))``.

    ``upd`` is exactly :func:`ell_sliced_gather_min_batch` of ``dmask``
    (B, n); ``keys[k]`` is the gather-min of the post-phase gate
    ``min(ga[k], gb[k], gc[k] + fin(upd))`` over (K, B, n) gate parts, ``fin``
    0 where ``upd`` is finite. K must be >= 1.

    ``out_view``, the sliced *outgoing* view of the same graph
    (``to_ell_out_sliced``), makes the relax sweep the push along it
    (``ell_push.cu``: only the settled vertices' out-rows are read); the
    gate sweep then reads its ``upd`` in stream order. The same bits; a
    call of this form counts in ``.push_launches``, the other in
    ``.launches``. Without it the relax sweep is the single-sweep body's
    sparse gather and merge (faster than the pipelined body there, PERF.md),
    the gate sweep the pipelined body's.
    """
    if ga.dim() != 3 or ga.shape[0] < 1:
        raise ValueError(f"need a (K>=1, B, n) gate stack; got {tuple(ga.shape)}")
    if dmask.dim() != 2 or not (ga.shape == gb.shape == gc.shape) \
            or ga.shape[1:] != dmask.shape:
        raise ValueError(
            f"want dmask (B, n) and ga, gb, gc (K, B, n); got "
            f"{tuple(dmask.shape)}, {tuple(ga.shape)}, {tuple(gb.shape)}, "
            f"{tuple(gc.shape)}"
        )
    b, n = dmask.shape
    check_sliced({"dmask": dmask, "ga": ga, "gb": gb, "gc": gc}, sliced, n)
    if out_view is not None:
        check_sliced({"dmask": dmask}, out_view, n)
    if runs_twin(dmask):
        return ref.ell_sliced_relax_keys_batch_ref(dmask, ga, gb, gc, sliced,
                                                   out_view=out_view)
    k, dev = ga.shape[0], dmask.device
    keys = torch.empty((k, b, n), dtype=torch.float32, device=dev)
    if keys.numel() == 0:
        return torch.empty((b, n), dtype=torch.float32, device=dev), keys
    lanes = max(b, k * b)
    _check_lanes(lanes)
    plan = _ScanPlan(sliced)
    # scratch and tables held in locals until the launch returns: a freed
    # temporary could hand its memory to the next allocation while in use
    packed = packed_scratch(lanes, n + 1, dev)
    split = plan.split(lanes, dev)
    table0, table1 = plan.table(b, skip=True), plan.table(k * b, skip=False)
    if out_view is None:  # the relax sweep: the single-sweep body's gather
        upd = torch.empty((b, n), dtype=torch.float32, device=dev)
        relax = _Plan(sliced)
        live_bits = live_bits_scratch(n + 1, dev)
        partials = relax.partials(b, dev)
        relax_args = (ctypes.addressof(relax.table), relax.n_slices,
                      RELAX_THREADS)
        bits, parts = live_bits.data_ptr(), partials.data_ptr()
    else:
        upd = push_rows(dmask, out_view)
        relax_args, bits, parts = (None, 0, RELAX_THREADS), None, None
    launch("ell_sliced_relax_keys_batch", "ell_sliced_relax_keys_launch", dev,
           dmask.data_ptr(), ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), n,
           b, k, *relax_args, ctypes.addressof(table0),
           ctypes.addressof(table1), plan.n_buckets,
           ctypes.addressof(plan.plan), packed.data_ptr(), bits, parts,
           split.data_ptr(), upd.data_ptr(), keys.data_ptr())
    if out_view is None:
        ell_sliced_relax_keys_batch.launches += 1
    else:
        ell_sliced_relax_keys_batch.push_launches += 1
    return upd, keys


ell_sliced_relax_keys_batch.launches = 0  # kernel launches since the last reset
ell_sliced_relax_keys_batch.push_launches = 0  # those with the push sweep


def ell_sliced_keys_dep_batch(gates, dga, dgb, sliced, *, dep_idx: int = 0):
    """Fused out-scan over a sliced view: keys ``(K0 + 1, B, n)``.

    Rows ``[:K0]`` are the gather-mins of the (K0, B, n) ``gates``; row
    ``K0`` is the gather-min of ``min(dga, dgb + keys[dep_idx])`` over the
    (B, n) dependent-gate parts. All unpadded.
    """
    if gates.dim() != 3:
        raise ValueError(f"want gates (K0, B, n); got {tuple(gates.shape)}")
    k0, b, n = gates.shape
    if not 0 <= dep_idx < k0:
        raise ValueError(f"dep_idx {dep_idx} out of range for K0={k0}")
    if dga.shape != (b, n) or dgb.shape != (b, n):
        raise ValueError(
            f"want dga and dgb ({b}, {n}); got {tuple(dga.shape)}, "
            f"{tuple(dgb.shape)}"
        )
    check_sliced({"gates": gates, "dga": dga, "dgb": dgb}, sliced, n)
    if runs_twin(gates):
        return ref.ell_sliced_keys_dep_batch_ref(gates, dga, dgb, dep_idx,
                                                 sliced)
    dev = gates.device
    out = torch.empty((k0 + 1, b, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lanes = max(k0 * b, b)
    _check_lanes(lanes)
    plan = _ScanPlan(sliced)
    packed = packed_scratch(lanes, n + 1, dev)
    split = plan.split(lanes, dev)
    table0, table1 = plan.table(k0 * b, skip=False), plan.table(b, skip=False)
    launch("ell_sliced_keys_dep_batch", "ell_sliced_keys_dep_launch", dev,
           gates.data_ptr(), dga.data_ptr(), dgb.data_ptr(), n, b, k0,
           int(dep_idx), ctypes.addressof(table0), ctypes.addressof(table1),
           plan.n_buckets, ctypes.addressof(plan.plan), packed.data_ptr(),
           split.data_ptr(), out.data_ptr())
    ell_sliced_keys_dep_batch.launches += 1
    return out


ell_sliced_keys_dep_batch.launches = 0  # kernel launches since the last reset


def ell_sliced_push_relax_batch(dmask: torch.Tensor, sliced, *,
                                stats=None) -> torch.Tensor:
    """Returns upd (B, n) f32: the relax pushed along a sliced outgoing view
    (``to_ell_out_sliced``), ``min dmask[b, rows[i]] + ws[i, j]`` over every
    bucket's rows i and slots j with ``cols[i, j] = v``, +inf where v has no
    candidate.

    ``dmask`` is (B, n) f32, unpadded. Row i of a bucket belongs to vertex
    ``rows[i]`` (a split hub owns several rows; an owner outside [0, n)
    pushes nothing); a row ends at its first id outside [0, n) (the
    sentinel n). ``merge_idx`` is not read: the atomic min lands each row's
    candidates in place. ``stats``: see ``ell_relax.push_rows`` (the kernel
    only).
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n); got {tuple(dmask.shape)}")
    check_sliced({"dmask": dmask}, sliced, dmask.shape[1])
    if runs_twin(dmask):
        return ref.ell_push_relax_batch_ref(dmask, sliced)
    upd = push_rows(dmask, sliced, stats)
    ell_sliced_push_relax_batch.launches += 1
    return upd


ell_sliced_push_relax_batch.launches = 0  # kernel launches since the last reset


def ell_sliced_delta_push_batch(d: torch.Tensor, light_from: torch.Tensor,
                                heavy_from: torch.Tensor, sliced,
                                delta: float, *, stats=None) -> torch.Tensor:
    """Returns upd (B, n) f32: ``ell_delta_push_batch``'s function pushed
    along a sliced outgoing view (``to_ell_out_sliced``, or its buckets
    alone, ``to_ell_out_buckets``): the light sources' arcs of weight
    ``<= delta`` and the heavy sources' others, over every bucket's rows i
    (owner ``rows[i]``) and slots j, +inf where v has no candidate. No
    merge plan is read. ``stats``: see ``ell_relax.push_rows`` (the kernel
    only).
    """
    check_gates(d, light_from, heavy_from)
    check_buckets({"d": d}, sliced)
    if runs_twin(d):
        return ref.ell_delta_push_batch_ref(d, light_from, heavy_from,
                                            sliced, delta)
    upd = delta_push_rows(d, light_from, heavy_from, sliced, delta, stats)
    ell_sliced_delta_push_batch.launches += 1
    return upd


ell_sliced_delta_push_batch.launches = 0  # kernel launches since the last reset


def register_kernels(reg):
    """Register this module's kernel contracts (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    g = R.SRC_GATHER
    gather = ((g, "pack_kernel"), (g, "sliced_gather_min_kernel"),
              (g, "merge_kernel"))
    scan = ((g, "pack_kernel"), (g, "scan_kernel"), (g, "short_merge_kernel"))
    push = ((R.SRC_PUSH, "push_mark_kernel"), (R.SRC_PUSH, "push_kernel"))
    k = R.FIXTURE_K

    def views():
        """(label, lanes, n, in-view, out-view): the reference's small
        view, the same build at n % 4 = 1 and 3, and views of more than 16
        buckets with rows at B = 1, 8, 13, 40."""
        out = [(f"n{n}_b3", 3, n, R.fixture_sliced(n, side="in"),
                R.fixture_sliced(n, side="out")) for n in (10, 13, 11)]
        sl_in, sl_out = R.fixture_sliced_groups("in"), \
            R.fixture_sliced_groups("out")
        n = sl_in.merge_idx.shape[0]
        out += [(f"groups_b{b}", b, n, sl_in, sl_out) for b in (1, 8, 13, 40)]
        return out

    def cases_gather():
        return tuple(
            R.SpecCase(f"{lab}{'_sparse' if i % 2 else ''}", (
                R.fixture_rows((1 if i % 2 else k, b, n), 13 + i,
                               inf_frac=0.7 if i % 2 else 0.2, nan=i > 0),
                sl), {"sparse": True} if i % 2 else {})
            for i, (lab, b, n, sl, _) in enumerate(views()))

    def in_scan(i, b, n, sl):
        return (R.fixture_rows((b, n), 14 + i, inf_frac=0.6, nan=i > 0),
                *(R.fixture_rows((k, b, n), 15 + i + j, nan=i > 0,
                                 signed=i % 2 == 1) for j in range(3)),
                sl)

    def cases_relax_keys():
        return tuple(R.SpecCase(lab, in_scan(i, b, n, sl))
                     for i, (lab, b, n, sl, _) in enumerate(views()))

    def cases_relax_keys_push():
        return tuple(R.SpecCase(lab, in_scan(i, b, n, sl),
                                {"out_view": sl_out})
                     for i, (lab, b, n, sl, sl_out) in enumerate(views()))

    def cases_keys_dep():
        return tuple(
            R.SpecCase(lab, (R.fixture_rows((k, b, n), 18 + i, nan=i > 0),
                             R.fixture_rows((b, n), 19 + i),
                             R.fixture_rows((b, n), 20 + i, nan=i > 0),
                             sl_out), {"dep_idx": i % 2})
            for i, (lab, b, n, _, sl_out) in enumerate(views()))

    def cases_push():
        return tuple(
            R.SpecCase(lab, (R.fixture_rows((b, n), 21 + i, inf_frac=0.5,
                                            nan=i > 0), sl_out))
            for i, (lab, b, n, _, sl_out) in enumerate(views()))

    reg.register(R.KernelContract(
        name="ell_sliced_gather_min_batch", module=__name__,
        wrapper=ell_sliced_gather_min_batch, make_cases=cases_gather,
        kernels=gather,
        notes="#9: pack, one gather launch a group of buckets, merge"))
    reg.register(R.KernelContract(
        name="ell_sliced_relax_keys_batch", module=__name__,
        wrapper=ell_sliced_relax_keys_batch, make_cases=cases_relax_keys,
        kernels=gather + scan,
        notes="#10: the sliced fused in-scan (single-sweep relax, pipelined "
              "gate sweep)"))
    reg.register(R.KernelContract(
        name="ell_sliced_relax_keys_batch_push", module=__name__,
        wrapper=ell_sliced_relax_keys_batch,
        make_cases=cases_relax_keys_push, kernels=push + scan,
        notes="#10b: the sliced fused in-scan with the push as its relax "
              "sweep"))
    reg.register(R.KernelContract(
        name="ell_sliced_keys_dep_batch", module=__name__,
        wrapper=ell_sliced_keys_dep_batch, make_cases=cases_keys_dep,
        kernels=scan, notes="#11: the sliced fused out-scan"))
    reg.register(R.KernelContract(
        name="ell_sliced_push_relax_batch", module=__name__,
        wrapper=ell_sliced_push_relax_batch, make_cases=cases_push,
        kernels=push,
        notes="#9b: the relax pushed along a sliced outgoing view"))

    def cases_delta_push():
        return tuple(
            R.SpecCase(lab, (*R.fixture_delta_gates(b, n, 22 + i,
                                                    signed=i % 2 == 1),
                             sl_out, R.FIXTURE_DELTA))
            for i, (lab, b, n, _, sl_out) in enumerate(views()))

    reg.register(R.KernelContract(
        name="ell_sliced_delta_push_batch", module=__name__,
        wrapper=ell_sliced_delta_push_batch, make_cases=cases_delta_push,
        kernels=R.DELTA_PUSH,
        notes="#9c: delta's relax, both turns, pushed along a sliced "
              "outgoing view"))
