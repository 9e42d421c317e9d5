"""The phase-committing pair: the settle mark and the worklist push (CUDA
kernels, ``csrc/ell_push.cu``), with the phase's tail.

On every criterion plan that relaxes by the push (no in-side dynamic keys
and no oracle; the default ``instatic|outstatic`` among them), the
stepper's phase is #2 (the thresholds) and then three launches that commit
the phase in place:

  * :func:`ell_settle_mark_batch` computes the loop predicate and the
    plan's settle terms from #2's per-lane thresholds, writes status 2,
    appends the relax sources' out-rows to a worklist and counts the
    settled vertices and the relaxed out-edges (on a state with telemetry
    also the settled vertices each settle term claims first);
  * :func:`ell_settle_push_batch` (the padded out-view) or
    :func:`ell_sliced_settle_push_batch` (a sliced one) walks the worklist
    and lowers ``dist`` in place, setting status 0 -> 1 where a candidate
    lands;
  * :func:`ell_settle_tail_batch` folds the counters into the state's
    (``trips``, the budget, ``phases``, ``sum_fringe``, ``relax_edges``,
    the settled ring, and with telemetry the fringe, relax and attribution
    rings) and demotes a target lane's fringe in the phase its target
    settles.

Each is an in-place operation on a :class:`CommitBuffers`: the stepper's
chunk buffers, which a CUDA graph captures. A dead phase (its loop
predicate false) writes nothing. The source's note says what bounds the
pair on the card and how its design answers. :func:`settle_phase_batch` is
the pair as a function of its inputs (it copies what the phase writes),
the form the contracts, the tests and ``chip_smoke.py`` hold against the
plain twins.

Delta-stepping commits its phase the same way (:func:`commit_delta_phase`),
after its own threshold launch (``frontier_crit.delta_thresholds_batch``:
each lane's bucket, its fringe size and the witness of a light round):

  * :func:`ell_delta_settle_mark_batch` takes, on a lane's light round, its
    work set (the bucket's fringe vertices below their ``last_proc``),
    records ``last_proc := d`` and ``removed := 1`` there, and on its heavy
    turn settles the removed vertices (status 2) and resets both slots
    there, in the carried ``crit_keys`` stack in place; it appends each
    source to the worklist and counts the settled vertices, the light
    ones and the relaxed out-edges (light arcs of the light sources, heavy
    arcs of the heavy ones);
  * :func:`ell_delta_settle_push_batch` / :func:`ell_sliced_delta_settle_push_batch`
    is the worklist push with delta's weight gate: a lane on its light
    round pushes the arcs of weight ``<= delta``, one on its heavy turn the
    others;
  * :func:`ell_delta_settle_tail_batch` is the tail with delta's
    attribution triple (light, heavy, the lane's bucket id).

A tensor on the CPU runs the plain twins in ``kernels/ref.py``
(``settle_mark_ref``, ``settle_push_ref``, ``settle_tail_ref``: a mark
that returns the settle mask, the worklist and the counters, then a push
that commits; delta's ``delta_mark_ref`` and ``delta_settle_push_ref``);
a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.config import SETTLE_MAX_OUT, SETTLE_PAD, runs_twin
from repro_torch.kernels.ell_relax import push_library
from repro_torch.kernels.ell_relax_keys import on_stream

MAX_LANES = 65535  # the tail's grid takes a lane a row
MARK, PUSH, TAIL = 0, 1, 2  # settle_phase_launch's `which`
DELTA_TERMS = 3  # delta's attribution slots: light, heavy, bucket id

_POINTERS = ("d", "status", "mins", "n_fringe", "live0", "budget", "in_key",
             "target", "out_deg", "vrows", "go", "counts", "acc", "d_src",
             "work", "trips", "phases", "sum_fringe", "relax_edges", "ring",
             "fringe_ring", "relax_ring", "attr_ring", "keys", "deg_light",
             "deg_heavy", "n_cur")


class _SettleArgs(ctypes.Structure):
    """``SettleArgs`` of ``csrc/ell_push.cu``, field for field."""

    _fields_ = ([(nm, ctypes.c_void_p) for nm in _POINTERS]
                + [("n", ctypes.c_longlong), ("total_rows", ctypes.c_longlong)]
                + [(nm, ctypes.c_int) for nm in ("lanes", "nb", "k_out",
                                                  "zero", "stop",
                                                  "ring_len", "n_terms")]
                + [("delta", ctypes.c_float), ("delta_mode", ctypes.c_int)])


class CommitBuffers(NamedTuple):
    """The operands a committed phase reads and writes in place: the
    stepper state's buffers and the chunk loop's budget and ``live0``."""

    dist: torch.Tensor  # (B, n) f32, lowered in place
    status: torch.Tensor  # (B, n) int32, in place
    trips: torch.Tensor  # 0-dim int32, in place
    phases: torch.Tensor  # (B,) int32, in place
    sum_fringe: torch.Tensor  # (B,) int64, in place
    relax_edges: torch.Tensor  # (B,) int64, in place
    settled_trace: torch.Tensor  # (B, L) int32 ring, in place
    budget: torch.Tensor  # 0-dim int32: trips left in the call, in place
    live0: torch.Tensor  # (B,) bool: lanes live at the call's entry
    out_deg: torch.Tensor  # (n,) int32
    target: torch.Tensor | None  # (B,) int32 s->t targets (-1: none)
    # telemetry: all three or none, in place
    fringe_trace: torch.Tensor | None = None  # (B, L) int32 ring
    relax_trace: torch.Tensor | None = None  # (B, L) int32 ring
    attr_trace: torch.Tensor | None = None  # (B, L, T) int32 ring, T the
    #   plan's settle terms (SettleRule.n_terms; delta: DELTA_TERMS)
    crit_keys: torch.Tensor | None = None  # (2, B, n) f32: delta's carried
    #   last_proc and removed, in place (a delta phase only)


class SettleRule(NamedTuple):
    """A plan's settle terms over #2's thresholds ``mins`` (1 + K, B)."""

    zero: bool  # DIJK: d <= min_F d
    in_key: torch.Tensor | None  # (n,) in_min_static: INSTATIC's term
    stop: bool  # the loop's stop_on_lane_finish

    def n_terms(self, mins) -> int:
        """The plan's settle terms, in its order: d <= min_F d, the
        in_min_static term, then one an OUT lane of ``mins``."""
        return int(self.zero) + (self.in_key is not None) + mins.shape[0] - 1


class DeltaRule(NamedTuple):
    """Delta's operands of a committed phase (``DeltaPolicy.prepare``)."""

    delta: float  # the f32 bucket width, as a Python float of its bits
    deg_light: torch.Tensor  # (n,) int32 out-arcs of weight <= delta
    deg_heavy: torch.Tensor  # (n,) int32 the others
    stop: bool  # the loop's stop_on_lane_finish


class SettleWork(NamedTuple):
    """What the mark hands the push and the tail: on the card the launch
    operands (the scratch they point into), on the CPU the twin's
    :class:`~repro_torch.kernels.ref.SettleMark`."""

    args: object  # _SettleArgs, or None on the twin path
    table: object  # the host bucket table, or None
    nb: int  # buckets with rows
    scratch: dict | None  # keeps the scratch alive with the launch operands
    mark: ref.SettleMark | ref.DeltaMark | None  # the twin's decision
    delta: float = 0.0  # delta's f32 bucket width (the twin's push reads it)


# (device index, stream) -> scratch: the counters (zeroed once, left zeroed
# by every live phase's tail), the dense d_src and the worklist (never
# read where not written this phase). A capture takes its own
# (:func:`capture_scratch`).
_scratch: dict = {}


def scratch(dev, stream: int, lanes: int, n: int, n_counts: int,
            n_work: int) -> dict:
    """The pair's scratch on ``dev`` for ``stream``, grown to these sizes."""
    key = (dev.index, stream)
    sc = _scratch.get(key)
    if sc is None:
        sc = _scratch[key] = {
            "go": torch.zeros(1, dtype=torch.int32, device=dev),
            "counts": torch.zeros(0, dtype=torch.int32, device=dev),
            "acc": torch.zeros(0, dtype=torch.int32, device=dev),
            "d_src": torch.empty(0, dtype=torch.float32, device=dev),
            "work": torch.empty(0, dtype=torch.int32, device=dev)}
    for name, size, zero in (("counts", n_counts, True),
                             ("acc", lanes * SETTLE_PAD, True),
                             ("d_src", lanes * n, False),
                             ("work", 2 * n_work, False)):
        if sc[name].numel() < size:
            make = torch.zeros if zero else torch.empty
            sc[name] = make(size, dtype=sc[name].dtype, device=dev)
    return sc


@contextlib.contextmanager
def capture_scratch():
    """Inside the block, :func:`scratch` serves a table of its own, which
    the block yields (as ``frontier_crit.capture_scratch`` does for #2):
    the stepper wraps a CUDA graph capture in it and keeps the table with
    the graph. The counters' zeroing is captured too; every live phase
    leaves them 0 anyway."""
    global _scratch
    saved, _scratch = _scratch, {}
    try:
        yield _scratch
    finally:
        _scratch = saved


def _buckets(out_view):
    """``[(cols, ws, rows or None)]`` of the buckets with rows of an
    outgoing view: the padded pair is one bucket whose row r belongs to
    vertex r. Their order is the mark's bucket numbering."""
    if hasattr(out_view, "slices"):
        return [(s.cols, s.ws, s.rows) for s in out_view.slices
                if s.rows.shape[0]]
    return [(out_view[0], out_view[1], None)]


def _check_state(buf: CommitBuffers, extra: dict, n_terms: int):
    """The buffers' shapes, types and devices, ``extra`` (name -> (tensor
    or None, shape, dtype)) beside them, and the telemetry rings' depth
    ``n_terms``."""
    d = buf.dist
    if d.dim() != 2 or d.dtype != torch.float32:
        raise ValueError(f"want f32 dist (B, n); got {d.dtype} "
                         f"{tuple(d.shape)}")
    b, n = d.shape
    want = {"status": ((b, n), torch.int32), "trips": ((), torch.int32),
            "phases": ((b,), torch.int32), "sum_fringe": ((b,), torch.int64),
            "relax_edges": ((b,), torch.int64), "budget": ((), torch.int32),
            "live0": ((b,), torch.bool), "out_deg": ((n,), torch.int32),
            "target": ((b,), torch.int32),
            "crit_keys": ((2, b, n), torch.float32)}
    named = buf._asdict()
    for name, (t, shape, dtype) in extra.items():
        named[name] = t
        want[name] = (shape, dtype)
    optional = {"target", "crit_keys", *extra}
    for name, (shape, dtype) in want.items():
        t = named[name]
        if t is None and name in optional:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"want {name} {dtype} {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    ring = buf.settled_trace
    if ring.dim() != 2 or ring.shape[0] != b or ring.shape[1] < 1 or \
            ring.dtype != torch.int32:
        raise ValueError(f"want an int32 settled ring (B, L); got "
                         f"{ring.dtype} {tuple(ring.shape)}")
    rings = (buf.fringe_trace, buf.relax_trace, buf.attr_trace)
    if any(r is not None for r in rings):
        shapes = [tuple(ring.shape)] * 2 + [tuple(ring.shape) + (n_terms,)]
        if any(r is None or tuple(r.shape) != sh or r.dtype != torch.int32
               for r, sh in zip(rings, shapes)):
            got = [None if r is None else (r.dtype, tuple(r.shape))
                   for r in rings]
            raise ValueError(f"want the telemetry rings int32 {shapes}; "
                             f"got {got}")
    tensors = [t for t in (*buf, *(e[0] for e in extra.values()))
               if t is not None]
    if any(t.device != d.device for t in tensors):
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the phase's operands must be contiguous")
    if b > MAX_LANES:
        raise ValueError(f"{b} lanes; the pair takes at most {MAX_LANES}")


def _check(buf: CommitBuffers, mins, n_fringe, rule: SettleRule):
    b, n = buf.dist.shape
    if mins.dim() != 2 or mins.shape[1] != b or mins.dtype != torch.float32 \
            or not 1 <= mins.shape[0] <= 1 + SETTLE_MAX_OUT:
        raise ValueError(f"want f32 mins (1 + K, {b}), K <= "
                         f"{SETTLE_MAX_OUT}; got {mins.dtype} "
                         f"{tuple(mins.shape)}")
    if buf.crit_keys is not None:
        raise ValueError("a criterion plan's phase carries no delta keys")
    _check_state(buf, {
        "mins": (mins, tuple(mins.shape), torch.float32),
        "n_fringe": (n_fringe, (b,), torch.int32),
        "in_key": (rule.in_key, (n,), torch.float32)}, rule.n_terms(mins))


def _check_delta(buf: CommitBuffers, mins, counts, rule: DeltaRule):
    b, n = buf.dist.shape
    if buf.crit_keys is None:
        raise ValueError("a delta phase needs its (2, B, n) crit_keys")
    if not isinstance(rule.delta, float):
        raise TypeError(f"want the f32 delta as a Python float; got "
                        f"{type(rule.delta).__name__}")
    _check_state(buf, {
        "mins": (mins, (2, b), torch.float32),
        "counts": (counts, (2, b), torch.int32),
        "deg_light": (rule.deg_light, (n,), torch.int32),
        "deg_heavy": (rule.deg_heavy, (n,), torch.int32)}, DELTA_TERMS)


def _check_view(out_view, vrows, n: int, dev):
    buckets = _buckets(out_view)
    for cols, ws, rows in buckets:
        if cols.dim() != 2 or cols.shape != ws.shape or cols.shape[1] < 1 \
                or cols.dtype != torch.int32 or ws.dtype != torch.float32:
            raise ValueError("want int32 cols and f32 ws (rows, D >= 1)")
        if rows is None and cols.shape[0] != n:
            raise ValueError(f"the padded out-view needs one row per vertex: "
                             f"cols has {cols.shape[0]} rows for n = {n}")
        for t in (cols, ws) + (() if rows is None else (rows,)):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("the out-view must be contiguous on the "
                                 "phase's device")
    sliced = hasattr(out_view, "slices")
    if sliced and (vrows is None or tuple(vrows.shape) != (n, 4)
                   or vrows.dtype != torch.int32 or vrows.device != dev):
        raise ValueError("a sliced out-view needs its (n, 4) int32 vertex "
                         "row table (core.graph.vertex_row_table)")
    return buckets


def _mark_twin(buf: CommitBuffers, mins, n_fringe, rule: SettleRule):
    mark = ref.settle_mark_ref(
        buf.dist, buf.status, mins, n_fringe, buf.live0, buf.budget,
        zero=rule.zero, in_key=rule.in_key, stop=rule.stop,
        target=buf.target, out_deg=buf.out_deg,
        attr=buf.attr_trace is not None)
    buf.status.copy_(torch.where(mark.settle, 2, buf.status))
    return SettleWork(None, None, 0, None, mark)


def _delta_mark_twin(buf: CommitBuffers, mins, counts, rule: DeltaRule):
    mark = ref.delta_mark_ref(
        buf.dist, buf.status, buf.crit_keys, mins, counts, buf.live0,
        buf.budget, rule.delta, stop=rule.stop, deg_light=rule.deg_light,
        deg_heavy=rule.deg_heavy, attr=buf.attr_trace is not None)
    buf.status.copy_(torch.where(mark.heavy_from, 2, buf.status))
    buf.crit_keys[0].copy_(mark.last_proc)
    buf.crit_keys[1].copy_(mark.removed)
    return SettleWork(None, None, 0, None, mark, rule.delta)


def _push_twin(buf: CommitBuffers, work: SettleWork, out_view):
    mark = work.mark
    if isinstance(mark, ref.DeltaMark):
        d, status = ref.delta_settle_push_ref(
            buf.dist, buf.status, mark.light_src, mark.heavy_src, out_view,
            work.delta)
    else:
        d, status = ref.settle_push_ref(buf.dist, buf.status, mark.sources,
                                        out_view)
    buf.dist.copy_(d)
    buf.status.copy_(status)


def _tail_twin(buf: CommitBuffers, work: SettleWork, n_fringe):
    tail = ref.settle_tail_ref(
        buf.status, n_fringe, work.mark, buf.target, buf.trips, buf.phases,
        buf.sum_fringe, buf.relax_edges, buf.settled_trace, buf.budget,
        buf.fringe_trace, buf.relax_trace, buf.attr_trace)
    for name in tail._fields:
        if getattr(tail, name) is not None:
            getattr(buf, name).copy_(getattr(tail, name))


def _launch(name: str, which: int, work: SettleWork, dev):
    lib = push_library()
    rc = on_stream(dev, lambda stream: lib.settle_phase_launch(
        which, ctypes.byref(work.args), work.table, work.nb, stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch_mark(name: str, buf: CommitBuffers, out_view, vrows, ptrs: dict,
                 **scalars) -> SettleWork:
    """The mark's launch (the criterion's or delta's, by ``delta_mode`` in
    ``scalars``) over the scratch of its stream: ``ptrs`` the operands
    beside ``buf``'s, ``scalars`` the int fields beside the sizes."""
    b, n = buf.dist.shape
    dev = buf.dist.device
    buckets = _buckets(out_view)
    rows = [int(c.shape[0]) for c, _, _ in buckets]
    tiles = -(-b // 32)
    entries = []
    for cols, ws, owners in buckets:
        entries += [cols.data_ptr(), ws.data_ptr(),
                    0 if owners is None else owners.data_ptr(),
                    cols.shape[0], cols.shape[1]]
    table = (ctypes.c_longlong * max(len(entries), 1))(*entries)
    lib = push_library()
    held = {}

    def call(stream):
        sc = held["sc"] = scratch(dev, stream, b, n, tiles * len(buckets),
                                  tiles * sum(rows))
        ptr = {"d": buf.dist, "status": buf.status, "live0": buf.live0,
               "budget": buf.budget, "target": buf.target,
               "out_deg": buf.out_deg, "vrows": vrows, "trips": buf.trips,
               "phases": buf.phases, "sum_fringe": buf.sum_fringe,
               "relax_edges": buf.relax_edges, "ring": buf.settled_trace,
               "fringe_ring": buf.fringe_trace,
               "relax_ring": buf.relax_trace, "attr_ring": buf.attr_trace,
               "keys": buf.crit_keys, **ptrs, **sc}
        args = held["args"] = _SettleArgs(
            **{nm: (None if ptr.get(nm) is None else ptr[nm].data_ptr())
               for nm in _POINTERS},
            n=n, total_rows=sum(rows), lanes=b, nb=len(buckets),
            ring_len=buf.settled_trace.shape[1], **scalars)
        return lib.settle_phase_launch(MARK, ctypes.byref(args), table,
                                       len(buckets), stream)

    rc = on_stream(dev, call)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return SettleWork(held["args"], table, len(buckets), held["sc"], None,
                      float(scalars["delta"]))


def ell_settle_mark_batch(buf: CommitBuffers, mins: torch.Tensor,
                          n_fringe: torch.Tensor, rule: SettleRule, out_view,
                          vrows: torch.Tensor | None = None) -> SettleWork:
    """The settle mark of one phase, in place on ``buf``: writes status 2
    where the plan settles a fringe vertex under the loop predicate, and
    returns the worklist and counters the push and the tail read.

    ``mins`` (1 + K, B) f32 and ``n_fringe`` (B,) int32 are #2's output
    for the phase's entry state; ``rule`` the plan's terms; ``out_view``
    the padded ``(cols, ws)`` of ``to_ell_out`` or a sliced outgoing view
    (its buckets with rows number the lists), ``vrows`` the sliced view's
    :func:`~repro_torch.core.graph.vertex_row_table`.
    """
    _check(buf, mins, n_fringe, rule)
    _check_view(out_view, vrows, buf.dist.shape[1], buf.dist.device)
    if runs_twin(buf.dist):
        return _mark_twin(buf, mins, n_fringe, rule)
    work = _launch_mark(
        "ell_settle_mark_batch", buf, out_view, vrows,
        {"mins": mins, "n_fringe": n_fringe, "in_key": rule.in_key},
        k_out=mins.shape[0] - 1, zero=int(rule.zero), stop=int(rule.stop),
        n_terms=rule.n_terms(mins), delta=0.0, delta_mode=0)
    ell_settle_mark_batch.launches += 1
    return work


ell_settle_mark_batch.launches = 0  # kernel launches since the last reset


def ell_settle_push_batch(buf: CommitBuffers, work: SettleWork,
                          cols: torch.Tensor, ws: torch.Tensor) -> None:
    """The worklist push along the padded outgoing ELL ``(cols, ws)``
    (``to_ell_out``), in place on ``buf``: each relax source u of lane b
    (its entry distance) lowers ``dist[b, v]`` to ``d[b, u] + w`` over its
    out-edges (u, v, w), and status 0 turns 1 where such a candidate below
    +inf lands (``ref.settle_push_ref``). ``work`` is the mark's."""
    if runs_twin(buf.dist):
        _push_twin(buf, work, (cols, ws))
        return
    _launch("ell_settle_push_batch", PUSH, work, buf.dist.device)
    ell_settle_push_batch.launches += 1


ell_settle_push_batch.launches = 0  # kernel launches since the last reset


def ell_sliced_settle_push_batch(buf: CommitBuffers, work: SettleWork,
                                 sliced) -> None:
    """:func:`ell_settle_push_batch` along a sliced outgoing view
    (``to_ell_out_sliced`` or its buckets): a source's rows are found
    through the view's vertex row table, which the mark read. One launch a
    group of 16 buckets, counted once a call."""
    if runs_twin(buf.dist):
        _push_twin(buf, work, sliced)
        return
    _launch("ell_sliced_settle_push_batch", PUSH, work, buf.dist.device)
    ell_sliced_settle_push_batch.launches += 1


ell_sliced_settle_push_batch.launches = 0  # kernel launches since the last reset


def ell_settle_tail_batch(buf: CommitBuffers, work: SettleWork,
                          n_fringe: torch.Tensor) -> None:
    """The tail of a committed phase, in place on ``buf``: under the loop
    predicate, ``trips`` + 1 and the budget - 1; on each lane with a fringe
    at the phase's entry its settled count into the ring, ``phases`` + 1
    and ``sum_fringe`` + |F|; ``relax_edges`` + the relaxed out-edges; and
    on a target lane whose target settled, its fringe demoted to status 0.
    It leaves the mark's counters zeroed for the next phase."""
    if runs_twin(buf.dist):
        _tail_twin(buf, work, n_fringe)
        return
    _launch("ell_settle_tail_batch", TAIL, work, buf.dist.device)
    ell_settle_tail_batch.launches += 1


ell_settle_tail_batch.launches = 0  # kernel launches since the last reset


def commit_phase(buf: CommitBuffers, mins, n_fringe, rule: SettleRule,
                 out_view, vrows=None, *, use_kernels: bool = True) -> None:
    """One committed phase after #2: the mark, the push along ``out_view``
    and the tail, in place on ``buf``. ``use_kernels=False`` runs the plain
    twins on any device."""
    if not use_kernels:
        _check(buf, mins, n_fringe, rule)
        work = _mark_twin(buf, mins, n_fringe, rule)
        _push_twin(buf, work, out_view)
        _tail_twin(buf, work, n_fringe)
        return
    work = ell_settle_mark_batch(buf, mins, n_fringe, rule, out_view, vrows)
    if hasattr(out_view, "slices"):
        ell_sliced_settle_push_batch(buf, work, out_view)
    else:
        ell_settle_push_batch(buf, work, *out_view)
    ell_settle_tail_batch(buf, work, n_fringe)


def ell_delta_settle_mark_batch(buf: CommitBuffers, mins: torch.Tensor,
                                counts: torch.Tensor, rule: DeltaRule,
                                out_view, vrows: torch.Tensor | None = None
                                ) -> SettleWork:
    """Delta's mark of one phase, in place on ``buf`` (its ``crit_keys``
    included): from the threshold's ``mins`` / ``counts`` (2, B)
    (``frontier_crit.delta_thresholds_batch``) it takes each live lane's
    light round or heavy turn (``ref.delta_mark_ref``), writes status 2 at
    the settled, ``last_proc`` and ``removed`` where they change, and
    returns the worklist and counters the push and the tail read.
    ``out_view`` and ``vrows`` as for :func:`ell_settle_mark_batch`."""
    _check_delta(buf, mins, counts, rule)
    _check_view(out_view, vrows, buf.dist.shape[1], buf.dist.device)
    if runs_twin(buf.dist):
        return _delta_mark_twin(buf, mins, counts, rule)
    work = _launch_mark(
        "ell_delta_settle_mark_batch", buf, out_view, vrows,
        {"mins": mins, "n_fringe": counts[0], "n_cur": counts[1],
         "deg_light": rule.deg_light, "deg_heavy": rule.deg_heavy},
        k_out=1, zero=0, stop=int(rule.stop), n_terms=DELTA_TERMS,
        delta=rule.delta, delta_mode=1)
    ell_delta_settle_mark_batch.launches += 1
    return work


ell_delta_settle_mark_batch.launches = 0  # kernel launches since the last reset


def ell_delta_settle_push_batch(buf: CommitBuffers, work: SettleWork,
                                cols: torch.Tensor, ws: torch.Tensor) -> None:
    """Delta's worklist push along the padded outgoing ELL, in place on
    ``buf``: a source of a lane on its light round lowers ``dist`` over its
    arcs of weight ``<= delta``, one of a lane on its heavy turn over the
    others, each candidate the reference's ``d + w`` from the source's
    entry distance; status 0 turns 1 where a candidate below +inf lands
    (``ref.delta_settle_push_ref``). ``work`` is delta's mark's."""
    if runs_twin(buf.dist):
        _push_twin(buf, work, (cols, ws))
        return
    _launch("ell_delta_settle_push_batch", PUSH, work, buf.dist.device)
    ell_delta_settle_push_batch.launches += 1


ell_delta_settle_push_batch.launches = 0  # kernel launches since the last reset


def ell_sliced_delta_settle_push_batch(buf: CommitBuffers, work: SettleWork,
                                       sliced) -> None:
    """:func:`ell_delta_settle_push_batch` along a sliced outgoing view
    (delta's ``to_ell_out_buckets``): one launch a group of 16 buckets,
    counted once a call."""
    if runs_twin(buf.dist):
        _push_twin(buf, work, sliced)
        return
    _launch("ell_sliced_delta_settle_push_batch", PUSH, work,
            buf.dist.device)
    ell_sliced_delta_settle_push_batch.launches += 1


ell_sliced_delta_settle_push_batch.launches = 0  # kernel launches since the last reset


def ell_delta_settle_tail_batch(buf: CommitBuffers, work: SettleWork,
                                n_fringe: torch.Tensor) -> None:
    """Delta's tail: :func:`ell_settle_tail_batch` (the same kernel) with
    delta's attribution triple: the light vertices, the settled ones and
    the lane's bucket id, cast as the reference casts it (a NaN to 0, out
    of range to the range's end)."""
    if runs_twin(buf.dist):
        _tail_twin(buf, work, n_fringe)
        return
    _launch("ell_delta_settle_tail_batch", TAIL, work, buf.dist.device)
    ell_delta_settle_tail_batch.launches += 1


ell_delta_settle_tail_batch.launches = 0  # kernel launches since the last reset


def commit_delta_phase(buf: CommitBuffers, mins, counts, rule: DeltaRule,
                       out_view, vrows=None, *,
                       use_kernels: bool = True) -> None:
    """One committed delta phase after its threshold launch (``mins``,
    ``counts``): the mark, the push along ``out_view`` and the tail, in
    place on ``buf``. ``use_kernels=False`` runs the plain twins on any
    device."""
    if not use_kernels:
        _check_delta(buf, mins, counts, rule)
        work = _delta_mark_twin(buf, mins, counts, rule)
        _push_twin(buf, work, out_view)
        _tail_twin(buf, work, counts[0])
        return
    work = ell_delta_settle_mark_batch(buf, mins, counts, rule, out_view,
                                       vrows)
    if hasattr(out_view, "slices"):
        ell_sliced_delta_settle_push_batch(buf, work, out_view)
    else:
        ell_delta_settle_push_batch(buf, work, *out_view)
    ell_delta_settle_tail_batch(buf, work, counts[0])


class PhaseResult(NamedTuple):
    """The state fields one committed phase writes (:func:`settle_phase_batch`)."""

    dist: torch.Tensor
    status: torch.Tensor
    trips: torch.Tensor
    phases: torch.Tensor
    sum_fringe: torch.Tensor
    relax_edges: torch.Tensor
    settled_trace: torch.Tensor
    budget: torch.Tensor
    fringe_trace: torch.Tensor | None = None  # with telemetry
    relax_trace: torch.Tensor | None = None
    attr_trace: torch.Tensor | None = None
    crit_keys: torch.Tensor | None = None  # delta's carried stack


def _phase_buffers(d, status, live0, out_deg, target, budget: int,
                   ring_len: int, n_terms: int | None,
                   crit_keys=None) -> CommitBuffers:
    """Fresh buffers of one phase: copies of ``d``, ``status`` and
    ``crit_keys``, zero counters, a ``ring_len`` ring (with ``n_terms``,
    also the fringe, relax and attribution rings) and the budget."""
    b, _ = d.shape
    dev = d.device

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    rings = {}
    if n_terms is not None:
        rings = dict(fringe_trace=zeros((b, ring_len), torch.int32),
                     relax_trace=zeros((b, ring_len), torch.int32),
                     attr_trace=zeros((b, ring_len, n_terms), torch.int32))
    return CommitBuffers(
        dist=d.clone(), status=status.clone(), trips=zeros((), torch.int32),
        phases=zeros((b,), torch.int32), sum_fringe=zeros((b,), torch.int64),
        relax_edges=zeros((b,), torch.int64),
        settled_trace=zeros((b, ring_len), torch.int32),
        budget=torch.full((), budget, dtype=torch.int32, device=dev),
        live0=live0, out_deg=out_deg, target=target,
        crit_keys=None if crit_keys is None else crit_keys.clone(), **rings)


def settle_phase_batch(d, status, mins, n_fringe, live0, out_view, out_deg,
                       in_key=None, *, zero: bool = True, stop: bool = False,
                       target=None, vrows=None, budget: int = 1,
                       ring_len: int = 3, telemetry: bool = False,
                       use_kernels: bool = True) -> PhaseResult:
    """One committed phase as a function of its inputs: copies of ``d`` and
    ``status``, zero counters, a ``ring_len`` ring (with ``telemetry`` also
    the fringe, relax and attribution rings) and the given ``budget``,
    through :func:`commit_phase` (the three kernels on the card, the twins
    on the CPU or with ``use_kernels=False``); returns what the phase
    wrote."""
    rule = SettleRule(zero, in_key, stop)
    buf = _phase_buffers(d, status, live0, out_deg, target, budget, ring_len,
                         rule.n_terms(mins) if telemetry else None)
    commit_phase(buf, mins, n_fringe, rule, out_view, vrows,
                 use_kernels=use_kernels)
    return PhaseResult(*(getattr(buf, nm) for nm in PhaseResult._fields))


def delta_phase_batch(d, status, crit_keys, live0, out_view, out_deg,
                      deg_light, deg_heavy, delta: float, *,
                      stop: bool = False, target=None, vrows=None,
                      budget: int = 1, ring_len: int = 3,
                      telemetry: bool = False,
                      use_kernels: bool = True) -> PhaseResult:
    """One committed delta phase as a function of its inputs: delta's
    threshold launch on ``d``, ``status`` and ``crit_keys[0]``, then
    :func:`commit_delta_phase` on fresh buffers (:func:`settle_phase_batch`'s,
    with a copy of the carried ``crit_keys`` (2, B, n)); the four kernels on
    the card, the twins on the CPU or with ``use_kernels=False``. Returns
    what the phase wrote, ``crit_keys`` included."""
    from repro_torch.kernels.frontier_crit import delta_thresholds_batch

    buf = _phase_buffers(d, status, live0, out_deg, target, budget, ring_len,
                         DELTA_TERMS if telemetry else None, crit_keys)
    if use_kernels:
        mins, counts = delta_thresholds_batch(d, status, crit_keys[0], delta)
    else:
        mins, counts = ref.delta_thresholds_ref(d, status, crit_keys[0],
                                                delta)
    commit_delta_phase(buf, mins, counts,
                       DeltaRule(float(delta), deg_light, deg_heavy, stop),
                       out_view, vrows, use_kernels=use_kernels)
    return PhaseResult(*(getattr(buf, nm) for nm in PhaseResult._fields))


def register_kernels(reg):
    """Register this module's kernel contracts (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    pair = ((R.SRC_PUSH, "settle_mark_kernel"),
            (R.SRC_PUSH, "settle_push_kernel"),
            (R.SRC_PUSH, "settle_tail_kernel"))

    def cases(sliced: bool):
        out = []
        for i, (b, n) in enumerate(((R.FIXTURE_B, R.FIXTURE_N),)
                                   + R.WIDE_SHAPES):
            out.append(R.SpecCase(
                f"b{b}_n{n}" if i else "ref",
                *R.fixture_settle(b, n, 200 + i, sliced=sliced,
                                  signed=bool(i % 2), target=i % 2 == 0,
                                  stop=i == 3, telemetry=i % 3 == 1)))
        return tuple(out)

    for name, sliced, notes in (
            ("ell_settle_commit_batch", False,
             "#1b redesigned: the settle mark, the worklist push along the "
             "padded out-ELL and the tail, committing the phase in place"),
            ("ell_sliced_settle_commit_batch", True,
             "#9b redesigned: the pair along a sliced out-view")):
        reg.register(R.KernelContract(
            name=name, module=__name__, wrapper=settle_phase_batch,
            make_cases=lambda s=sliced: cases(s), kernels=pair,
            counter_outputs=(2, 3, 4, 5, 6), notes=notes))

    delta_pair = ((R.SRC_CRIT, "delta_crit_kernel"),
                  (R.SRC_PUSH, "delta_settle_mark_kernel"),
                  (R.SRC_PUSH, "delta_settle_push_kernel"),
                  (R.SRC_PUSH, "settle_tail_kernel"))

    def delta_cases(sliced: bool):
        out = []
        for i, (b, n) in enumerate(((R.FIXTURE_B, R.FIXTURE_N),)
                                   + R.WIDE_SHAPES):
            out.append(R.SpecCase(
                f"b{b}_n{n}" if i else "ref",
                *R.fixture_delta(b, n, 300 + i, sliced=sliced,
                                 signed=bool(i % 2), target=i % 2 == 0,
                                 stop=i == 3, telemetry=i % 3 == 1)))
        return tuple(out)

    for name, sliced, notes in (
            ("ell_delta_commit_batch", False,
             "#5c / #9c redesigned on delta's path: the threshold, the "
             "mark, the worklist push with delta's weight gate along the "
             "padded out-ELL and the tail, committing the phase in place"),
            ("ell_sliced_delta_commit_batch", True,
             "the same along the sliced out-view's buckets")):
        reg.register(R.KernelContract(
            name=name, module=__name__, wrapper=delta_phase_batch,
            make_cases=lambda s=sliced: delta_cases(s), kernels=delta_pair,
            counter_outputs=(2, 3, 4, 5, 6), notes=notes))
