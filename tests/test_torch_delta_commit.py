"""Delta-stepping's committed phase against the reference, bit for bit.

The port's delta policy commits each phase through its threshold, its mark,
the worklist push with delta's weight gate and the tail
(``ops.delta_thresholds``, ``ops.commit_delta_phase``); on the CPU
``step_batch`` runs their twins (``ref.delta_thresholds_ref``,
``delta_mark_ref``, ``delta_settle_push_ref``, ``settle_tail_ref``). Each
case steps both packages from one seeded state through the same calls, the
reference with its plain twins (``use_pallas=False``), and compares every
state field after each call (``dist``, ``status``, ``crit_keys``, the
counters and every ring), bit for bit: on both layouts (a sliced out-view
of more than 64 buckets among them), at 0.5, 1 and 4 times
``default_delta``, with target lanes under ``stop_on_lane_finish`` and an
idle lane, with NaN fault rows, with telemetry, on calls of k not a
multiple of the chunk (dead phases), and at a bucket width whose f32
multiples fall on bucket edges. The invariant the mark's partial reset
relies on is checked on every phase of such runs, and each twin is held
against the parent's phase body (``DeltaPolicy.gates``, the push of
``ops.delta_push_relax_batch`` and the PyTorch passes around it) on real
phases.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_stepping as JD
from repro.core import from_coo as j_from_coo
from repro.core import graph as JGr
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro_torch.core import delta_stepping as TD
from repro_torch.core import from_coo as t_from_coo
from repro_torch.core import graph as TGr
from repro_torch.core import policies as TP
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels import registry as R
from repro_torch.kernels import settle_push as SP
from test_torch_chunk_loop import assert_states_equal

torch.set_num_threads(1)

J = TS.PHASES_PER_REPLAY
E = TS.EMPTY_LANE
INF = float("inf")

# name -> (layout, delta scale of default_delta, init kwargs, sources,
#          stop_on_lane_finish, NaN fault slots (lane, vertex) or ())
CASES = {
    "padded": ("padded", 1.0, {}, [0, 7, 90, 3], False, ()),
    "sliced": ("sliced", 1.0, {}, [5, 1, 170, 44], False, ()),
    "half_padded": ("padded", 0.5, {}, [2, 60, 130], False, ()),
    "half_sliced": ("sliced", 0.5, {"trace_len": 7}, [9, 100], False, ()),
    "x4_padded": ("padded", 4.0, {}, [11, 140, 33], False, ()),
    "x4_sliced": ("sliced", 4.0, {}, [4, 88, 177], False, ()),
    "targets_stop_idle": ("padded", 1.0, {"targets": [60, E, 12, E]},
                          [0, 5, E, 99], True, ()),
    "targets_sliced_x4": ("sliced", 4.0, {"targets": [100, E, 3],
                                          "trace_len": 4},
                          [7, 61, 20], False, ()),
    "stop_padded": ("padded", 0.5, {"trace_len": 3}, [0, 17, 140, E],
                    True, ()),
    "nan_padded": ("padded", 1.0, {}, [0, 50, 100], False,
                   ((1, 170), (2, 3), (2, 177))),
    "nan_sliced_targets": ("sliced", 4.0, {"targets": [E, 44, 120]},
                           [9, 30, 150], False, ((0, 160), (2, 11))),
    "telemetry_padded": ("padded", 1.0, {"telemetry": True, "trace_len": 5},
                         [0, 7, E, 90], False, ()),
    "telemetry_sliced_half": ("sliced", 0.5, {"telemetry": True},
                              [3, 60, 111], False, ()),
    # a NaN lane's bucket id in the attribution ring: the cast of a NaN
    "telemetry_nan_targets_stop": ("padded", 4.0,
                                   {"telemetry": True, "trace_len": 3,
                                    "targets": [70, E, 15]},
                                   [2, 19, 150], True, ((1, 40),)),
}
CALLS = (J + 3, 5, 4 * 180 + 16, 4 * 180 + 16, J)  # k of each call


def _graphs(seed=3, n=180, p=0.03):
    return (JGen.uniform_gnp(n, p, seed=seed),
            TGen.uniform_gnp(n, p, seed=seed, device="cpu"))


def _pair(case, gj, gt):
    layout, scale, kw, sources, stop, faults = CASES[case]
    delta = scale * JD.default_delta(gj)
    assert delta == scale * TD.default_delta(gt)
    sj = JS.init_batch_state(gj, sources, criterion="delta", delta=delta,
                             **kw)
    st = TS.init_batch_state(gt, sources, criterion="delta", delta=delta,
                             device="cpu", **kw)
    if faults:
        # NaN in unexplored slots: a relax that lands there makes them
        # fringe with a NaN distance, the lane's bucket id NaN, and the lane
        # then drains its removed vertices and settles nothing more
        d = np.asarray(sj.dist).copy()
        for lane, v in faults:
            d[lane, v] = np.nan
        sj = dataclasses.replace(sj, dist=jnp.asarray(d))
        st = dataclasses.replace(st, dist=torch.from_numpy(d))
    step_kw = {"stop_on_lane_finish": stop}
    if layout == "sliced":
        step_kw["ell_out"] = TGr.to_ell_out_buckets(gt)
    return sj, st, step_kw


def check_invariants(st):
    """What delta's mark relies on, on a state the stepper made:
    ``last_proc != inf => removed => status 1``, so a heavy turn that
    resets the removed slots resets the lane, and a lane without fringe
    has nothing to reset."""
    last, removed = st.crit_keys[0], st.crit_keys[1] > 0.5
    assert bool(((last != INF) <= removed).all())
    assert bool((removed <= (st.status == 1)).all())
    assert bool(((st.crit_keys[1] == 0) | (st.crit_keys[1] == 1)).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_committed_delta_phase_steps_as_the_reference(case):
    """Calls of J + 3 and 5 phases, then to the end (the chunk runs dead
    phases past it), then again on the finished state: every field after
    each call, bit for bit."""
    gj, gt = _graphs()
    sj, st, step_kw = _pair(case, gj, gt)
    stop = step_kw["stop_on_lane_finish"]
    for k in CALLS:
        sj = JS.step_batch(gj, sj, k, use_pallas=False,
                           stop_on_lane_finish=stop)
        st = TS.step_batch(gt, st, k, **step_kw)
        assert_states_equal(sj, st)
        check_invariants(st)


def test_a_delta_phase_is_the_commit_and_nothing_else(monkeypatch):
    """One commit a phase, the threshold before it; the parent's relax and
    #2 never run on a delta phase."""
    _, gt = _graphs(seed=4)
    calls = []
    real = tops.commit_delta_phase

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("a delta phase ran the parent's relax or #2")

    monkeypatch.setattr(tops, "commit_delta_phase", counted)
    for name in ("delta_push_relax_batch", "crit_thresholds_batch",
                 "delta_relax_batch"):
        monkeypatch.setattr(tops, name, refused)
    for telemetry in (True, False):
        calls.clear()
        st = TS.init_batch_state(gt, [0, 9], criterion="delta", device="cpu",
                                 telemetry=telemetry, trace_len=4)
        out = TS.step_batch(gt, st, 3)
        assert len(calls) == J and int(out.trips) == 3


def _many_degrees_graph(n=200, widths=90, seed=6):
    """Vertex v has out-degree v % widths + 1 to distinct other vertices,
    so an out-view sliced at every width 1..widths has a bucket with rows
    for each."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(n):
        to = rng.choice(n - 1, v % widths + 1, replace=False)
        src += [v] * len(to)
        dst += list(to + (to >= v))
    w = rng.uniform(0.0, 1.0, len(src)).astype(np.float32)
    return np.array(src, np.int32), np.array(dst, np.int32), w


@pytest.mark.parametrize("telemetry", [False, True])
def test_delta_steps_over_more_buckets_than_the_mark_aggregates(telemetry):
    """``step_batch(..., ell_out=)`` on the buckets of an out-view sliced at
    every width 1..90 (the mark aggregates the appends of at most 64 in
    shared memory, and appends straight to the list counts beyond; the push
    runs in six groups of 16): every field after each call, bit for bit."""
    src, dst, w = _many_degrees_graph()
    n = 200
    gj = JGr.from_coo(src, dst, w, n)
    gt = TGr.from_coo(src, dst, w, n, device="cpu")
    view = TGr.to_ell_out_buckets(gt, pad_multiple=1,
                                  boundaries=tuple(range(1, 91)))
    assert sum(1 for s in view.slices if s.rows.shape[0]) == 90
    kw = {"telemetry": telemetry, "trace_len": 4} if telemetry else {}
    sources = [0, 45, 130, 199]
    sj = JS.init_batch_state(gj, sources, criterion="delta", **kw)
    st = TS.init_batch_state(gt, sources, criterion="delta", device="cpu",
                             **kw)
    for k in (J + 1, 5, 4 * n):
        sj = JS.step_batch(gj, sj, k, use_pallas=False)
        st = TS.step_batch(gt, st, k, ell_out=view)
        assert_states_equal(sj, st)


def _tenth_grid(seed=0, n=80, m=700):
    """Weights on multiples of 0.1 (and -0), which f32 holds inexactly: with
    delta = 0.1, d / delta falls on integer bucket edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = (rng.integers(0, 12, m) * np.float32(0.1)).astype(np.float32)
    w[rng.random(m) < 0.05] = -0.0
    return (j_from_coo(src, dst, w, n),
            t_from_coo(src, dst, w, n, device="cpu"))


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_a_bucket_edge_delta_steps_as_the_reference(layout):
    """At delta = 0.1 on weights of multiples of 0.1 distances sit on
    bucket edges (d / delta an integer), and t = fl(13 delta) at delta =
    0.00999875205575592 has t / delta = 12.99999 in f32, so bucket 12: the
    threshold, the mark and the reference take the same f32 divide and
    floor there, bit for bit."""
    step_kw = (lambda g: {"ell_out": TGr.to_ell_out_buckets(g)}
               if layout == "sliced" else {})
    gj, gt = _tenth_grid(seed=2)
    kw = dict(criterion="delta", delta=0.1, telemetry=True, trace_len=6)
    sj = JS.init_batch_state(gj, [0, 9, 40, 77], **kw)
    st = TS.init_batch_state(gt, [0, 9, 40, 77], device="cpu", **kw)
    for k in (J - 1, J + 2, 4 * gt.n + 16):
        sj = JS.step_batch(gj, sj, k, use_pallas=False)
        st = TS.step_batch(gt, st, k, **step_kw(gt))
        assert_states_equal(sj, st)
        check_invariants(st)
    q = st.dist[torch.isfinite(st.dist)] / torch.tensor(0.1)
    assert int((q == torch.floor(q)).sum()) > 3
    delta = 0.00999875205575592
    t = np.float32(13) * np.float32(delta)
    assert np.floor(t / np.float32(delta)) == 12
    args = ([0, 0, 1], [1, 2, 2], [t, np.float32(0.5), np.float32(0.0)], 3)
    gj, gt = j_from_coo(*args), t_from_coo(*args, device="cpu")
    kw = dict(criterion="delta", delta=delta, telemetry=True, trace_len=8)
    sj = JS.init_batch_state(gj, [0, 1], **kw)
    st = TS.init_batch_state(gt, [0, 1], device="cpu", **kw)
    for k in (1, 2, 3, 40):
        sj = JS.step_batch(gj, sj, k, use_pallas=False)
        st = TS.step_batch(gt, st, k, **step_kw(gt))
        assert_states_equal(sj, st)
        check_invariants(st)
    assert st.status.tolist() == [[2, 2, 2], [0, 2, 2]]


def test_the_invariant_holds_through_admission_demotion_and_dead_phases():
    """One phase a call over whole solves, with lanes refilled on the way
    (admission), target lanes demoted the phase their target settles, a
    NaN fault row, and calls past the loop's end: after every call the
    mark's invariant holds, and the state equals the reference's."""
    gj, gt = _graphs(seed=8, n=120, p=0.05)
    srcs = [0, 30, E, 90]
    kw = dict(criterion="delta", targets=[50, E, E, 7], trace_len=3)
    sj = JS.init_batch_state(gj, srcs, **kw)
    st = TS.init_batch_state(gt, srcs, device="cpu", **kw)
    d = np.asarray(sj.dist).copy()
    d[1, 77] = np.nan
    sj = dataclasses.replace(sj, dist=jnp.asarray(d))
    st = dataclasses.replace(st, dist=torch.from_numpy(d))
    refill = {12: ([-2, -2, 5, -2], [-1, -1, 100, -1]),
              30: ([60, -2, -2, 3], [-1, -1, -1, 110])}
    for call in range(70):
        if call in refill:
            s_new, t_new = refill[call]
            sj = JS.reset_lanes(sj, np.array(s_new, np.int32),
                                targets=np.array(t_new, np.int32))
            st = TS.reset_lanes(st, np.array(s_new, np.int32),
                                targets=np.array(t_new, np.int32))
        sj = JS.step_batch(gj, sj, 1 if call % 5 else 3, use_pallas=False)
        st = TS.step_batch(gt, st, 1 if call % 5 else 3)
        assert_states_equal(sj, st)
        check_invariants(st)


# ---------------------------------------------------------------------------
# the twins against the parent's phase body
# ---------------------------------------------------------------------------


def parent_phase(s, aux):
    """The parent's delta phase on state ``s`` under a true loop predicate:
    ``DeltaPolicy.gates`` (the bucket ids and #2 on them), the push
    ``ops.delta_push_relax_batch`` and the PyTorch passes around it.
    Returns (dist, status, crit_keys, n_fringe, n_settled, relax_inc, (light,
    heavy, bucket id))."""
    ell_out, delta, deg_light, deg_heavy, _ = aux
    d, status = s.dist, s.status
    last_proc, removed = s.crit_keys[0], s.crit_keys[1] > 0.5
    _, b_lane, n_f, cur, heavy_turn, heavy_from = TP.DeltaPolicy.gates(
        s, use_kernels=False)
    upd = tops.delta_push_relax_batch(d, cur, heavy_from, ell_out, delta,
                                      use_kernels=False)
    new_d = torch.minimum(d, upd)
    new_status = torch.where(
        heavy_from, 2, torch.where((status == 0) & (upd < INF), 1, status)
    ).to(torch.int32)
    new_last = torch.where(heavy_turn[:, None], INF,
                           torch.where(cur, d, last_proc))
    new_removed = ~heavy_turn[:, None] & (removed | cur)
    n_settled = heavy_from.sum(dim=1, dtype=torch.int32)
    relax_inc = (torch.where(cur, deg_light[None], 0).sum(
        dim=1, dtype=torch.int64)
        + torch.where(heavy_from, deg_heavy[None], 0).sum(
            dim=1, dtype=torch.int64))
    bucket = torch.where(n_f > 0, b_lane, 0.0)
    attr = (cur.sum(dim=1, dtype=torch.int32), n_settled, bucket)
    return (new_d, new_status,
            torch.stack([new_last, new_removed.to(torch.float32)]), n_f,
            n_settled, relax_inc, attr)


def _bits(x):
    """The bits of an f32 tensor, every NaN as one value (the parent's
    ``torch.minimum`` gives the CPU's NaN, the commit keeps the entry's)."""
    if x.dtype != torch.float32:
        return x
    return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)


def _phase_states(layout, scale, sources, faults=()):
    """Entry states of real phases of one solve, and its prepare's aux."""
    _, gt = _graphs(seed=5)
    delta = scale * TD.default_delta(gt)
    st = TS.init_batch_state(gt, sources, criterion="delta", delta=delta,
                             device="cpu", telemetry=True, trace_len=4)
    if faults:
        d = st.dist.clone()
        for lane, v in faults:
            d[lane, v] = float("nan")
        st = dataclasses.replace(st, dist=d)
    pol = TP.policy_for("delta")
    out = pol.out_view(gt, layout == "sliced")
    aux = pol.prepare(gt, None, out, st, False)
    states = []
    for k in (0, 1, 2, 3, 5, 8, 13, 21, 34):
        s = TS.step_batch(gt, st, k) if k else st
        if bool((s.status == 1).any()):
            states.append(s)
    return gt, aux, states


@pytest.mark.parametrize("layout,scale,faults", [
    ("padded", 1.0, ()), ("sliced", 0.5, ()), ("padded", 4.0, ((1, 77),)),
    ("sliced", 1.0, ((0, 12),))])
def test_each_twin_is_the_parents_phase(layout, scale, faults):
    """On real phases: the threshold twin gives the parent's bucket, |F|
    and light rounds; the mark twin its work set, heavy sources, carried
    stack (on lanes with a fringe) and counters; the push twin its dist and
    status; and the committed phase (``delta_phase_batch``'s twins) its
    every field, the rings' slot included."""
    gt, aux, states = _phase_states(layout, scale, [0, 7, 90, E], faults)
    ell_out, delta, deg_light, deg_heavy, vrows = aux
    assert len(states) >= 4
    one = torch.ones((), dtype=torch.int32)
    for s in states:
        want = parent_phase(s, aux)
        gates = TP.DeltaPolicy.gates(s, use_kernels=False)
        mins, counts = ref.delta_thresholds_ref(s.dist, s.status,
                                                s.crit_keys[0], delta)
        assert torch.equal(_bits(mins[0]), _bits(gates.bucket))
        assert torch.equal(counts[0], gates.n_fringe)
        assert torch.equal(ref.delta_light_lanes(mins, counts),
                           gates.cur.any(dim=1))
        live0 = counts[0] > 0
        mark = ref.delta_mark_ref(
            s.dist, s.status, s.crit_keys, mins, counts, live0, one, delta,
            stop=False, deg_light=deg_light, deg_heavy=deg_heavy, attr=True)
        assert bool(mark.go)
        assert torch.equal(mark.cur, gates.cur)
        assert torch.equal(mark.heavy_from, gates.heavy_from)
        assert torch.equal(mark.n_settled, want[4])
        assert torch.equal(mark.relax_inc, want[5])
        lanes = live0[:, None]
        assert torch.equal(_bits(torch.where(lanes, mark.last_proc, 0.0)),
                           _bits(torch.where(lanes, want[2][0], 0.0)))
        assert torch.equal(torch.where(lanes, mark.removed, 0.0),
                           torch.where(lanes, want[2][1], 0.0))
        st2 = torch.where(mark.heavy_from, 2, s.status).to(torch.int32)
        d2, status2 = ref.delta_settle_push_ref(
            s.dist, st2, mark.light_src, mark.heavy_src, ell_out, delta)
        assert torch.equal(_bits(d2), _bits(want[0]))
        assert torch.equal(status2, want[1])
        got = SP.delta_phase_batch(
            s.dist, s.status, s.crit_keys, live0, ell_out, s.out_deg,
            deg_light, deg_heavy, delta, vrows=vrows, telemetry=True,
            ring_len=4)
        assert torch.equal(_bits(got.dist), _bits(want[0]))
        assert torch.equal(got.status, want[1])
        assert torch.equal(_bits(got.crit_keys), _bits(want[2]))
        assert torch.equal(got.settled_trace[:, 0],
                           torch.where(live0, want[4], 0))
        assert torch.equal(got.relax_edges, want[5])
        assert torch.equal(got.sum_fringe, torch.where(
            live0, want[3], 0).to(torch.int64))
        light, heavy, bucket = want[6]
        attr = torch.stack([light, heavy, ref.f32_to_int32(bucket)], dim=1)
        assert torch.equal(got.attr_trace[:, 0],
                           torch.where(live0[:, None], attr, 0))
        assert int(got.trips) == 1 and int(got.budget) == 0


def test_a_dead_delta_phase_writes_nothing():
    """No budget: the committed phase keeps every field of its entry."""
    _, aux, states = _phase_states("padded", 1.0, [0, 7, 90, E])
    ell_out, delta, deg_light, deg_heavy, _ = aux
    s = states[2]
    live0 = (s.status == 1).any(dim=1)
    got = SP.delta_phase_batch(
        s.dist, s.status, s.crit_keys, live0, ell_out, s.out_deg, deg_light,
        deg_heavy, delta, budget=0, telemetry=True)
    assert torch.equal(_bits(got.dist), _bits(s.dist))
    assert torch.equal(got.status, s.status)
    assert torch.equal(_bits(got.crit_keys), _bits(s.crit_keys))
    assert int(got.trips) == 0 and int(got.budget) == 0
    assert not bool(got.settled_trace.any() or got.attr_trace.any())


def test_the_threshold_twin_on_edge_cases():
    """The witness of a light round: an empty W beside an attained +inf
    bucket id (a d / delta that overflows), a NaN bucket (no light round),
    -0 and +0 ids, and W's least id above the lane's bucket."""
    big = float(np.finfo(np.float32).max)
    d = torch.tensor([[big, big, INF, 1.0],
                      [big, 2.0, 0.5, 3.0],
                      [float("nan"), 0.2, 0.2, 5.0],
                      [-0.0, 0.0, 0.7, 2.0],
                      [0.1, 0.9, 2.5, 2.6]])
    status = torch.tensor([[1, 1, 0, 0], [1, 0, 2, 0], [1, 1, 1, 0],
                           [1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.int32)
    last = torch.tensor([[big, INF, INF, INF],
                         [INF, INF, INF, INF],
                         [INF, INF, 0.2, INF],
                         [-0.0, INF, INF, INF],
                         [0.1, 0.9, INF, INF]])
    mins, counts = ref.delta_thresholds_ref(d, status, last, 1e-38)
    # lane 0: both ids +inf, W = {1}: a light round on the +inf bucket
    assert mins[0, 0] == INF and counts[1, 0] == 1
    # lane 1: W = {0} at +inf; lane 2: the NaN bucket; lane 3: -0 and +0
    light = ref.delta_light_lanes(mins, counts).tolist()
    assert light[:2] == [True, True] and not light[2]
    assert bool(torch.isnan(mins[0, 2]))
    mins, counts = ref.delta_thresholds_ref(d, status, last, 0.5)
    assert mins[0, 3] == 0 and bool(torch.signbit(mins[0, 3]))
    assert ref.delta_light_lanes(mins, counts).tolist()[3]
    # lane 4: the bucket 0's one vertex is at its last_proc, and W's least
    # id is 5: the heavy turn
    assert mins.tolist()[0][4] == 0.0 and mins.tolist()[1][4] == 5.0
    assert not ref.delta_light_lanes(mins, counts).tolist()[4]
    # an empty W against an attained +inf bucket: no light round
    mins, counts = ref.delta_thresholds_ref(d[:1], status[:1],
                                            torch.tensor([[big, big, 0, 0]]),
                                            1e-38)
    assert mins[0, 0] == INF and mins[1, 0] == INF and counts[1, 0] == 0
    assert not ref.delta_light_lanes(mins, counts).tolist()[0]


def test_the_bucket_id_casts_as_the_reference_casts():
    """``f32_to_int32``: toward zero, a NaN to 0, beyond the range to its
    end, as XLA's convert (and the card's) gives it."""
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, -2.5, -0.0,
                  2.0 ** 31, -2.0 ** 31], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = ref.f32_to_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_wrappers_check_their_inputs():
    args, _ = R.fixture_delta()
    d, status, keys = args[:3]
    with pytest.raises(TypeError, match="Python float"):
        tops.delta_thresholds_batch(d, status, keys[0].contiguous(),
                                    np.float32(0.5))
    with pytest.raises(ValueError, match="last_proc"):
        tops.delta_thresholds_batch(d, status, keys[0, :, :-1], 0.5)
    with pytest.raises(ValueError, match="crit_keys"):
        SP.delta_phase_batch(d, status, keys[:1], *args[3:])
