"""The port's dynamic-key plans against the JAX reference, bit for bit.

Every non-oracle plan with dynamic keys (the paper's strengthened ``in|out``
criterion among them) runs through the port's stepper and the reference's
on the same seeded graphs, sources and chunk schedules. Compared: every
``BatchedResult`` field and, where a state is at hand, the carried key
stack ``crit_keys`` and its ``keys_valid`` flag. The reference runs its
``use_pallas=False`` twins (bit-identical by its ops rule) and, in one
case, its Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.serving.backends import StaticBackend as JBackend
from repro_torch import interop
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.serving import StaticBackend

torch.set_num_threads(1)

GRAPHS = {
    "gnp": ("uniform_gnp", (160, 0.04)),
    "kronecker": ("kronecker", (7,)),
    "grid_road": ("grid_road", (10, 12)),
    "webgraph": ("webgraph", (180,)),
}
DYNAMIC_PLANS = ["in|out", "insimple|outsimple", "in", "out", "outweak",
                 "outstatic|outsimple", "in|out|instatic|outstatic"]
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase")


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def assert_results_equal(want, got):
    for f in RESULT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            assert_bits(w, g)


def assert_states_equal(sj, st):
    """Harvested fields plus the carried keys and their flag."""
    assert_results_equal(JS.harvest(sj), TS.harvest(st))
    if sj.crit_keys is None:
        assert st.crit_keys is None
    else:
        assert_bits(sj.crit_keys, st.crit_keys)
    if sj.keys_valid is None:
        assert st.keys_valid is None
    else:
        assert bool(sj.keys_valid) is st.keys_valid


def _graphs(name, seed=1):
    fn, args = GRAPHS[name]
    return (getattr(JGen, fn)(*args, seed=seed),
            getattr(TGen, fn)(*args, seed=seed, device="cpu"))


def _state_fields(st):
    """A reference BatchState as the numpy dict interop reads."""
    return {f.name: (st.criterion if f.name == "criterion"
                     else None if getattr(st, f.name) is None
                     else np.asarray(getattr(st, f.name)))
            for f in dataclasses.fields(st)}


@pytest.mark.parametrize("criterion", DYNAMIC_PLANS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dynamic_plans_match_reference(graph, criterion):
    gj, gt = _graphs(graph)
    sources = np.array([0, 7, gt.n - 1, 3])
    want = JS.run_phased_static_batch(gj, sources, use_pallas=False,
                                      criterion=criterion, trace_len=8)
    got = TS.run_phased_static_batch(gt, sources, criterion=criterion,
                                     trace_len=8, device="cpu")
    assert_results_equal(want, got)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_in_out_states_match_reference_phase_by_phase(use_kernels):
    """The carried keys after every trip, not only the final distances."""
    gj, gt = _graphs("webgraph", seed=3)
    sj = JS.init_batch_state(gj, [0, 9, JS.EMPTY_LANE], criterion="in|out",
                             trace_len=4)
    st = TS.init_batch_state(gt, [0, 9, TS.EMPTY_LANE], criterion="in|out",
                             trace_len=4, device="cpu")
    assert_states_equal(sj, st)
    for _ in range(6):
        sj = JS.step_batch(gj, sj, 1, use_pallas=False)
        st = TS.step_batch(gt, st, 1, use_kernels=use_kernels)
        assert_states_equal(sj, st)


def test_in_out_pallas_interpret_path_matches_port():
    """The reference's kernel path (Pallas in interpret mode) at n = 160."""
    gj, gt = _graphs("gnp", seed=2)
    sources = [1, 4, 150]
    want = JS.run_phased_static_batch(gj, sources, use_pallas=True,
                                      criterion="in|out", trace_len=16)
    got = TS.run_phased_static_batch(gt, sources, criterion="in|out",
                                     trace_len=16, device="cpu")
    assert_results_equal(want, got)


@pytest.mark.parametrize("criterion", ["in|out", "insimple|outsimple"])
def test_chunked_schedule_from_one_state_matches_reference(criterion):
    """Both packages resume from one mid-solve reference state (carried
    keys included) and run the same chunks, resets and early stops: every
    reset invalidates the in-side keys and the next step re-primes them,
    a zero-trip step included."""
    gj, gt = _graphs("kronecker", seed=7)
    sj = JS.init_batch_state(gj, [0, 5, JS.EMPTY_LANE, 9], criterion=criterion,
                             trace_len=6)
    sj = JS.step_batch(gj, sj, 3, use_pallas=False)
    st = interop.state_from_numpy(_state_fields(sj), device="cpu")
    assert_states_equal(sj, st)
    K = JS.KEEP_LANE
    schedule = [
        ("step", 4, True), ("reset", [K, 17, 3, JS.EMPTY_LANE]),
        ("step", 0, False), ("step", 5, False), ("lane", 0, 8),
        ("step", 2, True), ("reset", [K, K, K, K]), ("step", 1000, True),
        ("reset", [1, K, K, 2]), ("step", 1000, False),
    ]
    for op in schedule:
        if op[0] == "step":
            sj = JS.step_batch(gj, sj, op[1], use_pallas=False,
                               stop_on_lane_finish=op[2])
            st = TS.step_batch(gt, st, op[1], stop_on_lane_finish=op[2])
        elif op[0] == "reset":
            sj = JS.reset_lanes(sj, op[1])
            st = TS.reset_lanes(st, op[1])
        else:
            sj = JS.reset_lane(sj, op[1], op[2])
            st = TS.reset_lane(st, op[1], op[2])
        assert_states_equal(sj, st)
        np.testing.assert_array_equal(JS.lanes_active(sj), TS.lanes_active(st))


def test_reset_lane_is_bitwise_a_fresh_solve_in_out():
    _, gt = _graphs("grid_road", seed=8)
    st = TS.init_batch_state(gt, [0, 1, 2], criterion="in|out", device="cpu")
    st = TS.step_batch(gt, st, 5)
    st = TS.reset_lane(st, 1, 40)
    assert st.keys_valid is False
    st = TS.step_batch(gt, st, gt.n + 1)
    fresh = TS.run_phased_static_batch(gt, [40], criterion="in|out",
                                       device="cpu")
    assert_bits(fresh.dist[0], st.dist[1])
    assert_bits(fresh.phases[0], st.phases[1])


def test_single_source_in_out_matches_reference():
    gj, gt = _graphs("webgraph", seed=5)
    want = JS.run_phased_static(gj, 3, use_pallas=False, criterion="in|out")
    got = TS.run_phased_static(gt, 3, criterion="in|out", device="cpu")
    for f in ("dist", "status", "phases", "sum_fringe", "relax_edges",
              "settled_per_phase"):
        assert_bits(getattr(want, f), getattr(got, f))


def test_default_plan_carries_no_keys():
    _, gt = _graphs("gnp")
    st = TS.init_batch_state(gt, [0, 1], device="cpu")
    assert st.crit_keys is None and st.keys_valid is None
    st = TS.step_batch(gt, TS.reset_lanes(st, [3, TS.KEEP_LANE]), 4)
    assert st.crit_keys is None and st.keys_valid is None
    # in-side keys are primed; out-only plans carry keys but never prime
    st = TS.init_batch_state(gt, [0, 1], criterion="out", device="cpu")
    assert st.crit_keys.shape == (2, 2, gt.n) and st.keys_valid is None


def test_explicit_ell_out_matches_the_default():
    gj, gt = _graphs("gnp", seed=4)
    from repro_torch.core.graph import to_ell_in, to_ell_out

    a = TS.run_phased_static_batch(gt, [0, 1], criterion="in|out",
                                   device="cpu")
    b = TS.run_phased_static_batch(gt, [0, 1], criterion="in|out",
                                   ell=to_ell_in(gt), ell_out=to_ell_out(gt),
                                   device="cpu")
    assert_results_equal(JS.run_phased_static_batch(
        gj, [0, 1], use_pallas=False, criterion="in|out"), a)
    assert_results_equal(a, b)


def _serve(backend, sources, lanes, chunk):
    """Drive a backend through the admission schedule; returns the rows,
    per-request phases and every peek."""
    state = backend.init(lanes)
    lane_req = [None] * lanes
    pending = list(range(len(sources)))
    rows, phases_of, peeks = {}, {}, []
    while pending or any(r is not None for r in lane_req):
        admit = np.full(lanes, TS.KEEP_LANE, np.int64)
        for lane in range(lanes):
            if lane_req[lane] is None and pending:
                lane_req[lane] = pending.pop(0)
                admit[lane] = sources[lane_req[lane]]
        if (admit != TS.KEEP_LANE).any():
            state = backend.reset_lanes(state, admit)
        state = backend.step(state, chunk, stop_on_lane_finish=True)
        trips, active, phases = backend.peek(state)
        peeks.append((trips, active.tolist(), phases.tolist()))
        for lane in range(lanes):
            r = lane_req[lane]
            if r is not None and not active[lane]:
                rows[r] = backend.take_row(state, lane)
                phases_of[r] = int(phases[lane])
                lane_req[lane] = None
    return rows, phases_of, peeks


@pytest.mark.parametrize("family,args,lanes,chunk,criterion", [
    ("uniform_gnp", (150, 0.04), 3, 4, "in|out"),
    ("webgraph", (160,), 2, 7, "in|out"),
    ("grid_road", (9, 10), 4, 1000, "outweak"),
])
def test_static_backend_dynamic_rows_match_reference(family, args, lanes,
                                                     chunk, criterion):
    gj = getattr(JGen, family)(*args, seed=2)
    gt = getattr(TGen, family)(*args, seed=2, device="cpu")
    sources = np.random.default_rng(1).integers(0, gt.n, 7)
    want = _serve(JBackend(gj, use_pallas=False, criterion=criterion),
                  sources, lanes, chunk)
    backend = StaticBackend(gt, criterion=criterion, device="cpu")
    assert backend.criterion == criterion and backend.ell_out is not None
    got = _serve(backend, sources, lanes, chunk)
    assert want[2] == got[2]  # every peek: trips, live flags, phases
    assert want[1] == got[1]
    for r in range(len(sources)):
        np.testing.assert_array_equal(want[0][r].view(np.int32),
                                      got[0][r].view(np.int32))
