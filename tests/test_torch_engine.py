"""The port's stepper against the JAX reference's, bit for bit.

Both packages solve the same seeded graphs from the same sources under the
same chunk schedule; every ``BatchedResult`` / ``PhasedResult`` field must
match exactly. The reference runs its Pallas kernels in interpret mode on
small graphs and its ``use_pallas=False`` twins (bit-identical by its ops
rule) on larger ones.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import criteria as JC
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro_torch import interop
from repro_torch.core import criteria as TC
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen

torch.set_num_threads(1)

GRAPHS = {
    "gnp": ("uniform_gnp", (160, 0.04)),
    "kronecker": ("kronecker", (7,)),
    "grid_road": ("grid_road", (10, 12)),
    "webgraph": ("webgraph", (180,)),
}
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


def assert_results_equal(want, got, fields=RESULT_FIELDS):
    for f in fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            assert_bits(w, g)


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


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_batch_solve_matches_reference(graph, use_kernels):
    gj, gt = _graphs(graph)
    sources = np.array([0, 7, gt.n - 1, 3, 11])
    want = JS.run_phased_static_batch(gj, sources, use_pallas=False,
                                      trace_len=8)
    got = TS.run_phased_static_batch(gt, sources, use_kernels=use_kernels,
                                     trace_len=8, device="cpu")
    assert_results_equal(want, got)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_empty_lanes_and_single_lane_match_reference(graph):
    gj, gt = _graphs(graph, seed=4)
    for sources in ([5], [2, TS.EMPTY_LANE, 9, TS.EMPTY_LANE, 0]):
        sj = JS.init_batch_state(gj, sources, trace_len=4)
        st = TS.init_batch_state(gt, sources, trace_len=4, device="cpu")
        want = JS.harvest(JS.step_batch(gj, sj, gt.n + 1, use_pallas=False))
        got = TS.harvest(TS.step_batch(gt, st, gt.n + 1))
        assert_results_equal(want, got)


def test_pallas_interpret_path_matches_port():
    """The reference's kernel path (Pallas in interpret mode) at small n."""
    gj, gt = _graphs("gnp", seed=2)
    sources = [1, 4, 150]
    want = JS.run_phased_static_batch(gj, sources, use_pallas=True,
                                      trace_len=64)
    got = TS.run_phased_static_batch(gt, sources, trace_len=64, device="cpu")
    assert_results_equal(want, got)


@pytest.mark.parametrize("graph", ["grid_road", "webgraph"])
def test_single_source_matches_reference(graph):
    gj, gt = _graphs(graph, seed=5)
    want = JS.run_phased_static(gj, 3, use_pallas=False)
    got = TS.run_phased_static(gt, 3, device="cpu")
    for f in ("dist", "status", "phases", "sum_fringe", "relax_edges",
              "settled_per_phase"):
        assert_bits(getattr(want, f), getattr(got, f))
    # the default ring covers the cap, so the full profile is there
    assert got.settled_per_phase.shape == (gt.n + 1,)
    short = TS.run_phased_static(gt, 3, trace_len=1, device="cpu")
    assert short.settled_per_phase is None


@pytest.mark.parametrize("criterion", ["dijk", "instatic", "outstatic",
                                       "dijk|outstatic", "outstatic|instatic"])
def test_static_criteria_match_reference(criterion):
    gj, gt = _graphs("kronecker", seed=6)
    want = JS.run_phased_static_batch(gj, [0, 9], use_pallas=False,
                                      criterion=criterion, trace_len=8)
    got = TS.run_phased_static_batch(gt, [0, 9], criterion=criterion,
                                     trace_len=8, device="cpu")
    assert_results_equal(want, got)


def test_max_phases_cap_matches_reference():
    gj, gt = _graphs("grid_road")
    want = JS.run_phased_static_batch(gj, [0, gt.n - 1], max_phases=3,
                                      use_pallas=False)
    got = TS.run_phased_static_batch(gt, [0, gt.n - 1], max_phases=3,
                                     device="cpu")
    assert int(got.total_phases) == 3
    assert_results_equal(want, got)


def test_chunked_schedule_from_one_state_matches_reference():
    """Both packages resume from one mid-solve reference state and run the
    same schedule of chunks, lane resets and early stops."""
    gj, gt = _graphs("webgraph", seed=7)
    sj = JS.init_batch_state(gj, [0, 5, JS.EMPTY_LANE, 9], trace_len=6)
    sj = JS.step_batch(gj, sj, 3, use_pallas=False)
    st = interop.state_from_numpy(_state_fields(sj), device="cpu")
    assert_results_equal(JS.harvest(sj), TS.harvest(st))
    K = JS.KEEP_LANE
    schedule = [
        ("step", 4, True), ("reset", [K, 17, 3, JS.EMPTY_LANE]),
        ("step", 5, False), ("lane", 0, 8), ("step", 2, True),
        ("step", 1000, True), ("reset", [1, K, K, 2]), ("step", 1000, False),
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
        assert_results_equal(JS.harvest(sj), TS.harvest(st))
        np.testing.assert_array_equal(JS.lanes_active(sj), TS.lanes_active(st))


def test_reset_lane_is_bitwise_a_fresh_solve():
    _, gt = _graphs("gnp", seed=8)
    st = TS.init_batch_state(gt, [0, 1, 2], device="cpu")
    st = TS.step_batch(gt, st, 5)
    st = TS.reset_lane(st, 1, 40)
    st = TS.step_batch(gt, st, gt.n + 1)
    fresh = TS.run_phased_static_batch(gt, [40], device="cpu")
    assert_bits(fresh.dist[0], st.dist[1])
    assert_bits(fresh.phases[0], st.phases[1])


def test_counters_survive_uint32_wrap_like_reference():
    """The reference test_counters_survive_uint32_wrap, on both packages: a
    low limb seeded just below 2^32 must carry, and harvest must give the
    same int64 totals."""
    gj, gt = _graphs("gnp", seed=3)
    near = np.uint32(2**32 - 2)
    sj = JS.init_batch_state(gj, [0, 1])
    sj = dataclasses.replace(
        sj, sum_fringe=jnp.full_like(sj.sum_fringe, near),
        relax_edges=jnp.full_like(sj.relax_edges, near))
    st = interop.state_from_numpy(_state_fields(sj), device="cpu")
    want = JS.harvest(JS.step_batch(gj, sj, 64, use_pallas=False))
    got = TS.harvest(TS.step_batch(gt, st, 64))
    assert got.sum_fringe.dtype == np.int64
    assert (got.sum_fringe > 2**32).all()
    assert_results_equal(want, got)
    base = TS.harvest(TS.step_batch(
        gt, TS.init_batch_state(gt, [0, 1], device="cpu"), 64))
    np.testing.assert_array_equal(got.relax_edges,
                                  int(near) + base.relax_edges)


def test_plans_match_reference():
    names = TC.CRITERIA
    assert names == JC._CANON_ORDER
    specs = list(names) + ["instatic|outstatic", "out|in", "in|out|oracle",
                           "outweak|insimple", "OUTSTATIC | dijk"]
    for spec in specs:
        assert TC.canonical(spec) == JC.canonical(spec)
        assert tuple(TC.plan_for(spec)) == tuple(JC.plan_for(spec))
        assert TC.attribution_terms(TC.plan_for(spec)) == \
            JC.attribution_terms(JC.plan_for(spec))
    with pytest.raises(ValueError, match="unknown criterion"):
        TC.parse("instatic|bogus")


def test_input_validation_matches_reference():
    gj, gt = _graphs("gnp")
    cases = [
        (lambda m: m.run_phased_static_batch, ([],), "non-empty"),
        (lambda m: m.run_phased_static_batch, ([500],), r"\[0, 160\)"),
        (lambda m: m.run_phased_static_batch, ([0, -1],), r"\[0, 160\)"),
        (lambda m: m.run_phased_static_batch, ([0.5],), "integer"),
        (lambda m: m.init_batch_state, ([0, -3],), "empty lane"),
    ]
    for get, args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            get(JS)(gj, *args)
        with pytest.raises(ValueError, match=msg):
            kw = {"device": "cpu"}
            get(TS)(gt, *args, **kw)
    with pytest.raises(ValueError, match="trace_len"):
        TS.init_batch_state(gt, [0], trace_len=0, device="cpu")
    with pytest.raises(ValueError, match="delta"):
        TS.init_batch_state(gt, [0], delta=0.5, device="cpu")
    st = TS.init_batch_state(gt, [0, 1], device="cpu")
    sj = JS.init_batch_state(gj, [0, 1])
    for args, msg in (([0], r"shape \(2,\)"), ([0, -3], "keep"),
                      ([0, 160], "keep")):
        with pytest.raises(ValueError, match=msg):
            JS.reset_lanes(sj, args)
        with pytest.raises(ValueError, match=msg):
            TS.reset_lanes(st, args)
    with pytest.raises(ValueError, match="target lanes"):
        TS.reset_lanes(st, [0, 1], targets=[3, 4])
    with pytest.raises(ValueError, match="dist_true"):
        TS.reset_lanes(st, [0, 1], dist_true=np.zeros((2, 160), np.float32))
    for lane, src, msg in ((2, 0, "lane must be"), (0, 160, "source must be"),
                           (0, -2, "source must be")):
        with pytest.raises(ValueError, match=msg):
            TS.reset_lane(st, lane, src)
    with pytest.raises(ValueError, match="target lanes"):
        TS.reset_lane(st, 0, 3, target=4)
    with pytest.raises(ValueError, match="layout must be"):
        TS.run_phased_static_batch(gt, [0], layout="dense", device="cpu")


def test_unported_modes_raise_naming_the_roadmap():
    _, gt = _graphs("gnp")
    for kw in ({"criterion": "oracle"}, {"criterion": "in|oracle"},
               {"criterion": "delta"}, {"telemetry": True},
               {"targets": [3]}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TS.run_phased_static_batch(gt, [0], device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.run_phased_static(gt, 0, target=3, device="cpu")


def test_entry_points_run_on_the_card_by_default():
    _, gt = _graphs("gnp")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lives on cpu"):
            TS.run_phased_static_batch(gt, [0])
        return
    for call in (lambda: TS.run_phased_static_batch(gt, [0]),
                 lambda: TS.run_phased_static(gt, 0),
                 lambda: TS.init_batch_state(gt, [0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
