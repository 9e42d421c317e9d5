"""The port's fault injection (``repro_torch.serving.faults``) against the
reference's (``repro.serving.faults``).

A plan of one seed must be one schedule in both packages (the numpy
generators are the reference's), each fault's corruption RNG must draw the
same numbers, a corrupted row must be the same bits, and the shims must
fire the same faults at the same ordinals: ``FaultyBackend`` over each
package's ``StaticBackend`` and ``FaultyDistCache`` over each package's
``DistCache``, driven by one script of calls.
"""
import numpy as np
import pytest
import torch

from repro.graphs import generators as JGen
from repro.serving import DistCache as JCache
from repro.serving import StaticBackend as JBackend
from repro.serving import faults as JF
from repro_torch.graphs import generators as TGen
from repro_torch.serving import DistCache as TCache
from repro_torch.serving import StaticBackend as TBackend
from repro_torch.serving import faults as TF

torch.set_num_threads(1)


def _faults(plan):
    return [(f.kind, f.at, f.lane, f.magnitude) for f in plan.faults]


@pytest.mark.parametrize("seed", [0, 1, 9, 10, 123, 2**20 - 1, 987654])
@pytest.mark.parametrize("n_faults,horizon,lanes", [(4, 24, 4), (6, 20, 1),
                                                    (12, 3, 8), (0, 5, 2)])
def test_random_plans_are_the_references(seed, n_faults, horizon, lanes):
    jp = JF.FaultPlan.random(seed, n_faults=n_faults, horizon=horizon,
                             lanes=lanes)
    tp = TF.FaultPlan.random(seed, n_faults=n_faults, horizon=horizon,
                             lanes=lanes)
    assert _faults(tp) == _faults(jp)
    assert tp.seed == jp.seed and len(tp) == len(jp)
    assert repr(tp) == repr(jp)
    for kinds in (("stall",), TF._ROW_KINDS, TF.FAULT_KINDS):
        assert [(i, f.kind) for i, f in tp.indexed(kinds)] == \
            [(i, f.kind) for i, f in jp.indexed(kinds)]
    for i in range(len(tp)):
        np.testing.assert_array_equal(tp.rng_for(i).integers(0, 1 << 30, 8),
                                      jp.rng_for(i).integers(0, 1 << 30, 8))


def test_plan_kinds_restriction_and_validation():
    for kinds in (("stall", "step_error"), ("cache_poison",)):
        jp = JF.FaultPlan.random(5, n_faults=10, kinds=kinds)
        tp = TF.FaultPlan.random(5, n_faults=10, kinds=kinds)
        assert _faults(tp) == _faults(jp)
        assert {f.kind for f in tp.faults} <= set(kinds)
    assert TF.FAULT_KINDS == JF.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.Fault("meteor", at=0)
    with pytest.raises(ValueError, match="ordinal"):
        TF.Fault("stall", at=-1)
    assert issubclass(TF.InjectedFault, RuntimeError)


def test_virtual_clock():
    for VC in (JF.VirtualClock, TF.VirtualClock):
        c = VC(1.5)
        assert c.now() == 1.5 and c.advance(2.0) == 3.5 and c.now() == 3.5
        with pytest.raises(ValueError, match="forward"):
            c.advance(-1.0)


@pytest.mark.parametrize("kind", ["row_nan", "row_neg", "row_perturb"])
@pytest.mark.parametrize("index", [0, 3, 17])
def test_corrupt_row_is_the_references(kind, index):
    rng = np.random.default_rng(index)
    row = rng.uniform(0, 5, 97).astype(np.float32)
    row[rng.integers(0, 97, 20)] = np.inf
    row[4] = -0.0
    fault = (TF.Fault(kind, at=0, magnitude=1.75),
             JF.Fault(kind, at=0, magnitude=1.75))
    plan_t, plan_j = TF.FaultPlan([fault[0]], seed=index), \
        JF.FaultPlan([fault[1]], seed=index)
    got = TF._corrupt_row(row, fault[0], plan_t.rng_for(0))
    want = JF._corrupt_row(row, fault[1], plan_j.rng_for(0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got.view(np.int32), row.view(np.int32))
    assert got is not row


@pytest.fixture(scope="module")
def graphs():
    return (JGen.uniform_gnp(60, 7 / 60, seed=91),
            TGen.uniform_gnp(60, 7 / 60, seed=91, device="cpu"))


def _drive(backend, sources):
    """One script of backend calls: admit, step, harvest every live lane."""
    state = backend.init(2)
    log = []
    pending = list(sources)
    lane_src = [None, None]
    for _ in range(60):
        admit = np.full(2, -2, np.int64)
        for lane in range(2):
            if lane_src[lane] is None and pending:
                lane_src[lane] = admit[lane] = pending.pop(0)
        if (admit != -2).any():
            state = backend.reset_lanes(state, admit)
        try:
            state = backend.step(state, 3, stop_on_lane_finish=True)
        except (JF.InjectedFault, TF.InjectedFault) as e:
            log.append(("raised", str(e)))
            continue
        _, active, _ = backend.peek(state)
        for lane in range(2):
            if lane_src[lane] is not None and not active[lane]:
                row = backend.take_row(state, lane)
                log.append(("row", lane, int(lane_src[lane]),
                            row.view(np.int32).tobytes()))
                lane_src[lane] = None
        if not pending and lane_src == [None, None]:
            break
    return log


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_faulty_backend_fires_alike(graphs, seed):
    gj, gt = graphs
    jp = JF.FaultPlan.random(seed, n_faults=6, horizon=10, lanes=2,
                             kinds=("row_nan", "row_neg", "row_perturb",
                                    "step_error", "stall"))
    tp = TF.FaultPlan.random(seed, n_faults=6, horizon=10, lanes=2,
                             kinds=("row_nan", "row_neg", "row_perturb",
                                    "step_error", "stall"))
    jc, tc = JF.VirtualClock(), TF.VirtualClock()
    jb = JF.FaultyBackend(JBackend(gj, use_pallas=False), jp, clock=jc)
    tb = TF.FaultyBackend(TBackend(gt, device="cpu"), tp, clock=tc)
    assert (tb.n, tb.criterion, tb.point_queries, tb.g) == \
        (jb.n, jb.criterion, jb.point_queries, gt)
    sources = [0, 5, 17, 33, 41, 59]
    assert _drive(tb, sources) == _drive(jb, sources)
    assert [(f.kind, f.at) for f in tb.fired] == \
        [(f.kind, f.at) for f in jb.fired]
    assert tb.steps_taken == jb.steps_taken and tc.now() == jc.now()
    assert tb._unfired == jb._unfired
    assert tb.fired  # the script met faults


def test_faulty_backend_with_no_due_fault_is_transparent(graphs):
    _, gt = graphs
    plan = TF.FaultPlan([TF.Fault("row_nan", at=10_000, lane=0),
                         TF.Fault("step_error", at=10_000)])
    log = _drive(TF.FaultyBackend(TBackend(gt, device="cpu"), plan),
                 [0, 17])
    plain = _drive(TBackend(gt, device="cpu"), [0, 17])
    assert log == plain


@pytest.mark.parametrize("seed", [8, 21])
def test_faulty_dist_cache_poisons_alike(seed):
    rng = np.random.default_rng(seed)
    rows = [rng.uniform(0, 3, 40).astype(np.float32) for _ in range(5)]
    faults = [("cache_poison", 0, 2.0), ("cache_poison", 2, 0.5),
              ("cache_poison", 3, 1.0)]
    out = []
    for F, Cache in ((JF, JCache), (TF, TCache)):
        plan = F.FaultPlan([F.Fault(k, at=a, magnitude=m)
                            for k, a, m in faults], seed=seed)
        cache = F.FaultyDistCache(Cache(capacity=3), plan)
        got = []
        for s, r in enumerate(rows):
            cache.put("g", "c", s, r, now=float(s))
        for s in range(5):
            hit = cache.get("g", "c", s)
            got.append(None if hit is None else hit.view(np.int32).tobytes())
        out.append((got, cache.poisoned, cache.puts, cache.corrupt_dropped,
                    cache.evictions, len(cache), ("g", "c", 4) in cache,
                    sorted(cache._unfired)))
    assert out[0] == out[1]
    assert out[1][1]  # something was poisoned, and the cache dropped it
    assert out[1][3] >= 1
