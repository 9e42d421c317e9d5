"""The port's dense criterion semantics, ``run_phased`` and oracle plans
against the JAX reference, bit for bit.

Both packages get the same seeded graphs, states and sources. The
reference's engines are compiled (``jax.jit``), and XLA fuses the oracle's
``1e-6 + 1e-6 * |dist_true|`` into one FMA, so its ``crit_*`` functions are
held here under ``jax.jit`` as its engines run them. The stepper's oracle
plans are held against the reference's stepper with ``use_pallas=False``
(its Pallas path is bit-identical by its own ops rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import criteria as JC
from repro.core import oracle as JO
from repro.core import phased as JP
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro_torch.core import criteria as TC
from repro_torch.core import oracle as TO
from repro_torch.core import phased as TP
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ref as kref

torch.set_num_threads(1)

GRAPHS = {
    "gnp": ("uniform_gnp", (96, 0.06)),
    "kronecker": ("kronecker", (7,)),
}
SIGNED = np.array([0.0, -0.0, 0.5, 1.0, np.nan], np.float32)
ORACLE_PLANS = ("oracle", "instatic|outstatic|oracle", "in|out|oracle")
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase")


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(want, got):
    want, got = _bits(want), _bits(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(want, got)


def _graphs(name, seed=1):
    fn, args = GRAPHS[name]
    return (getattr(JGen, fn)(*args, seed=seed),
            getattr(TGen, fn)(*args, seed=seed, device="cpu"))


def _truth(gj, sources) -> np.ndarray:
    return np.stack([JO.dijkstra_numpy(gj, int(s)).astype(np.float32)
                     for s in sources])


# ---------------------------------------------------------------------------
# the segment-min helper and the oracle's tolerance
# ---------------------------------------------------------------------------


SEGMIN_CASES = {
    "+0 then -0": [0.0, -0.0],
    "-0 then +0": [-0.0, 0.0],
    "-0 beside 0.5": [0.5, -0.0, 1.0],
    "NaN first": [np.nan, 1.0, -0.0],
    "NaN last": [0.0, 0.5, np.nan],
    "zeros and NaN": [0.0, np.nan, -0.0],
    "+0 twice": [0.0, 0.5, 0.0],
}


@pytest.mark.parametrize("case", sorted(SEGMIN_CASES))
def test_segment_min_matches_jax_on_ties(case):
    vals = np.asarray(SEGMIN_CASES[case], np.float32)
    idx = np.zeros(len(vals), np.int32)
    idx[-1] = 2  # the last value in a segment of its own; segment 1 empty
    want = jax.ops.segment_min(jnp.asarray(vals), jnp.asarray(idx),
                               num_segments=4)
    got = kref.segment_min(torch.from_numpy(vals), torch.from_numpy(idx), 4)
    assert_bits(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_min_matches_jax_on_random_ties(seed):
    rng = np.random.default_rng(seed)
    vals = SIGNED[rng.integers(0, len(SIGNED), 4000)]
    vals[rng.random(4000) < 0.6] = SIGNED[rng.integers(0, 4, 1)]
    idx = rng.integers(0, 300, 4000).astype(np.int32)
    want = jax.jit(lambda v, i: jax.ops.segment_min(v, i, num_segments=320))(
        jnp.asarray(vals), jnp.asarray(idx))
    got = kref.segment_min(torch.from_numpy(vals), torch.from_numpy(idx), 320)
    assert_bits(want, got)


def _edge_rows(rng, size):
    """True distances and tentatives around the oracle's tolerance edge:
    each d is one of the f32 values next to fl(dt + tol) (FMA form)."""
    dt = np.concatenate([
        rng.uniform(0, 4, size // 2), rng.uniform(0, 1e-3, size // 4),
        rng.uniform(1e3, 1e5, size - size // 2 - size // 4),
    ]).astype(np.float32)
    dt[:3] = (0.0, np.inf, 1.0)
    tol = np.asarray(jax.jit(lambda x: 1e-6 + 1e-6 * jnp.abs(x))(dt))
    edge = dt + tol
    step = rng.integers(-2, 3, size)
    d = edge.copy()
    with np.errstate(over="ignore"):  # nextafter(+inf, +inf)
        for _ in range(2):  # walk up to two ulps either way
            d = np.where(step > 0, np.nextafter(d, np.float32(np.inf)), d)
            d = np.where(step < 0, np.nextafter(d, np.float32(-np.inf)), d)
            step = step - np.sign(step)
    return dt, d.astype(np.float32)


def test_oracle_tolerance_is_the_compiled_fma():
    rng = np.random.default_rng(3)
    dt, _ = _edge_rows(rng, 20000)
    want = jax.jit(lambda x: 1e-6 + 1e-6 * jnp.abs(x))(jnp.asarray(dt))
    got = TC.oracle_tolerance(torch.from_numpy(dt))
    assert_bits(want, got)
    # the eager two-step f32 form is not it: the test can tell them apart
    eps = np.float32(1e-6)
    assert (eps + eps * np.abs(dt) != np.asarray(want)).any()


def _contexts(gj, gt, seed, **over):
    """A random mid-solve state over both graphs, as each package's
    CritContext (the reference's status is int8, as run_phased keeps it)."""
    rng = np.random.default_rng(seed)
    n = gt.n
    d = rng.uniform(0, 3, n).astype(np.float32)
    d[rng.random(n) < 0.2] = np.inf
    status = rng.integers(0, 3, n).astype(np.int8)
    status[np.isinf(d)] = 0
    dt = (d * rng.choice([0.5, 1.0, 1.0], n)).astype(np.float32)
    vals = dict(d=d, status=status, dist_true=dt)
    vals.update(over)
    fringe = vals["status"] == 1
    min_fd = np.float32(np.min(np.where(fringe, vals["d"], np.inf)))
    cj = JC.CritContext(
        src=gj.src, dst=gj.dst, w=gj.w, in_min_static=gj.in_min_static,
        out_min_static=gj.out_min_static, d=jnp.asarray(vals["d"]),
        status=jnp.asarray(vals["status"]), fringe=jnp.asarray(fringe),
        min_fringe_d=jnp.float32(min_fd),
        dist_true=jnp.asarray(vals["dist_true"]))
    ct = TC.CritContext(
        src=gt.src, dst=gt.dst, w=gt.w, in_min_static=gt.in_min_static,
        out_min_static=gt.out_min_static, d=torch.from_numpy(vals["d"]),
        status=torch.from_numpy(vals["status"]),
        fringe=torch.from_numpy(fringe),
        min_fringe_d=torch.tensor(min_fd),
        dist_true=torch.from_numpy(vals["dist_true"]))
    return cj, ct


def test_registry_holds_every_criterion():
    assert set(TC.REGISTRY) == set(JC.REGISTRY) == set(TC.CRITERIA)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(JC.REGISTRY))
def test_crit_functions_match_reference(graph, name):
    gj, gt = _graphs(graph)
    fn = jax.jit(JC.REGISTRY[name])
    for seed in range(3):
        cj, ct = _contexts(gj, gt, seed)
        assert_bits(fn(cj), TC.REGISTRY[name](ct))


def test_crit_oracle_at_the_tolerance_edge():
    gj, gt = _graphs("gnp")
    dt, d = _edge_rows(np.random.default_rng(4), gt.n)
    status = np.ones(gt.n, np.int8)
    cj, ct = _contexts(gj, gt, 0, d=d, status=status, dist_true=dt)
    want = jax.jit(JC.crit_oracle)(cj)
    assert_bits(want, TC.crit_oracle(ct))
    mask = np.asarray(want)
    assert mask.any() and not mask.all()  # both sides of the edge are hit


@pytest.mark.parametrize("names", [("dijk",), ("instatic", "outstatic"),
                                   ("in", "out"), ("oracle",),
                                   ("insimple", "outweak", "oracle")])
def test_evaluate_matches_reference(names):
    gj, gt = _graphs("kronecker")
    fn = jax.jit(JC.evaluate, static_argnums=0)
    for seed in range(3):
        cj, ct = _contexts(gj, gt, seed)
        assert_bits(fn(names, cj), TC.evaluate(names, ct))
    # truth far below every tentative: the bare oracle's mask is empty and
    # the DIJK guard settles instead
    low = np.zeros(gt.n, np.float32)
    cj, ct = _contexts(gj, gt, 9, dist_true=low)
    cj = cj._replace(d=cj.d + 1.0)
    ct = ct._replace(d=ct.d + 1.0, min_fringe_d=ct.min_fringe_d + 1.0)
    cj = cj._replace(min_fringe_d=cj.min_fringe_d + 1.0)
    want = fn(("oracle",), cj)
    assert np.asarray(want).any()
    assert_bits(want, TC.evaluate(("oracle",), ct))


# ---------------------------------------------------------------------------
# run_phased, bellman_ford, dijkstra_phase_counts
# ---------------------------------------------------------------------------


RUN_PHASED = ["dijk", "instatic", "insimple", "in", "outstatic", "outsimple",
              "outweak", "out", "oracle", "instatic|outstatic", "in|out",
              "in|out|oracle"]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("criterion", RUN_PHASED)
def test_run_phased_matches_reference(graph, criterion):
    gj, gt = _graphs(graph, seed=2)
    src = 5
    dt = _truth(gj, [src])[0] if "oracle" in criterion else None
    want = JP.run_phased(gj, src, criterion, dist_true=dt, trace_len=48)
    got = TP.run_phased(gt, src, criterion, dist_true=dt, trace_len=48,
                        device="cpu")
    for f in ("dist", "status", "phases", "settled_per_phase"):
        assert_bits(getattr(want, f), getattr(got, f))
    for f in ("sum_fringe", "relax_edges"):
        assert int(getattr(want, f)) == getattr(got, f)
        assert isinstance(getattr(got, f), np.int64)


def test_run_phased_validation_and_defaults():
    gj, gt = _graphs("gnp")
    for pkg, g, kw in ((JP, gj, {}), (TP, gt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="requires dist_true"):
            pkg.run_phased(g, 0, "in|oracle", **kw)
    # a missing dist_true is zeros; a short cap stops the loop, and the
    # trace's last slot takes every later phase
    want = JP.run_phased(gj, 0, "dijk", trace_len=4, max_phases=9)
    got = TP.run_phased(gt, 0, "dijk", trace_len=4, max_phases=9,
                        device="cpu")
    assert int(got.phases) == 9
    for f in ("dist", "status", "phases", "settled_per_phase"):
        assert_bits(getattr(want, f), getattr(got, f))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bellman_ford_and_dijkstra_match_reference(graph):
    gj, gt = _graphs(graph, seed=3)
    for src in (0, 11):
        assert_bits(JO.bellman_ford_jnp(gj, src),
                    TO.bellman_ford(gt, src, device="cpu"))
        np.testing.assert_array_equal(JO.dijkstra_phase_counts(gj, src),
                                      TO.dijkstra_phase_counts(gt, src))


# ---------------------------------------------------------------------------
# oracle plans on the stepper
# ---------------------------------------------------------------------------


def _harvest_equal(want, got):
    for f in RESULT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        elif f in ("sum_fringe", "relax_edges"):
            np.testing.assert_array_equal(np.asarray(w), g)
        else:
            assert_bits(w, g)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("criterion", ORACLE_PLANS)
def test_oracle_plans_match_reference_chunked_and_reset(layout, criterion):
    gj, gt = _graphs("gnp", seed=4)
    ell_j = (JS.to_ell_in_sliced(gj) if layout == "sliced"
             else JS.to_ell_in(gj))
    ell_t = (TS.to_ell_in_sliced(gt) if layout == "sliced"
             else TS.to_ell_in(gt))
    sources = np.array([0, TS.EMPTY_LANE, 17], np.int32)
    dt = _truth(gj, [0, 0, 17])
    sj = JS.init_batch_state(gj, sources, criterion=criterion,
                             dist_true=dt, trace_len=6)
    st = TS.init_batch_state(gt, sources, criterion=criterion,
                             dist_true=dt, trace_len=6, device="cpu")
    for chunk in range(40):
        if chunk == 2:  # refill the parked lane with fresh truth rows
            refill = np.array([TS.KEEP_LANE, 40, TS.KEEP_LANE], np.int32)
            dt = _truth(gj, [0, 40, 17])
            sj = JS.reset_lanes(sj, refill, dist_true=dt)
            st = TS.reset_lanes(st, refill, dist_true=dt)
        sj = JS.step_batch(gj, sj, 3, ell=ell_j, use_pallas=False)
        st = TS.step_batch(gt, st, 3, ell=ell_t)
        _harvest_equal(JS.harvest(sj), TS.harvest(st))
        assert_bits(sj.dist_true, st.dist_true)
        if not TS.lanes_active(st).any():
            break
    assert not TS.lanes_active(st).any()
    np.testing.assert_array_equal(_bits(st.dist), dt.view(np.int32))


@pytest.mark.parametrize("criterion", ORACLE_PLANS)
def test_oracle_stepper_matches_run_phased(criterion):
    gj, gt = _graphs("kronecker", seed=5)
    dt = _truth(gj, [3])[0]
    want = TP.run_phased(gt, 3, criterion, dist_true=dt, trace_len=gt.n + 1,
                         device="cpu")
    got = TS.run_phased_static(gt, 3, criterion=criterion, dist_true=dt,
                               device="cpu")
    for f in ("dist", "status", "phases", "settled_per_phase"):
        assert_bits(getattr(want, f), getattr(got, f))
    for f in ("sum_fringe", "relax_edges"):
        assert getattr(want, f) == getattr(got, f)


def test_oracle_plans_at_the_tolerance_edge():
    """Truth rows set so that each final distance lies a few ulps around
    fl(dt + tol): the settle decisions hinge on the tolerance's bits."""
    gj, gt = _graphs("gnp", seed=6)
    final = _truth(gj, [2])[0]
    rng = np.random.default_rng(6)
    # dt such that fl(dt + tol(dt)) lands near the final distance: step dt
    # down from the final value, a ulp at a time, a random count of steps
    dt = final.copy()
    for _ in range(int(rng.integers(15, 25))):
        dt = np.where(rng.random(gt.n) < 0.9,
                      np.nextafter(dt, np.float32(-np.inf)), dt)
    dt = np.where(np.isfinite(final), dt, final).astype(np.float32)[None]
    for crit in ("oracle", "in|out|oracle"):
        want = JS.run_phased_static_batch(gj, [2], criterion=crit,
                                          dist_true=dt, use_pallas=False,
                                          trace_len=gt.n + 1, telemetry=True)
        got = TS.run_phased_static_batch(gt, [2], criterion=crit,
                                         dist_true=dt, trace_len=gt.n + 1,
                                         telemetry=True, device="cpu")
        _harvest_equal(want, got)
        assert_bits(want.settle_attribution, got.settle_attribution)
        p = TP.run_phased(gt, 2, crit, dist_true=dt[0], device="cpu")
        assert int(p.phases) == int(got.phases[0])


def test_dist_true_errors_match_reference():
    """The reference's test_oracle_plan_requires_and_validates_dist_true,
    on both packages: the same errors, and a refilled lane equal to a fresh
    solve."""
    gj, gt = _graphs("gnp", seed=7)
    dt = _truth(gj, [0])
    dt3 = _truth(gj, [3])
    for js, g, kw in ((JS, gj, {}), (TS, gt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="includes 'oracle'"):
            js.init_batch_state(g, [0], criterion="oracle", **kw)
        with pytest.raises(ValueError, match="shape"):
            js.init_batch_state(g, [0], criterion="oracle",
                                dist_true=np.zeros((2, g.n), np.float32),
                                **kw)
        state = js.init_batch_state(g, [0], criterion="oracle", dist_true=dt,
                                    **kw)
        with pytest.raises(ValueError, match="refilling lanes requires"):
            js.reset_lanes(state, np.asarray([3], np.int32))
        with pytest.raises(ValueError, match="dist_true must have shape"):
            js.reset_lanes(state, np.asarray([3], np.int32),
                           dist_true=np.zeros((2, g.n), np.float32))
        with pytest.raises(ValueError, match="use reset_lanes"):
            js.reset_lane(state, 0, 3)
        js.reset_lanes(state, np.asarray([-1], np.int32))  # parking is fine
        plain = js.init_batch_state(g, [0], **kw)
        with pytest.raises(ValueError, match="does not read dist_true"):
            js.reset_lanes(plain, np.asarray([1], np.int32), dist_true=dt)
        # dist_true on a plan without the oracle is dropped
        assert js.init_batch_state(g, [0], dist_true=dt, **kw).dist_true \
            is None
    st = TS.init_batch_state(gt, [0], criterion="oracle", dist_true=dt,
                             device="cpu")
    st = TS.reset_lanes(st, np.asarray([3], np.int32), dist_true=dt3)
    while TS.lanes_active(st).any():
        st = TS.step_batch(gt, st, 50)
    solo = JS.run_phased_static(gj, 3, criterion="oracle", dist_true=dt3[0],
                                use_pallas=False)
    assert_bits(solo.dist, st.dist[0])
    assert int(solo.phases) == int(st.phases[0])


def test_oracle_state_crosses_over_through_interop():
    """A reference oracle state stopped mid-solve, continued by the port."""
    from repro_torch import interop

    gj, gt = _graphs("kronecker", seed=8)
    dt = _truth(gj, [1, 30])
    sj = JS.init_batch_state(gj, [1, 30], criterion="in|out|oracle",
                             dist_true=dt, trace_len=8, telemetry=True)
    sj = JS.step_batch(gj, sj, 4, use_pallas=False)
    fields = {f.name: (sj.criterion if f.name == "criterion"
                       else None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)}
    st = interop.state_from_numpy(fields, device="cpu")
    sj = JS.step_batch(gj, sj, 200, use_pallas=False)
    st = TS.step_batch(gt, st, 200)
    _harvest_equal(JS.harvest(sj), TS.harvest(st))
    for f in ("fringe_per_phase", "relax_per_phase", "settle_attribution"):
        assert_bits(getattr(JS.harvest(sj), f), getattr(TS.harvest(st), f))
