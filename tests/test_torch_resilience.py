"""The port's fault-tolerant serving against the reference's, on the CPU.

``verify_row`` (the port's runs on the graph's device, here the CPU) must
give the reference's verdict and reason string on engine rows and on every
single-entry corruption, signed-zero weights included. Both packages'
``ResilientBatcher`` then serve one script under one fault plan, each with
its own copy of one clock: the same completions in the same order with the
same outcomes, retries, quarantines and rows (bit for bit), the same
``ServingMetrics`` report, registry snapshot and trace events, and the
same faults fired. The reference runs its plain twins (``use_pallas=False``,
bit-identical to its kernels); no tolerance. Last, the chaos property of
``tests/test_property_sssp.py`` on both packages with hypothesis.
"""
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.graphs import generators as JGen
from repro.kernels import config as jcfg
from repro.obs import Observability as JObs
from repro.obs import validate_events as j_validate_events
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DistCache as JCache
from repro.serving import ServerClosed as JServerClosed
from repro.serving import StaticBackend as JBackend
from repro.serving import backends as JB
from repro.serving import faults as JF
from repro.serving import resilience as JR
from repro_torch.core import from_coo
from repro_torch.core.graph import to_ell_in, to_ell_out, to_ell_out_sliced
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config as tcfg
from repro_torch.obs import Observability as TObs
from repro_torch.obs import validate_events as t_validate_events
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DistCache as TCache
from repro_torch.serving import StaticBackend as TBackend
from repro_torch.serving import backends as TB
from repro_torch.serving import faults as TF
from repro_torch.serving import resilience as TR
from repro_torch.serving.scheduler import ServerClosed

torch.set_num_threads(1)

REQ_FIELDS = ("req_id", "source", "target", "priority", "lane", "outcome",
              "phases", "cache_hit", "coalesced", "downgraded",
              "served_stale", "t_arrival", "t_admitted", "t_completed",
              "fail_reason", "retries", "not_before", "deadline")
CACHE_STATS = ("hits", "misses", "evictions", "corrupt_dropped",
               "stale_misses", "puts")
PKG = {
    "j": dict(F=JF, Backend=JBackend, Cache=JCache, Obs=JObs,
              Res=JR.ResilientBatcher, Batcher=JBatcher, B=JB, kcfg=jcfg),
    "t": dict(F=TF, Backend=TBackend, Cache=TCache, Obs=TObs,
              Res=TR.ResilientBatcher, Batcher=TBatcher, B=TB, kcfg=tcfg),
}


@pytest.fixture(scope="module")
def graphs():
    return {
        "gnp": (JGen.uniform_gnp(140, 8 / 140, seed=71),
                TGen.uniform_gnp(140, 8 / 140, seed=71, device="cpu")),
        "grid": (JGen.grid_road(9, 9, seed=2),
                 TGen.grid_road(9, 9, seed=2, device="cpu")),
    }


def _solo(gt, source, criterion="instatic|outstatic"):
    return TS.run_phased_static(gt, source, criterion=criterion,
                                device="cpu").dist.numpy()


# ---------------------------------------------------------------------------
# verify_row
# ---------------------------------------------------------------------------


def _corruptions(clean, source):
    """Every single-entry corruption of a finished row: NaN, negative,
    raised, lowered, zeroed (both signs) and de-infinitied, at every
    vertex, plus the source and a short row."""
    out = []
    for v in range(clean.shape[0]):
        x = clean[v]
        vals = [np.nan, -1.0, 0.0, -0.0]
        if np.isfinite(x):
            vals += [x + np.float32(0.5), x * np.float32(0.5),
                     np.nextafter(x, np.float32(np.inf))]
        else:
            vals += [7.0]
        for val in vals:
            bad = clean.copy()
            bad[v] = val
            out.append(bad)
    bad = clean.copy()
    bad[source] = 0.25
    out.append(bad)
    out.append(clean[:-1].copy())
    return out


def _verdicts_equal(gj, gt, row, source, target=None):
    want = JR.verify_row(gj, row, source, target=target)
    got = TR.verify_row(gt, row, source, target=target)
    assert got == want, (got, want)
    return got


@pytest.mark.parametrize("kind,sources", [("gnp", (0, 3, 17, 40)),
                                          ("grid", (0, 40))])
def test_verify_row_equals_the_reference(graphs, kind, sources):
    gj, gt = graphs[kind]
    rejected = 0
    for s in sources:
        clean = _solo(gt, s)
        assert _verdicts_equal(gj, gt, clean, s) is None
        for bad in _corruptions(clean, s):
            reason = _verdicts_equal(gj, gt, bad, s)
            if bad.shape == clean.shape and np.array_equal(
                    bad.view(np.int32), clean.view(np.int32)):
                continue  # a corruption that wrote the same bits
            if bad.shape == clean.shape and np.array_equal(bad, clean):
                continue  # -0 for +0: equal as values, certifiable
            assert reason is not None
            rejected += 1
            # point rows get the sanity prefix only
            _verdicts_equal(gj, gt, bad, s, target=int(s))
    assert rejected > 100


def test_verify_row_reasons_on_signed_zero_weights():
    """Weights on {+0, -0, 0.5, 1}: many vertices sit at distance ±0 and
    their min-in-edge is a tie of -0 and +0, which the port's scatter-min
    must break as ``np.minimum.at`` does (the later arc's sign)."""
    rng = np.random.default_rng(13)
    n, m = 90, 900
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.choice(np.array([0.0, -0.0, 0.5, 1.0], np.float32), m,
                   p=[0.3, 0.3, 0.2, 0.2])
    from repro.core.graph import from_coo as j_from_coo
    gj = j_from_coo(src, dst, w, n)
    gt = from_coo(src, dst, w, n, device="cpu")
    zeros_seen = 0
    for s in (0, 7, 31):
        clean = _solo(gt, s)
        assert _verdicts_equal(gj, gt, clean, s) is None
        zeros_seen += int((clean == 0).sum())
        for bad in _corruptions(clean, s):
            _verdicts_equal(gj, gt, bad, s)
    assert zeros_seen > 10
    # an engine row holds +0 only (+0 + -0 is +0), so the ties come from a
    # row whose zeros are -0 (equal by value: still certified); raising a
    # vertex at distance 0 then prints its tied min-in-edge, whose sign the
    # later arc decides
    signs = set()
    for s in (0, 7, 31):
        clean = _solo(gt, s)
        neg0 = clean.copy()
        neg0[(clean == 0) & (np.arange(n) != s)] = -0.0
        assert _verdicts_equal(gj, gt, neg0, s) is None
        for v in np.flatnonzero(clean == 0):
            if v == s:
                continue
            bad = neg0.copy()
            bad[v] = 1.0
            reason = _verdicts_equal(gj, gt, bad, s)
            signs.add(reason.split("min-in-edge ")[1].split(" ")[0])
    assert {"np.float32(0.0)", "np.float32(-0.0)"} <= signs


def test_verify_row_input_forms(graphs):
    gj, gt = graphs["gnp"]
    clean = _solo(gt, 3)
    ro = clean.copy()
    ro.flags.writeable = False  # a cached row is read-only
    assert TR.verify_row(gt, ro, 3) is None
    assert _verdicts_equal(gj, gt, clean.astype(np.float64), 3) is None
    bad = clean.astype(np.float64)
    bad[5] = -1e-60  # negative in f64, -0 in f32: the row as given decides
    assert _verdicts_equal(gj, gt, bad, 3) == "negative distance"
    assert _verdicts_equal(gj, gt, clean.reshape(1, -1), 3).startswith(
        "shape")
    # the verifier reads the graph's resident in-view, memoised on it
    cols, ws = gt.__dict__["_verify_edges"]
    assert cols.device == ws.device == gt.device
    assert cols is to_ell_in(gt)[0]
    loops = cols == torch.arange(gt.n, dtype=cols.dtype)[:, None]
    assert not bool(torch.isfinite(ws[loops]).any())


def _looped_graphs(seed):
    """Random arcs on weights {+0, -0, 0.5, 1}, self-loops of every
    weight among them (a zero-weight self-loop certifies any value)."""
    rng = np.random.default_rng(seed)
    n, m = 70, 700
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:20] = dst[:20]  # 20 self-loops up front, more at random
    w = rng.choice(np.array([0.0, -0.0, 0.5, 1.0], np.float32), m,
                   p=[0.3, 0.3, 0.2, 0.2])
    from repro.core.graph import from_coo as j_from_coo
    return j_from_coo(src, dst, w, n), from_coo(src, dst, w, n, device="cpu")


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_verify_row_over_either_resident_view(layout):
    """The verifier's in-view is the one the graph holds: a graph served
    on the sliced layout (its sliced out-view resident) gets the sliced
    in-view, never a padded copy. Its self-loops go to +inf with the index
    arrays shared; verdicts and reasons are the reference's either way."""
    gj, gt = _looped_graphs(29)
    s = 4
    clean = _solo(_looped_graphs(29)[1], s)  # solved on another copy
    if layout == "sliced":
        to_ell_out_sliced(gt)
    else:
        to_ell_out(gt)
    assert _verdicts_equal(gj, gt, clean, s) is None
    view = gt.__dict__["_verify_edges"]
    assert ("_ell_in_cache" in gt.__dict__) == (layout == "padded")
    if layout == "sliced":
        held = next(iter(gt.__dict__["_ell_in_sliced_cache"].values()))
        pairs = [(a.rows, a.cols, a.ws, b.cols)
                 for a, b in zip(view.slices, held.slices)]
    else:
        cols, ws = view
        pairs = [(torch.arange(gt.n, dtype=cols.dtype), cols, ws,
                  to_ell_in(gt)[0])]
    loops = 0
    for rows, cols, ws, held_cols in pairs:
        assert cols is held_cols
        at = cols == rows[:, None]
        loops += int(at.sum())
        assert not bool(torch.isfinite(ws[at]).any())
    assert loops >= 20
    rejected = 0
    for bad in _corruptions(clean, s):
        if _verdicts_equal(gj, gt, bad, s) is not None:
            rejected += 1
    assert rejected > 100


# ---------------------------------------------------------------------------
# ResilientBatcher on one fault script, both packages
# ---------------------------------------------------------------------------


class Clock:
    """Advances 0.25 on every call and by ``advance``: one per server."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


def _server(pkg, g, faults, *, seed=0, random_plan=None, lanes=2,
            cache=False, obs=True, clock="ticking",
            criterion="instatic|outstatic", point_queries=False,
            backend="static", resilient=True, **kw):
    """One package's server: ``faults`` are ``Fault`` argument tuples (or
    ``random_plan`` the keywords of ``FaultPlan.random(seed, ...)``)."""
    p = PKG[pkg]
    F = p["F"]
    if random_plan is not None:
        plan = F.FaultPlan.random(seed, **random_plan)
    else:
        plan = F.FaultPlan([F.Fault(*f) for f in faults], seed=seed)
    clk = Clock() if clock == "ticking" else F.VirtualClock()
    clock_fn = clk if clock == "ticking" else clk.now
    if backend == "static":
        bkw = dict(criterion=criterion, point_queries=point_queries)
        inner = (p["Backend"](g, use_pallas=False, **bkw) if pkg == "j"
                 else p["Backend"](g, device="cpu", **bkw))
    else:  # a pre-measured portfolio: routing runs, no probe
        led = p["kcfg"].TuningLedger()
        fam = p["B"].graph_family(g)
        p["kcfg"].record_portfolio(led, fam, lanes, "instatic|outstatic",
                                   "padded", wall_s=0.5, phases=10,
                                   queries=lanes)
        p["kcfg"].record_portfolio(led, fam, lanes, "delta", "sliced",
                                   wall_s=0.25, phases=20, queries=lanes,
                                   delta=0.3)
        cands = (p["B"].EngineCandidate("instatic|outstatic", "padded"),
                 p["B"].EngineCandidate("delta", "sliced"))
        bkw = dict(lanes_hint=lanes, candidates=cands, ledger=led,
                   point_queries=point_queries)
        if pkg == "j":
            bkw["use_pallas"] = False
        inner = p["B"].PortfolioBackend(g, **bkw)
    be = F.FaultyBackend(inner, plan, clock=clk)
    args = dict(kw, lanes=lanes, backend=be, clock=clock_fn,
                point_queries=point_queries)
    if cache:
        args["cache"] = F.FaultyDistCache(p["Cache"](), plan)
    if obs:
        args["obs"] = p["Obs"].enabled(clock=clock_fn)
    cls = p["Res"] if resilient else p["Batcher"]
    return cls(g, **args), clk


def _run(server, script):
    log = []
    for op in script:
        try:
            if op[0] == "submit":
                server.submit(op[1], **(op[2] if len(op) > 2 else {}))
                out = []
            elif op[0] == "step":
                out = server.step()
            elif op[0] == "drain":
                out = server.drain(max_steps=op[1] if len(op) > 1 else 5000)
            else:
                out = server.close()
        except (JF.InjectedFault, TF.InjectedFault, ServerClosed,
                JServerClosed) as e:
            out = [type(e).__name__]
        log.append(out)
    return log


def _view(r):
    return r if isinstance(r, str) else tuple(getattr(r, f)
                                              for f in REQ_FIELDS)


def _bits(a):
    return None if a is None else np.asarray(a).view(np.int32).tobytes()


def _served(gj, gt, script, faults, **kw):
    """Both packages' servers over one script; everything compared."""
    sj, cj = _server("j", gj, faults, **kw)
    st, ct = _server("t", gt, faults, **kw)
    lj, lt = _run(sj, script), _run(st, script)
    assert [[_view(r) for r in o] for o in lt] == \
        [[_view(r) for r in o] for o in lj]
    for oj, ot in zip(lj, lt):
        for a, b in zip(oj, ot):
            if not isinstance(a, str):
                assert _bits(b.dist) == _bits(a.dist)
    assert [_view(r) for r in st.completed] == [_view(r) for r in sj.completed]
    assert st.metrics.report() == sj.metrics.report()
    assert (st.busy_lanes, st.pending, st.idle, st.closed) == \
        (sj.busy_lanes, sj.pending, sj.idle, sj.closed)
    assert [(f.kind, f.at, f.lane) for f in st.backend.fired] == \
        [(f.kind, f.at, f.lane) for f in sj.backend.fired]
    assert st.backend.steps_taken == sj.backend.steps_taken
    assert ct.now() == cj.now()
    if isinstance(st, TR.ResilientBatcher):
        assert st._lane_disabled == sj._lane_disabled
        assert st._lane_rejects == sj._lane_rejects
    if st.cache is not None:
        assert [getattr(st.cache, f) for f in CACHE_STATS] == \
            [getattr(sj.cache, f) for f in CACHE_STATS]
        assert st.cache.poisoned == sj.cache.poisoned
        assert {k: _bits(e.row) for k, e in st.cache._d.items()} == \
            {k: _bits(e.row) for k, e in sj.cache._d.items()}
    if st.obs is not None:
        assert st.obs.registry.snapshot() == sj.obs.registry.snapshot()
        assert st.obs.registry.to_prometheus() == \
            sj.obs.registry.to_prometheus()
        events = st.obs.tracer.events()
        assert events == sj.obs.tracer.events()
        assert t_validate_events(events) == []
        assert j_validate_events(events) == []
    return st, lt


def _submits(sources, **kw):
    return [("submit", int(s), kw) for s in sources]


CASES = {
    # name: (graph, faults, plan seed, script, server kwargs)
    "row_corruption": (
        "gnp", [("row_nan", 0, 0), ("row_perturb", 0, 1, 2.0)], 3,
        _submits((0, 3)) + [("drain", 500)], dict(cache=True)),
    "budget_exhausted": (
        "gnp", [("row_nan", 0)] * 10, 4, _submits((0,)) + [("drain", 500)],
        dict(lanes=1, retry_budget=2)),
    "lane_retired": (
        "gnp", [("row_nan", 0, 0), ("row_nan", 0, 0)], 5,
        _submits((0,)) + [("drain", 500)],
        dict(retry_budget=5, quarantine_lane_after=2)),
    "step_failure": (
        "gnp", [("step_error", 1)], 6, _submits((0, 3)) + [("drain", 500)],
        dict(phases_per_step=4)),
    "stall_deadline": (
        "gnp", [("stall", 0, None, 10.0)], 0,
        _submits((0,)) + [("submit", 3, {"deadline": 5.0}), ("drain", 500)],
        dict(lanes=1, clock="virtual")),
    "late_delivery": (
        "gnp", [("stall", 0, None, 10.0)], 0,
        [("submit", 0, {"deadline": 5.0}), ("step",), ("drain", 500)],
        dict(lanes=1, clock="virtual")),
    "cache_poison": (
        "gnp", [("cache_poison", 0)], 8,
        _submits((0,)) + [("drain", 500)] + _submits((0,)) + [("drain", 500)],
        dict(lanes=1, cache=True)),
    "point_downgrade": (
        "gnp", [], 0, [("submit", 3, {"target": 17}), ("drain", 500)],
        dict(lanes=1, cache=True, point_queries=True)),
    "grid_chaos": (
        "grid", [("row_nan", 0, 1), ("step_error", 3), ("stall", 5, None, 2.0)],
        11, _submits(np.random.default_rng(0).integers(0, 81, 10))
        + [("drain", 1000)], dict(cache=True)),
    "every_kind_once": (
        "gnp", [("row_nan", 1, 0), ("row_neg", 2, 1), ("row_perturb", 3),
                ("step_error", 4), ("stall", 5, None, 1.5),
                ("cache_poison", 1)], 17,
        _submits((0, 3, 17, 40, 3, 99)) + [("step",), ("step",)]
        + _submits((0, 17, 120)) + [("drain", 1000)],
        dict(cache=True, lanes=3, phases_per_step=3)),
    "no_verify": (
        "gnp", [("row_neg", 0, 0)], 2, _submits((0, 3)) + [("drain", 500)],
        dict(verify=False, cache=True)),
    "close_with_parked_retries": (
        "gnp", [("row_nan", 0)] * 3, 9,
        _submits((0, 3, 17)) + [("step",)] * 3 + [("close",), ("step",)],
        dict(lanes=2, backoff_base=50.0, backoff_cap=100.0)),
    "in_out_points": (
        "grid", [("row_perturb", 1, None, 0.5), ("step_error", 2)], 12,
        [("submit", 0, {"target": 40}), ("submit", 5),
         ("submit", 0, {"target": 80}), ("drain", 1000)],
        dict(criterion="in|out", point_queries=True, cache=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_scripts_match_the_reference(graphs, case):
    graph, faults, seed, script, kw = CASES[case]
    gj, gt = graphs[graph]
    st, lt = _served(gj, gt, script, faults, seed=seed, **kw)
    crit = kw.get("criterion", "instatic|outstatic")
    served = [r for o in lt for r in o if not isinstance(r, str)]
    for r in served:
        if r.outcome == "ok":
            want = _solo(gt, r.source, crit)
            if case == "no_verify" and r.dist.view(np.int32).tobytes() != \
                    want.view(np.int32).tobytes():
                continue  # without verification a corrupted row gets out
            np.testing.assert_array_equal(r.dist.view(np.int32),
                                          want.view(np.int32))
    if case == "budget_exhausted":
        (req,) = served
        assert req.outcome == "failed" and req.retries == 2
        assert st.metrics.quarantines == 3 and req.dist is None
    if case == "lane_retired":
        assert st._lane_disabled[0] and served[0].lane != 0
    if case == "step_failure":
        assert st.metrics.engine_failures == 1
    if case == "stall_deadline":
        assert {r.source: r.outcome for r in served} == {0: "ok",
                                                         3: "deadline"}
    if case == "cache_poison":
        assert st.cache.poisoned and st.cache.corrupt_dropped == 1
    if case == "every_kind_once":
        assert {f.kind for f in st.backend.fired} | (
            {"cache_poison"} if st.cache.poisoned else set()) == \
            set(TF.FAULT_KINDS)
        assert {r.outcome for r in served} == {"ok"}
        assert st.metrics.quarantines == 3 and \
            st.metrics.engine_failures == 1
    if case == "close_with_parked_retries":
        assert lt[-1] == ["ServerClosed"]
        assert any(r.outcome == "shed" for r in lt[-2])
    if case == "point_downgrade":
        (pt,) = served
        assert pt.downgraded and pt.distance == float(_solo(gt, 3)[17])


@pytest.mark.parametrize("graph,crit", [("gnp", "instatic|outstatic"),
                                        ("grid", "in|out")])
def test_an_empty_plan_serves_like_the_plain_batcher(graphs, graph, crit):
    """No faults: the verified server's completions, rows and steps are the
    plain ``ContinuousBatcher``'s (both packages, one script)."""
    gj, gt = graphs[graph]
    srcs = np.random.default_rng(5).integers(0, gt.n, 12)
    script = _submits(srcs[:6]) + [("step",)] + _submits(srcs[6:]) + \
        [("drain", 2000)]
    st, lt = _served(gj, gt, script, [], cache=True, lanes=3,
                     criterion=crit)
    plain, _ = _server("t", gt, [], cache=True, lanes=3, criterion=crit,
                       resilient=False)
    lp = _run(plain, script)
    assert [[_view(r) for r in o] for o in lp] == \
        [[_view(r) for r in o] for o in lt]
    for op, ot in zip(lp, lt):
        for a, b in zip(op, ot):
            assert _bits(a.dist) == _bits(b.dist)
    assert plain.metrics.steps == st.metrics.steps
    assert plain.metrics.report() == st.metrics.report()


# ---------------------------------------------------------------------------
# chaos: random fault plans, both packages (after test_property_sssp.py)
# ---------------------------------------------------------------------------

_CHAOS = {}


def _chaos_graphs():
    if not _CHAOS:
        _CHAOS["g"] = (JGen.uniform_gnp(60, 7.0 / 60, seed=91),
                       TGen.uniform_gnp(60, 7.0 / 60, seed=91, device="cpu"))
        _CHAOS["rows"] = {}
    return _CHAOS["g"]


def _chaos_row(source):
    rows = _CHAOS["rows"]
    if source not in rows:
        rows[source] = _solo(_CHAOS["g"][1], source)
    return rows[source]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 20), b=st.integers(1, 4),
       backend_kind=st.sampled_from(["static", "portfolio"]),
       n_faults=st.integers(1, 6))
def test_chaos_serving_matches_the_reference(seed, b, backend_kind,
                                             n_faults):
    """Random fault plans x {Static,Portfolio} backends x lane counts x
    mixed point/full traffic: both packages serve alike, every request
    completes bit-exact against the fault-free solve, retry amplification
    is bounded by the faults that fired, and no corrupted row sits in the
    cache with a valid checksum."""
    gj, gt = _chaos_graphs()
    servers = []
    for pkg, g in (("j", gj), ("t", gt)):
        server, clk = _server(
            pkg, g, (), seed=seed,
            random_plan=dict(n_faults=n_faults, horizon=30, lanes=b),
            lanes=b, clock="virtual", backend=backend_kind,
            point_queries=True, cache=True, obs=False,
            retry_budget=max(6, n_faults))
        rng = np.random.default_rng(seed)
        reqs = []
        for i in range(10):
            s = int(rng.integers(0, g.n))
            t = int(rng.integers(0, g.n)) if i % 3 == 0 else None
            reqs.append(server.submit(s, target=t))
        server.drain(max_steps=2000)
        servers.append((server, clk, reqs))
    (sj, cj, rj), (st_, ct, rt) = servers
    assert [_view(r) for r in rt] == [_view(r) for r in rj]
    assert st_.metrics.report() == sj.metrics.report()
    assert ct.now() == cj.now()
    for r in rt:
        assert r.outcome == "ok", (r.fail_reason, st_.backend.plan.faults)
        np.testing.assert_array_equal(r.dist.view(np.int32),
                                      _chaos_row(r.source).view(np.int32))
        if r.target is not None:
            assert r.downgraded
            assert r.distance == float(_chaos_row(r.source)[r.target])
    fired = st_.backend.fired
    bound = sum(b if f.kind == "step_error" else 1
                for f in fired if f.kind != "stall")
    assert st_.metrics.retries <= bound
    assert st_.metrics.quarantines == sum(
        1 for f in fired if f.kind.startswith("row_"))
    assert st_.metrics.engine_failures == sum(
        1 for f in fired if f.kind == "step_error")
    assert ct.now() == pytest.approx(sum(
        f.magnitude for f in fired if f.kind == "stall"))
    cache = st_.cache
    for (_, _, source), e in cache._d.items():
        if zlib.crc32(e.row.tobytes()) == e.crc:
            np.testing.assert_array_equal(e.row, _chaos_row(source))
    for key in list(cache._d):
        got = cache.get(*key, now=ct.now())
        if got is not None:
            np.testing.assert_array_equal(got, _chaos_row(key[2]))
