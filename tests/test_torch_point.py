"""s->t point queries in the port against the JAX reference, bit for bit.

Target lanes in the stepper (validation, reset semantics, the early exit
and the bound-gated relax, with ``relax_edges`` counting only the gated
sources), ``interop`` with target lanes, ``PointBackend`` /
``run_point_to_point`` (every ``PointResult`` field), and the batcher's
point paths (capability, cached full rows serving point hits, point rows
never cached, coalescing onto an in-flight full solve, mixed traffic).
The reference runs its plain twins (``use_pallas=False``); no tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import from_coo as j_from_coo
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DistCache as JCache
from repro.serving import PointBackend as JPoint
from repro.serving import StaticBackend as JBackend
from repro.serving import point as JPointMod
from repro_torch import interop
from repro_torch.core import from_coo as t_from_coo
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as kops
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DistCache as TCache
from repro_torch.serving import PointBackend as TPoint
from repro_torch.serving import StaticBackend as TBackend
from repro_torch.serving import point as TPointMod
from repro_torch.serving import run_point_to_point

torch.set_num_threads(1)

K = TS.KEEP_LANE
E = TS.EMPTY_LANE
PLANS = ["instatic|outstatic", "in|out"]
LAYOUTS = ["padded", "sliced"]
POINT_FIELDS = ("source", "target", "distance", "phases_forward",
                "phases_backward", "mu", "meeting_vertex",
                "unreachable_certified")


@pytest.fixture(scope="module")
def graphs():
    """(reference, port) pairs: a gnp, a road grid and the island graph
    (a gnp plus 4 edge-free vertices: targets no path reaches)."""
    out = {
        "gnp": (JGen.uniform_gnp(96, 8.0 / 96, seed=5),
                TGen.uniform_gnp(96, 8.0 / 96, seed=5, device="cpu")),
        "grid": (JGen.grid_road(8, 9, seed=6),
                 TGen.grid_road(8, 9, seed=6, device="cpu")),
    }
    base = JGen.uniform_gnp(256, 10.0 / 256, seed=7)
    coo = (np.array(base.src, np.int64), np.array(base.dst, np.int64),
           np.array(base.w, np.float32))
    out["island"] = (j_from_coo(*coo, 260), t_from_coo(*coo, 260,
                                                        device="cpu"))
    return out


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def assert_states_equal(sj, st):
    """Every field the port carries: dist, status, trips, phases, both
    counters (the reference's two limbs combined), the carried keys, the
    ring and the targets."""
    for f in ("dist", "status", "trips", "phases", "settled_trace",
              "target", "crit_keys"):
        w, g = getattr(sj, f), getattr(st, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            assert_bits(w, g)
    hj, ht = JS.harvest(sj), TS.harvest(st)
    for f in ("sum_fringe", "relax_edges"):
        np.testing.assert_array_equal(getattr(hj, f), getattr(ht, f))
    assert (sj.keys_valid is None) == (st.keys_valid is None)
    if st.keys_valid is not None:
        assert bool(sj.keys_valid) == st.keys_valid


def _state_fields(st):
    """A reference BatchState as the numpy dict interop reads."""
    return {f.name: (st.criterion if f.name == "criterion"
                     else None if getattr(st, f.name) is None
                     else np.asarray(getattr(st, f.name)))
            for f in dataclasses.fields(st)}


# ---------------------------------------------------------------------------
# target lanes in the stepper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call,msg", [
    (lambda M, g, kw: M.init_batch_state(g, [0], targets=[g.n], **kw),
     r"in \[0, "),
    (lambda M, g, kw: M.init_batch_state(g, [0, 1], targets=[3], **kw),
     r"shape \(2,\)"),
    (lambda M, g, kw: M.reset_lanes(M.init_batch_state(g, [0, 1], **kw),
                                    [2, K], targets=[5, -1]),
     "without target lanes"),
    (lambda M, g, kw: M.reset_lane(M.init_batch_state(g, [0, 1], **kw),
                                   0, 2, target=5),
     "without target lanes"),
    (lambda M, g, kw: M.reset_lane(M.init_batch_state(g, [0], targets=[7],
                                                      **kw), 0, 2, target=g.n),
     "target must be"),
    (lambda M, g, kw: M.reset_lanes(
        M.init_batch_state(g, [0, 1], targets=[7, 8], **kw), [2, K],
        targets=[-2, 3]),
     "full-solve lane"),
])
def test_target_validation_matches_reference(graphs, call, msg):
    gj, gt = graphs["gnp"]
    for mod, g, kw in ((JS, gj, {}), (TS, gt, {"device": "cpu"})):
        with pytest.raises(ValueError, match=msg):
            call(mod, g, kw)


def test_reset_lanes_target_semantics_match_reference(graphs):
    """KEEP_LANE lanes keep their target; touched lanes default to a full
    solve unless the reset assigns one; reset_lane sets one lane's."""
    gj, gt = graphs["gnp"]
    ops = [("lanes", [K, 2], None), ("lanes", [3, K], [30, -1]),
           ("lane", 1, 4, 40), ("lane", 0, E, E), ("lanes", [5, 6], [60, 61])]
    sj = JS.init_batch_state(gj, [0, 1], targets=np.array([10, 20], np.int32))
    st = TS.init_batch_state(gt, [0, 1], targets=[10, 20], device="cpu")
    assert st.target.dtype == torch.int32
    for op in ops:
        if op[0] == "lanes":
            sj = JS.reset_lanes(sj, op[1], targets=op[2])
            st = TS.reset_lanes(st, op[1], targets=op[2])
        else:
            sj = JS.reset_lane(sj, op[1], op[2], target=op[3])
            st = TS.reset_lane(st, op[1], op[2], target=op[3])
        assert_states_equal(sj, st)


def test_target_free_state_is_the_pre_target_program(graphs):
    """targets=None keeps ``target`` absent, and all-(-1) targets solve
    bitwise as no targets at all."""
    _, gt = graphs["gnp"]
    plain = TS.run_phased_static_batch(gt, [3, 41], device="cpu")
    alloff = TS.run_phased_static_batch(gt, [3, 41], targets=[-1, -1],
                                        device="cpu")
    assert plain.target is None and alloff.target.tolist() == [-1, -1]
    for f in ("dist", "status", "phases", "total_phases"):
        assert_bits(getattr(plain, f), getattr(alloff, f))
    np.testing.assert_array_equal(plain.relax_edges, alloff.relax_edges)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("criterion", PLANS)
@pytest.mark.parametrize("graph", ["gnp", "grid"])
def test_target_lanes_match_reference_chunk_by_chunk(graphs, graph,
                                                     criterion, layout):
    """The early exit and the gated relax, chunk by chunk with admissions:
    every state field equal after every call, relax_edges included."""
    gj, gt = graphs[graph]
    n = gt.n
    rng = np.random.default_rng(17)
    s0 = rng.integers(0, n, 4)
    t0 = np.array([rng.integers(0, n), -1, s0[2], rng.integers(0, n)])
    ell_j = (JS.to_ell_in_sliced(gj) if layout == "sliced"
             else JS.to_ell_in(gj))
    ell_t = (TS.to_ell_in_sliced(gt) if layout == "sliced"
             else TS.to_ell_in(gt))
    sj = JS.init_batch_state(gj, s0, criterion=criterion, trace_len=8,
                             targets=t0)
    st = TS.init_batch_state(gt, s0, criterion=criterion, trace_len=8,
                             targets=t0, device="cpu")
    schedule = [("step", 3, False), ("reset", [K, 5, K, E], [K, 7, K, E]),
                ("step", 4, True), ("step", 2, False),
                ("reset", [int(rng.integers(0, n)), K, K, 9], [n - 1, K, K, -1]),
                ("step", n + 1, False)]
    for op in schedule:
        if op[0] == "step":
            sj = JS.step_batch(gj, sj, op[1], ell=ell_j, use_pallas=False,
                               stop_on_lane_finish=op[2])
            st = TS.step_batch(gt, st, op[1], ell=ell_t,
                               stop_on_lane_finish=op[2])
        else:
            tg = np.where(np.array(op[2]) == K, -1, op[2])
            sj = JS.reset_lanes(sj, op[1], targets=tg)
            st = TS.reset_lanes(st, op[1], targets=tg)
        assert_states_equal(sj, st)
    assert not TS.lanes_active(st).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_shot_fronts_with_targets_match_reference(graphs, layout):
    gj, gt = graphs["gnp"]
    for s, t in [(0, 57), (12, 12), (88, 3)]:
        want = JS.run_phased_static(gj, s, target=t, layout=layout,
                                    use_pallas=False)
        got = TS.run_phased_static(gt, s, target=t, layout=layout,
                                   device="cpu")
        for f in ("dist", "status", "phases", "sum_fringe", "relax_edges",
                  "settled_per_phase"):
            assert_bits(getattr(want, f), getattr(got, f))
    srcs, tgts = [0, 12, 88], [57, 12, 3]
    want = JS.run_phased_static_batch(gj, srcs, targets=tgts, layout=layout,
                                      use_pallas=False)
    got = TS.run_phased_static_batch(gt, srcs, targets=tgts, layout=layout,
                                     device="cpu")
    for f in ("dist", "status", "phases", "total_phases", "target"):
        assert_bits(getattr(want, f), getattr(got, f))
    np.testing.assert_array_equal(want.relax_edges, got.relax_edges)
    full = TS.run_phased_static_batch(gt, srcs, layout=layout, device="cpu")
    # the bound saves relax work and never changes dist[target]
    assert (got.relax_edges <= full.relax_edges).all()
    assert (got.relax_edges < full.relax_edges).any()
    for i, t in enumerate(tgts):
        assert_bits(full.dist[i, t], got.dist[i, t])


def test_target_lane_is_a_fixed_point_after_its_exit(graphs):
    _, gt = graphs["gnp"]
    st = TS.init_batch_state(gt, [0], targets=[57], device="cpu")
    while TS.lanes_active(st).any():
        st = TS.step_batch(gt, st, 1)
    after = TS.step_batch(gt, st, 5)
    for f in ("dist", "status", "phases", "trips", "relax_edges"):
        assert_bits(getattr(st, f), getattr(after, f))


def test_interop_carries_target_lanes(graphs):
    """A JAX state with target lanes, mid-solve, continues in the port bit
    for bit."""
    gj, gt = graphs["grid"]
    sj = JS.init_batch_state(gj, [0, 5, 70], criterion="in|out",
                             targets=np.array([71, -1, 2], np.int32))
    sj = JS.step_batch(gj, sj, 3, use_pallas=False)
    st = interop.state_from_numpy(_state_fields(sj), device="cpu")
    assert_states_equal(sj, st)
    sj = JS.reset_lanes(sj, [K, 9, K], targets=[-1, 40, -1])
    st = TS.reset_lanes(st, [K, 9, K], targets=[-1, 40, -1])
    sj = JS.step_batch(gj, sj, gt.n + 1, use_pallas=False)
    st = TS.step_batch(gt, st, gt.n + 1)
    assert_states_equal(sj, st)


def test_gated_wrappers_equal_the_plain_ones_on_the_gated_mask():
    rng = np.random.default_rng(3)
    g = TGen.uniform_gnp(120, 0.06, seed=9, device="cpu")
    d = torch.from_numpy(rng.uniform(0, 2, (3, g.n)).astype(np.float32))
    settle = torch.from_numpy(rng.random((3, g.n)) < 0.3)
    bound = torch.tensor([0.7, float("inf"), 1.2])
    gated = kops._bound_gate(d, settle, bound)
    assert gated.sum() < settle.sum() and gated[1].equal(settle[1])
    cols, ws = TS.to_ell_out(g)
    want = kops.push_settled_batch(d, gated, cols, ws)
    for got in (kops.push_settled_gated_batch(d, settle, bound, cols, ws),
                kops.push_settled_gated_batch_sliced(
                    d, settle, bound, TS.to_ell_out_sliced(g)),
                kops.relax_settled_gated_batch(d, settle, bound,
                                               TS.to_ell_in(g)),
                kops.relax_settled_gated_batch(d, settle, bound,
                                               TS.to_ell_in_sliced(g))):
        assert_bits(want, got)


# ---------------------------------------------------------------------------
# PointBackend / run_point_to_point
# ---------------------------------------------------------------------------


def _assert_points_equal(want, got):
    for f in POINT_FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    assert_bits(want.dist, got.dist)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("criterion,layout", [
    ("instatic|outstatic", "padded"), ("in|out", "padded"),
    ("instatic|outstatic", "sliced"), ("in|out", "sliced")])
def test_point_results_match_reference(graphs, criterion, layout,
                                       bidirectional):
    gj, gt = graphs["gnp"]
    kw = dict(criterion=criterion, layout=layout, bidirectional=bidirectional,
              phases_per_chunk=2)
    jb = JPoint(gj, use_pallas=False, **kw)
    tb = TPoint(gt, device="cpu", **kw)
    for s, t in np.random.default_rng(11).integers(0, gt.n, (4, 2)):
        _assert_points_equal(jb.query(s, t), tb.query(s, t))


def test_island_graph_certifies_unreachable_like_reference(graphs):
    gj, gt = graphs["island"]
    got = []
    for s, t in [(0, 258), (3, 257), (259, 0)]:
        want = JPoint(gj, phases_per_chunk=4, use_pallas=False).query(s, t)
        got.append(TPoint(gt, phases_per_chunk=4, device="cpu").query(s, t))
        _assert_points_equal(want, got[-1])
    # an edge-free target's in-ball is empty: certified before the flood
    assert got[0].distance == float("inf") and got[0].unreachable_certified
    assert not got[2].unreachable_certified  # an edge-free source ends first


@pytest.mark.parametrize("df,db", [
    ([1.0, 0.5, 2.0, 0.5], [0.5, 1.0, 0.0, 1.0]),  # ties: first minimum
    ([np.inf] * 5, [np.inf] * 5),  # all +inf: vertex 0
    ([np.inf, 2.0, np.inf], [1.0, np.inf, 3.0]),  # all +inf sums
    ([0.0, -0.0, 0.0], [-0.0, -0.0, 0.0]),  # signed zeros compare equal
    ([3.0, 1.0, 2.0, 1.0], [0.0, 2.0, 1.0, 1.0]),  # three-way tie
])
def test_meeting_vertex_is_jax_argmin(df, db):
    df = np.array([df], np.float32)
    db = np.array([db], np.float32)
    m, v = JPointMod._meet(jnp.asarray(df), jnp.asarray(db))
    got = TPointMod._meet(torch.from_numpy(df), torch.from_numpy(db))
    assert got == (float(m), int(v))
    assert np.signbit(got[0]) == np.signbit(float(m))  # mu's bits too
    # and torch.argmin agrees with the first-index rule on the CPU
    assert int(torch.argmin(torch.from_numpy(df[0] + db[0]))) == int(v)


def _tensors(view):
    """Every tensor of a padded ``(cols, ws)`` pair or a SlicedEll."""
    if isinstance(view, torch.Tensor):
        return [view]
    if isinstance(view, (tuple, list)):
        return [t for v in view for t in _tensors(v)]
    return []


@pytest.mark.parametrize("layout", LAYOUTS)
def test_transpose_views_are_the_forward_views_swapped(layout):
    from repro_torch.core.graph import Graph
    g = TGen.uniform_gnp(150, 0.05, seed=13, device="cpu")
    views = ((TS.to_ell_in_sliced, TS.to_ell_out_sliced)
             if layout == "sliced" else (TS.to_ell_in, TS.to_ell_out))
    gt = TPointMod.transpose_memo(g)
    assert TPointMod.transpose_memo(g) is gt
    # the reverse graph built with memos of its own: what gt would build
    fresh = Graph(n=g.n, m=g.m, src=g.dst, dst=g.src, w=g.w,
                  in_min_static=g.out_min_static,
                  out_min_static=g.in_min_static)
    fwd_in, fwd_out = views
    for bwd_view, fwd_view in ((fwd_in, fwd_out), (fwd_out, fwd_in)):
        shared = bwd_view(gt)
        assert shared is fwd_view(g)  # one copy, memoised once
        want = bwd_view(fresh)
        assert type(want) is type(shared)
        if layout == "sliced":
            assert (want.merge_multi, want.split_rows) == \
                (shared.merge_multi, shared.split_rows)
        pairs = list(zip(_tensors(want), _tensors(shared)))
        assert pairs and len(pairs) == len(_tensors(want))
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_run_point_to_point_memoises_and_validates(graphs):
    _, gt = graphs["gnp"]
    gt.__dict__.pop("_point_backends", None)
    run_point_to_point(gt, 0, 1, device="cpu")
    run_point_to_point(gt, 2, 3, device="cpu")
    assert len(gt.__dict__["_point_backends"]) == 1
    run_point_to_point(gt, 0, 1, layout="sliced", device="cpu")
    assert len(gt.__dict__["_point_backends"]) == 2
    b = TPoint(gt, device="cpu")
    with pytest.raises(ValueError, match="target must be"):
        b.query(0, gt.n)
    with pytest.raises(ValueError, match="source must be"):
        b.query(-1, 0)
    with pytest.raises(ValueError, match="layout"):
        TPoint(gt, layout="mosaic", device="cpu")
    # delta-stepping answers s->t queries as the reference's backend does
    gj = graphs["gnp"][0]
    want = JPoint(gj, policy="delta", use_pallas=False).query(0, 1)
    got = TPoint(gt, policy="delta", device="cpu").query(0, 1)
    assert np.float32(got.distance).view(np.int32) == \
        np.float32(want.distance).view(np.int32)
    assert (got.phases_forward, got.phases_backward) == \
        (want.phases_forward, want.phases_backward)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TPoint(gt)


# ---------------------------------------------------------------------------
# the batcher's point paths
# ---------------------------------------------------------------------------


class Clock:
    """A clock that advances a fixed step on every call: both packages'
    batchers get one each, so equal timings mean equal clock calls."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _serve_both(gj, gt, script, **kw):
    """Run one script of ("submit", source, target) / ("step",) /
    ("drain",) on both batchers; returns both servers and each one's
    retired requests in order."""
    sj = JBatcher(gj, use_pallas=False, clock=Clock(),
                  cache=None if kw.get("cache") is None else JCache(),
                  **{k: v for k, v in kw.items() if k != "cache"})
    st = TBatcher(gt, clock=Clock(),
                  cache=None if kw.get("cache") is None else TCache(),
                  **{k: v for k, v in kw.items() if k != "cache"})
    done = ([], [])
    for op in script:
        for i, srv in enumerate((sj, st)):
            if op[0] == "submit":
                srv.submit(op[1], target=op[2])
            elif op[0] == "step":
                done[i].extend(srv.step())
            else:
                done[i].extend(srv.drain(max_steps=10_000))
    return sj, st, done


def _assert_served_equal(sj, st, done):
    wj, wt = done
    assert [(r.req_id, r.lane, r.outcome, r.phases, r.cache_hit, r.coalesced,
             r.downgraded, r.t_admitted, r.t_completed) for r in wj] == \
        [(r.req_id, r.lane, r.outcome, r.phases, r.cache_hit, r.coalesced,
          r.downgraded, r.t_admitted, r.t_completed) for r in wt]
    for a, b in zip(wj, wt):
        assert_bits(a.dist, b.dist)
        assert a.distance == b.distance
    assert sj.metrics.report() == st.metrics.report()


def test_server_requires_point_capability(graphs):
    _, gt = graphs["gnp"]
    server = TBatcher(gt, lanes=2)
    with pytest.raises(ValueError, match="point_queries=True"):
        server.submit(0, target=5)
    with pytest.raises(ValueError, match="point-capable backend"):
        TBatcher(gt, point_queries=True,
                 backend=TBackend(gt, device="cpu"))


@pytest.mark.parametrize("name,script,kw", [
    # a cached full row serves a point hit with no engine work
    ("cached_full_row", [("submit", 7, None), ("drain",), ("submit", 7, 33),
                         ("drain",)], dict(lanes=2, cache=True)),
    # a cold point row is never cached: the next full query re-solves, and
    # then ITS row serves point hits
    ("point_rows_never_cached", [("submit", 9, 50), ("drain",),
                                 ("submit", 9, None), ("drain",),
                                 ("submit", 9, 50), ("drain",)],
     dict(lanes=2, cache=True)),
    # a point query for a source already solving in full rides along
    ("coalesce_onto_full", [("submit", 13, None), ("step",),
                            ("submit", 13, 60), ("drain",)],
     dict(lanes=1, cache=True, phases_per_step=1)),
    # the downgrade under backlog: a full, cacheable row answers it
    ("downgrade", [("submit", 0, None), ("submit", 3, 17), ("drain",),
                   ("submit", 3, None), ("drain",)],
     dict(lanes=1, cache=True, point_downgrade_backlog=1)),
])
def test_point_serving_paths_match_reference(graphs, name, script, kw):
    gj, gt = graphs["gnp"]
    sj, st, done = _serve_both(gj, gt, script, point_queries=True, **kw)
    _assert_served_equal(sj, st, done)
    wt = done[1]
    if name == "cached_full_row":
        assert wt[-1].cache_hit and wt[-1].phases == 0
    elif name == "point_rows_never_cached":
        assert [r.cache_hit for r in wt] == [False, False, True]
        assert len(st.cache) == 1
    elif name == "coalesce_onto_full":
        assert wt[-1].coalesced and wt[-1].target == 60
    else:
        (pt,) = [r for r in wt if r.target == 17]
        assert pt.downgraded and pt.effective_target is None
        assert wt[-1].cache_hit and st.metrics.downgraded == 1


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("criterion", PLANS)
def test_mixed_full_and_point_traffic_matches_reference(graphs, criterion,
                                                        layout):
    gj, gt = graphs["grid"]
    rng = np.random.default_rng(23)
    script = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 5))):
            s = int(rng.integers(0, gt.n))
            t = int(rng.integers(0, gt.n)) if rng.integers(0, 2) else None
            script.append(("submit", s, t))
        script.append(("step",))
    script.append(("drain",))
    bj = JBackend(gj, use_pallas=False, criterion=criterion, layout=layout,
                  point_queries=True)
    bt = TBackend(gt, criterion=criterion, layout=layout, point_queries=True,
                  device="cpu")
    sj = JBatcher(gj, lanes=3, phases_per_step=3, backend=bj, clock=Clock(),
                  cache=JCache(), point_queries=True)
    st = TBatcher(gt, lanes=3, phases_per_step=3, backend=bt, clock=Clock(),
                  cache=TCache(), point_queries=True)
    done = ([], [])
    for op in script:
        for i, srv in enumerate((sj, st)):
            if op[0] == "submit":
                srv.submit(op[1], target=op[2])
            else:
                done[i].extend(srv.step() if op[0] == "step"
                               else srv.drain(max_steps=10_000))
    assert len(done[1]) == sum(op[0] == "submit" for op in script)
    _assert_served_equal(sj, st, done)
    full = {}
    for r in done[1]:
        if r.target is not None and not r.cache_hit and not r.coalesced:
            if r.source not in full:
                full[r.source] = TS.run_phased_static(
                    gt, r.source, criterion=criterion, device="cpu").dist
            assert float(full[r.source][r.target]) == r.distance
