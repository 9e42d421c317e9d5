"""The port's delta-stepping against the JAX reference, bit for bit.

``weight_gated_ell`` and ``delta_relax_batch`` against the reference's ops
(``use_pallas=False``), the ``"delta"`` stepper policy against the
reference's on every ``BatchedResult`` field (B = 1, 3, 5, both layouts,
the reference test's bucket widths), the port's own legacy loop
``run_delta_stepping`` against both, the input checks, serving, and a
reference state continued by the port.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_stepping as JD
from repro.core import from_coo as j_from_coo
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import ops as jops
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import StaticBackend as JBackend
from repro_torch import interop
from repro_torch.core import delta_stepping as TD
from repro_torch.core import from_coo as t_from_coo
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as tops
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import StaticBackend as TBackend

torch.set_num_threads(1)

DELTAS = [0.05, 0.35, None, 50.0]  # None -> default_delta(g)
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase", "fringe_per_phase",
                 "relax_per_phase", "settle_attribution")


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(want, got):
    want, got = _bits(want), _bits(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(want, got)


def assert_results_equal(want, got):
    for f in RESULT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            assert_bits(w, g)


@pytest.fixture(scope="module", params=["gnp", "kron"])
def graphs(request):
    if request.param == "gnp":
        return (JGen.uniform_gnp(96, 8.0 / 96, seed=5),
                TGen.uniform_gnp(96, 8.0 / 96, seed=5, device="cpu"))
    return (JGen.kronecker(6, seed=5),
            TGen.kronecker(6, seed=5, device="cpu"))


def _ells(gj, gt, layout):
    if layout == "sliced":
        return JS.to_ell_in_sliced(gj), TS.to_ell_in_sliced(gt)
    return JS.to_ell_in(gj), TS.to_ell_in(gt)


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


# ---------------------------------------------------------------------------
# the ops layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_weight_gated_ell_matches_reference(layout):
    gj, gt = _tenth_grid(seed=1)
    ej, et = _ells(gj, gt, layout)
    for delta in (0.1, 0.3, 0.25):  # w == delta ties at 0.1 and 0.3
        dj = jnp.float32(delta)
        dt = torch.tensor(delta, dtype=torch.float32)
        for vj, vt in zip(jops.weight_gated_ell(ej, dj),
                          tops.weight_gated_ell(et, dt)):
            if layout == "padded":
                assert vt[0] is et[0]  # the ids are the view's own
                assert_bits(vj[1], vt[1])
                continue
            assert vt.merge_idx is et.merge_idx
            assert vt.row_owner is et.row_owner
            for sj, st, s0 in zip(vj.slices, vt.slices, et.slices):
                assert st.cols is s0.cols and st.rows is s0.rows
                assert_bits(sj.ws, st.ws)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_delta_relax_batch_matches_reference(graphs, layout, use_kernels):
    gj, gt = graphs
    ej, et = _ells(gj, gt, layout)
    rng = np.random.default_rng(2)
    b, n = 3, gt.n
    d = rng.uniform(0, 2, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.3] = np.inf
    light = rng.random((b, n)) < 0.2
    heavy = rng.random((b, n)) < 0.2
    heavy[0] = False  # a lane on a light round: an all-+inf heavy gate
    light[1] = False
    delta = np.float32(0.2)
    lj, hj = jops.weight_gated_ell(ej, jnp.float32(delta))
    lt, ht = tops.weight_gated_ell(et, torch.tensor(delta))
    want = jops.delta_relax_batch(jnp.asarray(d), jnp.asarray(light),
                                  jnp.asarray(heavy), lj, hj,
                                  use_pallas=False)
    got = tops.delta_relax_batch(torch.from_numpy(d), torch.from_numpy(light),
                                 torch.from_numpy(heavy), lt, ht,
                                 use_kernels=use_kernels)
    assert_bits(want, got)


def test_default_delta_matches_reference(graphs):
    gj, gt = graphs
    assert TD.default_delta(gt) == JD.default_delta(gj)
    assert isinstance(TD.default_delta(gt), float)


# ---------------------------------------------------------------------------
# the stepper policy and the legacy loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("b", [1, 3, 5])
def test_delta_solves_match_reference(graphs, layout, b):
    gj, gt = graphs
    ej, et = _ells(gj, gt, layout)
    srcs = [(7 * i + 2) % gt.n for i in range(b)]
    default = None
    for delta in DELTAS:
        want = JS.run_phased_static_batch(
            gj, srcs, ell=ej, criterion="delta", delta=delta,
            use_pallas=False, trace_len=4 * gt.n + 16, telemetry=b == 3)
        got = TS.run_phased_static_batch(
            gt, srcs, ell=et, criterion="delta", delta=delta,
            trace_len=4 * gt.n + 16, telemetry=b == 3, device="cpu")
        assert_results_equal(want, got)
        default = got if delta is None else default
    # each row at the default width against the port's own legacy loop
    for i, s in enumerate(srcs):
        leg = TD.run_delta_stepping(gt, s, device="cpu")
        assert_bits(leg.dist, default.dist[i])
        assert int(leg.phases) == int(default.phases[i])


@pytest.mark.parametrize("delta", DELTAS)
def test_legacy_loop_matches_reference_and_the_stepper(graphs, delta):
    gj, gt = graphs
    dl = float(delta) if delta is not None else TD.default_delta(gt)
    want = JD.run_delta(gj, 3, delta=dl)
    got = TD.run_delta(gt, 3, delta=dl, device="cpu")
    for f in ("dist", "phases", "buckets_processed"):
        assert_bits(getattr(want, f), getattr(got, f))
    assert got.relax_edges == want.relax_edges
    assert isinstance(got.relax_edges, np.int64)
    res = TS.run_phased_static(gt, 3, criterion="delta", delta=dl,
                               layout="sliced", device="cpu")
    assert_bits(got.dist, res.dist)
    assert int(got.phases) == int(res.phases)


def test_legacy_loop_sticks_on_a_bucket_edge_as_the_reference_does():
    """t = fl(13 delta) has t / delta = 12.99999 in f32, so bucket 12, but
    the legacy loop keeps t in bucket 12 only while t < fl(13 delta): the
    vertex drops out of its own bucket and both packages' legacy loops run
    empty heavy rounds to the cap, with the same bits. The stepper compares
    bucket ids and finishes, in both packages."""
    d = 0.00999875205575592
    t = np.float32(13) * np.float32(d)
    args = ([0, 0], [1, 2], [t, np.float32(0.5)], 3)
    gj, gt = j_from_coo(*args), t_from_coo(*args, device="cpu")
    want, got = JD.run_delta(gj, 0, delta=d), TD.run_delta(gt, 0, delta=d,
                                                           device="cpu")
    assert int(got.phases) == 4 * 3 + 16  # the cap
    for f in ("dist", "phases", "buckets_processed"):
        assert_bits(getattr(want, f), getattr(got, f))
    assert got.relax_edges == want.relax_edges
    sj = JS.run_phased_static(gj, 0, criterion="delta", delta=d,
                              use_pallas=False)
    st = TS.run_phased_static(gt, 0, criterion="delta", delta=d,
                              device="cpu")
    for f in ("dist", "status", "phases", "settled_per_phase"):
        assert_bits(getattr(sj, f), getattr(st, f))
    assert int(st.phases) < 4 * 3 + 16 and (st.status == 2).all()


def test_bucket_edges_on_a_tenth_grid():
    """delta = 0.1 over weights on the 0.1 grid: the f32 divide by the f32
    delta decides each bucket id, and the ids match the reference's."""
    gj, gt = _tenth_grid(seed=2)
    for layout in ("padded", "sliced"):
        ej, et = _ells(gj, gt, layout)
        want = JS.run_phased_static_batch(
            gj, [0, 5, 9], ell=ej, criterion="delta", delta=0.1,
            use_pallas=False, trace_len=4 * gt.n + 16, telemetry=True)
        got = TS.run_phased_static_batch(
            gt, [0, 5, 9], ell=et, criterion="delta", delta=0.1,
            trace_len=4 * gt.n + 16, telemetry=True, device="cpu")
        assert_results_equal(want, got)
    leg_j = JD.run_delta(gj, 5, delta=0.1)
    leg_t = TD.run_delta(gt, 5, delta=0.1, device="cpu")
    for f in ("dist", "phases", "buckets_processed"):
        assert_bits(getattr(leg_j, f), getattr(leg_t, f))
    # some distance sits on a bucket edge: d / delta is an integer there
    d = got.dist.numpy()
    q = d[np.isfinite(d)] / np.float32(0.1)
    assert (q == np.floor(q)).sum() > 3


def test_chunked_stepping_and_lane_reset(graphs):
    gj, gt = graphs
    sj = JS.init_batch_state(gj, [1, TS.EMPTY_LANE, 4], criterion="delta",
                             trace_len=5, telemetry=True)
    st = TS.init_batch_state(gt, [1, TS.EMPTY_LANE, 4], criterion="delta",
                             trace_len=5, telemetry=True, device="cpu")
    for chunk in range(200):
        if chunk == 3:
            refill = np.array([TS.KEEP_LANE, 9, TS.KEEP_LANE], np.int32)
            sj = JS.reset_lanes(sj, refill)
            st = TS.reset_lanes(st, refill)
        if chunk == 6:
            sj = JS.reset_lane(sj, 0, 13)
            st = TS.reset_lane(st, 0, 13)
        sj = JS.step_batch(gj, sj, 2, use_pallas=False)
        st = TS.step_batch(gt, st, 2)
        assert_results_equal(JS.harvest(sj), TS.harvest(st))
        assert_bits(sj.crit_keys, st.crit_keys)
        if not TS.lanes_active(st).any():
            break
    assert not TS.lanes_active(st).any()
    for lane, s in ((0, 13), (1, 9), (2, 4)):
        assert_bits(TD.run_delta(gt, s, device="cpu").dist, st.dist[lane])


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_prepare_is_memoised_per_view_and_delta(layout):
    """``prepare`` counts the light and heavy degrees once for an
    (out-view, delta) pair and hands the same objects to later calls;
    another delta or out-view counts them again. The degrees count the
    light and heavy real arcs (the COO padding and w == delta ties
    included). The aux holds the out-view itself and the f32 delta: no
    weight-gated copy of any view."""
    src, dst = [0, 0, 1, 2, 2, 3], [1, 2, 3, 3, 0, 1]
    w = np.float32([0.1, 0.3, 0.1, 0.25, -0.0, 0.2])
    gt = t_from_coo(src, dst, w, 4, pad_to=9, device="cpu")
    pol = TS.P.policy_for("delta")
    ell = TS.to_ell_in_sliced(gt) if layout == "sliced" else TS.to_ell_in(gt)
    out = pol.out_view(gt, layout == "sliced")

    def prep(delta, view=out):
        st = TS.init_batch_state(gt, [0], criterion="delta", delta=delta,
                                 device="cpu")
        return pol.prepare(gt, ell, view, st, True)

    first = prep(0.1)
    assert all(a is b for a, b in zip(first, prep(0.1)))
    np.testing.assert_array_equal(first[2].numpy(), [1, 1, 1, 0])
    np.testing.assert_array_equal(first[3].numpy(), [1, 0, 1, 1])
    other = prep(0.25)
    assert other is not first and other[2] is not first[2]
    np.testing.assert_array_equal(other[2].numpy(), [1, 1, 2, 1])
    if layout == "padded":  # the same arrays in a new tuple still hit
        assert prep(0.25, (out[0], out[1]))[2] is other[2]
        assert prep(0.25, (out[0], out[1].clone()))[2] is not other[2]
    for aux, delta in ((first, 0.1), (other, 0.25)):
        assert aux[0] is out  # the out-view itself, weights ungated
        assert aux[1] == float(np.float32(delta))
    if layout == "sliced":  # the buckets of the sliced out-view, no plan
        full = TS.to_ell_out_sliced(gt)
        assert not hasattr(out, "merge_idx")
        for s_b, s_f in zip(out.slices, full.slices):
            assert s_b.cols is s_f.cols and s_b.ws is s_f.ws


def test_delta_gates_are_the_phase_decision(graphs):
    """``DeltaPolicy.gates`` is what ``phase`` acts on: the bucket ids, the
    light work set and the heavy turn of every lane, phase after phase,
    with kernels and with the plain twins alike."""
    _, gt = graphs
    pol = TS.P.policy_for("delta")
    st = TS.init_batch_state(gt, [0, 3, 7], criterion="delta",
                             trace_len=4 * gt.n + 16, telemetry=True,
                             device="cpu")
    for _ in range(40):
        gk = pol.gates(st, True)
        gp = pol.gates(st, False)
        for a, b in zip(gk, gp):
            assert_bits(a, b)
        fringe = st.status == 1
        assert bool((torch.isinf(gk.bidx) == ~fringe).all())
        assert_bits(gk.n_fringe, fringe.sum(dim=1, dtype=torch.int32))
        nxt = TS.step_batch(gt, st, 1)
        if not bool(fringe.any()):
            break
        # a light round settles nothing; the heavy turn settles the
        # removed set and resets the drain keys
        settled = (nxt.status == 2) & (st.status != 2)
        assert_bits(settled, gk.heavy_from)
        fresh = (torch.isinf(nxt.crit_keys[0]).all(dim=1)
                 & (nxt.crit_keys[1] == 0).all(dim=1))
        assert bool(fresh[gk.heavy_turn].all())
        st = nxt


def test_reference_state_continues_in_the_port(graphs):
    gj, gt = graphs
    sj = JS.init_batch_state(gj, [0, 7], criterion="delta", delta=0.2,
                             trace_len=64, telemetry=True)
    sj = JS.step_batch(gj, sj, 5, use_pallas=False)
    fields = {f.name: (sj.criterion if f.name == "criterion"
                       else None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)}
    st = interop.state_from_numpy(fields, device="cpu")
    assert st.delta.dim() == 0 and st.delta.dtype == torch.float32
    sj = JS.step_batch(gj, sj, 4 * gt.n, use_pallas=False)
    st = TS.step_batch(gt, st, 4 * gt.n)
    assert_results_equal(JS.harvest(sj), TS.harvest(st))


# ---------------------------------------------------------------------------
# input checks (test_delta_policy.py's and test_sssp_core.py's)
# ---------------------------------------------------------------------------


def _line_graphs(w):
    """A 3-vertex path with weights ``w`` smuggled in after ``from_coo``,
    as a graph built by other means would carry them."""
    gj = j_from_coo([0, 1], [1, 2], [1.0, 1.0], 3)
    gt = t_from_coo([0, 1], [1, 2], [1.0, 1.0], 3, device="cpu")
    w = np.asarray(w, np.float32)
    return (dataclasses.replace(gj, w=jnp.asarray(w)),
            dataclasses.replace(gt, w=torch.from_numpy(w)))


@pytest.mark.parametrize("w, match", [
    ([1.0, np.nan], "NaN/-inf"), ([1.0, -np.inf], "non-negative|NaN/-inf"),
    ([1.0, -0.5], "non-negative")])
def test_run_delta_rejects_bad_weights(w, match):
    for g, kw in zip(_line_graphs(w), ({}, {"device": "cpu"})):
        pkg = JD if kw == {} else TD
        with pytest.raises(ValueError, match=match):
            pkg.run_delta(g, 0, **kw)


def test_run_delta_accepts_inf_padding():
    _, gt = _line_graphs([1.0, np.inf])
    res = TD.run_delta(gt, 0, device="cpu")
    assert float(res.dist[1]) == 1.0 and not np.isfinite(float(res.dist[2]))


@pytest.mark.parametrize("source", [-1, 3, 100])
def test_run_delta_rejects_bad_source(source):
    _, gt = _line_graphs([1.0, 2.0])
    with pytest.raises(ValueError, match="source must be in"):
        TD.run_delta(gt, source, device="cpu")


@pytest.mark.parametrize("delta", [0.0, -1.0, np.inf, np.nan])
def test_bad_delta_is_rejected_everywhere(delta):
    _, gt = _line_graphs([1.0, 2.0])
    with pytest.raises(ValueError, match="delta must be"):
        TD.run_delta(gt, 0, delta=delta, device="cpu")
    with pytest.raises(ValueError, match="delta must be"):
        TS.run_phased_static(gt, 0, criterion="delta", delta=delta,
                             device="cpu")
    with pytest.raises(ValueError, match="delta must be"):
        TBackend(gt, policy="delta", delta=delta, device="cpu").init(2)


def test_criterion_policies_reject_a_delta():
    _, gt = _line_graphs([1.0, 2.0])
    with pytest.raises(ValueError, match="does not take a delta"):
        TS.run_phased_static(gt, 0, criterion="in|out", delta=0.5,
                             device="cpu")
    with pytest.raises(ValueError, match="does not take a delta"):
        TBackend(gt, delta=0.5, device="cpu")
    with pytest.raises(ValueError, match="oracle"):
        TBackend(gt, policy="in|oracle", device="cpu")
    assert TD.run_delta is TD.run_delta_stepping


def test_delta_extremes_and_relax_edges_type():
    gj = JGen.uniform_gnp(60, 0.1, seed=3)
    gt = TGen.uniform_gnp(60, 0.1, seed=3, device="cpu")
    for delta in (10.0, 1e-3):
        want = JD.run_delta_stepping(gj, 0, delta=delta)
        got = TD.run_delta_stepping(gt, 0, delta=delta, device="cpu")
        assert_bits(want.dist, got.dist)
        assert int(want.phases) == int(got.phases)
        assert got.relax_edges == want.relax_edges


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_static_backend_and_batcher_match_reference(graphs, layout):
    gj, gt = graphs
    bj = JBackend(gj, policy="delta", layout=layout, use_pallas=False)
    bt = TBackend(gt, policy="delta", layout=layout, device="cpu")
    assert bt.criterion == bj.criterion == "delta"
    assert bt.delta == bj.delta
    srcs = np.array([3, TS.EMPTY_LANE, 20], np.int32)
    sj = bj.step(bj.reset_lanes(bj.init(3), srcs), 7)
    st = bt.step(bt.reset_lanes(bt.init(3), srcs), 7)
    pj, pt = bj.peek(sj), bt.peek(st)
    assert pj[0] == pt[0]
    np.testing.assert_array_equal(pj[1], pt[1])
    np.testing.assert_array_equal(pj[2], pt[2])
    assert_bits(bj.take_row(sj, 2), bt.take_row(st, 2))
    # the continuous batcher over a delta backend needs nothing of its own
    servers = [
        JBatcher(gj, lanes=2, phases_per_step=5, backend=bj, clock=Clock()),
        TBatcher(gt, lanes=2, phases_per_step=5, backend=bt, clock=Clock()),
    ]
    done = []
    for server in servers:
        for s in (4, 11, 4, 30, 2):
            server.submit(s)
        server.drain()
        done.append(sorted(server.completed, key=lambda r: r.req_id))
    assert [(r.req_id, r.source, r.lane, r.phases, r.outcome)
            for r in done[0]] == [(r.req_id, r.source, r.lane, r.phases,
                                   r.outcome) for r in done[1]]
    for rj, rt in zip(*done):
        assert_bits(rj.dist, rt.dist)
