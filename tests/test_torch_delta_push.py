"""Delta-stepping's relax as one push over the outgoing view, against the
JAX reference's two gathers over the weight-gated incoming views.

``ops.delta_push_relax_batch`` (``ell_delta_push_batch`` on the padded
out-view, ``ell_sliced_delta_push_batch`` on the sliced one's buckets) is
the port's counterpart of the reference's relax and runs on no engine path:
the port's delta policy commits its phase through ``ops.commit_delta_phase``
(a mark, a worklist push and a tail). The reference gathers ``where(light, d, inf)``
over the light twin of its incoming view and ``where(heavy, d, inf)`` over
the heavy twin (``delta_relax_batch`` over ``weight_gated_ell``). Min is
exact and every candidate is the reference's one f32 add on the reference's
operands (``d + w`` or ``d + inf``), so the two agree bit for bit. A NaN
compares as one value: where a target's candidates hold NaNs of two
payloads (a NaN source's and the -inf + inf of a -inf source), which one a
min keeps depends on the order of its fold, in the reference as in the
port's own twin of the gathers. On the CPU a wrapper runs its plain twin;
the reference runs through its plain reference, and its Pallas kernels in
interpret mode where said. The CUDA kernels are held against the twin on
the card by ``test_torch_cuda.py`` and ``chip_smoke.py`` phase 20.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import from_coo as j_from_coo
from repro.core import static_engine as JS
from repro.kernels import ops as jops
from repro.serving import PointBackend as JPoint
from repro.serving import StaticBackend as JBackend
from repro_torch.core import SlicedBuckets
from repro_torch.core import from_coo as t_from_coo
from repro_torch.core import static_engine as TS
from repro_torch.core.policies import policy_for
from repro_torch.core import (
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_buckets,
    to_ell_out_sliced,
)
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ell_relax import ell_delta_push_batch
from repro_torch.kernels.ell_sliced import ell_sliced_delta_push_batch
from repro_torch.serving import PointBackend as TPoint
from repro_torch.serving import StaticBackend as TBackend

torch.set_num_threads(1)

INF = np.inf
DELTAS = (0.1, 0.3, 0.7)  # on the weights' tenth grid: w == delta ties
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase", "fringe_per_phase",
                 "relax_per_phase", "settle_attribution")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(want, got):
    """Bit equality, every NaN taken as one value (see the docstring)."""
    want, got = _np(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype != np.float32:
        np.testing.assert_array_equal(want, got)
        return
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(want[keep].view(np.int32),
                                  got[keep].view(np.int32))


def _tenth_grid(seed=0, n=80, m=700):
    """Weights on multiples of f32(0.1) up to 1.1, +0 among them and -0 on
    5 % of the arcs, so every delta of :data:`DELTAS` ties with some
    weight; a hub with a wide row, so the sliced views split it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[: m // 6] = 1
    w = (rng.integers(0, 12, m) * np.float32(0.1)).astype(np.float32)
    w[rng.random(m) < 0.05] = -0.0
    return (j_from_coo(src, dst, w, n),
            t_from_coo(src, dst, w, n, device="cpu"))


@pytest.fixture(scope="module")
def grid():
    return _tenth_grid()


def _views(gj, gt, layout):
    """(reference in-view, port out-view, port out-views the kernel
    wrapper takes): the sliced push takes the full sliced out-view or its
    buckets alone."""
    if layout == "sliced":
        return (JS.to_ell_in_sliced(gj), to_ell_out_buckets(gt),
                (to_ell_out_buckets(gt), to_ell_out_sliced(gt)))
    return JS.to_ell_in(gj), to_ell_out(gt), (to_ell_out(gt),)


def _inputs(rng, b, n, sets):
    """d with +inf, NaN, -inf, +0 and -0 slots; the light and heavy sets,
    ``disjoint`` within a lane (as the policy makes them) or
    ``overlap``."""
    d = rng.uniform(0, 2, (b, n)).astype(np.float32)
    for value, share in ((INF, 0.2), (np.nan, 0.04), (-INF, 0.04),
                         (0.0, 0.03), (-0.0, 0.03)):
        d[rng.random((b, n)) < share] = value
    light = rng.random((b, n)) < 0.3
    heavy = rng.random((b, n)) < 0.3
    if sets == "disjoint":
        heavy &= ~light
    else:
        assert (light & heavy).any()
    return d, light, heavy


def _reference(d, light, heavy, ell_in, delta, use_pallas=False):
    lj, hj = jops.weight_gated_ell(ell_in, jnp.float32(delta))
    return np.asarray(jops.delta_relax_batch(
        jnp.asarray(d), jnp.asarray(light), jnp.asarray(heavy), lj, hj,
        use_pallas=use_pallas))


# ---------------------------------------------------------------------------
# the op and its kernel wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sets", ["disjoint", "overlap"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_push_matches_the_reference_gathers(grid, layout, b, sets):
    gj, gt = grid
    ej, out, wrapper_views = _views(gj, gt, layout)
    rng = np.random.default_rng(b + 10 * len(sets))
    ws = gt.w.numpy()
    for delta in DELTAS:
        assert (ws == np.float32(delta)).any()  # a tie with delta
        d, light, heavy = _inputs(rng, b, gt.n, sets)
        want = _reference(d, light, heavy, ej, delta)
        args = (torch.from_numpy(d), torch.from_numpy(light),
                torch.from_numpy(heavy))
        for use_kernels in (True, False):
            assert_same(want, tops.delta_push_relax_batch(
                *args, out, delta, use_kernels=use_kernels))
        for view in wrapper_views:
            if layout == "sliced":
                got = ell_sliced_delta_push_batch(*args, view, delta)
            else:
                got = ell_delta_push_batch(*args, *view, delta)
            assert_same(want, got)
        # the port's own gathers over its weight-gated in-view agree too
        et = to_ell_in_sliced(gt) if layout == "sliced" else to_ell_in(gt)
        lt, ht = tops.weight_gated_ell(et, torch.tensor(np.float32(delta)))
        assert_same(want, tops.delta_relax_batch(*args, lt, ht))


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_push_matches_the_reference_kernels_in_interpret_mode(
        grid, layout):
    gj, gt = grid
    ej, out, _ = _views(gj, gt, layout)
    d, light, heavy = _inputs(np.random.default_rng(7), 3, gt.n, "overlap")
    want = _reference(d, light, heavy, ej, 0.3, use_pallas=True)
    assert_same(want, tops.delta_push_relax_batch(
        torch.from_numpy(d), torch.from_numpy(light), torch.from_numpy(heavy),
        out, 0.3))


def test_gated_out_arcs_carry_what_the_reference_adds():
    """delta = 0.1: the arc 0 -> 1 of weight f32(0.1) is light (w == delta),
    0 -> 2 of 0.5 heavy, 3 -> 1 of -0 light, 3 -> 2 of 0.2 heavy. A -inf
    source gives -inf along its turn's arcs and NaN (-inf + inf) along the
    others; a NaN source NaN along all; -0 + -0 is -0 and +0 + -0 is +0; a
    +inf source pushes nothing; a lane in both sets takes both turns."""
    src, dst = [0, 0, 3, 3], [1, 2, 1, 2]
    w = np.float32([0.1, 0.5, -0.0, 0.2])
    gj, gt = j_from_coo(src, dst, w, 4), t_from_coo(src, dst, w, 4,
                                                    device="cpu")
    d = np.full((7, 4), 1.0, np.float32)
    light = np.zeros((7, 4), bool)
    heavy = np.zeros((7, 4), bool)
    for lane, (vertex, value, is_light, is_heavy) in enumerate((
            (0, -INF, True, False), (0, np.nan, True, False),
            (0, -INF, False, True), (3, 0.0, True, False),
            (3, -0.0, True, False), (0, 1.0, True, True),
            (0, INF, True, True))):
        d[lane, vertex] = value
        light[lane, vertex], heavy[lane, vertex] = is_light, is_heavy
    nan = np.nan
    expect = np.float32([
        [INF, -INF, nan, INF], [INF, nan, nan, INF], [INF, nan, -INF, INF],
        [INF, 0.0, INF, INF], [INF, -0.0, INF, INF],
        [INF, np.float32(1) + np.float32(0.1), 1.5, INF],
        [INF, INF, INF, INF]])
    for layout in ("padded", "sliced"):
        ej, out, _ = _views(gj, gt, layout)
        want = _reference(d, light, heavy, ej, 0.1)
        assert_same(expect, want)
        assert_same(want, tops.delta_push_relax_batch(
            torch.from_numpy(d), torch.from_numpy(light),
            torch.from_numpy(heavy), out, 0.1))


def test_wrappers_check_their_inputs(grid):
    _, gt = grid
    cols, ws = to_ell_out(gt)
    d = torch.zeros((2, gt.n))
    on = torch.zeros((2, gt.n), dtype=torch.bool)
    with pytest.raises(ValueError, match="bool light_from"):
        ell_delta_push_batch(d, on.to(torch.uint8), on, cols, ws, 0.1)
    with pytest.raises(ValueError, match="bool heavy_from"):
        ell_delta_push_batch(d, on, on[:1], cols, ws, 0.1)
    with pytest.raises(ValueError, match="one row per vertex"):
        ell_delta_push_batch(d, on, on, cols[:-1], ws[:-1], 0.1)
    with pytest.raises(ValueError, match="at least one bucket"):
        ell_sliced_delta_push_batch(d, on, on, SlicedBuckets(()), 0.1)


# ---------------------------------------------------------------------------
# the delta policy, solves and serving
# ---------------------------------------------------------------------------


@pytest.fixture
def push_only(monkeypatch):
    """Counts the calls of delta's committed phase
    (``ops.commit_delta_phase``; ``delta_push_relax_batch`` is off the
    engine path); the reference's gathers and gated views must not run on a
    delta path."""
    calls = []
    real = tops.commit_delta_phase

    def counted(*args, **kw):
        calls.append(kw.get("use_kernels", True))
        return real(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("a delta path ran the reference's gathers")

    monkeypatch.setattr(tops, "commit_delta_phase", counted)
    for name in ("delta_relax_batch", "weight_gated_ell",
                 "key_min_batch_any"):
        monkeypatch.setattr(tops, name, refused)
    return calls


def _assert_results_equal(want, got):
    for f in RESULT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            w, g = _np(w), _np(g)
            assert w.shape == g.shape, f
            if w.dtype == np.float32:
                w, g = w.view(np.int32), g.view(np.int32)
            np.testing.assert_array_equal(w, g, err_msg=f)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_solves_push_and_match_the_reference(grid, layout, push_only):
    gj, gt = grid
    ej = JS.to_ell_in_sliced(gj) if layout == "sliced" else JS.to_ell_in(gj)
    srcs = [1, 0, 9, 40, 77, 5, 13, 60]
    for delta, b in ((0.1, 8), (0.3, 3), (None, 1)):
        kw = dict(criterion="delta", delta=delta, trace_len=4 * gt.n + 16,
                  telemetry=True)
        want = JS.run_phased_static_batch(gj, srcs[:b], ell=ej,
                                          use_pallas=False, **kw)
        for use_kernels in (True, False):
            got = TS.run_phased_static_batch(
                gt, srcs[:b], layout=layout, use_kernels=use_kernels,
                device="cpu", **kw)
            _assert_results_equal(want, got)
    assert push_only and set(push_only) == {True, False}


@pytest.mark.parametrize("spec", ["delta", "instatic|outstatic", "in",
                                  "in|out"])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_each_policy_names_the_views_it_reads(spec, layout):
    """``in_view`` / ``out_view``: delta reads no in-view and the out-view
    (its buckets alone when sliced); a plan reads the in-view, and the
    out-view where it pushes or scans out-side keys."""
    _, gt = _tenth_grid(seed=3)
    pol, sliced = policy_for(spec), layout == "sliced"
    want_in = None if spec == "delta" else (
        to_ell_in_sliced(gt) if sliced else to_ell_in(gt))
    if spec == "delta":
        want_out = to_ell_out_buckets(gt) if sliced else to_ell_out(gt)
    elif spec == "in":
        want_out = None  # relaxes in the fused in-scan, no out-side key
    else:
        want_out = to_ell_out_sliced(gt) if sliced else to_ell_out(gt)
    assert pol.in_view(gt, sliced) is want_in
    assert pol.out_view(gt, sliced) is want_out
    assert pol.needs_out_adjacency == (want_out is not None)


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_serving_pushes_and_matches_the_reference(layout, push_only):
    gj, gt = _tenth_grid(seed=3)
    bj = JBackend(gj, policy="delta", layout=layout, use_pallas=False)
    bt = TBackend(gt, policy="delta", layout=layout, device="cpu")
    # the views a delta server holds: the out-view (on the sliced layout
    # its buckets, no merge plan) and no in-view
    assert bt.ell is None
    if layout == "sliced":
        assert isinstance(bt.ell_out, SlicedBuckets)
        assert bt.ell_out is to_ell_out_buckets(gt)
    else:
        assert bt.ell_out is to_ell_out(gt)
    held = {k for k in gt.__dict__ if k.startswith("_ell_") and gt.__dict__[k]}
    assert held == ({"_ell_out_buckets_cache"} if layout == "sliced"
                    else {"_ell_out_cache"})
    srcs = np.array([3, TS.EMPTY_LANE, 20, 1], np.int32)
    sj = bj.step(bj.reset_lanes(bj.init(4), srcs), 9)
    st = bt.step(bt.reset_lanes(bt.init(4), srcs), 9)
    pj, pt = bj.peek(sj), bt.peek(st)
    assert pj[0] == pt[0]
    np.testing.assert_array_equal(pj[1], pt[1])
    np.testing.assert_array_equal(pj[2], pt[2])
    for lane in (0, 2, 3):
        assert_same(bj.take_row(sj, lane), bt.take_row(st, lane))
    # to the end, a lane refilled on the way
    sj = bj.step(bj.reset_lanes(sj, np.array([-2, 7, -2, -2], np.int32)),
                 4 * gt.n + 16)
    st = bt.step(bt.reset_lanes(st, np.array([-2, 7, -2, -2], np.int32)),
                 4 * gt.n + 16)
    for lane in range(4):
        assert_same(bj.take_row(sj, lane), bt.take_row(st, lane))
    assert push_only


def test_a_delta_solve_builds_no_in_view_and_verify_row_takes_the_layout():
    """``run_phased_static_batch`` builds only the out-view delta reads;
    ``verify_row`` then builds the in-view of that layout (the sliced one
    beside the out-view's buckets)."""
    from repro_torch.serving import verify_row

    for layout in ("padded", "sliced"):
        _, gt = _tenth_grid(seed=5)
        res = TS.run_phased_static_batch(gt, [2, 9], criterion="delta",
                                         layout=layout, device="cpu")
        assert not gt.__dict__.get("_ell_in_cache")
        assert not gt.__dict__.get("_ell_in_sliced_cache")
        assert verify_row(gt, res.dist[0].numpy(), 2) is None
        built = "_ell_in_sliced_cache" if layout == "sliced" else \
            "_ell_in_cache"
        assert gt.__dict__.get(built)
        assert not gt.__dict__.get({"_ell_in_cache": "_ell_in_sliced_cache",
                                    "_ell_in_sliced_cache": "_ell_in_cache"}
                                   [built])


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_point_queries_push_both_lanes(layout, push_only):
    """The backward lane runs on the transpose, whose out-view is the
    graph's in-side view, shared: on the sliced layout the transpose's
    out-buckets are the graph's in-view's own buckets."""
    gj, gt = _tenth_grid(seed=4)
    pj = JPoint(gj, policy="delta", layout=layout, use_pallas=False)
    pt = TPoint(gt, policy="delta", layout=layout, device="cpu")
    for s, t in ((0, 1), (5, 70), (33, 2)):
        want, got = pj.query(s, t), pt.query(s, t)
        assert_same(np.float32(want.distance), np.float32(got.distance))
        assert (want.phases_forward, want.phases_backward) == (
            got.phases_forward, got.phases_backward)
    _, bwd_in, bwd_out = pt._backward()
    if layout == "sliced":
        fwd_in = to_ell_in_sliced(gt)
        assert isinstance(bwd_out, SlicedBuckets)
        for a, b in zip(bwd_out.slices, fwd_in.slices):
            assert a.cols is b.cols and a.ws is b.ws
    else:
        assert bwd_out is to_ell_in(gt)
    assert len(push_only) > 0
