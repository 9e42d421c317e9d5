"""The push relax of the port against the JAX reference's pull, bit for bit.

The port relaxes every plan without in-side dynamic keys (the default
``instatic|outstatic`` among them) by a push along the OUTGOING view
(``ell_push_relax_batch`` / ``ell_sliced_push_relax_batch``); the reference
pulls along the incoming one (``ell_relax_batch``,
``ell_sliced_gather_min_batch``). Min is exact and each candidate is the
same single f32 add, so the two agree bit for bit. On the CPU a wrapper
runs its plain twin; the reference runs its Pallas kernels in interpret
mode, as its own tests do. The CUDA kernel is held against the twin and the
pull kernel on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels.ell_relax import ell_relax_batch as j_relax
from repro.kernels.ell_relax_keys import (
    ell_sliced_gather_min_batch as j_sliced_gather,
)
from repro.serving.backends import StaticBackend as JBackend
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.ell_relax import ell_push_relax_batch
from repro_torch.kernels.ell_sliced import ell_sliced_push_relax_batch
from repro_torch.serving import StaticBackend

from helpers import mk_ell

torch.set_num_threads(1)

INF = np.inf
LANES = [1, 3, 8, 9, 40]  # 9 and 40: past one 8-lane tile and one 32-lane word
CASES = ["random", "nan", "empty", "all"]
BOUNDARIES = (8, 32)  # the sliced views' explicit buckets; hubs split at 32
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase")


def T(x):
    """numpy / JAX array -> torch tensor (a copy) on the CPU."""
    return torch.from_numpy(np.array(x, copy=True))


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def out_view(cols, ws, n):
    """The outgoing ELL of the edges an incoming one holds: row u lists the
    (v, w) of every slot ``cols[v, j] = u < n``, left-packed, with the
    sentinel n and +inf after (the layout ``to_ell_out`` builds). It keeps
    the +inf weights an ELL of random slots may hold, so both views carry
    the same candidates, NaN ones included."""
    cols, ws = np.asarray(cols), np.asarray(ws)
    keep = cols < n
    v = np.nonzero(keep)[0]
    u, w = cols[keep], ws[keep]
    order = np.argsort(u, kind="stable")
    u, v, w = u[order], v[order], w[order]
    deg = np.bincount(u, minlength=n)
    d_out = max(int(deg.max()) if deg.size else 0, 1)
    slot = np.arange(u.size) - (np.cumsum(deg) - deg)[u]
    out_c = np.full((n, d_out), n, np.int32)
    out_w = np.full((n, d_out), INF, np.float32)
    out_c[u, slot], out_w[u, slot] = v, w
    return out_c, out_w


def _coo_sparse_out(rng):
    """A graph where a third of the vertices have no out-edges and some
    arcs carry +inf weights (both views drop them), plus +inf padding."""
    n = 120
    src = rng.integers(0, 80, 900).astype(np.int32)  # 80..119: no out-edges
    dst = rng.integers(0, n, 900).astype(np.int32)
    w = rng.uniform(0, 1, 900).astype(np.float32)
    w[rng.random(900) < 0.1] = INF
    return src, dst, w, n


def _graphs(name):
    """(reference graph, port graph) from the same COO."""
    rng = np.random.default_rng(5)
    if name == "sparse_out":
        src, dst, w, n = _coo_sparse_out(rng)
        return (JG.from_coo(src, dst, w, n, pad_to=950),
                TG.from_coo(src, dst, w, n, pad_to=950, device="cpu"))
    fn, args = {"gnp": ("uniform_gnp", (150, 0.05)),
                "grid_road": ("grid_road", (9, 11)),
                "kronecker": ("kronecker", (8,))}[name]
    return (getattr(JGen, fn)(*args, seed=3),
            getattr(TGen, fn)(*args, seed=3, device="cpu"))


def _dmask(rng, b, n, case, pushers=None):
    """(B, n) dmask: +inf off a seeded frontier (~10 % of the vertices a
    lane), none (empty) or every vertex (all), NaN on one pusher a lane
    (nan). ``pushers`` are vertices with out-edges, where a NaN spreads."""
    dm = rng.uniform(0, 10, (b, n)).astype(np.float32)
    if case == "empty":
        dm[:] = INF
    elif case != "all":
        dm[rng.random((b, n)) > 0.1] = INF
    if case == "nan":
        dm[np.arange(b), rng.choice(pushers, b)] = np.nan
    return dm


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b", LANES)
def test_push_twin_matches_pull_on_random_ell(b, case):
    rng = np.random.default_rng(b * 10 + len(case))
    n = 97
    cols, ws = mk_ell(rng, n, 11, n + 1)  # ids up to the sentinel n
    out_c, out_w = out_view(cols, ws, n)
    dm = _dmask(rng, b, n, case, np.unique(np.asarray(cols)[
        np.asarray(cols) < n]))
    pad = np.concatenate([dm, np.full((b, 1), INF, np.float32)], axis=1)
    want = j_relax(jnp.asarray(pad), cols, ws, block_rows=32, interpret=True)
    got = ell_push_relax_batch(T(dm), T(out_c), T(out_w))
    assert_bits(want, got)
    assert_bits(want, ref.ell_relax_batch_ref(T(pad), T(cols), T(ws)))
    if case == "nan":
        assert np.isnan(np.asarray(want)).any()
    if case == "empty":
        assert np.isinf(np.asarray(want)).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b", LANES)
@pytest.mark.parametrize("graph", ["gnp", "grid_road", "kronecker",
                                   "sparse_out"])
def test_push_twin_matches_pull_on_graph_views(graph, b, case):
    gj, gt = _graphs(graph)
    n = gt.n
    rng = np.random.default_rng(b + len(case) + n)
    pushers = np.nonzero(TG.out_degrees(gt).numpy())[0]
    dm = _dmask(rng, b, n, case, pushers)
    pad = np.concatenate([dm, np.full((b, 1), INF, np.float32)], axis=1)
    cols, ws = JG.to_ell_in(gj)
    want = np.asarray(j_relax(jnp.asarray(pad), cols, ws, block_rows=32,
                              interpret=True))
    # the padded out-view, one row a vertex
    assert_bits(want, ell_push_relax_batch(T(dm), *TG.to_ell_out(gt)))
    # the sliced out-view with split hub rows, against the reference's
    # sliced pull over the sliced in-view
    sl_in = JG.to_ell_in_sliced(gj, boundaries=BOUNDARIES, split=32)
    sl_out = TG.to_ell_out_sliced(gt, boundaries=BOUNDARIES, split=32)
    assert_bits(j_sliced_gather(jnp.asarray(dm)[None], sl_in,
                                interpret=True)[0], want)
    assert_bits(want, ell_sliced_push_relax_batch(T(dm), sl_out))
    if case == "all":  # every vertex pushes: every reachable v is finite
        indeg = np.bincount(np.asarray(gj.dst)[np.isfinite(np.asarray(gj.w))],
                            minlength=n)
        assert np.isfinite(want[:, indeg > 0]).all()


def test_push_visits_only_live_owners_and_honours_row_ends():
    """A row ends at its first id outside [0, n) (the twin and the kernel
    alike); an owner outside [0, n) pushes nothing; a -inf dmask pushes."""
    n = 6
    cols = torch.tensor([[1, 2, 6, 3],     # the sentinel ends row 0 before 3
                         [0, -1, 4, 4],    # so does a negative id
                         [5, 5, 5, 9],     # ... and an id past n
                         [6, 6, 6, 6],
                         [0, 1, 2, 3],
                         [6, 6, 6, 6]], dtype=torch.int32)
    ws = torch.arange(24, dtype=torch.float32).reshape(n, 4) / 8
    dm = torch.full((2, n), INF)
    dm[0, 0], dm[0, 1], dm[0, 2] = 1.0, 2.0, 0.5
    dm[1, 4] = -INF
    got = ell_push_relax_batch(dm, cols, ws)
    want = torch.full((2, n), INF)
    want[0, 1], want[0, 2] = 1.0 + ws[0, 0], 1.0 + ws[0, 1]
    want[0, 0] = 2.0 + ws[1, 0]
    want[0, 5] = 0.5 + ws[2, 0]
    want[1, :4] = -INF
    assert_bits(want, got)
    sliced = TG.sliced_ell(
        [TG.EllSlice(rows=torch.tensor([0, 7, 2], dtype=torch.int32),
                     cols=cols[[0, 1, 2]].contiguous(),
                     ws=ws[[0, 1, 2]].contiguous())],
        torch.tensor([[0], [3], [2], [3], [3], [3]], dtype=torch.int32))
    got_s = ell_sliced_push_relax_batch(dm, sliced)  # row 1's owner is 7
    want_s = torch.full((2, n), INF)
    want_s[0, 1], want_s[0, 2] = want[0, 1], want[0, 2]
    want_s[0, 5] = want[0, 5]
    assert_bits(want_s, got_s)


def test_push_wrappers_check_their_inputs():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    ws = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="one row per vertex"):
        ell_push_relax_batch(torch.zeros((2, 5)), cols, ws)
    with pytest.raises(ValueError, match="want dmask"):
        ell_push_relax_batch(torch.zeros(4), cols, ws)
    with pytest.raises(TypeError, match="f32 dmask"):
        ell_push_relax_batch(torch.zeros((2, 4), dtype=torch.float64), cols, ws)
    with pytest.raises(ValueError, match="contiguous"):
        ell_push_relax_batch(torch.zeros((4, 2)).t(), cols, ws)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("graph", ["gnp", "kronecker", "sparse_out"])
def test_default_plan_solve_matches_reference(graph, layout, use_kernels):
    gj, gt = _graphs(graph)
    sources = np.random.default_rng(2).integers(0, gt.n, 5)
    want = JS.run_phased_static_batch(gj, sources, trace_len=16, layout=layout)
    got = TS.run_phased_static_batch(gt, sources, trace_len=16, layout=layout,
                                     use_kernels=use_kernels, device="cpu")
    for f in RESULT_FIELDS:
        assert_bits(getattr(want, f), getattr(got, f))
    # the relax read the outgoing view, in the layout of the incoming one
    assert f"_ell_out{'_sliced' if layout == 'sliced' else ''}_cache" \
        in gt.__dict__


def _serve(backend, sources, lanes, chunk):
    state = backend.init(lanes)
    lane_req = [None] * lanes
    pending = list(range(len(sources)))
    rows, peeks = {}, []
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
                lane_req[lane] = None
    return rows, peeks


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("graph", ["gnp", "kronecker"])
def test_default_plan_backend_matches_reference(graph, layout):
    gj, gt = _graphs(graph)
    sources = np.random.default_rng(4).integers(0, gt.n, 7)
    want = _serve(JBackend(gj, use_pallas=False, layout=layout), sources, 3, 4)
    be = StaticBackend(gt, layout=layout, device="cpu")
    assert be.ell_out is not None
    assert tops._is_sliced(be.ell_out) == (layout == "sliced")
    got = _serve(be, sources, 3, 4)
    assert want[1] == got[1]  # every peek: trips, live flags, phases
    for r in want[0]:
        assert_bits(want[0][r], got[0][r])


@pytest.mark.parametrize("criterion,reads_out", [
    ("instatic|outstatic", True), ("dijk", True), ("instatic", True),
    ("outstatic", True), ("outsimple", True), ("in|out", True),
    ("insimple", False), ("insimple|outsimple", True),
])
def test_which_plans_read_the_outgoing_view(criterion, reads_out):
    """Every plan without in-side keys pushes its relax along the outgoing
    view; ``insimple`` relaxes in the fused in-scan and reads none."""
    from repro_torch.core import policies as P

    pol = P.policy_for(criterion)
    assert pol.needs_out_adjacency == reads_out
    assert bool(pol.plan.in_scan_keys) == (criterion in (
        "in|out", "insimple", "insimple|outsimple"))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("graph", ["gnp", "kronecker", "sparse_out"])
def test_relax_settled_keeps_the_reference_contract(graph, use_kernels):
    """``ops.relax_settled_batch[_sliced]`` take the INCOMING view, as the
    reference's functions of those names do, and give its bits; the push
    the engines run has its own names and takes the outgoing view."""
    from repro.kernels import ops as jops

    gj, gt = _graphs(graph)
    rng = np.random.default_rng(17)
    b = 3
    d = rng.uniform(0, 10, (b, gt.n)).astype(np.float32)
    d[rng.random((b, gt.n)) < 0.3] = INF
    settle = rng.random((b, gt.n)) < 0.2
    jd, jset = jnp.asarray(d), jnp.asarray(settle)
    kw = dict(use_kernels=use_kernels)
    want = jops.relax_settled_batch(jd, jset, *JG.to_ell_in(gj),
                                    use_pallas=False)
    assert_bits(want, tops.relax_settled_batch(T(d), T(settle),
                                               *TG.to_ell_in(gt), **kw))
    assert_bits(want, tops.push_settled_batch(T(d), T(settle),
                                              *TG.to_ell_out(gt), **kw))
    jv = JG.to_ell_in_sliced(gj, boundaries=BOUNDARIES)
    want_s = jops.relax_settled_batch_sliced(jd, jset, jv, use_pallas=False)
    assert_bits(want, want_s)
    assert_bits(want_s, tops.relax_settled_batch_sliced(
        T(d), T(settle), TG.to_ell_in_sliced(gt, boundaries=BOUNDARIES), **kw))
    assert_bits(want_s, tops.push_settled_batch_sliced(
        T(d), T(settle), TG.to_ell_out_sliced(gt, boundaries=BOUNDARIES),
        **kw))
