"""The port's degree-sliced layout against the JAX reference, bit for bit.

Builders (every slice's ``rows``/``cols``/``ws``, ``merge_idx``, widths and
padded slots), the three sliced kernels' twins against the reference's
Pallas kernels in interpret mode, the stepper and ``StaticBackend`` on the
sliced layout. The reference's sliced builders read its tuning ledger when
no boundaries are given; ``REPRO_TUNING_LEDGER`` is unset here, so both
packages fall back to ``default_slice_boundaries``. The CUDA kernels are
held against their twins on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import graph as JG
from repro.core import phased as JP
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import ref as jref
from repro.kernels import registry as R
from repro.kernels.ell_relax_keys import (
    ell_sliced_gather_min_batch as j_sliced_gather,
)
from repro.kernels.ell_relax_keys import ell_sliced_keys_dep_batch as j_sliced_dep
from repro.kernels.ell_relax_keys import (
    ell_sliced_relax_keys_batch as j_sliced_relax_keys,
)
from repro.serving.backends import StaticBackend as JBackend
from repro_torch import interop
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.ell_sliced import (
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_relax_keys_batch,
)
from repro_torch.serving import StaticBackend

torch.set_num_threads(1)

# the reference's sweep (tests/test_sliced_layout.py): auto boundaries, one
# narrow bucket where every hub row splits, split wider than the bucket
LAYOUT_CASES = [
    (None, None),
    ((8,), 8),
    ((8, 16), 16),
    ((8, 64), None),
    ((24,), 48),
]
GRAPHS = {
    "kronecker": ("kronecker", (7,), 21),
    "gnp": ("uniform_gnp", (150, 0.05), 3),
    "grid_road": ("grid_road", (9, 11), 2),
    "webgraph": ("webgraph", (300,), 4),
}
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase")
CRITERIA = ["instatic|outstatic", "in|out", "insimple|outsimple"]


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


def assert_results_equal(want, got, fields=RESULT_FIELDS):
    for f in fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or g is None:
            assert w is None and g is None, f
        else:
            assert_bits(w, g)


def _graphs(name):
    if name == "edgeless":
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32))
        return (JG.from_coo(*empty, n=5),
                TG.from_coo(*empty, n=5, device="cpu"))
    fn, args, seed = GRAPHS[name]
    return (getattr(JGen, fn)(*args, seed=seed),
            getattr(TGen, fn)(*args, seed=seed, device="cpu"))


def carry(view):
    """A reference SlicedEll carried into the port through interop."""
    return interop.sliced_from_numpy(
        {"slices": [{"rows": np.asarray(s.rows), "cols": np.asarray(s.cols),
                     "ws": np.asarray(s.ws)} for s in view.slices],
         "merge_idx": np.asarray(view.merge_idx)},
        device="cpu")


# --- builders ---------------------------------------------------------------


@pytest.mark.parametrize("side", ["in", "out"])
@pytest.mark.parametrize("boundaries,split", LAYOUT_CASES)
@pytest.mark.parametrize("graph", sorted(GRAPHS) + ["edgeless"])
def test_sliced_views_match_reference(graph, boundaries, split, side):
    gj, gt = _graphs(graph)
    want = getattr(JG, f"to_ell_{side}_sliced")(gj, boundaries=boundaries,
                                                split=split)
    got = getattr(TG, f"to_ell_{side}_sliced")(gt, boundaries=boundaries,
                                               split=split)
    assert len(got.slices) == len(want.slices)
    for w, g in zip(want.slices, got.slices):
        for f in ("rows", "cols", "ws"):
            assert_bits(getattr(w, f), getattr(g, f))
    assert_bits(want.merge_idx, got.merge_idx)
    assert got.widths == want.widths
    assert got.padded_slots == want.padded_slots
    # the compact merge plan holds exactly the non-sentinel entries
    midx = np.asarray(want.merge_idx)
    keep = midx != got.total_rows
    assert_bits(midx[keep], got.merge_pos)
    assert_bits(np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int64),
                got.merge_ptr)


def test_sliced_views_are_memoised_and_check_split():
    _, gt = _graphs("kronecker")
    se = TG.to_ell_in_sliced(gt, boundaries=(8,), split=8)
    assert TG.to_ell_in_sliced(gt, boundaries=[8], split=8) is se
    assert TG.to_ell_in_sliced(gt, boundaries=(8, 16), split=16) is not se
    assert TG.to_ell_out_sliced(gt, boundaries=(8,), split=8) is not se
    assert TG.to_ell_in_sliced(gt) is TG.to_ell_in_sliced(gt)
    with pytest.raises(ValueError, match="split"):
        TG.to_ell_in_sliced(gt, boundaries=(8, 64), split=8)
    with pytest.raises(ValueError, match="split"):
        TG.to_ell_out_sliced(gt, boundaries=(24,), split=16)


def test_default_slice_boundaries_match_reference():
    rng = np.random.default_rng(0)
    for deg in (np.array([], np.int64), np.array([0, 0, 0], np.int64),
                np.array([1] * 95 + [500] * 5, np.int64),
                rng.zipf(1.7, 5000).astype(np.int64),
                rng.poisson(100, 4000).astype(np.int64)):
        for pad in (2, 8):
            assert (TG.default_slice_boundaries(deg, pad)
                    == JG.default_slice_boundaries(deg, pad))


def test_sliced_ell_rejects_a_merge_plan_out_of_range():
    view = carry(R.fixture_sliced())
    total = view.total_rows
    bad = view.merge_idx.clone()
    bad[0, 0] = total + 1
    with pytest.raises(ValueError, match="merge_idx entries"):
        TG.sliced_ell(view.slices, bad)
    with pytest.raises(ValueError, match="int32 merge_idx"):
        TG.sliced_ell(view.slices, view.merge_idx.long())


# --- the three kernels: twins against interpret-mode Pallas -------------------


def _empty_middle_view():
    """kronecker(7)'s in-view with an empty bucket between its two."""
    gj, _ = _graphs("kronecker")
    v = JG.to_ell_in_sliced(gj, boundaries=(8, 64))
    empty = JG.EllSlice(rows=jnp.zeros((0,), jnp.int32),
                        cols=jnp.full((0, 16), gj.n, jnp.int32),
                        ws=jnp.full((0, 16), jnp.inf, jnp.float32))
    return v._replace(slices=(v.slices[0], empty, *v.slices[1:]))


VIEWS = {
    "fixture_in": lambda: R.fixture_sliced(side="in"),
    "fixture_out": lambda: R.fixture_sliced(side="out"),
    "kron_split": lambda: JG.to_ell_in_sliced(_graphs("kronecker")[0],
                                              boundaries=(8,), split=8),
    "empty_middle": _empty_middle_view,
}


def _view(name):
    view = VIEWS[name]()
    return view, int(view.merge_idx.shape[0])


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_sliced_gather_min_matches_reference(name, v):
    view, n = _view(name)
    vecs = np.array(R.fixture_rows((v, R.FIXTURE_B, n), seed=11 + v))
    vecs[v - 1, 1, 3] = np.nan
    want = j_sliced_gather(jnp.asarray(vecs), view, interpret=True)
    assert_bits(jref.ell_sliced_gather_min_batch_ref(jnp.asarray(vecs), view),
                want)
    tv = carry(view)
    assert_bits(want, ref.ell_sliced_gather_min_batch_ref(T(vecs), tv))
    for sparse in (False, True):
        assert_bits(want, ell_sliced_gather_min_batch(T(vecs), tv,
                                                      sparse=sparse))
    assert_bits(want, tops.gather_min_batch_sliced(T(vecs), tv))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_sliced_relax_keys_matches_reference(name, k):
    view, n = _view(name)
    b = R.FIXTURE_B
    dmask = np.array(R.fixture_rows((b, n), seed=6, inf_frac=0.7))
    ga, gb, gc = (np.array(R.fixture_rows((k, b, n), seed=s))
                  for s in (7, 8, 9))
    if k == 2:
        ga[1, 0, 2] = np.nan
        gc[0, 2, 5] = np.nan
    want = j_sliced_relax_keys(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                               view, interpret=True)
    tv = carry(view)
    args = [T(x) for x in (dmask, ga, gb, gc)]
    for got in (ref.ell_sliced_relax_keys_batch_ref(*args, tv),
                ell_sliced_relax_keys_batch(*args, tv)):
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


@pytest.mark.parametrize("k0,dep_idx", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_sliced_keys_dep_matches_reference(name, k0, dep_idx):
    view, n = _view(name)
    b = R.FIXTURE_B
    gates = np.array(R.fixture_rows((k0, b, n), seed=21))
    dga = np.array(R.fixture_rows((b, n), seed=22))
    dgb = np.array(R.fixture_rows((b, n), seed=23))
    dga[1, 4] = np.nan
    want = j_sliced_dep(*(jnp.asarray(x) for x in (gates, dga, dgb)), view,
                        dep_idx=dep_idx, interpret=True)
    tv = carry(view)
    args = [T(x) for x in (gates, dga, dgb)]
    assert_bits(want, ref.ell_sliced_keys_dep_batch_ref(*args, dep_idx, tv))
    assert_bits(want, ell_sliced_keys_dep_batch(*args, tv, dep_idx=dep_idx))


def test_sliced_wrappers_reject_what_the_kernels_do_not_take():
    tv = carry(R.fixture_sliced())
    n, b = R.FIXTURE_N, R.FIXTURE_B
    v = torch.zeros((2, b, n))
    with pytest.raises(ValueError, match=r"want vecs \(V, B, n\)"):
        ell_sliced_gather_min_batch(v[0], tv)
    with pytest.raises(ValueError, match=r"int32 merge_idx"):
        ell_sliced_gather_min_batch(v[:, :, :n - 1].contiguous(), tv)
    with pytest.raises(TypeError):
        ell_sliced_gather_min_batch(v.double(), tv)
    with pytest.raises(ValueError, match="dep_idx 2 out of range"):
        ell_sliced_keys_dep_batch(v, v[0], v[0], tv, dep_idx=2)
    with pytest.raises(ValueError, match=r"need a \(K>=1, B, n\) gate stack"):
        ell_sliced_relax_keys_batch(v[0], v[:0], v[:0], v[:0], tv)
    with pytest.raises(ValueError, match="at least one bucket"):
        ell_sliced_gather_min_batch(v, tv._replace(slices=()))


def test_sliced_cpu_tensors_run_the_twins_and_count_no_launch():
    fns = (ell_sliced_gather_min_batch, ell_sliced_relax_keys_batch,
           ell_sliced_keys_dep_batch)
    before = [f.launches for f in fns]
    tv = carry(R.fixture_sliced())
    v = T(R.fixture_rows((2, R.FIXTURE_B, R.FIXTURE_N)))
    ell_sliced_gather_min_batch(v, tv, sparse=True)
    ell_sliced_relax_keys_batch(v[0], v, v, v, tv)
    ell_sliced_keys_dep_batch(v, v[0], v[1], tv, dep_idx=1)
    assert [f.launches for f in fns] == before


class _LargestTensor(TorchDispatchMode):
    """Records the element count of the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_sliced_twin_never_materialises_the_merge_gather():
    """The reference merges through take(concat, merge_idx), a (V, B, n, C)
    tensor: 24.6 GB per vector at kronecker(20). The twin must not."""
    n, hub_in = 600, 599
    src = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
    dst = np.concatenate([np.zeros(hub_in), np.arange(1, n)]).astype(np.int32)
    w = np.random.default_rng(0).uniform(0, 1, src.size).astype(np.float32)
    g = TG.from_coo(src, dst, w, n, device="cpu")
    view = TG.to_ell_in_sliced(g, boundaries=(8,))
    c = view.merge_idx.shape[1]
    assert c >= 64
    vecs = torch.rand((2, 4, n))
    with _LargestTensor() as mode:
        got = ref.ell_sliced_gather_min_batch_ref(vecs, view)
    # the largest tensors are the buckets' own (V, B, R_b, D_b) gather and
    # masks over merge_idx itself
    lanes = vecs.shape[0] * vecs.shape[1]
    biggest = max(lanes * view.padded_slots, view.merge_idx.numel())
    assert mode.most <= biggest < lanes * n * c
    cols, ws = TG.to_ell_in(g)
    assert_bits(ref.ell_gather_min_batch_ref(vecs, cols, ws), got)


# --- the stepper and serving on the sliced layout ---------------------------


@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("boundaries,split", LAYOUT_CASES)
def test_sliced_solve_matches_reference_and_padded(boundaries, split, crit):
    gj, gt = _graphs("kronecker")
    srcs = np.asarray([0, 5, gt.n - 1], np.int32)
    views = {side: (getattr(JG, f"to_ell_{side}_sliced")(
                        gj, boundaries=boundaries, split=split),
                    getattr(TG, f"to_ell_{side}_sliced")(
                        gt, boundaries=boundaries, split=split))
             for side in ("in", "out")}
    want = JS.run_phased_static_batch(gj, srcs, criterion=crit, trace_len=8,
                                      ell=views["in"][0],
                                      ell_out=views["out"][0])
    got = TS.run_phased_static_batch(gt, srcs, criterion=crit, trace_len=8,
                                     ell=views["in"][1],
                                     ell_out=views["out"][1], device="cpu")
    assert_results_equal(want, got)
    padded = TS.run_phased_static_batch(gt, srcs, criterion=crit,
                                        trace_len=8, device="cpu")
    assert_results_equal(padded, got)
    plain = TS.run_phased_static_batch(gt, srcs, criterion=crit, trace_len=8,
                                       ell=views["in"][1],
                                       ell_out=views["out"][1],
                                       use_kernels=False, device="cpu")
    assert_results_equal(padded, plain)


@pytest.mark.parametrize("crit", ["instatic|outstatic", "in|out"])
@pytest.mark.parametrize("graph", ["gnp", "grid_road", "webgraph"])
def test_layout_sliced_equals_padded(graph, crit):
    _, gt = _graphs(graph)
    srcs = np.asarray([0, 7, gt.n - 1, 3])
    padded = TS.run_phased_static_batch(gt, srcs, criterion=crit,
                                        device="cpu")
    sliced = TS.run_phased_static_batch(gt, srcs, criterion=crit,
                                        layout="sliced", device="cpu")
    assert_results_equal(padded, sliced)
    one = TS.run_phased_static(gt, 7, criterion=crit, layout="sliced",
                               device="cpu")
    assert_bits(padded.dist[1].numpy(), one.dist)
    assert int(one.phases) == int(padded.phases[1])


def test_sliced_stepper_chunking_and_reset():
    """The reference's chunking-and-reset contract on the sliced layout,
    both packages on one schedule: chunked stepping, early exit and lane
    resets stay invisible, and a reset lane re-primes its carried in-side
    keys (keys_valid)."""
    gj = JGen.grid_road(11, 9, seed=55)
    gt = TGen.grid_road(11, 9, seed=55, device="cpu")
    jv = (JG.to_ell_in_sliced(gj), JG.to_ell_out_sliced(gj))
    tv = (TG.to_ell_in_sliced(gt), TG.to_ell_out_sliced(gt))
    srcs = np.asarray([0, gt.n - 1, 17], np.int32)
    full = TS.run_phased_static_batch(gt, srcs, criterion="in|out",
                                      device="cpu")
    js = JS.init_batch_state(gj, srcs, criterion="in|out")
    ts = TS.init_batch_state(gt, srcs, criterion="in|out", device="cpu")
    assert ts.keys_valid is False
    while TS.lanes_active(ts).any():
        js = JS.step_batch(gj, js, 3, ell=jv[0], ell_out=jv[1],
                           stop_on_lane_finish=True)
        ts = TS.step_batch(gt, ts, 3, ell=tv[0], ell_out=tv[1],
                           stop_on_lane_finish=True)
        assert_bits(js.crit_keys, ts.crit_keys)
    assert ts.keys_valid is True and bool(js.keys_valid)
    assert_results_equal(JS.harvest(js), TS.harvest(ts))
    assert_results_equal(full, TS.harvest(ts), ("dist", "phases"))
    reset = np.asarray([-2, 40, -1], np.int32)
    js, ts = JS.reset_lanes(js, reset), TS.reset_lanes(ts, reset)
    assert ts.keys_valid is False
    while TS.lanes_active(ts).any():
        js = JS.step_batch(gj, js, 7, ell=jv[0], ell_out=jv[1])
        ts = TS.step_batch(gt, ts, 7, ell=tv[0], ell_out=tv[1])
    after = TS.harvest(ts)
    assert_results_equal(JS.harvest(js), after)
    gen = JP.run_phased(gj, 40, "in|out")
    assert_bits(gen.dist, after.dist[1])
    assert int(after.phases[1]) == int(gen.phases)
    assert torch.isinf(after.dist[2]).all()


def test_step_batch_derives_ell_out_in_the_layout_of_ell():
    _, gt = _graphs("kronecker")
    st = TS.init_batch_state(gt, [0, 5], criterion="in|out", device="cpu")
    TS.step_batch(gt, st, 2, ell=TG.to_ell_in_sliced(gt))
    assert "_ell_out_sliced_cache" in gt.__dict__
    assert "_ell_out_cache" not in gt.__dict__


def test_edgeless_graph_solves_on_the_sliced_layout():
    gj, gt = _graphs("edgeless")
    for crit in ("instatic|outstatic", "in|out"):
        want = JS.run_phased_static_batch(gj, [2, 4], criterion=crit,
                                          layout="sliced")
        got = TS.run_phased_static_batch(gt, [2, 4], criterion=crit,
                                         layout="sliced", device="cpu")
        assert_results_equal(want, got, RESULT_FIELDS[:-1])


def _serve(backend, sources, lanes, chunk):
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


@pytest.mark.parametrize("graph,crit,lanes,chunk", [
    ("kronecker", "instatic|outstatic", 3, 4),
    ("kronecker", "in|out", 4, 5),
    ("webgraph", "insimple|outsimple", 2, 1000),
])
def test_sliced_static_backend_matches_reference(graph, crit, lanes, chunk):
    gj, gt = _graphs(graph)
    sources = np.random.default_rng(1).integers(0, gt.n, 7)
    want = _serve(JBackend(gj, use_pallas=False, criterion=crit,
                           layout="sliced"), sources, lanes, chunk)
    be = StaticBackend(gt, criterion=crit, layout="sliced", device="cpu")
    assert tops._is_sliced(be.ell)
    assert be.ell_out is None or tops._is_sliced(be.ell_out)
    got = _serve(be, sources, lanes, chunk)
    assert want[2] == got[2]  # every peek: trips, live flags, phases
    assert want[1] == got[1]
    for r in want[0]:
        assert_bits(want[0][r], got[0][r])
