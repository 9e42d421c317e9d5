"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Floats compare bit for bit, with every NaN taken as one value (IEEE leaves
NaN payloads open).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    EllSlice,
    from_coo,
    run_phased_static_batch,
    sliced_ell,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
)
from repro_torch.graphs import kronecker, uniform_gnp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ell_key_min import (
    ell_key_min,
    ell_key_min_batch,
    ell_key_min_status_batch,
)
from repro_torch.kernels.ell_relax import (
    ell_push_relax_batch,
    ell_relax,
    ell_relax_batch,
)
from repro_torch.kernels.ell_relax_keys import (
    ell_gather_min_batch,
    ell_keys_dep_batch,
    ell_relax_keys,
    ell_relax_keys_batch,
)
from repro_torch.kernels.ell_sliced import (
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_push_relax_batch,
    ell_sliced_relax_keys_batch,
)
from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _same_bits(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        canon = torch.tensor(float("nan"), device=a.device)
        a = torch.where(torch.isnan(a), canon, a).view(torch.int32)
        b = torch.where(torch.isnan(b), canon, b).view(torch.int32)
    return bool(torch.equal(a, b))


def _ell(rng, n, d, n_pad):
    cols = rng.integers(0, n_pad, size=(n, d)).astype(np.int32)
    ws = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    ws[rng.random((n, d)) < 0.2] = np.inf
    return cols, ws


@pytest.mark.parametrize("b,n,d", [(1, 300, 8), (2, 1000, 3), (3, 777, 33),
                                   (8, 5000, 40), (13, 700, 5),
                                   (8, 2000, 200)])
def test_ell_relax_batch_matches_twin(cuda, b, n, d):
    rng = np.random.default_rng(b * 1000 + n + d)
    cols, ws = _ell(rng, n, d, n + 1)
    dm = rng.uniform(0, 10, (b, n + 1)).astype(np.float32)
    dm[rng.random(dm.shape) < 0.5] = np.inf
    dm[0, 3] = np.nan
    args = (_t(dm, cuda), _t(cols, cuda), _t(ws, cuda))
    before = ell_relax_batch.launches
    got = ell_relax_batch(*args)
    assert ell_relax_batch.launches == before + 1
    assert _same_bits(got, ref.ell_relax_batch_ref(*args))
    row = args[0][b - 1].contiguous()
    assert _same_bits(ell_relax(row, *args[1:]),
                      ref.ell_relax_ref(row, *args[1:]))


@pytest.mark.parametrize("b", [1, 5, 8, 9])
def test_ell_relax_batch_sparse_dmask_and_odd_weights(cuda, b):
    """The engine's dmask is +inf almost everywhere and the kernel skips
    those columns; -inf and NaN weights must still give the twin's NaN."""
    rng = np.random.default_rng(40 + b)
    n = 4099  # not a multiple of 32: a partial last bitmap word
    cols, ws = _ell(rng, n, 24, n + 1)
    ws[3, 0], ws[17, 5], ws[40, 2] = -np.inf, np.nan, -np.inf
    dm = np.full((b, n + 1), np.inf, np.float32)
    live = rng.random((b, n)) < 0.01
    dm[:, :n][live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    args = (_t(dm, cuda), _t(cols, cuda), _t(ws, cuda))
    got = ell_relax_batch(*args)
    want = ref.ell_relax_batch_ref(*args)
    # +inf + -inf is NaN where the lane's dmask is +inf, -inf where finite
    assert (torch.isnan(want[:, 3]) | (want[:, 3] == -np.inf)).all()
    assert torch.isnan(want[:, 17]).all()  # x + NaN is NaN for every x
    assert _same_bits(got, want)


@pytest.mark.parametrize("b,n,k,per_lane", [(1, 100, 0, False),
                                            (8, 100_000, 1, False),
                                            (5, 3000, 2, True),
                                            (70, 5000, 8, True)])
def test_frontier_crit_lanes_matches_twin(cuda, b, n, k, per_lane):
    rng = np.random.default_rng(b + n + k)
    d = rng.uniform(0, 5, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.2] = np.inf
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    d[0, 1], status[0, 1] = np.nan, 1
    keys = None
    if k:
        shape = (k, b, n) if per_lane else (k, n)
        keys = _t(rng.uniform(0, 1, shape).astype(np.float32), cuda)
    args = (_t(d, cuda), _t(status, cuda), keys)
    before = frontier_crit_lanes_batch.launches
    mins, cnt = frontier_crit_lanes_batch(*args)
    assert frontier_crit_lanes_batch.launches == before + 1
    w_mins, w_cnt = ref.frontier_crit_lanes_batch_ref(*args)
    assert _same_bits(mins, w_mins) and _same_bits(cnt, w_cnt)


def test_solve_with_kernels_matches_plain_solve(cuda):
    g = uniform_gnp(3000, 3e-3, seed=4, device=cuda)
    sources = [0, 11, 2999, 5, 77]
    a = run_phased_static_batch(g, sources, trace_len=16)
    b = run_phased_static_batch(g, sources, trace_len=16, use_kernels=False)
    for f in ("dist", "status", "phases", "total_phases", "settled_per_phase"):
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.sum_fringe, b.sum_fringe)
    assert np.array_equal(a.relax_edges, b.relax_edges)
    cols, _ = to_ell_in(g)
    assert cols.device.type == "cuda"


def _dense(rng, shape, nan=False):
    """Key-gate-like values: dense, with some +inf and optionally a NaN."""
    x = rng.uniform(0, 3, shape).astype(np.float32)
    x[rng.random(shape) < 0.2] = np.inf
    if nan:
        x.reshape(-1)[7] = np.nan
    return x


@pytest.mark.parametrize("b,n,d", [(1, 300, 8), (3, 777, 33), (8, 5000, 40),
                                   (13, 700, 5), (8, 2000, 200)])
def test_ell_key_min_batch_matches_twin(cuda, b, n, d):
    rng = np.random.default_rng(b * 7 + n + d)
    cols, ws = _ell(rng, n, d, n + 1)
    gate = _t(_dense(rng, (b, n + 1), nan=b == 3), cuda)
    args = (gate, _t(cols, cuda), _t(ws, cuda))
    before = ell_key_min_batch.launches
    got = ell_key_min_batch(*args)
    assert ell_key_min_batch.launches == before + 1
    assert _same_bits(got, ref.ell_key_min_batch_ref(*args))
    row = gate[b - 1].contiguous()
    assert _same_bits(ell_key_min(row, *args[1:]),
                      ref.ell_key_min_ref(row, *args[1:]))


@pytest.mark.parametrize("v,b,n,rows,d", [(1, 8, 3000, 3000, 40),
                                          (2, 8, 3000, 3000, 40),
                                          (3, 5, 900, 411, 9),
                                          (2, 1, 64, 64, 3)])
def test_ell_gather_min_batch_matches_twin(cuda, v, b, n, rows, d):
    rng = np.random.default_rng(v + b + n + d)
    cols, ws = _ell(rng, rows, d, n + 1)  # ids up to the sentinel n
    vecs = _t(_dense(rng, (v, b, n), nan=v == 2), cuda)
    args = (vecs, _t(cols, cuda), _t(ws, cuda))
    before = ell_gather_min_batch.launches
    got = ell_gather_min_batch(*args)
    assert ell_gather_min_batch.launches == before + 1
    assert _same_bits(got, ref.ell_gather_min_batch_ref(*args))


@pytest.mark.parametrize("k,b,n,d", [(1, 8, 3000, 40), (2, 8, 3000, 40),
                                     (2, 3, 777, 33), (1, 1, 500, 8),
                                     (3, 13, 700, 5)])
def test_ell_relax_keys_batch_matches_twin(cuda, k, b, n, d):
    rng = np.random.default_rng(k * 100 + b + n + d)
    cols, ws = _ell(rng, n, d, n + 1)
    dm = np.full((b, n), np.inf, np.float32)  # sparse, as on the engine's path
    live = rng.random((b, n)) < 0.05
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    parts = [_t(_dense(rng, (k, b, n), nan=(i == 1 and k == 2)), cuda)
             for i in range(3)]
    args = (_t(dm, cuda), *parts, _t(cols, cuda), _t(ws, cuda))
    before = ell_relax_keys_batch.launches
    upd, keys = ell_relax_keys_batch(*args)
    assert ell_relax_keys_batch.launches == before + 1
    w_upd, w_keys = ref.ell_relax_keys_batch_ref(*args)
    assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)
    one = (args[0][0].contiguous(), *(p[:, 0].contiguous() for p in parts),
           *args[4:])
    u1, k1 = ell_relax_keys(*one)
    assert _same_bits(u1, w_upd[0]) and _same_bits(k1, w_keys[:, 0])


@pytest.mark.parametrize("k0,dep_idx,b,n,d", [(1, 0, 8, 3000, 40),
                                              (2, 1, 8, 3000, 40),
                                              (2, 0, 5, 901, 17),
                                              (3, 2, 1, 400, 8)])
def test_ell_keys_dep_batch_matches_twin(cuda, k0, dep_idx, b, n, d):
    rng = np.random.default_rng(k0 * 10 + dep_idx + b + n + d)
    cols, ws = _ell(rng, n, d, n + 1)
    gates = _t(_dense(rng, (k0, b, n)), cuda)
    dga = _t(_dense(rng, (b, n), nan=k0 == 2), cuda)
    dgb = _t(_dense(rng, (b, n)), cuda)
    tc, tw = _t(cols, cuda), _t(ws, cuda)
    before = ell_keys_dep_batch.launches
    got = ell_keys_dep_batch(gates, dga, dgb, tc, tw, dep_idx=dep_idx)
    assert ell_keys_dep_batch.launches == before + 1
    assert _same_bits(got, ref.ell_keys_dep_batch_ref(gates, dga, dgb,
                                                      dep_idx, tc, tw))


# The fused scans' pipelined body: widths at, under and over one stage
# (4096 slots a row are chunked across stages), n off the row tile, odd D
# (rows and copies off 16-byte boundaries).
SCAN_SHAPES = [(1000, 8), (999, 40), (2001, 152), (37, 4096), (301, 1000),
               (500, 5)]


def _scan_ell(rng, n, d):
    """An in-ELL with _build_ell's trailing (n, +inf) padding, rows that are
    all padding, an interior sentinel followed by real slots, NaN and -inf
    weights and ids outside [0, n]. Returns it and the twin's form of it:
    the twin cannot index out of range, and the kernel reads NaN there,
    which is what a NaN weight on an in-range id gives."""
    cols = rng.integers(0, n + 1, size=(n, d)).astype(np.int32)
    ws = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    deg = rng.integers(0, d + 1, n)
    deg[::7] = 0  # rows that are all padding
    pad = np.arange(d)[None] >= deg[:, None]
    cols[pad], ws[pad] = n, np.inf
    real = np.nonzero(deg >= 2)[0]
    cols[real[:3], 0], ws[real[:3], 0] = n, np.inf  # interior sentinels
    ws[real[3], 0], ws[real[4], 1] = np.nan, -np.inf
    cols[real[5], 1], cols[real[6], 0] = -3, n + 5  # ids out of range
    bad = (cols < 0) | (cols > n)
    return cols, ws, np.where(bad, 0, cols), np.where(bad, np.nan, ws)


def _adjacency(cols, ws, dev):
    """(cols, ws) on the card; with D odd, as contiguous views that start one
    row into a larger buffer, so their data starts off a 16-byte boundary."""
    if cols.shape[1] % 2 == 0:
        return _t(cols, dev), _t(ws, dev)
    return tuple(_t(np.concatenate([a[:1], a]), dev)[1:] for a in (cols, ws))


@pytest.mark.parametrize("k,b", [(1, 1), (1, 8), (2, 8)])  # 1, 8, 16 lanes
@pytest.mark.parametrize("n,d", SCAN_SHAPES)
def test_ell_relax_keys_batch_pipelined_body(cuda, n, d, k, b):
    rng = np.random.default_rng(n + d + 10 * k + b)
    cols, ws, twin_cols, twin_ws = _scan_ell(rng, n, d)
    dm = np.full((b, n), np.inf, np.float32)
    live = rng.random((b, n)) < 0.03
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    dm[0, 1] = np.nan
    parts = [_t(_dense(rng, (k, b, n), nan=i == 1), cuda) for i in range(3)]
    vecs = (_t(dm, cuda), *parts)
    before = ell_relax_keys_batch.launches
    upd, keys = ell_relax_keys_batch(*vecs, *_adjacency(cols, ws, cuda))
    assert ell_relax_keys_batch.launches == before + 1
    w_upd, w_keys = ref.ell_relax_keys_batch_ref(
        *vecs, _t(twin_cols, cuda), _t(twin_ws, cuda))
    assert torch.isnan(w_upd).any() and torch.isnan(w_keys).any()
    assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)


@pytest.mark.parametrize("n,d", [(300_001, 8), (4_500_000, 2)])
def test_ell_relax_keys_batch_large_n(cuda, n, d):
    """Many units a block of the persistent grid, and a sparse sweep whose
    bitmap (37 KB, 562 KB) outgrows what the L1 keeps."""
    rng = np.random.default_rng(n + d)
    cols, ws, twin_cols, twin_ws = _scan_ell(rng, n, d)
    dm = np.full((2, n), np.inf, np.float32)
    live = rng.random((2, n)) < 0.002
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    parts = [_t(_dense(rng, (1, 2, n)), cuda) for _ in range(3)]
    vecs = (_t(dm, cuda), *parts)
    upd, keys = ell_relax_keys_batch(*vecs, *_adjacency(cols, ws, cuda))
    w_upd, w_keys = ref.ell_relax_keys_batch_ref(
        *vecs, _t(twin_cols, cuda), _t(twin_ws, cuda))
    assert torch.isfinite(w_upd).any()
    assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)


@pytest.mark.parametrize("k0,dep_idx,b", [(1, 0, 1), (1, 0, 8), (2, 0, 8),
                                          (2, 1, 8)])
@pytest.mark.parametrize("n,d", SCAN_SHAPES)
def test_ell_keys_dep_batch_pipelined_body(cuda, n, d, k0, dep_idx, b):
    rng = np.random.default_rng(n + d + 10 * k0 + dep_idx + b)
    cols, ws, twin_cols, twin_ws = _scan_ell(rng, n, d)
    gates = _t(_dense(rng, (k0, b, n), nan=True), cuda)
    dga = _t(_dense(rng, (b, n), nan=True), cuda)
    dgb = _t(_dense(rng, (b, n)), cuda)
    before = ell_keys_dep_batch.launches
    got = ell_keys_dep_batch(gates, dga, dgb, *_adjacency(cols, ws, cuda),
                             dep_idx=dep_idx)
    assert ell_keys_dep_batch.launches == before + 1
    want = ref.ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx,
                                      _t(twin_cols, cuda), _t(twin_ws, cuda))
    assert torch.isnan(want).any()
    assert _same_bits(got, want)


@pytest.mark.parametrize("criterion", ["in|out", "insimple|outsimple",
                                       "outweak"])
def test_dynamic_solve_with_kernels_matches_plain_solve(cuda, criterion):
    g = uniform_gnp(3000, 3e-3, seed=4, device=cuda)
    sources = [0, 11, 2999, 5, 77]
    a = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion)
    b = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion,
                                use_kernels=False)
    for f in ("dist", "status", "phases", "total_phases", "settled_per_phase"):
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.sum_fringe, b.sum_fringe)
    assert np.array_equal(a.relax_edges, b.relax_edges)


def test_cuda_tensors_never_fall_back(cuda):
    dm = ops.pad_lane_batch(torch.zeros((2, 4), device=cuda))
    cols = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ws = torch.zeros((4, 2), dtype=torch.float32)  # on the host: refused
    with pytest.raises(ValueError, match="different devices"):
        ell_relax_batch(dm, cols, ws)
    v = torch.zeros((1, 2, 4), device=cuda)
    for call in (lambda: ell_key_min_batch(dm, cols, ws),
                 lambda: ell_gather_min_batch(v, cols, ws),
                 lambda: ell_relax_keys_batch(v[0], v, v, v, cols, ws),
                 lambda: ell_keys_dep_batch(v, v[0], v[0], cols, ws)):
        with pytest.raises(ValueError, match="different devices"):
            call()


def _sliced_view(kind, dev):
    """Sliced views with split rows, an empty middle bucket, or no edges."""
    if kind == "edgeless":
        g = from_coo(np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32), n=37, device=dev)
        return to_ell_in_sliced(g)
    g = kronecker(10, seed=3, device=dev)
    if kind == "split":  # every row wider than 8 splits into chunks
        return to_ell_in_sliced(g, boundaries=(8,), split=8)
    if kind == "out_default":
        return to_ell_out_sliced(g)
    v = to_ell_in_sliced(g, boundaries=(8, 64))
    empty = EllSlice(rows=v.slices[0].rows[:0],
                     cols=torch.full((0, 16), g.n, dtype=torch.int32,
                                     device=dev),
                     ws=torch.full((0, 16), np.inf, dtype=torch.float32,
                                   device=dev))
    return sliced_ell((v.slices[0], empty, *v.slices[1:]), v.merge_idx)


SLICED_KINDS = ["split", "out_default", "empty_middle", "edgeless"]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("v,b", [(1, 8), (2, 8), (3, 5), (1, 1)])
@pytest.mark.parametrize("kind", SLICED_KINDS)
def test_ell_sliced_gather_min_batch_matches_twin(cuda, kind, v, b, sparse):
    view = _sliced_view(kind, cuda)
    n = view.merge_idx.shape[0]
    rng = np.random.default_rng(v * 10 + b)
    x = _dense(rng, (v, b, n), nan=v == 2)
    if sparse:  # +inf but on ~2 % of the vertices, as the relax's dmask
        x[rng.random(x.shape) > 0.02] = np.inf
    vecs = _t(x, cuda)
    before = ell_sliced_gather_min_batch.launches
    got = ell_sliced_gather_min_batch(vecs, view, sparse=sparse)
    assert ell_sliced_gather_min_batch.launches == before + 1
    assert _same_bits(got, ref.ell_sliced_gather_min_batch_ref(vecs, view))


@pytest.mark.parametrize("k,b", [(1, 8), (2, 8), (2, 3), (3, 1)])
@pytest.mark.parametrize("kind", SLICED_KINDS)
def test_ell_sliced_relax_keys_batch_matches_twin(cuda, kind, k, b):
    view = _sliced_view(kind, cuda)
    n = view.merge_idx.shape[0]
    rng = np.random.default_rng(k * 100 + b)
    dm = np.full((b, n), np.inf, np.float32)
    live = rng.random((b, n)) < 0.05
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    parts = [_t(_dense(rng, (k, b, n), nan=(i == 0 and k == 2)), cuda)
             for i in range(3)]
    args = (_t(dm, cuda), *parts)
    before = ell_sliced_relax_keys_batch.launches
    upd, keys = ell_sliced_relax_keys_batch(*args, view)
    assert ell_sliced_relax_keys_batch.launches == before + 1
    w_upd, w_keys = ref.ell_sliced_relax_keys_batch_ref(*args, view)
    assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)


@pytest.mark.parametrize("k0,dep_idx,b", [(1, 0, 8), (2, 1, 8), (2, 0, 3),
                                          (3, 2, 1)])
@pytest.mark.parametrize("kind", SLICED_KINDS)
def test_ell_sliced_keys_dep_batch_matches_twin(cuda, kind, k0, dep_idx, b):
    view = _sliced_view(kind, cuda)
    n = view.merge_idx.shape[0]
    rng = np.random.default_rng(k0 * 10 + dep_idx + b)
    gates = _t(_dense(rng, (k0, b, n)), cuda)
    dga = _t(_dense(rng, (b, n), nan=k0 == 2), cuda)
    dgb = _t(_dense(rng, (b, n)), cuda)
    before = ell_sliced_keys_dep_batch.launches
    got = ell_sliced_keys_dep_batch(gates, dga, dgb, view, dep_idx=dep_idx)
    assert ell_sliced_keys_dep_batch.launches == before + 1
    assert _same_bits(got, ref.ell_sliced_keys_dep_batch_ref(
        gates, dga, dgb, dep_idx, view))


@pytest.mark.parametrize("criterion", ["instatic|outstatic", "in|out",
                                       "insimple|outsimple"])
def test_sliced_solve_with_kernels_matches_plain_and_padded(cuda, criterion):
    g = kronecker(11, seed=4, device=cuda)
    sources = [0, 11, 2047, 5, 77]
    a = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion,
                                layout="sliced")
    b = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion,
                                layout="sliced", use_kernels=False)
    c = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion)
    for f in ("dist", "status", "phases", "total_phases", "settled_per_phase"):
        assert _same_bits(getattr(a, f), getattr(b, f)), f
        assert _same_bits(getattr(a, f), getattr(c, f)), f
    for f in ("sum_fringe", "relax_edges"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert np.array_equal(getattr(a, f), getattr(c, f))


def test_sliced_cuda_tensors_never_fall_back(cuda):
    view = _sliced_view("split", cuda)
    n = view.merge_idx.shape[0]
    v = torch.zeros((1, 2, n))  # on the host: refused with a CUDA view
    for call in (lambda: ell_sliced_gather_min_batch(v, view),
                 lambda: ell_sliced_relax_keys_batch(v[0], v, v, v, view),
                 lambda: ell_sliced_keys_dep_batch(v, v[0], v[0], view)):
        with pytest.raises(ValueError, match="different devices"):
            call()
    # 17 buckets with rows (vertex i has in-degree 8 * (i + 1)) are more
    # than one launch takes: the card runs them in two groups, and agrees
    # with the twin (it raised before the groups)
    deg = 8 * np.arange(1, 18)
    dst = np.repeat(np.arange(17), deg).astype(np.int32)
    src = (np.arange(dst.size) % 150 + 17).astype(np.int32)
    g = from_coo(src, dst, np.ones(dst.size, np.float32), n=200, device=cuda)
    wide = to_ell_in_sliced(g, boundaries=tuple(deg))
    assert len(wide.slices) == 17
    x = _t(_dense(np.random.default_rng(17), (1, 2, 200), nan=True), cuda)
    assert _same_bits(ell_sliced_gather_min_batch(x, wide),
                      ref.ell_sliced_gather_min_batch_ref(x, wide))


# --- the push relax (csrc/ell_push.cu) ----------------------------------------
#
# dmask holds negative values and NaN here; ties of -0 and +0 have their own
# tests below (every fold takes -0, the atomics in any order too). Weights
# are finite or +inf, as the builders keep them: a -inf weight would make
# +inf + -inf = NaN in the pull from a lane that pushes nothing.


def _push_out_view(cols, ws, n):
    """The outgoing ELL of the slots ``cols[v, j] = u < n`` of an incoming
    one: row u lists (v, w), left-packed, sentinel n and +inf after."""
    keep = cols < n
    v = np.nonzero(keep)[0]
    u, w = cols[keep], ws[keep]
    order = np.argsort(u, kind="stable")
    u, v, w = u[order], v[order], w[order]
    deg = np.bincount(u, minlength=n)
    d_out = max(int(deg.max()) if deg.size else 0, 1)
    slot = np.arange(u.size) - (np.cumsum(deg) - deg)[u]
    out_c = np.full((n, d_out), n, np.int32)
    out_w = np.full((n, d_out), np.inf, np.float32)
    out_c[u, slot], out_w[u, slot] = v, w
    return out_c, out_w


def _push_dmask(rng, b, n, live=0.05):
    """A dmask with a share ``live`` of its slots finite, negative values
    among them; unless it is empty, a -inf and a NaN a lane too."""
    dm = np.full((b, n), np.inf, np.float32)
    on = rng.random((b, n)) < live
    dm[on] = rng.uniform(-5, 10, on.sum()).astype(np.float32)
    if live > 0:
        dm[0, 1] = -np.inf
        dm[np.arange(b), rng.integers(0, n, b)] = np.nan
    assert not (dm == 0).any()  # no -0 (nor +0) in dmask
    return dm


def _push_expected_candidates(dm, cols_o, n):
    """Lane-slots the push must visit: real slots of the rows whose owner
    has a lane that is not +inf, times those lanes."""
    lanes = (dm != np.inf).sum(axis=0)
    ends = np.cumprod((cols_o >= 0) & (cols_o < n), axis=1).sum(axis=1)
    return int((lanes * ends).sum())


@pytest.mark.parametrize("b,n,d", [(1, 300, 8), (3, 777, 33), (8, 5000, 40),
                                   (13, 700, 5), (40, 2000, 17),
                                   (70, 901, 152), (8, 20_000, 200)])
def test_ell_push_relax_batch_matches_twin_and_pull(cuda, b, n, d):
    rng = np.random.default_rng(b * 31 + n + d)
    cols, ws = _ell(rng, n, d, n + 1)  # +inf weights, ids up to n
    ws[ws < 0.3] -= 1.0  # negative weights too
    cols_o, ws_o = _push_out_view(cols, ws, n)
    dm = _push_dmask(rng, b, n)
    tdm, tc, tw = _t(dm, cuda), _t(cols_o, cuda), _t(ws_o, cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = ell_push_relax_batch.launches
    got = ell_push_relax_batch(tdm, tc, tw, stats=stats)
    assert ell_push_relax_batch.launches == before + 1
    assert _same_bits(got, ref.ell_push_relax_batch_ref(tdm, (tc, tw)))
    pad = ops.pad_lane_batch(tdm)
    assert _same_bits(got, ell_relax_batch(pad, _t(cols, cuda), _t(ws, cuda)))
    cand, atomics = stats.tolist()
    assert cand == _push_expected_candidates(dm, cols_o, n)
    # every output the push lowered took at least one atomic
    assert int((got != np.inf).sum()) <= atomics <= cand


@pytest.mark.parametrize("live", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("b", [1, 8, 33])
def test_ell_push_relax_batch_graph_views(cuda, b, live):
    """The builders' out-view of a graph, against the pull over its in-view:
    an empty frontier, a sparse one, every vertex settled."""
    g = uniform_gnp(3000, 3e-3, seed=5, device=cuda)
    rng = np.random.default_rng(b + int(live * 100))
    dm = _push_dmask(rng, b, g.n, live)
    tdm = _t(dm, cuda)
    got = ell_push_relax_batch(tdm, *to_ell_out(g))
    assert _same_bits(got, ref.ell_push_relax_batch_ref(tdm, to_ell_out(g)))
    assert _same_bits(got, ell_relax_batch(ops.pad_lane_batch(tdm),
                                           *to_ell_in(g)))
    if live == 0.0:
        assert bool(torch.isinf(got).all())


@pytest.mark.parametrize("b", [1, 8, 40])
@pytest.mark.parametrize("boundaries,split", [((8, 32, 128, 512), 512),
                                              ((8,), 8), ((16, 64), 64),
                                              (None, None)])
def test_ell_sliced_push_relax_batch_matches_twin_and_pull(cuda, boundaries,
                                                           split, b):
    """Buckets of width 8 to 512, hub rows split (kronecker(12)'s largest
    out-degree is far past 512), against the twin, the sliced pull over the
    in-view and the padded pull."""
    g = kronecker(12, seed=6, device=cuda)
    sl_out = to_ell_out_sliced(g, boundaries=boundaries, split=split)
    assert any(int(torch.unique(s.rows).numel()) < s.rows.shape[0]
               for s in sl_out.slices)  # some hub owns several rows
    rng = np.random.default_rng(b + len(sl_out.slices))
    dm = _push_dmask(rng, b, g.n, 0.03)
    tdm = _t(dm, cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = ell_sliced_push_relax_batch.launches
    got = ell_sliced_push_relax_batch(tdm, sl_out, stats=stats)
    assert ell_sliced_push_relax_batch.launches == before + 1
    assert _same_bits(got, ref.ell_push_relax_batch_ref(tdm, sl_out))
    sl_in = to_ell_in_sliced(g, boundaries=boundaries, split=split)
    assert _same_bits(got, ell_sliced_gather_min_batch(tdm[None], sl_in,
                                                       sparse=True)[0])
    assert _same_bits(got, ell_relax_batch(ops.pad_lane_batch(tdm),
                                           *to_ell_in(g)))
    cand = sum(_push_expected_candidates(dm[:, s.rows.cpu().numpy()],
                                         s.cols.cpu().numpy(), g.n)
               for s in sl_out.slices)
    assert stats[0].item() == cand


def test_push_cuda_tensors_never_fall_back(cuda):
    dm = torch.zeros((2, 4), device=cuda)
    cols = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ws = torch.zeros((4, 2), dtype=torch.float32)  # on the host: refused
    with pytest.raises(ValueError, match="different devices"):
        ell_push_relax_batch(dm, cols, ws)
    view = _sliced_view("split", cuda)
    with pytest.raises(ValueError, match="different devices"):
        ell_sliced_push_relax_batch(torch.zeros((2, view.merge_idx.shape[0])),
                                    view)


# --- signed zeros: every kernel takes -0 over +0 on a tie -------------------

_VALUES = np.array([0.0, -0.0, 0.5, 1.0], np.float32)


def _signed(rng, shape, inf_frac=0.2, nan=False):
    """Draws from {0, -0, 0.5, 1}, +inf on ``inf_frac``, NaN at a few
    slots of lane 1 when ``nan``."""
    x = _VALUES[rng.integers(0, _VALUES.size, shape)]
    x[rng.random(shape) < inf_frac] = np.inf
    if nan:
        lane = (slice(None),) * (len(shape) - 2) + (1,)
        x[lane + (rng.integers(0, shape[-1], 3),)] = np.nan
    return x


def _both_zeros(x):
    z = x == 0
    return bool((z & torch.signbit(x)).any() and (z & ~torch.signbit(x)).any())


def _signed_graph(dev, n=3000, m=40_000, hub=1300):
    """Weights from {0, -0, 0.5, 1}; vertex 0 has in- and out-degree
    ``hub`` (it splits in the 512 bucket)."""
    rng = np.random.default_rng(21)
    nb = rng.integers(1, n, hub)
    src = np.concatenate([nb, np.zeros(hub, int), rng.integers(0, n, m)])
    dst = np.concatenate([np.zeros(hub, int), nb, rng.integers(0, n, m)])
    w = _VALUES[rng.integers(0, 4, src.size)]
    return from_coo(src.astype(np.int32), dst.astype(np.int32), w, n=n,
                    device=dev)


SIGNED_KERNELS = ["relax", "key_min", "gather", "relax_keys", "keys_dep",
                  "crit", "push", "sliced_gather", "sliced_relax_keys",
                  "sliced_relax_keys_push", "sliced_keys_dep",
                  "sliced_push"]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("kernel", SIGNED_KERNELS)
def test_signed_zero_ties_match_twins(cuda, kernel, b):
    g = _signed_graph(cuda)
    n = g.n
    rng = np.random.default_rng(b * 7 + len(kernel))
    cols, ws = to_ell_in(g)
    sl = dict(boundaries=(8, 32, 128, 512))
    v = _t(_signed(rng, (2, b, n), nan=b > 1), cuda)
    dm = _t(_signed(rng, (b, n), inf_frac=0.6, nan=b > 1), cuda)
    parts = [_t(_signed(rng, (2, b, n), nan=b > 1 and i == 0), cuda)
             for i in range(3)]
    if kernel == "relax":
        pad = ops.pad_lane_batch(dm)
        got, want = (ell_relax_batch(pad, cols, ws),
                     ref.ell_relax_batch_ref(pad, cols, ws))
    elif kernel == "key_min":
        pad = ops.pad_lane_batch(v[0])
        got, want = (ell_key_min_batch(pad, cols, ws),
                     ref.ell_key_min_batch_ref(pad, cols, ws))
    elif kernel == "gather":
        got, want = (ell_gather_min_batch(v, cols, ws),
                     ref.ell_gather_min_batch_ref(v, cols, ws))
    elif kernel == "relax_keys":
        upd, got = ell_relax_keys_batch(dm, *parts, cols, ws)
        w_upd, want = ref.ell_relax_keys_batch_ref(dm, *parts, cols, ws)
        assert _same_bits(upd, w_upd)
    elif kernel == "keys_dep":
        got = ell_keys_dep_batch(v, parts[0][0], parts[1][0], cols, ws,
                                 dep_idx=1)
        want = ref.ell_keys_dep_batch_ref(v, parts[0][0], parts[1][0], 1,
                                          cols, ws)
    elif kernel == "crit":
        st = _t(rng.integers(0, 3, (b, n)).astype(np.int32), cuda)
        # lane 0 keeps its -0s; the others only +0s (abs), so both signs of
        # zero are some lane's min
        d = torch.cat([dm[:1], dm[1:].abs()]) if b > 1 else dm
        k = torch.cat([v[:, :1], v[:, 1:].abs()], dim=1) if b > 1 else v
        got = frontier_crit_lanes_batch(d, st, k)[0]
        want = ref.frontier_crit_lanes_batch_ref(d, st, k)[0]
        if b == 1:  # one lane: its fringe min is -0, its keys' lane +0
            want = torch.cat([want, ref.frontier_crit_lanes_batch_ref(
                d.abs(), st, k)[0]])
            got = torch.cat([got, frontier_crit_lanes_batch(
                d.abs(), st, k)[0]])
    elif kernel == "push":
        got = ell_push_relax_batch(dm, *to_ell_out(g))
        want = ref.ell_relax_batch_ref(ops.pad_lane_batch(dm), cols, ws)
        assert _same_bits(got, ref.ell_push_relax_batch_ref(dm, to_ell_out(g)))
    elif kernel == "sliced_push":
        got = ell_sliced_push_relax_batch(dm, to_ell_out_sliced(g, **sl))
        want = ref.ell_relax_batch_ref(ops.pad_lane_batch(dm), cols, ws)
    elif kernel == "sliced_gather":
        view = to_ell_in_sliced(g, **sl)
        got, want = (ell_sliced_gather_min_batch(v, view),
                     ref.ell_sliced_gather_min_batch_ref(v, view))
    elif kernel.startswith("sliced_relax_keys"):
        view = to_ell_in_sliced(g, **sl)
        out_view = (to_ell_out_sliced(g, **sl) if kernel.endswith("push")
                    else None)
        upd, keys = ell_sliced_relax_keys_batch(dm, *parts, view,
                                                out_view=out_view)
        w_upd, w_keys = ref.ell_sliced_relax_keys_batch_ref(dm, *parts, view)
        assert _same_bits(upd, w_upd)
        got, want = keys, w_keys
    else:
        view = to_ell_out_sliced(g, **sl)
        got = ell_sliced_keys_dep_batch(v, parts[0][0], parts[1][0], view,
                                        dep_idx=1)
        want = ref.ell_sliced_keys_dep_batch_ref(v, parts[0][0], parts[1][0],
                                                 1, view)
    assert _both_zeros(want)
    assert _same_bits(got, want)


# --- the sliced fused scans on the pipelined body (#10, #10b, #11) ----------


def _hub_sliced(dev):
    """kronecker(12) plus a vertex of in- and out-degree 1,300 (three rows
    of the 512 bucket on either side)."""
    g = kronecker(12, seed=6, device=dev)
    rng = np.random.default_rng(4)
    nb = rng.integers(1, g.n, 1300)
    real = torch.isfinite(g.w)
    src = np.concatenate([g.src[real].cpu().numpy(), nb, np.zeros(1300, int)])
    dst = np.concatenate([g.dst[real].cpu().numpy(), np.zeros(1300, int), nb])
    w = np.concatenate([g.w[real].cpu().numpy(),
                        rng.uniform(0, 1, 2600).astype(np.float32)])
    g = from_coo(src.astype(np.int32), dst.astype(np.int32), w, n=g.n,
                 device=dev)
    kw = dict(boundaries=(8, 32, 128, 512))
    return g, to_ell_in_sliced(g, **kw), to_ell_out_sliced(g, **kw)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b", [1, 8, 13, 40])
def test_sliced_relax_keys_on_the_pipelined_body(cuda, b, k):
    g, sl_in, sl_out = _hub_sliced(cuda)
    assert sl_in.merge_multi > 0 and sl_in.split_rows > 0
    n = g.n
    rng = np.random.default_rng(b * 3 + k)
    dm = np.full((b, n), np.inf, np.float32)
    live = rng.random((b, n)) < 0.05
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    dm[:, 0] = 1.0  # the hub settled in every lane
    dm[np.arange(b), rng.integers(0, n, b)] = np.nan
    parts = [_t(_dense(rng, (k, b, n), nan=i == 0), cuda) for i in range(3)]
    tdm = _t(dm, cuda)
    w_upd, w_keys = ref.ell_sliced_relax_keys_batch_ref(tdm, *parts, sl_in)
    for out_view, counter in ((None, "launches"), (sl_out, "push_launches")):
        before = getattr(ell_sliced_relax_keys_batch, counter)
        upd, keys = ell_sliced_relax_keys_batch(tdm, *parts, sl_in,
                                                out_view=out_view)
        assert getattr(ell_sliced_relax_keys_batch, counter) == before + 1
        assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)


@pytest.mark.parametrize("k0,dep_idx", [(1, 0), (2, 1)])
@pytest.mark.parametrize("b", [1, 8, 13, 40])
def test_sliced_keys_dep_on_the_pipelined_body(cuda, b, k0, dep_idx):
    g, _, sl_out = _hub_sliced(cuda)
    n = g.n
    rng = np.random.default_rng(b * 5 + k0)
    gates = _t(_dense(rng, (k0, b, n), nan=True), cuda)
    dga = _t(_dense(rng, (b, n), nan=True), cuda)
    dgb = _t(_dense(rng, (b, n)), cuda)
    before = ell_sliced_keys_dep_batch.launches
    got = ell_sliced_keys_dep_batch(gates, dga, dgb, sl_out, dep_idx=dep_idx)
    assert ell_sliced_keys_dep_batch.launches == before + 1
    assert _same_bits(got, ref.ell_sliced_keys_dep_batch_ref(
        gates, dga, dgb, dep_idx, sl_out))


def test_sliced_fused_scans_refuse_a_table_the_body_does_not_take(cuda,
                                                                   monkeypatch):
    """A unit table built for other constants is refused by the kernel's
    check, never run, and nothing falls back to another body."""
    from repro_torch.kernels import ell_sliced

    g, sl_in, _ = _hub_sliced(cuda)
    real = ell_sliced.scan_units
    monkeypatch.setattr(ell_sliced, "scan_units",
                        lambda *a, **kw: real(*a, warps=4, **kw))
    x = torch.zeros((1, 2, g.n), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ell_sliced_keys_dep_batch(x, x[0], x[0], sl_in)


# --- frontier_crit_lanes_batch: one launch, a ticket, vector loads (#2) ----


def _crit_inputs(rng, b, n, k, per_lane, offset=0):
    """(d, status, keys) on the host with NaN, -0 / +0 ties and +inf holes;
    ``offset`` floats into a larger buffer, so rows start off 16 bytes."""
    d = rng.uniform(0, 5, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.2] = np.inf
    d[rng.random((b, n)) < 0.05] = 0.0
    d[rng.random((b, n)) < 0.05] = -0.0
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    if n > 3:
        d[0, 3], status[0, 3] = np.nan, 1
    keys = None
    if k:
        shape = (k, b, n) if per_lane else (k, n)
        keys = rng.uniform(0, 1, shape).astype(np.float32)
        keys[rng.random(shape) < 0.1] = -0.0
        keys[rng.random(shape) < 0.1] = 0.0

    def place(x):
        buf = np.zeros(x.size + offset, x.dtype)
        buf[offset:] = x.reshape(-1)
        return buf, x.shape
    return [place(x) for x in (d, status)] + ([place(keys)] if k else [])


def _on_card(placed, dev, offset):
    return [torch.from_numpy(buf).to(dev)[offset:].view(shape)
            for buf, shape in placed]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [4096, 1001, 999, 37, 3])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k,per_lane", [(0, False), (1, False), (1, True),
                                        (4, False), (4, True)])
def test_frontier_crit_one_launch_matches_twin(cuda, k, per_lane, b, n,
                                               offset):
    """n % 4 in {0, 1, 3}, rows shorter than one block, tensors starting off
    a 16-byte boundary; -0 ties, NaN, all three key forms; five calls in a
    row, each one launch, each bit-equal (the ticket is back at 0 after
    every call)."""
    rng = np.random.default_rng(k * 1000 + b * 10 + n + offset)
    args = _on_card(_crit_inputs(rng, b, n, k, per_lane, offset), cuda,
                    offset)
    keys = args[2] if k else None
    w_mins, w_cnt = ref.frontier_crit_lanes_batch_ref(args[0], args[1], keys)
    for _ in range(5):
        before = frontier_crit_lanes_batch.launches
        mins, cnt = frontier_crit_lanes_batch(args[0], args[1], keys)
        assert frontier_crit_lanes_batch.launches == before + 1
        assert _same_bits(mins, w_mins) and _same_bits(cnt, w_cnt)


def test_frontier_crit_many_lanes_and_calls(cuda):
    """70 lanes (more than a wave's blocks a lane), then 50 calls in a row
    on alternating inputs: the scratch is reused and the ticket reset."""
    rng = np.random.default_rng(70)
    big = _on_card(_crit_inputs(rng, 70, 5000, 8, True), cuda, 0)
    small = _on_card(_crit_inputs(rng, 8, 100_003, 1, False), cuda, 0)
    want = {id(x): ref.frontier_crit_lanes_batch_ref(*x)
            for x in (big, small)}
    outs = []
    for i in range(50):
        x = big if i % 2 else small
        outs.append((x, frontier_crit_lanes_batch(*x)))
    for x, (mins, cnt) in outs:
        w_mins, w_cnt = want[id(x)]
        assert _same_bits(mins, w_mins) and _same_bits(cnt, w_cnt)


# --- the dense single sweeps on the pipelined body (#4, #5, #6) -------------


@pytest.mark.parametrize("body", ["pipelined", "single_sweep"])
@pytest.mark.parametrize("v,b,n,rows,d", [(1, 8, 3000, 3000, 152),
                                          (2, 8, 3000, 3000, 40),
                                          (3, 5, 900, 411, 9),
                                          (1, 1, 5000, 5000, 1000),
                                          (2, 1, 64, 64, 3)])
def test_dense_sweep_bodies_match_twin(cuda, body, v, b, n, rows, d):
    """#6 through its wrapper (the pipelined body) and both bodies through
    the C entry point; -0 weights, NaN gates, more than 8 lanes, rows wider
    than a stage (D = 1000), n_rows != n."""
    from repro_torch.kernels import ell_relax_keys as erk
    from repro_torch.kernels.config import RELAX_THREADS, relax_threads_per_row

    rng = np.random.default_rng(v * 31 + b + n + d)
    cols, ws = _ell(rng, rows, d, n + 1)
    ws[rng.random(ws.shape) < 0.1] = -0.0
    ws[rng.random(ws.shape) < 0.1] = 0.0
    x = _dense(rng, (v, b, n), nan=True)
    x[rng.random(x.shape) < 0.1] = 0.0
    vecs, tc, tw = _t(x, cuda), _t(cols, cuda), _t(ws, cuda)
    want = ref.ell_gather_min_batch_ref(vecs, tc, tw)
    if body == "pipelined":
        got = ell_gather_min_batch(vecs, tc, tw)
    else:
        got = torch.empty_like(want)
        lanes = v * b
        packed = erk.packed_scratch(lanes, n + 1, cuda)
        erk.launch("single sweep", "ell_gather_min_launch", cuda,
                   vecs.data_ptr(), n, n + 1, lanes, tc.data_ptr(),
                   tw.data_ptr(), rows, d, relax_threads_per_row(d),
                   RELAX_THREADS, packed.data_ptr(), None, got.data_ptr())
    assert _same_bits(got, want)


@pytest.mark.parametrize("b", [1, 8, 13])
def test_key_min_on_the_pipelined_body(cuda, b):
    """#5 and its B = 1 view #4 (a one-lane gate is the packed table as it
    stands: no pack), on a gate of 0 / +inf as unsettled gates are."""
    rng = np.random.default_rng(b)
    n, d = 4000, 152
    cols, ws = _ell(rng, n, d, n + 1)
    ws[rng.random(ws.shape) < 0.1] = -0.0
    gate = np.where(rng.random((b, n + 1)) < 0.6, 0.0, np.inf).astype(
        np.float32)
    gate[:, n] = np.inf
    args = (_t(gate, cuda), _t(cols, cuda), _t(ws, cuda))
    assert _same_bits(ell_key_min_batch(*args),
                      ref.ell_key_min_batch_ref(*args))
    row = args[0][b - 1].contiguous()
    assert _same_bits(ell_key_min(row, *args[1:]),
                      ref.ell_key_min_ref(row, *args[1:]))


# --- sliced views with more buckets than one launch takes -------------------


def _many_bucket_views(dev):
    """kronecker(10) sliced at 40 boundaries, pad multiple 1: more than 16
    buckets with rows on either side, so every pass runs in groups."""
    g = kronecker(10, seed=3, device=dev)
    kw = dict(pad_multiple=1, boundaries=tuple(range(1, 41)))
    views = to_ell_in_sliced(g, **kw), to_ell_out_sliced(g, **kw)
    for v in views:
        assert sum(1 for s in v.slices if s.rows.shape[0]) > 16
    return g, views


@pytest.mark.parametrize("b", [1, 8, 13])
def test_many_bucket_views_match_twins(cuda, b):
    g, (sl_in, sl_out) = _many_bucket_views(cuda)
    n = g.n
    rng = np.random.default_rng(b + 40)
    dm = np.full((b, n), np.inf, np.float32)
    live = rng.random((b, n)) < 0.05
    dm[live] = rng.uniform(0, 10, live.sum()).astype(np.float32)
    dm[np.arange(b), rng.integers(0, n, b)] = np.nan
    tdm = _t(dm, cuda)
    for view, sparse in ((sl_in, True), (sl_out, False)):
        x = tdm[None] if sparse else _t(_dense(rng, (2, b, n), nan=True), cuda)
        assert _same_bits(
            ell_sliced_gather_min_batch(x, view, sparse=sparse),
            ref.ell_sliced_gather_min_batch_ref(x, view))
    pull = ref.ell_sliced_gather_min_batch_ref(tdm[None], sl_in)[0]
    push = ell_sliced_push_relax_batch(tdm, sl_out)
    assert _same_bits(push, ref.ell_push_relax_batch_ref(tdm, sl_out))
    assert _same_bits(push, pull)
    parts = [_t(_dense(rng, (2, b, n), nan=i == 0), cuda) for i in range(3)]
    w_upd, w_keys = ref.ell_sliced_relax_keys_batch_ref(tdm, *parts, sl_in)
    for out_view in (None, sl_out):
        upd, keys = ell_sliced_relax_keys_batch(tdm, *parts, sl_in,
                                                out_view=out_view)
        assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)
    got = ell_sliced_keys_dep_batch(parts[0], parts[1][0], parts[2][0],
                                    sl_out, dep_idx=1)
    assert _same_bits(got, ref.ell_sliced_keys_dep_batch_ref(
        parts[0], parts[1][0], parts[2][0], 1, sl_out))


@pytest.mark.parametrize("criterion", ["instatic|outstatic", "in|out"])
def test_many_bucket_solves_match_padded(cuda, criterion):
    g, (sl_in, sl_out) = _many_bucket_views(cuda)
    sources = [0, 11, g.n - 1, 5, 77]
    a = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion,
                                ell=sl_in, ell_out=sl_out)
    c = run_phased_static_batch(g, sources, trace_len=16, criterion=criterion)
    for f in ("dist", "status", "phases", "total_phases", "settled_per_phase"):
        assert _same_bits(getattr(a, f), getattr(c, f)), f
    for f in ("sum_fringe", "relax_edges"):
        assert np.array_equal(getattr(a, f), getattr(c, f))


@pytest.mark.parametrize("b", [1, 3, 8, 13])
@pytest.mark.parametrize("n,d,rows", [(3000, 152, 3000), (900, 9, 411),
                                      (5000, 1000, 5000)])
def test_key_min_status_matches_twin_and_f32(cuda, b, n, d, rows):
    """The status-gate table path against its twin and against the f32
    path (#5 on the padded gate, #6 at V = 1) on the same "unsettled" gate:
    -0 and NaN weights, ids up to the sentinel, more than 8 lanes, rows
    wider than a stage, n_rows != n."""
    rng = np.random.default_rng(b * 7 + n + d)
    cols, ws = _ell(rng, rows, d, n + 1)
    ws[rng.random(ws.shape) < 0.1] = -0.0
    ws[rng.random(ws.shape) < 0.1] = 0.0
    ws.reshape(-1)[5] = np.nan
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    gate = np.where(status < 2, 0.0, np.inf).astype(np.float32)
    ts, tc, tw = _t(status, cuda), _t(cols, cuda), _t(ws, cuda)
    before = ell_key_min_status_batch.launches
    got = ell_key_min_status_batch(ts, tc, tw)
    assert ell_key_min_status_batch.launches == before + 1
    assert _same_bits(got, ref.ell_key_min_status_batch_ref(ts, tc, tw))
    tg = _t(gate, cuda)
    assert _same_bits(got, ell_key_min_batch(ops.pad_lane_batch(tg), tc, tw))
    assert _same_bits(got[None], ell_gather_min_batch(tg[None], tc, tw))
