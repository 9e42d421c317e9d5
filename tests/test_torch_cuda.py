"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Floats compare bit for bit, with every NaN taken as one value (IEEE leaves
NaN payloads open).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import (
    EllSlice,
    from_coo,
    run_phased_static_batch,
    sliced_ell,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_buckets,
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
    ell_delta_push_batch,
    ell_push_rect_batch,
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
    ell_sliced_delta_push_batch,
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_push_relax_batch,
    ell_sliced_relax_keys_batch,
)
from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch
from test_torch_lm_train_tol import train_tol

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


def _fields_that_differ(got, want) -> list[str]:
    """The fields of two results (NamedTuples of tensors or None) that are
    not the same bits, or that one of them lacks."""
    bad = []
    for nm in got._fields:
        a, b = getattr(got, nm), getattr(want, nm)
        if (a is None) != (b is None) or (a is not None
                                          and not _same_bits(a, b)):
            bad.append(nm)
    return bad


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


@pytest.mark.parametrize("P,rank", [(1, 0), (2, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("b,live", [(1, 0.05), (8, 0.3), (13, 0.02),
                                    (40, 0.01), (8, 1.0)])
@pytest.mark.parametrize("signed", [False, True])
def test_ell_push_rect_batch_matches_twin(cuda, P, rank, b, live, signed):
    """The rectangular push of the sharded stepper: one rank's block of
    G(3000, 3e-3) pushed to global targets, against its twin (the COO
    segment-min) and, where the block is the whole graph's rows, against
    the square push; sparse and dense dmask, NaN / -inf lanes, -0 and +0
    weights and dmask values."""
    from repro_torch.core.distributed import shard_graph_batch
    from repro_torch.core.graph import from_coo

    g = uniform_gnp(3000, 3e-3, seed=P + rank, device=cuda)
    if signed:
        table = torch.tensor(_VALUES, device=cuda)
        w = table[(g.w.clamp(0, 0.999) * 4).long()]
        g = from_coo(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                     w.cpu().numpy(), g.n, device=cuda)
    sg = shard_graph_batch(g, P, rank=rank)
    rng = np.random.default_rng(b * 7 + rank)
    dm = _push_dmask(rng, b, sg.n_loc, live)
    if signed:
        dm = np.where(np.isfinite(dm) & (dm > 0),
                      _VALUES[rng.integers(0, 4, dm.shape)], dm)
    tdm = _t(dm.astype(np.float32), cuda)
    before = ell_push_rect_batch.launches
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = ell_push_rect_batch(tdm, *sg.ell_out, sg.n_pad, stats=stats)
    assert ell_push_rect_batch.launches == before + 1
    assert got.shape == (b, sg.n_pad)
    assert _same_bits(got, ref.ell_push_rect_batch_ref(tdm, *sg.ell_out,
                                                        sg.n_pad))
    real = torch.isfinite(sg.w)
    assert _same_bits(got, ref.push_coo_batch_ref(
        tdm, sg.src_local[real], sg.dst[real], sg.w[real], sg.n_pad))
    live_rows = (tdm != np.inf).any(dim=0)
    assert int(stats[0]) == int(
        ((tdm != np.inf).sum(dim=0) * sg.out_deg).sum())
    assert live_rows.any() or int(stats[1]) == 0
    if P == 1:  # one block holds every row: the square push's bits
        assert _same_bits(got, ell_push_relax_batch(tdm, *sg.ell_out))


def test_push_rect_cuda_tensors_never_fall_back(cuda):
    dm = torch.zeros((2, 4), device=cuda)
    cols = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ws = torch.zeros((4, 2), dtype=torch.float32)  # on the host: refused
    with pytest.raises(ValueError, match="different devices"):
        ell_push_rect_batch(dm, cols, ws, 9)
    with pytest.raises(ValueError, match="one row per owner"):
        ell_push_rect_batch(dm, cols[:3].contiguous(), ws[:3].to(cuda), 9)


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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", range(9))
def test_frontier_crit_every_key_count_matches_twin(cuda, k, offset):
    """Every key count the kernel takes (0 to KMAX = 8) on aligned rows and
    on rows off a 16-byte boundary: the instances whose unroll, and for
    K > 4 off the boundary the key-at-a-time fold, were set so that ptxas
    spills none (the audit's resource check); shared and per-lane keys,
    -0 ties and NaN, bit-equal to the twin."""
    for per_lane in ((False, True) if k else (False,)):
        for b, n in ((8, 4096), (3, 1001)):
            rng = np.random.default_rng(100 * k + 10 * b + offset)
            args = _on_card(_crit_inputs(rng, b, n, k, per_lane, offset),
                            cuda, offset)
            keys = args[2] if k else None
            mins, cnt = frontier_crit_lanes_batch(args[0], args[1], keys)
            w_mins, w_cnt = ref.frontier_crit_lanes_batch_ref(args[0],
                                                              args[1], keys)
            assert _same_bits(mins, w_mins) and _same_bits(cnt, w_cnt), (
                k, per_lane, b, n, offset)


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


# ---------------------------------------------------------------------------
# s->t: the bound-gated relax, the batcher and point queries on the card
# ---------------------------------------------------------------------------


def _gated_inputs(rng, b, n, dev):
    """d, a settle mask and per-lane bounds that cut some sources (a median
    of the lane's settled d, or 1.0) and none (+inf)."""
    d = rng.uniform(0, 4, (b, n)).astype(np.float32)
    settle = rng.random((b, n)) < 0.2
    bound = np.empty(b, np.float32)
    for i in range(b):
        bound[i] = (np.median(d[i][settle[i]]) if i % 3 == 0 else
                    np.inf if i % 3 == 1 else 1.0)
    td, ts, tb = _t(d, dev), _t(settle, dev), _t(bound, dev)
    gated = ops._bound_gate(td, ts, tb)
    assert 0 < int(gated.sum()) < int(ts.sum())  # the bound cuts sources
    if b > 1:
        assert bool(gated[1].eq(ts[1]).all())  # +inf cuts none
    return td, ts, tb


@pytest.mark.parametrize("b", [1, 8, 13])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_gated_push_matches_twin_and_gated_pull(cuda, layout, b):
    rng = np.random.default_rng(b + len(layout))
    if layout == "padded":
        g = uniform_gnp(3000, 3e-3, seed=5, device=cuda)
        out_v, in_v = to_ell_out(g), to_ell_in(g)
        fn, counter = ops.push_settled_gated_batch, ell_push_relax_batch
        args = out_v
    else:
        g = kronecker(11, seed=4, device=cuda)
        out_v, in_v = to_ell_out_sliced(g), to_ell_in_sliced(g)
        fn, counter = ops.push_settled_gated_batch_sliced, \
            ell_sliced_push_relax_batch
        args = (out_v,)
    d, settle, bound = _gated_inputs(rng, b, g.n, cuda)
    before = counter.launches
    got = fn(d, settle, bound, *args)
    assert counter.launches == before + 1
    assert _same_bits(got, fn(d, settle, bound, *args, use_kernels=False))
    assert _same_bits(got, ops.relax_settled_gated_batch(d, settle, bound,
                                                         in_v))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("layout", ["padded", "sliced", "sliced_push"])
def test_gated_in_scans_match_twins(cuda, layout, k):
    b = 8
    rng = np.random.default_rng(k * 10 + len(layout))
    if layout == "padded":
        g = uniform_gnp(3000, 3e-3, seed=5, device=cuda)
        ell, out_view = to_ell_in(g), None
    else:
        g = kronecker(11, seed=4, device=cuda)
        ell = to_ell_in_sliced(g)
        out_view = to_ell_out_sliced(g) if layout == "sliced_push" else None
    d, settle, bound = _gated_inputs(rng, b, g.n, cuda)
    parts = [tuple(_t(_dense(rng, (b, g.n)), cuda) for _ in range(3))
             for _ in range(k)]
    kernel = (ell_relax_keys_batch if layout == "padded"
              else ell_sliced_relax_keys_batch)
    attr = "push_launches" if out_view is not None else "launches"
    before = getattr(kernel, attr)
    upd, keys = ops.in_scan_relax_keys_gated_batch(d, settle, bound, parts,
                                                   ell, out_view=out_view)
    assert getattr(kernel, attr) == before + 1
    w_upd, w_keys = ops.in_scan_relax_keys_gated_batch(
        d, settle, bound, parts, ell, out_view=out_view, use_kernels=False)
    assert _same_bits(upd, w_upd) and _same_bits(keys, w_keys)
    # the gate reaches the relax alone: the ungated call on the gated mask
    gated = ops._bound_gate(d, settle, bound)
    u2, k2 = ops.in_scan_relax_keys_batch(d, gated, parts, ell,
                                          out_view=out_view)
    assert _same_bits(upd, u2) and _same_bits(keys, k2)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("criterion,layout", [
    ("instatic|outstatic", "padded"), ("in|out", "padded"),
    ("instatic|outstatic", "sliced"), ("in|out", "sliced")])
def test_batcher_and_points_on_the_card_match_plain_and_host(cuda, criterion,
                                                             layout):
    """ContinuousBatcher (full and point requests, duplicates, a cache) and
    PointBackend on the card with the kernels, bit-equal to the card's
    plain twins and to the CPU port on the same trace."""
    from repro_torch.serving import (
        ContinuousBatcher,
        DistCache,
        PointBackend,
        StaticBackend,
    )

    rng = np.random.default_rng(5)
    n = 600
    trace = [(int(s), int(t) if t >= 0 else None)
             for s, t in zip(rng.integers(0, 40, 14),
                             np.where(rng.random(14) < 0.5,
                                      rng.integers(0, n, 14), -1))]
    pairs = rng.integers(0, n, (3, 2))
    runs = []
    for dev, use_kernels in ((cuda, True), (cuda, False), ("cpu", False)):
        g = uniform_gnp(n, 0.02, seed=3, device=dev)
        be = StaticBackend(g, criterion=criterion, layout=layout,
                           use_kernels=use_kernels, point_queries=True,
                           device=dev)
        server = ContinuousBatcher(g, lanes=4, phases_per_step=6, backend=be,
                                   cache=DistCache(), clock=_Clock(),
                                   point_queries=True)
        before = frontier_crit_lanes_batch.launches
        done = []
        for i, (s, t) in enumerate(trace):
            server.submit(s, target=t)
            if i % 4 == 3:
                done += server.step()
        done += server.drain(max_steps=10_000)
        if use_kernels:
            assert frontier_crit_lanes_batch.launches > before
        pb = PointBackend(g, criterion=criterion, layout=layout,
                          use_kernels=use_kernels, phases_per_chunk=3,
                          device=dev)
        points = [pb.query(s, t) for s, t in pairs]
        runs.append((done, server.metrics.report(), points))
    want_done, want_rep, want_pts = runs[0]
    assert len(want_done) == len(trace)
    for done, rep, pts in runs[1:]:
        assert rep == want_rep
        assert [(r.req_id, r.lane, r.phases, r.cache_hit, r.coalesced)
                for r in done] == [(r.req_id, r.lane, r.phases, r.cache_hit,
                                    r.coalesced) for r in want_done]
        for a, b in zip(want_done, done):
            assert np.array_equal(a.dist.view(np.int32), b.dist.view(np.int32))
        for a, b in zip(want_pts, pts):
            assert (a.distance, a.phases_forward, a.phases_backward, a.mu,
                    a.meeting_vertex, a.unreachable_certified) == \
                (b.distance, b.phases_forward, b.phases_backward, b.mu,
                 b.meeting_vertex, b.unreachable_certified)
            assert np.array_equal(a.dist.view(np.int32), b.dist.view(np.int32))


def test_meeting_vertex_on_the_card_is_the_first_minimum(cuda):
    from repro_torch.serving.point import _meet

    for df, db, want in (([2.0, 0.5, 2.0, 0.5], [0.5, 1.0, 0.0, 1.0], 1),
                         ([np.inf] * 5, [np.inf] * 5, 0),
                         ([0.0, -0.0, 0.0], [-0.0, -0.0, 0.0], 0)):
        a = _t(np.array([df], np.float32), cuda)
        b = _t(np.array([db], np.float32), cuda)
        assert _meet(a, b)[1] == want
        assert int(torch.argmin(a[0] + b[0])) == want


# ---------------------------------------------------------------------------
# delta-stepping, oracle plans and the telemetry rings on the card
# ---------------------------------------------------------------------------

RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase", "fringe_per_phase",
                 "relax_per_phase", "settle_attribution")


def _results_same(a, b, fields=RESULT_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f
        else:
            assert _same_bits(x, y.to(x.device)), f


@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("b", [1, 8, 13])
def test_weight_gated_gathers_match_twins(cuda, layout, b):
    g = uniform_gnp(2000, 5e-3, seed=11, device=cuda)
    ell = to_ell_in_sliced(g) if layout == "sliced" else to_ell_in(g)
    rng = np.random.default_rng(b)
    d = rng.uniform(0, 2, (b, g.n)).astype(np.float32)
    light = rng.random((b, g.n)) < 0.03
    heavy = rng.random((b, g.n)) < 0.03
    heavy[0] = False  # a lane on its light round: an all-+inf heavy gate
    d, light, heavy = (_t(x, cuda) for x in (d, light, heavy))
    gather = (ell_sliced_gather_min_batch if layout == "sliced"
              else ell_key_min_batch)
    for delta in (0.1, 0.02):
        views = ops.weight_gated_ell(ell, torch.tensor(delta, device=cuda))
        before = gather.launches
        got = ops.delta_relax_batch(d, light, heavy, *views)
        assert gather.launches == before + 2  # the kernel, never the twin
        want = ops.delta_relax_batch(d, light, heavy, *views,
                                     use_kernels=False)
        assert _same_bits(got, want)


def _delta_inputs(rng, b, n, overlap):
    """d with NaN, -inf, +inf, +0 and -0 slots; light and heavy sets of a
    few percent, disjoint within a lane unless ``overlap``."""
    d = rng.uniform(0, 2, (b, n)).astype(np.float32)
    for value, share in ((np.inf, 0.2), (np.nan, 0.01), (-np.inf, 0.01),
                         (0.0, 0.01), (-0.0, 0.01)):
        d[rng.random((b, n)) < share] = value
    light = rng.random((b, n)) < 0.05
    heavy = rng.random((b, n)) < 0.05
    if not overlap:
        heavy &= ~light
    return d, light, heavy


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("b", [1, 8, 40])
@pytest.mark.parametrize("layout", ["padded", "sliced", "groups"])
def test_delta_push_matches_twin_and_gated_gathers(cuda, layout, b, overlap):
    """#5c / #9c against their twin and the reference's two gathers (#5 /
    #9) over the weight-gated in-views, with weights tied to delta, signed
    zeros, NaN and -inf sources; the sliced push on the out-view's buckets
    and on the full view, and on a view of more than 16 buckets."""
    g = (uniform_gnp(3000, 3e-3, seed=5, device="cpu") if layout == "padded"
         else kronecker(12 if layout == "sliced" else 10, seed=6,
                        device="cpu"))
    # weights on {+0, -0, 0.5, 1}: delta = 0.5 ties with a quarter of them
    g = from_coo(g.src, g.dst, _signed_weights(g.w), g.n, device=cuda)
    kw = (dict(pad_multiple=1, boundaries=tuple(range(1, 25)))
          if layout == "groups" else {})
    if layout == "padded":
        ell_in, views = to_ell_in(g), [to_ell_out(g)]
        kern, gather = ell_delta_push_batch, ell_key_min_batch
    else:
        ell_in = to_ell_in_sliced(g, **kw)
        views = [to_ell_out_sliced(g, **kw), to_ell_out_buckets(g, **kw)]
        kern, gather = ell_sliced_delta_push_batch, ell_sliced_gather_min_batch
        if layout == "groups":
            assert len(views[0].slices) > 16  # two launch groups
    rng = np.random.default_rng(b + 7 * overlap + len(layout))
    d, light, heavy = (_t(x, cuda) for x in _delta_inputs(rng, b, g.n,
                                                          overlap))
    for delta in (0.5, 0.7):
        for view in views:
            args = (d, light, heavy, *(view if layout == "padded"
                                       else (view,)), delta)
            before = kern.launches
            got = kern(*args)
            assert kern.launches == before + 1  # the kernel, never the twin
            want = ref.ell_delta_push_batch_ref(d, light, heavy, view, delta)
            assert _same_bits(got, want)
        gated = ops.weight_gated_ell(ell_in, torch.tensor(delta,
                                                          device=cuda))
        before = gather.launches
        assert _same_bits(got, ops.delta_relax_batch(d, light, heavy,
                                                     *gated))
        assert gather.launches == before + 2


def _signed_weights(w):
    """w in [0, 1) onto {+0, -0, 0.5, 1} by value; +inf stays."""
    table = torch.tensor([0.0, -0.0, 0.5, 1.0], device=w.device)
    q = (w.clamp(0.0, 0.999) * 4).long()
    return torch.where(torch.isfinite(w), table[q], w).contiguous()


def test_delta_push_cuda_tensors_never_fall_back(cuda):
    d = torch.zeros((2, 4), device=cuda)
    on = torch.zeros((2, 4), dtype=torch.bool, device=cuda)
    cols = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ws = torch.zeros((4, 2), dtype=torch.float32)  # on the host: refused
    with pytest.raises(ValueError, match="different devices"):
        ell_delta_push_batch(d, on, on, cols, ws, 0.5)
    with pytest.raises(ValueError, match="different devices"):
        ell_delta_push_batch(d, on.cpu(), on, cols, ws.to(cuda), 0.5)
    view = _sliced_view("split", cuda)
    n = view.merge_idx.shape[0]
    d0, on0 = torch.zeros((2, n)), torch.zeros((2, n), dtype=torch.bool)
    with pytest.raises(ValueError, match="different devices"):
        ell_sliced_delta_push_batch(d0, on0, on0, view, 0.5)


@pytest.mark.parametrize("n", [4096, 4097, 4099])
def test_frontier_crit_on_bucket_ids(cuda, n):
    rng = np.random.default_rng(n)
    status = rng.integers(0, 3, (8, n)).astype(np.int32)
    bidx = np.floor(rng.uniform(0, 3, (8, n)) / np.float32(0.1))
    bidx = np.where(status == 1, bidx, np.inf).astype(np.float32)
    status[5] = 0  # an empty lane: +inf, no fringe
    args = (_t(bidx, cuda), _t(status, cuda), None)
    got = frontier_crit_lanes_batch(*args)
    want = ref.frontier_crit_lanes_batch_ref(*args)
    assert all(_same_bits(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_solves_match_plain_host_and_legacy(cuda, layout):
    from repro_torch.core import run_delta_stepping

    g = uniform_gnp(3000, 3e-3, seed=4, device=cuda)
    g_cpu = uniform_gnp(3000, 3e-3, seed=4, device="cpu")
    sources = [0, 5, 9, 17]
    kw = dict(criterion="delta", layout=layout, trace_len=600,
              telemetry=True)
    from repro_torch.core import static_engine as TS
    from repro_torch.kernels import frontier_crit as FC
    from repro_torch.kernels import settle_push as SP

    pair = (FC.delta_thresholds_batch, SP.ell_delta_settle_mark_batch,
            SP.ell_sliced_delta_settle_push_batch if layout == "sliced"
            else SP.ell_delta_settle_push_batch,
            SP.ell_delta_settle_tail_batch)
    others = (ell_key_min_batch, ell_sliced_gather_min_batch,
              ell_delta_push_batch, ell_sliced_delta_push_batch,
              frontier_crit_lanes_batch)
    before = [k.launches for k in pair + others]
    TS.reset_chunk_stats()
    got = run_phased_static_batch(g, sources, **kw)
    torch.cuda.synchronize()
    # a phase is delta's four launches, the dead phases of the last chunk
    # too; no gather, no #5c / #9c and no #2 runs
    stats = TS.chunk_stats()
    phases = stats.live_phases + stats.dead_phases
    assert stats.live_phases == int(got.total_phases)
    assert [k.launches - n for k, n in zip(pair + others, before)] == (
        [phases] * len(pair) + [0] * len(others))
    _results_same(got, run_phased_static_batch(g, sources, use_kernels=False,
                                               **kw))
    _results_same(got, run_phased_static_batch(g_cpu, sources, device="cpu",
                                               **kw))
    for i, s in enumerate(sources):
        leg = run_delta_stepping(g, s)
        assert _same_bits(leg.dist, got.dist[i])
        assert int(leg.phases) == int(got.phases[i])


@pytest.mark.parametrize("criterion", ["oracle", "instatic|outstatic|oracle",
                                       "in|out|oracle"])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_oracle_solves_match_plain_and_host(cuda, criterion, layout):
    from repro_torch.core import run_phased

    g = uniform_gnp(3000, 3e-3, seed=6, device=cuda)
    g_cpu = uniform_gnp(3000, 3e-3, seed=6, device="cpu")
    sources = [1, 40, 300]
    truth = run_phased_static_batch(g, sources).dist
    kw = dict(criterion=criterion, layout=layout, trace_len=400,
              telemetry=True)
    got = run_phased_static_batch(g, sources, dist_true=truth, **kw)
    _results_same(got, run_phased_static_batch(
        g, sources, dist_true=truth, use_kernels=False, **kw))
    _results_same(got, run_phased_static_batch(
        g_cpu, sources, dist_true=truth.cpu(), device="cpu", **kw))
    solo = run_phased(g, 40, criterion, dist_true=truth[1])
    assert _same_bits(solo.dist, got.dist[1])
    assert int(solo.phases) == int(got.phases[1])


@pytest.mark.parametrize("criterion", ["instatic|outstatic", "in|out",
                                       "delta"])
def test_telemetry_rings_match_plain_and_host(cuda, criterion):
    g = uniform_gnp(3000, 3e-3, seed=8, device=cuda)
    g_cpu = uniform_gnp(3000, 3e-3, seed=8, device="cpu")
    sources = [2, 7, 100, 2999]
    kw = dict(criterion=criterion, trace_len=600)
    on = run_phased_static_batch(g, sources, telemetry=True, **kw)
    _results_same(on, run_phased_static_batch(g, sources, telemetry=True,
                                              use_kernels=False, **kw))
    _results_same(on, run_phased_static_batch(g_cpu, sources, telemetry=True,
                                              device="cpu", **kw))
    off = run_phased_static_batch(g, sources, **kw)
    _results_same(on, off, RESULT_FIELDS[:7])
    assert torch.equal(on.fringe_per_phase.sum(dim=1).cpu(),
                       torch.from_numpy(on.sum_fringe))


def test_segment_min_and_oracle_tolerance_match_the_host(cuda):
    from repro_torch.core import bellman_ford
    from repro_torch.core.criteria import oracle_tolerance

    rng = np.random.default_rng(12)
    signed = np.array([0.0, -0.0, 0.5, 1.0, np.nan], np.float32)
    vals = signed[rng.integers(0, 4, 1 << 20)]  # ties of -0 and +0
    vals[rng.integers(0, 1 << 20, 40)] = np.nan
    idx = rng.integers(0, 5000, 1 << 20).astype(np.int32)
    want = ref.segment_min(torch.from_numpy(vals), torch.from_numpy(idx),
                           5003)
    got = ref.segment_min(_t(vals, cuda), _t(idx, cuda), 5003)
    assert _same_bits(got.cpu(), want)
    dt = rng.uniform(0, 1e4, 1 << 16).astype(np.float32)
    assert _same_bits(oracle_tolerance(_t(dt, cuda)).cpu(),
                      oracle_tolerance(torch.from_numpy(dt)))
    g = uniform_gnp(2000, 4e-3, seed=13, device=cuda)
    g_cpu = uniform_gnp(2000, 4e-3, seed=13, device="cpu")
    assert _same_bits(bellman_ford(g, 3).cpu(),
                      bellman_ford(g_cpu, 3, device="cpu"))


def _probed(entries):
    return {k: {f: e.get(f) for f in ("phases", "queries", "delta",
                                      "settle_attribution")}
            for k, e in entries.items()}


def test_portfolio_probe_on_the_kernels_matches_twins_and_host(cuda):
    """Every default candidate probed on the card with the kernels, with
    the twins and on the host: the same phases and attributions; the
    routed backend serves the host's rows."""
    from repro_torch.kernels.config import TuningLedger
    from repro_torch.serving import (
        DEFAULT_CANDIDATES,
        ContinuousBatcher,
        PortfolioBackend,
        graph_family,
        measure_portfolio,
    )

    g = kronecker(10, seed=3, device=cuda)
    g_cpu = kronecker(10, seed=3, device="cpu")
    assert graph_family(g) == graph_family(g_cpu)
    led = TuningLedger()
    on = measure_portfolio(g, lanes=4, ledger=led, repeats=1)
    plain = measure_portfolio(g, lanes=4, ledger=TuningLedger(), repeats=1,
                              use_kernels=False)
    host = measure_portfolio(g_cpu, lanes=4, ledger=TuningLedger(),
                             repeats=1)
    assert _probed(on) == _probed(plain) == _probed(host)
    assert len(on) == len(DEFAULT_CANDIDATES)
    pb = PortfolioBackend(g, lanes_hint=4, ledger=led)
    server = ContinuousBatcher(g, lanes=4, backend=pb)
    for s in (0, 17, 300, 1023, 17):
        server.submit(s)
    for r in server.drain(max_steps=100_000):
        want = run_phased_static_batch(
            g_cpu, [r.source], criterion=pb.criterion,
            layout=pb.choice.layout, delta=pb.choice.resolve_delta(g_cpu),
            device="cpu").dist[0]
        assert _same_bits(torch.from_numpy(r.dist.copy()), want)


def test_verify_row_on_the_card_matches_the_host(cuda):
    from repro_torch.serving import verify_row

    rng = np.random.default_rng(5)
    n, m = 4000, 40000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.choice(np.array([0.0, -0.0, 0.5, 1.0, 0.25], np.float32), m)
    g = from_coo(src, dst, w, n, device=cuda)
    g_cpu = from_coo(src, dst, w, n, device="cpu")
    for s in (0, 9, 3999):
        clean = run_phased_static_batch(g, [s]).dist[0].cpu().numpy()
        assert verify_row(g, clean, s) is None
        neg0 = clean.copy()
        neg0[(clean == 0) & (np.arange(n) != s)] = -0.0  # ties of ±0
        rows = [neg0]
        for v in rng.integers(0, n, 40):
            for val in (np.nan, -1.0, 1.0, 0.0, clean[v] + 0.5, 7.0):
                bad = neg0.copy()
                bad[v] = val
                rows.append(bad)
        for row in rows:
            assert verify_row(g, row, s) == verify_row(g_cpu, row, s)
            assert verify_row(g, row, s, target=1) == \
                verify_row(g_cpu, row, s, target=1)
    cols_d, ws_d = g.__dict__["_verify_edges"]
    assert cols_d.is_cuda and ws_d.is_cuda
    before = ell_key_min_batch.launches
    assert verify_row(g, clean, s) is None
    assert ell_key_min_batch.launches == before + 1  # best through #5
    # a graph served on the sliced layout: #9 over its sliced in-view
    g_s = from_coo(src, dst, w, n, device=cuda)
    to_ell_out_sliced(g_s)
    before = ell_sliced_gather_min_batch.launches
    for row in rows:
        assert verify_row(g_s, row, s) == verify_row(g_cpu, row, s)
    assert ell_sliced_gather_min_batch.launches > before
    assert hasattr(g_s.__dict__["_verify_edges"], "slices")
    assert not g_s.__dict__.get("_ell_in_cache")


def test_analysis_card_checks_find_nothing(cuda):
    """The audit's card checks (``python -m repro_torch.analysis``): every
    kernel's ptxas resources within the card's limits, every case of every
    contract written in full on a poisoned allocator, 3 runs alike."""
    from repro_torch.analysis.kernel_audit import audit_card

    findings, rows, stats = audit_card()
    assert findings == [], [str(f) for f in findings]
    assert len(rows) == 19 and stats["poisoned_cells"] == 0


# ---- the LM substrate's serving path (no kernel of its own: its products
# are torch matmuls and einsums, as the reference's are jnp.einsum) -------

LM_B, LM_S, LM_STEPS = 2, 32, 3


@pytest.fixture
def full_f32():
    """f32 products in full f32 on the card for the test (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _lm_inputs(cfg, dev):
    rng = np.random.default_rng(0)
    batch = {}
    toks = rng.integers(0, cfg.vocab, (LM_B, LM_S + LM_STEPS))
    if cfg.embeddings_in:
        batch["embeds"] = (0.1 * rng.standard_normal(
            (LM_B, LM_S, cfg.d_model))).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :LM_S]
    if cfg.n_vision_tokens:
        batch["vision"] = (0.02 * rng.standard_normal(
            (LM_B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    return ({k: _t(v, dev) for k, v in batch.items()}, toks[:, LM_S:])


def _lm_check(got, want, tol):
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol,
                               atol=tol)


def _lm_card_against_host(arch, dtype, tol, dev):
    from repro_torch.configs import get_smoke
    from repro_torch.models import (decode_step, forward_logits, init_params,
                                    prefill)

    cfg = get_smoke(arch)
    card = init_params(cfg, seed=0, dtype=dtype, device=dev)
    host = copy.deepcopy(card).cpu()
    b_d, nxt = _lm_inputs(cfg, dev)
    b_h = {k: v.cpu() for k, v in b_d.items()}
    _lm_check(forward_logits(cfg, card, b_d), forward_logits(cfg, host, b_h),
              tol)
    if cfg.encoder_only:
        with pytest.raises(ValueError, match="encoder-only"):
            prefill(cfg, card, b_d)
        return
    lg_d, c_d, pos_d = prefill(cfg, card, b_d)
    lg_h, c_h, pos_h = prefill(cfg, host, b_h)
    for i in range(LM_STEPS + 1):
        assert pos_d == pos_h == LM_S + i
        _lm_check(lg_d, lg_h, tol)
        for unit_d, unit_h in zip(c_d, c_h, strict=True):
            for lname, entry in unit_h.items():
                for leaf, want in entry.items():
                    _lm_check(unit_d[lname][leaf], want, tol)
        if i == LM_STEPS:
            break
        tok = nxt[:, i:i + 1]
        lg_d, c_d, pos_d = decode_step(cfg, card, _t(tok, dev), c_d, pos_d)
        lg_h, c_h, pos_h = decode_step(cfg, host, _t(tok, "cpu"), c_h, pos_h)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_smoke_on_the_card_matches_the_host(cuda, full_f32, arch):
    """Every smoke config, f32: forward_logits, prefill (logits and every
    cache leaf) and 3 decode steps on the card against the same weights on
    the CPU, rtol = atol = 1e-4."""
    _lm_card_against_host(arch, torch.float32, 1e-4, cuda)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_1_3b"])
def test_lm_bf16_on_the_card_stays_there_and_near_the_host(cuda, arch):
    """bf16 serving keeps every tensor on the card; against the CPU's bf16
    within the two backends' bf16 rounding (atol = rtol = 6e-2, the bound
    the CPU tests measured against the reference)."""
    _lm_card_against_host(arch, torch.bfloat16, 6e-2, cuda)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_and_grads_on_the_card_match_the_host(cuda, full_f32,
                                                            arch):
    """Every smoke config, f32: ``train_loss`` under remat none, "full"
    and "dots" and the gradient of every parameter on the card against the
    same weights and batch on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.models import init_params, train_loss

    cfg = get_smoke(arch)
    loss_rtol, g_rtol, g_atol = train_tol(cfg)
    card = init_params(cfg, seed=0, device=cuda).requires_grad_()
    host = copy.deepcopy(card).cpu()
    b_d = batch_for(cfg, DataConfig(batch=LM_B, seq_len=LM_S), 0,
                    device=cuda)
    b_h = {k: v.cpu() for k, v in b_d.items()}
    for remat, policy in [(False, "full"), (True, "full"), (True, "dots")]:
        runs = []
        for model, batch in ((card, b_d), (host, b_h)):
            loss = train_loss(cfg, model, batch, remat=remat,
                              remat_policy=policy)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            runs.append((loss, grads))
        (loss_d, g_d), (loss_h, g_h) = runs
        assert loss_d.device.type == "cuda"
        torch.testing.assert_close(loss_d.cpu(), loss_h, rtol=loss_rtol,
                                   atol=0)
        for (name, _), gd, gh in zip(card.named_parameters(), g_d, g_h):
            assert gd.device.type == "cuda", name
            scale = float(gh.abs().max())
            torch.testing.assert_close(gd.cpu(), gh, rtol=g_rtol,
                                       atol=g_atol * scale,
                                       msg=lambda m: f"{policy} {name}: {m}")


def test_lm_train_two_steps_on_the_card(cuda, full_f32, tmp_path):
    """``train()`` on the card (the default device) for 2 smoke steps (bf16
    m, factored v) with a checkpoint after each; the second step, resumed
    from the first's checkpoint on the card and on the CPU (the card's
    and the host's generators draw different weights, so both sides start
    from that checkpoint), gives the same loss; the checkpoint restores
    onto the card, and the entry points default to it."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.runtime.train_loop import train

    cfg = get_smoke("internlm2_1_8b")
    dcfg = DataConfig(batch=4, seq_len=32)
    ocfg = OptConfig(lr=5e-3, warmup_steps=1, total_steps=4,
                     m_dtype="bfloat16", v_mode="factored")
    card_dir, host_dir = tmp_path / "card", tmp_path / "host"
    first = train(cfg, 1, dcfg, ocfg, ckpt_dir=str(card_dir), ckpt_every=1)
    shutil.copytree(card_dir, host_dir)
    got = train(cfg, 2, dcfg, ocfg, ckpt_dir=str(card_dir), ckpt_every=1)
    want = train(cfg, 2, dcfg, ocfg, ckpt_dir=str(host_dir), ckpt_every=1,
                 device="cpu")
    assert got.restored_from == want.restored_from == 1
    assert first.skipped_steps == got.skipped_steps == 0
    assert np.isfinite(first.losses).all()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    shapes = init_params(cfg, device="meta")
    state = CheckpointManager(str(card_dir)).restore(
        2, {"params": shapes,
            "opt": init_opt_state(shapes, ocfg, device="meta")})
    assert state["params"].embed.device.type == "cuda"
    assert state["opt"]["m"]["embed"].device.type == "cuda"
    assert int(state["opt"]["step"]) == 2
    assert make_batch(dcfg, 0, cfg.vocab)["tokens"].device.type == "cuda"
    assert init_opt_state(state["params"], ocfg)["step"].device.type == "cuda"


# ---------------------------------------------------------------------------
# the LM substrate on a mesh: one sharded step of qwen3-moe smoke
# ---------------------------------------------------------------------------

MESH_B, MESH_S = 2, 64  # the expert-parallel gate is on at tp 1 and 2


def _plain_ep_loss_grads(cfg, model, batch, dp, tp):
    """``train_loss`` and its gradients on one device, each MoE layer the
    one-process twin of the (dp, tp) expert-parallel path."""
    from repro_torch.models import layers as L
    from repro_torch.models import train_loss

    def plain(cfg_, p, x, shd=None):
        if L.ep_gate(cfg_, x.shape[0], x.shape[1], dp, tp):
            return L.apply_moe_ep_plain(cfg_, p, x, dp, tp)
        return L.apply_moe(cfg_, p, x)

    saved, L.apply_moe = L.apply_moe, plain
    try:
        loss = train_loss(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        L.apply_moe = saved
    return loss.detach(), grads


def _sharded_step_against_plain(mesh, dev):
    """One sharded step of qwen3-moe smoke on ``mesh`` (FSDP over "data"),
    its loss and every gathered gradient against the plain twin's on the
    card; the router's named. Returns the worst gradient share."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.launch.steps import build_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.sharding.partition import gather_param, place_params

    cfg = get_smoke("qwen3_moe_235b")
    loss_rtol, g_rtol, g_atol = train_tol(cfg)
    step = build_step(cfg, "train_4k", mesh, fsdp=True, microbatches=1)
    whole = init_params(cfg, seed=0, device="cpu")
    plain = copy.deepcopy(whole).to(dev).requires_grad_()
    model = place_params(whole, mesh, step.param_specs)
    batch = batch_for(cfg, DataConfig(batch=MESH_B, seq_len=MESH_S), 0,
                      device=dev)
    loss, grads = value_and_grad(cfg, model, batch, _shd(mesh))
    want_loss, want = _plain_ep_loss_grads(cfg, plain, batch,
                                           mesh.shape["data"],
                                           mesh.shape["model"])
    assert loss.device == dev
    torch.testing.assert_close(loss, want_loss, rtol=loss_rtol, atol=0)
    names = [n for n, _ in plain.named_parameters()]
    assert any(n.endswith("moe.router") for n in names)
    for name, w in zip(names, want):
        g = gather_param(model, name, grads[name])
        assert g.device == dev, name
        torch.testing.assert_close(g, w, rtol=g_rtol,
                                   atol=g_atol * float(w.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
    state = init_opt_state(model, step.opt_cfg)
    loss2, gnorm = step.fn(model, state, batch)
    assert torch.isfinite(loss2) and torch.isfinite(gnorm)
    assert int(state["step"]) == 1


def _shd(mesh):
    from repro_torch.models.layers import ShardingCtx

    return ShardingCtx(dp=("data",), tp="model", mesh=mesh)


def _mesh_rank(rank, world, store):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, dev = init_group(rank, world, backend="gloo", init_method=store,
                           device="cuda:0")
    try:
        _sharded_step_against_plain(make_mesh(1, world, dev), dev)
    finally:
        dist.destroy_process_group()


def test_lm_sharded_step_gloo_world_of_2_on_the_card(cuda, full_f32,
                                                     tmp_path):
    """2 gloo ranks sharing cuda:0 as a (1, 2) mesh: the expert-parallel
    MoE's all-to-alls staged through host memory; the sharded loss and
    gradients against ``apply_moe_ep_plain(dp=1, tp=2)`` in one process,
    then one train step of ``build_step``."""
    import torch.multiprocessing as mp

    mp.spawn(_mesh_rank, args=(2, f"file://{tmp_path}/store"), nprocs=2)


def test_lm_sharded_step_nccl_world_of_one(cuda, full_f32, tmp_path):
    """An NCCL world of one, (1, 1): the same step, the gate on at tp 1,
    against ``apply_moe_ep_plain(dp=1, tp=1)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group, make_mesh

    _, _, dev = init_group(0, 1, backend="nccl",
                           init_method=f"file://{tmp_path}/nccl",
                           device="cuda:0")
    try:
        _sharded_step_against_plain(make_mesh(1, 1, dev), dev)
    finally:
        dist.destroy_process_group()


def _collectives_on_the_card(world, rank, dev):
    """Every collective of ``launch.collectives`` on CUDA tensors against
    its whole function, with staging buffers of 4 KiB so that a tensor
    takes many chunks (odd widths, f32 / int64)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives as coll

    saved, coll.STAGE_BYTES = coll.STAGE_BYTES, 4096
    try:
        def mine(r, dtype):
            gen = torch.Generator().manual_seed(r)
            return (torch.randn(3, 1001, generator=gen) * 100).to(dtype)

        for dtype in (torch.float32, torch.int64):
            every = torch.stack([mine(r, dtype) for r in range(world)])
            x = mine(rank, dtype).to(dev)
            kept = x.clone()
            got = coll.all_gather(None, dev, x)
            assert got.device == dev
            torch.testing.assert_close(got.cpu(), every, rtol=0, atol=0)
            got = coll.all_reduce(None, dev, x)
            torch.testing.assert_close(got.cpu(), every.sum(0), rtol=0,
                                       atol=1e-3)
            got = coll.all_reduce(None, dev, x, dist.ReduceOp.MIN)
            torch.testing.assert_close(got.cpu(), every.amin(0), rtol=0,
                                       atol=0)
            got = coll.broadcast(None, dev, x, world - 1)
            torch.testing.assert_close(got.cpu(), every[-1], rtol=0, atol=0)
            got = coll.reduce(None, dev, x, 0)
            if rank == 0:
                torch.testing.assert_close(got.cpu(), every.sum(0), rtol=0,
                                           atol=1e-3)
            rows = torch.stack([x[:, :1000]] * world) + rank
            got = coll.all_to_all(None, dev, rows)
            want = every[:, :, :1000] + torch.arange(world).view(
                world, 1, 1).to(dtype)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
            got = coll.reduce_scatter(None, dev, rows)
            torch.testing.assert_close(got.cpu(), want.sum(0), rtol=0,
                                       atol=1e-3)
            assert torch.equal(x, kept)  # no input is written
    finally:
        coll.STAGE_BYTES = saved


def _collectives_rank(rank, world, store):
    import torch.distributed as dist

    from repro_torch.launch.collectives import staged
    from repro_torch.launch.mesh import init_group

    _, _, dev = init_group(rank, world, backend="gloo", init_method=store,
                           device="cuda:0")
    try:
        assert staged(None, dev)
        _collectives_on_the_card(world, rank, dev)
    finally:
        dist.destroy_process_group()


def test_staged_collectives_gloo_world_of_2_on_the_card(cuda, tmp_path):
    """2 gloo ranks sharing cuda:0: each collective staged through pinned
    host chunks (the gather and the reduce-scatter as all-to-alls) gives
    its whole function on the card."""
    import torch.multiprocessing as mp

    mp.spawn(_collectives_rank, args=(2, f"file://{tmp_path}/store"),
             nprocs=2)


def test_collectives_nccl_world_of_one(cuda, tmp_path):
    """An NCCL world of one: NCCL's own collectives, on the card."""
    import torch.distributed as dist

    from repro_torch.launch.collectives import staged
    from repro_torch.launch.mesh import init_group

    _, _, dev = init_group(0, 1, backend="nccl",
                           init_method=f"file://{tmp_path}/nccl",
                           device="cuda:0")
    try:
        assert not staged(None, dev)
        _collectives_on_the_card(1, 0, dev)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rows,d", [
    ((2, 5), 7, 3), ((4, 2048), 92672, 64), ((8, 512), 1000, 300),
    ((1, 4096), 50, 2048), ((0,), 4, 8)])
def test_embed_grad_matches_twin_and_itself(cuda, shape, rows, d, dtype,
                                            offset):
    """The fixed-order embedding gradient against its twin, bit for bit,
    and two launches against each other: repeated ids (a token that takes
    a quarter of the positions), ids that never occur, D off the 16-byte
    width (one column a thread) and on it (16 bytes a thread), a gradient
    off a 16-byte boundary (``offset``), -0 gradients; f32 and bf16."""
    from repro_torch.kernels.embed_grad import embed_grad

    rng = np.random.default_rng(rows + d)
    ids = rng.integers(0, rows, size=shape).astype(np.int32)
    ids.reshape(-1)[::4] = rows // 2  # a hot token
    g = rng.standard_normal(shape + (d,)).astype(np.float32)
    g.reshape(-1, d)[::3, 0] = np.float32(-0.0)
    flat = _t(np.concatenate([np.zeros(offset, np.float32), g.reshape(-1)]),
              cuda).to(dtype)
    g_c, ids_c = flat[offset:].view(g.shape), _t(ids, cuda)
    before = embed_grad.launches
    got = embed_grad(g_c, ids_c, rows)
    again = embed_grad(g_c, ids_c, rows)
    want = ref.embed_grad_ref(g_c, ids_c, rows)
    torch.cuda.synchronize()
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))
    assert torch.equal(got.view(view), again.view(view))
    assert embed_grad.launches == before + (2 if rows else 0)


@pytest.mark.parametrize("row0", [0, 40, 120])
def test_embed_grad_block_form_matches_twin_and_itself(cuda, row0):
    """#12's block form (rows [row0, row0 + 40) of a 160-row table): ids
    before, inside and after the block, a hot id inside it; against its
    twin bit for bit and two launches against each other, each counted
    as a launch of the block form."""
    from repro_torch.kernels.embed_grad import embed_grad

    rng = np.random.default_rng(row0)
    ids = rng.integers(0, 160, size=(3, 50)).astype(np.int32)
    ids.reshape(-1)[::5] = row0 + 7
    g = rng.standard_normal((3, 50, 24)).astype(np.float32)
    g_c, ids_c = _t(g, cuda), _t(ids, cuda)
    before = (embed_grad.launches, embed_grad.block_launches)
    got = embed_grad(g_c, ids_c, 40, row0)
    again = embed_grad(g_c, ids_c, 40, row0)
    want = ref.embed_grad_ref(g_c, ids_c, 40, row0)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert (embed_grad.launches, embed_grad.block_launches) == (
        before[0] + 2, before[1] + 2)


def test_embed_grad_bit_stable_through_a_training_step(cuda):
    """internlm2's smoke config, f32: two runs of the loss and gradients on
    one card give every leaf, the embedding's included, in the same
    bits (the lookup's backward is the fixed-order kernel)."""
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.kernels.embed_grad import embed_grad
    from repro_torch.models import init_params
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.configs import get_smoke

    cfg = get_smoke("internlm2_1_8b")
    model = init_params(cfg, seed=0, device=cuda)
    batch = batch_for(cfg, DataConfig(batch=4, seq_len=64), 0, device=cuda)
    before = embed_grad.launches
    l1, g1 = value_and_grad(cfg, model, batch)
    l2, g2 = value_and_grad(cfg, model, batch)
    assert embed_grad.launches == before + 2
    assert torch.equal(l1, l2)
    assert [n for n in g1 if not torch.equal(g1[n], g2[n])] == []


def _states_same_bits(a, b) -> list:
    """The fields of two stepper states that differ (NaN as one value)."""
    import dataclasses

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x) and torch.is_tensor(y):
            if not _same_bits(x, y):
                bad.append(f.name)
        elif x != y:
            bad.append(f.name)
    return bad


CHUNK_CASES = {
    # name -> (criterion, layout, init kwargs, stop_on_lane_finish)
    "default_padded": ("instatic|outstatic", "padded", {}, False),
    "default_sliced": ("instatic|outstatic", "sliced", {}, False),
    "in_out": ("in|out", "padded", {}, False),
    "delta_sliced": ("delta", "sliced", {}, False),
    "delta_padded_targets_telemetry": ("delta", "padded",
                                       {"targets": [900, -1, 17, 2500],
                                        "telemetry": True, "trace_len": 5},
                                       True),
    "targets_stop": ("instatic|outstatic", "padded",
                     {"targets": [900, -1, 17, 2500]}, True),
    "telemetry_wraps": ("in|out", "sliced",
                        {"telemetry": True, "trace_len": 5}, False),
    "outsimple_sliced": ("outsimple", "sliced", {}, False),
    "dijk_targets": ("dijk", "padded", {"targets": [40, 2999, -1, 5]}, False),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_graph_replay_matches_the_eager_chunk(cuda, case):
    """``step_batch`` on the card replays its captured chunk; the same
    chunk run eagerly (never captured) gives every state field in the same
    bits, call after call; the key captures once, then only replays."""
    from repro_torch.core import static_engine as TS
    from repro_torch.core.graph import to_ell_out_buckets

    crit, layout, kw, stop = CHUNK_CASES[case]
    g = uniform_gnp(3000, 0.003, seed=4, device=cuda)
    sources = [0, 5, 1200, 2999]
    step_kw = {}
    if layout == "sliced":
        step_kw = ({"ell_out": to_ell_out_buckets(g)} if crit == "delta"
                   else {"ell": to_ell_in_sliced(g)})
    TS.forget_chunks(g)
    TS.reset_chunk_stats()
    graph_st = eager_st = TS.init_batch_state(g, sources, criterion=crit,
                                              device=cuda, **kw)
    j = TS.PHASES_PER_REPLAY
    for k in (1, j, 3 * j + 2, 1, 4 * g.n, 4 * g.n):
        graph_st = TS.step_batch(g, graph_st, k, stop_on_lane_finish=stop,
                                 **step_kw)
        eager_st = TS._step(g, eager_st, k, step_kw.get("ell"), True, stop,
                            step_kw.get("ell_out"), capture=False)
        torch.cuda.synchronize()
        assert _states_same_bits(graph_st, eager_st) == [], (case, k)
    stats = TS.chunk_stats()
    assert stats.captures == 1 and stats.replays > 0
    assert not TS.lanes_active(graph_st).any() or stop


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A chunk whose capture fails (here a host read inside the phase,
    legal eagerly, refused while capturing) raises: nothing goes back to
    an eager loop."""
    from repro_torch.core import static_engine as TS

    real = ops.crit_thresholds_batch

    def host_read(*a, **kw):
        out = real(*a, **kw)
        out[1].sum().item()
        return out

    monkeypatch.setattr(ops, "crit_thresholds_batch", host_read)
    g = uniform_gnp(500, 0.01, seed=2, device=cuda)
    st = TS.init_batch_state(g, [0, 1], device=cuda)
    with pytest.raises(RuntimeError, match="capturing the stepper's chunk"):
        TS.step_batch(g, st, 3 * TS.PHASES_PER_REPLAY)
    monkeypatch.undo()
    # the stepper captures and replays again after the failure
    res = TS.step_batch(g, st, 4 * g.n)
    want = TS.step_batch(g, st, 4 * g.n, use_kernels=False)
    assert _states_same_bits(res, want) == []


def test_a_capture_after_its_pools_graphs_are_freed(cuda, monkeypatch):
    """The captures share a memory pool while a graph captured into it
    lives; once every such graph is freed with its chunk, PyTorch frees the
    pool and refuses its id, so the next capture takes a new pool, and
    replays the same bits."""
    import gc

    from repro_torch.core import static_engine as TS

    monkeypatch.setattr(TS, "_POOLS", {})  # a pool of this test's own
    index = torch.cuda.current_device()
    pools = []
    for seed in (5, 6):
        g = uniform_gnp(400, 0.01, seed=seed, device=cuda)
        st = TS.init_batch_state(g, [0, 3], device=cuda)
        before = TS.capture_count()
        res = TS.step_batch(g, st, 4 * g.n)
        assert TS.capture_count() == before + 1
        want = TS.step_batch(g, st, 4 * g.n, use_kernels=False)
        assert _states_same_bits(res, want) == []
        pool, live = TS._POOLS[index]
        assert len(live) == 1
        pools.append(pool)
        TS.forget_chunks(g)
        del g, st, res, want
        gc.collect()
        assert len(live) == 0
    assert pools[0] != pools[1]


SETTLE_SHAPES = [(3, 10), (1, 13), (8, 11), (13, 13), (40, 11), (8, 3000),
                 (33, 700)]


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("i,shape", list(enumerate(SETTLE_SHAPES)))
def test_settle_pair_matches_its_twins(cuda, sliced, i, shape):
    """The settle mark, the worklist push and the tail against the plain
    twins, every field a phase writes bit for bit: signed zeros, NaN fault
    rows, target lanes, stop_on_lane_finish, the telemetry rings, 1 to 40
    lanes (two tiles)."""
    from repro_torch.kernels import registry as R
    from repro_torch.kernels import settle_push as SP
    from repro_torch.analysis.kernel_audit import to_device

    b, n = shape
    args, kw = R.fixture_settle(b, n, 300 + i, sliced=sliced,
                                signed=bool(i % 2), target=i % 2 == 0,
                                stop=i == 3, telemetry=i % 3 == 1)
    args, kw = to_device(args, cuda), to_device(kw, cuda)
    counts = [f.launches for f in (
        SP.ell_settle_mark_batch, SP.ell_sliced_settle_push_batch if sliced
        else SP.ell_settle_push_batch, SP.ell_settle_tail_batch)]
    got = SP.settle_phase_batch(*args, **kw)
    torch.cuda.synchronize()
    want = SP.settle_phase_batch(*args, **kw, use_kernels=False)
    assert _fields_that_differ(got, want) == []
    assert [f.launches for f in (
        SP.ell_settle_mark_batch, SP.ell_sliced_settle_push_batch if sliced
        else SP.ell_settle_push_batch, SP.ell_settle_tail_batch)] == [
            c + 1 for c in counts]
    # a dead phase (no budget left) writes nothing
    dead = SP.settle_phase_batch(*args, **kw, budget=0)
    assert _same_bits(dead.dist, args[0]) and _same_bits(dead.status, args[1])
    assert int(dead.trips) == 0 and int(dead.phases.sum()) == 0


def test_settle_pair_on_many_buckets_and_a_default_solve(cuda):
    """The sliced pair over more than 16 buckets (two push launches a
    call), and the default plan's solve on G(3000, 0.003): its phases
    launch #2 and the pair once each and no PR 15 push."""
    from repro_torch.core import out_degrees
    from repro_torch.core import static_engine as TS
    from repro_torch.core.graph import vertex_row_table
    from repro_torch.kernels import launch_counters
    from repro_torch.kernels import registry as R
    from repro_torch.kernels import settle_push as SP

    cpu = R.fixture_groups_graph()
    g = from_coo(cpu.src.numpy(), cpu.dst.numpy(), cpu.w.numpy(), cpu.n,
                 device=cuda)
    view = to_ell_out_sliced(g, pad_multiple=1, boundaries=tuple(range(1, 25)))
    assert sum(1 for s in view.slices if s.rows.shape[0]) > 16
    rng = np.random.default_rng(8)
    d = _t(rng.uniform(0, 4, (8, g.n)).astype(np.float32), cuda)
    st = _t(rng.integers(0, 3, (8, g.n)).astype(np.int32), cuda)
    mins, n_f = ref.frontier_crit_lanes_batch_ref(d, st,
                                                  g.out_min_static[None])
    args = (d, st, mins, n_f, n_f > 0, view, out_degrees(g), g.in_min_static)
    kw = {"zero": False, "vrows": vertex_row_table(g, view)}
    got = SP.settle_phase_batch(*args, **kw)
    want = SP.settle_phase_batch(*args, **kw, use_kernels=False)
    assert _fields_that_differ(got, want) == []

    graph = uniform_gnp(3000, 0.003, seed=11, device=cuda)
    state = TS.init_batch_state(graph, [0, 9, 2000, 2999], device=cuda)
    names = ("frontier_crit_lanes_batch", "ell_settle_mark_batch",
             "ell_settle_push_batch", "ell_settle_tail_batch",
             "ell_push_relax_batch")
    counters = launch_counters()
    before = {nm: getattr(*counters[nm]) for nm in names}
    TS.reset_chunk_stats()
    res = TS.step_batch(graph, state, 4 * graph.n)
    torch.cuda.synchronize()
    ran = {nm: getattr(*counters[nm]) - before[nm] for nm in names}
    stats = TS.chunk_stats()
    phases = stats.live_phases + stats.dead_phases
    assert ran == {**dict.fromkeys(names[:4], phases),
                   "ell_push_relax_batch": 0}
    want = TS.step_batch(graph, state, 4 * graph.n, use_kernels=False)
    assert _states_same_bits(res, want) == []


@pytest.mark.parametrize("telemetry", [False, True])
def test_settle_pair_over_more_buckets_than_the_mark_aggregates(cuda,
                                                               telemetry):
    """An out-view with 90 buckets with rows (the mark aggregates the
    appends of at most 64 in shared memory and appends straight to the
    list counts beyond): the pair against its twins on 40 lanes, and a
    captured solve through ``step_batch(..., ell_out=)`` against the plain
    stepper, bit for bit."""
    from repro_torch.core import out_degrees
    from repro_torch.core import static_engine as TS
    from repro_torch.core.graph import vertex_row_table
    from repro_torch.kernels import settle_push as SP

    rng = np.random.default_rng(13)
    n = 400
    src, dst = [], []
    for v in range(n):
        to = rng.choice(n - 1, v % 90 + 1, replace=False)
        src += [v] * len(to)
        dst += list(to + (to >= v))
    w = rng.uniform(0.0, 1.0, len(src)).astype(np.float32)
    g = from_coo(np.array(src, np.int32), np.array(dst, np.int32), w, n,
                 device=cuda)
    view = to_ell_out_sliced(g, pad_multiple=1, boundaries=tuple(range(1, 91)))
    assert sum(1 for s in view.slices if s.rows.shape[0]) == 90
    d = _t(rng.uniform(0, 4, (40, n)).astype(np.float32), cuda)
    st = _t(rng.integers(0, 3, (40, n)).astype(np.int32), cuda)
    mins, n_f = ref.frontier_crit_lanes_batch_ref(d, st,
                                                  g.out_min_static[None])
    args = (d, st, mins, n_f, n_f > 0, view, out_degrees(g), g.in_min_static)
    kw = {"zero": True, "vrows": vertex_row_table(g, view),
          "telemetry": telemetry}
    got = SP.settle_phase_batch(*args, **kw)
    want = SP.settle_phase_batch(*args, **kw, use_kernels=False)
    assert _fields_that_differ(got, want) == []
    extra = {"telemetry": True, "trace_len": 5} if telemetry else {}
    state = TS.init_batch_state(g, [0, 89, 200, 399], device=cuda, **extra)
    res = TS.step_batch(g, state, 4 * n, ell_out=view)
    torch.cuda.synchronize()
    plain = TS.step_batch(g, state, 4 * n, ell_out=view, use_kernels=False)
    assert _states_same_bits(res, plain) == []


def test_settle_dead_chunk_launches_only_the_pair_and_crit(cuda):
    """A finished state's replayed chunk: every phase is dead, the state
    keeps every bit, and the kernels a phase launches are #2 and the
    pair's three, which return early (each J times in a replay's trace);
    anything else in the trace is the chunk's own, fewer than J times
    (the copies in and out of the chunk's buffers apart)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import static_engine as TS

    g = uniform_gnp(3000, 0.003, seed=12, device=cuda)
    st = TS.step_batch(g, TS.init_batch_state(g, [0, 7], device=cuda),
                       4 * g.n)
    assert not TS.lanes_active(st).any()
    j = TS.PHASES_PER_REPLAY
    TS.step_batch(g, st, j)  # the key's capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = TS.step_batch(g, st, j)
        torch.cuda.synchronize()
    assert _states_same_bits(st, again) == []
    per_phase = sorted(e.key for e in prof.key_averages()
                       if e.device_time_total > 0 and e.count >= j
                       and not e.key.startswith(("Memcpy", "Memset")))
    kernels = ("crit_kernel", "settle_mark_kernel", "settle_push_kernel",
               "settle_tail_kernel")
    assert len(per_phase) == 4, per_phase
    assert all(sum(k in key for key in per_phase) == 1 for k in kernels), \
        per_phase


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("i,shape", list(enumerate(SETTLE_SHAPES)))
def test_delta_pair_matches_its_twins(cuda, sliced, i, shape):
    """Delta's threshold, mark, worklist push and tail against the plain
    twins, every field a phase writes bit for bit (``crit_keys`` too):
    light rounds and heavy turns, signed zeros with weights tied to delta,
    a NaN lane, target lanes, stop_on_lane_finish, the telemetry rings, 1
    to 40 lanes (two tiles); a dead phase writes nothing."""
    from repro_torch.analysis.kernel_audit import to_device
    from repro_torch.kernels import frontier_crit as FC
    from repro_torch.kernels import registry as R
    from repro_torch.kernels import settle_push as SP

    b, n = shape
    args, kw = R.fixture_delta(b, n, 500 + i, sliced=sliced,
                               signed=bool(i % 2), target=i % 2 == 0,
                               stop=i == 3, telemetry=i % 3 == 1)
    args, kw = to_device(args, cuda), to_device(kw, cuda)
    wrappers = (FC.delta_thresholds_batch, SP.ell_delta_settle_mark_batch,
                SP.ell_sliced_delta_settle_push_batch if sliced
                else SP.ell_delta_settle_push_batch,
                SP.ell_delta_settle_tail_batch)
    counts = [f.launches for f in wrappers]
    got = SP.delta_phase_batch(*args, **kw)
    torch.cuda.synchronize()
    want = SP.delta_phase_batch(*args, **kw, use_kernels=False)
    assert _fields_that_differ(got, want) == []
    assert [f.launches for f in wrappers] == [c + 1 for c in counts]
    d, status, keys = args[:3]
    thr = FC.delta_thresholds_batch(d, status, keys[0], args[-1])
    assert all(_same_bits(x, y) for x, y in zip(
        thr, ref.delta_thresholds_ref(d, status, keys[0], args[-1])))
    dead = SP.delta_phase_batch(*args, **kw, budget=0)
    assert _same_bits(dead.dist, d) and _same_bits(dead.status, status)
    assert _same_bits(dead.crit_keys, keys)
    assert int(dead.trips) == 0 and int(dead.phases.sum()) == 0


@pytest.mark.parametrize("b,n", [(1, 13), (8, 4096), (13, 1001), (40, 777)])
def test_delta_thresholds_matches_twin_on_edges(cuda, b, n):
    """The threshold on rows off 16-byte boundaries and aligned ones: ids
    that overflow to +inf, a NaN lane, -0 and +0 ids, empty lanes, widths
    whose multiples fall on bucket edges."""
    from repro_torch.kernels import frontier_crit as FC

    rng = np.random.default_rng(b * 7 + n)
    big = np.finfo(np.float32).max
    d = rng.choice(np.array([0.0, -0.0, 0.1, 0.3, 0.7, 1.3, big, np.inf],
                            np.float32), (b, n))
    d = np.where(rng.random((b, n)) < 0.5,
                 rng.integers(0, 40, (b, n)) * np.float32(0.1), d)
    d = d.astype(np.float32)
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    last = np.where(rng.random((b, n)) < 0.5, d, np.inf).astype(np.float32)
    d[b - 1, rng.integers(0, n)] = np.nan
    status[0, : n // 2] = 0
    if b > 2:
        status[1] = 0
    for delta in (0.1, 1e-38, 0.5, 3.0):
        args = (_t(d, cuda), _t(status, cuda), _t(last, cuda), delta)
        got = FC.delta_thresholds_batch(*args)
        want = ref.delta_thresholds_ref(*args)
        assert all(_same_bits(x, y) for x, y in zip(got, want)), delta
    view = _t(np.concatenate([d, d], axis=1), cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        FC.delta_thresholds_batch(view, _t(status, cuda), _t(last, cuda),
                                  0.5)


@pytest.mark.parametrize("telemetry", [False, True])
def test_delta_pair_over_more_buckets_than_the_mark_aggregates(cuda,
                                                              telemetry):
    """Delta's pair on the buckets of an out-view of 90 buckets with rows
    (the mark appends straight to the list counts beyond 64; the push runs
    in six groups): against its twins on 40 lanes, and a captured solve
    through ``step_batch(..., ell_out=)`` against the eager and the plain
    stepper, bit for bit."""
    from repro_torch.core import out_degrees
    from repro_torch.core import static_engine as TS
    from repro_torch.core.graph import vertex_row_table
    from repro_torch.core.policies import delta_degrees
    from repro_torch.kernels import settle_push as SP

    rng = np.random.default_rng(17)
    n = 400
    src, dst = [], []
    for v in range(n):
        to = rng.choice(n - 1, v % 90 + 1, replace=False)
        src += [v] * len(to)
        dst += list(to + (to >= v))
    w = rng.uniform(0.0, 1.0, len(src)).astype(np.float32)
    g = from_coo(np.array(src, np.int32), np.array(dst, np.int32), w, n,
                 device=cuda)
    view = to_ell_out_buckets(g, pad_multiple=1,
                              boundaries=tuple(range(1, 91)))
    assert sum(1 for s in view.slices if s.rows.shape[0]) == 90
    d = rng.uniform(0, 4, (40, n)).astype(np.float32)
    st = rng.integers(0, 3, (40, n)).astype(np.int32)
    delta = 0.25
    x = np.floor(d / np.float32(delta))
    bucket = np.where(st == 1, x, np.inf).min(axis=1, keepdims=True)
    removed = (st == 1) & (x == bucket) & (rng.random((40, n)) < 0.7)
    removed[1::2] = ((st == 1) & (x == bucket))[1::2]  # heavy turns
    keys = np.stack([np.where(removed, d, np.inf), removed]).astype(
        np.float32)
    dl, dh = delta_degrees(g, delta)
    args = (_t(d, cuda), _t(st, cuda), _t(keys, cuda),
            _t((st == 1).any(axis=1), cuda), view, out_degrees(g), dl, dh,
            delta)
    kw = {"vrows": vertex_row_table(g, view), "telemetry": telemetry}
    got = SP.delta_phase_batch(*args, **kw)
    want = SP.delta_phase_batch(*args, **kw, use_kernels=False)
    assert _fields_that_differ(got, want) == []
    extra = {"telemetry": True, "trace_len": 5} if telemetry else {}
    state = TS.init_batch_state(g, [0, 89, 200, 399], criterion="delta",
                                device=cuda, **extra)
    res = TS.step_batch(g, state, 4 * n, ell_out=view)
    eager = TS._step(g, state, 4 * n, None, True, False, view, capture=False)
    torch.cuda.synchronize()
    plain = TS.step_batch(g, state, 4 * n, ell_out=view, use_kernels=False)
    assert _states_same_bits(res, eager) == []
    assert _states_same_bits(res, plain) == []


@pytest.mark.parametrize("layout", ["padded", "sliced"])
def test_delta_dead_chunk_launches_only_its_four_kernels(cuda, layout):
    """A finished delta state's replayed chunk: every phase is dead, the
    state keeps every bit, and the kernels a phase launches are delta's
    four (the threshold, the mark, the push, the tail), each J times in a
    replay's trace; anything else is the chunk's own, fewer than J times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import static_engine as TS

    g = uniform_gnp(3000, 0.003, seed=12, device=cuda)
    kw = {"ell_out": to_ell_out_buckets(g)} if layout == "sliced" else {}
    st = TS.step_batch(g, TS.init_batch_state(g, [0, 7], criterion="delta",
                                              device=cuda), 4 * g.n, **kw)
    assert not TS.lanes_active(st).any()
    j = TS.PHASES_PER_REPLAY
    TS.step_batch(g, st, j, **kw)  # the key's capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = TS.step_batch(g, st, j, **kw)
        torch.cuda.synchronize()
    assert _states_same_bits(st, again) == []
    per_phase = sorted(e.key for e in prof.key_averages()
                       if e.device_time_total > 0 and e.count >= j
                       and not e.key.startswith(("Memcpy", "Memset")))
    kernels = ("delta_crit_kernel", "delta_settle_mark_kernel",
               "delta_settle_push_kernel", "settle_tail_kernel")
    assert len(per_phase) == 4, per_phase
    assert all(sum(k in key for key in per_phase) == 1 for k in kernels), \
        per_phase
