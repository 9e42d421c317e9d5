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

from repro_torch.core import run_phased_static_batch, to_ell_in
from repro_torch.graphs import uniform_gnp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ell_relax import ell_relax, ell_relax_batch
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


def test_cuda_tensors_never_fall_back(cuda):
    dm = ops.pad_lane_batch(torch.zeros((2, 4), device=cuda))
    cols = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    ws = torch.zeros((4, 2), dtype=torch.float32)  # on the host: refused
    with pytest.raises(ValueError, match="different devices"):
        ell_relax_batch(dm, cols, ws)
