"""The port's kernels against the JAX reference's Pallas kernels, bit for bit.

On the CPU a kernel wrapper runs its plain twin; the reference runs its
Pallas kernel in interpret mode, as its own tests do. Inputs come from the
reference's registry fixtures, ``helpers.mk_ell``, a multi-tile case and a
NaN case, handed over as numpy. The CUDA kernels are held against their
twins on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import registry as R
from repro.kernels.ell_relax import ell_relax as j_ell_relax
from repro.kernels.ell_relax import ell_relax_batch as j_ell_relax_batch
from repro.kernels.frontier_crit import frontier_crit as j_frontier_crit
from repro.kernels.frontier_crit import frontier_crit_batch as j_frontier_crit_batch
from repro.kernels.frontier_crit import (
    frontier_crit_lanes_batch as j_frontier_crit_lanes_batch,
)
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ell_relax import ell_relax, ell_relax_batch
from repro_torch.kernels.frontier_crit import (
    frontier_crit,
    frontier_crit_batch,
    frontier_crit_lanes,
    frontier_crit_lanes_batch,
)

from helpers import mk_ell
from test_torch_push import out_view

torch.set_num_threads(1)

INF = np.inf


def T(x, device="cpu"):
    """numpy / JAX array -> torch tensor (a copy) on ``device``."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def _dmask(rng, shape, nan_at=None):
    dm = rng.uniform(0, 10, shape).astype(np.float32)
    dm[rng.random(shape) < 0.5] = INF
    if nan_at is not None:
        dm[nan_at] = np.nan
    return dm


def _state(rng, shape, nan_at=None):
    d = rng.uniform(0, 5, shape).astype(np.float32)
    d[rng.random(shape) < 0.2] = INF
    status = rng.integers(0, 3, shape).astype(np.int32)
    if nan_at is not None:
        d[nan_at] = np.nan
        status[nan_at] = 1  # on the fringe, so it reaches the minima
    return d, status


# --- ell_relax_batch / ell_relax (kernels #1 and #3) ----------------------


@pytest.mark.parametrize("block_rows", [R.SMALL_BLOCK_ROWS, 256])
def test_ell_relax_registry_fixtures(block_rows):
    cols, ws = R.fixture_ell()
    dm1, dmb = R.fixture_lane_vec(), R.fixture_lane_batch()
    assert_bits(j_ell_relax(dm1, cols, ws, block_rows=block_rows,
                            interpret=True),
                ell_relax(T(dm1), T(cols), T(ws)))
    assert_bits(j_ell_relax_batch(dmb, cols, ws, block_rows=block_rows,
                                  interpret=True),
                ell_relax_batch(T(dmb), T(cols), T(ws)))
    assert_bits(j_ell_relax(dm1, cols, ws, block_rows=block_rows,
                            interpret=True),
                ref.ell_relax_ref(T(dm1), T(cols), T(ws)))


@pytest.mark.parametrize("b,n,d,block", [
    (1, 64, 8, 16), (4, 100, 24, 32), (8, 300, 8, 128), (13, 77, 5, 32),
])
def test_ell_relax_batch_mk_ell_multi_tile(b, n, d, block):
    rng = np.random.default_rng(b * 31 + n * 7 + d)
    n_pad = -(-(n + 1) // 128) * 128
    cols, ws = mk_ell(rng, n, d, n_pad)
    dm = _dmask(rng, (b, n_pad))
    want = j_ell_relax_batch(jnp.asarray(dm), cols, ws, block_rows=block,
                             interpret=True)
    assert_bits(want, ell_relax_batch(T(dm), T(cols), T(ws)))
    row = j_ell_relax(jnp.asarray(dm[0]), cols, ws, block_rows=block,
                      interpret=True)
    assert_bits(row, ell_relax(T(dm[0]), T(cols), T(ws)))


def test_ell_relax_nan_propagates_like_reference():
    rng = np.random.default_rng(5)
    n, d, b = 60, 6, 3
    n_pad = -(-(n + 1) // 128) * 128
    cols, ws = mk_ell(rng, n, d, n_pad)
    dm = _dmask(rng, (b, n_pad), nan_at=(1, int(np.asarray(cols)[7, 0])))
    want = np.asarray(j_ell_relax_batch(jnp.asarray(dm), cols, ws,
                                        block_rows=32, interpret=True))
    got = ell_relax_batch(T(dm), T(cols), T(ws))
    assert np.isnan(want).any()
    assert_bits(want, got)


# --- frontier_crit_lanes_batch and its thin wrappers (kernel #2) ----------


def test_frontier_crit_lanes_registry_fixtures():
    n, b, k = R.FIXTURE_N, R.FIXTURE_B, R.FIXTURE_K
    d = R.fixture_rows((b, n), seed=21)
    status = R.fixture_status((b, n))
    for keys, block in ((None, 4), (R.fixture_rows((k, n), seed=22), 2048),
                        (R.fixture_rows((k, b, n), seed=23), 4)):
        want = j_frontier_crit_lanes_batch(d, status, keys, block=block,
                                           interpret=True)
        got = frontier_crit_lanes_batch(
            T(d), T(status), None if keys is None else T(keys))
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


@pytest.mark.parametrize("block", [4, 2048])
def test_frontier_crit_scalar_and_batch_fixtures(block):
    n, b = R.FIXTURE_N, R.FIXTURE_B
    d1, s1 = R.fixture_rows((n,), seed=24), R.fixture_status((n,))
    om = R.fixture_rows((n,), seed=25)
    for want, got in zip(j_frontier_crit(d1, s1, om, block=block,
                                         interpret=True),
                         frontier_crit(T(d1), T(s1), T(om))):
        assert_bits(want, got)
    db, sb = R.fixture_rows((b, n), seed=26), R.fixture_status((b, n))
    om = R.fixture_rows((n,), seed=27)
    for want, got in zip(j_frontier_crit_batch(db, sb, om, block=block,
                                               interpret=True),
                         frontier_crit_batch(T(db), T(sb), T(om))):
        assert_bits(want, got)
    mins, cnt = frontier_crit_lanes(T(d1), T(s1), T(om)[None])
    assert mins.shape == (2,) and cnt.dtype == torch.int32


@pytest.mark.parametrize("b,n,block,k", [
    (1, 100, 64, 0), (5, 4100, 2048, 1), (3, 77, 32, 2),
])
def test_frontier_crit_lanes_multi_step(b, n, block, k):
    rng = np.random.default_rng(b * 100 + n + k)
    d, status = _state(rng, (b, n))
    for keys in ([None] if k == 0 else
                 [rng.uniform(0, 1, (k, n)).astype(np.float32),
                  rng.uniform(0, 1, (k, b, n)).astype(np.float32)]):
        want = j_frontier_crit_lanes_batch(
            jnp.asarray(d), jnp.asarray(status),
            None if keys is None else jnp.asarray(keys), block=block,
            interpret=True)
        got = frontier_crit_lanes_batch(T(d), T(status),
                                        None if keys is None else T(keys))
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


def test_frontier_crit_nan_propagates_like_reference():
    rng = np.random.default_rng(9)
    d, status = _state(rng, (3, 50), nan_at=(1, 17))
    om = rng.uniform(0, 1, 50).astype(np.float32)
    want = j_frontier_crit_lanes_batch(jnp.asarray(d), jnp.asarray(status),
                                       jnp.asarray(om)[None], block=16,
                                       interpret=True)
    got = frontier_crit_lanes_batch(T(d), T(status), T(om)[None])
    assert np.isnan(np.asarray(want[0])).any()
    assert_bits(want[0], got[0])
    assert_bits(want[1], got[1])


# --- the ops layer: padding, masking, use_kernels parity ------------------


@pytest.mark.parametrize("use_kernels", [True, False])
def test_ops_wrappers_match_reference(use_kernels):
    rng = np.random.default_rng(11)
    b, n, dd = 4, 90, 7
    cols, ws = mk_ell(rng, n, dd, n + 1)  # ids up to the sentinel n
    d, status = _state(rng, (b, n))
    settle = rng.random((b, n)) < 0.4
    om = rng.uniform(0, 1, n).astype(np.float32)
    jd, js, jset = jnp.asarray(d), jnp.asarray(status), jnp.asarray(settle)
    # the port's relax_settled_batch is the reference's pull over the same
    # incoming view; the push the engines run takes the outgoing view of
    # the same edges
    out_c, out_w = out_view(cols, ws, n)
    for use_pallas in (True, False):
        want = jops.relax_settled_batch(jd, jset, cols, ws, block_rows=32,
                                        use_pallas=use_pallas)
        assert_bits(want, tops.relax_settled_batch(
            T(d), T(settle), T(cols), T(ws), use_kernels=use_kernels))
        assert_bits(want, tops.push_settled_batch(
            T(d), T(settle), T(out_c), T(out_w), use_kernels=use_kernels))
        for keys in (None, om[None], rng.uniform(0, 1, (2, b, n)).astype(np.float32)):
            want = jops.crit_thresholds_batch(
                jd, js, None if keys is None else jnp.asarray(keys), block=32,
                use_pallas=use_pallas)
            got = tops.crit_thresholds_batch(
                T(d), T(status), None if keys is None else T(keys),
                use_kernels=use_kernels)
            assert_bits(want[0], got[0])
            assert_bits(want[1], got[1])
    assert_bits(jops.relax_settled(jd[0], jset[0], cols, ws, block_rows=32),
                tops.relax_settled(T(d[0]), T(settle[0]), T(cols), T(ws),
                                   use_kernels=use_kernels))
    for want, got in zip(
            jops.static_thresholds(jd[0], js[0], jnp.asarray(om), block=32),
            tops.static_thresholds(T(d[0]), T(status[0]), T(om),
                                   use_kernels=use_kernels)):
        assert_bits(want, got)
    for want, got in zip(
            jops.static_thresholds_batch(jd, js, jnp.asarray(om), block=32),
            tops.static_thresholds_batch(T(d), T(status), T(om),
                                         use_kernels=use_kernels)):
        assert_bits(want, got)


def test_pad_lane_batch_sentinel_slot():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = tops.pad_lane_batch(x)
    assert out.shape == (2, 4) and out.dtype == torch.float32
    assert torch.equal(out[:, :3], x) and torch.isinf(out[:, 3]).all()
    assert (tops.pad_lane_batch(x, fill=0.0)[:, 3] == 0).all()


# --- wrapper contracts ----------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    ws = torch.zeros((4, 2), dtype=torch.float32)
    dm = torch.zeros((2, 5), dtype=torch.float32)
    with pytest.raises(TypeError):
        ell_relax_batch(dm.double(), cols, ws)
    with pytest.raises(TypeError):
        ell_relax_batch(dm, cols.long(), ws)
    with pytest.raises(ValueError, match="want dmask"):
        ell_relax_batch(dm, cols, ws[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ell_relax_batch(torch.zeros((5, 2)).t(), cols, ws)
    with pytest.raises(ValueError, match="at least one slot"):
        ell_relax_batch(dm, cols[:, :0], ws[:, :0])
    d = torch.zeros((2, 5), dtype=torch.float32)
    st = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(TypeError):
        frontier_crit_lanes_batch(d, st.long(), None)
    with pytest.raises(ValueError, match="keys must be"):
        frontier_crit_lanes_batch(d, st, torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="too many OUT lanes"):
        frontier_crit_lanes_batch(d, st, torch.zeros((9, 5)))
    with pytest.raises(ValueError, match="contiguous"):
        frontier_crit_lanes_batch(torch.zeros((5, 2)).t(), st, None)


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    before = (ell_relax_batch.launches, frontier_crit_lanes_batch.launches)
    rng = np.random.default_rng(2)
    cols, ws = mk_ell(rng, 20, 4, 21)
    ell_relax_batch(T(_dmask(rng, (2, 21))), T(cols), T(ws))
    d, st = _state(rng, (2, 20))
    frontier_crit_lanes_batch(T(d), T(st), None)
    assert (ell_relax_batch.launches,
            frontier_crit_lanes_batch.launches) == before


def test_library_names_follow_the_source():
    paths = {nm: _build.library_path(nm) for nm in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for nm, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(nm + "-")
        assert (_build.CSRC / _build.SOURCES[nm]).exists()
