"""The port's dynamic-key kernels, ops wrappers and gate helpers against the
JAX reference, bit for bit.

On the CPU each kernel wrapper runs its plain twin; the reference runs its
Pallas kernel in interpret mode (at its default ``block_rows`` and at
``SMALL_BLOCK_ROWS``, which makes the two-sweep kernels multi-tile) and its
``ref.py`` oracles. Inputs are the reference's registry fixtures, seeded
``helpers.mk_ell`` blocks and NaN cases, handed over as numpy. The CUDA
kernels are held against their twins on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import criteria as JC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import registry as R
from repro.kernels.ell_key_min import ell_key_min as j_ell_key_min
from repro.kernels.ell_key_min import ell_key_min_batch as j_ell_key_min_batch
from repro.kernels.ell_relax_keys import (
    ell_gather_min_batch as j_ell_gather_min_batch,
)
from repro.kernels.ell_relax_keys import ell_keys_dep_batch as j_ell_keys_dep_batch
from repro.kernels.ell_relax_keys import ell_relax_keys as j_ell_relax_keys
from repro.kernels.ell_relax_keys import (
    ell_relax_keys_batch as j_ell_relax_keys_batch,
)
from repro_torch import interop
from repro_torch.core import criteria as TC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.ell_key_min import ell_key_min, ell_key_min_batch
from repro_torch.kernels.ell_relax_keys import (
    ell_gather_min_batch,
    ell_keys_dep_batch,
    ell_relax_keys,
    ell_relax_keys_batch,
)

from helpers import mk_ell

torch.set_num_threads(1)

INF = np.inf
N, B = R.FIXTURE_N, R.FIXTURE_B
BLOCKS = [R.SMALL_BLOCK_ROWS, 256]


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


# --- ell_key_min_batch / ell_key_min (kernels #5 and #4) ------------------


@pytest.mark.parametrize("block_rows", BLOCKS)
def test_ell_key_min_registry_fixtures(block_rows):
    cols, ws = R.fixture_ell()
    g1, gb = R.fixture_lane_vec(), R.fixture_lane_batch()
    want1 = j_ell_key_min(g1, cols, ws, block_rows=block_rows, interpret=True)
    assert_bits(want1, ell_key_min(T(g1), T(cols), T(ws)))
    assert_bits(want1, ref.ell_key_min_ref(T(g1), T(cols), T(ws)))
    want = j_ell_key_min_batch(gb, cols, ws, block_rows=block_rows,
                               interpret=True)
    assert_bits(want, ell_key_min_batch(T(gb), T(cols), T(ws)))
    assert_bits(jref.ell_key_min_batch_ref(gb, cols, ws),
                ref.ell_key_min_batch_ref(T(gb), T(cols), T(ws)))


# --- ell_gather_min_batch (kernel #6) --------------------------------------


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("v", [1, 2])
def test_ell_gather_min_registry_fixtures(block_rows, v):
    cols, ws = R.fixture_ell()
    vecs = R.fixture_rows((v, B, N), seed=30 + v)
    want = j_ell_gather_min_batch(vecs, cols, ws, block_rows=block_rows,
                                  interpret=True)
    assert_bits(want, ell_gather_min_batch(T(vecs), T(cols), T(ws)))
    assert_bits(jref.ell_gather_min_batch_ref(vecs, cols, ws),
                ref.ell_gather_min_batch_ref(T(vecs), T(cols), T(ws)))


def test_ell_gather_min_rows_differ_from_vertices():
    """The gather alone takes any row count (a degree bucket's rows)."""
    rng = np.random.default_rng(3)
    n = 50
    cols, ws = mk_ell(rng, 17, 6, n + 1)
    vecs = rng.uniform(0, 1, (2, 3, n)).astype(np.float32)
    want = j_ell_gather_min_batch(jnp.asarray(vecs), cols, ws, block_rows=8,
                                  interpret=True)
    assert_bits(want, ell_gather_min_batch(T(vecs), T(cols), T(ws)))


# --- ell_relax_keys_batch / ell_relax_keys (kernel #7) ---------------------


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("k", [1, 2])
def test_ell_relax_keys_registry_fixtures(block_rows, k):
    cols, ws = R.fixture_ell()
    dmask = R.fixture_rows((B, N), seed=6)
    ga, gb, gc = (R.fixture_rows((k, B, N), seed=s) for s in (7, 8, 9))
    want = j_ell_relax_keys_batch(dmask, ga, gb, gc, cols, ws,
                                  block_rows=block_rows, interpret=True)
    args = [T(x) for x in (dmask, ga, gb, gc, cols, ws)]
    got = ell_relax_keys_batch(*args)
    assert_bits(want[0], got[0])
    assert_bits(want[1], got[1])
    for w, g in zip(jref.ell_relax_keys_batch_ref(dmask, ga, gb, gc, cols, ws),
                    ref.ell_relax_keys_batch_ref(*args)):
        assert_bits(w, g)
    # the 1-D view
    want1 = j_ell_relax_keys(dmask[1], ga[:, 1], gb[:, 1], gc[:, 1], cols, ws,
                             block_rows=block_rows, interpret=True)
    got1 = ell_relax_keys(args[0][1], args[1][:, 1], args[2][:, 1],
                          args[3][:, 1], args[4], args[5])
    assert_bits(want1[0], got1[0])
    assert_bits(want1[1], got1[1])


# --- ell_keys_dep_batch (kernel #8) ----------------------------------------


@pytest.mark.parametrize("block_rows", BLOCKS)
@pytest.mark.parametrize("k0,dep_idx", [(1, 0), (2, 0), (2, 1)])
def test_ell_keys_dep_registry_fixtures(block_rows, k0, dep_idx):
    cols, ws = R.fixture_ell()
    gates = R.fixture_rows((k0, B, N), seed=10)
    dga, dgb = R.fixture_rows((B, N), seed=11), R.fixture_rows((B, N), seed=12)
    want = j_ell_keys_dep_batch(gates, dga, dgb, cols, ws, dep_idx=dep_idx,
                                block_rows=block_rows, interpret=True)
    args = [T(x) for x in (gates, dga, dgb)]
    assert_bits(want, ell_keys_dep_batch(*args, T(cols), T(ws),
                                         dep_idx=dep_idx))
    assert_bits(jref.ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws),
                ref.ell_keys_dep_batch_ref(*args, dep_idx, T(cols), T(ws)))


# --- larger multi-tile blocks and NaN ---------------------------------------


@pytest.mark.parametrize("b,n,d,block", [(1, 64, 8, 16), (4, 100, 24, 32),
                                         (8, 300, 8, 128), (13, 77, 5, 32)])
def test_fused_scans_mk_ell_multi_tile(b, n, d, block):
    rng = np.random.default_rng(b * 31 + n * 7 + d)
    cols, ws = mk_ell(rng, n, d, n + 1)  # ids up to the sentinel n

    def rows(*shape):
        x = rng.uniform(0, 3, shape).astype(np.float32)
        x[rng.random(shape) < 0.4] = INF
        return x

    dmask, ga, gb, gc = rows(b, n), rows(2, b, n), rows(2, b, n), rows(2, b, n)
    want = j_ell_relax_keys_batch(jnp.asarray(dmask), jnp.asarray(ga),
                                  jnp.asarray(gb), jnp.asarray(gc), cols, ws,
                                  block_rows=block, interpret=True)
    got = ell_relax_keys_batch(T(dmask), T(ga), T(gb), T(gc), T(cols), T(ws))
    assert_bits(want[0], got[0])
    assert_bits(want[1], got[1])
    dga, dgb = rows(b, n), rows(b, n)
    want = j_ell_keys_dep_batch(jnp.asarray(ga), jnp.asarray(dga),
                                jnp.asarray(dgb), cols, ws, dep_idx=1,
                                block_rows=block, interpret=True)
    assert_bits(want, ell_keys_dep_batch(T(ga), T(dga), T(dgb), T(cols),
                                         T(ws), dep_idx=1))
    gate = tops.pad_lane_batch(T(rows(b, n)))
    want = j_ell_key_min_batch(jnp.asarray(gate.numpy()), cols, ws,
                               block_rows=block, interpret=True)
    assert_bits(want, ell_key_min_batch(gate, T(cols), T(ws)))


def test_nan_in_gate_parts_propagates_like_reference():
    rng = np.random.default_rng(5)
    n, d, b = 60, 6, 3
    cols, ws = mk_ell(rng, n, d, n + 1)
    c = np.asarray(cols)
    dmask = rng.uniform(0, 3, (b, n)).astype(np.float32)
    ga, gb, gc = (rng.uniform(0, 3, (2, b, n)).astype(np.float32)
                  for _ in range(3))
    ga[1, 2, c[7, 0] % n] = np.nan  # a NaN gate part
    dmask[0, c[9, 1] % n] = np.nan  # a NaN distance: upd NaN, fin +inf
    want = j_ell_relax_keys_batch(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                                  cols, ws, block_rows=16, interpret=True)
    got = ell_relax_keys_batch(T(dmask), T(ga), T(gb), T(gc), T(cols), T(ws))
    assert np.isnan(np.asarray(want[1])).any()
    assert_bits(want[0], got[0])
    assert_bits(want[1], got[1])
    dga = rng.uniform(0, 3, (b, n)).astype(np.float32)
    dga[1, c[3, 0] % n] = np.nan
    want = j_ell_keys_dep_batch(jnp.asarray(gb), jnp.asarray(dga),
                                jnp.asarray(gc[0]), cols, ws, dep_idx=0,
                                block_rows=16, interpret=True)
    got = ell_keys_dep_batch(T(gb), T(dga), T(gc[0]), T(cols), T(ws))
    assert np.isnan(np.asarray(want)).any()
    assert_bits(want, got)


# --- the ops layer -----------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
def test_key_ops_match_reference(use_kernels):
    rng = np.random.default_rng(11)
    b, n, dd = 4, 90, 7
    cols, ws = mk_ell(rng, n, dd, n + 1)
    tcols, tws = T(cols), T(ws)

    def rows(*shape):
        x = rng.uniform(0, 3, shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = INF
        return x

    d, settle = rows(b, n), rng.random((b, n)) < 0.4
    gate = rows(b, n)
    parts = [tuple(rows(b, n) for _ in range(3)) for _ in range(2)]
    gates = rows(2, b, n)
    dga, dgb = rows(b, n), rows(b, n)
    for use_pallas in (True, False):
        kw = dict(block_rows=32, use_pallas=use_pallas)
        assert_bits(
            jops.key_min_batch(jnp.asarray(gate), cols, ws, **kw),
            tops.key_min_batch(T(gate), tcols, tws, use_kernels=use_kernels))
        assert_bits(
            jops.key_min_batch_any(jnp.asarray(gate), (cols, ws), **kw),
            tops.key_min_batch_any(T(gate), (tcols, tws),
                                   use_kernels=use_kernels))
        for k in (1, 2):
            jp = tuple(tuple(jnp.asarray(x) for x in p) for p in parts[:k])
            tp = tuple(tuple(T(x) for x in p) for p in parts[:k])
            want = jops.in_scan_relax_keys_batch(
                jnp.asarray(d), jnp.asarray(settle), jp, (cols, ws), **kw)
            got = tops.in_scan_relax_keys_batch(
                T(d), T(settle), tp, (tcols, tws), use_kernels=use_kernels)
            assert_bits(want[0], got[0])
            assert_bits(want[1], got[1])
        assert_bits(
            jops.out_scan_keys_batch(jnp.asarray(gates), None, (cols, ws),
                                     **kw),
            tops.out_scan_keys_batch(T(gates), None, (tcols, tws),
                                     use_kernels=use_kernels))
        for dep_idx in (0, 1):
            assert_bits(
                jops.out_scan_keys_batch(
                    jnp.asarray(gates),
                    (jnp.asarray(dga), jnp.asarray(dgb), dep_idx),
                    (cols, ws), **kw),
                tops.out_scan_keys_batch(T(gates), (T(dga), T(dgb), dep_idx),
                                         (tcols, tws),
                                         use_kernels=use_kernels))


# --- gate helpers --------------------------------------------------------------


@pytest.mark.parametrize("name", ["in_dyn", "in_full", "out_dyn", "out_weak",
                                  "out_full"])
def test_gate_helpers_match_reference(name):
    rng = np.random.default_rng(len(name))
    b, n = 3, 40
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    settle = (status == 1) & (rng.random((b, n)) < 0.5)
    in_min = rng.uniform(0, 1, n).astype(np.float32)
    in_min[3] = INF
    out_min = rng.uniform(0, 1, n).astype(np.float32)
    out_dyn = rng.uniform(0, 2, (b, n)).astype(np.float32)
    jspec, tspec = JC._KEY_SPECS[name], TC._KEY_SPECS[name]
    assert tuple(jspec) == tuple(tspec)
    jst, tst = jnp.asarray(status), T(status)
    assert_bits(
        JC.key_gate(jspec, jst, jnp.asarray(in_min), jnp.asarray(out_min),
                    {"out_dyn": jnp.asarray(out_dyn)}),
        TC.key_gate(tspec, tst, T(in_min), T(out_min), {"out_dyn": T(out_dyn)}))
    if tspec.side == "in":
        want = JC.in_scan_gate_parts(jspec, jst, jnp.asarray(settle),
                                     jnp.asarray(in_min)[None])
        got = TC.in_scan_gate_parts(tspec, tst, T(settle), T(in_min)[None])
        for w, g in zip(want, got):
            assert_bits(w, g)
    if tspec.aux == "out_dyn":
        for w, g in zip(JC.dep_gate_parts(jspec, jst),
                        TC.dep_gate_parts(tspec, tst)):
            assert_bits(w, g)


# --- wrapper contracts -----------------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    ws = torch.zeros((4, 2), dtype=torch.float32)
    v = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match=r"need a \(K>=1, B, n\) gate stack"):
        ell_relax_keys_batch(v[0], v[:0], v[:0], v[:0], cols, ws)
    with pytest.raises(ValueError, match="dep_idx 2 out of range for K0=2"):
        ell_keys_dep_batch(v, v[0], v[0], cols, ws, dep_idx=2)
    with pytest.raises(ValueError, match="dep_idx -1 out of range"):
        ell_keys_dep_batch(v, v[0], v[0], cols, ws, dep_idx=-1)
    with pytest.raises(ValueError, match="one ELL row per vertex"):
        ell_relax_keys_batch(v[0], v, v, v, cols[:3], ws[:3])
    with pytest.raises(ValueError, match="want gate"):
        ell_key_min_batch(v, cols, ws)
    with pytest.raises(TypeError):
        ell_gather_min_batch(v.double(), cols, ws)
    with pytest.raises(TypeError):
        ell_key_min_batch(v[0], cols.long(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather_min_batch(torch.zeros((4, 3, 2)).transpose(0, 2), cols, ws)
    with pytest.raises(ValueError, match="at least one slot"):
        ell_gather_min_batch(v, cols[:, :0], ws[:, :0])
    # a sliced view routes to the sliced twins on the CPU
    sl = interop.sliced_from_numpy(
        {"slices": [{"rows": np.asarray(s.rows), "cols": np.asarray(s.cols),
                     "ws": np.asarray(s.ws)}
                    for s in R.fixture_sliced().slices],
         "merge_idx": np.asarray(R.fixture_sliced().merge_idx)},
        device="cpu")
    g = T(R.fixture_rows((2, B, N)))
    assert_bits(ref.ell_sliced_gather_min_batch_ref(g[:1], sl)[0],
                tops.key_min_batch_any(g[0], sl))
    assert_bits(ref.ell_sliced_gather_min_batch_ref(g, sl),
                tops.out_scan_keys_batch(g, None, sl))
    assert_bits(ref.ell_sliced_keys_dep_batch_ref(g, g[0], g[1], 1, sl),
                tops.out_scan_keys_batch(g, (g[0], g[1], 1), sl))


def test_cpu_tensors_run_the_twins_and_count_no_launch():
    fns = (ell_key_min_batch, ell_gather_min_batch, ell_relax_keys_batch,
           ell_keys_dep_batch)
    before = [f.launches for f in fns]
    cols, ws = (T(x) for x in R.fixture_ell())
    v = T(R.fixture_rows((2, B, N)))
    ell_key_min_batch(tops.pad_lane_batch(v[0]), cols, ws)
    ell_gather_min_batch(v, cols, ws)
    ell_relax_keys_batch(v[0], v, v, v, cols, ws)
    ell_keys_dep_batch(v, v[0], v[1], cols, ws, dep_idx=1)
    assert [f.launches for f in fns] == before
