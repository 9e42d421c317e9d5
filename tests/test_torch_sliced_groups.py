"""Sliced views with more buckets than one launch takes, against the JAX
reference, bit for bit.

A launch of a sliced pass takes a group of ``SLICED_GROUP_BUCKETS``
buckets with rows (the bucket table lives in the kernel's parameter space);
a view with more runs each pass once a group, in order. Here: the groups
themselves (every row in exactly one group, in order, each group's units
counted from 0), and the twins of the sliced kernels and the sliced solves
on views of ``kronecker(8)`` built with 24 boundaries (19 and 22 buckets
with rows) against the reference's sliced Pallas kernels in interpret mode
and its ``run_phased_static_batch``. The CUDA kernels on such views are
held against these twins on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import ref as jref
from repro.kernels.ell_relax_keys import (
    ell_sliced_gather_min_batch as j_sliced_gather,
)
from repro.kernels.ell_relax_keys import ell_sliced_keys_dep_batch as j_sliced_dep
from repro.kernels.ell_relax_keys import (
    ell_sliced_relax_keys_batch as j_sliced_relax_keys,
)
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ref
from repro_torch.kernels.config import SLICED_GROUP_BUCKETS
from repro_torch.kernels.ell_sliced import (
    bucket_groups,
    ell_sliced_gather_min_batch,
    ell_sliced_keys_dep_batch,
    ell_sliced_push_relax_batch,
    ell_sliced_relax_keys_batch,
    scan_units,
)

torch.set_num_threads(1)

# 24 boundaries at a pad multiple of 1: kronecker(8)'s in-view has 19
# buckets with rows, its out-view 22 (two groups each)
PAD, BOUNDARIES = 1, tuple(range(1, 25))
RESULT_FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges",
                 "total_phases", "settled_per_phase")


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def _graphs():
    return (JGen.kronecker(8, seed=21),
            TGen.kronecker(8, seed=21, device="cpu"))


def _views(side):
    gj, gt = _graphs()
    return (getattr(JG, f"to_ell_{side}_sliced")(gj, pad_multiple=PAD,
                                                 boundaries=BOUNDARIES),
            getattr(TG, f"to_ell_{side}_sliced")(gt, pad_multiple=PAD,
                                                 boundaries=BOUNDARIES))


def _rows(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


# --- the groups -------------------------------------------------------------


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("lanes", [1, 8, 16])
@pytest.mark.parametrize("side", ["in", "out"])
def test_groups_hold_every_row_once_in_order(side, lanes, skip):
    _, view = _views(side)
    live = [s for s in view.slices if s.rows.shape[0]]
    groups = bucket_groups(view)
    assert len(live) > SLICED_GROUP_BUCKETS  # more than one launch takes
    assert all(1 <= len(g) <= SLICED_GROUP_BUCKETS for g in groups)
    assert [s for g in groups for s in g] == live  # every bucket, in order
    assert all(len(g) == SLICED_GROUP_BUCKETS for g in groups[:-1])
    table = scan_units(view, lanes, skip)
    assert len(table) == len(live)
    covered = np.zeros(view.total_rows, np.int64)
    i, row = 0, 0
    for group in groups:
        unit = 0  # one launch a group: its units count from 0
        for s in group:
            entry = table[i]
            n_rows, rows, first, offset = (entry[2], entry[5], entry[8],
                                           entry[9])
            assert entry[:2] == (s.cols.data_ptr(), s.ws.data_ptr())
            assert (first, offset) == (unit, row)
            covered[offset:offset + n_rows] += 1
            unit += -(-n_rows // rows)
            row += n_rows
            i += 1
    assert row == view.total_rows
    assert (covered == 1).all()  # every row lies in exactly one group


# --- the twins on a many-bucket view ---------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("side", ["in", "out"])
def test_sliced_gather_min_on_many_buckets(side, sparse):
    jv, tv = _views(side)
    n = jv.merge_idx.shape[0]
    vecs = _rows(np.random.default_rng(3), (2, 3, n), 0.9 if sparse else 0.3)
    vecs[1, 2, 7] = np.nan
    want = j_sliced_gather(jnp.asarray(vecs), jv, interpret=True)
    assert_bits(jref.ell_sliced_gather_min_batch_ref(jnp.asarray(vecs), jv),
                want)
    assert_bits(want, ell_sliced_gather_min_batch(T(vecs), tv, sparse=sparse))


@pytest.mark.parametrize("k", [1, 2])
def test_sliced_relax_keys_on_many_buckets(k):
    (jv, tv), (_, tv_out) = _views("in"), _views("out")
    n = jv.merge_idx.shape[0]
    rng = np.random.default_rng(4 + k)
    dmask = _rows(rng, (3, n), 0.8)
    ga, gb, gc = (_rows(rng, (k, 3, n)) for _ in range(3))
    ga[0, 1, 2] = np.nan
    want = j_sliced_relax_keys(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                               jv, interpret=True)
    args = [T(x) for x in (dmask, ga, gb, gc)]
    for out_view in (None, tv_out):
        got = ell_sliced_relax_keys_batch(*args, tv, out_view=out_view)
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


@pytest.mark.parametrize("k0,dep_idx", [(1, 0), (2, 1)])
def test_sliced_keys_dep_on_many_buckets(k0, dep_idx):
    jv, tv = _views("out")
    n = jv.merge_idx.shape[0]
    rng = np.random.default_rng(9)
    gates = _rows(rng, (k0, 3, n))
    dga, dgb = _rows(rng, (3, n)), _rows(rng, (3, n))
    dga[1, 4] = np.nan
    want = j_sliced_dep(*(jnp.asarray(x) for x in (gates, dga, dgb)), jv,
                        dep_idx=dep_idx, interpret=True)
    got = ell_sliced_keys_dep_batch(*(T(x) for x in (gates, dga, dgb)), tv,
                                    dep_idx=dep_idx)
    assert_bits(want, got)


def test_sliced_push_on_many_buckets():
    """The push along the 22-bucket out-view against the reference's pull
    over the 19-bucket in-view: the same relax."""
    (jv_in, _), (_, tv_out) = _views("in"), _views("out")
    n = jv_in.merge_idx.shape[0]
    dmask = _rows(np.random.default_rng(12), (4, n), 0.85)
    want = j_sliced_gather(jnp.asarray(dmask)[None], jv_in, interpret=True)[0]
    assert_bits(want, ell_sliced_push_relax_batch(T(dmask), tv_out))
    assert_bits(want, ref.ell_push_relax_batch_ref(T(dmask), tv_out))


# --- solves on a many-bucket view ------------------------------------------


@pytest.mark.parametrize("crit", ["instatic|outstatic", "in|out"])
def test_sliced_solves_on_many_buckets_match_reference(crit):
    gj, gt = _graphs()
    (jv_in, tv_in), (jv_out, tv_out) = _views("in"), _views("out")
    srcs = np.asarray([0, 5, gt.n - 1], np.int32)
    want = JS.run_phased_static_batch(gj, srcs, criterion=crit, trace_len=8,
                                      ell=jv_in, ell_out=jv_out)
    got = TS.run_phased_static_batch(gt, srcs, criterion=crit, trace_len=8,
                                     ell=tv_in, ell_out=tv_out, device="cpu")
    for f in RESULT_FIELDS:
        assert_bits(getattr(want, f), getattr(got, f))
    padded = TS.run_phased_static_batch(gt, srcs, criterion=crit, trace_len=8,
                                        device="cpu")
    for f in RESULT_FIELDS:
        assert_bits(getattr(padded, f), getattr(got, f))
