"""numpy inputs of every layout numpy reads, against the reference.

``torch.from_numpy`` refuses a negative stride and a foreign byte order, so
the port's entry points pass numpy inputs through ``np.ascontiguousarray``
first (``from_coo``, ``f32_rows``, ``verify_row``, which keeps the row's
own dtype). Each form here goes through the reference and the port: a
reversed view, a big-endian array and, for the oracle plans' ``dist_true``,
a Fortran-ordered one. The results are held bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.serving import resilience as JR
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.serving import resilience as TR

torch.set_num_threads(1)

N, M = 50, 400


def _coo(seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    w = rng.random(M).astype(np.float32)
    return src, dst, w


def _bits(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _forms(a: np.ndarray) -> dict:
    """The layouts one array can come in: a reversed view (a negative
    stride), big-endian, and both at once."""
    be = a.astype(a.dtype.newbyteorder(">"))
    return {"reversed": a[::-1], "big_endian": be,
            "big_endian_reversed": be[::-1]}


@pytest.mark.parametrize("form", ["reversed", "big_endian",
                                  "big_endian_reversed"])
def test_from_coo_takes_every_layout(form):
    src, dst, w = _coo()
    arrays = [_forms(x)[form] for x in (src, dst, w)]
    assert arrays[0].strides[0] < 0 or not arrays[0].dtype.isnative
    gj = JG.from_coo(*arrays, N)
    gt = TG.from_coo(*arrays, N, device="cpu")
    for field in ("src", "dst", "w", "in_min_static", "out_min_static"):
        np.testing.assert_array_equal(_bits(getattr(gj, field)),
                                      _bits(getattr(gt, field)))
    want = JS.run_phased_static_batch(gj, [0, 7], use_pallas=False)
    got = TS.run_phased_static_batch(gt, [0, 7], device="cpu")
    np.testing.assert_array_equal(_bits(want.dist), _bits(got.dist))
    np.testing.assert_array_equal(np.asarray(want.phases),
                                  _bits(got.phases))


@pytest.mark.parametrize("form", ["reversed", "big_endian", "fortran"])
def test_oracle_dist_true_takes_every_layout(form):
    src, dst, w = _coo()
    gj, gt = JG.from_coo(src, dst, w, N), TG.from_coo(src, dst, w, N,
                                                      device="cpu")
    srcs = [1, 9]
    rows = np.asarray(JS.run_phased_static_batch(
        gj, srcs, use_pallas=False).dist)
    given = {"reversed": np.ascontiguousarray(rows[::-1])[::-1],
             "big_endian": rows.astype(">f4"),
             "fortran": np.asfortranarray(rows)}[form]
    assert given.strides[0] < 0 or not given.dtype.isnative \
        or not given.flags.c_contiguous
    want = JS.run_phased_static_batch(gj, srcs, criterion="oracle",
                                      dist_true=given, use_pallas=False)
    got = TS.run_phased_static_batch(gt, srcs, criterion="oracle",
                                     dist_true=given, device="cpu")
    for field in ("dist", "status", "phases"):
        np.testing.assert_array_equal(_bits(getattr(want, field)),
                                      _bits(getattr(got, field)))
    np.testing.assert_array_equal(want.sum_fringe, got.sum_fringe)


@pytest.mark.parametrize("form", ["reversed", "big_endian",
                                  "big_endian_reversed"])
@pytest.mark.parametrize("corrupt", [None, "raised", "nan"])
def test_verify_row_takes_every_layout(form, corrupt):
    src, dst, w = _coo()
    gj, gt = JG.from_coo(src, dst, w, N), TG.from_coo(src, dst, w, N,
                                                      device="cpu")
    row = np.asarray(JS.run_phased_static_batch(
        gj, [4], use_pallas=False).dist)[0].copy()
    v = int(np.flatnonzero(np.isfinite(row) & (np.arange(N) != 4))[3])
    if corrupt == "raised":
        row[v] += np.float32(0.5)
    elif corrupt == "nan":
        row[v] = np.nan
    # every form holds the row's values, in order
    given = {"reversed": row[::-1].copy()[::-1],
             "big_endian": row.astype(">f4"),
             "big_endian_reversed": row[::-1].astype(">f4")[::-1]}[form]
    assert given.strides[0] < 0 or not given.dtype.isnative
    np.testing.assert_array_equal(np.asarray(given, np.float32), row)
    want = JR.verify_row(gj, given, 4)
    got = TR.verify_row(gt, given, 4)
    assert got == want
    assert (got is None) == (corrupt is None)
