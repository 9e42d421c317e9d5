"""The status-gate table path of the dense key gathers against the JAX
reference, bit for bit.

A key whose ``KeySpec`` gate is ``"unsettled"`` (+0 where status < 2,
+inf elsewhere) is gathered on the card from a table of one byte of lane
bits a column, built from the lanes' status, in place of the packed f32
gate (``ell_key_min_status_batch``). Here, on the CPU: the table itself
(lane bits, the sentinel column clear), the twin that reads through it
against the reference's ``ell_key_min_batch`` / ``ell_gather_min_batch``
Pallas kernels in interpret mode on the reference's gate (-0 weights
included), the ops layer choosing the table by the gate's kind only, and
``insimple|outsimple`` solves (whose out-scan and priming take it) against
the reference. The kernel is held against the twin and the f32 path on the
card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import criteria as JC
from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels.ell_key_min import ell_key_min_batch as j_ell_key_min_batch
from repro.kernels.ell_relax_keys import (
    ell_gather_min_batch as j_ell_gather_min_batch,
)
from repro_torch.core import criteria as TC
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.config import lane_tile
from repro_torch.kernels.ell_key_min import ell_key_min_status_batch

torch.set_num_threads(1)

INF = np.inf
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


def _signed_ell(rng, rows, d, n):
    """ids in [0, n] (n the sentinel), weights from {+0, -0, 0.5, 1, +inf}."""
    cols = rng.integers(0, n + 1, (rows, d)).astype(np.int32)
    ws = np.array([0.0, -0.0, 0.5, 1.0, INF], np.float32)[
        rng.integers(0, 5, (rows, d))]
    return cols, ws


@pytest.mark.parametrize("lanes", [1, 3, 8, 13])
def test_status_gate_table_holds_lane_bits(lanes):
    rng = np.random.default_rng(lanes)
    n = 50
    status = rng.integers(0, 3, (lanes, n)).astype(np.int32)
    status[0, :3] = (-1, 7, 2)  # below 2 gates, 2 and above do not
    table = ref.status_gate_table(T(status), n + 1).numpy()
    w = lane_tile(lanes)
    tiles = -(-lanes // w)
    assert table.shape == (tiles, n + 1) and table.dtype == np.uint8
    assert (table[:, n] == 0).all()  # the sentinel column is clear
    for lane in range(tiles * w):
        t, k = divmod(lane, w)
        bit = (table[t, :n] >> k) & 1
        want = (status[lane] < 2) if lane < lanes else np.zeros(n, bool)
        np.testing.assert_array_equal(bit.astype(bool), want)
    if w < 8:
        assert (table >> w == 0).all()  # no bit past the tile


@pytest.mark.parametrize("lanes", [1, 5, 8])
def test_status_gate_rows_are_the_unsettled_gate(lanes):
    rng = np.random.default_rng(20 + lanes)
    n = 40
    status = rng.integers(0, 3, (lanes, n)).astype(np.int32)
    spec = JC._KEY_SPECS["in_dyn"]
    assert spec.gate == "unsettled"
    z = jnp.zeros(n, jnp.float32)
    gate = np.asarray(JC.key_gate(spec, jnp.asarray(status), z, z, {}))
    gate = np.concatenate([gate, np.full((lanes, 1), INF, np.float32)], 1)
    rows = ref.status_gate_rows(ref.status_gate_table(T(status), n + 1),
                                lanes)
    assert_bits(gate, rows)


@pytest.mark.parametrize("lanes,n,rows,d", [(8, 60, 60, 9), (3, 45, 20, 4),
                                            (13, 30, 30, 16), (1, 70, 70, 7)])
def test_status_twin_matches_reference_kernels(lanes, n, rows, d):
    """#5 on the padded gate and #6 at V = 1 on the unpadded one, in the
    reference, against the twin that reads the table; -0 weights make ties
    of 0 + -0 and 0 + +0 (both +0) in every row."""
    rng = np.random.default_rng(lanes * 100 + n)
    status = rng.integers(0, 3, (lanes, n)).astype(np.int32)
    cols, ws = _signed_ell(rng, rows, d, n)
    z = jnp.zeros(n, jnp.float32)
    gate = JC.key_gate(JC._KEY_SPECS["out_dyn"], jnp.asarray(status), z, z,
                       {})
    want6 = j_ell_gather_min_batch(gate[None], jnp.asarray(cols),
                                   jnp.asarray(ws), interpret=True)[0]
    got = ell_key_min_status_batch(T(status), T(cols), T(ws))
    assert_bits(want6, got)
    assert_bits(want6, ref.ell_key_min_status_batch_ref(T(status), T(cols),
                                                        T(ws)))
    if rows == n:
        padded = jnp.concatenate([gate, jnp.full((lanes, 1), jnp.inf)], 1)
        want5 = j_ell_key_min_batch(padded, jnp.asarray(cols),
                                    jnp.asarray(ws), interpret=True)
        assert_bits(want5, got)


def test_ops_choose_the_table_by_the_gate_kind_only():
    """An "unsettled" gate on the padded layout never builds its f32 gate;
    any other kind, or the sliced layout, does; all give the same bits."""
    g = TGen.kronecker(7, seed=5, device="cpu")
    rng = np.random.default_rng(7)
    status = T(rng.integers(0, 3, (4, g.n)).astype(np.int32))
    gate = torch.where(status < 2, 0.0, INF).to(torch.float32)
    built = []

    def make_gate():
        built.append(1)
        return gate

    padded, sliced = TG.to_ell_in(g), TG.to_ell_in_sliced(g)
    want = tops.key_min_batch_any(gate, padded)
    for use_kernels in (True, False):
        got = tops.key_min_batch_for("unsettled", status, make_gate, padded,
                                     use_kernels=use_kernels)
        assert not built
        assert_bits(want.numpy(), got)
    for kind, ell in (("twohop", padded), ("unsettled", sliced)):
        got = tops.key_min_batch_for(kind, status, make_gate, ell)
        assert built.pop() == 1
        assert_bits(want.numpy(), got)


def test_status_wrapper_rejects_what_the_kernel_does_not_take():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    ws = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="int32 status"):
        ell_key_min_status_batch(torch.zeros((2, 4)), cols, ws)
    with pytest.raises(ValueError, match="contiguous"):
        ell_key_min_status_batch(
            torch.zeros((4, 2), dtype=torch.int32).t(), cols, ws)


@pytest.mark.parametrize("graph", ["gnp", "kronecker"])
def test_insimple_outsimple_solves_match_reference(graph):
    """The plan whose out-scan (out_dyn) and priming (in_dyn) take the
    status-gate table, on graphs with -0 weights."""
    rng = np.random.default_rng(3)
    if graph == "gnp":
        gj0 = JGen.uniform_gnp(150, 0.05, seed=3)
    else:
        gj0 = JGen.kronecker(7, seed=21)
    src, dst = np.asarray(gj0.src), np.asarray(gj0.dst)
    w = np.asarray(gj0.w).copy()
    real = np.isfinite(w)
    src, dst, w = src[real], dst[real], w[real]
    w[rng.random(w.size) < 0.3] = -0.0
    w[rng.random(w.size) < 0.2] = 0.0
    gj = JG.from_coo(src, dst, w, n=gj0.n)
    gt = TG.from_coo(src, dst, w, n=gj0.n, device="cpu")
    srcs = np.asarray([0, 5, gt.n - 1], np.int32)
    kw = dict(criterion="insimple|outsimple", trace_len=8)
    want = JS.run_phased_static_batch(gj, srcs, **kw)
    got = TS.run_phased_static_batch(gt, srcs, device="cpu", **kw)
    for f in RESULT_FIELDS:
        assert_bits(getattr(want, f), getattr(got, f))
