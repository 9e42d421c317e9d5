"""The port's graph layer against the JAX reference, bit for bit.

Both packages build the same seeded COO graph; every array (COO fields,
static minima, incoming and outgoing ELL views, out-degrees, CSR) must be
equal element for element, floats compared as bits.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.oracle import dijkstra_numpy as j_dijkstra
from repro.graphs import generators as JGen
from repro_torch import interop
from repro_torch.core import graph as TG
from repro_torch.core.oracle import dijkstra_numpy as t_dijkstra
from repro_torch.graphs import generators as TGen

torch.set_num_threads(1)

FAMILIES = {
    "gnp": ("uniform_gnp", (150, 0.05), {}),
    "kronecker": ("kronecker", (7,), {}),
    "grid_road": ("grid_road", (9, 11), {}),
    "webgraph": ("webgraph", (200,), {"out_deg": 6}),
    "gnp_padded": ("uniform_gnp", (80, 0.05), {"pad_to": 400}),
}
FIELDS = ("src", "dst", "w", "in_min_static", "out_min_static")


def assert_bits(want, got):
    """Exact equality; float32 arrays compared through their int32 bits."""
    want = np.asarray(want)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    np.testing.assert_array_equal(want, got)


def _pair(family: str, seed: int = 3):
    fn, args, kw = FAMILIES[family]
    gj = getattr(JGen, fn)(*args, seed=seed, **kw)
    gt = getattr(TGen, fn)(*args, seed=seed, device="cpu", **kw)
    return gj, gt


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_arrays_match_reference(family):
    gj, gt = _pair(family)
    assert (gt.n, gt.m) == (gj.n, gj.m)
    for f in FIELDS:
        assert_bits(getattr(gj, f), getattr(gt, f))
    assert gt.num_real_edges == int(gj.num_real_edges)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("pad_multiple", [8, 3])
def test_ell_views_match_reference(family, pad_multiple):
    gj, gt = _pair(family)
    for jv, tv in ((JG.to_ell_in, TG.to_ell_in), (JG.to_ell_out, TG.to_ell_out)):
        (jc, jw), (tc, tw) = jv(gj, pad_multiple), tv(gt, pad_multiple)
        assert_bits(jc, tc)
        assert_bits(jw, tw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_out_degrees_csr_and_transpose_match_reference(family):
    gj, gt = _pair(family)
    assert_bits(JG.out_degrees(gj), TG.out_degrees(gt))
    for a, b in zip(JG.to_numpy_csr(gj), TG.to_numpy_csr(gt)):
        assert_bits(a, b)
    tj, tt = JG.transpose(gj), TG.transpose(gt)
    for f in FIELDS:
        assert_bits(getattr(tj, f), getattr(tt, f))
    assert_bits(JG.to_ell_in(tj)[0], TG.to_ell_in(tt)[0])


def test_ell_views_are_memoised_per_instance():
    _, gt = _pair("gnp")
    assert TG.to_ell_in(gt) is TG.to_ell_in(gt)
    assert TG.to_ell_out(gt) is TG.to_ell_out(gt)
    assert TG.to_ell_in(gt, 4) is not TG.to_ell_in(gt, 8)
    assert TG.out_degrees(gt) is TG.out_degrees(gt)


def test_sentinel_padding_and_width():
    # vertex 2 has no in-edges: its row is all sentinel (id n, w +inf)
    src, dst, w = [0, 1, 3, 3], [1, 0, 1, 0], [0.5, 0.25, 1.0, 2.0]
    gt = TG.from_coo(src, dst, w, n=4, device="cpu")
    gj = JG.from_coo(src, dst, w, n=4)
    cols, ws = TG.to_ell_in(gt)
    assert cols.shape == (4, 8)  # max in-degree 2 rounded up to 8
    assert (cols[2] == 4).all() and torch.isinf(ws[2]).all()
    assert_bits(JG.to_ell_in(gj)[0], cols)
    edgeless = TG.from_coo([], [], [], n=3, device="cpu")
    assert TG.to_ell_in(edgeless)[0].shape == (3, 8)


def test_from_coo_input_checks():
    with pytest.raises(ValueError, match="non-negative"):
        TG.from_coo([0], [1], [-0.5], n=2, device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        TG.from_coo([0], [1], [-np.inf], n=2, device="cpu")
    with pytest.raises(ValueError, match="finite"):
        TG.from_coo([0, 1], [1, 0], [0.5, np.nan], n=2, device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        TG.from_coo([0, 1], [1], [0.5], n=2, device="cpu")
    # +inf is the padding sentinel and is allowed
    g = TG.from_coo([0, 1], [1, 0], [0.5, np.inf], n=2, device="cpu")
    assert g.num_real_edges == 1
    assert float(g.out_min_static[1]) == np.inf


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the host case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.from_coo([0], [1], [0.5], n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGen.grid_road(3, 3)


def test_graph_from_numpy_takes_fields_as_given():
    gj, gt = _pair("webgraph")
    fields = {f: np.asarray(getattr(gj, f)) for f in FIELDS}
    fields.update(n=gj.n, m=gj.m)
    g2 = interop.graph_from_numpy(fields, device="cpu")
    for f in FIELDS:
        assert_bits(getattr(gj, f), getattr(g2, f))
    with pytest.raises(TypeError):
        interop.graph_from_numpy({**fields, "w": fields["w"].astype(np.float64)},
                                 device="cpu")


@pytest.mark.parametrize("family", ["gnp", "grid_road"])
def test_dijkstra_oracle_matches_reference(family):
    gj, gt = _pair(family)
    for s in (0, gt.n - 1):
        np.testing.assert_array_equal(j_dijkstra(gj, s), t_dijkstra(gt, s))
