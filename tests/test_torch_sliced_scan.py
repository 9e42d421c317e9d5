"""The sliced fused scans' new plan, held against the JAX reference.

The fused sliced scans (#10 ``ell_sliced_relax_keys_batch``, #11
``ell_sliced_keys_dep_batch``) run on the pipelined scan body over a unit
list that spans the buckets, write each single-row vertex's result in
place, and merge only a short list of vertices. On the CPU this checks the
parts a card run relies on:

  * ``row_owner`` plus the short list (``sliced_ell``) reproduce
    ``ref.merge_parts`` bit for bit on views with split hubs, vertices
    without rows, NaN and signed zeros;
  * the host unit table (``ell_sliced.scan_units``) covers every row of
    every bucket once, with a geometry the kernel takes;
  * ``ops.in_scan_relax_keys_batch`` with and without the outgoing view
    (the push as sweep 0) gives the reference's ``(upd, keys)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import ops as jops
from repro.kernels import registry as R
from repro.kernels.ell_relax_keys import (
    ell_sliced_relax_keys_batch as j_sliced_relax_keys,
)
from repro_torch import interop
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import config, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ell_sliced import (
    SLICED_GROUP_BUCKETS,
    bucket_groups,
    ell_sliced_relax_keys_batch,
    lane_tile,
    scan_geometry,
    scan_units,
)

torch.set_num_threads(1)

INF = np.inf
VALUES = np.array([0.0, -0.0, 0.5, 1.0, INF], np.float32)


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


def carry(view):
    return interop.sliced_from_numpy(
        {"slices": [{"rows": np.asarray(s.rows), "cols": np.asarray(s.cols),
                     "ws": np.asarray(s.ws)} for s in view.slices],
         "merge_idx": np.asarray(view.merge_idx)},
        device="cpu")


def _hub_coo():
    """Vertex 0 has in- and out-degree 1,300 (it splits into three rows of
    the 512 bucket), vertices 1-4 are mid-sized, and 60 of the 200 have no
    arc at all."""
    rng = np.random.default_rng(8)
    n = 200
    hub = rng.integers(1, 140, 1300)
    mids = np.repeat(np.arange(1, 5), [40, 100, 200, 600])
    mid_src = rng.integers(0, 140, mids.size)
    tail = rng.integers(0, 140, (2, 500))
    src = np.concatenate([hub, np.zeros(1300, int), mid_src, tail[0]])
    dst = np.concatenate([np.zeros(1300, int), hub, mids, tail[1]])
    w = VALUES[:4][rng.integers(0, 4, src.size)]
    return src.astype(np.int32), dst.astype(np.int32), w, n


def _hub_graphs():
    src, dst, w, n = _hub_coo()
    return JG.from_coo(src, dst, w, n), TG.from_coo(src, dst, w, n,
                                                    device="cpu")


def _shared_row_view():
    """A hand-made plan: vertex 1 lists row 0 alone, which vertex 2 lists
    too (so neither is written through), vertex 3 lists row 2 alone,
    vertex 0 lists nothing."""
    rows = torch.tensor([1, 2, 3], dtype=torch.int32)
    cols = torch.tensor([[0, 4], [2, 4], [1, 0]], dtype=torch.int32)
    ws = torch.tensor([[0.5, INF], [-0.0, INF], [0.0, 1.0]])
    midx = torch.tensor([[3, 3], [0, 3], [1, 0], [2, 3]], dtype=torch.int32)
    return TG.sliced_ell([TG.EllSlice(rows, cols, ws)], midx)


def _views():
    _, gt = _hub_graphs()
    kron = TGen.kronecker(8, seed=3, device="cpu")
    empty = TG.from_coo(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.float32), n=7, device="cpu")
    return {
        "hub_in": TG.to_ell_in_sliced(gt, boundaries=(8, 32, 128, 512)),
        "hub_out": TG.to_ell_out_sliced(gt, boundaries=(8, 32, 128, 512)),
        "kron_split": TG.to_ell_in_sliced(kron, boundaries=(8,), split=8),
        "kron_default": TG.to_ell_out_sliced(kron),
        "fixture": carry(R.fixture_sliced(side="in")),
        "edgeless": TG.to_ell_in_sliced(empty),
        "shared_row": _shared_row_view(),
    }


VIEWS = _views()


def write_through(parts, view, lead):
    """What the kernel does, in the plain form: rows of direct vertices
    straight into out, the others into the compact scratch, then the short
    merge (fold the leading ``merge_multi`` vertices, +inf for the rest).
    Every vertex must be written exactly once."""
    n = view.merge_idx.shape[0]
    flat = (torch.cat(list(parts), dim=-1) if parts
            else torch.zeros(tuple(lead) + (0,)))
    out = torch.full(tuple(lead) + (n,), float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    owner = view.row_owner.long()
    direct = owner >= 0
    out[..., owner[direct]] = flat[..., direct]
    writes.index_add_(0, owner[direct], torch.ones_like(owner[direct]))
    split = torch.full(tuple(lead) + (view.split_rows,), float("nan"))
    split[..., -1 - owner[~direct]] = flat[..., ~direct]
    ptr, pos = view.merge_ptr.tolist(), view.merge_pos.long()
    for i, v in enumerate(view.merge_short.tolist()):
        acc = torch.full(tuple(lead), INF)
        if i < view.merge_multi:
            for q in pos[ptr[v]:ptr[v + 1]].tolist():
                assert owner[q] < 0
                acc = ref.nan_min(acc, split[..., -1 - int(owner[q])])
        else:
            assert ptr[v] == ptr[v + 1]
        out[..., v] = acc
        writes[v] += 1
    assert bool((writes == 1).all())
    return out


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_write_through_plan_reproduces_merge_parts(name, lanes):
    view = VIEWS[name]
    rng = np.random.default_rng(lanes)
    lead = (lanes,)
    parts = []
    for s in view.slices:
        if not s.rows.shape[0]:
            continue
        x = VALUES[rng.integers(0, VALUES.size, lead + (s.rows.shape[0],))]
        x[rng.random(x.shape) < 0.05] = np.nan
        parts.append(T(x))
    assert_bits(ref.merge_parts(parts, view.merge_idx, lead).numpy(),
                write_through(parts, view, lead))


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_write_through_plan_shape(name):
    view = VIEWS[name]
    counts = (view.merge_ptr[1:] - view.merge_ptr[:-1]).numpy()
    owner = view.row_owner.numpy()
    short = view.merge_short.numpy()
    slots = np.sort(-1 - owner[owner < 0])
    assert view.split_rows == slots.size
    np.testing.assert_array_equal(slots, np.arange(slots.size))
    direct = owner[owner >= 0]
    assert np.unique(direct).size == direct.size
    assert (counts[direct] == 1).all()
    assert np.intersect1d(direct, short).size == 0
    assert direct.size + short.size == counts.size
    multi, rest = short[:view.merge_multi], short[view.merge_multi:]
    assert (counts[multi] >= 1).all() and (counts[rest] == 0).all()
    assert (np.diff(multi) > 0).all() and (np.diff(rest) > 0).all()


def test_hub_view_splits_and_writes_most_rows_through():
    view = VIEWS["hub_in"]
    assert view.widths == (8, 32, 128, 512)
    assert int((view.slices[-1].rows == 0).sum()) == 3  # the hub's 3 rows
    assert view.merge_multi >= 2  # the hub and the 600-arc vertex
    assert view.split_rows < view.total_rows // 4
    assert view.merge_short.numel() - view.merge_multi >= 60


# --- the unit table --------------------------------------------------------


def _shapes():
    return [{}, {"cap": 2560}, {"skip_warps": 8}, {"warps": 4}]


@pytest.mark.parametrize("shape", _shapes(), ids=str)
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("lanes", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("name", ["hub_in", "hub_out", "kron_split",
                                  "fixture", "edgeless"])
def test_unit_table_covers_every_row_once(name, lanes, skip, shape):
    view = VIEWS[name]
    cap = shape.get("cap", config.SCAN_CAP)
    warps = shape.get("skip_warps" if skip else "warps",
                      config.SCAN_SKIP_WARPS if skip else config.SCAN_WARPS)
    table = scan_units(view, lanes, skip, **shape)
    live = [s for s in view.slices if s.rows.shape[0]]
    assert len(table) == len(live)
    w = lane_tile(lanes)
    unit, row = 0, 0
    covered = np.zeros(view.total_rows, np.int64)
    for i, (s, entry) in enumerate(zip(live, table)):
        if i % SLICED_GROUP_BUCKETS == 0:
            unit = 0  # each group's units count from 0: one launch a group
        c, wt, n_rows, d_pad, tpr, rows, chunk, chunks, first, offset = entry
        assert (c, wt) == (s.cols.data_ptr(), s.ws.data_ptr())
        assert (n_rows, d_pad) == tuple(s.cols.shape)
        assert tpr & (tpr - 1) == 0 and max(w // 4, 1) <= tpr <= 32
        assert rows * tpr == 32 * warps
        assert chunks == -(-d_pad // chunk) and chunk <= d_pad
        if chunks == 1:
            assert rows * d_pad <= cap
        else:
            assert rows * (chunk + 8) <= cap
        assert (first, offset) == (unit, row)
        units = -(-n_rows // rows)
        for u in range(units):  # each unit's rows, as the kernel walks them
            lo = offset + u * rows
            covered[lo:min(lo + rows, offset + n_rows)] += 1
        unit += units
        row += n_rows
    assert row == view.total_rows
    assert (covered == 1).all()


def test_unit_geometry_of_the_default_widths():
    """kronecker(20)'s widths (8, 32, 128, 512) at 8 lanes: a 512-wide row
    (a split hub's) fits one stage at 32 threads a row on a dense sweep."""
    dense = [scan_geometry(d, 8, False) for d in (8, 32, 128, 512)]
    assert dense == [(2, 128, 8, 1), (2, 128, 32, 1), (8, 32, 128, 1),
                     (32, 8, 512, 1)]
    sparse = [scan_geometry(d, 8, True) for d in (8, 32, 128, 512)]
    assert sparse == [(2, 256, 8, 1), (4, 128, 32, 1), (16, 32, 128, 1),
                      (32, 16, 312, 2)]
    assert scan_geometry(152, 8, False) == (8, 32, 152, 1)  # padded G(1e6)


def test_unit_table_refuses_too_many_buckets():
    """17 buckets with rows, one more than a launch takes: the table is no
    longer refused but cut into two groups (16 + 1), each group's units
    counted from 0, the rows' offsets running on across the groups."""
    deg = 8 * np.arange(1, 18)
    dst = np.repeat(np.arange(17), deg).astype(np.int32)
    src = (np.arange(dst.size) % 150 + 17).astype(np.int32)
    g = TG.from_coo(src, dst, np.ones(dst.size, np.float32), n=200,
                    device="cpu")
    wide = TG.to_ell_in_sliced(g, boundaries=tuple(deg))
    assert [len(grp) for grp in bucket_groups(wide)] == [16, 1]
    table = scan_units(wide, 8, False)
    assert len(table) == 17
    assert table[16][8] == 0 and table[15][8] > 0
    assert [e[9] for e in table] == list(range(17))  # one row a bucket


# --- #10 with and without the out-view -------------------------------------


def _gate_parts(rng, b, n, k):
    def part(nan):
        x = VALUES[rng.integers(0, VALUES.size, (k, b, n))]
        if nan:
            x[0, 1, rng.integers(0, n, 2)] = np.nan
        return x
    return [part(i == 0) for i in range(3)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("graph", ["hub", "kronecker"])
def test_in_scan_with_and_without_the_out_view(graph, k):
    if graph == "hub":
        gj, gt = _hub_graphs()
        kw = dict(boundaries=(8, 32, 128, 512))
    else:
        gj = JGen.kronecker(8, seed=2)
        gt = TGen.kronecker(8, seed=2, device="cpu")
        kw = {}
    jv = JG.to_ell_in_sliced(gj, **kw)
    tv_in = TG.to_ell_in_sliced(gt, **kw)
    tv_out = TG.to_ell_out_sliced(gt, **kw)
    rng = np.random.default_rng(k)
    b, n = 3, gt.n
    d = VALUES[rng.integers(0, 4, (b, n))]
    settle = rng.random((b, n)) < 0.3
    ga, gb, gc = _gate_parts(rng, b, n, k)
    c = int(tv_in.slices[0].cols[0, 0])  # an in-neighbour of some row
    d[1, c], settle[1, c], ga[0, 2, c] = np.nan, True, np.nan
    jparts = [tuple(jnp.asarray(x[i]) for x in (ga, gb, gc)) for i in range(k)]
    tparts = [tuple(T(x[i]) for x in (ga, gb, gc)) for i in range(k)]
    want = jops.in_scan_relax_keys_batch(jnp.asarray(d), jnp.asarray(settle),
                                         jparts, jv, use_pallas=False)
    assert np.isnan(np.asarray(want[0])).any()
    assert np.isnan(np.asarray(want[1])).any()
    for out_view in (None, tv_out):
        for use_kernels in (True, False):
            got = tops.in_scan_relax_keys_batch(
                T(d), T(settle), tparts, tv_in, out_view=out_view,
                use_kernels=use_kernels)
            assert_bits(want[0], got[0])
            assert_bits(want[1], got[1])
    # the wrapper itself against the reference's Pallas kernel
    dmask = np.where(settle, d, INF).astype(np.float32)
    want = j_sliced_relax_keys(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                               jv, interpret=True)
    for out_view in (None, tv_out):
        got = ell_sliced_relax_keys_batch(T(dmask), T(ga), T(gb), T(gc),
                                          tv_in, out_view=out_view)
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


def test_padded_in_scan_takes_no_out_view():
    _, gt = _hub_graphs()
    d = torch.zeros((1, gt.n))
    parts = [(d, d, d)]
    with pytest.raises(ValueError, match="sliced layout"):
        tops.in_scan_relax_keys_batch(d, d > 0, parts, TG.to_ell_in(gt),
                                      out_view=TG.to_ell_out(gt))


def test_sliced_in_out_phase_hands_the_out_view_to_the_in_scan(monkeypatch):
    """On the sliced layout the in|out phase passes its outgoing view, so
    the card runs #10's push form; the padded phase passes none."""
    gj, gt = _hub_graphs()
    seen = []
    inner = tops.ell_sliced_relax_keys_batch

    def spy(*args, out_view=None):
        seen.append(out_view)
        return inner(*args, out_view=out_view)

    monkeypatch.setattr(tops, "ell_sliced_relax_keys_batch", spy)
    srcs = np.array([0, 3, 150], np.int32)
    kw = dict(boundaries=(8, 32, 128, 512))
    jv = (JG.to_ell_in_sliced(gj, **kw), JG.to_ell_out_sliced(gj, **kw))
    tv = (TG.to_ell_in_sliced(gt, **kw), TG.to_ell_out_sliced(gt, **kw))
    sj = JS.init_batch_state(gj, srcs, criterion="in|out")
    st = TS.init_batch_state(gt, srcs, criterion="in|out", device="cpu")
    for _ in range(3):
        sj = JS.step_batch(gj, sj, 1, ell=jv[0], ell_out=jv[1],
                           use_pallas=False)
        st = TS.step_batch(gt, st, 1, ell=tv[0], ell_out=tv[1])
        assert_bits(np.asarray(sj.crit_keys), st.crit_keys)
        assert_bits(np.asarray(sj.dist), st.dist)
    assert len(seen) == 3 and all(v is tv[1] for v in seen)
