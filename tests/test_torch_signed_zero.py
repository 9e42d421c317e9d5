"""Signed zeros: the port against the JAX reference where -0.0 meets +0.0.

``from_coo`` accepts -0.0 weights (``w < 0`` is False for it). The
reference builds its static minima with ``np.minimum.at``, where the later
of two tied arcs wins, and every jax min returns -0 for a tie of -0 and +0
in either order. ``torch.amin``, ``torch.minimum`` and ``scatter_reduce_``
keep either zero, by operand order, so the port folds through helpers that
prefer -0. Held here, bit for bit, on seeded graphs with weights drawn from
{0, -0, 0.5, 1}: the static minima; every twin against the reference's
Pallas kernel in interpret mode on vectors drawn from the same set (ties in
both orders) with NaN lanes; and the carried keys and state of 3-lane
solves after 1, 2 and 3 phases on both layouts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import static_engine as JS
from repro.kernels.ell_key_min import ell_key_min as j_key_min
from repro.kernels.ell_key_min import ell_key_min_batch as j_key_min_batch
from repro.kernels.ell_relax import ell_relax as j_relax
from repro.kernels.ell_relax import ell_relax_batch as j_relax_batch
from repro.kernels.ell_relax_keys import ell_gather_min_batch as j_gather
from repro.kernels.ell_relax_keys import ell_keys_dep_batch as j_keys_dep
from repro.kernels.ell_relax_keys import ell_relax_keys as j_relax_keys
from repro.kernels.ell_relax_keys import (
    ell_relax_keys_batch as j_relax_keys_batch,
)
from repro.kernels.ell_relax_keys import (
    ell_sliced_gather_min_batch as j_sliced_gather,
)
from repro.kernels.ell_relax_keys import (
    ell_sliced_keys_dep_batch as j_sliced_dep,
)
from repro.kernels.ell_relax_keys import (
    ell_sliced_relax_keys_batch as j_sliced_relax_keys,
)
from repro.kernels.frontier_crit import frontier_crit as j_crit
from repro.kernels.frontier_crit import frontier_crit_batch as j_crit_batch
from repro.kernels.frontier_crit import (
    frontier_crit_lanes_batch as j_crit_lanes,
)
from repro_torch import interop
from repro_torch.core import graph as TG
from repro_torch.core import static_engine as TS
from repro_torch.kernels import ref
from repro_torch.kernels.ell_key_min import ell_key_min, ell_key_min_batch
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
from repro_torch.kernels.frontier_crit import (
    frontier_crit,
    frontier_crit_batch,
    frontier_crit_lanes_batch,
)

torch.set_num_threads(1)

INF = np.inf
N, M = 60, 400
SEEDS = [0, 1, 2]
VALUES = np.array([0.0, -0.0, 0.5, 1.0], np.float32)
B = 3


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


def zeros_of_both_signs(x):
    """True where ``x`` holds both a -0 and a +0 (the ties were met)."""
    x = np.asarray(x).ravel()
    zero = x == 0
    return bool((zero & np.signbit(x)).any() and (zero & ~np.signbit(x)).any())


def coo(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    return src, dst, VALUES[rng.integers(0, VALUES.size, M)]


def graphs(seed):
    src, dst, w = coo(seed)
    return JG.from_coo(src, dst, w, n=N), TG.from_coo(src, dst, w, n=N,
                                                      device="cpu")


def values(rng, shape, nan=False, inf_frac=0.2):
    """Draws from {0, -0, 0.5, 1}, +inf on ``inf_frac``, NaN at a few
    slots of lane 1 when ``nan``."""
    x = VALUES[rng.integers(0, VALUES.size, shape)]
    x[rng.random(shape) < inf_frac] = INF
    if nan:
        lane = (slice(None),) * (len(shape) - 2) + (1,)
        x[lane + (rng.integers(0, shape[-1], 3),)] = np.nan
    return x


def carry(view):
    return interop.sliced_from_numpy(
        {"slices": [{"rows": np.asarray(s.rows), "cols": np.asarray(s.cols),
                     "ws": np.asarray(s.ws)} for s in view.slices],
         "merge_idx": np.asarray(view.merge_idx)},
        device="cpu")


# --- the static minima -------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_static_minima_match_reference(seed):
    gj, gt = graphs(seed)
    for f in ("in_min_static", "out_min_static"):
        want = np.asarray(getattr(gj, f))
        assert zeros_of_both_signs(want), f
        assert_bits(want, getattr(gt, f))


def test_static_minima_take_the_later_arc_of_a_tie():
    src = np.zeros(6, np.int32)
    dst = np.array([1, 1, 2, 2, 3, 3], np.int32)
    w = np.array([-0.0, 0.0, 0.0, -0.0, 0.5, -0.0], np.float32)
    gj = JG.from_coo(src, dst, w, n=4)
    gt = TG.from_coo(src, dst, w, n=4, device="cpu")
    assert_bits(gj.in_min_static, gt.in_min_static)
    assert_bits(gj.out_min_static, gt.out_min_static)
    assert list(np.signbit(np.asarray(gt.in_min_static))[1:]) == [False,
                                                                  True, True]


# --- every twin against its Pallas kernel ------------------------------------


def _in_ell(seed):
    gj, _ = graphs(seed)
    cols, ws = JG.to_ell_in(gj)
    return np.asarray(cols), np.asarray(ws)


@pytest.mark.parametrize("seed", SEEDS)
def test_relax_and_key_min_twins(seed):
    """#1 and its B = 1 view #3, #5 and its B = 1 view #4."""
    rng = np.random.default_rng(100 + seed)
    cols, ws = _in_ell(seed)
    n_pad = -(-(N + 1) // 128) * 128
    for j_batch, j_one, t_batch, t_one, r_batch, r_one in (
            (j_relax_batch, j_relax, ell_relax_batch, ell_relax,
             ref.ell_relax_batch_ref, ref.ell_relax_ref),
            (j_key_min_batch, j_key_min, ell_key_min_batch, ell_key_min,
             ref.ell_key_min_batch_ref, ref.ell_key_min_ref)):
        vec = values(rng, (B, n_pad), nan=True)
        vec[:, N:] = INF
        want = j_batch(jnp.asarray(vec), cols, ws, block_rows=16,
                       interpret=True)
        assert zeros_of_both_signs(want)
        assert_bits(want, t_batch(T(vec), T(cols), T(ws)))
        assert_bits(want, r_batch(T(vec), T(cols), T(ws)))
        want1 = j_one(jnp.asarray(vec[2]), cols, ws, block_rows=16,
                      interpret=True)
        assert_bits(want1, t_one(T(vec[2]), T(cols), T(ws)))
        assert_bits(want1, r_one(T(vec[2]), T(cols), T(ws)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_and_fused_scan_twins(seed):
    """#6, #7 (and its 1-D view) and #8."""
    rng = np.random.default_rng(200 + seed)
    cols, ws = _in_ell(seed)
    vecs = values(rng, (2, B, N), nan=True)
    want = j_gather(jnp.asarray(vecs), cols, ws, block_rows=16,
                    interpret=True)
    assert zeros_of_both_signs(want)
    assert_bits(want, ell_gather_min_batch(T(vecs), T(cols), T(ws)))
    dmask = values(rng, (B, N), nan=True, inf_frac=0.6)
    ga, gb, gc = (values(rng, (2, B, N), nan=i == 0) for i in range(3))
    want = j_relax_keys_batch(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                              cols, ws, block_rows=16, interpret=True)
    assert zeros_of_both_signs(want[1])
    args = [T(x) for x in (dmask, ga, gb, gc, cols, ws)]
    for got in (ell_relax_keys_batch(*args),
                ref.ell_relax_keys_batch_ref(*args)):
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])
    want1 = j_relax_keys(dmask[1], ga[:, 1], gb[:, 1], gc[:, 1], cols, ws,
                         block_rows=16, interpret=True)
    got1 = ell_relax_keys(args[0][1], args[1][:, 1], args[2][:, 1],
                          args[3][:, 1], args[4], args[5])
    assert_bits(want1[0], got1[0])
    assert_bits(want1[1], got1[1])
    gates = values(rng, (2, B, N))
    dga, dgb = values(rng, (B, N), nan=True), values(rng, (B, N))
    for dep_idx in (0, 1):
        want = j_keys_dep(*(jnp.asarray(x) for x in (gates, dga, dgb)), cols,
                          ws, dep_idx=dep_idx, block_rows=16, interpret=True)
        assert zeros_of_both_signs(want)
        args = [T(x) for x in (gates, dga, dgb)]
        assert_bits(want, ell_keys_dep_batch(*args, T(cols), T(ws),
                                             dep_idx=dep_idx))
        assert_bits(want, ref.ell_keys_dep_batch_ref(*args, dep_idx, T(cols),
                                                     T(ws)))


def _sliced(seed, side):
    gj, _ = graphs(seed)
    view = getattr(JG, f"to_ell_{side}_sliced")(gj, boundaries=(8,), split=8)
    return view, carry(view)


@pytest.mark.parametrize("seed", SEEDS)
def test_sliced_twins(seed):
    """#9, #10 and #11 on a view whose rows split (ties across rows meet in
    the merge)."""
    rng = np.random.default_rng(300 + seed)
    view, tv = _sliced(seed, "in")
    vecs = values(rng, (2, B, N), nan=True)
    want = j_sliced_gather(jnp.asarray(vecs), view, interpret=True)
    assert zeros_of_both_signs(want)
    for sparse in (False, True):
        assert_bits(want, ell_sliced_gather_min_batch(T(vecs), tv,
                                                      sparse=sparse))
    assert_bits(want, ref.ell_sliced_gather_min_batch_ref(T(vecs), tv))
    dmask = values(rng, (B, N), nan=True, inf_frac=0.6)
    ga, gb, gc = (values(rng, (2, B, N), nan=i == 2) for i in range(3))
    want = j_sliced_relax_keys(*(jnp.asarray(x) for x in (dmask, ga, gb, gc)),
                               view, interpret=True)
    assert zeros_of_both_signs(want[1])
    args = [T(x) for x in (dmask, ga, gb, gc)]
    for got in (ell_sliced_relax_keys_batch(*args, tv),
                ref.ell_sliced_relax_keys_batch_ref(*args, tv)):
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])
    gates = values(rng, (2, B, N))
    dga, dgb = values(rng, (B, N), nan=True), values(rng, (B, N))
    for dep_idx in (0, 1):
        want = j_sliced_dep(*(jnp.asarray(x) for x in (gates, dga, dgb)),
                            view, dep_idx=dep_idx, interpret=True)
        assert zeros_of_both_signs(want)
        args = [T(x) for x in (gates, dga, dgb)]
        assert_bits(want, ell_sliced_keys_dep_batch(*args, tv,
                                                    dep_idx=dep_idx))
        assert_bits(want, ref.ell_sliced_keys_dep_batch_ref(*args, dep_idx,
                                                            tv))


@pytest.mark.parametrize("seed", SEEDS)
def test_push_twin_matches_the_pull(seed):
    """The push (padded and sliced out-views) against the reference's pull
    over the in-view, on a dmask that is -0 or +0 at many settled
    vertices: the candidates' ties come in every order."""
    rng = np.random.default_rng(400 + seed)
    gj, gt = graphs(seed)
    cols, ws = _in_ell(seed)
    n_pad = -(-(N + 1) // 128) * 128
    dmask = values(rng, (B, N), nan=True, inf_frac=0.5)
    padded = np.full((B, n_pad), INF, np.float32)
    padded[:, :N] = dmask
    want = j_relax_batch(jnp.asarray(padded), cols, ws, block_rows=16,
                         interpret=True)
    assert zeros_of_both_signs(want)
    out_c, out_w = TG.to_ell_out(gt)
    _, tv_out = _sliced(seed, "out")
    for got in (ell_push_relax_batch(T(dmask), out_c, out_w),
                ref.ell_push_relax_batch_ref(T(dmask), (out_c, out_w)),
                ell_sliced_push_relax_batch(T(dmask), tv_out),
                ref.ell_push_relax_batch_ref(T(dmask), tv_out)):
        assert_bits(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_frontier_crit_twins(seed):
    """#2 with shared and per-lane keys, and its scalar and batch views."""
    rng = np.random.default_rng(500 + seed)
    d = values(rng, (B, N), nan=True)
    status = rng.integers(0, 3, (B, N)).astype(np.int32)
    om = values(rng, (N,))
    for keys in (None, values(rng, (2, N)), values(rng, (2, B, N))):
        want = j_crit_lanes(jnp.asarray(d), jnp.asarray(status),
                            None if keys is None else jnp.asarray(keys),
                            block=16, interpret=True)
        got = frontier_crit_lanes_batch(T(d), T(status),
                                        None if keys is None else T(keys))
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])
    d0 = values(rng, (B, N))  # no NaN: every lane's minima are zeros
    status[:, :4] = 1
    d0[:, :4] = np.array([0.0, -0.0, -0.0, 0.0], np.float32)
    for want, got in zip(j_crit_batch(d0, status, om, block=16,
                                      interpret=True),
                         frontier_crit_batch(T(d0), T(status), T(om))):
        assert_bits(want, got)
    want = j_crit_batch(d0, status, om, block=16, interpret=True)[0]
    assert np.signbit(np.asarray(want)).all()
    for want, got in zip(j_crit(d0[0], status[0], om, block=16,
                                interpret=True),
                         frontier_crit(T(d0[0]), T(status[0]), T(om))):
        assert_bits(want, got)


def test_fold_helpers_prefer_negative_zero_and_keep_nan():
    pz, nz, nan = 0.0, -0.0, float("nan")
    for a, b in ((pz, nz), (nz, pz), (nz, nz)):
        x = torch.tensor([a, b])
        assert torch.signbit(ref.amin(x))
        assert torch.signbit(ref.nan_min(x[:1], x[1:]))[0]
    x = torch.tensor([pz, pz, 1.0])
    assert not torch.signbit(ref.amin(x))
    assert not torch.signbit(ref.nan_min(x[:1], x[1:2]))[0]
    for x in (torch.tensor([nz, nan, pz]), torch.tensor([nan, nz])):
        assert torch.isnan(ref.amin(x))
        assert torch.isnan(ref.nan_min(x[:1], x[1:2]))


# --- solves: carried keys and state phase by phase ---------------------------


def _views(gj, gt, layout):
    if layout == "padded":
        return (None, None), (None, None)
    return ((JG.to_ell_in_sliced(gj), JG.to_ell_out_sliced(gj)),
            (TG.to_ell_in_sliced(gt), TG.to_ell_out_sliced(gt)))


@pytest.mark.parametrize("criterion", ["in|out", "instatic|outstatic"])
@pytest.mark.parametrize("layout", ["padded", "sliced"])
@pytest.mark.parametrize("seed", SEEDS)
def test_solves_carry_the_reference_bits(seed, layout, criterion):
    gj, gt = graphs(seed)
    (ji, jo), (ti, to) = _views(gj, gt, layout)
    srcs = np.array([0, 17, N - 1], np.int32)
    sj = JS.init_batch_state(gj, srcs, criterion=criterion)
    st = TS.init_batch_state(gt, srcs, criterion=criterion, device="cpu")
    met = False
    for _ in range(3):
        sj = JS.step_batch(gj, sj, 1, ell=ji, ell_out=jo, use_pallas=False)
        st = TS.step_batch(gt, st, 1, ell=ti, ell_out=to)
        for f in ("dist", "status", "phases"):
            assert_bits(np.asarray(getattr(sj, f)), getattr(st, f))
        if sj.crit_keys is None:
            assert st.crit_keys is None
        else:
            assert_bits(np.asarray(sj.crit_keys), st.crit_keys)
            met |= zeros_of_both_signs(sj.crit_keys)
    assert met or criterion != "in|out"
