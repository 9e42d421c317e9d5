"""The phase-committing pair's plain twins against the reference, bit for
bit.

Every criterion plan that relaxes by the push (no in-side dynamic keys, no
oracle) commits its phase through the settle mark, the worklist push and
the tail (``kernels/settle_push.py``); on the CPU ``step_batch`` runs their
twins (``ref.settle_mark_ref``, ``settle_push_ref``, ``settle_tail_ref``).
Each case steps both packages from one seeded state through the same
calls, the reference with its plain twins (``use_pallas=False``), and
compares every state field after each call, bit for bit, on both layouts:
with target and empty lanes, under ``stop_on_lane_finish``, with NaN fault
rows, with the telemetry rings (the attribution ring's first-true counts
come from the mark), on an out-view with more buckets than the mark
aggregates in shared memory, and on calls that end in dead phases. The
hazard test builds a settled source that a candidate of its own phase
lowers: its out-edges still push from its entry distance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JGr
from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro.kernels import ops as JO
from repro_torch.core import graph as TGr
from repro_torch.core import policies as TP
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import ref
from repro_torch.kernels import settle_push as SP
from test_torch_chunk_loop import assert_states_equal

torch.set_num_threads(1)

J = TS.PHASES_PER_REPLAY
E = TS.EMPTY_LANE

# name -> (criterion, layout, init kwargs, sources, stop_on_lane_finish,
#          NaN fault slots (lane, vertex) or ())
CASES = {
    "default_padded": ("instatic|outstatic", "padded", {}, [0, 7, 90, 3],
                       False, ()),
    "default_sliced": ("instatic|outstatic", "sliced", {}, [5, 1, 170, 44],
                       False, ()),
    "dijk_padded": ("dijk", "padded", {}, [2, 60, 130], False, ()),
    "dijk_sliced": ("dijk", "sliced", {"trace_len": 7}, [9, 100], False, ()),
    "instatic_sliced": ("instatic", "sliced", {}, [3, 77, 150], False, ()),
    "outstatic_padded": ("outstatic", "padded", {}, [11, 140], False, ()),
    "outsimple_padded": ("outsimple", "padded", {}, [0, 33, 120], False, ()),
    "outsimple_sliced": ("outsimple", "sliced", {}, [4, 88], False, ()),
    "dijk_outstatic": ("dijk|outstatic", "padded", {}, [6, 170], False, ()),
    "instatic_out_sliced": ("instatic|out", "sliced", {}, [1, 95, 160],
                            False, ()),
    "outweak_padded": ("outweak", "padded", {}, [8, 49], False, ()),
    "targets_empty": ("instatic|outstatic", "padded",
                      {"targets": [60, E, 12, E]}, [0, 5, E, 99], False, ()),
    "targets_stop_sliced": ("instatic|outstatic", "sliced",
                            {"targets": [100, E, 3], "trace_len": 4},
                            [7, 61, 20], True, ()),
    "stop_padded": ("instatic|outstatic", "padded", {"trace_len": 3},
                    [0, 17, 140, E], True, ()),
    "nan_padded": ("instatic|outstatic", "padded", {}, [0, 50, 100],
                   False, ((1, 170), (2, 3), (2, 177))),
    "nan_sliced_targets": ("dijk|outstatic", "sliced",
                           {"targets": [E, 44, 120]}, [9, 30, 150], False,
                           ((0, 160), (2, 11))),
    # the attribution ring: each settled vertex to its first true term
    "telemetry_default_padded": ("instatic|outstatic", "padded",
                                 {"telemetry": True, "trace_len": 5},
                                 [0, 7, E, 90], False, ()),
    "telemetry_four_terms_sliced": ("dijk|instatic|outstatic|outsimple",
                                    "sliced", {"telemetry": True},
                                    [3, 60, 111], False, ((1, 40),)),
    "telemetry_targets_stop": ("dijk|outstatic", "padded",
                               {"telemetry": True, "trace_len": 3,
                                "targets": [70, E, 15]}, [2, 19, 150],
                               True, ()),
}


def _graphs(seed=3, n=180, p=0.03):
    return (JGen.uniform_gnp(n, p, seed=seed),
            TGen.uniform_gnp(n, p, seed=seed, device="cpu"))


def _pair(case, gj, gt):
    crit, layout, kw, sources, stop, faults = CASES[case]
    sj = JS.init_batch_state(gj, sources, criterion=crit, **kw)
    st = TS.init_batch_state(gt, sources, criterion=crit, device="cpu", **kw)
    if faults:
        # NaN in unexplored slots: a relax that lands there makes them
        # fringe with a NaN distance, and the lane then settles nothing
        d = np.asarray(sj.dist).copy()
        for lane, v in faults:
            d[lane, v] = np.nan
        sj = dataclasses.replace(sj, dist=jnp.asarray(d))
        st = dataclasses.replace(st, dist=torch.from_numpy(d))
    step_kw = {"stop_on_lane_finish": stop}
    if layout == "sliced":
        step_kw["ell"] = TGr.to_ell_in_sliced(gt)
    return sj, st, step_kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_pair_steps_as_the_reference(case):
    """Calls of J + 3 and 5 phases, then to the end (the chunk runs dead
    phases past it), then again on the finished state: every field after
    each call, bit for bit."""
    crit = CASES[case][0]
    assert TP.policy_for(crit).commits
    gj, gt = _graphs()
    sj, st, step_kw = _pair(case, gj, gt)
    stop = step_kw["stop_on_lane_finish"]
    for k in (J + 3, 5, 4 * gt.n + 16, 4 * gt.n + 16, J):
        sj = JS.step_batch(gj, sj, k, use_pallas=False,
                           stop_on_lane_finish=stop)
        st = TS.step_batch(gt, st, k, **step_kw)
        assert_states_equal(sj, st)


def test_the_pair_is_the_plans_choice(monkeypatch):
    """The pair is the plan's choice: oracle plans and plans with in-side
    keys never take it, and a push plan takes it with the attribution ring
    as without (one commit a phase)."""
    assert not TP.policy_for("oracle").commits
    assert not TP.policy_for("instatic|outstatic|oracle").commits
    assert not TP.policy_for("in|out").commits  # relaxes in the in-scan
    _, gt = _graphs(seed=4)
    calls = []
    real = SP.commit_phase

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TP.kops, "commit_phase", counted)
    for telemetry in (True, False):
        calls.clear()
        st = TS.init_batch_state(gt, [0, 9], device="cpu",
                                 telemetry=telemetry, trace_len=4)
        TS.step_batch(gt, st, 3)
        assert len(calls) == J
        calls.clear()
        st = TS.init_batch_state(gt, [0, 9], device="cpu",
                                 criterion="dijk|oracle",
                                 dist_true=torch.zeros((2, gt.n)),
                                 telemetry=telemetry, trace_len=4)
        TS.step_batch(gt, st, 3)
        assert calls == []


def _many_degrees_graph(n=200, widths=90, seed=6):
    """Vertex v has out-degree v % widths + 1 to distinct other vertices,
    so an out-view sliced at every width 1..widths has a bucket with rows
    for each."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(n):
        to = rng.choice(n - 1, v % widths + 1, replace=False)
        src += [v] * len(to)
        dst += list(to + (to >= v))
    w = rng.uniform(0.0, 1.0, len(src)).astype(np.float32)
    return np.array(src, np.int32), np.array(dst, np.int32), w


@pytest.mark.parametrize("crit,telemetry",
                         [("instatic|outstatic", False),
                          ("dijk|outstatic", True)])
def test_the_pair_steps_over_more_buckets_than_the_mark_aggregates(
        crit, telemetry):
    """``step_batch(..., ell_out=)`` on an out-view with 90 buckets with
    rows (the mark aggregates the appends of at most 64 in shared memory,
    and appends straight to the list counts beyond): every field after
    each call against the reference's, bit for bit."""
    src, dst, w = _many_degrees_graph()
    n = 200
    gj = JGr.from_coo(src, dst, w, n)
    gt = TGr.from_coo(src, dst, w, n, device="cpu")
    view = TGr.to_ell_out_sliced(gt, pad_multiple=1,
                                 boundaries=tuple(range(1, 91)))
    assert sum(1 for s in view.slices if s.rows.shape[0]) == 90
    kw = {"telemetry": telemetry, "trace_len": 4} if telemetry else {}
    sources = [0, 45, 130, 199]
    sj = JS.init_batch_state(gj, sources, criterion=crit, **kw)
    st = TS.init_batch_state(gt, sources, criterion=crit, device="cpu", **kw)
    for k in (J + 1, 4 * n):
        sj = JS.step_batch(gj, sj, k, use_pallas=False)
        st = TS.step_batch(gt, st, k, ell_out=view)
        assert_states_equal(sj, st)


def _hazard_graph():
    """0 -> 1 (w 1), 1 -> 2 (w 1), 0 -> 2 (w 5), 2 -> 3 (w 1), 3 -> 0."""
    src = np.array([0, 1, 0, 2, 3], np.int32)
    dst = np.array([1, 2, 2, 3, 0], np.int32)
    w = np.array([1.0, 1.0, 5.0, 1.0, 0.5], np.float32)
    return src, dst, w


@pytest.mark.parametrize("sliced", [False, True])
def test_a_source_lowered_in_its_own_phase_pushes_its_entry_distance(sliced):
    """Vertices 0, 1, 2 settle in one phase (an OUT threshold above every
    fringe distance): 0's candidate lowers the settled 1 (3 -> 1), and 1
    and 2 must push from their entry distances (3 and 10), as the
    reference's min(d, upd) over the entry's dmask gives: d[2] = 4, not
    2, and d[3] = 11, not 5."""
    src, dst, w = _hazard_graph()
    gj = JGr.from_coo(src, dst, w, 4)
    gt = TGr.from_coo(src, dst, w, 4, device="cpu")
    d = np.array([[0.0, 3.0, 10.0, np.inf], [np.inf, 0.0, np.inf, np.inf]],
                 np.float32)
    status = np.array([[1, 1, 1, 0], [0, 1, 0, 0]], np.int32)
    mins = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)  # K = 1
    # the reference's phase body on these inputs
    settle = (status == 1) & (d <= mins[1][:, None])
    cols, ws = JGr.to_ell_in(gj)
    upd = JO.relax_settled_batch(jnp.asarray(d), jnp.asarray(settle), cols,
                                 ws, use_pallas=False)
    want_d = np.asarray(jnp.minimum(jnp.asarray(d), upd))
    want_s = np.asarray(jnp.where(
        settle, 2, jnp.where((status == 0) & (upd < np.inf), 1, status)))
    assert want_d[0, 2] == 4.0 and want_d[0, 3] == 11.0
    view = (TGr.to_ell_out_sliced(gt, pad_multiple=1, boundaries=(1,))
            if sliced else TGr.to_ell_out(gt))
    kw = {"vrows": TGr.vertex_row_table(gt, view)} if sliced else {}
    n_f = torch.from_numpy((status == 1).sum(1).astype(np.int32))
    got = SP.settle_phase_batch(
        torch.from_numpy(d), torch.from_numpy(status), torch.from_numpy(mins),
        n_f, n_f > 0, view, TGr.out_degrees(gt), None, zero=False, **kw)
    np.testing.assert_array_equal(got.dist.numpy().view(np.int32),
                                  want_d.view(np.int32))
    np.testing.assert_array_equal(got.status.numpy(), want_s)
    np.testing.assert_array_equal(got.settled_trace[:, 0].numpy(), [3, 1])
    np.testing.assert_array_equal(got.relax_edges.numpy(), [4, 1])
    assert int(got.trips) == 1 and int(got.budget) == 0


def test_the_mark_twin_returns_the_worklist_and_counters():
    """The mark's twin alone: the settle mask under the predicate, the
    worklist (relax sources below +inf and below a target's bound) and the
    counters; a dead phase (no budget) decides nothing."""
    d = torch.tensor([[0.0, 2.0, np.inf, 1.0], [5.0, 1.0, 1.0, 0.5]])
    status = torch.tensor([[1, 1, 1, 0], [1, 1, 2, 1]], dtype=torch.int32)
    mins = torch.tensor([[0.0, 0.5], [np.inf, 1.0]])
    n_f = torch.tensor([3, 3], dtype=torch.int32)
    deg = torch.tensor([2, 1, 3, 4], dtype=torch.int32)
    target = torch.tensor([-1, 1], dtype=torch.int32)
    kw = dict(zero=True, in_key=None, stop=False, target=target, out_deg=deg)
    m = ref.settle_mark_ref(d, status, mins, n_f, n_f > 0,
                            torch.tensor(1, dtype=torch.int32), **kw)
    assert bool(m.go)
    # lane 0: every fringe vertex (the OUT lane is +inf); the +inf one
    # settles, and on a target state a full-solve lane's bound (+inf) keeps
    # it out of the relax; lane 1: d <= 1 on the fringe (1 and 3), and only
    # 3 (0.5 < the target's 1.0) relaxes
    np.testing.assert_array_equal(m.settle.numpy(),
                                  [[1, 1, 1, 0], [0, 1, 0, 1]])
    np.testing.assert_array_equal(m.sources.numpy(),
                                  [[1, 1, 0, 0], [0, 0, 0, 1]])
    np.testing.assert_array_equal(m.n_settled.numpy(), [3, 2])
    np.testing.assert_array_equal(m.relax_inc.numpy(), [3, 4])
    dead = ref.settle_mark_ref(d, status, mins, n_f, n_f > 0,
                               torch.tensor(0, dtype=torch.int32), **kw)
    assert not bool(dead.go) and not bool(dead.settle.any())
    assert int(dead.relax_inc.sum()) == 0
    # the first-true claim over the terms in order (zero, then the OUT
    # lane): lane 0 settles 0 by d <= min_F d and 1, 2 by the OUT lane;
    # lane 1 settles 3 by d <= min_F d (0.5) and 1 by the OUT lane (1.0)
    m = ref.settle_mark_ref(d, status, mins, n_f, n_f > 0,
                            torch.tensor(1, dtype=torch.int32), attr=True,
                            **kw)
    np.testing.assert_array_equal(m.attr_counts.numpy(), [[1, 2], [1, 1]])
