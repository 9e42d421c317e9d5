"""The port's chunk loop against the reference's device loop, bit for bit.

``step_batch`` runs the loop as chunks of ``PHASES_PER_REPLAY`` gated
phases (``core/static_engine.py``): on the CPU the chunk function runs
eagerly, the same function the card captures in a CUDA graph. Every case
steps both packages from one seeded state through the same schedule of
calls and compares every state field after each call, bit for bit: the
reference runs its ``lax.while_loop`` with its plain twins
(``use_pallas=False``), as its own stepper tests run it on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import static_engine as JS
from repro.graphs import generators as JGen
from repro_torch import interop
from repro_torch.analysis import trace_guard as TG
from repro_torch.core import graph as TGr
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.kernels import launch_counters

torch.set_num_threads(1)

J = TS.PHASES_PER_REPLAY
KS = (0, 1, J - 1, J, J + 1, 3 * J + 2)
E, K = TS.EMPTY_LANE, TS.KEEP_LANE


def _graphs(seed=3, n=180, p=0.03):
    return (JGen.uniform_gnp(n, p, seed=seed),
            TGen.uniform_gnp(n, p, seed=seed, device="cpu"))


def _ref_fields(st):
    """A reference BatchState as the numpy dict interop reads."""
    return {f.name: (st.criterion if f.name == "criterion"
                     else None if getattr(st, f.name) is None
                     else np.asarray(getattr(st, f.name)))
            for f in dataclasses.fields(st)}


def assert_states_equal(sj, st):
    """Every field of the port's state against the reference's, bit for
    bit (the reference's two-limb counters folded into int64)."""
    want = interop.state_from_numpy(_ref_fields(sj), device="cpu")
    for f in dataclasses.fields(TS.BatchState):
        w, g = getattr(want, f.name), getattr(st, f.name)
        if not torch.is_tensor(w):
            assert w == g, f.name
            continue
        assert g is not None and w.shape == g.shape and w.dtype == g.dtype, (
            f.name, w.shape, w.dtype, None if g is None else g.shape)
        if w.dtype == torch.float32:
            w, g = w.view(torch.int32), g.view(torch.int32)
        assert torch.equal(w, g), f.name


def _dist_true(gj, sources):
    """(B, n) true distances: the reference's default solve, rows of
    empty lanes +inf."""
    srcs = [max(s, 0) for s in sources]
    rows = np.asarray(JS.run_phased_static_batch(gj, srcs,
                                                 use_pallas=False).dist)
    rows = rows.copy()
    rows[np.asarray(sources) < 0] = np.inf
    return rows.astype(np.float32)


# name -> (criterion, layout, init kwargs, sources, stop_on_lane_finish)
CASES = {
    "default_padded": ("instatic|outstatic", "padded", {}, [0, 7, 90, 3],
                       False),
    "default_sliced": ("instatic|outstatic", "sliced", {}, [5, 1, 170, 44],
                       False),
    "in_out": ("in|out", "padded", {}, [0, 60, 120], False),
    "oracle": ("instatic|outstatic|oracle", "padded", {}, [2, 33, 150],
               False),
    "delta": ("delta", "padded", {"delta": 0.3}, [4, 80, 177], False),
    "telemetry_wraps": ("in|out", "sliced", {"telemetry": True,
                                             "trace_len": 5},
                        [1, 9, 130], False),
    "targets_and_empty": ("instatic|outstatic", "padded",
                          {"targets": [60, E, 12, E]}, [0, 5, E, 99], False),
    "stop_on_lane_finish": ("instatic|outstatic", "padded", {"trace_len": 3},
                            [0, 17, 140, E], True),
    "delta_stop_targets": ("delta", "sliced",
                           {"delta": 0.25, "targets": [100, E, 3]},
                           [7, 61, E], True),
}


def _pair(case, gj, gt):
    """The two packages' initial states and the port's step keywords."""
    crit, layout, kw, sources, stop = CASES[case]
    kw = dict(kw)
    if "oracle" in crit:
        kw["dist_true"] = _dist_true(gj, sources)
    sj = JS.init_batch_state(gj, sources, criterion=crit, **kw)
    st = TS.init_batch_state(gt, sources, criterion=crit, device="cpu", **kw)
    step_kw = {"stop_on_lane_finish": stop}
    if layout == "sliced":
        if crit == "delta":
            step_kw["ell_out"] = TGr.to_ell_out_buckets(gt)
        else:
            step_kw["ell"] = TGr.to_ell_in_sliced(gt)
    return sj, st, step_kw


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_batch_matches_the_reference_loop(case, k):
    """Three calls of k phases, each compared, then a call to the end."""
    gj, gt = _graphs()
    sj, st, step_kw = _pair(case, gj, gt)
    stop = step_kw["stop_on_lane_finish"]
    for _ in range(3):
        sj = JS.step_batch(gj, sj, k, use_pallas=False,
                           stop_on_lane_finish=stop)
        st = TS.step_batch(gt, st, k, **step_kw)
        assert_states_equal(sj, st)
    for _ in range(8 if stop else 1):  # a stopping loop ends at each finish
        sj = JS.step_batch(gj, sj, 4 * gt.n + 16, use_pallas=False,
                           stop_on_lane_finish=stop)
        st = TS.step_batch(gt, st, 4 * gt.n + 16, **step_kw)
        assert_states_equal(sj, st)


@pytest.mark.parametrize("case", ["default_padded", "in_out", "delta",
                                  "targets_and_empty"])
def test_calls_with_reset_lanes_between_match_the_reference(case):
    gj, gt = _graphs(seed=5)
    sj, st, step_kw = _pair(case, gj, gt)
    crit, _, kw, sources, _ = CASES[case]
    b = len(sources)
    schedule = [
        ("step", J + 3), ("reset", [K] * (b - 1) + [11]), ("step", 1),
        ("step", 2 * J), ("reset", [22] + [K] * (b - 2) + [E]),
        ("step", J - 1), ("lane", 1, 40), ("step", 3 * J + 2),
        ("step", 4 * gt.n + 16),
    ]
    for op in schedule:
        if op[0] == "step":
            sj = JS.step_batch(gj, sj, op[1], use_pallas=False)
            st = TS.step_batch(gt, st, op[1], **step_kw)
        elif op[0] == "reset":
            tg = ([-1] * b) if "targets" in kw else None
            sj = JS.reset_lanes(sj, op[1], targets=tg)
            st = TS.reset_lanes(st, op[1], targets=tg)
        else:
            sj = JS.reset_lane(sj, op[1], op[2])
            st = TS.reset_lane(st, op[1], op[2])
        assert_states_equal(sj, st)
        np.testing.assert_array_equal(JS.lanes_active(sj),
                                      TS.lanes_active(st))


@pytest.mark.parametrize("case", ["default_sliced", "in_out", "delta",
                                  "telemetry_wraps", "targets_and_empty"])
def test_a_finished_state_keeps_every_bit(case):
    """Chunks run past the loop's end (every phase dead) change nothing,
    trips included."""
    gj, gt = _graphs(seed=7)
    sj, st, step_kw = _pair(case, gj, gt)
    st = TS.step_batch(gt, st, 4 * gt.n + 16, **step_kw)
    assert not TS.lanes_active(st).any()
    for k in (1, J, 3 * J + 2):
        again = TS.step_batch(gt, st, k, **step_kw)
        for f in dataclasses.fields(TS.BatchState):
            a, b = getattr(st, f.name), getattr(again, f.name)
            if torch.is_tensor(a):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, b.view(torch.int32)
                                   if b.is_floating_point() else b), f.name
            else:
                assert a == b, f.name


def test_one_host_read_a_chunk_and_the_dead_phases_counted():
    """A solve of P phases runs ceil(P / J) chunks: one read of the loop
    flag each, the phases past the end counted as dead."""
    _, gt = _graphs(seed=9)
    st = TS.init_batch_state(gt, [0, 50, 100], device="cpu")
    TS.reset_chunk_stats()
    res = TS.step_batch(gt, st, gt.n + 1)
    stats = TS.chunk_stats()
    trips = int(res.trips)
    assert stats.live_phases == trips
    # the flag a chunk ends with is the next phase's predicate: the chunk
    # that runs the last live phase is the last
    assert stats.chunks == stats.host_reads == -(-trips // J)
    assert stats.dead_phases == stats.chunks * J - trips
    assert stats.replays == stats.captures == 0  # no capture off the card


def test_launch_accounting_adds_per_replay(monkeypatch):
    """An eager chunk counts its wrappers' launches as they happen; a
    replay adds the counts its capture recorded, once a replay; the dead
    phases' share is counted apart. On the CPU the wrappers launch
    nothing, so a counting stand-in plays #2 and a stand-in graph replays
    the chunk function."""
    from repro_torch.kernels import ops as kops

    counters = launch_counters()
    crit, attr = counters["frontier_crit_lanes_batch"]
    real = kops.crit_thresholds_batch

    def counted(*a, **kw):
        setattr(crit, attr, getattr(crit, attr) + 1)
        return real(*a, **kw)

    monkeypatch.setattr(kops, "crit_thresholds_batch", counted)
    monkeypatch.setattr(crit, attr, 0)
    gt = TGen.grid_road(12, 15, seed=11, device="cpu")  # > 3 J + 4 phases
    st = TS.init_batch_state(gt, [0, 90], device="cpu")
    TS.reset_chunk_stats()
    st1 = TS.step_batch(gt, st, 3)  # one eager chunk, 3 live phases
    assert getattr(crit, attr) == J
    stats = TS.chunk_stats()
    assert stats.dead_launches == {"frontier_crit_lanes_batch": J - 3}

    chunk = next(reversed(gt.__dict__["_chunk_memo"].values()))

    class Replayed:
        def replay(self):
            before = getattr(crit, attr)
            chunk.body(gt)
            setattr(crit, attr, before)  # a replay makes no Python call

    chunk.graph, chunk.replay_counts = Replayed(), {
        "frontier_crit_lanes_batch": J}
    TS.reset_chunk_stats()
    setattr(crit, attr, 0)
    st2 = TS.step_batch(gt, st1, 2 * J + 1)
    stats = TS.chunk_stats()
    assert stats.replays == stats.chunks == 3
    assert getattr(crit, attr) == 3 * J
    assert stats.dead_launches["frontier_crit_lanes_batch"] == J - 1
    want = TS.step_batch(gt, st1, 2 * J + 1, use_kernels=False)
    for nm in ("dist", "status", "trips", "phases", "sum_fringe",
               "relax_edges"):
        assert torch.equal(getattr(st2, nm), getattr(want, nm)), nm


def test_the_memo_is_keyed_on_views_and_delta_and_bounded():
    _, gt = _graphs(seed=13)
    memo = lambda: gt.__dict__.get("_chunk_memo", {})  # noqa: E731

    def delta_step(delta, **kw):
        st = TS.init_batch_state(gt, [0, 1], criterion="delta", delta=delta,
                                 device="cpu")
        TS.step_batch(gt, st, 2, **kw)
        return next(reversed(memo().values()))

    first = delta_step(0.25)
    assert len(memo()) == 1
    assert delta_step(0.25) is first and len(memo()) == 1
    other = delta_step(0.5)
    assert other is not first and len(memo()) == 2
    sliced = delta_step(0.25, ell_out=TGr.to_ell_out_buckets(gt))
    assert sliced not in (first, other) and len(memo()) == 3
    # the views by identity: a copy of the out-view is another key
    cols, ws = TGr.to_ell_out(gt)
    copied = delta_step(0.25, ell_out=(cols.clone(), ws.clone()))
    assert copied not in (first, other, sliced)
    assert len(memo()) == TS.CHUNKS_PER_GRAPH
    # one more key frees the oldest (the first delta chunk, since the 0.5
    # chunk and the rest were made after its last use)
    st = TS.init_batch_state(gt, [0, 1], device="cpu")
    TS.step_batch(gt, st, 2, stop_on_lane_finish=True)
    assert len(memo()) == TS.CHUNKS_PER_GRAPH
    assert first not in memo().values() and other in memo().values()
    # a hit moves a chunk to the back: stepping the 0.5 chunk again keeps
    # it through the next new key
    assert delta_step(0.5) is other
    TS.step_batch(gt, st, 2)
    assert other in memo().values() and sliced not in memo().values()


def test_trace_guard_counts_captures():
    """The build sentinel's zero budget covers graph captures: a capture
    inside the block raises, none passes. (No capture runs off the card:
    the count is advanced by hand, as a capture advances it.)"""
    assert TG.capture_count() == TS.capture_count()
    with TG.TraceGuard(label="none") as guard:
        _, gt = _graphs(seed=15)
        TS.step_batch(gt, TS.init_batch_state(gt, [0], device="cpu"), J)
    assert guard.captures == 0 and guard.compiles == 0
    saved = TS._CAPTURES[0]
    try:
        with pytest.raises(TG.RetraceError, match="1 graph capture"):
            with TG.TraceGuard(label="one"):
                TS._CAPTURES[0] += 1
        with TG.TraceGuard(max_compiles=1) as guard:
            TS._CAPTURES[0] += 1
        assert guard.captures == 1 and TG.capture_count() == saved + 2
    finally:
        TS._CAPTURES[0] = saved
