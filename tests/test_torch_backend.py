"""The port's StaticBackend against the JAX reference's, bit for bit.

Both backends serve the same request stream under the same admission
schedule (refill free lanes -> step with stop_on_lane_finish -> peek ->
take_row of finished lanes); every delivered row, every peek and the
per-request phase counts must match exactly.
"""
import numpy as np
import pytest
import torch

from repro.graphs import generators as JGen
from repro.serving.backends import StaticBackend as JBackend
from repro_torch.core import static_engine as TS
from repro_torch.graphs import generators as TGen
from repro_torch.serving import EngineBackend, StaticBackend

torch.set_num_threads(1)


def _serve(backend, sources, lanes, chunk):
    """Drive a backend through the admission schedule; returns the rows,
    per-request phases and every peek."""
    state = backend.init(lanes)
    lane_req = [None] * lanes
    pending = list(range(len(sources)))
    rows, phases_of, peeks = {}, {}, []
    while pending or any(r is not None for r in lane_req):
        admit = np.full(lanes, TS.KEEP_LANE, np.int64)
        for lane in range(lanes):
            if lane_req[lane] is None and pending:
                lane_req[lane] = pending.pop(0)
                admit[lane] = sources[lane_req[lane]]
        if (admit != TS.KEEP_LANE).any():
            state = backend.reset_lanes(state, admit)
        state = backend.step(state, chunk, stop_on_lane_finish=True)
        trips, active, phases = backend.peek(state)
        peeks.append((trips, active.tolist(), phases.tolist()))
        for lane in range(lanes):
            r = lane_req[lane]
            if r is not None and not active[lane]:
                rows[r] = backend.take_row(state, lane)
                phases_of[r] = int(phases[lane])
                lane_req[lane] = None
    return rows, phases_of, peeks


@pytest.mark.parametrize("family,args,lanes,chunk", [
    ("uniform_gnp", (150, 0.04), 3, 4),
    ("grid_road", (9, 10), 4, 1000),
    ("webgraph", (160,), 2, 7),
])
def test_static_backend_rows_match_reference(family, args, lanes, chunk):
    gj = getattr(JGen, family)(*args, seed=2)
    gt = getattr(TGen, family)(*args, seed=2, device="cpu")
    sources = np.random.default_rng(1).integers(0, gt.n, 7)
    want = _serve(JBackend(gj, use_pallas=False), sources, lanes, chunk)
    got = _serve(StaticBackend(gt, device="cpu"), sources, lanes, chunk)
    assert want[2] == got[2]  # every peek: trips, live flags, phases
    assert want[1] == got[1]
    for r in range(len(sources)):
        assert want[0][r].dtype == got[0][r].dtype == np.float32
        np.testing.assert_array_equal(want[0][r].view(np.int32),
                                      got[0][r].view(np.int32))


def test_static_backend_rows_match_a_standalone_solve():
    gt = TGen.kronecker(7, seed=3, device="cpu")
    sources = np.array([0, 5, 9, 33, 2])
    rows, _, _ = _serve(StaticBackend(gt, device="cpu"), sources, 2, 3)
    batch = TS.run_phased_static_batch(gt, sources, device="cpu")
    for r in range(len(sources)):
        np.testing.assert_array_equal(rows[r], batch.dist[r].numpy())


def test_static_backend_contract():
    gt = TGen.grid_road(4, 4, seed=0, device="cpu")
    be = StaticBackend(gt, criterion="outstatic|instatic", device="cpu")
    assert isinstance(be, EngineBackend)
    assert be.criterion == "instatic|outstatic" and be.n == 16
    state = be.init(3)
    trips, active, phases = be.peek(state)
    assert trips == 0 and not active.any() and phases.tolist() == [0, 0, 0]
    row = be.take_row(state, 1)
    assert row.shape == (16,) and np.isinf(row).all()
    row[0] = 0.0  # a host-owned copy: the state is untouched
    assert torch.isinf(state.dist[1, 0])
    with pytest.raises(ValueError, match="layout must be"):
        StaticBackend(gt, layout="dense", device="cpu")
    with pytest.raises(ValueError, match="delta"):
        StaticBackend(gt, delta=0.5, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StaticBackend(gt, device="cpu", policy="delta")
    # serving never runs the oracle (the reference's ValueError), and point
    # queries are ported: target-capable lane state
    with pytest.raises(ValueError, match="oracle"):
        StaticBackend(gt, device="cpu", criterion="in|out|oracle")
    pb = StaticBackend(gt, device="cpu", point_queries=True)
    assert pb.point_queries and pb.init(2).target.tolist() == [-1, -1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StaticBackend(gt)
