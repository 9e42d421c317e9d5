"""``ShardedBackend`` under ``ContinuousBatcher``, and the
``sssp_run`` launcher, in gloo worlds of CPU ranks.

(g) The batcher runs on rank 0 over a ``ShardedBackend``; ranks 1 and up
sit in ``follow()`` and return when rank 0 closes the backend. Its
completions (order, lanes, flags, phases, rows bit for bit) must equal the
port's ``StaticBackend`` on the same trace, on both schedules, for the
default plan and ``in|out``, in worlds of 2 and 3 ranks. Both batchers
read one injected clock each, a counter, so their timestamps compare too.
The backend's refusals (oracle plans, s->t targets) and its leader /
follower roles are held in a world of one. (h) ``python -m
repro_torch.launch.sssp_run --verify`` in a world of 2.

The worlds are ``test_torch_distributed.py``'s (``torch.multiprocessing``
ranks, a ``file://`` store in ``tmp_path``, one thread a rank, joins with
a timeout). This module imports no JAX: the spawned ranks import it.
"""
import contextlib
import io
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_distributed as TD

torch.set_num_threads(1)

GRAPH = {"n": 120, "p": 8 / 120, "seed": 3}
TRACE = [3, 91, 3, 0, 119, 91, 7, 64, 0, 33, 3, 101]
PLANS = ("instatic|outstatic", "in|out")
REQ_FIELDS = ("req_id", "source", "lane", "outcome", "phases", "cache_hit",
              "coalesced", "t_arrival", "t_admitted", "t_completed")


class Tick:
    """A clock that advances by one on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _serve(g, backend):
    from repro_torch.serving import ContinuousBatcher, DistCache

    server = ContinuousBatcher(g, lanes=4, phases_per_step=6,
                               cache=DistCache(capacity=16), backend=backend,
                               clock=Tick())
    for s in TRACE:
        server.submit(s)
    done = sorted(server.drain(max_steps=2000), key=lambda r: r.req_id)
    rows = np.stack([r.dist for r in done])
    meta = np.array([[_num(getattr(r, f)) for f in REQ_FIELDS]
                     for r in done])
    return rows, meta


def _num(v) -> float:
    """A request field as a number: None -1, an outcome 1 where "ok"."""
    if v is None:
        return -1.0
    return float(v == "ok") if isinstance(v, str) else float(v)


def scen_serving(rank, world, spec):
    """Every rank builds the backend; rank 0 serves the trace through it
    (and through a StaticBackend), the others follow."""
    from repro_torch.serving import ShardedBackend, StaticBackend

    g = TD.port_graph(spec["graph"])
    out = {}
    for crit in PLANS:
        for sched in TD.SCHEDULES:
            key = f"{crit}:{sched}:"
            backend = ShardedBackend(g, schedule=sched, criterion=crit,
                                     device="cpu")
            if rank == 0:
                out[key + "rows"], out[key + "meta"] = _serve(g, backend)
                backend.close()
                (out[key + "static_rows"],
                 out[key + "static_meta"]) = _serve(
                    g, StaticBackend(g, criterion=crit, device="cpu"))
            followed = torch.tensor(backend.follow() if rank else 0)
            replayed = [torch.zeros_like(followed) for _ in range(world)]
            dist.all_gather(replayed, followed)
            out[key + "followed"] = torch.stack(replayed).numpy()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    waits = {P: TD.start_world(tmp, f"serving{P}", P, scen_serving,
                                graph=GRAPH)
             for P in (2, 3)}
    return {P: w() for P, w in waits.items()}


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("sched", TD.SCHEDULES)
@pytest.mark.parametrize("crit", PLANS)
def test_sharded_backend_serves_like_static_backend(served, P, sched, crit):
    out = served[P]
    key = f"{crit}:{sched}:"
    assert out[key + "rows"].shape == (len(TRACE), GRAPH["n"])
    TD.assert_same(out[key + "rows"], out[key + "static_rows"], key + "rows")
    assert np.array_equal(out[key + "meta"], out[key + "static_meta"]), key
    # some requests hit the cache or coalesced, the rest ran on the engine
    meta = out[key + "meta"]
    short = (meta[:, REQ_FIELDS.index("cache_hit")]
             + meta[:, REQ_FIELDS.index("coalesced")])
    assert 0 < (short > 0).sum() < len(TRACE)


@pytest.mark.parametrize("P", [2, 3])
def test_followers_replay_every_command_and_exit_on_close(served, P):
    for crit in PLANS:
        for sched in TD.SCHEDULES:
            followed = served[P][f"{crit}:{sched}:followed"]
            assert followed[0] == 0 and (followed[1:] > 0).all()
            assert len(set(followed[1:].tolist())) == 1  # one replay each


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_sharded_backend_refusals_and_roles(world1):
    from repro_torch.serving import ShardedBackend

    g = TD.port_graph(GRAPH)
    with pytest.raises(ValueError, match="oracle"):
        ShardedBackend(g, criterion="oracle", device="cpu")
    with pytest.raises(ValueError, match="unknown criterion"):
        ShardedBackend(g, criterion="delta", device="cpu")
    with pytest.raises(ValueError, match="unknown exchange schedule"):
        ShardedBackend(g, schedule="ring", device="cpu")
    backend = ShardedBackend(g, device="cpu")
    assert backend.sg.ell_t is None  # the default plan ships no transpose
    assert ShardedBackend(g, criterion="in|out",
                          device="cpu").sg.ell_t is not None
    state = backend.init(3)
    with pytest.raises(ValueError, match="s->t"):
        backend.reset_lanes(state, np.array([1, -2, -2]),
                            targets=np.array([5, -1, -1]))
    with pytest.raises(ValueError, match="sources must be"):
        backend.reset_lanes(state, np.array([1, GRAPH["n"], -2]))
    with pytest.raises(RuntimeError, match="does not follow"):
        backend.follow()
    state = backend.reset_lanes(state, np.array([1, -2, 7]))
    while backend.peek(state)[1].any():
        state = backend.step(state, 4)
    trips, live, phases = backend.peek(state)
    assert trips > 0 and not live.any() and phases[1] == 0
    row = backend.take_row(state, 2)
    assert row.shape == (GRAPH["n"],) and row[7] == 0.0
    backend.close()


def _sssp_rank(rank: int, store: str, out: str):
    from repro_torch.launch import sssp_run

    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sssp_run.main(["--n", "400", "--deg", "6", "--backend", "gloo",
                            "--device", "cpu", "--rank", str(rank),
                            "--world-size", "2", "--init-method", store,
                            "--verify"])
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump((rc, buf.getvalue()), f)


def test_sssp_run_verifies_in_a_world_of_two(tmp_path):
    out = tmp_path / "sssp"
    ctx = mp.spawn(_sssp_rank, args=(f"file://{tmp_path}/store", str(out)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + TD.JOIN_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("sssp_run outlived its limit")
    results = []
    for rank in (0, 1):
        with open(f"{out}.{rank}", "rb") as f:
            results.append(pickle.load(f))
    assert [rc for rc, _ in results] == [0, 0]
    text = results[0][1]
    assert "verified against sequential Dijkstra: True" in text
    assert "world 2 (gloo)" in text and "phases in" in text
    assert results[1][1] == ""  # only rank 0 prints
