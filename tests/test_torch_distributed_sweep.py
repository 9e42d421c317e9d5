"""The reference's criterion sweep through the port's sharded stepper: the
11 criteria of ``tests/test_distributed_batch.py``, plus ``oracle`` with
per-lane ``dist_true``, on both exchange schedules, in gloo worlds of 4
and 3 ranks, each against the JAX sharded stepper's fields on a mesh of as
many devices and against JAX ``run_phased_static`` per source, bit for
bit. The setup (the worlds, the JAX subprocesses, the programs) is
``test_torch_distributed.py``'s.
"""
import numpy as np
import pytest

from test_torch_distributed import (
    SCHEDULES,
    assert_matches_solo,
    assert_state_equal,
    port_graph,
    start_jax,
    start_world,
)

CRITERIA = ("dijk", "instatic", "outstatic", "insimple", "outsimple", "in",
            "out", "outweak", "instatic|outstatic", "insimple|outsimple",
            "in|out", "oracle")
GRAPH = {"n": 90, "p": 8 / 90, "seed": 6}
SOURCES = [2, 0, 61, 89]
WORLDS = (4, 3)


def _dist_true():
    from repro_torch.core.oracle import dijkstra_numpy

    g = port_graph(GRAPH)
    return np.stack([dijkstra_numpy(g, s).astype(np.float32)
                     for s in SOURCES])


def _runs(P: int, dist_true):
    runs = []
    for crit in CRITERIA:
        for sched in SCHEDULES:
            run = {"key": f"{crit}:{sched}:", "P": P, "schedule": sched,
                   "graph": GRAPH, "criterion": crit, "sources": SOURCES,
                   "trace_len": 8,
                   "program": [("step", GRAPH["n"] + 1, False),
                               ("snap", "end")]}
            if crit == "oracle":
                run["dist_true"] = dist_true
            runs.append(run)
    return runs


def _solo(dist_true):
    return [{"key": f"{crit}:{s}:", "graph": GRAPH, "source": s,
             "criterion": crit,
             "dist_true": dist_true[i] if crit == "oracle" else None}
            for crit in CRITERIA for i, s in enumerate(SOURCES)]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    dt = _dist_true()
    jax_wait = {P: start_jax(tmp, f"sweep{P}", _runs(P, dt)) for P in WORLDS}
    jax_wait["solo"] = start_jax(tmp, "solo", [], _solo(dt))
    port_wait = {P: start_world(tmp, f"sweep{P}", P, "runs", runs=_runs(P, dt))
                 for P in WORLDS}
    port = {P: w() for P, w in port_wait.items()}
    jax_out = {P: w() for P, w in jax_wait.items()}
    return jax_out, port


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_sweep_matches_jax_stepper_and_run_phased_static(sweep, P, sched,
                                                         crit):
    jx, port = sweep[0][P], sweep[1][P]
    assert_state_equal(port, jx, f"{crit}:{sched}:end:")
    assert_matches_solo(port, sweep[0]["solo"], f"{crit}:{sched}:",
                        [f"{crit}:{s}:" for s in SOURCES])
    assert int(port[f"{crit}:{sched}:end:trips"]) > 0
