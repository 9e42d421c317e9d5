"""The port's sharded stepper (``repro_torch.core.distributed``) against the
JAX package's sharded stepper and its single-device engine, bit for bit.

Setup:

  * the port's worlds are gloo process groups of ``torch.multiprocessing``
    ranks over a ``file://`` store in ``tmp_path`` (no TCP port to collide
    under xdist); each rank runs ``torch.set_num_threads(1)`` and every
    join has a timeout. Rank 0 writes what the test compares (the blocks
    gathered to ``(B, n_pad)``) to an npz;
  * the JAX side runs in a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before jax
    is imported, on a mesh of P of those devices. It writes ``np.asarray``
    of each state field to an npz and never calls ``harvest_sharded``
    (slicing a sharded array raises there), nor the legacy program's
    output slice;
  * both sides build one graph from one seed (the two packages'
    generators draw the same COO) and run one program of steps, drains,
    resets and snapshots.

Checked here: (a) P = 4 and P = 3 (n not a multiple of P * 8: padding
columns), both schedules, a B = 4 batch with a ``trace_len = 8`` ring,
against the JAX stepper's fields (``dist``, ``status``, ``phases``, the
combined ``sum_fringe`` / ``relax_edges``, ``trips``, the ring) and JAX
``run_phased_static`` per source, on the kernel path and the plain one;
(c) chunked stepping with ``stop_on_lane_finish`` and
``reset_sharded_lanes`` under ``in|out``, and a JAX state carried in
mid-solve that continues to the same bits; (d) weights on {+0, -0, 0.5,
1}, sign bits compared; (e) the legacy program against the B = 1 stepper
and JAX ``run_phased_static``; (f) every ``ValueError`` the reference
raises; the partition against the reference's rows, and the rectangular
push's twin against the COO segment-min. The criterion sweep (b) is
``test_torch_distributed_sweep.py``; serving and the launcher are
``test_torch_sharded_serving.py``.

This module imports no JAX at the top: the spawned ranks import it.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIGNED = (0.0, -0.0, 0.5, 1.0)
JOIN_S = 600.0  # a world's wall-clock limit
SCHEDULES = ("allreduce", "reduce_scatter")
FIELDS = ("dist", "status", "phases", "sum_fringe", "relax_edges", "trips",
          "settled_trace")
# A run's program: ops run alike on both sides.
#   ("step", k, stop)   one step_sharded_batch call
#   ("drain", k, stop)  steps of k while some lane is live
#   ("reset", sources)  reset_sharded_lanes
#   ("snap", name)      record every state field under name
#   ("load", name)      (port only) continue from the JAX state ``name``


# ---------------------------------------------------------------------------
# graphs, shared by both sides
# ---------------------------------------------------------------------------


def signed_weights(w: np.ndarray) -> np.ndarray:
    """Weights mapped onto {+0, -0, 0.5, 1} by value (+inf stays)."""
    q = (np.clip(w, 0.0, 0.999) * 4).astype(np.int64)
    return np.where(np.isfinite(w), np.array(SIGNED, np.float32)[q],
                    w).astype(np.float32)


def port_graph(spec: dict):
    """The port's CPU graph of a spec ``{n, p, seed, signed}``."""
    from repro_torch.core.graph import from_coo
    from repro_torch.graphs import uniform_gnp

    g = uniform_gnp(spec["n"], spec["p"], seed=spec["seed"], device="cpu")
    if not spec.get("signed"):
        return g
    return from_coo(g.src.numpy(), g.dst.numpy(),
                    signed_weights(g.w.numpy()), g.n, device="cpu")


JAX_SCRIPT = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import distributed as D
from repro.core.graph import from_coo
from repro.core.static_engine import run_phased_static
from repro.graphs import uniform_gnp

SIGNED = np.array((0.0, -0.0, 0.5, 1.0), np.float32)
job = pickle.load(open(sys.argv[1], "rb"))
out = {}
graphs = {}


def graph(spec):
    key = repr(sorted(spec.items()))
    if key not in graphs:
        g = uniform_gnp(spec["n"], spec["p"], seed=spec["seed"])
        if spec.get("signed"):
            w = np.asarray(g.w)
            q = (np.clip(w, 0.0, 0.999) * 4).astype(np.int64)
            w = np.where(np.isfinite(w), SIGNED[q], w).astype(np.float32)
            g = from_coo(np.asarray(g.src), np.asarray(g.dst), w, g.n)
        graphs[key] = g
    return graphs[key]


RAW = ("dist", "status", "trips", "phases", "sum_fringe", "sum_fringe_hi",
       "relax_edges", "relax_edges_hi", "settled_trace")


def snap(st, pre):
    for f in RAW:
        out[pre + f] = np.asarray(getattr(st, f))
    if st.dist_true is not None:
        out[pre + "dist_true"] = np.asarray(st.dist_true)
    out[pre + "n"] = np.asarray(st.n)
    out[pre + "criterion"] = np.asarray(st.criterion)


for run in job["runs"]:
    key, P = run["key"], run["P"]
    mesh = Mesh(np.array(jax.devices()[:P]), ("x",))
    g = graph(run["graph"])
    sg = D.shard_graph_batch(g, P, with_transpose=run.get("transpose", True))
    if run.get("partition"):
        for f in ("src_local", "dst", "w", "tsrc_local", "tdst", "tw",
                  "in_min", "out_min", "out_deg"):
            out[key + "sg_" + f] = np.asarray(getattr(sg, f))
        for f in ("n", "n_pad", "n_loc", "num_shards"):
            out[key + "sg_" + f] = np.asarray(getattr(sg, f))
    st = D.init_sharded_batch_state(
        sg, np.asarray(run["sources"], np.int32), criterion=run["criterion"],
        dist_true=run.get("dist_true"), trace_len=run.get("trace_len", 1))
    for op in run["program"]:
        if op[0] == "step":
            st = D.step_sharded_batch(sg, st, mesh, ("x",), op[1],
                                      schedule=run["schedule"],
                                      stop_on_lane_finish=op[2])
        elif op[0] == "drain":
            while D.sharded_lanes_active(st).any():
                st = D.step_sharded_batch(sg, st, mesh, ("x",), op[1],
                                          schedule=run["schedule"],
                                          stop_on_lane_finish=op[2])
        elif op[0] == "reset":
            st = D.reset_sharded_lanes(st, np.asarray(op[1], np.int32))
        elif op[0] == "snap":
            snap(st, key + op[1] + ":")
for solo in job.get("solo", ()):
    g = graph(solo["graph"])
    dt = solo.get("dist_true")
    r = run_phased_static(g, solo["source"], criterion=solo["criterion"],
                          dist_true=dt)
    for f in ("dist", "phases", "sum_fringe", "relax_edges"):
        out[solo["key"] + f] = np.asarray(getattr(r, f))
np.savez(job["out"] + ".tmp.npz", **out)
os.replace(job["out"] + ".tmp.npz", job["out"])
print("JAX-DONE")
'''


def start_jax(tmp_path: Path, name: str, runs: list, solo=()):
    """Start the JAX side of ``runs`` / ``solo`` in a subprocess; returns a
    function that waits for it and loads its npz."""
    job = tmp_path / f"jax-{name}.pkl"
    out = tmp_path / f"jax-{name}.npz"
    with open(job, "wb") as f:
        pickle.dump({"runs": runs, "solo": list(solo), "out": str(out)}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(job)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        try:
            text, _ = proc.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0 and "JAX-DONE" in text, text
        return dict(np.load(out))

    return wait


# ---------------------------------------------------------------------------
# the port's worlds
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, store: str, job: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        with open(job, "rb") as f:
            spec = pickle.load(f)
        scenario = spec["scenario"]  # a name here, or a function elsewhere
        if isinstance(scenario, str):
            scenario = SCENARIOS[scenario]
        out = scenario(rank, world, spec)
        if rank == 0:
            np.savez(spec["out"], **out)
    finally:
        dist.destroy_process_group()


def start_world(tmp_path: Path, name: str, nprocs: int, scenario,
                **spec):
    """Start ``scenario`` (a :data:`SCENARIOS` name, or a module-level
    function ``f(rank, world, spec) -> dict`` of an importable module) in
    a gloo world of ``nprocs`` ranks; returns a
    function that joins it and loads rank 0's npz as a dict. A rank's
    exception fails the join; so does a world that outlives
    :data:`JOIN_S`."""
    job = tmp_path / f"port-{name}.pkl"
    out = tmp_path / f"port-{name}.npz"
    with open(job, "wb") as f:
        pickle.dump(dict(spec, scenario=scenario, out=str(out)), f)
    ctx = mp.spawn(_rank_main, args=(nprocs, f"file://{tmp_path}/store-"
                                     f"{name}", str(job)),
                   nprocs=nprocs, join=False)
    deadline = time.monotonic() + JOIN_S

    def wait():
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"world {name} outlived {JOIN_S} s")
        return dict(np.load(out))

    return wait


def jax_fields(path: str, prefix: str) -> dict:
    """The JAX state ``prefix`` of the npz at ``path``, waiting (within
    :data:`JOIN_S`) for the JAX side to write it."""
    deadline = time.monotonic() + JOIN_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX result at {path}")
        time.sleep(0.2)
    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


def _fields(state, comm, pre: str, out: dict):
    """Every compared field of a state, the blocks gathered."""
    out[pre + "dist"] = comm.gather(state.dist).numpy()
    out[pre + "status"] = comm.gather(state.status).numpy()
    for f in ("phases", "sum_fringe", "relax_edges", "trips",
              "settled_trace"):
        out[pre + f] = getattr(state, f).numpy()


def scen_runs(rank, world, spec):
    """The port's side of JAX-style ``runs`` (and their harvests)."""
    from repro_torch import interop
    from repro_torch.core import distributed as D

    out = {}
    comm = D.Comm(None, torch.device("cpu"))
    graphs = {}
    for run in spec["runs"]:
        key = run["key"]
        gkey = repr(sorted(run["graph"].items()))
        if gkey not in graphs:
            graphs[gkey] = port_graph(run["graph"])
        g = graphs[gkey]
        sg = D.shard_graph_batch(g, world,
                                 with_transpose=run.get("transpose", True))
        st = D.init_sharded_batch_state(
            sg, run["sources"], criterion=run["criterion"],
            dist_true=run.get("dist_true"),
            trace_len=run.get("trace_len", 1))
        kw = dict(schedule=run["schedule"],
                  use_kernels=run.get("use_kernels", True))
        for op in run["program"]:
            if op[0] == "step":
                st = D.step_sharded_batch(sg, st, None, op[1],
                                          stop_on_lane_finish=op[2], **kw)
            elif op[0] == "drain":
                while D.sharded_lanes_active(st).any():
                    st = D.step_sharded_batch(sg, st, None, op[1],
                                              stop_on_lane_finish=op[2], **kw)
            elif op[0] == "reset":
                st = D.reset_sharded_lanes(st, op[1])
            elif op[0] == "snap":
                _fields(st, comm, key + op[1] + ":", out)
            elif op[0] == "load":
                st = interop.sharded_state_from_numpy(
                    jax_fields(spec["jax_npz"], op[1]), rank, world,
                    device="cpu")
        res = D.harvest_sharded(st)
        out[key + "h:dist"] = res.dist.numpy()
        out[key + "h:status"] = res.status.numpy()
        out[key + "h:phases"] = res.phases.numpy()
        out[key + "h:sum_fringe"] = res.sum_fringe
        out[key + "h:relax_edges"] = res.relax_edges
        out[key + "h:trace"] = (np.zeros(0) if res.settled_per_phase is None
                                else res.settled_per_phase.numpy())
    return out


def scen_legacy(rank, world, spec):
    """The legacy program and the B = 1 stepper (run_distributed)."""
    from repro_torch.core import distributed as D

    g = port_graph(spec["graph"])
    out = {}
    for sched in SCHEDULES:
        for uk in (True, False):
            run = D.make_distributed_sssp(None, schedule=sched,
                                          use_kernels=uk)
            for s in spec["sources"]:
                d, ph = run(D.shard_graph(g, world, source=s), g.n + 1)
                out[f"{sched}:{uk}:{s}:legacy"] = d.numpy()
                out[f"{sched}:{uk}:{s}:legacy_phases"] = ph.numpy()
                d1, ph1 = D.run_distributed(g, None, s, schedule=sched,
                                            device="cpu", use_kernels=uk)
                out[f"{sched}:{uk}:{s}:b1"] = d1.numpy()
                out[f"{sched}:{uk}:{s}:b1_phases"] = ph1.numpy()
    return out


def scen_partition(rank, world, spec):
    """Each rank's partition and views, gathered to rank 0."""
    from repro_torch.core import distributed as D

    g = port_graph(spec["graph"])
    sg = D.shard_graph_batch(g, world)
    out = {"n_loc": np.asarray(sg.n_loc), "n_pad": np.asarray(sg.n_pad)}
    for f in ("src_local", "dst", "w", "tsrc_local", "tdst", "tw", "in_min",
              "out_min", "out_deg"):
        parts = [torch.empty_like(getattr(sg, f)) for _ in range(world)]
        dist.all_gather(parts, getattr(sg, f))
        out[f] = torch.stack(parts).numpy()
    # the out-view holds the COO row's real edges, ids global, sentinel n_pad
    for side, (cols, ws), (rows, ids, w) in (
            ("fwd", sg.ell_out, (sg.src_local, sg.dst, sg.w)),
            ("rev", sg.ell_t, (sg.tsrc_local, sg.tdst, sg.tw))):
        real = torch.isfinite(w)
        want = sorted(zip(rows[real].tolist(), ids[real].tolist(),
                          w[real].tolist()))
        live = cols != sg.n_pad
        got = sorted(zip(torch.nonzero(live)[:, 0].tolist(),
                         cols[live].tolist(), ws[live].tolist()))
        ok = torch.tensor(int(got == want and bool(
            torch.isinf(ws[~live]).all())))
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        out[f"{side}_view_ok"] = ok.numpy()
    return out


def scen_runs_and_partition(rank, world, spec):
    out = scen_runs(rank, world, spec)
    out.update({"partition:" + k: v
                for k, v in scen_partition(rank, world, spec).items()})
    return out


SCENARIOS = {"runs": scen_runs, "legacy": scen_legacy,
             "runs+partition": scen_runs_and_partition}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def bits(x) -> np.ndarray:
    x = np.ascontiguousarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(bits(a), bits(b)), what


def combined(jx: dict, pre: str, name: str) -> np.ndarray:
    lo = jx[pre + name].astype(np.int64)
    hi = jx[pre + name + "_hi"].astype(np.int64)
    return (hi << np.int64(32)) + lo


def assert_state_equal(port: dict, jx: dict, pre: str):
    """The port's gathered fields against the JAX stepper's raw ones."""
    for f in ("dist", "status", "phases", "trips", "settled_trace"):
        assert_same(port[pre + f], jx[pre + f], pre + f)
    for f in ("sum_fringe", "relax_edges"):
        assert_same(port[pre + f], combined(jx, pre, f), pre + f)


def assert_matches_solo(port: dict, jx: dict, key: str, solo_keys: list):
    """Harvested rows against JAX run_phased_static, one source a row."""
    for i, sk in enumerate(solo_keys):
        assert_same(port[key + "h:dist"][i], jx[sk + "dist"], sk + "dist")
        for f in ("phases", "sum_fringe", "relax_edges"):
            assert int(port[key + "h:" + f][i]) == int(jx[sk + f]), (sk, f)


# ---------------------------------------------------------------------------
# (a), (c), (d): the batch stepper against the JAX stepper
# ---------------------------------------------------------------------------

GRAPH = {"n": 150, "p": 8 / 150, "seed": 5}
GRAPH_SIGNED = {"n": 120, "p": 10 / 120, "seed": 7, "signed": True}
SOURCES = [3, 0, 91, 149]
SOURCES_SIGNED = [4, 0, 77, 119]
WORLDS = (4, 3)


def _batch_runs(P: int):
    runs = []
    for sched in SCHEDULES:
        runs.append({"key": f"a:{sched}:", "P": P, "schedule": sched,
                     "graph": GRAPH, "criterion": "instatic|outstatic",
                     "sources": SOURCES, "trace_len": 8,
                     "program": [("step", GRAPH["n"] + 1, False),
                                 ("snap", "end")], "transpose": False})
        runs.append(dict(runs[-1], key=f"plain:{sched}:", use_kernels=False))
        runs.append({"key": f"d:{sched}:", "P": P, "schedule": sched,
                     "graph": GRAPH_SIGNED, "criterion": "in|out",
                     "sources": SOURCES_SIGNED, "trace_len": 8,
                     "program": [("step", GRAPH_SIGNED["n"] + 1, False),
                                 ("snap", "end")]})
    # (c): chunks that stop on a lane's finish, then a reset, under in|out
    runs.append({"key": "c:", "P": P, "schedule": "reduce_scatter",
                 "graph": GRAPH, "criterion": "in|out", "sources": SOURCES,
                 "trace_len": 8,
                 "program": [("drain", 3, True), ("snap", "chunked"),
                             ("reset", [42, -2, -1, 5]), ("drain", 7, False),
                             ("snap", "end")]})
    # (c): the JAX stepper's state after 4 trips, carried into the port
    runs.append({"key": "m:", "P": P, "schedule": "allreduce",
                 "graph": GRAPH, "criterion": "in|out", "sources": SOURCES,
                 "trace_len": 8,
                 "program": [("step", 4, False), ("snap", "mid"),
                             ("step", GRAPH["n"] + 1, False),
                             ("snap", "end")]})
    runs.append({"key": "partition:", "P": P, "schedule": "allreduce",
                 "graph": GRAPH, "criterion": "instatic|outstatic",
                 "sources": SOURCES, "program": [], "partition": True})
    return runs


def _solo(graph: dict, sources, criterion: str, tag: str):
    return [{"key": f"{tag}:{s}:", "graph": graph, "source": s,
             "criterion": criterion} for s in sources]


SOLO = (_solo(GRAPH, SOURCES, "instatic|outstatic", "default")
        + _solo(GRAPH_SIGNED, SOURCES_SIGNED, "in|out", "signed")
        + _solo(GRAPH, [3, 42, 5], "instatic|outstatic", "legacy"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides of every run here: the JAX subprocesses and the port's
    worlds all at once (a world's carried-in state waits for its JAX
    side's npz)."""
    tmp = tmp_path_factory.mktemp("sharded")
    jax_wait = {P: start_jax(tmp, f"p{P}", _batch_runs(P),
                             SOLO if P == 4 else ()) for P in WORLDS}
    port_wait = {}
    for P in WORLDS:
        runs = [r for r in _batch_runs(P) if not r.get("partition")]
        runs.append({"key": "carried:", "graph": GRAPH, "criterion": "in|out",
                     "schedule": "reduce_scatter", "sources": SOURCES,
                     "trace_len": 8,
                     "program": [("load", "m:mid:"),
                                 ("step", GRAPH["n"] + 1, False),
                                 ("snap", "end")]})
        port_wait[P] = start_world(tmp, f"runs{P}", P, "runs+partition",
                                   runs=runs, graph=GRAPH,
                                   jax_npz=str(tmp / f"jax-p{P}.npz"))
    port_wait["legacy"] = start_world(tmp, "legacy", 3, "legacy",
                                      graph=GRAPH, sources=[3, 42, 5])
    port = {k: w() for k, w in port_wait.items()}
    for P in WORLDS:
        port[(P, "partition")] = {k[len("partition:"):]: v
                                  for k, v in port[P].items()
                                  if k.startswith("partition:")}
    return {P: w() for P, w in jax_wait.items()}, port


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_batch_matches_jax_stepper_fields(results, P, sched):
    jx, port = results[0][P], results[1][P]
    assert_state_equal(port, jx, f"a:{sched}:end:")
    # padding columns exist and stay +inf / unexplored
    n = GRAPH["n"]
    assert port[f"a:{sched}:end:dist"].shape[1] > n
    assert np.isinf(port[f"a:{sched}:end:dist"][:, n:]).all()


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_batch_matches_jax_run_phased_static(results, P, sched):
    jx4, port = results[0][4], results[1][P]
    assert_matches_solo(port, jx4, f"a:{sched}:",
                        [f"default:{s}:" for s in SOURCES])
    assert port[f"a:{sched}:h:trace"].shape == (len(SOURCES), 8)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_plain_path_matches_jax_stepper_fields(results, P, sched):
    """``use_kernels=False``: the reference's segment-min over the COO row
    and #2's twin, the same bits."""
    jx, port = results[0][P], results[1][P]
    for f in FIELDS:
        assert_same(port[f"plain:{sched}:end:{f}"], port[f"a:{sched}:end:{f}"],
                    f)
    assert_state_equal({k.replace("plain:", "a:", 1): v
                        for k, v in port.items() if k.startswith("plain:")},
                       jx, f"a:{sched}:end:")


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_signed_zero_weights_match_jax(results, P, sched):
    """(d): -0 and +0 weights under in|out (dynamic keys on both sides),
    sign bits compared."""
    jx, port = results[0][P], results[1][P]
    assert_state_equal(port, jx, f"d:{sched}:end:")
    assert_matches_solo(port, results[0][4], f"d:{sched}:",
                        [f"signed:{s}:" for s in SOURCES_SIGNED])


@pytest.mark.parametrize("P", WORLDS)
def test_chunked_stepping_and_resets_match_jax(results, P):
    """(c): stop_on_lane_finish chunks, then a keep / park / refill reset."""
    jx, port = results[0][P], results[1][P]
    assert_state_equal(port, jx, "c:chunked:")
    assert_state_equal(port, jx, "c:end:")
    assert np.isinf(port["c:end:dist"][2]).all()  # the parked lane
    assert_same(port["c:end:dist"][1], port["c:chunked:dist"][1], "kept lane")


@pytest.mark.parametrize("P", WORLDS)
def test_jax_state_carried_mid_solve_continues_to_the_same_bits(results, P):
    jx, port = results[0][P], results[1][P]
    assert int(jx["m:mid:trips"]) == 4 and (jx["m:mid:status"] == 1).any()
    assert_state_equal({k.replace("carried:", "m:", 1): v
                        for k, v in port.items()
                        if k.startswith("carried:")}, jx, "m:end:")
    assert_state_equal(port, jx, "m:end:")


@pytest.mark.parametrize("P", WORLDS)
def test_partition_is_the_reference_rows(results, P):
    jx, part = results[0][P], results[1][(P, "partition")]
    pre = "partition:sg_"
    n_loc = int(jx[pre + "n_loc"])
    assert int(part["n_loc"]) == n_loc and int(part["n_pad"]) == int(
        jx[pre + "n_pad"]) == n_loc * P
    for f in ("src_local", "dst", "w", "tsrc_local", "tdst", "tw"):
        assert_same(part[f], jx[pre + f], f)
    for f in ("in_min", "out_min", "out_deg"):
        assert_same(part[f].reshape(-1), jx[pre + f], f)
    assert int(part["fwd_view_ok"]) == 1 and int(part["rev_view_ok"]) == 1


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("rank", [0, 2])
def test_interop_carries_the_reference_partition(results, P, rank):
    """A rank's block from the JAX ShardedBatchGraph's arrays is the block
    the port's own partition builds, rank-local views included."""
    from repro_torch import interop
    from repro_torch.core import distributed as D

    pre = "partition:sg_"
    fields = {k[len(pre):]: v for k, v in results[0][P].items()
              if k.startswith(pre)}
    got = interop.sharded_graph_from_numpy(fields, rank, device="cpu")
    want = D.shard_graph_batch(port_graph(GRAPH), P, rank=rank)
    for f in ("n", "n_pad", "n_loc", "num_shards", "rank"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("src_local", "dst", "w", "tsrc_local", "tdst", "tw", "in_min",
              "out_min", "out_deg"):
        assert_same(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
    for f in ("ell_out", "ell_t"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            assert_same(a.numpy(), b.numpy(), f)


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_legacy_program_matches_b1_stepper_and_jax(results, sched,
                                                   use_kernels):
    """(e): the legacy single-query program in a world of 3, its (n_pad,)
    row and phases, against the B = 1 stepper and JAX run_phased_static."""
    jx, port = results[0][4], results[1]["legacy"]
    n = GRAPH["n"]
    for s in (3, 42, 5):
        pre = f"{sched}:{use_kernels}:{s}:"
        assert np.isinf(port[pre + "legacy"][n:]).all()
        assert_same(port[pre + "legacy"][:n], port[pre + "b1"], pre)
        assert int(port[pre + "legacy_phases"]) == int(port[pre + "b1_phases"])
        assert_same(port[pre + "b1"], jx[f"legacy:{s}:dist"], pre + "jax")
        assert int(port[pre + "b1_phases"]) == int(jx[f"legacy:{s}:phases"])


# ---------------------------------------------------------------------------
# the rectangular push's twin, and (f) the ValueErrors, in a world of one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of this one process, torn down after the module."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("P,rank", [(3, 0), (3, 2), (4, 1)])
@pytest.mark.parametrize("lanes", [1, 5])
def test_rect_push_twin_is_the_coo_segment_min(P, rank, lanes):
    """The wrapper's twin (the left-packed rows cut at the sentinel) is the
    reference's segment-min over the rank's COO row, NaN, -0 and sparse
    lanes included."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_relax import ell_push_rect_batch

    g = port_graph(GRAPH_SIGNED)
    sg = D.shard_graph_batch(g, P, rank=rank)
    rng = np.random.default_rng(P * 10 + rank + lanes)
    dm = np.array(SIGNED, np.float32)[rng.integers(0, 4, (lanes, sg.n_loc))]
    dm[rng.random(dm.shape) < 0.6] = np.inf
    dm[-1, rng.integers(0, sg.n_loc, 2)] = np.nan
    dm = torch.from_numpy(dm)
    got = ell_push_rect_batch(dm, *sg.ell_out, sg.n_pad)
    real = torch.isfinite(sg.w)  # the COO row's padding edges left out
    want = ref.push_coo_batch_ref(dm, sg.src_local[real], sg.dst[real],
                                  sg.w[real], sg.n_pad)
    canon = torch.tensor(float("nan"))
    assert torch.equal(torch.where(torch.isnan(got), canon, got).view(
        torch.int32), torch.where(torch.isnan(want), canon, want).view(
        torch.int32))
    assert got.shape == (lanes, sg.n_pad)
    # the segment-min itself, on the unmasked candidates, as the reference
    # writes it (cand = where(live, d[src] + w, inf))
    src = sg.src_local[real].long()
    cand = torch.where(dm[:, src] != float("inf"), dm[:, src] + sg.w[real],
                       float("inf"))
    for b in range(lanes):
        row = ref.segment_min(cand[b], sg.dst[real], sg.n_pad)
        assert torch.equal(torch.where(torch.isnan(row), canon, row).view(
            torch.int32), torch.where(torch.isnan(want[b]), canon,
                                      want[b]).view(torch.int32))


def test_ordered_image_orders_floats_and_zeros():
    from repro_torch.core.distributed import _from_ordered, _ordered

    x = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf],
                     dtype=torch.float32)
    img = _ordered(x)
    assert (img[1:] > img[:-1]).all()  # strictly increasing, -0 < +0
    assert torch.equal(_from_ordered(img).view(torch.int32),
                       x.view(torch.int32))


def _jax_world1():
    """The reference's objects on a one-device mesh of this process."""
    import jax
    from jax.sharding import Mesh

    from repro.core import distributed as JD
    from repro.graphs import uniform_gnp as j_gnp

    return JD, j_gnp, Mesh(np.array(jax.devices()[:1]), ("x",))


def _raises_both(port_call, ref_call, same_message: bool = True,
                 match: str | None = None):
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        ref_call()
    if same_message:
        assert str(got.value) == str(want.value)
    if match is not None:
        assert match in str(got.value) and match in str(want.value)


def _setup1(transpose=True, P=1):
    from repro_torch.core import distributed as D

    JD, j_gnp, mesh = _jax_world1()
    g_t = port_graph(GRAPH)
    g_j = j_gnp(GRAPH["n"], GRAPH["p"], seed=GRAPH["seed"])
    sg_t = D.shard_graph_batch(g_t, P, with_transpose=transpose, rank=0)
    sg_j = JD.shard_graph_batch(g_j, P, with_transpose=transpose)
    return D, JD, mesh, g_t, g_j, sg_t, sg_j


BAD_SOURCES = [
    ("negative", [-3]),
    ("padding_id", [151]),
    ("n", [150]),
    ("float", np.array([1.0])),
    ("two_d", np.zeros((2, 2), np.int32)),
    ("empty", np.zeros(0, np.int32)),
    ("int64_wrap", np.array([2 ** 32 + 3], np.int64)),
]


@pytest.mark.parametrize("label,sources", BAD_SOURCES, ids=[b[0] for b in
                                                            BAD_SOURCES])
def test_init_rejects_bad_sources_like_reference(world1, label, sources):
    D, JD, _, _, _, sg_t, sg_j = _setup1()
    _raises_both(lambda: D.init_sharded_batch_state(sg_t, sources),
                 lambda: JD.init_sharded_batch_state(sg_j, sources))


@pytest.mark.parametrize("case", ["trace_len", "oracle_missing",
                                  "oracle_shape", "criterion"])
def test_init_rejects_bad_options_like_reference(world1, case):
    D, JD, _, _, _, sg_t, sg_j = _setup1()
    kw = {"trace_len": {"trace_len": 0},
          "oracle_missing": {"criterion": "oracle"},
          "oracle_shape": {"criterion": "dijk|oracle",
                           "dist_true": np.zeros((1, 7), np.float32)},
          "criterion": {"criterion": "instatic|bogus"}}[case]
    _raises_both(lambda: D.init_sharded_batch_state(sg_t, [0], **kw),
                 lambda: JD.init_sharded_batch_state(sg_j, [0], **kw))


@pytest.mark.parametrize("case", ["source_negative", "source_n"])
def test_legacy_and_b1_front_ends_reject_bad_sources(world1, case):
    from repro_torch.core import distributed as D

    JD, j_gnp, mesh = _jax_world1()
    g_t = port_graph(GRAPH)
    g_j = j_gnp(GRAPH["n"], GRAPH["p"], seed=GRAPH["seed"])
    s = -1 if case == "source_negative" else GRAPH["n"]
    _raises_both(lambda: D.shard_graph(g_t, 1, source=s),
                 lambda: JD.shard_graph(g_j, 1, source=s))
    _raises_both(lambda: D.run_distributed(g_t, None, s, device="cpu"),
                 lambda: JD.run_distributed(g_j, mesh, "x", s))


@pytest.mark.parametrize("case", ["shard_count", "no_transpose", "schedule"])
def test_step_rejects_like_reference(world1, case):
    D, JD, mesh, g_t, g_j, sg_t, sg_j = _setup1(
        transpose=case != "no_transpose", P=2 if case == "shard_count" else 1)
    crit = "in|out"
    st_t = D.init_sharded_batch_state(sg_t, [0], criterion=crit)
    st_j = JD.init_sharded_batch_state(sg_j, [0], criterion=crit)
    sched = "ring" if case == "schedule" else "reduce_scatter"
    match = {"shard_count": "sharded for 2", "no_transpose": "with_transpose",
             "schedule": "unknown exchange schedule"}[case]
    _raises_both(lambda: D.step_sharded_batch(sg_t, st_t, None, 1,
                                              schedule=sched),
                 lambda: JD.step_sharded_batch(sg_j, st_j, mesh, "x", 1,
                                               schedule=sched),
                 same_message=case != "shard_count", match=match)


@pytest.mark.parametrize("case", ["shape", "id", "oracle_refill",
                                  "oracle_shape", "not_oracle"])
def test_reset_rejects_like_reference(world1, case):
    D, JD, _, _, _, sg_t, sg_j = _setup1()
    oracle = case.startswith("oracle")
    crit = "oracle" if oracle else "instatic|outstatic"
    dt = np.zeros((2, GRAPH["n"]), np.float32) if oracle else None
    st_t = D.init_sharded_batch_state(sg_t, [0, 1], criterion=crit,
                                      dist_true=dt)
    st_j = JD.init_sharded_batch_state(sg_j, [0, 1], criterion=crit,
                                       dist_true=dt)
    src, kw = {"shape": ([0, 1, 2], {}), "id": ([0, 150], {}),
               "oracle_refill": ([3, -2], {}),
               "oracle_shape": ([3, -2],
                                {"dist_true": np.zeros((2, 5), np.float32)}),
               "not_oracle": ([-1, -2],
                              {"dist_true": np.zeros((2, 150),
                                                     np.float32)})}[case]
    _raises_both(lambda: D.reset_sharded_lanes(st_t, src, **kw),
                 lambda: JD.reset_sharded_lanes(st_j, src, **kw))


def test_world_of_one_solves_like_the_static_engine(world1):
    """One rank holds every vertex: the stepper is the single-device
    engine, bit for bit, on both schedules (and a reset lane with an
    oracle row)."""
    from repro_torch.core import distributed as D
    from repro_torch.core.oracle import dijkstra_numpy
    from repro_torch.core.static_engine import run_phased_static_batch

    g = port_graph(GRAPH)
    for crit in ("instatic|outstatic", "insimple|outsimple"):
        want = run_phased_static_batch(g, SOURCES, criterion=crit,
                                       device="cpu")
        for sched in SCHEDULES:
            got = D.run_sharded_batch(g, None, SOURCES, schedule=sched,
                                      criterion=crit, device="cpu")
            assert_same(got.dist.numpy(), want.dist.numpy(), crit)
            assert_same(got.status.numpy(), want.status.numpy(), crit)
            assert_same(got.phases.numpy(), want.phases.numpy(), crit)
            assert_same(got.sum_fringe, want.sum_fringe, crit)
            assert int(got.total_phases) == int(want.total_phases)
    dt = np.stack([dijkstra_numpy(g, s).astype(np.float32) for s in SOURCES])
    want = run_phased_static_batch(g, SOURCES, criterion="oracle",
                                   dist_true=dt, device="cpu")
    got = D.run_sharded_batch(g, None, SOURCES, criterion="oracle",
                              dist_true=dt, device="cpu")
    assert_same(got.dist.numpy(), want.dist.numpy(), "oracle")
    assert_same(got.phases.numpy(), want.phases.numpy(), "oracle")


def test_init_group_refuses_bad_pairings():
    """No backend switch: NCCL on the CPU raises, as do an unknown backend
    and a rank outside the world, before any group is joined."""
    from repro_torch.launch.mesh import init_group

    with pytest.raises(ValueError, match="NCCL"):
        init_group(0, 1, backend="nccl", device="cpu",
                   init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="backend must be"):
        init_group(0, 1, backend="mpi", device="cpu",
                   init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="rank must be"):
        init_group(2, 2, device="cpu", init_method="file:///nonexistent")
