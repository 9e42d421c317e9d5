"""The harness of the LM mesh tests (``test_torch_lm_mesh_*.py``), and the
port's collectives' gradient rules on their own.

A module's checks run twice at once: the port in one gloo world of ranks
spawned with ``torch.multiprocessing`` (a ``file://`` store, one thread a
rank, ``device="cpu"``), the reference in one subprocess on a forced
4-device CPU platform, each task on its own ``(data, model)`` mesh of Auto
axes under ``jax.set_mesh`` (jax's default Explicit axes make the
reference's ``with_sharding_constraint`` raise). The reference writes each
task's weights first; the ranks read them from there, so both packages
compute on the same weights. This module imports no JAX: the ranks import
it.
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

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 240  # a world or a JAX subprocess outliving this fails its test

JAX_SCRIPT = r'''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import models as J
from repro.configs import get_smoke
from repro.models import layers as JL
from repro.models.layers import ShardingCtx
from repro.optim import adamw as JA

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)


def init_params(cfg, key, dtype=jnp.float32):
    """The reference's ``init_params`` under ``jax.jit`` (its eager form
    runs each op on its own, seconds a config); every weight of these
    tasks comes from here, ``train``'s own included."""
    return jax.jit(lambda k: J.init_params(cfg, k, dtype))(key)


import repro.runtime.train_loop as _loop  # noqa: E402
_loop.init_params = init_params


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def save(path, arrays):
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


out = {}
weights = {}
for task in job["tasks"]:
    cfg = get_smoke(task["arch"])
    if task["arch"] not in weights:
        weights[task["arch"]] = init_params(cfg, jax.random.PRNGKey(0))
        save(os.path.join(job["dir"], f"w-{task['arch']}.npz"),
             flat(np_tree(weights[task["arch"]])))
for task in job["tasks"]:
    cfg = dataclasses.replace(get_smoke(task["arch"]), **task.get("cfg", {}))
    dp, tp = task["mesh"]
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:dp * tp])
    key = task["key"]
    params = weights[task["arch"]]
    with jax.set_mesh(mesh):
        shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
        if task["kind"] == "moe":
            p = params["units"][task["layer"]]["moe"]
            p = jax.tree.map(lambda x: x[task["unit"]], p)
            x, r = task["x"], task["r"]

            def f(p, x):
                y = JL.apply_moe(cfg, p, x, shd)
                return jnp.sum(y * r), y
            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
            out[key + "y"] = np.asarray(y)
            out[key + "gx"] = np.asarray(gx)
            for nm, g in gp.items():
                out[key + "g/" + nm] = np.asarray(g)
        elif task["kind"] == "loss":
            batch = task["batch"]
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: J.train_loss(cfg, p, b, shd)))(params, batch)
            out[key + "loss"] = np.asarray(loss)
            for k, v in flat(np_tree(grads)).items():
                out[key + "g/" + k] = v
            if task["opt"] is None:
                continue
            ocfg = JA.OptConfig(**task["opt"])
            st = JA.init_opt_state(params, ocfg)
            new_p, new_st, stats = jax.jit(
                lambda p, g, s: JA.apply_updates(p, g, s, ocfg))(
                    params, grads, st)
            out[key + "gnorm"] = np.asarray(stats["gnorm"])
            for k, v in flat(np_tree(new_p)).items():
                out[key + "p/" + k] = v
            for k, v in flat(np_tree(new_st)).items():
                out[key + "s/" + k] = v
        elif task["kind"] == "serve":
            logits, cache, pos = jax.jit(
                lambda p, b: J.prefill(cfg, p, b, shd))(params, task["batch"])
            out[key + "prefill"] = np.asarray(logits)
            step = jax.jit(lambda p, t, c, i: J.decode_step(cfg, p, t, c, i,
                                                            shd))
            for i, tok in enumerate(task["decode"]):
                logits, cache, pos = step(params, tok, cache, pos)
                out[key + f"decode{i}"] = np.asarray(logits)
            for k, v in flat(np_tree(cache)).items():
                out[key + "cache/" + k] = v.astype(np.float32)
        elif task["kind"] == "ckpt0":  # train's own start, as step 0
            from repro.checkpoint.manager import CheckpointManager
            p0 = init_params(cfg, jax.random.PRNGKey(0))
            CheckpointManager(task["ckpt_dir"]).save(0, {
                "params": p0,
                "opt": JA.init_opt_state(p0, JA.OptConfig(**task["opt"]))})
        elif task["kind"] == "train":
            import shutil, time
            from repro.data.pipeline import DataConfig
            from repro.runtime.train_loop import train
            if task.get("copy_from"):  # once that run has written its step
                src = task["copy_from"]
                done = os.path.join(src, f"ckpt_{task['copy_step']:08d}.json")
                deadline = time.monotonic() + job["join_s"]
                while not os.path.exists(done):
                    if time.monotonic() > deadline:  # its run failed
                        raise SystemExit(f"no checkpoint at {done}")
                    time.sleep(0.1)
                shutil.copytree(src, task["ckpt_dir"])
            res = train(cfg, mesh, task["steps"], DataConfig(**task["data"]),
                        JA.OptConfig(**task["opt"]),
                        ckpt_dir=task["ckpt_dir"],
                        ckpt_every=task["ckpt_every"])
            out[key + "losses"] = np.asarray(res.losses)
            out[key + "restored"] = np.asarray(-1 if res.restored_from is None
                                               else res.restored_from)
save(job["out"], out)
print("JAX-DONE")
'''


def start_jax(tmp_path: Path, name: str, tasks: list):
    """Start the reference's ``tasks`` in a subprocess; returns a function
    that waits for it and loads its results. Its weights land in
    ``tmp_path / f"w-{arch}.npz"`` first (:func:`weights_tree`)."""
    job = tmp_path / f"jax-{name}.pkl"
    out = tmp_path / f"jax-{name}.npz"
    with open(job, "wb") as f:
        pickle.dump({"tasks": tasks, "dir": str(tmp_path), "out": str(out),
                     "join_s": JOIN_S}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
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


def wait_for(path) -> Path:
    """``path`` once another process has written it (within
    :data:`JOIN_S`)."""
    path = Path(path)
    deadline = time.monotonic() + JOIN_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing at {path}")
        time.sleep(0.1)
    return path


def reference_file(path) -> dict:
    """The arrays of an npz the JAX side writes, once it has."""
    with np.load(wait_for(path)) as z:
        return {k: z[k] for k in z.files}


def weights_tree(directory, arch: str) -> dict:
    """The reference's smoke weights of ``arch`` as its nested numpy tree,
    waiting for the JAX side to write them."""
    from repro_torch.interop import nest

    return nest(reference_file(Path(directory) / f"w-{arch}.npz"))


def _rank_main(rank: int, world: int, store: str, job: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        with open(job, "rb") as f:
            spec = pickle.load(f)
        out = spec["scenario"](rank, world, spec)
        if rank == 0:
            with open(spec["out"] + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(spec["out"] + ".tmp", spec["out"])
    finally:
        dist.destroy_process_group()


def start_world(tmp_path: Path, name: str, nprocs: int, scenario, **spec):
    """Start ``scenario`` (a module-level function ``f(rank, world, spec)
    -> object`` of an importable module) in a gloo world of ``nprocs``
    ranks; returns a function that joins it and returns rank 0's result.
    A rank's exception fails the join; so does a world that outlives
    :data:`JOIN_S`."""
    job = tmp_path / f"port-{name}.pkl"
    out = tmp_path / f"port-{name}.out"
    with open(job, "wb") as f:
        pickle.dump(dict(spec, scenario=scenario, out=str(out),
                         dir=str(tmp_path)), f)
    ctx = mp.spawn(_rank_main, args=(nprocs, f"file://{tmp_path}/store-"
                                     f"{name}", str(job)),
                   nprocs=nprocs, join=False)
    deadline = time.monotonic() + JOIN_S

    def wait():
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"world {name} outlived {JOIN_S} s")
        with open(out, "rb") as f:
            return pickle.load(f)

    return wait


def close(got, want, rtol, atol_share, what=""):
    """``got`` within rtol and an atol of ``atol_share`` times ``want``'s
    largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_share * float(np.abs(want).max()),
        err_msg=what)


def mesh_of(dp: int, tp: int):
    """Every rank of the world calls this; the ranks past dp * tp get
    None."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(dp, tp, "cpu")


# ---------------------------------------------------------------------------
# the gradient rules, on their own (a world of 4 ranks as a 2 x 2 mesh)
# ---------------------------------------------------------------------------


def _rules(rank, world, spec):
    """Each rule's forward and its gradient, against the whole function
    computed on every rank (the values are the same everywhere: one seed)."""
    from repro_torch.sharding import comm

    mesh = mesh_of(2, 2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, generator=gen, dtype=torch.float64)
    w = torch.randn(2, 8, 3, generator=gen, dtype=torch.float64)
    d, m = mesh.coords["data"], mesh.coords["model"]
    out = {}
    # slice then gather over model: the identity, gradient w
    xr = x.clone().requires_grad_()
    y = comm.gather_blocks(mesh, "model", comm.slice_block(
        mesh, "model", xr, 1), 1)
    (g,) = torch.autograd.grad((y * w).sum(), xr)
    out["slice_gather"] = (torch.equal(y, x), torch.equal(g, w))
    # a block-local product joined over model: each rank's block of x * w;
    # the gradient of the sum against the replicated x is w, whole
    xr = x.clone().requires_grad_()
    blk = comm.slice_block(mesh, "model", xr, 1) * comm.slice_block(
        mesh, "model", w, 1)
    y = comm.gather_blocks(mesh, "model", blk, 1)
    (g,) = torch.autograd.grad(y.sum(), xr)
    out["block_product"] = (torch.allclose(y, x * w), torch.allclose(g, w))
    # copy_to: a replicated parameter used on different tokens by each
    # model rank; its gradient sums over "model"
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    mine = comm.slice_block(mesh, "model", x, 1)
    (g,) = torch.autograd.grad((comm.copy_to(mesh, "model", a) * mine).sum(),
                               a)
    out["copy_to"] = torch.allclose(g, x.sum())
    # all_to_all, twice: the identity; its gradient the identity
    xr = x[:, :, 0].clone().reshape(-1).requires_grad_()
    y = comm.all_to_all(mesh, "model", comm.all_to_all(mesh, "model", xr))
    (g,) = torch.autograd.grad((y * w[:, :, 0].reshape(-1)).sum(), xr)
    out["all_to_all"] = (torch.equal(y, xr.detach()),
                         torch.equal(g, w[:, :, 0].reshape(-1)))
    # mean over data of rank-dependent values; gradient 1 / dp
    v = (x.sum() + d).detach().requires_grad_()
    mean = comm.mean_over(mesh, "data", v)
    (g,) = torch.autograd.grad(mean, v)
    out["mean_over"] = (torch.allclose(mean, x.sum() + 0.5),
                        float(g) == 0.5)
    # gather_param: a (8, 6) leaf, rows over data and columns over model;
    # each data rank's loss weights it by (d + 1): the whole gradient is
    # the sum over data, each rank gets its block of it
    whole = torch.randn(8, 6, generator=gen, dtype=torch.float64)
    blk = whole[4 * d:4 * d + 4, 3 * m:3 * m + 3].clone().requires_grad_()
    full = comm.gather_param(mesh, blk, ("data", "model"), None, (8, 6))
    (g,) = torch.autograd.grad(((d + 1) * full * whole).sum(), blk)
    want = (1 + 2) * whole[4 * d:4 * d + 4, 3 * m:3 * m + 3]
    out["gather_param"] = (torch.equal(full, whole), torch.allclose(g, want))
    # a leaf held whole by data rank 1 only (the unit axis given to data)
    held = (whole[:, 3 * m:3 * m + 3].clone() if d == 1
            else torch.empty(0, dtype=torch.float64)).requires_grad_()
    full = comm.gather_param(mesh, held, (None, "model"), 1, (8, 6))
    (g,) = torch.autograd.grad(((d + 1) * full * whole).sum(), held)
    out["owner"] = (torch.equal(full, whole),
                    torch.allclose(g, 3 * whole[:, 3 * m:3 * m + 3])
                    if d == 1 else g.numel() == 0)
    # place / gather_whole round trip, a tuple entry numbering the blocks
    from repro_torch.sharding.comm import gather_whole, place

    spec2 = (("data", "model"), None)
    blk = place(mesh, whole, spec2)
    out["place"] = (tuple(blk.shape) == (2, 6)
                    and torch.equal(blk, whole[2 * (2 * d + m):
                                               2 * (2 * d + m) + 2]),
                    torch.equal(gather_whole(mesh, blk, spec2), whole))
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def test_gradient_rules_of_the_collectives(tmp_path):
    """On a 2 x 2 gloo mesh: slice / gather over "model" (backward:
    all-gather / take-my-block), ``copy_to`` (backward: sum over the
    axis), the all-to-all and its reverse, the mean over "data" (1 / dp),
    ``gather_param`` over both axes (the gradient summed over "data", the
    rank's block kept) and from one owner (summed onto it), ``place`` /
    ``gather_whole``: every rank agrees with the whole function."""
    every = start_world(tmp_path, "rules", 4, _rules)()
    for rank, out in enumerate(every):
        for rule, ok in out.items():
            assert np.all(ok), (rank, rule, ok)


def test_reduce_scatter_reduce_to_and_the_remesh(tmp_path):
    """``reduce_scatter`` and ``reduce_to`` sum over the axis; the elastic
    re-mesh builds its plan's mesh over the first ranks (the reference's
    ``remesh_after_failure[_batched]``), the others idle; the shared
    collectives of ``launch.collectives`` over the whole world, none
    writing its input."""
    every = start_world(tmp_path, "reduce", 4, _reduce)()
    for rank, ok in enumerate(every):
        assert all(ok.values()), (rank, ok)


def _reduce(rank, world, spec):
    from repro_torch.sharding import comm

    mesh = mesh_of(2, 2)
    d = mesh.coords["data"]
    x = torch.arange(8.0) + d
    rs = comm.reduce_scatter(mesh, "data", x, 0)
    red = comm.reduce_to(mesh, "data", x, 1)
    ok = {"reduce_scatter": torch.equal(
        rs, (2 * torch.arange(8.0) + 1)[4 * d:4 * d + 4]),
        "reduce_to": (red is None) if d == 0 else torch.equal(
            red, 2 * torch.arange(8.0) + 1)}
    # re-planning after a loss: every rank calls, the ranks past the mesh
    # get None
    from repro_torch.runtime.elastic import (
        remesh_after_failure,
        remesh_after_failure_batched,
    )

    plan, whole = remesh_after_failure(4, want_tp=2, device="cpu")
    ok["remesh"] = plan.mesh_shape == (2, 2) and whole.coords == {
        "data": rank // 2, "model": rank % 2}
    plan, part = remesh_after_failure_batched(3, want_tp=2, global_batch=4,
                                              device="cpu")
    ok["remesh_batched"] = (plan.mesh_shape, plan.dropped_devices) == (
        (2, 1), 1) and ((part is None) == (rank >= 2))
    if part is not None:
        ok["remesh_batched"] &= bool(comm.all_reduce(
            part, None, torch.ones(())) == 2)
    # the shared collectives over the world of 4 (gloo: the gather and the
    # reduce-scatter as all-to-alls), each against its whole function
    from repro_torch.launch import collectives as coll

    cpu = torch.device("cpu")
    mine = torch.arange(6.0).reshape(2, 3) + 10 * rank
    every_x = torch.stack([torch.arange(6.0).reshape(2, 3) + 10 * r
                           for r in range(world)])
    ok["coll_all_gather"] = torch.equal(coll.all_gather(None, cpu, mine),
                                        every_x)
    rows = torch.arange(8.0).reshape(4, 2) + 100 * rank
    ok["coll_all_to_all"] = torch.equal(
        coll.all_to_all(None, cpu, rows),
        torch.stack([torch.arange(2.0) + 2 * rank + 100 * r
                     for r in range(world)]))
    ok["coll_reduce_scatter"] = torch.equal(
        coll.reduce_scatter(None, cpu, rows),
        4 * (torch.arange(2.0) + 2 * rank) + 100 * 6)
    ok["coll_all_reduce"] = torch.equal(
        coll.all_reduce(None, cpu, mine, dist.ReduceOp.MIN),
        torch.arange(6.0).reshape(2, 3)) and torch.equal(
        mine, torch.arange(6.0).reshape(2, 3) + 10 * rank)
    ok["coll_broadcast"] = torch.equal(coll.broadcast(None, cpu, mine, 2),
                                       every_x[2])
    red = coll.reduce(None, cpu, mine, 1)
    ok["coll_reduce"] = rank != 1 or torch.equal(red, every_x.sum(0))
    every = [None] * world
    dist.all_gather_object(every, ok)
    return every


def test_make_mesh_without_a_device_needs_the_card(monkeypatch):
    """``device=None`` means the card, as everywhere in the port: without
    one, the mesh raises before it touches a group."""
    from repro_torch.launch.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)


@pytest.mark.parametrize("n,tp,want", [(1, 2, 1), (4, 2, 2), (6, 4, 3),
                                       (8, 16, 8), (7, 2, 1)])
def test_host_tp_is_the_references_choice(n, tp, want):
    from repro_torch.launch.mesh import host_tp

    assert host_tp(n, tp) == want
