"""Continuous-batching SSSP serving over a sharded graph (counterpart of
``examples/distributed_serving.py``).

Every rank of a ``torch.distributed`` world block-shards one road graph's
vertex state, and rank 0 serves asynchronous queries through the same
``ContinuousBatcher`` the single-device demo uses; only the engine
backend changes (``ShardedBackend``: the other ranks replay rank 0's
commands in ``follow()`` until it closes the backend). Admission,
coalescing, the distance cache and the metrics report are identical, and
every completed answer is checked bit for bit against a single-device
``run_phased_static`` solve.

    PYTHONPATH=src python -m repro_torch.examples.distributed_serving
        [--n 400] [--lanes 4] [--queries 16] [--phases-per-step 8]
        [--schedule reduce_scatter] [--seed 0] [--ranks 8] [--device cpu]

Run plainly, this process is rank 0 of a gloo world of ``--ranks`` (the
reference's 8 blocks) and starts the other ranks itself, over a
``file://`` store in a temporary directory; on one card they all share
it, so the run checks the answers and gives no speed figure. Under
``torchrun`` every rank joins the launcher's world (NCCL, one rank a
card; gloo with ``--device cpu``):

    torchrun --nproc-per-node 2 -m repro_torch.examples.distributed_serving
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.examples import Record, add_device_arg, sync
from repro_torch.examples.continuous_serving import arrivals, serve_and_check
from repro_torch.graphs import grid_road
from repro_torch.kernels.config import resolve_device
from repro_torch.launch.mesh import init_group
from repro_torch.obs.timer import now
from repro_torch.serving import ContinuousBatcher, DistCache, ShardedBackend

JOIN_S = 600.0  # the most the other ranks may take to return after rank 0


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400,
                    help="~vertex count (grid side is sqrt)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--phases-per-step", type=int, default=8)
    ap.add_argument("--schedule", choices=("allreduce", "reduce_scatter"),
                    default="reduce_scatter")
    ap.add_argument("--hot-frac", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=8,
                    help="the world's size when run without torchrun")
    add_device_arg(ap)
    return ap.parse_args(argv)


def rank_device(name, rank: int) -> torch.device:
    """A started rank's device: the card ``rank % cards``, or the CPU."""
    dev = resolve_device(name)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def serve(args, rank: int, world: int, dev) -> Record:
    """One rank's part: rank 0 serves and checks, the others follow."""
    side = max(2, int(np.sqrt(args.n)))
    g = grid_road(side, side, seed=args.seed, device=dev)
    backend = ShardedBackend(g, schedule=args.schedule, device=dev)
    out = Record()
    if rank:
        backend.follow()
        return out
    out.say(f"serving road grid {side}x{side} (n={g.n}, "
            f"n_pad={backend.sg.n_pad}) sharded over {world} {dev.type} "
            f"ranks, lanes={args.lanes}, k={args.phases_per_step}, "
            f"schedule={args.schedule}")
    server = ContinuousBatcher(
        g, lanes=args.lanes, phases_per_step=args.phases_per_step,
        cache=DistCache(capacity=128), backend=backend,
    )
    sources = arrivals(g.n, args.lanes, args.queries, args.hot_frac,
                       args.seed)
    t0 = now()
    try:
        done = serve_and_check(server, g, sources, out,
                               "single-device solve")
    finally:
        backend.close()  # the followers return, also when a check failed
    sync(dev)
    wall = now() - t0
    out.say(f"\nall {len(done)} sharded-served answers bit-exact vs "
            f"run_phased_static")
    out.say(server.metrics.to_json(indent=1))
    out.fields.update(n=g.n, m=g.num_real_edges, n_pad=backend.sg.n_pad,
                      ranks=world,
                      completions=done, seconds=wall,
                      metrics=server.metrics.report())
    return out


def _follower(rank: int, world: int, store: str, argv) -> None:
    """A started rank (a spawned process): join the world and follow."""
    args = parse(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(args.device, rank)
    init_group(rank, world, backend="gloo", init_method=store, device=dev)
    try:
        serve(args, rank, world, dev)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> Record:
    args = parse(argv)
    if "RANK" in os.environ:  # under torchrun: the launcher's world
        rank, world, dev = init_group(device=args.device)
        try:
            return serve(args, rank, world, dev)
        finally:
            dist.destroy_process_group()
    if args.ranks < 1:
        raise ValueError(f"--ranks must be at least 1; got {args.ranks}")
    dev = rank_device(args.device, 0)
    tmp = tempfile.mkdtemp(prefix="repro_torch_serving_")
    store = f"file://{tmp}/store"
    ctx = multiprocessing.get_context("spawn")
    argv = sys.argv[1:] if argv is None else list(argv)
    procs = [ctx.Process(target=_follower,
                         args=(r, args.ranks, store, argv), daemon=True)
             for r in range(1, args.ranks)]
    try:
        for p in procs:
            p.start()
        init_group(0, args.ranks, backend="gloo", init_method=store,
                   device=dev)
        try:
            out = serve(args, 0, args.ranks, dev)
        finally:
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout=JOIN_S)
        failed = {p.name: p.exitcode for p in procs if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks that did not end cleanly: {failed}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
