"""Distributed SSSP launcher: the paper's phased algorithm over a
``torch.distributed`` group, one vertex block a rank (counterpart of
``repro.launch.sssp_run``; criterion ``instatic|outstatic``).

    torchrun --nproc-per-node 2 -m repro_torch.launch.sssp_run \\
        --backend gloo --verify

Every rank builds the graph from the seed on its device and runs
``run_distributed`` from vertex 0; rank 0 prints the phases and the wall
time and, with ``--verify``, checks the row against sequential Dijkstra
(f64, host). Without ``torchrun``, pass ``--rank``, ``--world-size`` and
``--init-method`` (e.g. ``file:///tmp/store``) to each process. Exits 1
when the check fails.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch.distributed as dist

from repro_torch.core.distributed import run_distributed
from repro_torch.core.oracle import dijkstra_numpy
from repro_torch.graphs import uniform_gnp
from repro_torch.launch.mesh import BACKENDS, init_group
from repro_torch.obs.timer import Stopwatch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--deg", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="reduce_scatter",
                    choices=["reduce_scatter", "allreduce"])
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="default: nccl on a card, gloo on the CPU")
    ap.add_argument("--device", default=None,
                    help="default: cuda:(local rank % cards)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)

    rank, world, dev = init_group(args.rank, args.world_size,
                                  backend=args.backend,
                                  init_method=args.init_method,
                                  device=args.device)
    try:
        g = uniform_gnp(args.n, args.deg / args.n, seed=args.seed, device=dev)
        if rank == 0:
            print(f"world {world} ({dist.get_backend()}), rank 0 on {dev}; "
                  f"schedule={args.schedule}", flush=True)
        with Stopwatch() as sw:
            dist_row, phases = run_distributed(g, None, 0,
                                               schedule=args.schedule,
                                               device=dev)
            row = dist_row.cpu().numpy()
        ok = True
        if rank == 0:
            print(f"n={g.n}: {int(phases)} phases in {sw.elapsed:.2f}s "
                  f"(incl. the kernels' first load)", flush=True)
            if args.verify:
                ref = dijkstra_numpy(g, 0)
                fin = np.isfinite(ref)
                ok = bool((np.isfinite(row) == fin).all()
                          and np.allclose(row[fin], ref[fin], rtol=1e-5))
                print(f"verified against sequential Dijkstra: {ok}",
                      flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
