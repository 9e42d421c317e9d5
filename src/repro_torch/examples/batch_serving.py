"""Serving-style demo: answer batches of SSSP queries against one road
graph (counterpart of ``examples/batch_serving.py``).

A long-lived process holds one graph (its views built once), queries
arrive in batches of source ids, and each batch is answered by a single
call to ``run_phased_static_batch``: one phase loop for the whole batch,
each phase's adjacency read shared across queries. One row of every
request is checked against sequential Dijkstra.

    PYTHONPATH=src python -m repro_torch.examples.batch_serving [--n 5000]
        [--batch 16] [--requests 4] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import dijkstra_numpy, to_ell_in, to_ell_out
from repro_torch.core.static_engine import run_phased_static_batch
from repro_torch.examples import Record, add_device_arg, tensor_bytes
from repro_torch.graphs import grid_road
from repro_torch.kernels.config import resolve_device
from repro_torch.obs.timer import now


class SSSPServer:
    """Holds one graph; answers (B,) source batches with distance matrices."""

    def __init__(self, g, device):
        self.g = g
        self.device = device
        # built once, reused by every batch: the in-view, and the out-view
        # the default plan pushes its relax along
        self.ell = to_ell_in(g)
        self.ell_out = to_ell_out(g)

    def answer(self, sources):
        res = run_phased_static_batch(self.g, sources, ell=self.ell,
                                      ell_out=self.ell_out,
                                      device=self.device)
        return res.dist.cpu().numpy(), res


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--requests", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Record()

    side = int(np.sqrt(args.n))
    g = grid_road(side, side, seed=0, device=dev)
    out.say(f"serving road grid {side}x{side}: n={g.n}, "
            f"m={g.num_real_edges}")
    server = SSSPServer(g, dev)
    rng = np.random.default_rng(1)

    # warm-up request: the kernels' first load
    server.answer(rng.integers(0, g.n, args.batch))

    total_q, total_t = 0, 0.0
    phases = []
    for r in range(args.requests):
        sources = rng.integers(0, g.n, args.batch)
        t0 = now()
        dist, res = server.answer(sources)
        dt = now() - t0
        total_q += len(sources)
        total_t += dt
        phases.append(int(res.total_phases))
        # validate a spot-check row per request against sequential Dijkstra
        i = int(rng.integers(len(sources)))
        ref = dijkstra_numpy(g, int(sources[i]))
        fin = np.isfinite(ref)
        ok = (np.isfinite(dist[i]) == fin).all() and np.allclose(
            dist[i][fin], ref[fin], rtol=1e-5)
        out.say(f"request {r}: B={len(sources)} answered in {dt*1e3:7.1f} ms "
                f"({len(sources)/dt:8.1f} q/s), "
                f"phases={int(res.total_phases)}, spot-check row {i} vs "
                f"Dijkstra: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise RuntimeError(f"request {r}: row {i} differs from Dijkstra")
    out.say(f"\nserved {total_q} queries in {total_t*1e3:.0f} ms "
            f"-> {total_q/total_t:.1f} queries/sec sustained")
    out.fields.update(n=g.n, m=g.num_real_edges, phases=phases,
                      seconds=total_t, queries_per_s=total_q / total_t,
                      view_bytes=tensor_bytes(server.ell, server.ell_out))
    return out


if __name__ == "__main__":
    main()
