"""Quickstart: phased SSSP with Crauser-style criteria (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import dijkstra_numpy, run_delta_stepping, run_phased
from repro_torch.examples import Record, add_device_arg
from repro_torch.graphs import uniform_gnp
from repro_torch.kernels.config import resolve_device
from repro_torch.obs.timer import Stopwatch

CRITERIA = ("dijk", "instatic", "outstatic", "instatic|outstatic",
            "insimple|outsimple", "in|out")


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Record()

    with Stopwatch() as sw:
        # a uniform random graph, expected out-degree 10, uniform [0,1] weights
        g = uniform_gnp(n=2000, p=10 / 2000, seed=0, device=dev)
        ref = dijkstra_numpy(g, source=0)  # sequential oracle
        out.say(f"G(n={g.n}, m~{g.num_real_edges})")
        out.say(f"{'criterion':24s} {'phases':>7s} {'sum|F|':>9s}  correct")
        phases = {}
        for crit in CRITERIA:
            r = run_phased(g, 0, crit, device=dev)
            d = r.dist.cpu().numpy()
            ok = np.allclose(np.where(np.isfinite(ref), ref, 0),
                             np.where(np.isfinite(d), d, 0), rtol=1e-5)
            phases[crit] = int(r.phases)
            out.say(f"{crit:24s} {int(r.phases):7d} {int(r.sum_fringe):9d}  "
                    f"{ok}")
        r = run_phased(g, 0, "oracle", dist_true=ref.astype(np.float32),
                       device=dev)
        phases["oracle"] = int(r.phases)
        out.say(f"{'oracle (lower bound)':24s} {int(r.phases):7d} "
                f"{int(r.sum_fringe):9d}")
        d = run_delta_stepping(g, 0, device=dev)
        phases["delta"] = int(d.phases)
        out.say(f"{'delta-stepping':24s} {int(d.phases):7d} {'-':>9s}")
    out.fields.update(seconds=sw.elapsed, phases=phases)
    return out


if __name__ == "__main__":
    main()
