"""End-to-end run of the paper's workload (counterpart of
``examples/sssp_pipeline.py``): generate graph families, run every engine
(generic criteria engine, kernel-backed static engine, Delta-stepping,
sequential Dijkstra), validate distances, and report phases/work/time.

    PYTHONPATH=src python -m repro_torch.examples.sssp_pipeline [--n 50000]
        [--deg 10] [--device cpu]

The reference builds the padded in-ELL for every family. Here the static
engine pushes along the outgoing view as well, and a skewed family's
padded views (n x D slots of 8 bytes, D its largest degree) can outgrow
the card: each family gets the padded in- and out-views where they fit in
a quarter of the device's free memory, else the degree-sliced ones, and
a line after the family's header says which and their bytes. Both give
the same distances bit for bit.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.core import (
    dijkstra_numpy,
    run_delta_stepping,
    run_phased,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_sliced,
)
from repro_torch.core.static_engine import run_phased_static
from repro_torch.examples import Record, add_device_arg, sync, tensor_bytes
from repro_torch.graphs import grid_road, kronecker, uniform_gnp, webgraph
from repro_torch.kernels.config import resolve_device
from repro_torch.obs.timer import now

ENGINES = ("phased INSTATIC|OUTSTATIC", "phased static (CUDA kernels)",
           "phased IN|OUT (strong)", "delta-stepping")


def view_budget(dev: torch.device) -> int:
    """A quarter of the device's free memory, in bytes (the host's
    available memory for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 4
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 4


def padded_bytes(g, pad_multiple: int = 8) -> int:
    """Bytes of the padded in- and out-views of ``g`` (an int32 id and an
    f32 weight a slot), from its degrees, before building either."""
    real = torch.isfinite(g.w)
    total = 0
    for ids in (g.dst, g.src):
        deg = int(torch.bincount(ids[real].long(), minlength=g.n).max())
        total += g.n * (-(-max(deg, 1) // pad_multiple) * pad_multiple) * 8
    return total


def build_views(g, dev) -> tuple:
    """(layout, in-view, out-view): padded where both fit in
    :func:`view_budget`, else degree-sliced."""
    if padded_bytes(g) <= view_budget(dev):
        return "padded", to_ell_in(g), to_ell_out(g)
    return "sliced", to_ell_in_sliced(g), to_ell_out_sliced(g)


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--deg", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n
    out = Record()
    families = out.fields["families"] = {}

    graphs = {
        f"uniform G({n},{args.deg}/n)":
            lambda: uniform_gnp(n, args.deg / n, seed=0, device=dev),
        f"kronecker 2^{int(np.log2(n))}":
            lambda: kronecker(int(np.log2(n)), seed=0, device=dev),
        "road grid": lambda: grid_road(int(np.sqrt(n)), int(np.sqrt(n)),
                                       seed=0, device=dev),
        "web graph": lambda: webgraph(n, 8, seed=0, device=dev),
    }
    for name, make in graphs.items():
        t0 = now()
        g = make()  # one family on the device at a time
        build_s = now() - t0
        m = g.num_real_edges
        t0 = now()
        ref = dijkstra_numpy(g, 0)
        t_seq = now() - t0
        out.say(f"\n== {name}: n={g.n} m={m} (sequential Dijkstra "
                f"{t_seq*1e3:.0f} ms)")
        t0 = now()
        layout, ell, ell_out = build_views(g, dev)
        sync(dev)
        view_s = now() - t0
        nbytes = tensor_bytes(ell, ell_out)
        out.say(f"  view={layout} bytes={nbytes}")
        fam = families[name] = {
            "n": g.n, "m": m, "view": layout, "view_bytes": nbytes,
            "graph_s": build_s, "view_s": view_s, "dijkstra_s": t_seq,
            "engines": {}}

        def check(dist):
            d = dist.cpu().numpy()
            fin = np.isfinite(ref)
            return bool((np.isfinite(d) == fin).all() and np.allclose(
                d[fin], ref[fin], rtol=1e-4))

        for label, fn in zip(ENGINES, (
            lambda: run_phased(g, 0, "instatic|outstatic", device=dev),
            lambda: run_phased_static(g, 0, ell=ell, ell_out=ell_out,
                                      device=dev),
            lambda: run_phased(g, 0, "in|out", device=dev),
            lambda: run_delta_stepping(g, 0, device=dev),
        )):
            fn()  # warm-up: the kernels' first load
            sync(dev)
            t0 = now()
            r = fn()
            r.dist.cpu()
            t = now() - t0
            ok = check(r.dist)
            fam["engines"][label] = {"phases": int(r.phases), "s": t,
                                     "correct": ok}
            out.say(f"  {label:34s} phases={int(r.phases):6d} "
                    f"time={t*1e3:7.1f} ms  speedup-vs-seq=x{t_seq/t:5.2f} "
                    f"correct={ok}")
        del g, ell, ell_out, ref
    return out


if __name__ == "__main__":
    main()
