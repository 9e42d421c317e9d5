#!/usr/bin/env python3
"""Time the solves of two checkouts of the port in turns.

    python3 tools/ab_solve.py A_ROOT B_ROOT [--pairs 2] [--reps 5] [--out FILE]

Run on a machine with an NVIDIA H100 and ``nvcc``. ``A_ROOT`` and
``B_ROOT`` are roots of two checkouts (for example the parent commit from
``git archive``, unpacked into the git-ignored ``build/``, and this tree).
Each run is a fresh process that imports ``repro_torch`` from its root's
``src/`` and builds that root's kernels there, then times one workload's
solve (``run_phased_static_batch``) after one warm-up solve, ``--reps``
times, each ending in a ``torch.cuda.synchronize()``. Every run takes
each of the workloads (:data:`WORKLOADS`):

  * ``padded``: the default criterion, B = 8, on G(10^6, 10^-4), seed 0,
    over the padded in-ELL, on the sources of ``chip_smoke.py`` phase 4;
  * ``sliced``: the default criterion, B = 8, on ``kronecker(20)``, seed
    0, ``layout="sliced"``, on the sources of ``chip_smoke.py`` phase 15;
  * ``delta_gnp`` / ``delta_kron``: the portfolio's routed engine on both
    graphs, ``delta@x4:sliced`` (Δ at 4 x ``default_delta``, the sliced
    out-view's buckets), B = 8, the same sources;
  * ``road``: the default criterion, B = 16, on ``grid_road(512, 512)``,
    seed 0 (the high-diameter family of ``chip_smoke.py`` phase 31), its
    first ``ROAD_PHASES`` phases from 16 seeded sources.

Each workload gets ``--pairs`` pairs of runs, alternating which side runs
first (A B, B A, A B, ...). Each graph is generated once and its COO
arrays kept in a temporary directory for the later runs (the generators
and ``from_coo`` are the same in both checkouts). Prints the card's name
and power limit, each run's ms a phase and, per workload, the pairs B won
(its run's median below A's), the median over all solves of each side,
and the quartiles of each side's run medians; writes them as JSON to
``--out``. Exits non-zero without a card, or when the two checkouts'
results differ in a bit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

N, P, SEED, KRON_K, LANES, REQUESTS = 1_000_000, 1e-4, 0, 20, 8, 16
ROAD_SIDE, ROAD_LANES, ROAD_PHASES = 512, 16, 1024
# workload -> (graph, criterion, layout, delta as a multiple of
#   default_delta or None, lanes, max_phases or None for the whole solve)
WORKLOADS = {
    "padded": ("gnp", "instatic|outstatic", "padded", None, LANES, None),
    "sliced": ("kron", "instatic|outstatic", "sliced", None, LANES, None),
    "delta_gnp": ("gnp", "delta", "sliced", 4.0, LANES, None),
    "delta_kron": ("kron", "delta", "sliced", 4.0, LANES, None),
    "road": ("road", "instatic|outstatic", "padded", None, ROAD_LANES,
             ROAD_PHASES),
}


def worker(root: str, workload: str, cache: str, reps: int) -> dict:
    """One run: the solve's ms a phase on one checkout, and a digest of its
    result."""
    import hashlib
    import time

    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.core.delta_stepping import default_delta
    from repro_torch.core.graph import from_coo, out_degrees
    from repro_torch.core.static_engine import run_phased_static_batch
    from repro_torch.graphs import generators
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if not str(Path(generators.__file__)).startswith(str(Path(root))):
        raise SystemExit(f"repro_torch imported from {generators.__file__}")
    dev = torch.device("cuda", 0)
    _build.build()
    graph, crit, layout, delta_x, lanes, cap = WORKLOADS[workload]
    coo = Path(cache) / f"{graph}.npz"
    n = {"gnp": N, "kron": 2 ** KRON_K, "road": ROAD_SIDE ** 2}[graph]
    if coo.exists():
        z = np.load(coo)
        g = from_coo(z["src"], z["dst"], z["w"], n, device=dev)
    else:
        real = generators.from_coo

        def keep(src, dst, w, n_, pad_to=None, device=None):
            np.savez(coo, src=src, dst=dst, w=w)
            return real(src, dst, w, n_, pad_to=pad_to, device=device)

        generators.from_coo = keep
        g = {"gnp": lambda: generators.uniform_gnp(N, P, seed=SEED,
                                                   device=dev),
             "kron": lambda: generators.kronecker(KRON_K, seed=SEED,
                                                  device=dev),
             "road": lambda: generators.grid_road(ROAD_SIDE, ROAD_SIDE,
                                                  seed=SEED, device=dev),
             }[graph]()
        generators.from_coo = real
    if graph == "gnp":
        srcs = np.random.default_rng(1).integers(0, g.n, REQUESTS)[:LANES]
    elif graph == "kron":
        has_out = torch.nonzero(out_degrees(g) >= 1).squeeze(1).cpu().numpy()
        srcs = np.random.default_rng(2).choice(has_out, REQUESTS)[:LANES]
    else:
        srcs = np.random.default_rng(3).integers(0, g.n, lanes)
    kw = dict(layout=layout, criterion=crit, max_phases=cap)
    if delta_x is not None:
        kw["delta"] = delta_x * default_delta(g)

    def solve():
        res = run_phased_static_batch(g, srcs, device=dev, **kw)
        torch.cuda.synchronize()
        return res

    res = solve()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        walls.append(time.perf_counter() - t0)
    total = int(res.total_phases)
    digest = hashlib.sha256()
    for field in ("dist", "status", "phases", "sum_fringe", "relax_edges"):
        x = getattr(res, field)
        digest.update((x.cpu().numpy() if torch.is_tensor(x)
                       else np.asarray(x)).tobytes())
    return {"workload": workload, "phases": total,
            "ms_phase": [w / total * 1e3 for w in walls],
            "digest": digest.hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_root")
    ap.add_argument("b_root", nargs="?")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--worker", choices=tuple(WORKLOADS))
    ap.add_argument("--cache")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.a_root, args.worker, args.cache,
                                args.reps)), flush=True)
        return 0
    if args.b_root is None:
        ap.error("give two checkouts")
    roots = {"A": str(Path(args.a_root).resolve()),
             "B": str(Path(args.b_root).resolve())}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    summary = {"card": smi}
    with tempfile.TemporaryDirectory() as cache:
        for graph in WORKLOADS:
            runs = []
            order = [side for i in range(args.pairs)
                     for side in (("A", "B") if i % 2 == 0 else ("B", "A"))]
            for label in order:
                out = subprocess.run(
                    [sys.executable, __file__, roots[label], "--worker",
                     graph, "--cache", cache, "--reps", str(args.reps)],
                    capture_output=True, text=True, check=True,
                    env=dict(os.environ, PYTHONPATH=""))
                row = json.loads(out.stdout.strip().splitlines()[-1])
                row["tree"] = label
                runs.append(row)
                print(f"{graph} {label}: {row['phases']} phases, ms a phase "
                      + ", ".join(f"{x:.4f}" for x in row["ms_phase"]),
                      flush=True)
            if len({r["digest"] for r in runs}) != 1:
                raise SystemExit(f"{graph}: the two checkouts' results differ")
            run_med = [float(np.median(r["ms_phase"])) for r in runs]
            wins = sum(run_med[2 * i + (order[2 * i] == "A")]
                       < run_med[2 * i + (order[2 * i] == "B")]
                       for i in range(args.pairs))
            summary[graph] = {"pairs": args.pairs, "b_wins": int(wins)}
            for label in ("A", "B"):
                ms = [x for r in runs if r["tree"] == label
                      for x in r["ms_phase"]]
                meds = [m for m, r in zip(run_med, runs) if r["tree"] == label]
                q1, q3 = np.percentile(meds, [25, 75])
                summary[graph][label] = {
                    "median": float(np.median(ms)), "run_medians": meds,
                    "quartiles": [float(q1), float(q3)]}
            a, b = summary[graph]["A"], summary[graph]["B"]
            print(f"{graph}: B won {wins} of {args.pairs} pairs; A median "
                  f"{a['median']:.4f} ms a phase (run quartiles "
                  f"{a['quartiles'][0]:.4f}-{a['quartiles'][1]:.4f}), B "
                  f"median {b['median']:.4f} ({b['quartiles'][0]:.4f}-"
                  f"{b['quartiles'][1]:.4f}), B / A "
                  f"{b['median'] / a['median']:.4f}; results bit-equal",
                  flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
