#!/usr/bin/env python3
"""Time the default B = 8 solves of two checkouts of the port in turns.

    python3 tools/ab_solve.py A_ROOT B_ROOT [--pairs 2] [--reps 5] [--out FILE]

Run on a machine with an NVIDIA H100 and ``nvcc``. ``A_ROOT`` and
``B_ROOT`` are roots of two checkouts (for example the parent commit from
``git archive``, unpacked into the git-ignored ``build/``, and this tree).
Each run is a fresh process that imports ``repro_torch`` from its root's
``src/`` and builds that root's kernels there, then times the default
criterion's B = 8 solve (``run_phased_static_batch``) after one warm-up
solve, ``--reps`` times, each ending in a ``torch.cuda.synchronize()``:

  * ``padded``: G(10^6, 10^-4), seed 0, over the padded in-ELL, on the
    sources of ``chip_smoke.py`` phase 4;
  * ``sliced``: ``kronecker(20)``, seed 0, ``layout="sliced"``, on the
    sources of ``chip_smoke.py`` phase 15.

Each graph gets ``--pairs`` pairs of runs, alternating which side runs
first (A B, B A, A B, ...). Both graphs are generated once and their COO
arrays kept in a temporary directory for the later runs (the generators
and ``from_coo`` are the same in both checkouts). Prints each run's ms a
phase and, per graph, the pairs B won (its run's median below A's), the
median over all solves of each side, and the quartiles of each side's run
medians; writes them as JSON to ``--out``. Exits non-zero without a card,
or when the two checkouts' results differ in a bit.
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


def worker(root: str, graph: str, cache: str, reps: int) -> dict:
    """One run: the solve's ms a phase on one checkout, and a digest of its
    result."""
    import hashlib
    import time

    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.core.graph import from_coo, out_degrees, to_ell_in
    from repro_torch.core.static_engine import run_phased_static_batch
    from repro_torch.graphs import generators
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if not str(Path(generators.__file__)).startswith(str(Path(root))):
        raise SystemExit(f"repro_torch imported from {generators.__file__}")
    dev = torch.device("cuda", 0)
    _build.build()
    coo = Path(cache) / f"{graph}.npz"
    n = N if graph == "padded" else 2 ** KRON_K
    if coo.exists():
        z = np.load(coo)
        g = from_coo(z["src"], z["dst"], z["w"], n, device=dev)
    else:
        real = generators.from_coo

        def keep(src, dst, w, n_, pad_to=None, device=None):
            np.savez(coo, src=src, dst=dst, w=w)
            return real(src, dst, w, n_, pad_to=pad_to, device=device)

        generators.from_coo = keep
        g = (generators.uniform_gnp(N, P, seed=SEED, device=dev)
             if graph == "padded" else
             generators.kronecker(KRON_K, seed=SEED, device=dev))
        generators.from_coo = real
    if graph == "padded":
        srcs = np.random.default_rng(1).integers(0, g.n, REQUESTS)[:LANES]
        kw = dict(ell=to_ell_in(g))
    else:
        has_out = torch.nonzero(out_degrees(g) >= 1).squeeze(1).cpu().numpy()
        srcs = np.random.default_rng(2).choice(has_out, REQUESTS)[:LANES]
        kw = dict(layout="sliced")

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
    return {"graph": graph, "phases": total,
            "ms_phase": [w / total * 1e3 for w in walls],
            "digest": digest.hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_root")
    ap.add_argument("b_root", nargs="?")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--worker", choices=("padded", "sliced"))
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
    summary = {}
    with tempfile.TemporaryDirectory() as cache:
        for graph in ("padded", "sliced"):
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
