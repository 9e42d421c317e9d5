#!/usr/bin/env python3
"""Time variants of the push relax on one CUDA card.

    python3 tools/push_variants.py [--variants a,b,...] [--graphs gnp,kron]

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``. Builds ``src/repro_torch/kernels/csrc/ell_push.cu`` once as it
stands and once per variant (a changed ``#define`` or a small text edit,
below), every ``nvcc`` at once, into the git-ignored ``build/variants/``.
Then, on real relax inputs of the B = 8 ``instatic|outstatic`` solves that
``chip_smoke.py`` times (phase 200 and the densest phase of G(10^6, 10^-4)
on the padded out-view; phase 121 and the densest phase of ``kronecker(20)``
on the sliced out-view), it launches each build through
``ell_relax.push_rows``: every variant against the twin bit for bit (the
cut excepted, which leaves work out on purpose), CUDA-event medians in two
rounds (forward, then backward), and the shipped build's device time by
kernel from ``torch.profiler``, with the host time to issue one call.
Every variant is timed by CUDA events and by ``torch.profiler`` (device
time summed over its kernels). Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
INF = float("inf")

# name -> ({macro: value}, [(old text, new text)], bits must equal the twin)
VARIANTS = {
    "shipped": ({}, [], True),
    "task_slots_256": ({"PUSH_TASK_SLOTS": 256}, [], True),
    "task_slots_4096": ({"PUSH_TASK_SLOTS": 4096}, [], True),
    "task_rows_32": ({"PUSH_TASK_SLOTS": 1 << 20}, [], True),
    "unroll_2": ({"PUSH_UNROLL": 2}, [], True),
    "unroll_8": ({"PUSH_UNROLL": 8}, [], True),
    "no_filter": ({"PUSH_FILTER": 0}, [], True),
    "no_evict_first": ({}, [("__ldcs(crow + j)", "__ldg(crow + j)"),
                            ("__ldcs(wrow + j)", "__ldg(wrow + j)")], True),
    # cuts: the mark pass alone (the push pass is not launched); the push
    # pass reading the owners' mask words only; the push pass streaming the
    # active rows with no candidate formed
    "cut_mark_only": ({}, [("  for (int i = 0; rc == 0 && i < n_buckets;) {\n",
                            "  for (int i = 0; rc == 0 && i < 0;) {\n")],
                      False),
    "cut_scan_only": ({}, [("  while (rest != 0) {\n",
                            "  while (rest != 0 && tile < 0) {\n")], False),
    "cut_no_update": ({}, [
        ("      for (unsigned bits = rm; bits != 0; bits &= bits - 1) {\n",
         "      for (unsigned bits = rm; bits != 0 && tile < 0;"
         " bits &= bits - 1) {\n")], False),
}


def variant_source(src: str, defines: dict, edits: list) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    for name, value in defines.items():
        src, count = re.subn(rf"#define {name} \S+", f"#define {name} {value}",
                             src)
        if count != 1:
            raise SystemExit(f"no #define {name} in ell_push.cu")
    return src


def phase_inputs(graph, sources, ell_in, ell_out, deg, mid: int):
    """The relax inputs of phase ``mid`` and of the densest phase of the
    B = 8 default solve: d before a phase where it settled (a phase sets
    status 2 exactly on its settle mask), +inf elsewhere."""
    import torch

    from chip_smoke import push_load
    from repro_torch.core.static_engine import init_batch_state, step_batch

    st = init_batch_state(graph, sources, device=deg.device)
    at_mid, densest, dense_cand = None, None, -1
    while True:
        nxt = step_batch(graph, st, 1, ell=ell_in, ell_out=ell_out)
        if int(nxt.trips) == int(st.trips):
            break
        dm = torch.where((nxt.status == 2) & (st.status != 2), st.dist, INF)
        cand = push_load(dm, deg)[1]
        if int(nxt.trips) == mid:
            at_mid = (mid, dm)
        if cand > dense_cand:
            densest, dense_cand = (int(nxt.trips), dm), cand
        st = nxt
    return {f"phase {at_mid[0]}": at_mid[1],
            f"densest phase {densest[0]}": densest[1]}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--graphs", default="gnp,kron")
    args = parser.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("push_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        out_degrees,
        to_ell_in,
        to_ell_in_sliced,
        to_ell_out,
        to_ell_out_sliced,
    )
    from repro_torch.graphs import kronecker, uniform_gnp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.ell_relax import PUSH_SIGNATURES, push_rows

    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_summary, push_load, same_bits, time_ms

    src = (_build.CSRC / "ell_push.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        defines, edits, _ = VARIANTS[name]
        cu = out_dir / f"push_{name}.cu"
        cu.write_text(variant_source(src, defines, edits))
        so = out_dir / f"push_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-4000:]}")
        for fn, info in ptxas_summary(text):
            if fn == "push_kernel":
                print(f"[{name}] ptxas {fn}: {info}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in PUSH_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    cases = []  # (label, dmask, out-view, out-degrees)
    if "gnp" in args.graphs.split(","):
        g = uniform_gnp(1_000_000, 1e-4, seed=0, device=dev)
        deg, view = out_degrees(g), to_ell_out(g)
        src8 = np.random.default_rng(1).integers(0, g.n, 16)[:8]
        for label, dm in phase_inputs(g, src8, to_ell_in(g), view, deg,
                                      200).items():
            cases.append((f"G(1e6, 1e-4) padded {label}", dm, view, deg))
    if "kron" in args.graphs.split(","):
        gk = kronecker(20, seed=0, device=dev)
        deg, view = out_degrees(gk), to_ell_out_sliced(gk)
        has_out = torch.nonzero(deg >= 1).squeeze(1).cpu().numpy()
        src8 = np.random.default_rng(2).choice(has_out, 16)[:8]
        for label, dm in phase_inputs(gk, src8, to_ell_in_sliced(gk), view,
                                      deg, 121).items():
            cases.append((f"kronecker(20) sliced {label}", dm, view, deg))
    for label, dm, _, deg in cases:
        active, cand, _ = push_load(dm, deg)
        print(f"input {label}: {active} active rows, {cand} candidates")
    twins = [ref.ell_push_relax_batch_ref(dm, view)
             for _, dm, view, _ in cases]
    def device_ms(fn, calls: int = 20) -> float:
        """Device milliseconds a call, summed over its kernels."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()) \
            / calls / 1e3

    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            row = []
            for (label, dm, view, _), twin in zip(cases, twins):
                stats = torch.zeros(2, dtype=torch.int64, device=dev)
                got = push_rows(dm, view, stats, lib=libs[name])
                torch.cuda.synchronize()
                same = same_bits(got, twin)
                if VARIANTS[name][2] and not same:
                    raise SystemExit(f"{name} on {label} differs from the twin")

                def call(dm=dm, view=view, lib=libs[name]):
                    return push_rows(dm, view, lib=lib)
                row.append(f"{label} {time_ms(call, reps=30):.4f} ms event, "
                           f"{device_ms(call):.4f} ms device (atomics "
                           f"{stats[1].item()}; "
                           f"{'bits equal' if same else 'bits differ: a cut'})")
            print(f"[{name}] round {rnd}: " + "; ".join(row))
    if "shipped" in libs:
        for label, dm, view, _ in cases:
            push_rows(dm, view, lib=libs["shipped"])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    push_rows(dm, view, lib=libs["shipped"])
                torch.cuda.synchronize()
            parts = [(e.key.split("(")[0], e.device_time_total / 10e3)
                     for e in prof.key_averages() if e.device_time_total > 0]
            t0 = time.perf_counter()
            for _ in range(200):
                push_rows(dm, view, lib=libs["shipped"])
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"[shipped] {label} device ms a call: "
                  + "; ".join(f"{k} {t:.4f}" for k, t in parts)
                  + f"; host time to issue a call {host_us:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
