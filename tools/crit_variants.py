#!/usr/bin/env python3
"""Time variants of the frontier reduction's fold on one CUDA card.

    python3 tools/crit_variants.py [--variants a,b,...]

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``. Builds ``src/repro_torch/kernels/csrc/frontier_crit.cu`` once as
it stands and once per variant (a text edit of its ``nan_min``, below),
every ``nvcc`` at once, into the git-ignored ``build/variants/``. Then, on
the inputs of phase 200 of the B = 8 default solve on G(10^6, 10^-4) (keys:
the shared ``out_min_static``) and of phase 100 of the ``in|out`` solve
(keys: the per-lane ``out_full``), it calls each library's
``frontier_crit_lanes_launch`` directly: every variant against the twin
bit for bit (the phase inputs hold no -0, so the rule without the tie
gives the same bits), CUDA-event medians in two rounds (forward, then
backward), and the device time of its first pass from ``torch.profiler``.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# the fold as it ships (PTX min.NaN, one instruction, as the gathers of
# ell_gather.cu fold), and the forms it was chosen against: fminf (which
# takes -0 on a tie on the card) with NaN put back by compares, the compare
# with a sign test for the tie, the compare that ORs the zeros' bits on a
# tie, and the rule without the tie (the form before -0 was handled)
_FOLD = ('  float r;\n  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), '
         '"f"(v));\n  return r;\n')
VARIANTS = {
    "shipped": [],
    "fminf": [(_FOLD, "  return v != v ? v : (m != m ? m : fminf(m, v));\n")],
    "compare_signbit": [(_FOLD, "  return (v < m || v != v || (v == m && "
                                "signbit(v))) ? v : m;\n")],
    "compare_or_tie": [(_FOLD, "  return (v < m || v != v) ? v : (v == m ? "
                               "__int_as_float(__float_as_int(m) | "
                               "__float_as_int(v)) : m);\n")],
    "no_tie": [(_FOLD, "  return (v < m || v != v) ? v : m;\n")],
}


def variant_source(src: str, edits: list) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("crit_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import criteria as C
    from repro_torch.core import to_ell_in, to_ell_out
    from repro_torch.core.static_engine import init_batch_state, step_batch
    from repro_torch.graphs import uniform_gnp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import frontier_crit as fc
    from repro_torch.kernels.config import CRIT_ITEMS, CRIT_THREADS
    from repro_torch.kernels.ell_relax_keys import ell_keys_dep_batch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_split, same_bits, time_ms

    src = (_build.CSRC / "frontier_crit.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"crit_{name}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        so = out_dir / f"crit_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in fc._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    g = uniform_gnp(1_000_000, 1e-4, seed=0, device=dev)
    ell_in, ell_out = to_ell_in(g), to_ell_out(g)
    sources = np.random.default_rng(1).integers(0, g.n, 16)[:8]
    st = step_batch(g, init_batch_state(g, sources, device=dev), 200,
                    ell=ell_in, ell_out=ell_out)
    inputs = {"default phase 200, shared keys":
              (st.dist, st.status, g.out_min_static[None].contiguous())}
    spec = {k.name: k for k in C.plan_for("in|out").keys}
    st = step_batch(g, init_batch_state(g, sources, criterion="in|out",
                                        device=dev), 100,
                    ell=ell_in, ell_out=ell_out)
    gate = C.key_gate(spec["out_dyn"], st.status, g.in_min_static,
                      g.out_min_static, {})[None].contiguous()
    dga, dgb = C.dep_gate_parts(spec["out_full"], st.status)
    keys = ell_keys_dep_batch(gate, dga, dgb, *ell_out)[1][None].contiguous()
    inputs["in|out phase 100, per-lane keys"] = (st.dist, st.status, keys)

    def case(lib, d, status, keys):
        b, n = d.shape
        k = keys.shape[0]
        nblk = -(-n // (CRIT_THREADS * CRIT_ITEMS))
        part_min = torch.empty((1 + k, b, nblk), device=dev)
        part_cnt = torch.empty((b, nblk), dtype=torch.int32, device=dev)
        mins = torch.empty((1 + k, b), device=dev)
        cnt = torch.empty((b,), dtype=torch.int32, device=dev)
        key_sk, key_sb = (n, 0) if keys.dim() == 2 else (b * n, n)

        def call():
            rc = lib.frontier_crit_lanes_launch(
                d.data_ptr(), status.data_ptr(), keys.data_ptr(), n, b, k,
                key_sk, key_sb, CRIT_THREADS, CRIT_ITEMS, nblk,
                part_min.data_ptr(), part_cnt.data_ptr(), mins.data_ptr(),
                cnt.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return call, (mins, cnt)

    for label, (d, status, keys) in inputs.items():
        want = ref.frontier_crit_lanes_batch_ref(d, status, keys)
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                call, got = case(libs[name], d, status, keys)
                call()
                torch.cuda.synchronize()
                if not all(same_bits(a, w) for a, w in zip(got, want)):
                    raise SystemExit(f"{name} differs from the twin: {label}")
                ms = time_ms(call, reps=50)
                first = sum(t for k, t in device_split(call, calls=10)
                            if k.startswith("crit_partial"))
                print(f"[{name}] {label}, round {rnd}: {ms:.4f} ms a call "
                      f"(events), first pass {first:.4f} ms on the device",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
