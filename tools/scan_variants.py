#!/usr/bin/env python3
"""Time variants of the fused scans' pipelined body on one CUDA card.

    python3 tools/scan_variants.py [--variants a,b,...] [--no-sliced]

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``. Builds ``src/repro_torch/kernels/csrc/ell_gather.cu`` once as it
stands and once per variant (a changed ``#define`` or a small text edit,
below), every ``nvcc`` at once, into the git-ignored ``build/variants/``.
Then, on the inputs of phase 100 of the B = 8 ``in|out`` solve on
G(10^6, 10^-4) (the inputs ``chip_smoke.py`` phase 11 times), it calls each
library's ``ell_relax_keys_launch`` and ``ell_keys_dep_launch`` directly,
and on the inputs of phase 41 of the B = 8 sliced ``in|out`` solve on
``kronecker(20)`` (about 90 s to generate; ``--no-sliced`` leaves it out)
its ``ell_sliced_relax_keys_launch`` (the pull form) and
``ell_sliced_keys_dep_launch``, with unit tables built for the variant's
constants: every variant against the twins bit for bit (the cuts
excepted, which leave work out on purpose), CUDA-event medians in two
rounds (forward, then backward), and each fused call's device time by
kernel from ``torch.profiler``. The dense single sweeps of
``ell_gather_min_batch`` (the out_dyn gate over the out-ELL) and
``ell_key_min_batch`` (the in_dyn gate over the in-ELL) on the same phase
go through ``ell_gather_min_launch`` (and, read from the lanes' status,
``ell_gather_min_status_launch``) the same way, every variant, and the
shipped build's pipelined body, f32 and status table, in turns with the
single-sweep body it replaced there. Last, the shipped build's out-scan on the first 1, 2, 4 and 8 lanes
(a packed table of 4-32 MB). Exits non-zero without a card.

The module also holds the reference's split form of the two fused scans
(``split_in_scan``, ``split_out_scan``, and ``split_scans``, which puts
them in place of ``repro_torch.kernels.ops``' scans for a ``with`` block):
the single sweeps #1, #6 and #9 with the gate between them in torch, the
same bits as the fused kernels. ``chip_smoke.py`` and the CPU tests hold
the fused scans against it.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
INF = float("inf")

_LOAD = "            load_lanes<WL>(ptile + (long long)cu[u] * W, v[u]);\n"
_ANCHOR = ("// One sweep of the pipelined body: every row's min for every lane, "
           "written\n")
_ACC = "  int stage = 0;\n  unsigned parity = 0;\n  float acc[WL];\n"


def _gather_with(asm_load: str, policy: str = "") -> list:
    """Text edits that swap the scan's gather for a float4 load in inline
    PTX (``asm_load`` reads %4 and, with ``policy``, the policy %5)."""
    helper = (
        "__device__ __forceinline__ void load4_x(const float* p, float* v, "
        "unsigned long long pol) {\n"
        f'  asm volatile("{asm_load}" : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), '
        '"=f"(v[3]) : "l"(p), "l"(pol));\n}\n'
        "template <int W>\n"
        "__device__ __forceinline__ void load_x(const float* p, float* v, "
        "unsigned long long pol) {\n"
        "  if constexpr (W < 4) { load_lanes<W>(p, v); }\n"
        "  else { for (int q = 0; q < W / 4; ++q) load4_x(p + 4 * q, v + 4 * q,"
        " pol); }\n}\n")
    make = (f'  unsigned long long pol = 0;\n  asm volatile("{policy}" : '
            '"=l"(pol));\n') if policy else "  unsigned long long pol = 0;\n"
    return [(_ANCHOR, helper + _ANCHOR), (_ACC, _ACC + make),
            (_LOAD, _LOAD.replace("load_lanes<WL>(", "load_x<WL>(")
             .replace("v[u]);", "v[u], pol);"))]


# the sparse sweep with one thread a slot (its gathers are few, its checks
# many)
_SKIP_H1 = [("  constexpr int H = W > 4 ? W / 4 : 1;\n",
             "  constexpr int H = W > 4 && !SKIP ? W / 4 : 1;\n"),
            ("  g.tpr = W > 4 ? W / 4 : 1;",
             "  g.tpr = W > 4 && !SKIP ? W / 4 : 1;")]

# the folds' min, shipped as PTX's min.NaN (one instruction), against the
# explicit compares it replaced: the rule with the sign test for a tie of
# -0 and +0, and the one without it (the phase inputs hold no -0, so the
# bits stay the twins')
_NAN_MIN = ('  float r;\n  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), '
            '"f"(v));\n  return r;\n')
_NAN_MIN_COMPARE = [(_NAN_MIN, "  return (v < m || v != v || (v == m && "
                               "signbit(v))) ? v : m;\n")]
_NAN_MIN_NO_TIE = [(_NAN_MIN, "  return (v < m || v != v) ? v : m;\n")]


# name -> ({macro: value}, [(old text, new text)], bits must equal the twin)
VARIANTS = {
    "shipped": ({}, [], True),
    "nan_min_compare": ({}, _NAN_MIN_COMPARE, True),
    "nan_min_no_tie": ({}, _NAN_MIN_NO_TIE, True),
    "stages3": ({"SCAN_STAGES": 3}, [], True),
    "blocks3": ({"SCAN_BLOCKS_PER_SM": 3}, [], True),
    "cap2560_blocks3": ({"SCAN_CAP": 2560, "SCAN_BLOCKS_PER_SM": 3}, [], True),
    "unroll4": ({"SCAN_UNROLL": 4}, [], True),
    "skip_warps8": ({"SCAN_SKIP_WARPS": 8}, [], True),
    "skip_h1": ({}, _SKIP_H1, True),
    "skip_h1_warps8": ({"SCAN_SKIP_WARPS": 8}, _SKIP_H1, True),
    "skip_h1_warps12": ({"SCAN_SKIP_WARPS": 12}, _SKIP_H1, True),
    "skip_bits_global": ({}, [
        ("  const bool bits_in_smem = SKIP && (long long)smem + 4 * words <= "
         "smem_max;\n", "  const bool bits_in_smem = false;\n")], True),
    # the sparse sweep as two blocks of 8 warps an SM, its bitmap read
    # through the L1
    "skip_two_blocks": ({"SCAN_SKIP_WARPS": 8}, [
        ("  const bool bits_in_smem = SKIP && (long long)smem + 4 * words <= "
         "smem_max;\n", "  const bool bits_in_smem = false;\n"),
        ("  static constexpr int blocks = SKIP ? 1 : SCAN_BLOCKS_PER_SM;",
         "  static constexpr int blocks = SKIP ? 2 : SCAN_BLOCKS_PER_SM;")],
        True),
    # the sliced scans with every row into the scratch and the merge over
    # every vertex (the single-sweep body's merge) instead of write-through
    "sliced_no_write_through": ({"SLICED_WRITE_THROUGH": 0}, [], True),
    # the sliced in-scan's relax sweep on the pipelined body (the sparse
    # shape, bitmap in shared memory) instead of the single-sweep body
    "sliced_relax_pipelined": ({"SLICED_RELAX_PIPELINED": 1}, [], True),
    "no_evict_first": ({}, [
        ('".L2::cache_hint [%0], [%1], %2, [%3], %4;"',
         '" [%0], [%1], %2, [%3];"'),
        (', "r"(bar), "l"(policy)\n', ', "r"(bar)\n')], True),
    "gather_cg": ({}, _gather_with(
        "ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"), True),
    "gather_no_allocate": ({}, _gather_with(
        "ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"), True),
    "gather_evict_last": ({}, _gather_with(
        "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;",
        "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"), True),
    # cuts: the ring alone (consumers skip their rows), and the ring with
    # the shared-memory reads and bitmap checks but no gathers
    "cut_ring_only": ({}, [("    if (row_l < nr) {\n", "    if (false) {\n")],
                      False),
    "cut_no_gather": ({}, [("          if (take && valid && BITS) {\n",
                            "          if (false) {\n"),
                           ("          } else if (take && valid) {\n",
                            "          } else if (false) {\n")], False),
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
            raise SystemExit(f"no #define {name} in ell_gather.cu")
    return src


def shape_of(defines: dict) -> dict:
    """The unit-table constants of a variant's build (``scan_units``'s
    keywords), from its ``#define``s."""
    names = {"SCAN_CAP": "cap", "SCAN_WARPS": "warps",
             "SCAN_SKIP_WARPS": "skip_warps"}
    return {names[k]: v for k, v in defines.items() if k in names}


def split_in_scan(d, settle_mask, gate_parts, ell, *, out_view=None,
                  use_kernels=True):
    """``ops.in_scan_relax_keys_batch`` in the reference's split form: the
    relax sweep (``ops.relax_settled_batch``, #1, on the padded view;
    ``ops.relax_settled_batch_sliced``, #9 with its skip of all-+inf
    columns, on a sliced one; ``out_view`` is not used, the split form
    pulls), the post-phase gate ``min(ga, gb, gc + fin(upd))`` in torch,
    then one gather of the K gates (#6 or #9). ``use_kernels=False`` runs
    the fused form's twins."""
    import torch

    from repro_torch.kernels import ops, ref

    if not use_kernels:
        return _fused("in")(d, settle_mask, gate_parts, ell,
                            out_view=out_view, use_kernels=False)
    if ops._is_sliced(ell):
        upd = ops.relax_settled_batch_sliced(d, settle_mask, ell)
    else:
        upd = ops.relax_settled_batch(d, settle_mask, ell[0], ell[1])
    ga, gb, gc = (torch.stack([p[i] for p in gate_parts]) for i in range(3))
    fin = torch.where(upd < INF, 0.0, INF)
    gates = ref.nan_min(ga, ref.nan_min(gb, gc + fin[None]))
    return upd, _fused("out")(gates, None, ell)


def split_out_scan(gates, dep_parts, ell, *, use_kernels=True):
    """``ops.out_scan_keys_batch`` in the reference's split form: the
    independent keys by one gather (#6 or #9: the out-scan with no
    dependent key), then the dependent key by a second gather over the
    gate ``min(dga, dgb + keys[dep_idx])`` built in torch.
    ``use_kernels=False`` runs the fused form's twins."""
    import torch

    from repro_torch.kernels import ref

    gather = _fused("out")
    if dep_parts is None or not use_kernels:
        return gather(gates, dep_parts, ell, use_kernels=use_kernels)
    dga, dgb, dep_idx = dep_parts
    keys0 = gather(gates, None, ell)
    gate = ref.nan_min(dga, dgb + keys0[dep_idx])
    return torch.cat([keys0, gather(gate[None], None, ell)], dim=0)


_FUSED: dict = {}


def _fused(side: str):
    """The package's own scan of ``side`` (``in`` or ``out``), also while
    :func:`split_scans` has swapped it out."""
    from repro_torch.kernels import ops

    if side in _FUSED:
        return _FUSED[side]
    return ops.in_scan_relax_keys_batch if side == "in" else \
        ops.out_scan_keys_batch


@contextlib.contextmanager
def split_scans():
    """Run every engine's two-sweep scans in the split form inside the
    block: ``ops.in_scan_relax_keys_batch`` (and so its bound-gated form)
    and ``ops.out_scan_keys_batch`` are swapped for :func:`split_in_scan`
    and :func:`split_out_scan`, and put back on exit."""
    from repro_torch.kernels import ops

    _FUSED["in"], _FUSED["out"] = (ops.in_scan_relax_keys_batch,
                                   ops.out_scan_keys_batch)
    ops.in_scan_relax_keys_batch = split_in_scan
    ops.out_scan_keys_batch = split_out_scan
    try:
        yield
    finally:
        ops.in_scan_relax_keys_batch = _FUSED.pop("in")
        ops.out_scan_keys_batch = _FUSED.pop("out")


def rounds(names, cases):
    """Each variant's ``cases(name)`` -- ``(label, call, bits equal)``
    triples -- checked against the twins once, then timed by CUDA events in
    two rounds (forward, then backward), then split by kernel from
    ``torch.profiler``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_split, time_ms

    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            row = []
            for label, call, ok in cases(name):
                call()
                torch.cuda.synchronize()
                same = ok()
                if VARIANTS[name][2] and not same:
                    raise SystemExit(f"{name} {label} differs from its twin")
                row.append(f"{label} {time_ms(call, reps=20):.4f} ms "
                           f"({'bits equal' if same else 'bits differ: a cut'})")
            print(f"[{name}] round {rnd}: " + ", ".join(row), flush=True)
    for name in names:
        for label, call, _ in cases(name):
            call()
            torch.cuda.synchronize()
            submit = []
            for _ in range(5):  # host time to issue a call, kernels queued
                t0 = time.perf_counter()
                call()
                submit.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):  # back to back: no host wait between calls
                call()
            e1.record()
            e1.synchronize()
            print(f"[{name}] {label} host ms to issue a call: "
                  f"{np.median(submit):.4f}; ten calls back to back "
                  f"{e0.elapsed_time(e1) / 10:.4f} ms a call", flush=True)
            parts = device_split(call)
            print(f"[{name}] {label} device ms a call: "
                  + "; ".join(f"{k} {t:.4f}" for k, t in parts)
                  + f"; sum {sum(t for _, t in parts):.4f}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--no-sliced", action="store_true")
    args = parser.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import criteria as C
    from repro_torch.core import (
        to_ell_in,
        to_ell_in_sliced,
        to_ell_out,
        to_ell_out_sliced,
    )
    from repro_torch.core.static_engine import init_batch_state, step_batch
    from repro_torch.graphs import kronecker, uniform_gnp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ell_relax_keys as erk
    from repro_torch.kernels import ell_sliced as esl
    from repro_torch.kernels.ell_relax_keys import ell_keys_dep_batch
    from repro_torch.kernels.ell_sliced import ell_sliced_keys_dep_batch
    from repro_torch.kernels.config import RELAX_THREADS, relax_threads_per_row
    from repro_torch.kernels.ops import pad_lane_batch as ops_pad
    from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_summary, same_bits, time_ms

    src = (_build.CSRC / "ell_gather.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        defines, edits, _ = VARIANTS[name]
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, defines, edits))
        so = out_dir / f"{name}.so"
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
            if fn.startswith("void scan_kernel<8"):
                print(f"[{name}] ptxas {fn}: {info}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in erk._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    spec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def phase_inputs(graph, ell_in, ell_out, keys_dep, phase):
        """The fused scans' inputs of one phase of the B = 8 in|out solve."""
        sources = np.random.default_rng(1).integers(0, graph.n, 16)[:8]
        st = init_batch_state(graph, sources, criterion="in|out", device=dev)
        st = step_batch(graph, st, phase, ell=ell_in, ell_out=ell_out)
        d, status = st.dist, st.status
        g_od = C.key_gate(spec["out_dyn"], status, graph.in_min_static,
                          graph.out_min_static, {})[None].contiguous()
        dga, dgb = C.dep_gate_parts(spec["out_full"], status)
        keys = keys_dep(g_od, dga, dgb)
        mins, _ = frontier_crit_lanes_batch(d, status,
                                            keys[1][None].contiguous())
        settle = C.plan_union_mask(
            st.plan, d, status == 1, mins,
            {"in_full": st.crit_keys[0], "out_dyn": keys[0],
             "out_full": keys[1]}, graph.in_min_static, None)
        dmask = torch.where(settle, d, INF)
        ga, gb, gc = (p[None].contiguous() for p in C.in_scan_gate_parts(
            spec["in_full"], status, settle, graph.in_min_static[None]))
        print(f"inputs: phase {int(st.trips)} of the in|out B=8 solve, "
              f"{int(settle.sum())} settled", flush=True)
        return dmask, ga, gb, gc, g_od, dga, dgb, status

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    g = uniform_gnp(1_000_000, 1e-4, seed=0, device=dev)
    cols, ws = to_ell_in(g)
    cols_o, ws_o = to_ell_out(g)
    dmask, ga, gb, gc, g_od, dga, dgb, status_io = phase_inputs(
        g, (cols, ws), (cols_o, ws_o),
        lambda *a: ell_keys_dep_batch(*a, cols_o, ws_o), 100)
    n, b = g.n, dmask.shape[0]
    w_upd, w_keys = ref.ell_relax_keys_batch_ref(dmask, ga, gb, gc, cols, ws)
    w_dep = ref.ell_keys_dep_batch_ref(g_od, dga, dgb, 0, cols_o, ws_o)

    def relax_keys(lib):
        upd = torch.empty((b, n), device=dev)
        k = torch.empty((1, b, n), device=dev)
        packed = erk.packed_scratch(b, n + 1, dev)
        live = erk.live_bits_scratch(n + 1, dev)

        def call():
            checked(lib.ell_relax_keys_launch(
                dmask.data_ptr(), ga.data_ptr(), gb.data_ptr(), gc.data_ptr(),
                n, b, 1, cols.data_ptr(), ws.data_ptr(), cols.shape[1],
                packed.data_ptr(), live.data_ptr(), upd.data_ptr(),
                k.data_ptr(), stream()))
        return ("relax_keys", call,
                lambda: same_bits(upd, w_upd) and same_bits(k, w_keys))

    def keys_dep(lib, lanes=b):
        gates = g_od[:, :lanes].contiguous()
        da, db = dga[:lanes].contiguous(), dgb[:lanes].contiguous()
        out = torch.empty((2, lanes, n), device=dev)
        packed = erk.packed_scratch(lanes, n + 1, dev)

        def call():
            checked(lib.ell_keys_dep_launch(
                gates.data_ptr(), da.data_ptr(), db.data_ptr(), n, lanes, 1, 0,
                cols_o.data_ptr(), ws_o.data_ptr(), cols_o.shape[1],
                packed.data_ptr(), out.data_ptr(), stream()))
        return "keys_dep", call, lambda: same_bits(out, w_dep)

    rounds(names, lambda nm: [relax_keys(libs[nm]), keys_dep(libs[nm])])

    # the dense single sweeps: #6 on the out_dyn gate, #5 on the in_dyn gate
    g_id = ops_pad(C.key_gate(spec["in_dyn"], status_io, g.in_min_static,
                              g.out_min_static, {}))
    w_gm = ref.ell_gather_min_batch_ref(g_od, cols_o, ws_o)
    w_km = ref.ell_key_min_batch_ref(g_id, cols, ws)

    def dense(lib, label, vec, n_src, c, w, want, body=0):
        lanes = vec.numel() // n_src
        out = torch.empty_like(want)
        packed = erk.packed_scratch(lanes, n + 1, dev)
        tpr, threads = ((relax_threads_per_row(c.shape[1]), RELAX_THREADS)
                        if body else (0, 0))

        def call():
            checked(lib.ell_gather_min_launch(
                vec.data_ptr(), n_src, n + 1, lanes, c.data_ptr(),
                w.data_ptr(), c.shape[0], c.shape[1], tpr, threads,
                packed.data_ptr(), None, out.data_ptr(), stream()))
        return label, call, lambda: same_bits(out, want)

    def dense_status(lib, label, c, w, want):
        """(b): the same sweep read from status (the status-gate table)."""
        out = torch.empty_like(want).reshape(b, -1)
        bits = torch.empty((n + 1,), dtype=torch.uint8, device=dev)

        def call():
            checked(lib.ell_gather_min_status_launch(
                status_io.data_ptr(), n, n + 1, b, c.data_ptr(), w.data_ptr(),
                c.shape[0], c.shape[1], bits.data_ptr(), out.data_ptr(),
                stream()))
        return (label + " (status table)", call,
                lambda: same_bits(out, want.reshape(b, -1)))

    def dense_cases(lib, body=0):
        return [dense(lib, "gather_min", g_od, n, cols_o, ws_o, w_gm, body),
                dense(lib, "key_min", g_id, n + 1, cols, ws, w_km, body),
                dense_status(lib, "gather_min", cols_o, ws_o, w_gm),
                dense_status(lib, "key_min", cols, ws, w_km)]

    rounds(names, lambda nm: dense_cases(libs[nm]))
    if "shipped" in libs:
        shipped = dense_cases(libs["shipped"])
        single = dense_cases(libs["shipped"], body=1)
        for label, old, f32, bits in (("gather_min", single[0], shipped[0],
                                       shipped[2]),
                                      ("key_min", single[1], shipped[1],
                                       shipped[3])):
            for _, call, ok in (old, f32, bits):
                call()
                torch.cuda.synchronize()
                if not ok():
                    raise SystemExit(f"{label} differs from its twin")
            turns = [time_ms(c, reps=20) for c in
                     (old[1], f32[1], bits[1], bits[1], f32[1], old[1])]
            print(f"[shipped] {label} in turns (single-sweep body, "
                  "pipelined f32, pipelined status table, status table, "
                  "f32, single-sweep body): "
                  + ", ".join(f"{t:.4f}" for t in turns) + " ms", flush=True)
    if "shipped" in libs:
        for lanes in (1, 2, 4, 8):
            _, call, _ = keys_dep(libs["shipped"], lanes)
            print(f"[shipped] keys_dep on {lanes} lanes (packed table "
                  f"{lanes * 4 * (n + 1) / 1e6:.0f} MB): "
                  f"{time_ms(call, reps=20):.4f} ms")
    del g, cols, ws, cols_o, ws_o, dmask, ga, gb, gc, g_od, dga, dgb
    del w_upd, w_keys, w_dep, g_id, w_gm, w_km, status_io
    if args.no_sliced:
        return 0

    gk = kronecker(20, seed=0, device=dev)
    sl_in, sl_out = to_ell_in_sliced(gk), to_ell_out_sliced(gk)
    dmask, ga, gb, gc, g_od, dga, dgb, _ = phase_inputs(
        gk, sl_in, sl_out,
        lambda *a: ell_sliced_keys_dep_batch(*a, sl_out), 41)
    n = gk.n
    w_upd, w_keys = ref.ell_sliced_relax_keys_batch_ref(dmask, ga, gb, gc,
                                                        sl_in)
    w_dep = ref.ell_sliced_keys_dep_batch_ref(g_od, dga, dgb, 0, sl_out)

    def sliced_relax_keys(name):
        lib, shape = libs[name], shape_of(VARIANTS[name][0])
        plan, relax = esl._ScanPlan(sl_in, **shape), esl._Plan(sl_in)
        t0, t1 = plan.table(b, skip=True), plan.table(b, skip=False)
        upd = torch.empty((b, n), device=dev)
        k = torch.empty((1, b, n), device=dev)
        packed = erk.packed_scratch(b, n + 1, dev)
        live = erk.live_bits_scratch(n + 1, dev)
        partials = relax.partials(b, dev)
        # room for every row: the no-write-through variant puts them all
        # in the scratch
        split = torch.empty((b * sl_in.total_rows,), device=dev)

        def call():
            checked(lib.ell_sliced_relax_keys_launch(
                dmask.data_ptr(), ga.data_ptr(), gb.data_ptr(), gc.data_ptr(),
                n, b, 1, ctypes.addressof(relax.table), relax.n_slices,
                RELAX_THREADS, ctypes.addressof(t0), ctypes.addressof(t1),
                plan.n_buckets, ctypes.addressof(plan.plan), packed.data_ptr(),
                live.data_ptr(), partials.data_ptr(), split.data_ptr(),
                upd.data_ptr(), k.data_ptr(), stream()))
        return ("sliced relax_keys", call,
                lambda: same_bits(upd, w_upd) and same_bits(k, w_keys))

    def sliced_keys_dep(name):
        lib, shape = libs[name], shape_of(VARIANTS[name][0])
        plan = esl._ScanPlan(sl_out, **shape)
        t = plan.table(b, skip=False)
        out = torch.empty((2, b, n), device=dev)
        packed = erk.packed_scratch(b, n + 1, dev)
        split = torch.empty((b * sl_out.total_rows,), device=dev)

        def call():
            checked(lib.ell_sliced_keys_dep_launch(
                g_od.data_ptr(), dga.data_ptr(), dgb.data_ptr(), n, b, 1, 0,
                ctypes.addressof(t), ctypes.addressof(t), plan.n_buckets,
                ctypes.addressof(plan.plan), packed.data_ptr(),
                split.data_ptr(), out.data_ptr(), stream()))
        return "sliced keys_dep", call, lambda: same_bits(out, w_dep)

    print(f"kronecker(20) sliced: in-view rows {sl_in.total_rows} "
          f"({sl_in.split_rows} in the scratch, {sl_in.merge_short.numel()} "
          f"vertices in the short merge), out-view rows {sl_out.total_rows} "
          f"({sl_out.split_rows}, {sl_out.merge_short.numel()})")
    rounds(fused, lambda nm: [sliced_relax_keys(nm), sliced_keys_dep(nm)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
