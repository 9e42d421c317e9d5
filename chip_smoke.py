#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (CUDA
toolkit with ``nvcc`` under ``/usr/local/cuda``). Phases, in order; any
failure raises, exits non-zero and prints no ``ok`` line:

  1. device and build: the card's name, count and power limit; builds every
     CUDA kernel of the path from ``src/repro_torch/kernels/csrc``, and the
     two-pass body ``frontier_crit_lanes_batch`` ran on before (from
     ``tools/crit_variants.py``), to time the two in turns;
  2. kernel parity at full width: the paper's G(n=10^6, p=10^-4) graph
     (~10^8 arcs) and its incoming and outgoing ELL on the card; each kernel
     against its plain PyTorch twin on seeded inputs, compared bit for bit
     (every NaN counts as one value: IEEE leaves NaN payloads open); the
     push relax also against the pull (B = 1, 8, 13, 40, NaN lanes, a dense
     dmask, grid_road); the frontier reduction also on rows of n % 4 = 3
     and 1 and for 50 calls in a row;
  3. the main path, serving: a StaticBackend with 8 lanes answers 16
     requests (reset_lanes -> step -> peek -> take_row), with every
     kernel's launch count set to 0 just before and read just after: the
     relax is the push, no pull relax runs;
  4. end-to-end parity: run_phased_static_batch with the kernels and with
     use_kernels=False give bit-equal results;
  5. an independent check of one row against scipy's Dijkstra (f64, host);
  6. kernel times at the main shape, on the inputs of one real phase of
     the B = 8 solve (CUDA events, median per launch), beside the twin's
     time and the least time the card could take for that input (the
     relax's bound counts the settled vertices' out-rows, dmask and upd);
     push and pull on the same inputs in turns, the push's candidates and
     atomics; then every phase of the default solve: active rows, push and
     pull times, and the densest phase timed in turns; the frontier
     reduction in turns with its two-pass body;
  7. the dynamic-key kernels at full width: each key kernel against its
     twin on dense seeded key gates, bit for bit, and the status-gate table
     (``ell_key_min_status_batch``) against its twin and the f32 path;
  8. the paper's strengthened ``in|out`` criterion, serving: a StaticBackend
     with 8 lanes answers 16 requests, counts set to 0 just before;
  9. ``in|out`` end to end: the B = 8 solve with the kernels and with
     use_kernels=False bit-equal, the served rows equal to it, one row
     against scipy's Dijkstra;
 10. ``insimple|outsimple`` at full width, 64 trips, kernels against twins
     on every state field (the path of the status-gate table), with its
     device split a trip;
 11. the key kernels' times on the inputs of one real phase of the ``in|out``
     solve; the two fused scans (on the pipelined scan body) split by kernel
     with ``torch.profiler``, and their sweeps each timed alone on the
     single-sweep kernels (the body the fused scans ran on before the
     pipelined one): the stream floor, the sparse relax sweep, the dense
     gate sweeps; ``ell_key_min_batch`` and ``ell_gather_min_batch`` in turns
     with the single-sweep body, the status-gate table against the f32
     path, and the frontier reduction with per-lane keys in turns with its
     two-pass body, each bit-checked on these inputs first;
 12. the skewed graph: ``kronecker(20)`` (Graph500 initiator, ~9.1e7 arcs,
     largest in-degree ~3.8e5, so no padded layout fits) and its degree-sliced
     in- and out-views on the card, with their sizes;
 13. the sliced kernels against their twins at full width, bit for bit
     (sparse dmask with the skip on, dense V = 2 gates, K = 1 and 2,
     dep_idx 0 and 1, NaN cases; the fused in-scan with and without the
     out-view, B = 1, 8, 13); the sliced push along the out-view against
     its twin and the sliced pull (B = 1, 8, 13, 40, NaN lanes); then
     signed zeros: every kernel against its twin on both graphs with their
     weights mapped onto {+0, -0, 0.5, 1} and vectors from the same set
     (ties of -0 and +0 in every order, NaN lanes), the pushes also against
     the pulls;
 14. sliced serving: a StaticBackend(layout="sliced") with 8 lanes answers 16
     requests under ``instatic|outstatic``, then ``in|out``, counts set to 0
     just before: the sliced kernels run (the sliced push on the default
     plan, the fused in-scan in its push form on ``in|out``), the padded
     ones do not;
 15. sliced end to end: on kronecker(20) the B = 8 kernel and plain solves
     bit-equal for both plans, the served rows equal, one row against
     scipy's Dijkstra, the ``in|out`` kernel and plain states a quarter of
     the way bit-equal with their carried keys; on G(10^6, 10^-4)
     layout="sliced" bit-equal to the padded solves of phases 4 and 9;
 16. the sliced kernels' times on the inputs of one real phase (the sliced
     push and pull in turns; the fused scans on the pipelined body in turns
     with the single-sweep body they ran on before, each split by kernel),
     every phase of the sliced default solve as in phase 6, and ms/phase,
     phases per query and queries/s of the sliced solves and serving;
 17. more buckets than one launch takes: G(10^5, 10^-3) sliced into 19
     buckets with rows (each pass runs in two groups): every sliced kernel
     and the sliced push against its twin, and the sliced default and
     ``in|out`` solves against the padded ones, bit for bit.

The second line from the end is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

N, P, SEED = 1_000_000, 1e-4, 0  # the paper's Sec. 6 benchmark graph
LANES = 8
REQUESTS = 16
CHUNK = 64  # phases per step call in the serving loop
MID_PHASE = 200  # the phase whose kernel inputs phase 6 times
DYN_TRIPS = 64  # trips of the insimple|outsimple check (phase 10)
KRON_K = 20  # kronecker(20): the skewed graph of phases 12-16
INF = float("inf")
PUSH_IN_SCAN = "ell_sliced_relax_keys_batch[out_view]"  # #10b's name here
SIGNED = (0.0, -0.0, 0.5, 1.0)  # the values of the signed-zero cases


def log(msg: str):
    print(msg, flush=True)


def load_tool(name: str):
    """A script of ``tools/`` as a module (its kernel variants)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_bits(a, b) -> bool:
    """Bit equality of two tensors, with every NaN taken as one value."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        canon = torch.tensor(float("nan"), device=a.device)
        a = torch.where(torch.isnan(a), canon, a).view(torch.int32)
        b = torch.where(torch.isnan(b), canon, b).view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds per call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(out: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, S bytes smem; stack frame and spills") for
    each entry function in ``nvcc -Xptxas -v`` output, names demangled by
    ``c++filt`` where the host has it."""
    rows, fn, spill = [], None, ""
    for line in out.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], ""
        elif "spill stores" in line and fn is not None:
            spill = line  # "N bytes stack frame, M bytes spill stores, ..."
        elif line.startswith("ptxas info") and "Used" in line and fn:
            rows.append((fn, line.split("Used", 1)[1].strip() + "; " + spill))
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]  # mangled names say the same, less kindly
    return [(nm.split("(")[0], info) for nm, (_, info) in zip(names, rows)]


def device_split(fn, calls: int = 5) -> list[tuple[str, float]]:
    """Device milliseconds a call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls."""
    return [(k, t * c) for k, t, c in device_split_counted(fn, calls)]


def device_split_counted(fn, calls: int = 5) -> list[tuple[str, float, float]]:
    """``(kernel, device ms a launch, launches seen a call)`` of ``fn``
    from ``torch.profiler``. The profiler drops the records of the first
    milliseconds it traces, so one warm-up step goes first; late in a long
    run it still drops some (a kernel launched once a call then shows
    fewer launches), which leaves the time a launch true and makes the
    time a call short."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls),
                 acc_events=True) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [(e.key.split("(")[0], e.device_time_total / e.count / 1e3,
             e.count / calls)
            for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith("ProfilerStep")]


def repeat_wall(fn, first: float, runs: int = 3) -> list:
    """Wall seconds of ``runs`` calls of ``fn``, each ended by a
    synchronize: ``first`` (a call already made) and ``runs - 1`` more."""
    import torch

    walls = [first]
    for _ in range(runs - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def busy_line(fn, wall_s: float, phases: int) -> str:
    """The device time of one call of ``fn`` (its kernels summed, from
    ``torch.profiler``) against a wall time: the device's busy share, and
    the time a phase by kernel, PyTorch's own kernels (the phase glue)
    summed apart (with the copies and memsets)."""
    parts = device_split(fn, calls=1)
    dev_ms = sum(t for _, t in parts)
    ours = ("push_kernel", "push_mark_kernel", "crit_", "gather_min_kernel",
            "scan_kernel", "pack_kernel", "merge_kernel", "short_merge_kernel")
    glue = [(k, t) for k, t in parts if not any(o in k for o in ours)]
    ours = sorted((p for p in parts if p not in glue), key=lambda p: -p[1])
    split = "; ".join(f"{k} {t / phases:.4f}" for k, t in ours)
    return (f"device busy {dev_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
            f"({dev_ms / (wall_s * 1e3):.1%}; {dev_ms / phases:.3f} ms a "
            f"phase on the device: {split}; PyTorch's kernels (the glue, "
            f"{len(glue)} kinds) {sum(t for _, t in glue) / phases:.4f})")


def finite_slots(rows, cols_long) -> int:
    """Lane-slots ``rows[l, cols[r, j]]`` that are finite, over every lane:
    the adds and mins the data needs (a NaN or +inf slot needs none)."""
    import torch

    return int(sum(torch.isfinite(rows[i][cols_long]).sum()
                   for i in range(rows.shape[0])))


def push_load(dmask, out_deg) -> tuple[int, int, int]:
    """(active rows, candidates, bytes of their out-rows) of one relax
    input: the vertices u whose dmask is not +inf in some lane, their
    out-edges times those lanes, and 8 bytes a real out-slot of theirs
    (rows are left-packed, so a row's real slots are its out-degree)."""
    lanes = (dmask != float("inf")).sum(dim=0)
    deg = out_deg.long()
    return (int((lanes > 0).sum()), int((lanes * deg).sum()),
            int(8 * deg[lanes > 0].sum()))


def relax_bound(dmask, out_deg) -> tuple[float, str]:
    """The least time of the relax on this input, push or pull (the same
    function): the settled vertices' out-rows, dmask read and upd written
    once, an add and a min a candidate."""
    _, cand, row_bytes = push_load(dmask, out_deg)
    return bound(row_bytes + 2 * dmask.numel() * 4, 2.0 * cand)


def seeded_push_dmask(rng, b: int, n: int, live: float, dev):
    """(B, n) relax input: d on a share ``live`` of the slots, +inf
    elsewhere, and a NaN in every lane."""
    import torch

    dm = np.full((b, n), np.inf, np.float32)
    on = rng.random((b, n)) < live
    dm[on] = rng.uniform(0.0, 10.0, on.sum()).astype(np.float32)
    dm[np.arange(b), rng.integers(0, n, b)] = np.nan
    return torch.from_numpy(dm).to(dev)


def seeded_state(rng, b: int, n: int, dev):
    """(d, status) with a U/F/S mix and +inf holes, made on the host."""
    import torch

    d = rng.uniform(0.0, 10.0, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.3] = np.inf
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(status).to(dev)


def signed_weights(ws):
    """A view's weights mapped onto {+0, -0, 0.5, 1} by value (w in [0, 1)
    goes to SIGNED[int(4 w)]; +inf stays): an edge keeps one weight in its
    in- and out-view, and ties of -0 and +0 arise in every fold."""
    import torch

    table = torch.tensor(SIGNED, dtype=torch.float32, device=ws.device)
    q = (ws.clamp(0.0, 0.999) * 4).long()
    return torch.where(torch.isfinite(ws), table[q], ws).contiguous()


def signed_vec(rng, shape, dev, inf_frac=0.2, nan=True):
    """Values from {+0, -0, 0.5, 1}, +inf on ``inf_frac`` of the slots, and
    (``nan``) a NaN at three slots of lane 1; made on the host."""
    import torch

    x = np.array(SIGNED, np.float32)[rng.integers(0, len(SIGNED), shape)]
    x[rng.random(shape) < inf_frac] = np.inf
    if nan:
        lane = (slice(None),) * (len(shape) - 2) + (1,)
        x[lane + (rng.integers(0, shape[-1], 3),)] = np.nan
    return torch.from_numpy(x).to(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (
        KEEP_LANE,
        EllSlice,
        out_degrees,
        sliced_ell,
        to_ell_in,
        to_ell_in_sliced,
        to_ell_out,
        to_ell_out_sliced,
    )
    from repro_torch.core import criteria as C
    from repro_torch.core.static_engine import (
        init_batch_state,
        run_phased_static_batch,
        step_batch,
    )
    from repro_torch.graphs import grid_road, kronecker, uniform_gnp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ell_key_min import (
        ell_key_min,
        ell_key_min_batch,
        ell_key_min_status_batch,
    )
    from repro_torch.kernels.ell_relax import (
        ell_push_relax_batch,
        ell_relax,
        ell_relax_batch,
    )
    from repro_torch.kernels import ell_relax_keys as erk
    from repro_torch.kernels.config import RELAX_THREADS, relax_threads_per_row
    from repro_torch.kernels.ell_relax_keys import (
        ell_gather_min_batch,
        ell_keys_dep_batch,
        ell_relax_keys_batch,
    )
    from repro_torch.kernels.ell_sliced import (
        ell_sliced_gather_min_batch,
        ell_sliced_keys_dep_batch,
        ell_sliced_push_relax_batch,
        ell_sliced_relax_keys_batch,
    )
    from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch
    from repro_torch.serving import StaticBackend

    counted = {f.__name__: (f, "launches") for f in (
        ell_relax_batch, frontier_crit_lanes_batch, ell_key_min_batch,
        ell_key_min_status_batch, ell_gather_min_batch, ell_relax_keys_batch, ell_keys_dep_batch,
        ell_sliced_gather_min_batch, ell_sliced_relax_keys_batch,
        ell_sliced_keys_dep_batch, ell_push_relax_batch,
        ell_sliced_push_relax_batch)}
    # #10b: the sliced fused in-scan with the push as its relax sweep
    counted[PUSH_IN_SCAN] = (ell_sliced_relax_keys_batch, "push_launches")

    def zero_counts():
        for f, attr in counted.values():
            setattr(f, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(f, attr) for name, (f, attr) in counted.items()}

    def serve(backend, sources) -> tuple:
        """16 requests through 8 lanes: reset_lanes -> step -> peek ->
        take_row, counts set to 0 just before and read just after."""
        state = backend.init(LANES)
        lane_req = [None] * LANES
        pending = list(range(REQUESTS))
        rows, req_phases = {}, {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        steps = 0
        while pending or any(r is not None for r in lane_req):
            admit = np.full(LANES, KEEP_LANE, np.int64)
            for lane in range(LANES):
                if lane_req[lane] is None and pending:
                    lane_req[lane] = pending.pop(0)
                    admit[lane] = sources[lane_req[lane]]
            if (admit != KEEP_LANE).any():
                state = backend.reset_lanes(state, admit)
            state = backend.step(state, CHUNK, stop_on_lane_finish=True)
            steps += 1
            _, active, phases = backend.peek(state)
            for lane in range(LANES):
                r = lane_req[lane]
                if r is not None and not active[lane]:
                    rows[r] = backend.take_row(state, lane)
                    req_phases[r] = int(phases[lane])
                    lane_req[lane] = None
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        trips = int(state.trips)
        if len(rows) != REQUESTS:
            raise SystemExit(f"{backend.criterion} serving did not answer "
                             "every request")
        return rows, req_phases, counts, serve_s, steps, trips

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # nothing here multiplies;
    torch.backends.cudnn.allow_tf32 = False  # set so no reader has to ask

    # ---- 1. device and build -------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # the two-pass body #2 ran on before (tools/crit_variants.py holds it),
    # built beside the shipped sources to be timed in turns with its
    # redesign
    crit_tool = load_tool("crit_variants")
    with ThreadPoolExecutor(1) as pool:
        two_pass = pool.submit(crit_tool.build, [crit_tool.TWO_PASS],
                               ROOT / "build" / "variants")
        outputs = _build.build(ptxas_info=True)
        two_pass_lib = two_pass.result()[crit_tool.TWO_PASS]
    log(f"build: {sorted(_build.SOURCES)} and #2's two-pass body in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, out in sorted(outputs.items()):
        for fn, info in ptxas_summary(out):
            log(f"  ptxas {name}: {fn}: {info}")

    def crit_turns(d, st, keys, reps=50):
        """#2 in turns with its two-pass body (old, new, new, old) on one
        input, both bit-checked against the twin first: the CUDA-event
        medians, and each form's device ms a call (torch.profiler)."""
        old, got_old = crit_tool.caller(crit_tool.TWO_PASS, two_pass_lib, d,
                                        st, keys)

        def new():
            return frontier_crit_lanes_batch(d, st, keys)

        want = ref.frontier_crit_lanes_batch_ref(d, st, keys)
        old()
        got_new = new()
        torch.cuda.synchronize()
        for label, got in (("two-pass body", got_old), ("kernel", got_new)):
            if not all(same_bits(a, w) for a, w in zip(got, want)):
                raise SystemExit(f"frontier_crit_lanes_batch ({label}) "
                                 "disagrees with its twin")
        turns = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps),
                 time_ms(old, reps)]
        dev_ms = [sum(t for _, t in device_split(f, calls=10))
                  for f in (old, new)]
        return turns, dev_ms

    # ---- 2. kernel parity at full width ----------------------------------
    t0 = time.perf_counter()
    g = uniform_gnp(N, P, seed=SEED, device=dev)
    cols, ws = to_ell_in(g)
    torch.cuda.synchronize()
    n, d_pad = cols.shape
    ell_bytes = cols.numel() * 4 + ws.numel() * 4
    log(f"graph: G(n={N}, p={P}) seed {SEED}: n={g.n}, m={g.m}, D={d_pad}, "
        f"ELL {ell_bytes / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cols_o, ws_o = to_ell_out(g)  # the default plan's relax pushes along it
    torch.cuda.synchronize()
    ell_out_bytes = cols_o.numel() * 4 + ws_o.numel() * 4
    log(f"out-ELL: D_out={cols_o.shape[1]}, {ell_out_bytes / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    out_deg = out_degrees(g)
    gr = grid_road(1024, 1024, seed=0, device=dev)
    cols_r, ws_r = to_ell_in(gr)
    log(f"graph: grid_road seed 0: n={gr.n}, D={cols_r.shape[1]}")

    rng = np.random.default_rng(7)
    d8, st8 = seeded_state(rng, LANES, n, dev)
    dmask8 = kops.pad_lane_batch(torch.where(st8 == 1, d8, float("inf")))
    dmask_nan = dmask8.clone()
    dmask_nan[3, int(cols[5, 0])] = float("nan")  # reaches row 5 of lane 3
    d_nan = d8.clone()
    fringe_cols = torch.nonzero(st8[2] == 1)[:1, 0]
    d_nan[2, fringe_cols] = float("nan")  # a NaN on lane 2's fringe
    d13, st13 = seeded_state(rng, 13, gr.n, dev)
    dmask13 = kops.pad_lane_batch(torch.where(st13 == 1, d13, float("inf")))
    keys_shared = g.out_min_static[None].contiguous()
    keys_lane = torch.from_numpy(
        rng.uniform(0.0, 1.0, (2, LANES, n)).astype(np.float32)).to(dev)
    d1, st1 = d8[:1].contiguous(), st8[:1].contiguous()

    relax_cases = {
        "gnp B=8": (dmask8, cols, ws),
        "gnp B=1": (dmask8[:1].contiguous(), cols, ws),
        "gnp B=3": (dmask8[:3].contiguous(), cols, ws),
        "gnp B=8 NaN": (dmask_nan, cols, ws),
        "grid_road D=8 B=13": (dmask13, cols_r, ws_r),
    }
    crit_cases = {
        "gnp K=0": (d8, st8, None),
        "gnp K=1 shared": (d8, st8, keys_shared),
        "gnp K=2 per-lane": (d8, st8, keys_lane),
        "gnp B=1 K=1 shared": (d1, st1, keys_shared),
        "gnp K=1 shared NaN": (d_nan, st8, keys_shared),
        "grid_road B=13 K=1 shared": (d13, st13, gr.out_min_static[None]),
    }
    for cut in (1, 3):  # rows of n - 1 and n - 3 vertices: n % 4 = 3, 1
        m_ = n - cut
        crit_cases[f"gnp n % 4 = {m_ % 4} K=1 shared"] = (
            d8[:, :m_].contiguous(), st8[:, :m_].contiguous(),
            keys_shared[:, :m_].contiguous())
        crit_cases[f"gnp n % 4 = {m_ % 4} K=2 per-lane"] = (
            d8[:, :m_].contiguous(), st8[:, :m_].contiguous(),
            keys_lane[:, :, :m_].contiguous())
    errs = {"ell_relax_batch": 0.0, "frontier_crit_lanes_batch": 0.0}
    for label, (dm, c, w) in relax_cases.items():
        got = ell_relax_batch(dm, c, w)
        want = ref.ell_relax_batch_ref(dm, c, w)
        torch.cuda.synchronize()
        ok = same_bits(got, want)
        errs["ell_relax_batch"] = max(errs["ell_relax_batch"],
                                      max_abs_err(got, want))
        log(f"parity ell_relax_batch [{label}]: {'bits equal' if ok else 'DIFFER'}"
            f" (NaN out: {int(torch.isnan(got).sum())})")
        if not ok:
            raise SystemExit(f"ell_relax_batch disagrees with its twin: {label}")
    got = ell_relax(dmask8[4], cols, ws)
    want = ref.ell_relax_ref(dmask8[4], cols, ws)
    if not same_bits(got, want):
        raise SystemExit("ell_relax (the B = 1 view) disagrees with its twin")
    log("parity ell_relax [gnp 1-D view]: bits equal")

    def check_push(name, label, dm, out_view, pull, deg):
        """The push against its twin and against the pull on one input;
        ``deg`` is the graph's out-degrees."""
        push = (ell_push_relax_batch(dm, *out_view) if name ==
                "ell_push_relax_batch"
                else ell_sliced_push_relax_batch(dm, out_view))
        twin = ref.ell_push_relax_batch_ref(dm, out_view)
        torch.cuda.synchronize()
        ok_twin, ok_pull = same_bits(push, twin), same_bits(push, pull)
        errs[name] = max(errs.get(name, 0.0), max_abs_err(push, twin))
        active, cand, _ = push_load(dm, deg)
        log(f"parity {name} [{label}]: twin "
            f"{'bits equal' if ok_twin else 'DIFFER'}, pull "
            f"{'bits equal' if ok_pull else 'DIFFER'} ({active} active rows, "
            f"{cand} candidates, NaN out: {int(torch.isnan(push).sum())})")
        if not (ok_twin and ok_pull):
            raise SystemExit(f"{name} disagrees with its twin or the pull: "
                             f"{label}")

    pad = kops.pad_lane_batch
    prng = np.random.default_rng(15)
    dm8u = torch.where(st8 == 1, d8, INF)  # a third of the slots finite
    push_cases = {
        "gnp B=8, a third of dmask finite (dense)": dm8u,
        "gnp B=1": dm8u[:1].contiguous(),
        "gnp B=13 NaN lanes": seeded_push_dmask(prng, 13, n, 0.003, dev),
        "gnp B=40 NaN lanes": seeded_push_dmask(prng, 40, n, 0.001, dev),
    }
    for label, dm in push_cases.items():
        check_push("ell_push_relax_batch", label, dm, (cols_o, ws_o),
                   ell_relax_batch(pad(dm), cols, ws), out_deg)
    dm13u = torch.where(st13 == 1, d13, INF)
    check_push("ell_push_relax_batch", "grid_road B=13", dm13u,
               to_ell_out(gr), ell_relax_batch(pad(dm13u), cols_r, ws_r),
               out_degrees(gr))
    del push_cases, dm13u
    for label, (d, st, k) in crit_cases.items():
        mins, cnt = frontier_crit_lanes_batch(d, st, k)
        w_mins, w_cnt = ref.frontier_crit_lanes_batch_ref(d, st, k)
        torch.cuda.synchronize()
        ok = same_bits(mins, w_mins) and same_bits(cnt, w_cnt)
        errs["frontier_crit_lanes_batch"] = max(
            errs["frontier_crit_lanes_batch"], max_abs_err(mins, w_mins))
        log(f"parity frontier_crit_lanes_batch [{label}]: "
            f"{'bits equal' if ok else 'DIFFER'} (NaN out: "
            f"{int(torch.isnan(mins).sum())})")
        if not ok:
            raise SystemExit(
                f"frontier_crit_lanes_batch disagrees with its twin: {label}")
    # 50 calls in a row on alternating inputs, every result held: each call
    # finds the ticket its predecessor put back to 0
    rounds = [crit_cases["gnp K=1 shared"], crit_cases["gnp K=2 per-lane"]]
    wants = [ref.frontier_crit_lanes_batch_ref(*x) for x in rounds]
    outs = [frontier_crit_lanes_batch(*rounds[i % 2]) for i in range(50)]
    torch.cuda.synchronize()
    if not all(same_bits(o[0], wants[i % 2][0])
               and same_bits(o[1], wants[i % 2][1])
               for i, o in enumerate(outs)):
        raise SystemExit("frontier_crit_lanes_batch differs in 50 calls in "
                         "a row")
    log("parity frontier_crit_lanes_batch [50 calls in a row, alternating "
        "shared and per-lane keys]: bits equal")
    del rounds, wants, outs, crit_cases, d, st, k

    # ---- 3. the main path, serving ---------------------------------------
    sources = np.random.default_rng(1).integers(0, g.n, REQUESTS)
    rows, req_phases, launches, serve_s, steps, trips = serve(
        StaticBackend(g, device=dev), sources)
    log(f"serving: {len(rows)} requests answered in {serve_s:.3f} s "
        f"({len(rows) / serve_s:.2f} queries/s), {steps} step calls, "
        f"{trips} trips; phases per request "
        f"{[req_phases[r] for r in range(REQUESTS)]}")
    log(f"serving launches: {launches}")
    for name in ("ell_push_relax_batch", "frontier_crit_lanes_batch"):
        if launches[name] <= 0:
            raise SystemExit(f"the main path never launched {name}")
    pulled = {nm: launches[nm] for nm in ("ell_relax_batch",
                                          "ell_sliced_gather_min_batch",
                                          "ell_sliced_push_relax_batch")}
    if any(pulled.values()):
        raise SystemExit(f"the main path launched another relax: {pulled}")

    # ---- 4. end-to-end parity on the card --------------------------------
    src8 = sources[:LANES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_k = run_phased_static_batch(g, src8, ell=(cols, ws), device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_p = run_phased_static_batch(g, src8, ell=(cols, ws), device=dev,
                                    use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for field in ("dist", "status", "phases", "total_phases"):
        if not same_bits(getattr(res_k, field), getattr(res_p, field)):
            raise SystemExit(f"kernel and plain solves differ in {field}")
    for field in ("sum_fringe", "relax_edges"):
        if not np.array_equal(getattr(res_k, field), getattr(res_p, field)):
            raise SystemExit(f"kernel and plain solves differ in {field}")
    total = int(res_k.total_phases)

    def solve_default():
        return run_phased_static_batch(g, src8, ell=(cols, ws), device=dev)

    walls = repeat_wall(solve_default, solve_s)
    solve_s = float(np.median(walls))
    log(f"e2e: B={LANES} solve with kernels, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls) + f" s, median {solve_s:.3f} s "
        f"({LANES / solve_s:.2f} queries/s, {total} phases, "
        f"{solve_s / total * 1e3:.3f} ms/phase); plain twins {plain_s:.3f} s; "
        f"every BatchedResult field bit-equal")
    log(f"e2e: {busy_line(solve_default, solve_s, total)}")
    log(f"e2e: phases per row {res_k.phases.tolist()}, sum_fringe "
        f"{res_k.sum_fringe.tolist()}, relax_edges {res_k.relax_edges.tolist()}")
    dist_k = res_k.dist.cpu().numpy()
    for i in range(LANES):
        if not np.array_equal(rows[i].view(np.int32), dist_k[i].view(np.int32)):
            raise SystemExit(f"served row {i} differs from the batch solve")
    log("e2e: the 8 served rows equal the batch solve's rows bit for bit")
    del res_p

    # ---- 5. independent check against scipy ------------------------------
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    t0 = time.perf_counter()
    real = torch.isfinite(g.w)
    e_src, e_dst, e_w = g.src[real], g.dst[real], g.w[real]
    order = torch.sort(e_src.long(), stable=True).indices
    indptr = torch.zeros(g.n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(e_src.long(), minlength=g.n), 0)
    csr = sp.csr_matrix(
        (e_w[order].double().cpu().numpy(), e_dst[order].cpu().numpy(),
         indptr.cpu().numpy()), shape=(g.n, g.n))
    want = dijkstra(csr, directed=True, indices=int(src8[0]))
    got = dist_k[0]
    fin = np.isfinite(want)
    same_set = bool((np.isfinite(got) == fin).all())
    close = bool(np.allclose(got[fin], want[fin], rtol=1e-5))
    rel = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1e-30)
    log(f"scipy: row 0 (source {int(src8[0])}) reachable {int(fin.sum())}; "
        f"same reachable set {same_set}, rtol 1e-5 {close}, max rel err "
        f"{float(rel.max()):.3e} ({time.perf_counter() - t0:.1f} s)")
    if not (same_set and close):
        raise SystemExit("row 0 disagrees with scipy's Dijkstra")

    # ---- 6. kernel times at the main shape --------------------------------
    # The kernels' inputs of one real phase: phase MID_PHASE of the B = 8
    # solve above, built with the policy's own ops (crit thresholds, the
    # plan's settle mask, the ops layer's padding).
    st_mid = init_batch_state(g, src8, device=dev)
    st_mid = step_batch(g, st_mid, MID_PHASE, ell=(cols, ws))
    d_mid, s_mid = st_mid.dist, st_mid.status
    mins_mid, nf_mid = kops.crit_thresholds_batch(d_mid, s_mid, keys_shared)
    settle_mid = C.plan_union_mask(st_mid.plan, d_mid, s_mid == 1, mins_mid,
                                   {}, g.in_min_static, None)
    dmask_mid = kops.pad_lane_batch(
        torch.where(settle_mid, d_mid, float("inf")))
    fringe_mid = int(nf_mid.sum())
    cols_long = cols.long()
    live_slots = int(sum(torch.isfinite(dmask_mid[b][cols_long]).sum()
                         for b in range(LANES)))
    del cols_long
    log(f"timing inputs: phase {int(st_mid.trips)} of the B={LANES} solve: "
        f"{int(settle_mid.sum())} settled, {fringe_mid} on the fringe, "
        f"{live_slots} of {LANES * n * d_pad} lane-slots finite")
    # the relax, push and pull, on the same input in turns
    dm_mid = torch.where(settle_mid, d_mid, INF)  # the push's (B, n) input
    check_push("ell_push_relax_batch", f"phase {MID_PHASE} input", dm_mid,
               (cols_o, ws_o), ell_relax_batch(dmask_mid, cols, ws), out_deg)
    push_stats = torch.zeros(2, dtype=torch.int64, device=dev)
    ell_push_relax_batch(dm_mid, cols_o, ws_o, stats=push_stats)
    active_mid, cand_mid, rows_mid = push_load(dm_mid, out_deg)
    relax_turns = [
        time_ms(lambda: ell_relax_batch(dmask_mid, cols, ws), reps=20),
        time_ms(lambda: ell_push_relax_batch(dm_mid, cols_o, ws_o), reps=20),
        time_ms(lambda: ell_push_relax_batch(dm_mid, cols_o, ws_o), reps=20),
        time_ms(lambda: ell_relax_batch(dmask_mid, cols, ws), reps=20),
    ]
    out_ms_r = (relax_turns[0] + relax_turns[3]) / 2
    push_ms = (relax_turns[1] + relax_turns[2]) / 2
    plain_ms_r = time_ms(
        lambda: ref.ell_relax_batch_ref(dmask_mid, cols, ws), reps=5,
        warmup=1)
    push_plain_ms = time_ms(
        lambda: ref.ell_push_relax_batch_ref(dm_mid, (cols_o, ws_o)), reps=5,
        warmup=1)
    b_r, by_r = relax_bound(dm_mid, out_deg)
    stream_b_r, _ = bound(ell_bytes + dmask_mid.numel() * 4 + LANES * n * 4,
                          2.0 * live_slots)
    log(f"relax at phase {MID_PHASE}: {active_mid} active rows "
        f"({active_mid / n:.2%} of the vertices), {cand_mid} candidates, "
        f"{push_stats[1].item()} atomics issued (the kernel's count of "
        f"candidates: {push_stats[0].item()}), out-rows "
        f"{rows_mid / 1e6:.1f} MB")
    log(f"relax at phase {MID_PHASE}, in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in relax_turns) + f" ms; push "
        f"{push_ms:.4f} ms, pull {out_ms_r:.4f} ms; bound (settled out-rows "
        f"+ dmask + upd) {b_r:.4f} ms ({by_r}), the pull's stream of the "
        f"whole in-ELL {stream_b_r:.4f} ms; plain push twin "
        f"{push_plain_ms:.4f} ms, plain pull twin {plain_ms_r:.4f} ms")

    def phase_profile(graph, srcs, ell_in, ell_out, push, pull, pull_prep,
                      deg, label):
        """Every phase of the B = 8 default solve on ``graph``: its relax
        input rebuilt from two consecutive states (d before the phase where
        the phase settled: a phase sets status 2 exactly on its settle
        mask), its active rows and candidates, and one launch of the push
        and of the pull on it, timed by CUDA events in alternating order.
        Returns the densest phase's input and trip."""
        st = init_batch_state(graph, srcs, device=dev)
        act_rows, push_t, pull_t, lost = [], [], [], []
        densest, dense_cand, dense_trip = None, -1, 0
        while True:
            nxt = step_batch(graph, st, 1, ell=ell_in, ell_out=ell_out)
            if int(nxt.trips) == int(st.trips):
                break
            dm = torch.where((nxt.status == 2) & (st.status != 2), st.dist,
                             INF)
            active, cand, _ = push_load(dm, deg)
            prepped = pull_prep(dm)
            order = [("push", push, dm), ("pull", pull, prepped)]
            if len(act_rows) % 2:
                order.reverse()
            t = {}
            for nm, fn, arg in order:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(arg)
                e1.record()
                e1.synchronize()
                t[nm] = e0.elapsed_time(e1)
            act_rows.append(active)
            push_t.append(t["push"])
            pull_t.append(t["pull"])
            if t["push"] >= t["pull"]:
                lost.append((int(nxt.trips), active, t["push"], t["pull"]))
            if cand > dense_cand:
                densest, dense_cand, dense_trip = dm, cand, int(nxt.trips)
            st = nxt
        rows = np.array(act_rows)
        log(f"{label}: {len(rows)} phases; active rows per phase median "
            f"{int(np.median(rows))}, max {int(rows.max())} (phase "
            f"{int(rows.argmax()) + 1}), mean {rows.mean():.1f}; one launch "
            f"a phase: push {np.sum(push_t):.3f} ms in all (max "
            f"{np.max(push_t):.4f}), pull {np.sum(pull_t):.3f} ms in all; the "
            f"push was no faster than the pull in {len(lost)} phases"
            + (": " + "; ".join(f"phase {p} ({a} rows) {x:.4f} vs {y:.4f} ms"
                                for p, a, x, y in lost[:8]) if lost else ""))
        log(f"{label}: densest phase {dense_trip} ({dense_cand} candidates)")
        return densest, dense_trip, rows

    dense_dm, dense_trip, act_rows_g = phase_profile(
        g, src8, (cols, ws), (cols_o, ws_o),
        lambda dm: ell_push_relax_batch(dm, cols_o, ws_o),
        lambda dm: ell_relax_batch(dm, cols, ws), pad, out_deg,
        f"relax profile G(n={N}, p={P}), instatic|outstatic")
    dense_pad = pad(dense_dm)
    dense_turns = [
        time_ms(lambda: ell_relax_batch(dense_pad, cols, ws), reps=10),
        time_ms(lambda: ell_push_relax_batch(dense_dm, cols_o, ws_o), reps=10),
        time_ms(lambda: ell_push_relax_batch(dense_dm, cols_o, ws_o), reps=10),
        time_ms(lambda: ell_relax_batch(dense_pad, cols, ws), reps=10),
    ]
    d_act, d_cand, _ = push_load(dense_dm, out_deg)
    log(f"relax at the densest phase {dense_trip} ({d_act} active rows, "
        f"{d_cand} candidates), in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in dense_turns) + f" ms; bound "
        f"{relax_bound(dense_dm, out_deg)[0]:.4f} ms")
    del dense_dm, dense_pad
    crit_turns_mid, crit_dev_mid = crit_turns(d_mid, s_mid, keys_shared)
    out_ms_c = (crit_turns_mid[1] + crit_turns_mid[2]) / 2
    old_ms_c = (crit_turns_mid[0] + crit_turns_mid[3]) / 2
    plain_ms_c = time_ms(
        lambda: ref.frontier_crit_lanes_batch_ref(d_mid, s_mid, keys_shared),
        reps=20)
    view = dmask_mid[0].contiguous()
    view_ms = time_ms(lambda: ell_relax(view, cols, ws), reps=20)
    view_plain_ms = time_ms(lambda: ref.ell_relax_ref(view, cols, ws),
                            reps=5, warmup=1)
    dense_ms = time_ms(lambda: ell_relax_batch(dmask8, cols, ws), reps=20)
    dense_push_ms = time_ms(lambda: ell_push_relax_batch(dm8u, cols_o, ws_o),
                            reps=10)
    b_c, by_c = bound(
        d_mid.numel() * 4 + s_mid.numel() * 4 + keys_shared.numel() * 4
        + 2 * LANES * 4 + LANES * 4,
        3.0 * fringe_mid)
    b_v, _ = bound(ell_bytes + view.numel() * 4 + n * 4, 2.0 * n * d_pad)
    log(f"frontier_crit_lanes_batch at phase {MID_PHASE} (shared keys), bits "
        f"equal to the twin, in turns (two-pass body, kernel, kernel, "
        f"two-pass body): " + ", ".join(f"{t:.4f}" for t in crit_turns_mid)
        + f" ms: {out_ms_c:.4f} against {old_ms_c:.4f}; device ms a call "
        f"{crit_dev_mid[1]:.4f} against {crit_dev_mid[0]:.4f}; bound "
        f"{b_c:.4f} ms ({by_c}); plain {plain_ms_c:.4f} ms")
    log(f"ell_relax (B = 1 view, lane 0 of the timing inputs, not on the "
        f"main path): {view_ms:.4f} ms, plain {view_plain_ms:.4f} ms, bound "
        f"{b_v:.4f} ms")
    log(f"relax on the seeded parity input (a third of dmask finite, "
        f"{push_load(dm8u, out_deg)[0]} active rows): pull {dense_ms:.4f} ms, "
        f"push {dense_push_ms:.4f} ms")
    del st_mid, dmask_mid, settle_mid, d_mid, s_mid, dm8u, dm_mid

    # ---- 7. the dynamic-key kernels at full width ------------------------
    spec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def gate(name, status, graph=g):
        return C.key_gate(spec[name], status, graph.in_min_static,
                          graph.out_min_static, {})

    def check(name, label, got, twin):
        got = got if isinstance(got, tuple) else (got,)
        twin = twin if isinstance(twin, tuple) else (twin,)
        torch.cuda.synchronize()
        ok = all(same_bits(a, b) for a, b in zip(got, twin))
        errs[name] = max([errs.get(name, 0.0)]
                         + [max_abs_err(a, b) for a, b in zip(got, twin)])
        log(f"parity {name} [{label}]: {'bits equal' if ok else 'DIFFER'} "
            f"(NaN out: {sum(int(torch.isnan(a).sum()) for a in got)})")
        if not ok:
            raise SystemExit(f"{name} disagrees with its twin: {label}")

    # dense seeded gates, as real key gates are: 0 on F, a slack on U
    gate8 = kops.pad_lane_batch(gate("in_full", st8))
    gate_nan = gate8.clone()
    gate_nan[3, int(cols[5, 0])] = float("nan")  # reaches row 5 of lane 3
    gate13 = kops.pad_lane_batch(gate("in_full", st13, gr))
    for label, (gt_, c, w) in {
        "gnp B=8": (gate8, cols, ws),
        "gnp B=1": (gate8[:1].contiguous(), cols, ws),
        "gnp B=3": (gate8[:3].contiguous(), cols, ws),
        "gnp B=8 NaN": (gate_nan, cols, ws),
        "grid_road D=8 B=13": (gate13, cols_r, ws_r),
    }.items():
        check("ell_key_min_batch", label, ell_key_min_batch(gt_, c, w),
              ref.ell_key_min_batch_ref(gt_, c, w))
    row4 = gate8[4].contiguous()
    check("ell_key_min_batch", "gnp 1-D view ell_key_min",
          ell_key_min(row4, cols, ws), ref.ell_key_min_ref(row4, cols, ws))
    # the status-gate table path: the "unsettled" gate read from status,
    # against its twin and against the f32 path on the same gate
    for label, (st_, c, w) in {
        "in-ELL B=8": (st8, cols, ws),
        "out-ELL B=8": (st8, cols_o, ws_o),
        "in-ELL B=1": (st1, cols, ws),
        "grid_road D=8 B=13": (st13, cols_r, ws_r),
    }.items():
        got_ = ell_key_min_status_batch(st_, c, w)
        check("ell_key_min_status_batch", label, got_,
              ref.ell_key_min_status_batch_ref(st_, c, w))
        check("ell_key_min_status_batch", label + ", against the f32 path",
              got_, ell_key_min_batch(kops.pad_lane_batch(
                  torch.where(st_ < 2, 0.0, INF)), c, w))
    del got_
    del gate_nan, gate13, row4
    g_dyn, g_weak = gate("out_dyn", st8), gate("out_weak", st8)
    for label, vecs in {"out-ELL V=1": g_dyn[None],
                        "out-ELL V=2": torch.stack([g_dyn, g_weak])}.items():
        check("ell_gather_min_batch", label,
              ell_gather_min_batch(vecs, cols_o, ws_o),
              ref.ell_gather_min_batch_ref(vecs, cols_o, ws_o))
    settle8 = (st8 == 1) & torch.from_numpy(
        rng.random((LANES, n)) < 0.3).to(dev)
    dm8 = torch.where(settle8, d8, INF)
    parts = [C.in_scan_gate_parts(spec[nm], st8, settle8, g.in_min_static[None])
             for nm in ("in_full", "in_dyn")]
    for k in (1, 2):
        ga, gb, gc = (torch.stack([p[i] for p in parts[:k]]) for i in range(3))
        label = f"in-ELL K={k}"
        if k == 2:
            ga[1, 2, min(int(cols[11, 0]), n - 1)] = float("nan")
            label += " NaN in ga"
        check("ell_relax_keys_batch", label,
              ell_relax_keys_batch(dm8, ga, gb, gc, cols, ws),
              ref.ell_relax_keys_batch_ref(dm8, ga, gb, gc, cols, ws))
    del parts, ga, gb, gc, dm8, settle8
    dga8, dgb8 = C.dep_gate_parts(spec["out_full"], st8)
    for label, (gates, dep) in {
        "out-ELL K0=1 dep_idx=0": (g_dyn[None], 0),
        "out-ELL K0=2 dep_idx=1": (torch.stack([g_weak, g_dyn]), 1),
    }.items():
        check("ell_keys_dep_batch", label,
              ell_keys_dep_batch(gates, dga8, dgb8, cols_o, ws_o, dep_idx=dep),
              ref.ell_keys_dep_batch_ref(gates, dga8, dgb8, dep, cols_o, ws_o))
    del g_dyn, g_weak, gates, dga8, dgb8

    # ---- 8. in|out, serving ---------------------------------------------
    rows_io, req_phases_io, launches_io, serve_io_s, steps_io, trips_io = \
        serve(StaticBackend(g, criterion="in|out", device=dev), sources)
    log(f"in|out serving: {len(rows_io)} requests answered in "
        f"{serve_io_s:.3f} s ({len(rows_io) / serve_io_s:.2f} queries/s), "
        f"{steps_io} step calls, {trips_io} trips; phases per request "
        f"{[req_phases_io[r] for r in range(REQUESTS)]}")
    log(f"in|out serving launches: {launches_io}")
    for name in ("ell_keys_dep_batch", "ell_relax_keys_batch",
                 "ell_key_min_batch", "frontier_crit_lanes_batch"):
        if launches_io[name] <= 0:
            raise SystemExit(f"the in|out path never launched {name}")
    if launches_io["ell_relax_batch"] != 0:
        raise SystemExit("the in|out path launched ell_relax_batch")

    # ---- 9. in|out end to end ---------------------------------------------
    io_kw = dict(ell=(cols, ws), ell_out=(cols_o, ws_o), criterion="in|out",
                 device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_io = run_phased_static_batch(g, src8, **io_kw)
    torch.cuda.synchronize()
    solve_io_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_io_p = run_phased_static_batch(g, src8, use_kernels=False, **io_kw)
    torch.cuda.synchronize()
    plain_io_s = time.perf_counter() - t0
    for field in ("dist", "status", "phases", "total_phases"):
        if not same_bits(getattr(res_io, field), getattr(res_io_p, field)):
            raise SystemExit(f"in|out kernel and plain solves differ in {field}")
    for field in ("sum_fringe", "relax_edges"):
        if not np.array_equal(getattr(res_io, field), getattr(res_io_p, field)):
            raise SystemExit(f"in|out kernel and plain solves differ in {field}")
    del res_io_p
    total_io = int(res_io.total_phases)

    def solve_io():
        return run_phased_static_batch(g, src8, **io_kw)

    walls_io = repeat_wall(solve_io, solve_io_s)
    solve_io_s = float(np.median(walls_io))
    log(f"in|out e2e: {busy_line(solve_io, solve_io_s, total_io)}")
    log(f"in|out e2e: B={LANES} solve with kernels, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls_io) + f" s, median "
        f"{solve_io_s:.3f} s "
        f"({LANES / solve_io_s:.2f} queries/s, {total_io} phases, "
        f"{solve_io_s / total_io * 1e3:.3f} ms/phase); plain twins "
        f"{plain_io_s:.3f} s; every BatchedResult field bit-equal")
    log(f"in|out e2e: phases per row {res_io.phases.tolist()} (instatic|"
        f"outstatic: {res_k.phases.tolist()}), sum_fringe "
        f"{res_io.sum_fringe.tolist()}")
    dist_io = res_io.dist.cpu().numpy()
    for i in range(LANES):
        if not np.array_equal(rows_io[i].view(np.int32),
                              dist_io[i].view(np.int32)):
            raise SystemExit(f"in|out served row {i} differs from the solve")
    log("in|out e2e: the 8 served rows equal the batch solve's rows bit for "
        "bit")
    got = dist_io[0]
    same_set = bool((np.isfinite(got) == fin).all())
    close = bool(np.allclose(got[fin], want[fin], rtol=1e-5))
    rel = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1e-30)
    log(f"in|out scipy: row 0 same reachable set {same_set}, rtol 1e-5 "
        f"{close}, max rel err {float(rel.max()):.3e}")
    if not (same_set and close):
        raise SystemExit("in|out row 0 disagrees with scipy's Dijkstra")
    log(f"finding: in|out and instatic|outstatic dist rows bit-equal: "
        f"{np.array_equal(dist_io.view(np.int32), dist_k.view(np.int32))}")

    # ---- 10. insimple|outsimple at full width, DYN_TRIPS trips ------------
    st0 = init_batch_state(g, src8, criterion="insimple|outsimple", device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    st_k = step_batch(g, st0, DYN_TRIPS, ell=(cols, ws), ell_out=(cols_o, ws_o))
    torch.cuda.synchronize()
    simple_s = time.perf_counter() - t0
    launches_ss = read_counts()
    st_p = step_batch(g, st0, DYN_TRIPS, ell=(cols, ws), ell_out=(cols_o, ws_o),
                      use_kernels=False)
    for field in ("dist", "status", "trips", "phases", "sum_fringe",
                  "relax_edges", "settled_trace", "crit_keys"):
        if not same_bits(getattr(st_k, field), getattr(st_p, field)):
            raise SystemExit(f"insimple|outsimple kernel and plain states "
                             f"differ in {field}")
    if st_k.keys_valid is not st_p.keys_valid:
        raise SystemExit("insimple|outsimple keys_valid differs")
    log(f"insimple|outsimple: {int(st_k.trips)} trips in {simple_s:.3f} s "
        f"({simple_s / int(st_k.trips) * 1e3:.3f} ms/phase); every state "
        f"field bit-equal to the plain twins; launches {launches_ss}")

    def steps_simple():
        return step_batch(g, st0, DYN_TRIPS, ell=(cols, ws),
                          ell_out=(cols_o, ws_o))

    walls_ss = repeat_wall(steps_simple, simple_s)
    simple_s = float(np.median(walls_ss))
    log(f"insimple|outsimple: {DYN_TRIPS} trips, 3 runs "
        + ", ".join(f"{w:.3f}" for w in walls_ss) + f" s, median "
        f"{simple_s / DYN_TRIPS * 1e3:.3f} ms/phase; "
        f"{busy_line(steps_simple, simple_s, DYN_TRIPS)}")
    if launches_ss["ell_key_min_status_batch"] <= 0:
        raise SystemExit("insimple|outsimple never launched "
                         "ell_key_min_status_batch (its out-scan and "
                         "priming read the unsettled gate from status)")
    del st0, st_k, st_p

    # ---- 11. key kernels' times on one real phase of the in|out solve -----
    st_io = init_batch_state(g, src8, criterion="in|out", device=dev)
    st_io = step_batch(g, st_io, total_io // 2, ell=(cols, ws),
                       ell_out=(cols_o, ws_o))
    d_io, s_io = st_io.dist, st_io.status
    g_od = gate("out_dyn", s_io)[None]  # the out-scan's independent gate
    dga_io, dgb_io = C.dep_gate_parts(spec["out_full"], s_io)
    keys_io = ell_keys_dep_batch(g_od, dga_io, dgb_io, cols_o, ws_o)
    thr_keys = keys_io[1][None].contiguous()  # per-lane out_full lanes
    mins_io, nf_io = frontier_crit_lanes_batch(d_io, s_io, thr_keys)
    settle_io = C.plan_union_mask(
        st_io.plan, d_io, s_io == 1, mins_io,
        {"in_full": st_io.crit_keys[0], "out_dyn": keys_io[0],
         "out_full": keys_io[1]}, g.in_min_static, None)
    dmask_io = torch.where(settle_io, d_io, INF)
    ga_io, gb_io, gc_io = (p[None].contiguous() for p in C.in_scan_gate_parts(
        spec["in_full"], s_io, settle_io, g.in_min_static[None]))
    gate_io = kops.pad_lane_batch(gate("in_full", s_io))
    upd_io, _ = ell_relax_keys_batch(dmask_io, ga_io, gb_io, gc_io, cols, ws)
    fin_io = torch.where(upd_io < INF, 0.0, INF)
    gate1_io = torch.minimum(ga_io[0], torch.minimum(gb_io[0], gc_io[0] + fin_io))
    cl_in, cl_out = cols.long(), cols_o.long()
    pad = kops.pad_lane_batch
    fs_km = finite_slots(gate_io, cl_in)
    fs_ga = finite_slots(pad(g_od[0]), cl_out)
    fs_rk = finite_slots(pad(dmask_io), cl_in) + finite_slots(pad(gate1_io),
                                                              cl_in)
    dep_gate = torch.minimum(dga_io, dgb_io + keys_io[0])
    fs_kd = fs_ga + finite_slots(pad(dep_gate), cl_out)
    del cl_in, cl_out, fin_io, upd_io
    log(f"key timing inputs: phase {int(st_io.trips)} of the in|out B="
        f"{LANES} solve: {int(settle_io.sum())} settled, {int(nf_io.sum())} "
        f"on the fringe; finite lane-slots: key_min {fs_km}, gather "
        f"{fs_ga}, relax_keys {fs_rk}, keys_dep {fs_kd}")
    bn = LANES * n * 4  # bytes of one (B, n) f32 vector
    timed = {
        "ell_key_min_batch": (
            lambda: ell_key_min_batch(gate_io, cols, ws),
            lambda: ref.ell_key_min_batch_ref(gate_io, cols, ws),
            bound(ell_bytes + gate_io.numel() * 4 + bn, 2.0 * fs_km)),
        "ell_gather_min_batch": (
            lambda: ell_gather_min_batch(g_od, cols_o, ws_o),
            lambda: ref.ell_gather_min_batch_ref(g_od, cols_o, ws_o),
            bound(ell_out_bytes + 2 * bn, 2.0 * fs_ga)),
        "ell_relax_keys_batch": (
            lambda: ell_relax_keys_batch(dmask_io, ga_io, gb_io, gc_io, cols,
                                         ws),
            lambda: ref.ell_relax_keys_batch_ref(dmask_io, ga_io, gb_io,
                                                 gc_io, cols, ws),
            bound(ell_bytes + 6 * bn, 2.0 * fs_rk)),
        "ell_keys_dep_batch": (
            lambda: ell_keys_dep_batch(g_od, dga_io, dgb_io, cols_o, ws_o),
            lambda: ref.ell_keys_dep_batch_ref(g_od, dga_io, dgb_io, 0,
                                               cols_o, ws_o),
            bound(ell_out_bytes + 5 * bn, 2.0 * fs_kd)),
    }
    # #5 and #6 on the pipelined body, in turns with the single-sweep body
    # they ran on before (the same C entry point, asked for that body), both
    # bit-checked against the twin on these inputs first
    lib_g = erk.library()

    def single_sweep(vecs, n_src, c, w, out):
        lanes = vecs.numel() // n_src
        packed = erk.packed_scratch(lanes, n + 1, dev)
        erk.launch("single sweep", "ell_gather_min_launch", dev,
                   vecs.data_ptr(), n_src, n + 1, lanes, c.data_ptr(),
                   w.data_ptr(), c.shape[0], c.shape[1],
                   relax_threads_per_row(c.shape[1]), RELAX_THREADS,
                   packed.data_ptr(), None, out.data_ptr(), lib=lib_g)
        return out

    old_out = {"ell_key_min_batch": torch.empty((LANES, n), device=dev),
               "ell_gather_min_batch": torch.empty((1, LANES, n), device=dev)}
    single = {
        "ell_key_min_batch": lambda: single_sweep(
            gate_io, n + 1, cols, ws, old_out["ell_key_min_batch"]),
        "ell_gather_min_batch": lambda: single_sweep(
            g_od, n, cols_o, ws_o, old_out["ell_gather_min_batch"]),
    }
    times, single_ms = {}, {}
    for name, (kern, plain, (b_ms, b_by)) in timed.items():
        if name in single:
            want_ = plain()
            check(name, f"in|out phase {int(st_io.trips)} inputs", kern(),
                  want_)
            check(name, f"in|out phase {int(st_io.trips)} inputs, the "
                  "single-sweep body", single[name](), want_)
            del want_
            turns = [time_ms(single[name], reps=20), time_ms(kern, reps=20),
                     time_ms(kern, reps=20), time_ms(single[name], reps=20)]
            single_ms[name] = (turns[0] + turns[3]) / 2
            times[name] = ((turns[1] + turns[2]) / 2,
                           time_ms(plain, reps=3, warmup=1), b_ms, b_by)
            log(f"{name}: in turns (single-sweep body, pipelined, "
                f"pipelined, single-sweep body) "
                + ", ".join(f"{t:.4f}" for t in turns) + f" ms: "
                f"{times[name][0]:.4f} against {single_ms[name]:.4f} "
                f"({times[name][0] / single_ms[name]:.2f}x); plain "
                f"{times[name][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
                f"device ms a call by kernel: " + "; ".join(
                    f"{k} {t:.4f}" for k, t in device_split(kern)))
            continue
        times[name] = (time_ms(kern, reps=20), time_ms(plain, reps=3, warmup=1),
                       b_ms, b_by)
        log(f"{name}: {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    # (b), the status-gate table, against (a), the f32 path, on the
    # "unsettled" gates of the same phase (out_dyn over the out-ELL: the
    # insimple|outsimple out-scan, #6's role; in_dyn over the in-ELL: its
    # priming, #5's role), in turns with the single-sweep body too
    g_in_dyn = pad(gate("in_dyn", s_io))
    status_turns = {}
    for label, c, w, f32, old in (
            ("out-ELL", cols_o, ws_o,
             lambda: ell_gather_min_batch(g_od, cols_o, ws_o)[0],
             lambda: single[
                 "ell_gather_min_batch"]()[0]),
            ("in-ELL", cols, ws,
             lambda: ell_key_min_batch(g_in_dyn, cols, ws),
             lambda: single_sweep(g_in_dyn, n + 1, cols, ws,
                                  old_out["ell_key_min_batch"]))):
        def bits(c=c, w=w):
            return ell_key_min_status_batch(s_io, c, w)

        want_ = ref.ell_key_min_status_batch_ref(s_io, c, w)
        for tag, fn in (("", bits), (", the f32 path", f32),
                        (", the single-sweep body", old)):
            check("ell_key_min_status_batch",
                  f"in|out phase {int(st_io.trips)} {label}{tag}", fn(),
                  want_)
        del want_
        turns = [time_ms(fn, reps=20) for fn in (old, f32, bits, bits, f32,
                                                 old)]
        status_turns[label] = ((turns[2] + turns[3]) / 2,
                               (turns[1] + turns[4]) / 2,
                               (turns[0] + turns[5]) / 2)
        log(f"ell_key_min_status_batch {label}: in turns (single-sweep "
            f"body, f32 pipelined, status table, status table, f32 "
            f"pipelined, single-sweep body) " + ", ".join(
                f"{t:.4f}" for t in turns) + " ms: status table "
            f"{status_turns[label][0]:.4f} against f32 "
            f"{status_turns[label][1]:.4f} and the single-sweep body "
            f"{status_turns[label][2]:.4f}; device ms a call by kernel: "
            + "; ".join(f"{k} {t:.4f}" for k, t in device_split(bits)))
    status_plain_ms = time_ms(
        lambda: ref.ell_key_min_status_batch_ref(s_io, cols_o, ws_o), reps=3,
        warmup=1)
    del old_out, single, g_in_dyn
    # The split of the two fused scans into their sweeps, each timed alone
    # on the single-sweep kernels (the fused scans' earlier body): the
    # stream floor (an all-+inf dmask, every gather skipped), #7's sparse
    # relax sweep and dense gate sweep, #8's two dense gate sweeps.
    inf_mask = torch.full_like(pad(dmask_io), INF)
    split = {
        "stream floor (in-ELL, every gather skipped)":
            lambda: ell_relax_batch(inf_mask, cols, ws),
        "sparse sweep (#7 sweep 0, the relax dmask)":
            lambda: ell_relax_batch(pad(dmask_io), cols, ws),
        "dense sweep (#7 sweep 1, the in_full gate)":
            lambda: ell_gather_min_batch(gate1_io[None], cols, ws),
        "dense sweep (#8 sweep 0, the out_dyn gate)":
            lambda: ell_gather_min_batch(g_od, cols_o, ws_o),
        "dense sweep (#8 sweep 1, the out_full gate)":
            lambda: ell_gather_min_batch(dep_gate[None], cols_o, ws_o),
    }
    split_ms = {label: time_ms(fn, reps=20) for label, fn in split.items()}
    for label, ms in split_ms.items():
        log(f"split: {label}: {ms:.4f} ms (single-sweep kernel)")
    sweeps = list(split_ms.values())
    single_sweeps = {"ell_relax_keys_batch": sweeps[1] + sweeps[2],
                   "ell_keys_dep_batch": sweeps[3] + sweeps[4]}
    for name, ms in single_sweeps.items():
        log(f"split: {name} {times[name][0]:.4f} ms against its two sweeps "
            f"alone on the single-sweep body {ms:.4f} ms; two reads of the "
            f"adjacency bound it at {2 * times[name][2]:.4f} ms")
        log(f"split: {name} device ms a call by kernel: "
            + "; ".join(f"{k} {t:.4f}" for k, t in
                        device_split(timed[name][0])))
    del inf_mask, gate1_io, dep_gate
    row_io = gate_io[0].contiguous()
    km_view_ms = time_ms(lambda: ell_key_min(row_io, cols, ws), reps=20)
    km_view_plain_ms = time_ms(lambda: ref.ell_key_min_ref(row_io, cols, ws),
                               reps=3, warmup=1)
    b_kv, by_kv = bound(ell_bytes + row_io.numel() * 4 + n * 4,
                        2.0 * finite_slots(row_io[None], cols.long()))
    log(f"ell_key_min (B = 1 view, lane 0 of the key timing inputs, not on "
        f"the main path): {km_view_ms:.4f} ms, plain {km_view_plain_ms:.4f} "
        f"ms, bound {b_kv:.4f} ms ({by_kv})")
    crit_turns_io, crit_dev_io = crit_turns(d_io, s_io, thr_keys)
    pl_ms = (crit_turns_io[1] + crit_turns_io[2]) / 2
    pl_old_ms = (crit_turns_io[0] + crit_turns_io[3]) / 2
    b_pl, by_pl = bound(d_io.numel() * 4 + s_io.numel() * 4
                        + thr_keys.numel() * 4 + 3 * LANES * 4,
                        3.0 * int(nf_io.sum()))
    log(f"frontier_crit_lanes_batch with per-lane (1, B, n) keys on the same "
        f"inputs, bits equal to the twin, in turns (two-pass body, kernel, "
        f"kernel, two-pass body): " + ", ".join(f"{t:.4f}" for t in
                                               crit_turns_io)
        + f" ms: {pl_ms:.4f} against {pl_old_ms:.4f}; device ms a call "
        f"{crit_dev_io[1]:.4f} against {crit_dev_io[0]:.4f}; bound "
        f"{b_pl:.4f} ms ({by_pl})")
    del st_io, d_io, s_io, g_od, dga_io, dgb_io, keys_io, thr_keys, mins_io
    del settle_io, dmask_io, ga_io, gb_io, gc_io, gate_io, row_io

    # ---- 12. the skewed graph and its sliced views -------------------------
    t0 = time.perf_counter()
    gk = kronecker(KRON_K, seed=SEED, device=dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sl_in, sl_out = to_ell_in_sliced(gk), to_ell_out_sliced(gk)
    torch.cuda.synchronize()
    log(f"kronecker({KRON_K}) seed {SEED}: n={gk.n}, m={gk.num_real_edges} "
        f"arcs, generated in {gen_s:.1f} s (host numpy), views built in "
        f"{time.perf_counter() - t0:.1f} s")
    for side, view, real_to in (("in", sl_in, gk.dst), ("out", sl_out, gk.src)):
        deg = torch.bincount(real_to[torch.isfinite(gk.w)].long(),
                             minlength=gk.n)
        d_max = int(deg.max())
        padded_bytes = gk.n * (-(-d_max // 8) * 8) * 8
        log(f"  {side}-view: widths {view.widths}, rows per bucket "
            f"{[int(s.rows.shape[0]) for s in view.slices]}, padded slots "
            f"{view.padded_slots} ({view.padded_slots * 8 / 1e9:.3f} GB), "
            f"C={view.merge_idx.shape[1]} (merge_idx "
            f"{view.merge_idx.numel() * 4 / 1e9:.3f} GB, compact form "
            f"{(view.merge_ptr.numel() * 8 + view.merge_pos.numel() * 4) / 1e9:.3f}"
            f" GB); {int((deg == 0).sum())} vertices of degree 0, max degree "
            f"{d_max}: the padded layout would need {padded_bytes:.3e} bytes")
    sl_bytes = sl_in.padded_slots * 8
    sl_out_bytes = sl_out.padded_slots * 8

    def merge_bytes(view):
        return view.merge_ptr.numel() * 8 + view.merge_pos.numel() * 4

    def sliced_finite(vecs, view):
        """Finite lane-slots of a (lanes, n) vector over every bucket."""
        padded = kops.pad_lane_batch(vecs.reshape(-1, vecs.shape[-1]))
        return sum(finite_slots(padded, s.cols.long()) for s in view.slices)

    # ---- 13. sliced kernel parity at full width -----------------------------
    nk = gk.n
    rng = np.random.default_rng(13)
    dk, stk = seeded_state(rng, LANES, nk, dev)
    settle_k = (stk == 1) & torch.from_numpy(rng.random((LANES, nk)) < 0.01).to(dev)
    dmask_k = torch.where(settle_k, dk, INF)[None].contiguous()
    dmask_k_nan = dmask_k.clone()
    dmask_k_nan[0, 3, min(int(sl_in.slices[-1].cols[0, 0]), nk - 1)] = \
        float("nan")
    kspec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def kgate(name, status):
        return C.key_gate(kspec[name], status, gk.in_min_static,
                          gk.out_min_static, {})

    k_dyn, k_weak = kgate("out_dyn", stk), kgate("out_weak", stk)
    for label, (vecs, view, sparse) in {
        "in-view sparse dmask (skip on)": (dmask_k, sl_in, True),
        "in-view sparse dmask NaN (skip on)": (dmask_k_nan, sl_in, True),
        "out-view dense V=2 gates": (torch.stack([k_dyn, k_weak]), sl_out,
                                     False),
    }.items():
        check("ell_sliced_gather_min_batch", label,
              ell_sliced_gather_min_batch(vecs, view, sparse=sparse),
              ref.ell_sliced_gather_min_batch_ref(vecs, view))
    del dmask_k_nan
    out_deg_k = out_degrees(gk)
    for label, dm in {
        "out-view B=8 sparse dmask": dmask_k[0],
        "out-view B=1 NaN lane": seeded_push_dmask(prng, 1, nk, 0.01, dev),
        "out-view B=8 NaN lanes": seeded_push_dmask(prng, 8, nk, 0.01, dev),
        "out-view B=13 NaN lanes": seeded_push_dmask(prng, 13, nk, 0.003,
                                                     dev),
        "out-view B=40 NaN lanes": seeded_push_dmask(prng, 40, nk, 0.001,
                                                     dev),
    }.items():
        check_push("ell_sliced_push_relax_batch", label, dm, sl_out,
                   ell_sliced_gather_min_batch(dm[None], sl_in,
                                               sparse=True)[0], out_deg_k)
    kparts = [C.in_scan_gate_parts(kspec[nm], stk, settle_k,
                                   gk.in_min_static[None])
              for nm in ("in_full", "in_dyn")]
    for k in (1, 2):
        ga, gb, gc = (torch.stack([p[i] for p in kparts[:k]]) for i in range(3))
        label = f"in-view K={k}"
        if k == 2:
            ga[1, 2, min(int(sl_in.slices[0].cols[0, 0]), nk - 1)] = \
                float("nan")
            label += " NaN in ga"
        twin = ref.ell_sliced_relax_keys_batch_ref(dmask_k[0], ga, gb, gc,
                                                   sl_in)
        check("ell_sliced_relax_keys_batch", label,
              ell_sliced_relax_keys_batch(dmask_k[0], ga, gb, gc, sl_in),
              twin)
        check(PUSH_IN_SCAN, label + ", push sweep",
              ell_sliced_relax_keys_batch(dmask_k[0], ga, gb, gc, sl_in,
                                          out_view=sl_out), twin)
    for b_ in (1, 13):  # other lane tiles: one lane, and 8 + 5
        dm_ = seeded_push_dmask(prng, b_, nk, 0.01, dev)
        st_ = stk[:1].expand(b_, -1).contiguous()
        parts_ = [p[None].contiguous() for p in C.in_scan_gate_parts(
            kspec["in_full"], st_, (dm_ != INF) & (st_ == 1),
            gk.in_min_static[None])]
        twin = ref.ell_sliced_relax_keys_batch_ref(dm_, *parts_, sl_in)
        for name, ov in (("ell_sliced_relax_keys_batch", None),
                         (PUSH_IN_SCAN, sl_out)):
            check(name, f"in-view B={b_} K=1 NaN lanes",
                  ell_sliced_relax_keys_batch(dm_, *parts_, sl_in,
                                              out_view=ov), twin)
    del kparts, ga, gb, gc, dm_, st_, parts_, twin
    kdga, kdgb = C.dep_gate_parts(kspec["out_full"], stk)
    kdga_nan = kdga.clone()
    kdga_nan[4, min(int(sl_out.slices[0].cols[0, 0]), nk - 1)] = float("nan")
    for label, (gates, dep, dga_) in {
        "out-view K0=1 dep_idx=0": (k_dyn[None], 0, kdga),
        "out-view K0=2 dep_idx=1": (torch.stack([k_weak, k_dyn]), 1, kdga),
        "out-view K0=2 dep_idx=0 NaN in dga": (torch.stack([k_dyn, k_weak]), 0,
                                               kdga_nan),
    }.items():
        check("ell_sliced_keys_dep_batch", label,
              ell_sliced_keys_dep_batch(gates, dga_, kdgb, sl_out, dep_idx=dep),
              ref.ell_sliced_keys_dep_batch_ref(gates, dga_, kdgb, dep, sl_out))
    del dk, stk, settle_k, dmask_k, k_dyn, k_weak, kdga, kdgb, kdga_nan, gates

    # signed zeros at full width: every kernel against its twin where -0 and
    # +0 tie (XLA's min, and so the reference, takes -0 in either order).
    # Both graphs' views with their weights mapped onto {+0, -0, 0.5, 1} by
    # value, vectors drawn from the same set with +inf and NaN lanes; the
    # pushes also against the pulls over the same edges. A case whose twin
    # holds no zero of either sign tests nothing and fails.
    zrng = np.random.default_rng(16)

    def zcheck(name, label, got, twin):
        zeros = [(t == 0) & torch.signbit(t) for t in
                 (twin if isinstance(twin, tuple) else (twin,))]
        if not (any(bool(z.any()) for z in zeros) and any(
                bool(((t == 0) & ~torch.signbit(t)).any()) for t in
                (twin if isinstance(twin, tuple) else (twin,)))):
            raise SystemExit(f"signed-zero case {name} [{label}] met no tie")
        check(name, f"signed zeros, {label}", got, twin)

    def zsliced(view):
        return sliced_ell([EllSlice(sl.rows, sl.cols, signed_weights(sl.ws))
                           for sl in view.slices], view.merge_idx)

    zin, zout = (cols, signed_weights(ws)), (cols_o, signed_weights(ws_o))
    zb = LANES // 2  # the twins of the K = 2 scans gather (2, B, n, D)
    zd = signed_vec(zrng, (zb, n), dev, inf_frac=0.6)
    zst = torch.from_numpy(zrng.integers(0, 3, (zb, n)).astype(
        np.int32)).to(dev)
    zv = signed_vec(zrng, (2, zb, n), dev)
    zp = [signed_vec(zrng, (2, zb, n), dev, nan=i == 0) for i in range(3)]
    zpull = ell_relax_batch(pad(zd), *zin)
    zcheck("ell_relax_batch", "G(1e6) in-ELL", zpull,
           ref.ell_relax_batch_ref(pad(zd), *zin))
    zcheck("ell_push_relax_batch", "G(1e6) out-ELL",
           ell_push_relax_batch(zd, *zout),
           ref.ell_push_relax_batch_ref(zd, zout))
    if not same_bits(ell_push_relax_batch(zd, *zout), zpull):
        raise SystemExit("the push and the pull differ on signed zeros")
    # lane 0 keeps its -0s, the others hold only +0s: both are some min
    zdc = torch.cat([zd[:1], zd[1:].abs()])
    zkc = torch.cat([zv[:, :1], zv[:, 1:].abs()], dim=1)
    zcheck("frontier_crit_lanes_batch", "per-lane K=2 keys",
           frontier_crit_lanes_batch(zdc, zst, zkc),
           ref.frontier_crit_lanes_batch_ref(zdc, zst, zkc))
    zcheck("ell_key_min_batch", "G(1e6) in-ELL",
           ell_key_min_batch(pad(zv[0]), *zin),
           ref.ell_key_min_batch_ref(pad(zv[0]), *zin))
    zcheck("ell_gather_min_batch", "G(1e6) out-ELL V=2",
           ell_gather_min_batch(zv, *zout),
           ref.ell_gather_min_batch_ref(zv, *zout))
    # an unsettled gate is +0 or +inf, and +0 + -0 is +0: these keys hold
    # no -0, so no tie to meet; the -0 weights still go through the add
    for label, view in (("in-ELL", zin), ("out-ELL", zout)):
        check("ell_key_min_status_batch", f"signed-zero weights, G(1e6) "
              f"{label}", ell_key_min_status_batch(zst, *view),
              ref.ell_key_min_status_batch_ref(zst, *view))
    zcheck("ell_relax_keys_batch", "G(1e6) in-ELL K=2",
           ell_relax_keys_batch(zd, *zp, *zin),
           ref.ell_relax_keys_batch_ref(zd, *zp, *zin))
    zcheck("ell_keys_dep_batch", "G(1e6) out-ELL K0=2 dep_idx=1",
           ell_keys_dep_batch(zv, zp[0][0], zp[1][0], *zout, dep_idx=1),
           ref.ell_keys_dep_batch_ref(zv, zp[0][0], zp[1][0], 1, *zout))
    del zin, zout, zd, zst, zv, zp, zpull, zdc, zkc
    zs_in, zs_out = zsliced(sl_in), zsliced(sl_out)
    zd = signed_vec(zrng, (zb, nk), dev, inf_frac=0.9)
    zv = signed_vec(zrng, (2, zb, nk), dev)
    zp = [signed_vec(zrng, (2, zb, nk), dev, nan=i == 0) for i in range(3)]
    zpull = ell_sliced_gather_min_batch(zd[None], zs_in, sparse=True)[0]
    zcheck("ell_sliced_gather_min_batch", "kronecker in-view sparse",
           zpull, ref.ell_sliced_gather_min_batch_ref(zd[None], zs_in)[0])
    zcheck("ell_sliced_gather_min_batch", "kronecker out-view V=2",
           ell_sliced_gather_min_batch(zv, zs_out),
           ref.ell_sliced_gather_min_batch_ref(zv, zs_out))
    zpush = ell_sliced_push_relax_batch(zd, zs_out)
    zcheck("ell_sliced_push_relax_batch", "kronecker out-view", zpush,
           ref.ell_push_relax_batch_ref(zd, zs_out))
    if not same_bits(zpush, zpull):
        raise SystemExit("the sliced push and pull differ on signed zeros")
    ztwin = ref.ell_sliced_relax_keys_batch_ref(zd, *zp, zs_in)
    zcheck("ell_sliced_relax_keys_batch", "kronecker in-view K=2",
           ell_sliced_relax_keys_batch(zd, *zp, zs_in), ztwin)
    zcheck(PUSH_IN_SCAN, "kronecker in-view K=2, push sweep",
           ell_sliced_relax_keys_batch(zd, *zp, zs_in, out_view=zs_out),
           ztwin)
    zcheck("ell_sliced_keys_dep_batch", "kronecker out-view K0=2 dep_idx=1",
           ell_sliced_keys_dep_batch(zv, zp[0][0], zp[1][0], zs_out,
                                     dep_idx=1),
           ref.ell_sliced_keys_dep_batch_ref(zv, zp[0][0], zp[1][0], 1,
                                             zs_out))
    del zs_in, zs_out, zd, zv, zp, zpull, zpush, ztwin

    # ---- 14. sliced serving on the skewed graph ----------------------------
    has_out = torch.nonzero(out_degrees(gk) >= 1).squeeze(1).cpu().numpy()
    src_k = np.random.default_rng(2).choice(has_out, REQUESTS)
    padded_gathers = ("ell_relax_batch", "ell_key_min_batch",
                      "ell_key_min_status_batch", "ell_gather_min_batch", "ell_relax_keys_batch",
                      "ell_keys_dep_batch", "ell_push_relax_batch")
    served_k, sliced_serve = {}, {}
    # the default plan relaxes by the sliced push and runs no sliced gather;
    # in|out relaxes in the fused in-scan, whose relax sweep is the push
    # along the out-view it holds (#10b), and runs no other push
    for crit, must, never in (
            ("instatic|outstatic", ("ell_sliced_push_relax_batch",),
             ("ell_sliced_gather_min_batch", "ell_sliced_relax_keys_batch",
              PUSH_IN_SCAN, "ell_sliced_keys_dep_batch")),
            ("in|out", ("ell_sliced_gather_min_batch", PUSH_IN_SCAN,
                        "ell_sliced_keys_dep_batch"),
             ("ell_sliced_push_relax_batch", "ell_sliced_relax_keys_batch"))):
        rows_s, ph_s, l_s, s_s, steps_s, trips_s = serve(
            StaticBackend(gk, criterion=crit, layout="sliced", device=dev),
            src_k)
        served_k[crit] = rows_s
        sliced_serve[crit] = (l_s, s_s, ph_s)
        log(f"sliced serving {crit} on kronecker({KRON_K}): {REQUESTS} "
            f"requests in {s_s:.3f} s ({REQUESTS / s_s:.2f} queries/s), "
            f"{steps_s} step calls, {trips_s} trips; phases per request "
            f"{[ph_s[r] for r in range(REQUESTS)]}")
        log(f"sliced serving {crit} launches: {l_s}")
        for name in must + ("frontier_crit_lanes_batch",):
            if l_s[name] <= 0:
                raise SystemExit(f"sliced {crit} serving never launched {name}")
        if any(l_s[name] for name in padded_gathers):
            raise SystemExit(f"sliced {crit} serving launched a padded kernel")
        if any(l_s[name] for name in never):
            raise SystemExit(f"sliced {crit} serving launched one of {never}")

    # ---- 15. end-to-end parity on the sliced layout -------------------------
    src8_k = src_k[:LANES]
    real_k = torch.isfinite(gk.w)
    ek_src, ek_dst, ek_w = gk.src[real_k], gk.dst[real_k], gk.w[real_k]
    order_k = torch.sort(ek_src.long(), stable=True).indices
    indptr_k = torch.zeros(gk.n + 1, dtype=torch.int64, device=dev)
    indptr_k[1:] = torch.cumsum(torch.bincount(ek_src.long(), minlength=gk.n), 0)
    csr_k = sp.csr_matrix(
        (ek_w[order_k].double().cpu().numpy(), ek_dst[order_k].cpu().numpy(),
         indptr_k.cpu().numpy()), shape=(gk.n, gk.n))
    del real_k, ek_src, ek_dst, ek_w, order_k, indptr_k
    t0 = time.perf_counter()
    want_k = dijkstra(csr_k, directed=True, indices=int(src8_k[0]))
    scipy_k_s = time.perf_counter() - t0
    del csr_k
    fin_k = np.isfinite(want_k)
    sliced_solve = {}
    for crit in ("instatic|outstatic", "in|out"):
        kw = dict(criterion=crit, layout="sliced", device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_s = run_phased_static_batch(gk, src8_k, **kw)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_sp = run_phased_static_batch(gk, src8_k, use_kernels=False, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_s, field), getattr(res_sp, field)):
                raise SystemExit(f"sliced {crit} kernel and plain solves "
                                 f"differ in {field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_s, field), getattr(res_sp, field)):
                raise SystemExit(f"sliced {crit} kernel and plain solves "
                                 f"differ in {field}")
        del res_sp
        dist_s = res_s.dist.cpu().numpy()
        for i in range(LANES):
            if not np.array_equal(served_k[crit][i].view(np.int32),
                                  dist_s[i].view(np.int32)):
                raise SystemExit(f"sliced {crit} served row {i} differs from "
                                 "the solve")
        got = dist_s[0]
        same_set = bool((np.isfinite(got) == fin_k).all())
        close = bool(np.allclose(got[fin_k], want_k[fin_k], rtol=1e-5))
        rel = np.abs(got[fin_k] - want_k[fin_k]) / np.maximum(want_k[fin_k],
                                                              1e-30)
        total_s = int(res_s.total_phases)

        def solve_sliced(kw=kw):
            return run_phased_static_batch(gk, src8_k, **kw)

        walls_s = repeat_wall(solve_sliced, solve_s)
        solve_s = float(np.median(walls_s))
        sliced_solve[crit] = (solve_s, total_s, res_s.phases.tolist())
        log(f"sliced e2e {crit}: "
            f"{busy_line(solve_sliced, solve_s, total_s)}")
        log(f"sliced e2e {crit} on kronecker({KRON_K}): B={LANES} solve with "
            f"kernels, 3 runs " + ", ".join(f"{w:.3f}" for w in walls_s)
            + f" s, median {solve_s:.3f} s ({LANES / solve_s:.2f} queries/s, "
            f"{total_s} phases, {solve_s / total_s * 1e3:.3f} ms/phase; phases "
            f"per row {res_s.phases.tolist()}); plain twins {plain_s:.3f} s; "
            f"every BatchedResult field bit-equal; the 8 served rows equal")
        log(f"sliced e2e {crit} scipy: row 0 (source {int(src8_k[0])}) "
            f"reachable {int(fin_k.sum())}, same reachable set {same_set}, "
            f"rtol 1e-5 {close}, max rel err {float(rel.max()):.3e} (scipy "
            f"{scipy_k_s:.1f} s)")
        if not (same_set and close):
            raise SystemExit(f"sliced {crit} row 0 disagrees with scipy")
        if crit == "instatic|outstatic":
            st_k16 = init_batch_state(gk, src8_k, device=dev)
            st_k16 = step_batch(gk, st_k16, total_s // 2, ell=sl_in)
        del res_s
    for crit, padded_res in (("instatic|outstatic", res_k), ("in|out", res_io)):
        res_g = run_phased_static_batch(g, src8, criterion=crit,
                                        layout="sliced", device=dev)
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_g, field), getattr(padded_res, field)):
                raise SystemExit(f"gnp sliced {crit} differs from padded in "
                                 f"{field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_g, field),
                                  getattr(padded_res, field)):
                raise SystemExit(f"gnp sliced {crit} differs from padded in "
                                 f"{field}")
        del res_g
    # the carried keys too: the in|out kernel and plain states a quarter of
    # the way (the plain steps are the slow part), then the kernel state on
    # to half way, phase 16's timing inputs (a resumed stepper is the same
    # state as one call)
    st0 = init_batch_state(gk, src8_k, criterion="in|out", device=dev)
    half_io = sliced_solve["in|out"][1] // 2
    quarter_io = half_io // 2
    t0 = time.perf_counter()
    st_kio = step_batch(gk, st0, quarter_io, ell=sl_in, ell_out=sl_out)
    st_pio = step_batch(gk, st0, quarter_io, ell=sl_in, ell_out=sl_out,
                        use_kernels=False)
    for field in ("dist", "status", "trips", "phases", "sum_fringe",
                  "relax_edges", "crit_keys"):
        if not same_bits(getattr(st_kio, field), getattr(st_pio, field)):
            raise SystemExit(f"sliced in|out kernel and plain states differ "
                             f"in {field} after {quarter_io} phases")
    if st_kio.keys_valid is not st_pio.keys_valid:
        raise SystemExit("sliced in|out keys_valid differs")
    log(f"sliced e2e in|out: after {quarter_io} phases the kernel and plain "
        f"states are bit-equal on every field, crit_keys included "
        f"({time.perf_counter() - t0:.1f} s)")
    st_kio = step_batch(gk, st_kio, half_io - quarter_io, ell=sl_in,
                        ell_out=sl_out)
    del st0, st_pio
    sl_g = to_ell_in_sliced(g)
    log(f"sliced e2e on G(n={N}, p={P}): in-view widths {sl_g.widths}, "
        f"C={sl_g.merge_idx.shape[1]}, {sl_g.padded_slots * 8 / 1e9:.3f} GB "
        f"of slots; layout='sliced' bit-equal to the padded solve on every "
        f"field, instatic|outstatic and in|out")
    del sl_g

    # ---- 16. sliced kernel times on one real phase --------------------------
    # relax sweep: the settle mask of phase total // 2 of the B = 8
    # instatic|outstatic solve; fused scans: phase total // 2 of in|out
    dm16, st16 = st_k16.dist, st_k16.status
    mins16, nf16 = kops.crit_thresholds_batch(dm16, st16,
                                              gk.out_min_static[None])
    settle16 = C.plan_union_mask(st_k16.plan, dm16, st16 == 1, mins16, {},
                                 gk.in_min_static, None)
    relax16 = torch.where(settle16, dm16, INF)[None].contiguous()
    d_kio, s_kio = st_kio.dist, st_kio.status
    god16 = kgate("out_dyn", s_kio)[None].contiguous()
    dga16, dgb16 = C.dep_gate_parts(kspec["out_full"], s_kio)
    keys16 = ell_sliced_keys_dep_batch(god16, dga16, dgb16, sl_out)
    mins_io16, nf_io16 = frontier_crit_lanes_batch(
        d_kio, s_kio, keys16[1][None].contiguous())
    settle_io16 = C.plan_union_mask(
        st_kio.plan, d_kio, s_kio == 1, mins_io16,
        {"in_full": st_kio.crit_keys[0], "out_dyn": keys16[0],
         "out_full": keys16[1]}, gk.in_min_static, None)
    dmask_io16 = torch.where(settle_io16, d_kio, INF)
    ga16, gb16, gc16 = (p[None].contiguous() for p in C.in_scan_gate_parts(
        kspec["in_full"], s_kio, settle_io16, gk.in_min_static[None]))
    upd16, _ = ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16, sl_in)
    gate1_16 = torch.minimum(ga16[0], torch.minimum(
        gb16[0], gc16[0] + torch.where(upd16 < INF, 0.0, INF)))
    dep16 = torch.minimum(dga16, dgb16 + keys16[0])
    fs_r = sliced_finite(relax16, sl_in)
    fs_gate = sliced_finite(gate1_16, sl_in)
    fs_rk = sliced_finite(dmask_io16, sl_in) + fs_gate
    fs_kd = sliced_finite(god16, sl_out) + sliced_finite(dep16, sl_out)
    del gate1_16, dep16, upd16
    log(f"sliced timing inputs: phase {int(st_k16.trips)} of the "
        f"instatic|outstatic B={LANES} solve ({int(settle16.sum())} settled, "
        f"{int(nf16.sum())} on the fringe), phase {int(st_kio.trips)} of the "
        f"in|out solve ({int(settle_io16.sum())} settled); finite lane-slots: "
        f"relax {fs_r}, relax_keys {fs_rk} (gate sweep {fs_gate}), keys_dep "
        f"{fs_kd}")
    bk = LANES * nk * 4  # bytes of one (B, n) f32 vector
    # the relax, sliced push and sliced pull, on the same input in turns
    dm16 = relax16[0]
    check_push("ell_sliced_push_relax_batch", f"phase {int(st_k16.trips)} "
               "input", dm16, sl_out,
               ell_sliced_gather_min_batch(relax16, sl_in, sparse=True)[0],
               out_deg_k)
    push_stats.zero_()
    ell_sliced_push_relax_batch(dm16, sl_out, stats=push_stats)
    active16, cand16, rows16 = push_load(dm16, out_deg_k)
    relax_turns_k = [
        time_ms(lambda: ell_sliced_gather_min_batch(relax16, sl_in,
                                                    sparse=True), reps=20),
        time_ms(lambda: ell_sliced_push_relax_batch(dm16, sl_out), reps=20),
        time_ms(lambda: ell_sliced_push_relax_batch(dm16, sl_out), reps=20),
        time_ms(lambda: ell_sliced_gather_min_batch(relax16, sl_in,
                                                    sparse=True), reps=20),
    ]
    pull_ms_k = (relax_turns_k[0] + relax_turns_k[3]) / 2
    push_ms_k = (relax_turns_k[1] + relax_turns_k[2]) / 2
    push_plain_ms_k = time_ms(
        lambda: ref.ell_push_relax_batch_ref(dm16, sl_out), reps=3, warmup=1)
    b_rk, by_rk = relax_bound(dm16, out_deg_k)
    stream_b_rk, _ = bound(sl_bytes + merge_bytes(sl_in) + 2 * bk, 2.0 * fs_r)
    log(f"sliced relax at phase {int(st_k16.trips)}: {active16} active rows "
        f"({active16 / nk:.2%} of the vertices), {cand16} candidates, "
        f"{push_stats[1].item()} atomics issued (the kernel's count of "
        f"candidates: {push_stats[0].item()}), out-rows "
        f"{rows16 / 1e6:.1f} MB")
    log(f"sliced relax at phase {int(st_k16.trips)}, in turns (pull, push, "
        f"push, pull): " + ", ".join(f"{t:.4f}" for t in relax_turns_k)
        + f" ms; push {push_ms_k:.4f} ms, pull {pull_ms_k:.4f} ms; bound "
        f"(settled out-rows + dmask + upd) {b_rk:.4f} ms ({by_rk}), the "
        f"pull's stream of the whole sliced in-view {stream_b_rk:.4f} ms; "
        f"plain push twin {push_plain_ms_k:.4f} ms")
    dense_k, dense_trip_k, act_rows_k = phase_profile(
        gk, src8_k, sl_in, sl_out,
        lambda dm: ell_sliced_push_relax_batch(dm, sl_out),
        lambda dm: ell_sliced_gather_min_batch(dm, sl_in, sparse=True),
        lambda dm: dm[None], out_deg_k,
        f"relax profile kronecker({KRON_K}) sliced, instatic|outstatic")
    dense_k3 = dense_k[None]
    dense_turns_k = [
        time_ms(lambda: ell_sliced_gather_min_batch(dense_k3, sl_in,
                                                    sparse=True), reps=10),
        time_ms(lambda: ell_sliced_push_relax_batch(dense_k, sl_out), reps=10),
        time_ms(lambda: ell_sliced_push_relax_batch(dense_k, sl_out), reps=10),
        time_ms(lambda: ell_sliced_gather_min_batch(dense_k3, sl_in,
                                                    sparse=True), reps=10),
    ]
    dk_act, dk_cand, _ = push_load(dense_k, out_deg_k)
    log(f"sliced relax at the densest phase {dense_trip_k} ({dk_act} active "
        f"rows, {dk_cand} candidates), in turns (pull, push, push, pull): "
        + ", ".join(f"{t:.4f}" for t in dense_turns_k) + f" ms; bound "
        f"{relax_bound(dense_k, out_deg_k)[0]:.4f} ms")
    del dense_k, dense_k3
    # #10 (pull sweep), #10b (push sweep) and #11 on the pipelined body,
    # each in turns with the single-sweep body they ran on before (today's
    # body: per sweep a pack, the bucket-table gather and a merge over every
    # vertex, through #9's entry, which still runs it, with the gate between
    # the sweeps built by PyTorch instead of in the pack), then split by
    # kernel with torch.profiler
    def old_relax_keys():
        upd = ell_sliced_gather_min_batch(dmask_io16[None], sl_in,
                                          sparse=True)[0]
        fin = torch.where(upd < INF, 0.0, INF)
        gate = torch.minimum(ga16, torch.minimum(gb16, gc16 + fin[None]))
        return upd, ell_sliced_gather_min_batch(gate, sl_in)

    def old_keys_dep():
        keys0 = ell_sliced_gather_min_batch(god16, sl_out)
        gate = torch.minimum(dga16, dgb16 + keys0[0])
        return torch.cat([keys0, ell_sliced_gather_min_batch(gate[None],
                                                             sl_out)])

    relax_b, relax_by = relax_bound(dmask_io16, out_deg_k)
    _, cand_io16, rows_io16 = push_load(dmask_io16, out_deg_k)
    gate_bytes = (sl_bytes + 5 * bk + sl_in.row_owner.numel() * 4
                  + sl_in.merge_short.numel() * 4)
    gate_b, gate_by = bound(gate_bytes, 2.0 * fs_gate)
    rk_bound = bound(rows_io16 + 2 * bk + gate_bytes,
                     2.0 * (cand_io16 + fs_gate))
    sliced_timed = {
        "ell_sliced_relax_keys_batch": (
            lambda: ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16,
                                                sl_in),
            lambda: ref.ell_sliced_relax_keys_batch_ref(dmask_io16, ga16,
                                                        gb16, gc16, sl_in),
            old_relax_keys, rk_bound),
        PUSH_IN_SCAN: (
            lambda: ell_sliced_relax_keys_batch(dmask_io16, ga16, gb16, gc16,
                                                sl_in, out_view=sl_out),
            lambda: ref.ell_sliced_relax_keys_batch_ref(
                dmask_io16, ga16, gb16, gc16, sl_in, out_view=sl_out),
            old_relax_keys, rk_bound),
        "ell_sliced_keys_dep_batch": (
            lambda: ell_sliced_keys_dep_batch(god16, dga16, dgb16, sl_out),
            lambda: ref.ell_sliced_keys_dep_batch_ref(god16, dga16, dgb16, 0,
                                                      sl_out),
            old_keys_dep,
            bound(sl_out_bytes + merge_bytes(sl_out) + 5 * bk, 2.0 * fs_kd)),
    }
    old_ms = {}
    for name, (kern, plain, old, (b_ms, b_by)) in sliced_timed.items():
        turns = [time_ms(old, reps=20), time_ms(kern, reps=20),
                 time_ms(kern, reps=20), time_ms(old, reps=20)]
        times[name] = ((turns[1] + turns[2]) / 2,
                       time_ms(plain, reps=3, warmup=1), b_ms, b_by)
        old_ms[name] = (turns[0] + turns[3]) / 2
        log(f"{name}: in turns (today's body, pipelined, pipelined, today's "
            f"body) " + ", ".join(f"{t:.4f}" for t in turns) + f" ms: "
            f"{times[name][0]:.4f} against {old_ms[name]:.4f} "
            f"({times[name][0] / old_ms[name]:.2f}x); plain "
            f"{times[name][1]:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        for label, fn in (("pipelined", kern), ("today's body", old)):
            log(f"{name} device ms a launch by kernel (launches seen a "
                f"call), {label}: " + "; ".join(
                    f"{k} {t:.4f} ({c:g})"
                    for k, t, c in device_split_counted(fn, calls=10)))
    log(f"sliced relax_keys bound, in two parts: the relax sweep (settled "
        f"out-rows {rows_io16 / 1e6:.1f} MB + dmask + upd) {relax_b:.4f} ms "
        f"({relax_by}), the gate sweep (the whole sliced in-view stream, "
        f"ga/gb/gc/upd read, keys written, the write-through plan) "
        f"{gate_b:.4f} ms ({gate_by})")
    times["ell_sliced_gather_min_batch"] = (
        pull_ms_k,
        time_ms(lambda: ref.ell_sliced_gather_min_batch_ref(relax16, sl_in),
                reps=3, warmup=1),
        b_rk, by_rk)
    gdense = torch.stack([kgate("out_dyn", s_kio), kgate("out_weak", s_kio)])
    dense_ms_s = time_ms(lambda: ell_sliced_gather_min_batch(gdense, sl_out),
                         reps=20)
    log(f"ell_sliced_gather_min_batch on dense V=2 out-view gates of the same "
        f"in|out phase: {dense_ms_s:.4f} ms; the partials add "
        f"{2 * LANES * sl_in.total_rows * 4 / 1e9:.4f} GB of traffic per "
        f"8-lane sweep beyond the bound")
    for crit in ("instatic|outstatic", "in|out"):
        solve_s, total_s, ph = sliced_solve[crit]
        l_s, s_s, ph_s = sliced_serve[crit]
        log(f"sliced {crit} on kronecker({KRON_K}): solve "
            f"{solve_s / total_s * 1e3:.3f} ms/phase, {np.mean(ph):.1f} "
            f"phases per query, {LANES / solve_s:.2f} queries/s; serving "
            f"{REQUESTS / s_s:.2f} queries/s, {np.mean(list(ph_s.values())):.1f}"
            f" phases per request")
    del st_k16, st_kio, relax16, dm16, dmask_io16, ga16, gb16, gc16, gdense
    # ---- 17. a sliced view with more buckets than one launch takes --------
    # G(10^5, 10^-3) (in-degrees ~ 100 +- 10) sliced at widths 64, 68, ...,
    # 136: every width has rows, so a pass runs in groups of 16 buckets
    t0 = time.perf_counter()
    gm = uniform_gnp(100_000, 1e-3, seed=SEED, device=dev)
    many = dict(pad_multiple=4, boundaries=tuple(range(64, 137, 4)))
    mv_in, mv_out = to_ell_in_sliced(gm, **many), to_ell_out_sliced(gm, **many)
    nm_ = gm.n
    live_in = sum(1 for s_ in mv_in.slices if s_.rows.shape[0])
    live_out = sum(1 for s_ in mv_out.slices if s_.rows.shape[0])
    if min(live_in, live_out) <= 16:
        raise SystemExit(f"the many-bucket views have {live_in} / {live_out} "
                         "buckets with rows, not more than 16")
    mrng = np.random.default_rng(17)
    md, mst = seeded_state(mrng, LANES, nm_, dev)
    msettle = (mst == 1) & torch.from_numpy(
        mrng.random((LANES, nm_)) < 0.05).to(dev)
    mdm = torch.where(msettle, md, INF)
    mdm[3, 11] = float("nan")
    mspec = {k.name: k for k in C.plan_for("insimple|in|outweak|out").keys}

    def mgate(name_):
        return C.key_gate(mspec[name_], mst, gm.in_min_static,
                          gm.out_min_static, {})

    mlabel = f"G(1e5, 1e-3), {live_in} / {live_out} buckets with rows"
    check("ell_sliced_gather_min_batch", f"{mlabel}, in-view sparse dmask",
          ell_sliced_gather_min_batch(mdm[None], mv_in, sparse=True),
          ref.ell_sliced_gather_min_batch_ref(mdm[None], mv_in))
    mdense = torch.stack([mgate("out_dyn"), mgate("out_weak")])
    check("ell_sliced_gather_min_batch", f"{mlabel}, out-view dense V=2",
          ell_sliced_gather_min_batch(mdense, mv_out),
          ref.ell_sliced_gather_min_batch_ref(mdense, mv_out))
    check_push("ell_sliced_push_relax_batch", mlabel, mdm, mv_out,
               ell_sliced_gather_min_batch(mdm[None], mv_in,
                                           sparse=True)[0], out_degrees(gm))
    mparts = [p_[None].contiguous() for p_ in C.in_scan_gate_parts(
        mspec["in_full"], mst, msettle, gm.in_min_static[None])]
    mtwin = ref.ell_sliced_relax_keys_batch_ref(mdm, *mparts, mv_in)
    check("ell_sliced_relax_keys_batch", mlabel,
          ell_sliced_relax_keys_batch(mdm, *mparts, mv_in), mtwin)
    check(PUSH_IN_SCAN, f"{mlabel}, push sweep",
          ell_sliced_relax_keys_batch(mdm, *mparts, mv_in, out_view=mv_out),
          mtwin)
    mdga, mdgb = C.dep_gate_parts(mspec["out_full"], mst)
    check("ell_sliced_keys_dep_batch", mlabel,
          ell_sliced_keys_dep_batch(mdense, mdga, mdgb, mv_out, dep_idx=1),
          ref.ell_sliced_keys_dep_batch_ref(mdense, mdga, mdgb, 1, mv_out))
    del md, mst, msettle, mdm, mdense, mparts, mtwin, mdga, mdgb
    msrc = np.random.default_rng(3).integers(0, nm_, LANES)
    for crit in ("instatic|outstatic", "in|out"):
        res_m = run_phased_static_batch(gm, msrc, criterion=crit, ell=mv_in,
                                        ell_out=mv_out, device=dev)
        res_pad = run_phased_static_batch(gm, msrc, criterion=crit,
                                          device=dev)
        for field in ("dist", "status", "phases", "total_phases"):
            if not same_bits(getattr(res_m, field), getattr(res_pad, field)):
                raise SystemExit(f"many-bucket sliced {crit} differs from "
                                 f"the padded solve in {field}")
        for field in ("sum_fringe", "relax_edges"):
            if not np.array_equal(getattr(res_m, field),
                                  getattr(res_pad, field)):
                raise SystemExit(f"many-bucket sliced {crit} differs from "
                                 f"the padded solve in {field}")
        log(f"many-bucket sliced {crit} on {mlabel}: B={LANES} solve "
            f"({int(res_m.total_phases)} phases) bit-equal to the padded "
            "solve on every BatchedResult field")
    del gm, mv_in, mv_out, res_m, res_pad
    log(f"many-bucket phase: {time.perf_counter() - t0:.1f} s")

    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"card: {smi}")
    sliced_kernels = {
        "ell_sliced_gather_min_batch": "src/repro/kernels/ell_relax_keys.py:311",
        "ell_sliced_relax_keys_batch": "src/repro/kernels/ell_relax_keys.py:345",
        PUSH_IN_SCAN: "src/repro/kernels/ell_relax_keys.py:345",
        "ell_sliced_keys_dep_batch": "src/repro/kernels/ell_relax_keys.py:394",
    }
    new_kernels = {
        "ell_key_min_batch": "src/repro/kernels/ell_key_min.py:86",
        "ell_gather_min_batch": "src/repro/kernels/ell_relax_keys.py:93",
        "ell_relax_keys_batch": "src/repro/kernels/ell_relax_keys.py:182",
        "ell_keys_dep_batch": "src/repro/kernels/ell_relax_keys.py:482",
    }
    kernels = [
        # the pull relax: no serving path launches it since the push took
        # over the relax of every plan without in-side keys (0 launches on
        # the main path); its bound is the function's, the push's
        {"name": "ell_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": "src/repro/kernels/ell_relax.py:97",
         "launches": launches["ell_relax_batch"],
         "max_abs_err": errs["ell_relax_batch"], "ms": out_ms_r,
         "plain_ms": plain_ms_r, "bound_ms": b_r, "bound_by": by_r,
         "library_ms": None, "stream_bound_ms": stream_b_r},
        {"name": "ell_push_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": "src/repro/kernels/ell_relax.py:97",
         "launches": launches["ell_push_relax_batch"],
         "max_abs_err": errs["ell_push_relax_batch"], "ms": push_ms,
         "plain_ms": push_plain_ms, "bound_ms": b_r, "bound_by": by_r,
         "library_ms": None, "pull_ms": out_ms_r, "active_rows": active_mid,
         "candidates": cand_mid, "densest_phase_ms": dense_turns[1:3],
         "active_rows_median": int(np.median(act_rows_g)),
         "active_rows_max": int(act_rows_g.max())},
        {"name": "frontier_crit_lanes_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/frontier_crit.cu",
         "replaces": "src/repro/kernels/frontier_crit.py:94",
         "launches": launches["frontier_crit_lanes_batch"],
         "max_abs_err": errs["frontier_crit_lanes_batch"], "ms": out_ms_c,
         "plain_ms": plain_ms_c, "bound_ms": b_c, "bound_by": by_c,
         "library_ms": None, "two_pass_body_ms": old_ms_c,
         "device_ms": crit_dev_mid[1], "two_pass_device_ms": crit_dev_mid[0],
         "per_lane_keys_ms": pl_ms, "per_lane_keys_two_pass_ms": pl_old_ms,
         "per_lane_keys_bound_ms": b_pl,
         "launches_in_out": launches_io["frontier_crit_lanes_batch"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": replaces,
         # the gather runs on the insimple|outsimple path, the rest on in|out
         "launches": (launches_ss if name == "ell_gather_min_batch"
                      else launches_io)[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         # the fused scans: the adjacency read twice, and their two sweeps
         # each timed alone on the single-sweep body (their earlier design);
         # #5 and #6: the single-sweep body in turns with the pipelined one
         **({"two_read_bound_ms": 2 * times[name][2],
             "single_sweeps_ms": single_sweeps[name]}
            if name in single_sweeps else {}),
         **({"single_sweep_body_ms": single_ms[name]}
            if name in single_ms else {})}
        for name, replaces in new_kernels.items()
    ] + [
        # #6 (and #5) on "unsettled" gates read from status: the path of
        # insimple|outsimple's out-scan and priming; timed on the out-ELL
        {"name": "ell_key_min_status_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": "src/repro/kernels/ell_relax_keys.py:93",
         "also_replaces": "src/repro/kernels/ell_key_min.py:86",
         "launches": launches_ss["ell_key_min_status_batch"],
         "max_abs_err": errs["ell_key_min_status_batch"],
         "ms": status_turns["out-ELL"][0], "plain_ms": status_plain_ms,
         "bound_ms": times["ell_gather_min_batch"][2],
         "bound_by": times["ell_gather_min_batch"][3], "library_ms": None,
         "f32_path_ms": status_turns["out-ELL"][1],
         "single_sweep_body_ms": status_turns["out-ELL"][2],
         "in_ell_ms": status_turns["in-ELL"][0],
         "in_ell_f32_path_ms": status_turns["in-ELL"][1]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_gather.cu",
         "replaces": replaces,
         # the sliced in|out serving run's launches: the gather runs there
         # to re-prime keys; the default plan's relax is the sliced push,
         # and in|out's fused in-scan runs its push form (#10b)
         "launches": sliced_serve["in|out"][0][name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None,
         **({"stream_bound_ms": stream_b_rk}
            if name == "ell_sliced_gather_min_batch" else
            {"single_sweep_body_ms": old_ms[name]}),
         **({"bound_relax_ms": relax_b, "bound_gate_ms": gate_b,
             "push_source": "src/repro_torch/kernels/csrc/ell_push.cu"}
            if name != "ell_sliced_keys_dep_batch"
            and name != "ell_sliced_gather_min_batch" else {})}
        for name, replaces in sliced_kernels.items()
    ] + [
        {"name": "ell_sliced_push_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_push.cu",
         "replaces": "src/repro/kernels/ell_relax_keys.py:311",
         "launches": sliced_serve["instatic|outstatic"][0][
             "ell_sliced_push_relax_batch"],
         "max_abs_err": errs["ell_sliced_push_relax_batch"],
         "ms": push_ms_k, "plain_ms": push_plain_ms_k, "bound_ms": b_rk,
         "bound_by": by_rk, "library_ms": None, "pull_ms": pull_ms_k,
         "active_rows": active16, "candidates": cand16,
         "densest_phase_ms": dense_turns_k[1:3],
         "active_rows_median": int(np.median(act_rows_k)),
         "active_rows_max": int(act_rows_k.max())},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
