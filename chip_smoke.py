#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (CUDA
toolkit with ``nvcc`` under ``/usr/local/cuda``). Phases, in order; any
failure raises, exits non-zero and prints no ``ok`` line:

  1. device and build: the card's name, count and power limit; builds every
     CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
  2. kernel parity at full width: the paper's G(n=10^6, p=10^-4) graph
     (~10^8 arcs) and its incoming ELL on the card; each kernel against its
     plain PyTorch twin on seeded inputs, compared bit for bit (every NaN
     counts as one value: IEEE leaves NaN payloads open);
  3. the main path, serving: a StaticBackend with 8 lanes answers 16
     requests (reset_lanes -> step -> peek -> take_row), with every
     kernel's launch count set to 0 just before and read just after;
  4. end-to-end parity: run_phased_static_batch with the kernels and with
     use_kernels=False give bit-equal results;
  5. an independent check of one row against scipy's Dijkstra (f64, host);
  6. kernel times at the main shape, on the inputs of one real phase of
     the B = 8 solve (CUDA events, median per launch), beside the twin's
     time and the least time the card could take for that input.

The second line from the end is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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


def log(msg: str):
    print(msg, flush=True)


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


def seeded_state(rng, b: int, n: int, dev):
    """(d, status) with a U/F/S mix and +inf holes, made on the host."""
    import torch

    d = rng.uniform(0.0, 10.0, (b, n)).astype(np.float32)
    d[rng.random((b, n)) < 0.3] = np.inf
    status = rng.integers(0, 3, (b, n)).astype(np.int32)
    return torch.from_numpy(d).to(dev), torch.from_numpy(status).to(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import KEEP_LANE, to_ell_in
    from repro_torch.core import criteria as C
    from repro_torch.core.static_engine import (
        init_batch_state,
        run_phased_static_batch,
        step_batch,
    )
    from repro_torch.graphs import grid_road, uniform_gnp
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ell_relax import ell_relax, ell_relax_batch
    from repro_torch.kernels.frontier_crit import frontier_crit_lanes_batch
    from repro_torch.serving import StaticBackend

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
    outputs = _build.build(ptxas_info=True)
    log(f"build: {sorted(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, out in sorted(outputs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

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

    # ---- 3. the main path, serving ---------------------------------------
    sources = np.random.default_rng(1).integers(0, g.n, REQUESTS)
    backend = StaticBackend(g, device=dev)
    state = backend.init(LANES)
    lane_req = [None] * LANES
    pending = list(range(REQUESTS))
    rows, req_phases = {}, {}
    ell_relax_batch.launches = 0
    frontier_crit_lanes_batch.launches = 0
    torch.cuda.synchronize()
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
    launches = {"ell_relax_batch": ell_relax_batch.launches,
                "frontier_crit_lanes_batch": frontier_crit_lanes_batch.launches}
    trips = int(state.trips)
    log(f"serving: {len(rows)} requests answered in {serve_s:.3f} s "
        f"({len(rows) / serve_s:.2f} queries/s), {steps} step calls, "
        f"{trips} trips; phases per request "
        f"{[req_phases[r] for r in range(REQUESTS)]}")
    log(f"serving launches: {launches}")
    if len(rows) != REQUESTS:
        raise SystemExit("serving did not answer every request")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise SystemExit(f"the main path never launched {name}")
    del state

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
    log(f"e2e: B={LANES} solve with kernels {solve_s:.3f} s "
        f"({LANES / solve_s:.2f} queries/s, {total} phases, "
        f"{solve_s / total * 1e3:.3f} ms/phase); plain twins {plain_s:.3f} s; "
        f"every BatchedResult field bit-equal")
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
    out_ms_r = time_ms(lambda: ell_relax_batch(dmask_mid, cols, ws), reps=20)
    plain_ms_r = time_ms(
        lambda: ref.ell_relax_batch_ref(dmask_mid, cols, ws), reps=5,
        warmup=1)
    out_ms_c = time_ms(
        lambda: frontier_crit_lanes_batch(d_mid, s_mid, keys_shared), reps=50)
    plain_ms_c = time_ms(
        lambda: ref.frontier_crit_lanes_batch_ref(d_mid, s_mid, keys_shared),
        reps=20)
    view = dmask_mid[0].contiguous()
    view_ms = time_ms(lambda: ell_relax(view, cols, ws), reps=20)
    view_plain_ms = time_ms(lambda: ref.ell_relax_ref(view, cols, ws),
                            reps=5, warmup=1)
    dense_ms = time_ms(lambda: ell_relax_batch(dmask8, cols, ws), reps=20)
    b_r, by_r = bound(ell_bytes + dmask_mid.numel() * 4 + LANES * n * 4,
                      2.0 * live_slots)
    b_c, by_c = bound(
        d_mid.numel() * 4 + s_mid.numel() * 4 + keys_shared.numel() * 4
        + 2 * LANES * 4 + LANES * 4,
        3.0 * fringe_mid)
    b_v, _ = bound(ell_bytes + view.numel() * 4 + n * 4, 2.0 * n * d_pad)
    log(f"ell_relax (B = 1 view, lane 0 of the timing inputs, not on the "
        f"main path): {view_ms:.4f} ms, plain {view_plain_ms:.4f} ms, bound "
        f"{b_v:.4f} ms")
    log(f"ell_relax_batch on the seeded parity input (a third of dmask "
        f"finite): {dense_ms:.4f} ms")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"card: {smi}")
    kernels = [
        {"name": "ell_relax_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_relax.cu",
         "replaces": "src/repro/kernels/ell_relax.py:97",
         "launches": launches["ell_relax_batch"],
         "max_abs_err": errs["ell_relax_batch"], "ms": out_ms_r,
         "plain_ms": plain_ms_r, "bound_ms": b_r, "bound_by": by_r,
         "library_ms": None},
        {"name": "frontier_crit_lanes_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/frontier_crit.cu",
         "replaces": "src/repro/kernels/frontier_crit.py:94",
         "launches": launches["frontier_crit_lanes_batch"],
         "max_abs_err": errs["frontier_crit_lanes_batch"], "ms": out_ms_c,
         "plain_ms": plain_ms_c, "bound_ms": b_c, "bound_by": by_c,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
