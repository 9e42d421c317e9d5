#!/usr/bin/env python3
"""Time forms of the frontier reduction on one CUDA card.

    python3 tools/crit_variants.py [--variants a,b,...]

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``. Builds ``src/repro_torch/kernels/csrc/frontier_crit.cu`` once as
it stands and once per variant (a changed ``#define`` or a text edit of its
fold, below), and the two-pass body it replaced (``TWO_PASS_SOURCE``: per-
block partials over an (n / 2048, B) grid, then one fold block per lane),
every ``nvcc`` at once, into the git-ignored ``build/variants/``. Then, on
the inputs of phase 200 of the B = 8 default solve on G(10^6, 10^-4) (keys:
the shared ``out_min_static``) and of phase 100 of the ``in|out`` solve
(keys: the per-lane ``out_full``), it calls each library's entry point
directly: every form against the twin bit for bit (the phase inputs hold
no -0, so the rule without the tie gives the same bits), CUDA-event
medians in two rounds (forward, then backward), and the device time a call
from ``torch.profiler``; last, the shipped build and ``min_blocks2`` at 1,
2, 3, 4 and 8 blocks an SM. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# the fold as it ships in nan_min (PTX min.NaN, one instruction, as the
# gathers of ell_gather.cu fold), and the forms it was chosen against: fminf
# (which takes -0 on a tie on the card) with NaN put back by compares, the
# compare with a sign test for the tie, the compare that ORs the zeros' bits
# on a tie, and the rule without the tie (the form before -0 was handled);
# and fminf beside a NaN flag applied once a block (CRIT_NAN_FLAG 1). The
# loads: fewer or more groups of 4 vertices a thread before it folds.
_FOLD = ('  float r;\n  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), '
         '"f"(v));\n  return r;\n')
_UNROLL = "  static constexpr int value = K <= 2 ? 4 : (K <= 4 ? 2 : 1);\n"
# name -> ({macro: value}, [(old text, new text)])
VARIANTS = {
    "shipped": ({}, []),
    "nan_flag": ({"CRIT_NAN_FLAG": 1}, []),
    "fminf": ({}, [(_FOLD, "  return v != v ? v : (m != m ? m : fminf(m, "
                           "v));\n")]),
    "compare_signbit": ({}, [(_FOLD, "  return (v < m || v != v || (v == m "
                                     "&& signbit(v))) ? v : m;\n")]),
    "compare_or_tie": ({}, [(_FOLD, "  return (v < m || v != v) ? v : (v == "
                                    "m ? __int_as_float(__float_as_int(m) | "
                                    "__float_as_int(v)) : m);\n")]),
    "no_tie": ({}, [(_FOLD, "  return (v < m || v != v) ? v : m;\n")]),
    "unroll2": ({}, [(_UNROLL, _UNROLL.replace("K <= 2 ? 4", "K <= 2 ? 2"))]),
    "unroll8": ({}, [(_UNROLL, _UNROLL.replace("K <= 2 ? 4", "K <= 2 ? 8"))]),
    # registers held to 2 blocks of 256 threads an SM instead of 4 (no
    # spills for K >= 1), for the 1 and 2 blocks an SM of the sweep below
    "min_blocks2": ({"CRIT_MIN_BLOCKS": 2}, []),
}
TWO_PASS = "two_pass"  # the body frontier_crit.cu ran on before, below

# The two-pass body frontier_crit.cu shipped before its one-launch form
# (per-block partials over a (ceil(n / (threads * items)), B) grid, then one
# block a lane folds them; the wrapper allocated both scratch arrays a
# call), kept to be timed in turns with it. Its entry point:
# frontier_crit_two_pass_launch(d, status, keys, n, lanes, nkeys, key_sk,
# key_sb, threads, items, nblk, part_min, part_cnt, mins, cnt, stream).
TWO_PASS_SOURCE = r"""
#include <cuda_runtime.h>
#include <math_constants.h>

#define KMAX 8
#define NL (KMAX + 1)

__device__ __forceinline__ float nan_min(float m, float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ void block_fold(float* acc, int& cnt, int nl) {
  __shared__ float sm[NL][32];
  __shared__ int sc[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int l = 0; l < NL; ++l)
    if (l < nl) acc[l] = warp_min(acc[l]);
  cnt = warp_sum(cnt);
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      if (l < nl) sm[l][warp] = acc[l];
    sc[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      if (l < nl) acc[l] = warp_min(lane < nwarps ? sm[l][lane] : CUDART_INF_F);
    cnt = warp_sum(lane < nwarps ? sc[lane] : 0);
  }
}

__global__ void crit_partial_kernel(const float* __restrict__ d,
                                    const int* __restrict__ status,
                                    const float* __restrict__ keys,
                                    long long n, int lanes, int nkeys,
                                    long long key_sk, long long key_sb,
                                    int items, float* __restrict__ part_min,
                                    int* __restrict__ part_cnt) {
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const int nl = 1 + nkeys;
  const float* drow = d + (long long)b * n;
  const int* srow = status + (long long)b * n;
  const float* krow = keys + (long long)b * key_sb;
  float acc[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) acc[l] = CUDART_INF_F;
  int cnt = 0;
  const long long base = (long long)blockIdx.x * blockDim.x * items;
  for (int it = 0; it < items; ++it) {
    const long long v = base + (long long)it * blockDim.x + threadIdx.x;
    if (v < n && srow[v] == 1) {
      const float dv = drow[v];
      acc[0] = nan_min(acc[0], dv);
      cnt += 1;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < nkeys) acc[1 + k] = nan_min(acc[1 + k], dv + krow[k * key_sk + v]);
    }
  }
  block_fold(acc, cnt, nl);
  if (threadIdx.x == 0) {
    for (int l = 0; l < nl; ++l)
      part_min[((long long)l * lanes + b) * nblk + blockIdx.x] = acc[l];
    part_cnt[(long long)b * nblk + blockIdx.x] = cnt;
  }
}

__global__ void crit_final_kernel(const float* __restrict__ part_min,
                                  const int* __restrict__ part_cnt, int nblk,
                                  int lanes, int nkeys,
                                  float* __restrict__ mins,
                                  int* __restrict__ cnt_out) {
  const int b = blockIdx.x;
  const int nl = 1 + nkeys;
  float acc[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) acc[l] = CUDART_INF_F;
  int cnt = 0;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      if (l < nl)
        acc[l] = nan_min(acc[l], part_min[((long long)l * lanes + b) * nblk + i]);
    cnt += part_cnt[(long long)b * nblk + i];
  }
  block_fold(acc, cnt, nl);
  if (threadIdx.x == 0) {
    for (int l = 0; l < nl; ++l) mins[(long long)l * lanes + b] = acc[l];
    cnt_out[b] = cnt;
  }
}

extern "C" int frontier_crit_two_pass_launch(
    const float* d, const int* status, const float* keys, long long n,
    int lanes, int nkeys, long long key_sk, long long key_sb, int threads,
    int items, int nblk, float* part_min, int* part_cnt, float* mins,
    int* cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  crit_partial_kernel<<<dim3(nblk, lanes), threads, 0, s>>>(
      d, status, keys, n, lanes, nkeys, key_sk, key_sb, items, part_min,
      part_cnt);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  crit_final_kernel<<<lanes, threads, 0, s>>>(part_min, part_cnt, nblk, lanes,
                                              nkeys, mins, cnt);
  return (int)cudaGetLastError();
}
"""
TWO_PASS_THREADS, TWO_PASS_ITEMS = 256, 8
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
TWO_PASS_SIGNATURE = ([_P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _I, _I, _P, _P,
                       _P, _P, _P], _I)


def variant_source(src: str, defines: dict, edits: list) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant edit does not apply: {old!r}")
        src = src.replace(old, new)
    for name, value in defines.items():
        src, count = re.subn(rf"#define {name} \S+", f"#define {name} {value}",
                             src)
        if count != 1:
            raise SystemExit(f"no #define {name} in frontier_crit.cu")
    return src


def build(names, out_dir: Path) -> dict:
    """Each named form compiled into ``out_dir`` (``TWO_PASS`` from its own
    source), one ``nvcc`` each, all at once; returns name -> loaded
    library."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import frontier_crit as fc

    src = (_build.CSRC / "frontier_crit.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"crit_{name}.cu"
        cu.write_text(TWO_PASS_SOURCE if name == TWO_PASS
                      else variant_source(src, *VARIANTS[name]))
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
        sigs = ({"frontier_crit_two_pass_launch": TWO_PASS_SIGNATURE}
                if name == TWO_PASS else fc._SIGNATURES)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def caller(name, lib, d, status, keys, blocks_per_sm=None):
    """``(call, (mins, cnt))``: one reduction of (d, status, keys) through
    ``lib``'s entry point, with its own scratch; ``blocks_per_sm`` for the
    one-launch form (default the wrapper's)."""
    import torch

    from repro_torch.kernels import frontier_crit as fc
    from repro_torch.kernels.config import CRIT_BLOCKS_PER_SM

    dev = d.device
    b, n = d.shape
    k = 0 if keys is None else keys.shape[0]
    mins = torch.empty((1 + k, b), device=dev)
    cnt = torch.empty((b,), dtype=torch.int32, device=dev)
    key_sk, key_sb = ((0, 0) if keys is None else
                      (n, 0) if keys.dim() == 2 else (b * n, n))
    kptr = None if keys is None else keys.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if name == TWO_PASS:
        nblk = -(-n // (TWO_PASS_THREADS * TWO_PASS_ITEMS))

        def call():
            part_min = torch.empty((1 + k, b, nblk), device=dev)
            part_cnt = torch.empty((b, nblk), dtype=torch.int32, device=dev)
            rc = lib.frontier_crit_two_pass_launch(
                d.data_ptr(), status.data_ptr(), kptr, n, b, k, key_sk,
                key_sb, TWO_PASS_THREADS, TWO_PASS_ITEMS, nblk,
                part_min.data_ptr(), part_cnt.data_ptr(), mins.data_ptr(),
                cnt.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return call, (mins, cnt)
    bps = CRIT_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bx = max(1, min(-(-sms * bps // b), -(-n // (4 * fc.CRIT_THREADS))))
    part_min = torch.empty((1 + k) * b * bx, device=dev)
    part_cnt = torch.empty(b * bx, dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def call():
        rc = lib.frontier_crit_lanes_launch(
            d.data_ptr(), status.data_ptr(), kptr, n, b, k, key_sk, key_sb,
            bx, part_min.data_ptr(), part_cnt.data_ptr(), ticket.data_ptr(),
            mins.data_ptr(), cnt.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call, (mins, cnt)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join([*VARIANTS, TWO_PASS]))
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
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_relax_keys import ell_keys_dep_batch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_split, same_bits, time_ms

    libs = build(names, ROOT / "build" / "variants")
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

    def check_and_time(label, tag, call, got, want):
        call()
        torch.cuda.synchronize()
        if not all(same_bits(a, w) for a, w in zip(got, want)):
            raise SystemExit(f"{tag} differs from the twin: {label}")
        ms = time_ms(call, reps=50)
        parts = device_split(call, calls=10)
        print(f"[{tag}] {label}: {ms:.4f} ms a call (events), "
              f"{sum(t for _, t in parts):.4f} ms on the device ("
              + "; ".join(f"{k} {t:.4f}" for k, t in parts) + ")",
              flush=True)

    for label, (d, status, keys) in inputs.items():
        want = ref.frontier_crit_lanes_batch_ref(d, status, keys)
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                call, got = caller(name, libs[name], d, status, keys)
                check_and_time(label, f"{name}, round {rnd}", call, got, want)
        for lib_name in ("shipped", "min_blocks2"):
            if lib_name not in libs:
                continue
            for bps in (1, 2, 3, 4, 8):
                call, got = caller(lib_name, libs[lib_name], d, status,
                                   keys, blocks_per_sm=bps)
                check_and_time(label, f"{lib_name}, {bps} blocks an SM",
                               call, got, want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
