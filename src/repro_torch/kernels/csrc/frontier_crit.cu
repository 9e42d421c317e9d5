// frontier_crit_lanes_batch: the fused frontier reduction over plan lanes.
//
//   mins[0, b]     = min_{v in F_b} d[b, v]
//   mins[1 + k, b] = min_{v in F_b} (d[b, v] + keys[k, (b,) v])
//   cnt[b]         = |F_b|                      (F_b = {v : status[b, v] == 1})
//
// Replaces the TPU kernel repro/kernels/frontier_crit.py::
// frontier_crit_lanes_batch. There the grid ran in order on one core and
// every step min/sum-accumulated into one VMEM-resident output block
// (pl.when(step == 0) init). CUDA blocks run concurrently and in no order,
// so this is a two-pass reduction: pass 1 writes one partial per (lane,
// block) to a scratch buffer the wrapper allocates, pass 2 (one block per
// batch lane) folds the partials. The result is exact in any order: f32 min
// has no rounding and the int32 count is an exact sum. The TPU's 128-lane
// output padding is not carried over.
//
// What bounds it on an H100: memory. It reads d and status once
// (B * n * 8 bytes) plus the keys (K * n * 4 shared, K * B * n * 4
// per-lane) and writes a few bytes per lane; at n = 1e6, B = 8, K = 1 that
// is ~68 MB, ~20 us at 3.35 TB/s. The design reads every input word exactly
// once, coalesced (consecutive threads on consecutive vertices, a grid-y
// index per batch lane), and keeps all 1 + K running minima and the count
// of a thread in registers, so K OUT lanes cost no extra pass over d.
//
// Min semantics: nan_min keeps a NaN, as jnp.min does (fminf would drop
// it), and takes -0 over +0 on a tie in either order, as XLA's min does.
#include <cuda_runtime.h>
#include <math_constants.h>

#define KMAX 8
#define NL (KMAX + 1)

// min(m, v) as jnp.minimum gives it: NaN if either is NaN (the canonical
// NaN: card parity takes every NaN as one value), and -0 for a tie of -0
// and +0 in either order: PTX min.NaN, as the gathers of ell_gather.cu fold.
// Of the forms that keep the tie rule it is the fastest here; the rule
// itself costs the first pass ~0.02-0.03 ms against the compare without it
// (tools/crit_variants.py).
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

// Block-wide fold of the 1 + K minima and the count held by each thread.
// Thread 0 returns the block's values in acc / cnt. blockDim.x must be a
// multiple of 32 and at most 1024.
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

// Pass 1: grid (nblk, lanes); block x covers items * blockDim.x vertices of
// lane blockIdx.y. Keys are addressed keys[k * key_sk + b * key_sb + v]:
// key_sb = 0 for the shared (K, n) stack, n for the per-lane (K, B, n) one.
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

// Pass 2: one block per batch lane folds that lane's nblk partials.
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

// Launches both passes on `stream`; returns cudaGetLastError() after each
// (0 = both launched). part_min is (1 + nkeys, lanes, nblk), part_cnt
// (lanes, nblk), mins (1 + nkeys, lanes), cnt (lanes,).
extern "C" int frontier_crit_lanes_launch(
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
