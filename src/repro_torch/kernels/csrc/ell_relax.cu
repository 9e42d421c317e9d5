// ell_relax_batch: pull-model min-plus relaxation over the incoming ELL.
//
//   upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]
//
// Replaces the TPU kernel repro/kernels/ell_relax.py::ell_relax_batch (and,
// with B = 1, ell_relax in the same file). On the TPU the whole (B, n_pad)
// dmask sat in VMEM and each grid step reduced a (block_rows, D) tile.
//
// What bounds it on an H100: memory. There are no multiplies and min-plus
// has no tensor-core form. The least time is the bytes over the HBM rate:
// cols + ws (n * D * 8 bytes) read once, dmask (B * n_pad * 4) and upd
// (B * n * 4); at n = 1e6, D = 152, B = 8 that is ~1.3 GB, ~0.38 ms at
// 3.35 TB/s. The gather dmask[b, cols[v, j]] is random, and its working set
// (B * n_pad * 4 = 32 MB at B = 8) fits the 50 MB L2, so it is served from
// L2 -- but at the granularity of a 32-byte sector: read lane by lane from
// the (B, n_pad) rows, every lane of every slot costs its own sector, which
// at B = 8 is ~39 GB of L2 traffic per launch, 30x the HBM stream.
//
// What the design does about it:
//  * pass 1 (pack) copies each tile of W lanes of dmask into an interleaved
//    (n_pad, W) scratch, W = the lane count rounded up to a power of two, at
//    most LANE_TILE = 8. The W lanes of one slot are then one aligned read
//    of W * 4 <= 32 bytes: one sector per slot instead of one per lane. With
//    one lane the (1, n_pad) row already is that layout and is not copied;
//  * pass 1 also writes a bitmap of the columns that hold anything but +inf
//    in some lane (n_pad / 8 bytes, small enough to stay in L1). On the
//    engine's path dmask is +inf except at the vertices settled this phase
//    (a fraction of a percent of n), so pass 2 skips almost every gather:
//    a clear column contributes +inf + w = +inf, the identity of min, for
//    every w but -inf and NaN, which are never skipped. What is left is the
//    coalesced stream of cols and ws, the bound above;
//  * pass 2: a group of `tpr` threads (a power of two, at most a warp) owns
//    one row, so neighbouring threads read neighbouring (cols, ws) slots and
//    the adjacency stream is read coalesced, once per lane tile;
//  * each thread loads the (col, w) pairs of SLOTS slots before it issues
//    their gathers, so several independent reads are in flight per thread;
//  * the group folds its partial minima with xor shuffles and one thread
//    writes each output element: no atomics, no shared memory.
//
// Min semantics: jnp.min propagates NaN and fminf drops it, so the fold is
// an explicit compare that keeps a NaN. A column outside [0, n_pad) reads
// as NaN, as jnp.take's default fill mode does, instead of reading out of
// bounds.
#include <cuda_runtime.h>
#include <math_constants.h>

#define LANE_TILE 8
#define SLOTS 4

__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || v != v) ? v : m;
}

// Pass 1: packed[t, c, k] = dmask[t * W + k, c] (+inf past the last lane;
// not written when `packed` is null), and bit c of live_bits set iff some
// lane's dmask[b, c] is not +inf. One thread per column; blockDim.x must be
// a multiple of 32 so each warp owns one 32-bit word of the bitmap.
template <int W>
__global__ void pack_lanes_kernel(const float* __restrict__ dmask,
                                  long long n_pad, int lanes,
                                  float* __restrict__ packed,
                                  unsigned* __restrict__ live_bits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (c < n_pad) {
    const int tiles = (lanes + W - 1) / W;
    for (int t = 0; t < tiles; ++t) {
      float v[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int b = t * W + k;
        v[k] = b < lanes ? dmask[(long long)b * n_pad + c] : CUDART_INF_F;
        live |= v[k] != CUDART_INF_F;
      }
      if (packed != nullptr) {
        float* dst = packed + ((long long)t * n_pad + c) * W;
#pragma unroll
        for (int k = 0; k < W; ++k) dst[k] = v[k];
      }
    }
  }
  const unsigned word = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0 && c < n_pad) live_bits[c >> 5] = word;
}

// W consecutive floats at p (p aligned to W * 4 bytes), as vector loads.
template <int W>
__device__ __forceinline__ void load_lanes(const float* p, float* v) {
  if constexpr (W == 1) {
    v[0] = p[0];
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
    }
  }
}

// Pass 2: grid over rows * tpr threads; tiles of W lanes in `packed`.
template <int W>
__global__ void ell_relax_kernel(const float* __restrict__ packed,
                                 const unsigned* __restrict__ live_bits,
                                 long long n_pad,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ ws,
                                 long long n_rows, int d_pad, int lanes,
                                 int tpr, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid / tpr;
  const int sub = (int)(tid % tpr);
  // Threads past the last row still take part in the shuffles below (the
  // full-warp mask needs every lane); they only skip the loads and writes.
  const bool valid = row < n_rows;
  const int* crow = cols + (valid ? row : 0) * d_pad;
  const float* wrow = ws + (valid ? row : 0) * d_pad;
  const int tiles = (lanes + W - 1) / W;
  for (int t = 0; t < tiles; ++t) {
    const float* ptile = packed + (long long)t * n_pad * W;
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = CUDART_INF_F;
    for (int j0 = valid ? sub : d_pad; j0 < d_pad; j0 += SLOTS * tpr) {
      bool in_row[SLOTS];
      int c[SLOTS];
      float w[SLOTS];
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        const int j = j0 + u * tpr;
        in_row[u] = j < d_pad;
        c[u] = in_row[u] ? crow[j] : 0;
        w[u] = in_row[u] ? wrow[j] : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        if (!in_row[u]) continue;
        float v[W];
        if (c[u] >= 0 && (long long)c[u] < n_pad) {
          const bool live = (__ldg(live_bits + (c[u] >> 5)) >> (c[u] & 31)) & 1u;
          if (!live && w[u] == w[u] && w[u] != -CUDART_INF_F) continue;
          load_lanes<W>(ptile + (long long)c[u] * W, v);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) v[k] = CUDART_NAN_F;
        }
#pragma unroll
        for (int k = 0; k < W; ++k) acc[k] = nan_min(acc[k], v[k] + w[u]);
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      for (int off = tpr >> 1; off > 0; off >>= 1) {
        acc[k] = nan_min(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
      }
    }
    if (valid && sub == 0) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int b = t * W + k;
        if (b < lanes) out[(long long)b * n_rows + row] = acc[k];
      }
    }
  }
}

template <int W>
static int launch(const float* dmask, long long n_pad, const int* cols,
                  const float* ws, long long n_rows, int d_pad, int lanes,
                  int tpr, int threads, float* packed, unsigned* live_bits,
                  float* out, cudaStream_t stream) {
  if (lanes == 1) packed = nullptr;  // one lane: dmask is the packed layout
  const long long blocks1 = (n_pad + threads - 1) / threads;
  pack_lanes_kernel<W><<<(unsigned)blocks1, threads, 0, stream>>>(
      dmask, n_pad, lanes, packed, live_bits);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long blocks = (n_rows * tpr + threads - 1) / threads;
  ell_relax_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      packed == nullptr ? dmask : packed, live_bits, n_pad, cols, ws, n_rows,
      d_pad, lanes, tpr, out);
  return (int)cudaGetLastError();
}

// The lane-tile width for `lanes` lanes: the next power of two, at most 8.
extern "C" int ell_relax_lane_tile(int lanes) {
  int w = 1;
  while (w < lanes && w < LANE_TILE) w *= 2;
  return w;
}

// Launches both passes on `stream`; returns cudaGetLastError() after each
// (0 = launched). Scratch: `packed` holds ceil(lanes / W) * n_pad * W
// floats, 16-byte aligned (unused with one lane); `live_bits` holds
// ceil(n_pad / 32) words.
extern "C" int ell_relax_batch_launch(const float* dmask, long long n_pad,
                                      const int* cols, const float* ws,
                                      long long n_rows, int d_pad, int lanes,
                                      int tpr, int threads, float* packed,
                                      unsigned* live_bits, float* out,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (ell_relax_lane_tile(lanes)) {
    case 1:
      return launch<1>(dmask, n_pad, cols, ws, n_rows, d_pad, lanes, tpr,
                       threads, packed, live_bits, out, s);
    case 2:
      return launch<2>(dmask, n_pad, cols, ws, n_rows, d_pad, lanes, tpr,
                       threads, packed, live_bits, out, s);
    case 4:
      return launch<4>(dmask, n_pad, cols, ws, n_rows, d_pad, lanes, tpr,
                       threads, packed, live_bits, out, s);
    default:
      return launch<8>(dmask, n_pad, cols, ws, n_rows, d_pad, lanes, tpr,
                       threads, packed, live_bits, out, s);
  }
}
