// ell_gather: the one min-plus gather body of the port, and the entry points
// built on it.
//
//   out[l, r] = min_j vec[l, cols[r, j]] + ws[r, j]      (l = one gather lane)
//
// Replaces these TPU kernels of the JAX package:
//   * repro/kernels/ell_relax.py::ell_relax_batch (and ell_relax, its B = 1
//     view): the pull-model relaxation, vec = dmask, +inf off the vertices
//     settled this phase, padded by the ops layer;
//   * repro/kernels/ell_key_min.py::ell_key_min_batch (and ell_key_min, its
//     B = 1 view): one gate row per lane, padded by the ops layer;
//   * repro/kernels/ell_relax_keys.py::ell_gather_min_batch: V vectors x B
//     lanes = V * B gather lanes over one adjacency;
//   * ell_relax_keys.py::ell_relax_keys_batch (and ell_relax_keys): the fused
//     in-scan, sweep 0 = the relax update, sweep 1 = the next phase's in-side
//     keys through the gate min(ga, min(gb, gc + fin(upd)));
//   * ell_relax_keys.py::ell_keys_dep_batch: the fused out-scan, sweep 0 = the
//     independent keys, sweep 1 = the dependent key through the gate
//     min(dga, dgb + keys0[dep_idx]);
//   * ell_relax_keys.py::ell_sliced_gather_min_batch,
//     ell_sliced_relax_keys_batch and ell_sliced_keys_dep_batch: the same
//     sweeps over a degree-sliced adjacency (the section at the end).
//
// What bounds them on an H100: memory. There are no multiplies and min-plus
// has no tensor-core form; the least time is the bytes over the HBM rate:
// cols + ws (n * D * 8 bytes) read once plus the vectors and outputs, ~1.3 GB
// and ~0.4 ms at n = 1e6, D = 152, B = 8. The gather vec[l, cols[r, j]] is
// random; its working set (lanes * (n + 1) * 4 bytes, 32 MB at 8 lanes) fits
// the 50 MB L2 and is served from there, but at the granularity of a 32-byte
// sector: read lane by lane from (lanes, n + 1) rows, every lane of every
// slot costs its own sector, ~39 GB of L2 traffic per 8-lane sweep, 30x the
// HBM stream.
//
// What the design does about it:
//  * a pack pass copies each tile of W gather lanes into an interleaved
//    (n_idx, W) scratch, W = the lane count rounded up to a power of two, at
//    most LANE_TILE = 8, so one slot's W lanes are one aligned read of at most
//    32 bytes: one L2 sector per slot instead of one per lane. One lane of
//    rows that already hold every id (a padded vector) is that layout as it
//    stands and is not copied. The pack pass is also where the sweep-1 gates
//    are built, elementwise, as it packs (the "small elementwise pass"
//    between the two sweeps), and where the +inf column of the sentinel id n
//    is appended to unpadded vectors;
//  * the gather pass: a group of `tpr` threads (a power of two, at most a
//    warp) owns one row, so the (cols, ws) stream is read coalesced, once per
//    lane tile; each thread loads SLOTS slots before it issues their gathers;
//    the group folds with xor shuffles and one thread writes each output: no
//    atomics, no shared memory;
//  * a sweep over a sparse vector (the relax's dmask, +inf but at the
//    vertices settled this phase, a fraction of a percent of n) also writes,
//    in its pack pass, a bitmap of the columns that hold anything but +inf in
//    some lane (n_idx / 8 bytes, small enough to stay in L1), and its gather
//    pass skips the gathers of clear columns. What is left is the coalesced
//    stream of cols and ws, the bound above. Only the relax sweeps
//    (ell_relax_batch and sweep 0 of the fused in-scan) do this. Key gates
//    are dense (0 on every unsettled vertex): a bitmap would skip nothing and
//    cost its check on every slot.
//
// The two-sweep kernels need a grid-wide barrier: sweep 1 gathers from any
// column of sweep 0's output. On the TPU that output stayed resident in VMEM
// across a sequential (2, n_tiles) grid. Here each fused kernel is one C
// entry point that issues pack 0, gather 0, pack 1 (which builds the gate),
// gather 1 in order on one stream; stream order is the barrier. A cooperative
// launch with grid.sync() would cap the grid at the blocks that fit on the
// card at once (the gather pass has ~10^5 blocks at n = 1e6), and each sweep
// already streams the adjacency once, so it would save only the launch gaps.
//
// Min semantics: jnp.min/jnp.minimum propagate NaN and fminf drops it, so
// every fold and every gate min is an explicit compare that keeps a NaN from
// either side. Ids in [0, n] are the contract (to_ell_in / to_ell_out); an id
// outside [0, n_idx) reads NaN instead of memory out of bounds.
#include <cuda_runtime.h>
#include <math_constants.h>

#define LANE_TILE 8
#define SLOTS 4

__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || v != v) ? v : m;
}

// What the pack pass reads for gather lane l and column c.
enum PackMode { PACK_ROWS = 0, PACK_IN_GATE = 1, PACK_DEP_GATE = 2 };

struct PackSrc {
  const float* a;    // ROWS: (lanes, n_src) rows; IN_GATE: ga; DEP_GATE: dga
  const float* b;    // IN_GATE: gb; DEP_GATE: dgb
  const float* c;    // IN_GATE: gc; DEP_GATE: keys0[dep_idx], (B, n_src)
  const float* upd;  // IN_GATE: sweep 0's upd, (B, n_src)
  long long n_src;   // columns of each source row; columns past it read +inf
  int lanes_b;       // B: gate lane l = k * B + b reads upd row b
};

template <int MODE>
__device__ __forceinline__ float pack_value(const PackSrc& s, int l,
                                            long long c) {
  if (c >= s.n_src) return CUDART_INF_F;  // sentinel and index padding
  const long long i = (long long)l * s.n_src + c;
  if constexpr (MODE == PACK_ROWS) {
    return s.a[i];
  } else if constexpr (MODE == PACK_IN_GATE) {
    // a vertex joins the fringe iff its update is finite
    const float u = s.upd[(long long)(l % s.lanes_b) * s.n_src + c];
    const float fin = u < CUDART_INF_F ? 0.0f : CUDART_INF_F;
    return nan_min(s.a[i], nan_min(s.b[i], s.c[i] + fin));
  } else {
    return nan_min(s.a[i], s.b[i] + s.c[i]);
  }
}

template <int W>
__device__ __forceinline__ void store_lanes(float* p, const float* v) {
  if constexpr (W == 1) {
    p[0] = v[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      *reinterpret_cast<float4*>(p + 4 * q) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
}

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

// Pack: packed[t, c, k] = value of lane t * W + k at column c (+inf past the
// last lane; not written when `packed` is null). With `live_bits`, bit c is
// set iff some lane's value at c is not +inf. One thread per column;
// blockDim.x is a multiple of 32 so each warp owns one 32-bit word of the
// bitmap.
template <int W, int MODE>
__global__ void pack_kernel(PackSrc s, long long n_idx, int lanes,
                            float* __restrict__ packed,
                            unsigned* __restrict__ live_bits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (c < n_idx) {
    const int tiles = (lanes + W - 1) / W;
    for (int t = 0; t < tiles; ++t) {
      float v[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int l = t * W + k;
        v[k] = l < lanes ? pack_value<MODE>(s, l, c) : CUDART_INF_F;
        live |= v[k] != CUDART_INF_F;
      }
      if (packed != nullptr) {
        store_lanes<W>(packed + ((long long)t * n_idx + c) * W, v);
      }
    }
  }
  if (live_bits != nullptr) {
    const unsigned word = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && c < n_idx) live_bits[c >> 5] = word;
  }
}

// Gather body: thread `tid` of a grid over rows * tpr threads;
// out[l * out_stride + row] for every lane. SKIP: leave out the gathers of
// columns whose bit in live_bits is clear (+inf + w = +inf, the identity of
// min, for every w but -inf and NaN, which are never skipped).
template <int W, bool SKIP>
__device__ __forceinline__ void gather_rows(
    const float* __restrict__ packed, const unsigned* __restrict__ live_bits,
    long long n_idx, const int* __restrict__ cols,
    const float* __restrict__ ws, long long n_rows, int d_pad, int lanes,
    int tpr, float* __restrict__ out, long long out_stride, long long tid) {
  const long long row = tid / tpr;
  const int sub = (int)(tid % tpr);
  // Threads past the last row still take part in the shuffles below (the
  // full-warp mask needs every lane); they only skip the loads and writes.
  const bool valid = row < n_rows;
  const int* crow = cols + (valid ? row : 0) * d_pad;
  const float* wrow = ws + (valid ? row : 0) * d_pad;
  const int tiles = (lanes + W - 1) / W;
  for (int t = 0; t < tiles; ++t) {
    const float* ptile = packed + (long long)t * n_idx * W;
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
        if (c[u] >= 0 && (long long)c[u] < n_idx) {
          if constexpr (SKIP) {
            const bool live =
                (__ldg(live_bits + (c[u] >> 5)) >> (c[u] & 31)) & 1u;
            if (!live && w[u] == w[u] && w[u] != -CUDART_INF_F) continue;
          }
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
        const int l = t * W + k;
        if (l < lanes) out[(long long)l * out_stride + row] = acc[k];
      }
    }
  }
}

template <int W, bool SKIP>
__global__ void gather_min_kernel(const float* __restrict__ packed,
                                  const unsigned* __restrict__ live_bits,
                                  long long n_idx,
                                  const int* __restrict__ cols,
                                  const float* __restrict__ ws,
                                  long long n_rows, int d_pad, int lanes,
                                  int tpr, float* __restrict__ out) {
  gather_rows<W, SKIP>(packed, live_bits, n_idx, cols, ws, n_rows, d_pad,
                       lanes, tpr, out, n_rows,
                       (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

// The lane-tile width for `lanes` gather lanes: the next power of two, at
// most LANE_TILE.
extern "C" int ell_gather_lane_tile(int lanes) {
  int w = 1;
  while (w < lanes && w < LANE_TILE) w *= 2;
  return w;
}

struct Geometry {
  const int* cols;
  const float* ws;
  long long n_rows;
  int d_pad;
  int tpr;
  int threads;
};

// One lane of rows that hold every id needs no copy: it is the packed layout.
inline bool packs_as_is(int mode, const PackSrc& src, long long n_idx,
                        int lanes) {
  return mode == PACK_ROWS && lanes == 1 && src.n_src == n_idx;
}

// One sweep: pack `lanes` lanes of `src` into `packed` (n_idx columns), then
// gather-min them into out (lanes, n_rows). With SKIP the pack pass also
// writes `live_bits` and the gather pass skips clear columns. Returns
// cudaGetLastError() after each launch (0 = all launched).
template <int W, int MODE, bool SKIP>
static int sweep_w(const PackSrc& src, long long n_idx, int lanes,
                   const Geometry& g, float* packed, unsigned* live_bits,
                   float* out, cudaStream_t stream) {
  const bool as_is = packs_as_is(MODE, src, n_idx, lanes);
  if (!as_is || SKIP) {
    const long long blocks1 = (n_idx + g.threads - 1) / g.threads;
    pack_kernel<W, MODE><<<(unsigned)blocks1, g.threads, 0, stream>>>(
        src, n_idx, lanes, as_is ? nullptr : packed,
        SKIP ? live_bits : nullptr);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const long long blocks = (g.n_rows * g.tpr + g.threads - 1) / g.threads;
  gather_min_kernel<W, SKIP><<<(unsigned)blocks, g.threads, 0, stream>>>(
      as_is ? src.a : packed, live_bits, n_idx, g.cols, g.ws, g.n_rows,
      g.d_pad, lanes, g.tpr, out);
  return (int)cudaGetLastError();
}

template <int MODE, bool SKIP>
static int sweep(const PackSrc& src, long long n_idx, int lanes,
                 const Geometry& g, float* packed, unsigned* live_bits,
                 float* out, cudaStream_t stream) {
  switch (ell_gather_lane_tile(lanes)) {
    case 1:
      return sweep_w<1, MODE, SKIP>(src, n_idx, lanes, g, packed, live_bits,
                                    out, stream);
    case 2:
      return sweep_w<2, MODE, SKIP>(src, n_idx, lanes, g, packed, live_bits,
                                    out, stream);
    case 4:
      return sweep_w<4, MODE, SKIP>(src, n_idx, lanes, g, packed, live_bits,
                                    out, stream);
    default:
      return sweep_w<8, MODE, SKIP>(src, n_idx, lanes, g, packed, live_bits,
                                    out, stream);
  }
}

// Single sweep (ell_relax_batch, ell_key_min_batch, ell_gather_min_batch):
// `lanes` rows of n_src floats at `vecs`, gathered over ids in [0, n_idx);
// columns in [n_src, n_idx) read +inf. Scratch: `packed` holds
// ceil(lanes / W) * W * n_idx floats, 16-byte aligned (unused for one lane
// with n_src == n_idx); `live_bits`, for a sparse `vecs`, holds
// ceil(n_idx / 32) words, and null turns the skip off.
extern "C" int ell_gather_min_launch(const float* vecs, long long n_src,
                                     long long n_idx, int lanes,
                                     const int* cols, const float* ws,
                                     long long n_rows, int d_pad, int tpr,
                                     int threads, float* packed,
                                     unsigned* live_bits, float* out,
                                     void* stream) {
  const PackSrc src{vecs, nullptr, nullptr, nullptr, n_src, lanes};
  const Geometry g{cols, ws, n_rows, d_pad, tpr, threads};
  const cudaStream_t s = (cudaStream_t)stream;
  if (live_bits != nullptr) {
    return sweep<PACK_ROWS, true>(src, n_idx, lanes, g, packed, live_bits,
                                  out, s);
  }
  return sweep<PACK_ROWS, false>(src, n_idx, lanes, g, packed, nullptr, out,
                                 s);
}

// Fused in-scan (ell_relax_keys_batch): dmask (B, n), ga/gb/gc (K, B, n)
// unpadded; cols/ws (n, D). Writes upd (B, n) and keys (K, B, n). Scratch:
// `packed` as above for max(B, K * B) lanes over n + 1 columns; `live_bits`
// ceil((n + 1) / 32) words.
extern "C" int ell_relax_keys_launch(const float* dmask, const float* ga,
                                     const float* gb, const float* gc,
                                     long long n, int lanes_b, int k,
                                     const int* cols, const float* ws,
                                     int d_pad, int tpr, int threads,
                                     float* packed, unsigned* live_bits,
                                     float* upd, float* keys, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geometry g{cols, ws, n, d_pad, tpr, threads};
  const PackSrc s0{dmask, nullptr, nullptr, nullptr, n, lanes_b};
  int rc = sweep<PACK_ROWS, true>(s0, n + 1, lanes_b, g, packed, live_bits,
                                  upd, s);
  if (rc != 0) return rc;
  const PackSrc s1{ga, gb, gc, upd, n, lanes_b};
  return sweep<PACK_IN_GATE, false>(s1, n + 1, k * lanes_b, g, packed,
                                    nullptr, keys, s);
}

// Fused out-scan (ell_keys_dep_batch): gates (K0, B, n), dga/dgb (B, n)
// unpadded; cols/ws (n, D). Writes out (K0 + 1, B, n): rows [:K0] from the
// gates, row K0 through min(dga, dgb + out[dep_idx]). Scratch as above for
// max(K0 * B, B) lanes over n + 1 columns.
extern "C" int ell_keys_dep_launch(const float* gates, const float* dga,
                                   const float* dgb, long long n, int lanes_b,
                                   int k0, int dep_idx, const int* cols,
                                   const float* ws, int d_pad, int tpr,
                                   int threads, float* packed, float* out,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geometry g{cols, ws, n, d_pad, tpr, threads};
  const long long row = (long long)lanes_b * n;
  const PackSrc s0{gates, nullptr, nullptr, nullptr, n, lanes_b};
  int rc = sweep<PACK_ROWS, false>(s0, n + 1, k0 * lanes_b, g, packed,
                                   nullptr, out, s);
  if (rc != 0) return rc;
  const PackSrc s1{dga, dgb, out + dep_idx * row, nullptr, n, lanes_b};
  return sweep<PACK_DEP_GATE, false>(s1, n + 1, lanes_b, g, packed, nullptr,
                                     out + k0 * row, s);
}

// ---------------------------------------------------------------------------
// The degree-sliced layout (SlicedEll): every bucket in one gather launch,
// then a merge pass.
//
// Replaces ell_relax_keys.py::ell_sliced_gather_min_batch,
// ell_sliced_relax_keys_batch and ell_sliced_keys_dep_batch. On the TPU each
// was one grid=() step with every bucket and the (n, C) merge plan resident
// in VMEM, and the merge a take + min inside the body. Here a sweep is three
// launches in stream order:
//  * one pack of the gather vector (and, for the relax sweep, the bitmap),
//    shared by every bucket;
//  * one gather launch over a bucket table: each bucket starts at a block
//    boundary, so a block (and each of its warps) has one threads-per-row;
//    the launch writes each bucket's row-mins into a (lanes, R_total)
//    partials scratch at the bucket's row offset in the concatenation;
//    buckets without rows are left out, which keeps the concatenation order;
//  * a merge pass, out[l, v] = min over v's positions in the partials, read
//    from the compact form of merge_idx (its non-sentinel entries, CSR); a
//    vertex with no entry gets +inf, the sentinel's value.
// What bounds them on the card: bytes, as for the padded form: the slots of
// every bucket (sum_b R_b * D_b * 8 bytes, ~0.98 GB a side at kronecker(20)),
// plus the vectors, the partials written and read back and the merge plan
// (~0.3 ms a sweep at 3.35 TB/s). A bucket narrower than a warp shares a
// warp between rows, as a padded row of that width does; split rows of hubs
// are ordinary rows of the widest bucket. The merge adds one pass over
// (lanes, n) outputs and the merge plan, small next to the slots.

#define MAX_SLICES 16

struct SliceEntry {
  const int* cols;
  const float* ws;
  long long n_rows;
  long long first_block;  // first block of this bucket in the gather grid
  long long row_offset;   // first row of this bucket in the concatenation
  int d_pad;
  int tpr;
};

struct SliceTable {
  SliceEntry e[MAX_SLICES];
  int count;
};

template <int W, bool SKIP>
__global__ void sliced_gather_min_kernel(const float* __restrict__ packed,
                                         const unsigned* __restrict__ live_bits,
                                         long long n_idx, SliceTable tab,
                                         int lanes, long long r_total,
                                         float* __restrict__ partials) {
  // constant indices only, so the table stays in parameter space
  SliceEntry s = tab.e[0];
#pragma unroll
  for (int i = 1; i < MAX_SLICES; ++i) {
    if (i < tab.count && (long long)blockIdx.x >= tab.e[i].first_block) {
      s = tab.e[i];
    }
  }
  const long long tid =
      ((long long)blockIdx.x - s.first_block) * blockDim.x + threadIdx.x;
  gather_rows<W, SKIP>(packed, live_bits, n_idx, s.cols, s.ws, s.n_rows,
                       s.d_pad, lanes, s.tpr, partials + s.row_offset,
                       r_total, tid);
}

// out[l, v] = min over merge_pos[merge_ptr[v] .. merge_ptr[v + 1]) of
// partials[l, pos]; a position outside [0, r_total) reads NaN. Grid: (vertex
// blocks, lanes).
__global__ void merge_kernel(const float* __restrict__ partials,
                             long long r_total,
                             const long long* __restrict__ merge_ptr,
                             const int* __restrict__ merge_pos, long long n,
                             float* __restrict__ out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const float* prow = partials + (long long)blockIdx.y * r_total;
  float acc = CUDART_INF_F;
  const long long end = merge_ptr[v + 1];
  for (long long p = merge_ptr[v]; p < end; ++p) {
    const int q = merge_pos[p];
    acc = nan_min(acc, (q >= 0 && q < r_total) ? prow[q] : CUDART_NAN_F);
  }
  out[(long long)blockIdx.y * n + v] = acc;
}

// The bucket table from the host array `table`, 5 int64 per bucket: cols,
// ws, rows, width, threads per row. Buckets without rows are left out.
// Returns 0, or cudaErrorInvalidValue when the table does not fit or its rows
// do not add up to r_total.
static int make_table(const long long* table, int n_slices, int threads,
                      long long r_total, SliceTable* tab,
                      long long* gather_blocks) {
  tab->count = 0;
  long long block = 0, row = 0;
  for (int i = 0; i < n_slices; ++i) {
    const long long* t = table + 5 * i;
    const long long rows = t[2];
    if (rows == 0) continue;
    if (tab->count == MAX_SLICES) return (int)cudaErrorInvalidValue;
    SliceEntry& e = tab->e[tab->count++];
    e.cols = (const int*)t[0];
    e.ws = (const float*)t[1];
    e.n_rows = rows;
    e.d_pad = (int)t[3];
    e.tpr = (int)t[4];
    e.first_block = block;
    e.row_offset = row;
    block += (rows * e.tpr + threads - 1) / threads;
    row += rows;
  }
  if (row != r_total) return (int)cudaErrorInvalidValue;
  *gather_blocks = block;
  return 0;
}

struct SlicedGeometry {
  SliceTable tab;
  long long gather_blocks;
  long long r_total;
  const long long* merge_ptr;
  const int* merge_pos;
  int threads;
};

// One sliced sweep: pack `lanes` lanes of `src` over n_idx = n + 1 columns,
// gather every bucket into `partials`, merge into out (lanes, n).
template <int W, int MODE, bool SKIP>
static int sliced_sweep_w(const PackSrc& src, long long n, int lanes,
                          const SlicedGeometry& g, float* packed,
                          unsigned* live_bits, float* partials, float* out,
                          cudaStream_t stream) {
  const long long n_idx = n + 1;
  if (g.gather_blocks > 0) {
    const long long blocks1 = (n_idx + g.threads - 1) / g.threads;
    pack_kernel<W, MODE><<<(unsigned)blocks1, g.threads, 0, stream>>>(
        src, n_idx, lanes, packed, SKIP ? live_bits : nullptr);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    sliced_gather_min_kernel<W, SKIP>
        <<<(unsigned)g.gather_blocks, g.threads, 0, stream>>>(
            packed, live_bits, n_idx, g.tab, lanes, g.r_total, partials);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid((unsigned)((n + g.threads - 1) / g.threads),
                  (unsigned)lanes);
  merge_kernel<<<grid, g.threads, 0, stream>>>(partials, g.r_total,
                                               g.merge_ptr, g.merge_pos, n,
                                               out);
  return (int)cudaGetLastError();
}

template <int MODE, bool SKIP>
static int sliced_sweep(const PackSrc& src, long long n, int lanes,
                        const SlicedGeometry& g, float* packed,
                        unsigned* live_bits, float* partials, float* out,
                        cudaStream_t stream) {
  switch (ell_gather_lane_tile(lanes)) {
    case 1:
      return sliced_sweep_w<1, MODE, SKIP>(src, n, lanes, g, packed,
                                           live_bits, partials, out, stream);
    case 2:
      return sliced_sweep_w<2, MODE, SKIP>(src, n, lanes, g, packed,
                                           live_bits, partials, out, stream);
    case 4:
      return sliced_sweep_w<4, MODE, SKIP>(src, n, lanes, g, packed,
                                           live_bits, partials, out, stream);
    default:
      return sliced_sweep_w<8, MODE, SKIP>(src, n, lanes, g, packed,
                                           live_bits, partials, out, stream);
  }
}

static int sliced_geometry(const long long* table, int n_slices,
                           long long r_total, const long long* merge_ptr,
                           const int* merge_pos, int threads,
                           SlicedGeometry* g) {
  g->r_total = r_total;
  g->merge_ptr = merge_ptr;
  g->merge_pos = merge_pos;
  g->threads = threads;
  return make_table(table, n_slices, threads, r_total, &g->tab,
                    &g->gather_blocks);
}

// ell_sliced_gather_min_batch: `lanes` unpadded rows of n floats at `vecs`
// (ids in [0, n], the sentinel n reads +inf) -> out (lanes, n). Scratch:
// `packed` as for ell_gather_min_launch over n + 1 columns; `partials`
// lanes * r_total floats; `live_bits` ceil((n + 1) / 32) words for a sparse
// `vecs`, null turns the skip off.
extern "C" int ell_sliced_gather_min_launch(
    const float* vecs, long long n, int lanes, const long long* table,
    int n_slices, long long r_total, const long long* merge_ptr,
    const int* merge_pos, int threads, float* packed, unsigned* live_bits,
    float* partials, float* out, void* stream) {
  SlicedGeometry g;
  int rc = sliced_geometry(table, n_slices, r_total, merge_ptr, merge_pos,
                           threads, &g);
  if (rc != 0) return rc;
  const PackSrc src{vecs, nullptr, nullptr, nullptr, n, lanes};
  const cudaStream_t s = (cudaStream_t)stream;
  if (live_bits != nullptr) {
    return sliced_sweep<PACK_ROWS, true>(src, n, lanes, g, packed, live_bits,
                                         partials, out, s);
  }
  return sliced_sweep<PACK_ROWS, false>(src, n, lanes, g, packed, nullptr,
                                        partials, out, s);
}

// ell_sliced_relax_keys_batch: dmask (B, n), ga/gb/gc (K, B, n) unpadded.
// Writes upd (B, n) and keys (K, B, n). Scratch: `packed` for max(B, K * B)
// lanes over n + 1 columns, `partials` for max(B, K * B) lanes, `live_bits`
// ceil((n + 1) / 32) words.
extern "C" int ell_sliced_relax_keys_launch(
    const float* dmask, const float* ga, const float* gb, const float* gc,
    long long n, int lanes_b, int k, const long long* table, int n_slices,
    long long r_total, const long long* merge_ptr, const int* merge_pos,
    int threads, float* packed, unsigned* live_bits, float* partials,
    float* upd, float* keys, void* stream) {
  SlicedGeometry g;
  int rc = sliced_geometry(table, n_slices, r_total, merge_ptr, merge_pos,
                           threads, &g);
  if (rc != 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const PackSrc s0{dmask, nullptr, nullptr, nullptr, n, lanes_b};
  rc = sliced_sweep<PACK_ROWS, true>(s0, n, lanes_b, g, packed, live_bits,
                                     partials, upd, s);
  if (rc != 0) return rc;
  // the merge above is the barrier: the gate pack reads the merged upd
  const PackSrc s1{ga, gb, gc, upd, n, lanes_b};
  return sliced_sweep<PACK_IN_GATE, false>(s1, n, k * lanes_b, g, packed,
                                           nullptr, partials, keys, s);
}

// ell_sliced_keys_dep_batch: gates (K0, B, n), dga/dgb (B, n) unpadded.
// Writes out (K0 + 1, B, n): rows [:K0] from the gates, row K0 through
// min(dga, dgb + out[dep_idx]). Scratch as above for max(K0 * B, B) lanes.
extern "C" int ell_sliced_keys_dep_launch(
    const float* gates, const float* dga, const float* dgb, long long n,
    int lanes_b, int k0, int dep_idx, const long long* table, int n_slices,
    long long r_total, const long long* merge_ptr, const int* merge_pos,
    int threads, float* packed, float* partials, float* out, void* stream) {
  SlicedGeometry g;
  int rc = sliced_geometry(table, n_slices, r_total, merge_ptr, merge_pos,
                           threads, &g);
  if (rc != 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long row = (long long)lanes_b * n;
  const PackSrc s0{gates, nullptr, nullptr, nullptr, n, lanes_b};
  rc = sliced_sweep<PACK_ROWS, false>(s0, n, k0 * lanes_b, g, packed, nullptr,
                                      partials, out, s);
  if (rc != 0) return rc;
  const PackSrc s1{dga, dgb, out + dep_idx * row, nullptr, n, lanes_b};
  return sliced_sweep<PACK_DEP_GATE, false>(s1, n, lanes_b, g, packed,
                                            nullptr, partials, out + k0 * row,
                                            s);
}
