// ell_gather: the min-plus gather bodies of the port, and the entry points
// built on them.
//
//   out[l, r] = min_j vec[l, cols[r, j]] + ws[r, j]      (l = one gather lane)
//
// Replaces these TPU kernels of the JAX package:
//   * repro/kernels/ell_relax.py::ell_relax_batch (and ell_relax, its B = 1
//     view): the pull-model relaxation, vec = dmask, +inf off the vertices
//     settled this phase, padded by the ops layer. No engine path runs it:
//     the relax of every plan without in-side keys is the push along the
//     outgoing view (ell_push.cu), the same function;
//   * repro/kernels/ell_key_min.py::ell_key_min_batch (and ell_key_min, its
//     B = 1 view): one gate row per lane, padded by the ops layer;
//   * repro/kernels/ell_relax_keys.py::ell_gather_min_batch: V vectors x B
//     lanes = V * B gather lanes over one adjacency;
//   * ell_relax_keys.py::ell_relax_keys_batch (:182, and ell_relax_keys):
//     the fused in-scan, sweep 0 = the relax update, sweep 1 = the next
//     phase's in-side keys through the gate min(ga, min(gb, gc + fin(upd)));
//   * ell_relax_keys.py::ell_keys_dep_batch (:482): the fused out-scan,
//     sweep 0 = the independent keys, sweep 1 = the dependent key through the
//     gate min(dga, dgb + keys0[dep_idx]);
//   * ell_relax_keys.py::ell_sliced_gather_min_batch,
//     ell_sliced_relax_keys_batch and ell_sliced_keys_dep_batch: the same
//     sweeps over a degree-sliced adjacency (the section at the end).
//     The fused scans and the dense single sweeps (ell_key_min_batch,
//     ell_gather_min_batch) run on the pipelined scan body (its own section
//     below, with its own note), all but the sparse relax sweep of the
//     sliced in-scan; the pull (ell_relax_batch), the sliced gather and that
//     sweep on the single-sweep body described here.
//
// What bounds them on an H100: memory. There are no multiplies and min-plus
// has no tensor-core form. A dense sweep (the key gates) needs every slot:
// cols + ws (n * D * 8 bytes) read once plus the vectors and outputs, ~1.3 GB
// and ~0.4 ms at n = 1e6, D = 152, B = 8. A relax sweep needs far less: only
// the settled vertices' edges give candidates, so its least time is their
// out-rows plus dmask and upd (~0.03 ms at phase 200 of the default solve,
// ell_push.cu's note); a pull has to stream the whole in-adjacency to find
// them, which is why the relax is a push. The gather vec[l, cols[r, j]] is
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
//    stream of cols and ws and a bitmap check a slot: the dense bound above,
//    ~12x the relax's own (the push reads only the settled rows). Only the
//    relax sweeps (ell_relax_batch, ell_sliced_gather_min_batch on a relax
//    dmask, and sweep 0 of the fused in-scans) do this. Key gates are dense
//    (0 on every unsettled vertex): a bitmap would skip nothing and cost its
//    check on every slot.
//
// The two-sweep kernels need a grid-wide barrier: sweep 1 gathers from any
// column of sweep 0's output. On the TPU that output stayed resident in VMEM
// across a sequential (2, n_tiles) grid. Here each fused kernel is one C
// entry point that issues pack 0, scan 0, pack 1 (which builds the gate),
// scan 1 in order on one stream; stream order is the barrier. The scan body's
// grid is persistent (SMs x SCAN_BLOCKS_PER_SM blocks), so a cooperative
// launch with grid.sync() between the four passes would fit; it could save
// only the launch gaps, less than the ~0.07 ms a fused call's event time
// exceeds its kernels' device time on the card, and is not built.
//
// Min semantics: jnp.min/jnp.minimum propagate NaN and fminf drops it, so
// every fold and every gate min is nan_min below, which keeps a NaN from
// either side and takes -0 over +0 on a tie in either order, as XLA's min
// does (weights of -0 are legal, so keys can hold -0). Ids in [0, n] are
// the contract (to_ell_in / to_ell_out); an id outside [0, n_idx) reads NaN
// instead of memory out of bounds.
#include <cuda_runtime.h>
#include <math_constants.h>

#define LANE_TILE 8
#define SLOTS 4

// min(m, v) as jnp.minimum gives it: NaN if either is NaN (the canonical
// NaN: card parity takes every NaN as one value), and -0 for a tie of -0
// and +0 in either order. One instruction (PTX min.NaN, sm_80 and later);
// an explicit compare with a sign test for the tie cost the gather loops
// ~40 % (tools/scan_variants.py, nan_min_* variants).
__device__ __forceinline__ float nan_min(float m, float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
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
  const int* status = nullptr;  // the status-gate table's (lanes, n_src)
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

// The status-gate table of an "unsettled" key gate (core/criteria.py:
// gate[l, c] = 0 where status[l, c] < 2, else +inf): byte c of tile t holds
// bit k set where lane t * W + k's gate is 0; columns in [n_src, n_idx) (the
// sentinel) and lanes past the last are clear. One thread per column.
template <int W>
__global__ void pack_status_kernel(const int* __restrict__ status,
                                   long long n_src, long long n_idx,
                                   int lanes,
                                   unsigned char* __restrict__ bits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_idx) return;
  const int tiles = (lanes + W - 1) / W;
  for (int t = 0; t < tiles; ++t) {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int l = t * W + k;
      if (l < lanes && c < n_src && status[(long long)l * n_src + c] < 2) {
        m |= 1u << k;
      }
    }
    bits[(long long)t * n_idx + c] = (unsigned char)m;
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
// most LANE_TILE (kernels/ell_relax_keys.py's lane_tile sizes the packed
// scratch by the same rule).
static int ell_gather_lane_tile(int lanes) {
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

// ---------------------------------------------------------------------------
// The pipelined scan body: the fused scans of the paper's in|out plan, on
// the padded and on the degree-sliced layout.
//
// Replaces ell_relax_keys.py::ell_relax_keys_batch (:182; and
// ell_relax_keys, its B = 1 view), ell_relax_keys.py::ell_keys_dep_batch
// (:482), and their sliced forms ell_sliced_relax_keys_batch (:345) and
// ell_sliced_keys_dep_batch (:394); and, one sweep each, the dense
// gathers ell_relax_keys.py::ell_gather_min_batch (:93) and
// ell_key_min.py::ell_key_min_batch (:86, and ell_key_min, its B = 1 view:
// a one-lane padded gate is the packed table as it stands), which ran on
// the single-sweep body until the pipelined one had shown, on the fused
// scans, that its stream is what that body lacked. The fused scans are two
// sweeps over one adjacency,
// and sweep 1 reads every column of sweep 0's output, so each reads the
// adjacency twice: at n = 1e6, D = 152 the bytes bound is ~0.41 ms a fused
// call counting the adjacency once, ~0.82 ms counting the two reads no
// two-sweep design avoids. What bounds a sweep on an H100 is not those bytes
// but the random reads: a dense 8-lane sweep reads one 32-byte sector of the
// packed table for each of its ~1e8 real slots, and the L1 passes about one
// such request a cycle, at a latency of an L2 hit; the sparse relax sweep
// reads one bitmap word a slot instead. The single-sweep body above also
// streamed cols and ws at ~1.1 TB/s (short blocks, one warp a row, a
// dependent chain of loads each trip). What this body does:
//  * a unit list: a scan walks units of `rows` consecutive rows of one
//    bucket. A padded view is one bucket; a sliced view has a bucket a
//    width with rows, each with its own geometry (threads a row, rows a
//    unit, the chunk of a row a stage holds), and its units follow the
//    previous bucket's, so a block's consecutive units may lie in different
//    buckets. The table of buckets stays in parameter space, and a block
//    steps through it as its units ascend. A table holds MAX_SLICES
//    buckets; a view with more scans them in groups of that many, one
//    launch a group (every view the default boundaries build has at most
//    4, so one launch a sweep);
//  * persistent blocks: SCAN_BLOCKS_PER_SM blocks on each SM walk the units
//    in a grid stride; the sparse relax sweep runs one larger block an SM
//    instead, which holds its bitmap in shared memory (ScanShape below);
//  * the adjacency through shared memory, by warp roles: one producer warp
//    fills a ring of SCAN_STAGES stages, each the cols and ws of one unit
//    (or a chunk of each of its rows, where a unit's rows do not fit a
//    stage), by 1-D bulk copies (cp.async.bulk, the TMA's non-tensor form)
//    that complete on the stage's `full` mbarrier; SCAN_WARPS consumer warps
//    each wait for the stage alone and release it on its `empty` mbarrier,
//    so one warp's gathers overlap another's wait. Alone, the ring streams
//    at ~2.8 TB/s. The copies carry an L2 evict-first hint, so the stream
//    does not push the packed table (32 MB at 8 lanes) out of the L2. A copy
//    takes the 16-byte aligned span around its range (the bulk copy's
//    alignment; such a span never leaves the pages of the range), and
//    readers skip its head;
//  * balanced slots and one request a slot: `tpr` threads a row (a power of
//    two; a unit's rows * D slots fit a stage); at 8 lanes two neighbouring
//    threads share each slot, 4 lanes each, so the slot's sector is one
//    request of the pair; each thread issues SCAN_UNROLL gathers at a time
//    from shared-memory cols;
//  * kept from the body above: the lane-interleaved pack (one 32-byte sector
//    a slot for 8 lanes), the bitmap skip on the sparse relax sweep only,
//    nan_min, NaN for an id outside [0, n_idx).
// A padded row is a vertex and writes its output in place. A sliced view
// writes through: a vertex with exactly one slice-row takes that row's value
// as it stands (the merge's other columns are the +inf sentinel, and
// nan_min(x, +inf) is x, NaN and -0 included), so its row writes
// out[l, owner] directly; the rows of every other vertex (a split hub's)
// go to a compact scratch, and a short merge pass folds them, and writes
// +inf for the vertices with no row (sliced_ell's row_owner and
// merge_short). No pass over every vertex is left.
// The shape was chosen on the card against variants (tools/scan_variants.py
// times them): deeper rings or more blocks leave the L1 too little room for
// the gathers in flight; an L1-bypassing or no-allocate gather and an L2
// evict-last hint on the table are slower or level. Two designs tried on
// the way were slower and are gone: one block-wide barrier a unit (outputs
// staged in shared memory) in place of the warp roles, and a coarse bitmap
// in shared memory beside two blocks an SM (it took the L1's room).
// The grid-wide barrier between the sweeps stays stream order: pack 0,
// scan 0 (merge 0), pack 1 (which builds the gate from sweep 0's output),
// scan 1 (merge 1). A fused call's event time exceeds its kernels' device
// time by ~0.07 ms (chip_smoke.py phase 11): more than a cooperative launch
// could save.

#define SCAN_WARPS 8                      // consumer warps a block
#define SCAN_STAGES 2
#define SCAN_CAP 5120                     // slots of one array a stage holds
#define SCAN_STAGE_ELEMS (SCAN_CAP + 8)   // + the aligned spans' heads, tails
#define SCAN_UNROLL 8
#define SCAN_BLOCKS_PER_SM 2
#define SCAN_SKIP_WARPS 16                // the sparse sweep: one block an SM
#define MAX_SLICES 16         // buckets with rows a scan takes
#define SCAN_TABLE_COLS 10    // int64 a bucket in a host unit table
#define SLICED_WRITE_THROUGH 1
#define SLICED_RELAX_PIPELINED 0  // the sliced relax sweep's body (below)
#define MERGE_THREADS 256

// The launch shape of a sweep: a dense sweep runs SCAN_BLOCKS_PER_SM blocks
// of SCAN_WARPS consumer warps on each SM; the sparse relax sweep (SKIP)
// one block of SCAN_SKIP_WARPS, whose shared memory holds its bitmap whole
// beside the ring where that fits (125 KB at n = 1e6), so the check of a
// slot's column is a shared-memory read and not an L1 request.
template <bool SKIP>
struct ScanShape {
  static constexpr int warps = SKIP ? SCAN_SKIP_WARPS : SCAN_WARPS;
  static constexpr int threads = 32 * warps;  // consumer threads
  static constexpr int blocks = SKIP ? 1 : SCAN_BLOCKS_PER_SM;
};

// One bucket of a scan's unit list: rows of width d_pad, walked in units of
// `rows` rows, `tpr` threads a row, each row in `chunks` stages of `chunk`
// slots (chunks == 1: a unit's rows in one stage).
struct ScanBucket {
  const int* cols;
  const float* ws;
  long long n_rows;
  long long first_unit;  // this bucket's first unit in the scan's list
  long long row_offset;  // its first row in the concatenation of buckets
  int d_pad;
  int tpr;
  int rows;
  int chunk;
  int chunks;
};

struct ScanTable {
  ScanBucket e[MAX_SLICES];
  long long units;  // every bucket's units
  int count;
  int bits_words;   // SKIP: the bitmap's words, when shared memory holds it
};

// Where a scan writes row r of the concatenation, for gather lane l: with
// no owner, out[l * stride + r]; else out[l * stride + owner[r]] for
// owner[r] >= 0, and split[l * split_stride + (-1 - owner[r])] for the rows
// the merge folds.
struct ScanOut {
  float* out;
  long long stride;
  const int* owner;
  float* split;
  long long split_stride;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The 16-byte aligned span around bytes [p, p + nbytes): its start, and
// its length (a multiple of 16). p sits (p & 15) / 4 words into it.
__device__ __forceinline__ void aligned_span(const void* p, long long nbytes,
                                             unsigned long long* start,
                                             unsigned* bytes) {
  const unsigned long long a = (unsigned long long)p;
  *start = a & ~15ull;
  *bytes = (unsigned)(((a + nbytes + 15) & ~15ull) - *start);
}

// A block's walk over its items: units blockIdx.x + q * gridDim.x, each
// for every lane tile, each tile in its bucket's `chunks` stages. A block's
// units ascend, so a step to the next unit only compares it with the next
// bucket's first unit, kept in a register; the bucket is looked up anew only
// when the unit crosses into another (a padded view never does). The table
// is read with constant indices only: a runtime index into a kernel
// parameter would copy it to local memory.
struct ScanCursor {
  long long unit;
  int tile;
  int chunk;
  int bucket;            // the unit's bucket in the table
  long long next_first;  // the first unit past that bucket
  ScanBucket b;          // a copy of the bucket
  __device__ __forceinline__ explicit ScanCursor(const ScanTable& t)
      : unit(blockIdx.x), tile(0), chunk(0), bucket(-1), next_first(0) {
    seek(t);
  }
  __device__ __forceinline__ void seek(const ScanTable& t) {
    if (unit < next_first || unit >= t.units) return;
    bucket = 0;
#pragma unroll
    for (int i = 1; i < MAX_SLICES; ++i) {
      if (i < t.count && unit >= t.e[i].first_unit) bucket = i;
    }
    next_first = t.units;
#pragma unroll
    for (int i = 0; i < MAX_SLICES; ++i) {
      if (i == bucket) b = t.e[i];
      if (i == bucket + 1 && i < t.count) next_first = t.e[i].first_unit;
    }
  }
  __device__ __forceinline__ void next(const ScanTable& t, int tiles) {
    if (++chunk == b.chunks) {
      chunk = 0;
      if (++tile == tiles) {
        tile = 0;
        unit += gridDim.x;
        seek(t);
      }
    }
  }
  // the unit's first row in its bucket
  __device__ __forceinline__ long long r0() const {
    return (unit - b.first_unit) * b.rows;
  }
};

// The producer: the copies of one item into `stage`, completing on
// `bars[stage]`. The smem layout of a stage: cols then ws, each
// SCAN_STAGE_ELEMS 4-byte words; a chunked unit keeps row r at word
// r * (chunk + 8).
__device__ __forceinline__ void scan_issue(const ScanCursor& it,
                                           float* stages,
                                           unsigned long long* bars, int stage,
                                           unsigned long long policy) {
  const ScanBucket& g = it.b;
  const long long r0 = it.r0();
  const int nr = (int)min((long long)g.rows, g.n_rows - r0);
  const int j0 = it.chunk * g.chunk;
  const int len = min(g.chunk, g.d_pad - j0);
  const int copies = g.chunks == 1 ? 1 : nr;  // one span, or one a row
  const long long nbytes = 4ll * (g.chunks == 1 ? (long long)nr * g.d_pad
                                                : len);
  float* dst_c = stages + (long long)stage * 2 * SCAN_STAGE_ELEMS;
  float* dst_w = dst_c + SCAN_STAGE_ELEMS;
  const unsigned bar = smem_u32(bars + stage);
  unsigned total = 0;
  for (int r = 0; r < copies; ++r) {
    const long long off = (r0 + r) * g.d_pad + j0;
    unsigned long long a;
    unsigned b;
    aligned_span(g.cols + off, nbytes, &a, &b);
    total += b;
    aligned_span(g.ws + off, nbytes, &a, &b);
    total += b;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(total) : "memory");
  const int stride = g.chunks == 1 ? 0 : g.chunk + 8;
  for (int r = 0; r < copies; ++r) {
    const long long off = (r0 + r) * g.d_pad + j0;
    const void* src[2] = {g.cols + off, g.ws + off};
    float* dst[2] = {dst_c + r * stride, dst_w + r * stride};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      unsigned long long a;
      unsigned b;
      aligned_span(src[q], nbytes, &a, &b);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
          :: "r"(smem_u32(dst[q])), "l"(a), "r"(b), "r"(bar), "l"(policy)
          : "memory");
    }
  }
}

// One sweep of the pipelined body: every row's min for every lane, written
// as ScanOut says. The last warp is the producer: its lane 0 fills the
// stages in the block's item order, each once every consumer warp has
// released it. The other warps consume: warp w owns rows
// [w * rpw, (w + 1) * rpw) of each unit, rpw = 32 / tpr, and waits for
// nothing but its stage, so one warp's gathers overlap another's.
template <int W, bool SKIP, bool BITS>
__global__ void __launch_bounds__(ScanShape<SKIP>::threads + 32,
                                  ScanShape<SKIP>::blocks)
scan_kernel(const float* __restrict__ packed,
            const unsigned* __restrict__ live_bits, long long n_idx,
            const __grid_constant__ ScanTable tab, int lanes, ScanOut o) {
  constexpr int consumers = ScanShape<SKIP>::threads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      stages + SCAN_STAGES * 2 * SCAN_STAGE_ELEMS);
  unsigned long long* empty = full + SCAN_STAGES;
  const int tiles = (lanes + W - 1) / W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SCAN_STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(empty + s)), "r"(ScanShape<SKIP>::warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the bitmap of a sparse sweep, copied whole into shared memory if it fits
  const unsigned* bits = live_bits;
  if (SKIP && tab.bits_words > 0) {
    unsigned* sbits = reinterpret_cast<unsigned*>(empty + SCAN_STAGES);
    for (int i0 = 0; i0 < tab.bits_words; i0 += 8 * blockDim.x) {
      unsigned w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * blockDim.x + threadIdx.x;
        w[e] = i < tab.bits_words ? __ldg(live_bits + i) : 0u;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * blockDim.x + threadIdx.x;
        if (i < tab.bits_words) sbits[i] = w[e];
      }
    }
    bits = sbits;
  }
  __syncthreads();
  if (threadIdx.x >= consumers) {  // the producer warp
    if (threadIdx.x == consumers) {
      unsigned long long policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(policy));
      int stage = 0;
      unsigned round = 0;
      for (ScanCursor it(tab); it.unit < tab.units; it.next(tab, tiles)) {
        if (round > 0) {
          mbar_wait(smem_u32(empty + stage), (round - 1) & 1u);
        }
        scan_issue(it, stages, full, stage, policy);
        if (++stage == SCAN_STAGES) {
          stage = 0;
          ++round;
        }
      }
    }
    return;
  }
  // H threads share a slot, each folding WL of its W lanes: the slot's one
  // 32-byte sector is then one request of the pair, not two of one thread
  // (the L1 passes about one cache line a cycle, so a random gather costs a
  // cycle a request)
  constexpr int H = W > 4 ? W / 4 : 1;
  constexpr int WL = W / H;
  int stage = 0;
  unsigned parity = 0;
  float acc[WL];
  // this thread's place in a unit, set anew where the bucket changes
  int bucket = -1, row_l = 0, sub = 0, part = 0, step = 1;
  for (ScanCursor it(tab); it.unit < tab.units; it.next(tab, tiles)) {
    const ScanBucket& g = it.b;
    if (it.bucket != bucket) {
      bucket = it.bucket;
      row_l = threadIdx.x / g.tpr;
      sub = threadIdx.x % g.tpr;
      part = sub % H;    // which WL lanes of the tile
      step = g.tpr / H;  // slot-parallel threads a row
    }
    const long long r0 = it.r0();
    const int nr = (int)min((long long)g.rows, g.n_rows - r0);
    if (it.chunk == 0) {
#pragma unroll
      for (int k = 0; k < WL; ++k) acc[k] = CUDART_INF_F;
    }
    mbar_wait(smem_u32(full + stage), parity);
    if (row_l < nr) {
      const int j0 = it.chunk * g.chunk;
      const int len = min(g.chunk, g.d_pad - j0);
      // where this row's slots start in the stage: the aligned span's head
      // of the unit's (or the row's) copy, then the row
      const long long off = g.chunks == 1 ? r0 * g.d_pad
                                          : (r0 + row_l) * g.d_pad + j0;
      const int lead = g.chunks == 1 ? row_l * g.d_pad : row_l * (g.chunk + 8);
      const float* sbase = stages + stage * 2 * SCAN_STAGE_ELEMS;
      const int* sc = reinterpret_cast<const int*>(sbase) + lead +
                      (int)(((unsigned long long)(g.cols + off) & 15) >> 2);
      const float* sw = sbase + SCAN_STAGE_ELEMS + lead +
                        (int)(((unsigned long long)(g.ws + off) & 15) >> 2);
      const float* ptile = packed + (long long)it.tile * n_idx * W + part * WL;
      for (int j = sub / H; j < len; j += SCAN_UNROLL * step) {
        int cu[SCAN_UNROLL];
        float wu[SCAN_UNROLL];
        float v[SCAN_UNROLL][WL];
#pragma unroll
        for (int u = 0; u < SCAN_UNROLL; ++u) {
          const int jj = j + u * step;
          const bool in_row = jj < len;
          cu[u] = in_row ? sc[jj] : 0;
          wu[u] = in_row ? sw[jj] : CUDART_INF_F;
          bool take = in_row;
          const bool valid = cu[u] >= 0 && (long long)cu[u] < n_idx;
          if constexpr (SKIP) {
            if (take && valid && wu[u] == wu[u] && wu[u] != -CUDART_INF_F) {
              take = (bits[cu[u] >> 5] >> (cu[u] & 31)) & 1u;
            }
          }
          if (take && valid && BITS) {
            // the status-gate table: this thread's WL bits of the byte
            const unsigned m = __ldg(
                reinterpret_cast<const unsigned char*>(packed) +
                (long long)it.tile * n_idx + cu[u]);
#pragma unroll
            for (int k = 0; k < WL; ++k) {
              v[u][k] = (m >> (part * WL + k)) & 1u ? 0.0f : CUDART_INF_F;
            }
          } else if (take && valid) {
            load_lanes<WL>(ptile + (long long)cu[u] * W, v[u]);
          } else {
#pragma unroll
            for (int k = 0; k < WL; ++k) {
              v[u][k] = take ? CUDART_NAN_F : CUDART_INF_F;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < SCAN_UNROLL; ++u) {
#pragma unroll
          for (int k = 0; k < WL; ++k) {
            acc[k] = nan_min(acc[k], v[u][k] + wu[u]);
          }
        }
      }
    }
    __syncwarp();  // the warp has read its rows of the stage: release it
    if ((threadIdx.x & 31) == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                   :: "r"(smem_u32(empty + stage)) : "memory");
    }
    if (++stage == SCAN_STAGES) {
      stage = 0;
      parity ^= 1u;
    }
    if (it.chunk == g.chunks - 1) {
#pragma unroll
      for (int k = 0; k < WL; ++k) {
        for (int q = g.tpr >> 1; q >= H; q >>= 1) {
          acc[k] = nan_min(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], q));
        }
      }
      if (sub < H && row_l < nr) {
        const long long row = g.row_offset + r0 + row_l;
        float* dst = o.out + row;
        long long stride = o.stride;
        if (o.owner != nullptr) {
          const int v = __ldg(o.owner + row);
          dst = v >= 0 ? o.out + v : o.split + (-1 - (long long)v);
          stride = v >= 0 ? o.stride : o.split_stride;
        }
#pragma unroll
        for (int k = 0; k < WL; ++k) {
          const int l = it.tile * W + part * WL + k;
          if (l < lanes) dst[(long long)l * stride] = acc[k];
        }
      }
    }
  }
}

// Whether bucket `b` fits the body's shape for lane tiles of W: `tpr` a
// power of two in [H, 32], rows * tpr the consumer threads, and a unit's
// rows (or their chunks) within a stage. A host table that breaks one is
// refused, never run.
template <int W, bool SKIP>
static bool bucket_fits(const ScanBucket& b) {
  constexpr int shared_by = W > 4 ? W / 4 : 1;  // the kernel's H
  if (b.tpr < shared_by || b.tpr > 32 || (b.tpr & (b.tpr - 1)) != 0) {
    return false;
  }
  if (b.rows * b.tpr != ScanShape<SKIP>::threads) return false;
  if (b.d_pad < 1 || b.chunk < 1 || b.chunk > b.d_pad) return false;
  if (b.chunks != (b.d_pad + b.chunk - 1) / b.chunk) return false;
  if (b.chunks == 1) return (long long)b.rows * b.d_pad <= SCAN_CAP;
  return (long long)b.rows * (b.chunk + 8) <= SCAN_CAP;
}

struct Adjacency {
  const int* cols;
  const float* ws;
  long long n_rows;
  int d_pad;
};

// The one-bucket table of a padded view for lane tiles of W.
template <int W, bool SKIP>
static ScanTable scan_geometry(const Adjacency& a) {
  constexpr int threads = ScanShape<SKIP>::threads;
  ScanBucket g;
  g.cols = a.cols;
  g.ws = a.ws;
  g.n_rows = a.n_rows;
  g.first_unit = 0;
  g.row_offset = 0;
  g.d_pad = a.d_pad;
  const int d_pad = a.d_pad;
  g.tpr = W > 4 ? W / 4 : 1;  // the threads that share one slot's sector
  while (g.tpr < 32 && (long long)(threads / g.tpr) * d_pad > SCAN_CAP) {
    g.tpr *= 2;
  }
  g.rows = threads / g.tpr;
  if ((long long)g.rows * d_pad <= SCAN_CAP) {
    g.chunk = d_pad;
  } else {  // rows wider than a stage: each row's chunks, row by row
    g.chunk = (SCAN_CAP / g.rows - 8) & ~3;
  }
  g.chunks = (d_pad + g.chunk - 1) / g.chunk;
  ScanTable t;
  t.e[0] = g;
  t.count = 1;
  t.units = (a.n_rows + g.rows - 1) / g.rows;
  t.bits_words = 0;
  return t;
}

// Group `first / MAX_SLICES` of a sliced view's buckets, `count` of them,
// from the host array `rows`, SCAN_TABLE_COLS int64 a bucket with rows
// (kernels/ell_sliced.py builds it: cols, ws, rows, width, threads a row,
// rows a unit, chunk, chunks, first unit (from 0 in each group), first row
// in the concatenation). `row` is the group's first row and steps past its
// last. Returns 0, or cudaErrorInvalidValue for a group that does not fit
// this build's shape or leaves a row out.
template <int W, bool SKIP>
static int host_group(const long long* rows, int first, int count,
                      long long* row, ScanTable* t) {
  long long unit = 0;
  t->count = count;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + SCAN_TABLE_COLS * (first + i);
    ScanBucket& b = t->e[i];
    b.cols = (const int*)r[0];
    b.ws = (const float*)r[1];
    b.n_rows = r[2];
    b.d_pad = (int)r[3];
    b.tpr = (int)r[4];
    b.rows = (int)r[5];
    b.chunk = (int)r[6];
    b.chunks = (int)r[7];
    b.first_unit = r[8];
    b.row_offset = r[9];
    if (b.n_rows < 1 || !bucket_fits<W, SKIP>(b) || b.first_unit != unit ||
        b.row_offset != *row) {
      return (int)cudaErrorInvalidValue;
    }
    unit += (b.n_rows + b.rows - 1) / b.rows;
    *row += b.n_rows;
  }
  t->units = unit;
  t->bits_words = 0;
  return 0;
}

// What a sweep scans: a padded view, or a sliced view's host table.
struct ScanPlan {
  const Adjacency* padded;
  const long long* table;
  int n_buckets;
  long long r_total;
};

// The launches of a sweep: one for a padded view, one for each group of
// MAX_SLICES buckets of a sliced view.
static int scan_groups(const ScanPlan& p) {
  return p.padded != nullptr ? 1 : (p.n_buckets + MAX_SLICES - 1) / MAX_SLICES;
}

// The table of launch g of a sweep (`row` as for host_group).
template <int W, bool SKIP>
static int scan_table(const ScanPlan& p, int g, long long* row,
                      ScanTable* t) {
  if (p.padded != nullptr) {
    *t = scan_geometry<W, SKIP>(*p.padded);
    return 0;
  }
  const int first = g * MAX_SLICES;
  const int count = p.n_buckets - first < MAX_SLICES ? p.n_buckets - first
                                                     : MAX_SLICES;
  return host_group<W, SKIP>(p.table, first, count, row, t);
}

// Pack then scan: one sweep on the pipelined body. A sliced view with more
// than MAX_SLICES buckets with rows scans them in groups, one launch each
// after the one pack, in stream order: buckets own disjoint rows, and a row
// writes its own output (or compact-scratch) slot, so the groups add up to
// the one launch they stand for. Every group is checked before anything is
// launched. One lane of rows that already hold every id is the packed
// layout as it stands and is not copied.
template <int W, int MODE, bool SKIP, bool BITS>
static int scan_sweep_w(const PackSrc& src, long long n_idx, int lanes,
                        const ScanPlan& p, const ScanOut& o, float* packed,
                        unsigned* live_bits, cudaStream_t stream) {
  if (p.padded == nullptr && p.n_buckets < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = scan_groups(p);
  ScanTable tab;
  long long row = 0, units = 0;
  for (int g = 0; g < groups; ++g) {
    const int rc = scan_table<W, SKIP>(p, g, &row, &tab);
    if (rc != 0) return rc;
    units += tab.units;
  }
  if (p.padded == nullptr && row != p.r_total) {
    return (int)cudaErrorInvalidValue;
  }
  if (units == 0) return 0;  // no rows: nothing to gather
  const bool as_is = !SKIP && !BITS && packs_as_is(MODE, src, n_idx, lanes);
  int rc = 0;
  if (!as_is) {
    constexpr int pack_threads = ScanShape<false>::threads;
    const long long blocks1 = (n_idx + pack_threads - 1) / pack_threads;
    if (BITS) {
      pack_status_kernel<W><<<(unsigned)blocks1, pack_threads, 0, stream>>>(
          src.status, src.n_src, n_idx, lanes,
          reinterpret_cast<unsigned char*>(packed));
    } else {
      pack_kernel<W, MODE><<<(unsigned)blocks1, pack_threads, 0, stream>>>(
          src, n_idx, lanes, packed, SKIP ? live_bits : nullptr);
    }
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  size_t smem = sizeof(float) * SCAN_STAGES * 2 * SCAN_STAGE_ELEMS +
                sizeof(unsigned long long) * 2 * SCAN_STAGES;
  int dev = 0, sms = 0, smem_max = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc == 0) {
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == 0) {
    rc = (int)cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != 0) return rc;
  const long long words = (n_idx + 31) / 32;
  const bool bits_in_smem = SKIP && (long long)smem + 4 * words <= smem_max;
  if (bits_in_smem) smem += 4 * words;
  rc = (int)cudaFuncSetAttribute(scan_kernel<W, SKIP, BITS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc != 0) return rc;
  // persistent: ScanShape<SKIP>::blocks blocks on each SM walk every unit
  const long long fit = (long long)sms * ScanShape<SKIP>::blocks;
  row = 0;
  for (int g = 0; g < groups; ++g) {
    scan_table<W, SKIP>(p, g, &row, &tab);  // checked above
    tab.bits_words = bits_in_smem ? (int)words : 0;
    const long long grid = tab.units < fit ? tab.units : fit;
    scan_kernel<W, SKIP, BITS>
        <<<(unsigned)grid, ScanShape<SKIP>::threads + 32, smem, stream>>>(
            as_is ? src.a : packed, live_bits, n_idx, tab, lanes, o);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

// BITS: `packed` holds the status-gate table of src.status (bytes) in
// place of the f32 packed lanes.
template <int MODE, bool SKIP, bool BITS = false>
static int scan_sweep(const PackSrc& src, long long n_idx, int lanes,
                      const ScanPlan& p, const ScanOut& o, float* packed,
                      unsigned* live_bits, cudaStream_t stream) {
  switch (ell_gather_lane_tile(lanes)) {
    case 1:
      return scan_sweep_w<1, MODE, SKIP, BITS>(src, n_idx, lanes, p, o,
                                               packed, live_bits, stream);
    case 2:
      return scan_sweep_w<2, MODE, SKIP, BITS>(src, n_idx, lanes, p, o,
                                               packed, live_bits, stream);
    case 4:
      return scan_sweep_w<4, MODE, SKIP, BITS>(src, n_idx, lanes, p, o,
                                               packed, live_bits, stream);
    default:
      return scan_sweep_w<8, MODE, SKIP, BITS>(src, n_idx, lanes, p, o,
                                               packed, live_bits, stream);
  }
}

// Single sweep (ell_relax_batch, ell_key_min_batch, ell_gather_min_batch):
// `lanes` rows of n_src floats at `vecs`, gathered over ids in [0, n_idx);
// columns in [n_src, n_idx) read +inf. Scratch: `packed` holds
// ceil(lanes / W) * W * n_idx floats, 16-byte aligned (unused for one lane
// with n_src == n_idx); `live_bits`, for a sparse `vecs`, holds
// ceil(n_idx / 32) words, and null turns the skip off.
// threads == 0: a dense sweep (no live_bits) on the pipelined scan body
// below, the body of ell_key_min_batch and ell_gather_min_batch: a padded
// view as one bucket of its unit list, in the launch shape of the fused
// scans' dense sweeps. threads > 0: the single-sweep body above, `tpr`
// threads a row and `threads` a block, the body of the sparse pull
// (ell_relax_batch), which the dense sweeps ran on before (a caller may
// still ask for it, to time the two in turns).
extern "C" int ell_gather_min_launch(const float* vecs, long long n_src,
                                     long long n_idx, int lanes,
                                     const int* cols, const float* ws,
                                     long long n_rows, int d_pad, int tpr,
                                     int threads, float* packed,
                                     unsigned* live_bits, float* out,
                                     void* stream) {
  const PackSrc src{vecs, nullptr, nullptr, nullptr, n_src, lanes};
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 0) {
    if (live_bits != nullptr) return (int)cudaErrorInvalidValue;
    const Adjacency a{cols, ws, n_rows, d_pad};
    return scan_sweep<PACK_ROWS, false>(
        src, n_idx, lanes, ScanPlan{&a, nullptr, 0, n_rows},
        ScanOut{out, n_rows, nullptr, nullptr, 0}, packed, nullptr, s);
  }
  const Geometry g{cols, ws, n_rows, d_pad, tpr, threads};
  if (live_bits != nullptr) {
    return sweep<PACK_ROWS, true>(src, n_idx, lanes, g, packed, live_bits,
                                  out, s);
  }
  return sweep<PACK_ROWS, false>(src, n_idx, lanes, g, packed, nullptr, out,
                                 s);
}

// The dense single sweep of an "unsettled" key gate from the lanes' status
// (ell_gather_min_batch / ell_key_min_batch on such gates, chosen by the ops
// layer from the gate's kind): `status` (lanes, n_src) int32, ids in
// [0, n_idx), columns past n_src (the sentinel) read +inf. The pack writes
// the status-gate table, one byte of lane bits a column (n_idx bytes a tile
// of 8 lanes, against 32 bytes a column of f32 lanes), into `bits`
// (ceil(lanes / W) * n_idx bytes), and the scan reads one byte a slot and
// puts back the gate's +0 or +inf before the same add and nan_min as the f32
// path: bit-equal to it for every weight, -0 and NaN included. Timed
// against the f32 path on the pipelined body, it reads less and is the
// faster (PERF.md, PR 17).
extern "C" int ell_gather_min_status_launch(const int* status,
                                            long long n_src, long long n_idx,
                                            int lanes, const int* cols,
                                            const float* ws, long long n_rows,
                                            int d_pad, unsigned char* bits,
                                            float* out, void* stream) {
  PackSrc src{nullptr, nullptr, nullptr, nullptr, n_src, lanes};
  src.status = status;
  const Adjacency a{cols, ws, n_rows, d_pad};
  return scan_sweep<PACK_ROWS, false, true>(
      src, n_idx, lanes, ScanPlan{&a, nullptr, 0, n_rows},
      ScanOut{out, n_rows, nullptr, nullptr, 0},
      reinterpret_cast<float*>(bits), nullptr, (cudaStream_t)stream);
}

// Fused in-scan (ell_relax_keys_batch): dmask (B, n), ga/gb/gc (K, B, n)
// unpadded; cols/ws (n, D). Writes upd (B, n) and keys (K, B, n). Scratch:
// `packed` as above for max(B, K * B) lanes over n + 1 columns; `live_bits`
// ceil((n + 1) / 32) words.
extern "C" int ell_relax_keys_launch(const float* dmask, const float* ga,
                                     const float* gb, const float* gc,
                                     long long n, int lanes_b, int k,
                                     const int* cols, const float* ws,
                                     int d_pad, float* packed,
                                     unsigned* live_bits, float* upd,
                                     float* keys, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Adjacency a{cols, ws, n, d_pad};
  const ScanPlan p{&a, nullptr, 0, n};
  const PackSrc s0{dmask, nullptr, nullptr, nullptr, n, lanes_b};
  int rc = scan_sweep<PACK_ROWS, true>(s0, n + 1, lanes_b, p,
                                       ScanOut{upd, n, nullptr, nullptr, 0},
                                       packed, live_bits, s);
  if (rc != 0) return rc;
  const PackSrc s1{ga, gb, gc, upd, n, lanes_b};
  return scan_sweep<PACK_IN_GATE, false>(s1, n + 1, k * lanes_b, p,
                                         ScanOut{keys, n, nullptr, nullptr, 0},
                                         packed, nullptr, s);
}

// Fused out-scan (ell_keys_dep_batch): gates (K0, B, n), dga/dgb (B, n)
// unpadded; cols/ws (n, D). Writes out (K0 + 1, B, n): rows [:K0] from the
// gates, row K0 through min(dga, dgb + out[dep_idx]). Scratch as above for
// max(K0 * B, B) lanes over n + 1 columns.
extern "C" int ell_keys_dep_launch(const float* gates, const float* dga,
                                   const float* dgb, long long n, int lanes_b,
                                   int k0, int dep_idx, const int* cols,
                                   const float* ws, int d_pad, float* packed,
                                   float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Adjacency a{cols, ws, n, d_pad};
  const ScanPlan p{&a, nullptr, 0, n};
  const long long row = (long long)lanes_b * n;
  const PackSrc s0{gates, nullptr, nullptr, nullptr, n, lanes_b};
  int rc = scan_sweep<PACK_ROWS, false>(s0, n + 1, k0 * lanes_b, p,
                                        ScanOut{out, n, nullptr, nullptr, 0},
                                        packed, nullptr, s);
  if (rc != 0) return rc;
  const PackSrc s1{dga, dgb, out + dep_idx * row, nullptr, n, lanes_b};
  return scan_sweep<PACK_DEP_GATE, false>(
      s1, n + 1, lanes_b, p, ScanOut{out + k0 * row, n, nullptr, nullptr, 0},
      packed, nullptr, s);
}

// ---------------------------------------------------------------------------
// The degree-sliced layout (SlicedEll).
//
// Replaces ell_relax_keys.py::ell_sliced_gather_min_batch,
// ell_sliced_relax_keys_batch and ell_sliced_keys_dep_batch. On the TPU each
// was one grid=() step with every bucket and the (n, C) merge plan resident
// in VMEM, and the merge a take + min inside the body. What bounds them on
// the card: bytes, as for the padded form: the slots of every bucket
// (sum_b R_b * D_b * 8 bytes, ~0.98 GB a side at kronecker(20)), plus the
// vectors and outputs (~0.3 ms a sweep at 3.35 TB/s), and then the random
// reads, as above. A bucket narrower than a warp shares a warp between
// rows, as a padded row of that width does; split rows of hubs are ordinary
// rows of the widest bucket.
//
// The fused scans' dense sweeps (both of ell_sliced_keys_dep_batch, the
// gate sweep of ell_sliced_relax_keys_batch) run on the pipelined body with
// write-through: a sweep is a pack, a scan over the unit list of every
// bucket, and the short merge below (the vertices with no row or with
// several: split hubs and the vertices of degree 0). The sparse relax
// sweep of ell_sliced_relax_keys_batch, where no push takes its place, and
// ell_sliced_gather_min_batch keep the single-sweep body: a pack, one
// gather launch over a bucket table (each bucket starts at a block
// boundary, so a block has one threads-per-row) into a (lanes, R_total)
// partials scratch at each bucket's row offset in the concatenation, and a
// merge pass over every vertex, read from the compact form of merge_idx
// (its non-sentinel entries, CSR); a vertex with no entry gets +inf, the
// sentinel's value. Buckets without rows are left out, which keeps the
// concatenation order.

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

// The merge plan of a write-through sweep, from the host array `plan` of 8
// int64 (kernels/ell_sliced.py): row_owner, merge_ptr, merge_pos,
// merge_short, then r_total, the short list's length, its leading vertices
// that have rows (merge_multi), and the rows the scratch holds (split_rows).
struct MergePlan {
  const int* owner;
  const long long* merge_ptr;
  const int* merge_pos;
  const int* short_list;
  long long r_total;
  long long n_short;
  long long n_multi;
  long long n_split;
};

static MergePlan merge_plan(const long long* plan) {
  return MergePlan{(const int*)plan[0], (const long long*)plan[1],
                   (const int*)plan[2], (const int*)plan[3], plan[4], plan[5],
                   plan[6], plan[7]};
}

// The short merge: out[l, v] for the vertices v of the short list. Its
// first n_multi vertices have rows in the scratch, one warp a vertex
// folding them (a hub's hundreds of rows in 32 strides, then the warp's
// shuffles); the rest have no row and get +inf. A position outside
// [0, r_total), or whose row was written through, reads NaN. Grid:
// (multi_blocks + blocks of the rest, lanes).
__global__ void __launch_bounds__(MERGE_THREADS)
short_merge_kernel(const float* __restrict__ split, long long split_stride,
                   MergePlan m, long long multi_blocks,
                   float* __restrict__ out, long long n) {
  const long long l = blockIdx.y;
  if ((long long)blockIdx.x < multi_blocks) {
    const long long i = (long long)blockIdx.x * (MERGE_THREADS / 32) +
                        (threadIdx.x >> 5);
    if (i >= m.n_multi) return;  // the whole warp
    const int lane = threadIdx.x & 31;
    const int v = m.short_list[i];
    float acc = CUDART_INF_F;
    const long long end = m.merge_ptr[v + 1];
    for (long long p = m.merge_ptr[v] + lane; p < end; p += 32) {
      const int q = m.merge_pos[p];
      const long long s =
          (q >= 0 && q < m.r_total) ? -1 - (long long)m.owner[q] : -1;
      acc = nan_min(acc, (s >= 0 && s < m.n_split)
                             ? split[l * split_stride + s] : CUDART_NAN_F);
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc = nan_min(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) out[l * n + v] = acc;
  } else {
    const long long i = m.n_multi +
                        ((long long)blockIdx.x - multi_blocks) * MERGE_THREADS +
                        threadIdx.x;
    if (i < m.n_short) out[l * n + m.short_list[i]] = CUDART_INF_F;
  }
}

// One write-through sweep of a fused sliced scan: pack `lanes` lanes of
// `src` over n + 1 columns, scan every bucket (rows of single-row vertices
// straight into out (lanes, n), the others into `split`), then the short
// merge. With SLICED_WRITE_THROUGH 0 (a variant tools/scan_variants.py
// times) every row goes to `split` (lanes * r_total floats then) and the
// merge runs over every vertex.
template <int MODE, bool SKIP>
static int sliced_scan_sweep(const PackSrc& src, long long n, int lanes,
                             const long long* table, int n_buckets,
                             const MergePlan& m, float* packed,
                             unsigned* live_bits, float* split, float* out,
                             cudaStream_t stream) {
  const ScanPlan p{nullptr, table, n_buckets, m.r_total};
#if SLICED_WRITE_THROUGH
  int rc = scan_sweep<MODE, SKIP>(src, n + 1, lanes, p,
                                  ScanOut{out, n, m.owner, split, m.n_split},
                                  packed, live_bits, stream);
  if (rc != 0 || m.n_short == 0) return rc;
  constexpr long long per_block = MERGE_THREADS / 32;
  const long long multi_blocks = (m.n_multi + per_block - 1) / per_block;
  const long long rest_blocks =
      (m.n_short - m.n_multi + MERGE_THREADS - 1) / MERGE_THREADS;
  short_merge_kernel<<<dim3((unsigned)(multi_blocks + rest_blocks),
                            (unsigned)lanes),
                       MERGE_THREADS, 0, stream>>>(split, m.n_split, m,
                                                   multi_blocks, out, n);
#else
  const ScanOut all_rows{split, m.r_total, nullptr, nullptr, 0};
  int rc = scan_sweep<MODE, SKIP>(src, n + 1, lanes, p, all_rows, packed,
                                  live_bits, stream);
  if (rc != 0) return rc;
  merge_kernel<<<dim3((unsigned)((n + MERGE_THREADS - 1) / MERGE_THREADS),
                      (unsigned)lanes),
                 MERGE_THREADS, 0, stream>>>(split, m.r_total, m.merge_ptr,
                                             m.merge_pos, n, out);
#endif
  return (int)cudaGetLastError();
}

// The bucket tables of the single-sweep body from the host array `table`,
// 5 int64 per bucket: cols, ws, rows, width, threads per row. Buckets
// without rows are left out; the others go in groups of MAX_SLICES, in
// order, one gather launch a group. next_group fills `tab` with the group
// that starts at bucket *i and steps *i past it; `row` is the group's
// first row in the concatenation and steps past its last. Returns 0, or
// cudaErrorInvalidValue for a bucket with no threads a row.
static int next_group(const long long* table, int n_slices, int threads,
                      int* i, long long* row, SliceTable* tab,
                      long long* gather_blocks) {
  tab->count = 0;
  long long block = 0;
  for (; *i < n_slices && tab->count < MAX_SLICES; ++*i) {
    const long long* t = table + 5 * *i;
    const long long rows = t[2];
    if (rows == 0) continue;
    if (t[4] < 1 || t[3] < 1) return (int)cudaErrorInvalidValue;
    SliceEntry& e = tab->e[tab->count++];
    e.cols = (const int*)t[0];
    e.ws = (const float*)t[1];
    e.n_rows = rows;
    e.d_pad = (int)t[3];
    e.tpr = (int)t[4];
    e.first_block = block;
    e.row_offset = *row;
    block += (rows * e.tpr + threads - 1) / threads;
    *row += rows;
  }
  *gather_blocks = block;
  return 0;
}

// Whether the bucket table's rows add up to r_total (every group in range).
static int check_table(const long long* table, int n_slices, int threads,
                       long long r_total) {
  if (n_slices < 0 || threads < 32 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  SliceTable tab;
  long long row = 0, blocks = 0;
  for (int i = 0; i < n_slices;) {
    const int rc = next_group(table, n_slices, threads, &i, &row, &tab,
                              &blocks);
    if (rc != 0) return rc;
  }
  return row == r_total ? 0 : (int)cudaErrorInvalidValue;
}

// ell_sliced_gather_min_batch on the single-sweep body: pack `lanes` lanes
// of `src` over n_idx = n + 1 columns, gather every bucket into `partials`
// (one launch a group of MAX_SLICES buckets, each at its rows' offset), then
// merge into out (lanes, n). The table is checked (check_table) first.
template <int W, bool SKIP>
static int sliced_gather_w(const PackSrc& src, long long n, int lanes,
                           const long long* table, int n_slices,
                           long long r_total, const long long* merge_ptr,
                           const int* merge_pos, int threads, float* packed,
                           unsigned* live_bits, float* partials, float* out,
                           cudaStream_t stream) {
  const long long n_idx = n + 1;
  if (r_total > 0) {
    const long long blocks1 = (n_idx + threads - 1) / threads;
    pack_kernel<W, PACK_ROWS><<<(unsigned)blocks1, threads, 0, stream>>>(
        src, n_idx, lanes, packed, SKIP ? live_bits : nullptr);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    SliceTable tab;
    long long row = 0, gather_blocks = 0;
    for (int i = 0; i < n_slices;) {
      next_group(table, n_slices, threads, &i, &row, &tab, &gather_blocks);
      if (gather_blocks == 0) continue;
      sliced_gather_min_kernel<W, SKIP>
          <<<(unsigned)gather_blocks, threads, 0, stream>>>(
              packed, live_bits, n_idx, tab, lanes, r_total, partials);
      rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
  }
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)lanes);
  merge_kernel<<<grid, threads, 0, stream>>>(partials, r_total, merge_ptr,
                                             merge_pos, n, out);
  return (int)cudaGetLastError();
}

template <bool SKIP>
static int sliced_gather(const PackSrc& src, long long n, int lanes,
                         const long long* table, int n_slices,
                         long long r_total, const long long* merge_ptr,
                         const int* merge_pos, int threads, float* packed,
                         unsigned* live_bits, float* partials, float* out,
                         cudaStream_t stream) {
  const int rc = check_table(table, n_slices, threads, r_total);
  if (rc != 0) return rc;
  switch (ell_gather_lane_tile(lanes)) {
    case 1:
      return sliced_gather_w<1, SKIP>(src, n, lanes, table, n_slices,
                                      r_total, merge_ptr, merge_pos, threads,
                                      packed, live_bits, partials, out, stream);
    case 2:
      return sliced_gather_w<2, SKIP>(src, n, lanes, table, n_slices,
                                      r_total, merge_ptr, merge_pos, threads,
                                      packed, live_bits, partials, out, stream);
    case 4:
      return sliced_gather_w<4, SKIP>(src, n, lanes, table, n_slices,
                                      r_total, merge_ptr, merge_pos, threads,
                                      packed, live_bits, partials, out, stream);
    default:
      return sliced_gather_w<8, SKIP>(src, n, lanes, table, n_slices,
                                      r_total, merge_ptr, merge_pos, threads,
                                      packed, live_bits, partials, out, stream);
  }
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
  const PackSrc src{vecs, nullptr, nullptr, nullptr, n, lanes};
  const cudaStream_t s = (cudaStream_t)stream;
  if (live_bits != nullptr) {
    return sliced_gather<true>(src, n, lanes, table, n_slices, r_total,
                               merge_ptr, merge_pos, threads, packed,
                               live_bits, partials, out, s);
  }
  return sliced_gather<false>(src, n, lanes, table, n_slices, r_total,
                              merge_ptr, merge_pos, threads, packed, nullptr,
                              partials, out, s);
}

// ell_sliced_relax_keys_batch: dmask (B, n), ga/gb/gc (K, B, n) unpadded.
// Writes upd (B, n) and keys (K, B, n). The relax sweep (B lanes, sparse)
// runs on the single-sweep body, from `relax_table` (next_group's five
// int64 a bucket, `threads` a block) into `partials` (B * r_total floats)
// and the merge over every vertex: on kronecker(20)'s in|out phases it took
// 0.90 ms there against 1.20 on the pipelined body (tools/scan_variants.py;
// the build with SLICED_RELAX_PIPELINED 1 runs it on the pipelined body
// from `table0`, the unit table of the sparse shape). A null `relax_table`
// means upd already holds sweep 0 (the push along the outgoing view,
// launched before on the same stream). The gate sweep (K * B lanes, unit
// table `table1`) runs on the pipelined body with write-through. `plan`:
// the merge plan above. Scratch: `packed` for max(B, K * B) lanes over
// n + 1 columns, `live_bits` ceil((n + 1) / 32) words, `split`
// max(B, K * B) * split_rows floats.
extern "C" int ell_sliced_relax_keys_launch(
    const float* dmask, const float* ga, const float* gb, const float* gc,
    long long n, int lanes_b, int k, const long long* relax_table,
    int relax_buckets, int threads, const long long* table0,
    const long long* table1, int n_buckets, const long long* plan,
    float* packed, unsigned* live_bits, float* partials, float* split,
    float* upd, float* keys, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const MergePlan m = merge_plan(plan);
  if (relax_table != nullptr) {
    const PackSrc s0{dmask, nullptr, nullptr, nullptr, n, lanes_b};
#if SLICED_RELAX_PIPELINED
    const int rc = sliced_scan_sweep<PACK_ROWS, true>(
        s0, n, lanes_b, table0, n_buckets, m, packed, live_bits, split, upd,
        s);
#else
    const int rc = sliced_gather<true>(
        s0, n, lanes_b, relax_table, relax_buckets, m.r_total, m.merge_ptr,
        m.merge_pos, threads, packed, live_bits, partials, upd, s);
#endif
    if (rc != 0) return rc;
  }
  // the merge above (or the push) is the barrier: the gate pack reads upd
  const PackSrc s1{ga, gb, gc, upd, n, lanes_b};
  return sliced_scan_sweep<PACK_IN_GATE, false>(s1, n, k * lanes_b, table1,
                                                n_buckets, m, packed, nullptr,
                                                split, keys, s);
}

// ell_sliced_keys_dep_batch: gates (K0, B, n), dga/dgb (B, n) unpadded.
// Writes out (K0 + 1, B, n): rows [:K0] from the gates, row K0 through
// min(dga, dgb + out[dep_idx]). `table0` / `table1`: the unit tables of the
// K0 * B and the B lane sweeps. Scratch as above for max(K0 * B, B) lanes.
extern "C" int ell_sliced_keys_dep_launch(
    const float* gates, const float* dga, const float* dgb, long long n,
    int lanes_b, int k0, int dep_idx, const long long* table0,
    const long long* table1, int n_buckets, const long long* plan,
    float* packed, float* split, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const MergePlan m = merge_plan(plan);
  const long long row = (long long)lanes_b * n;
  const PackSrc s0{gates, nullptr, nullptr, nullptr, n, lanes_b};
  const int rc = sliced_scan_sweep<PACK_ROWS, false>(
      s0, n, k0 * lanes_b, table0, n_buckets, m, packed, nullptr, split, out,
      s);
  if (rc != 0) return rc;
  const PackSrc s1{dga, dgb, out + dep_idx * row, nullptr, n, lanes_b};
  return sliced_scan_sweep<PACK_DEP_GATE, false>(
      s1, n, lanes_b, table1, n_buckets, m, packed, nullptr, split,
      out + k0 * row, s);
}
