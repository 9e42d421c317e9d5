// ell_push: the relax update as a frontier push over the outgoing adjacency.
//
//   upd[b, v] = min over out-rows r with owner u, over slots j of r with
//               cols_out[r, j] = v, of dmask[b, u] + ws_out[r, j]
//
// (+inf where v has no candidate). dmask[b, u] is d[b, u] where u was settled
// this phase in lane b, +inf elsewhere. The outgoing view is a table of
// buckets: the padded to_ell_out is one bucket whose row r belongs to vertex
// r; a degree-sliced to_ell_out_sliced has one bucket per width, row i of a
// bucket belongs to vertex rows[i], and a split hub owns several rows.
//
// Replaces, on the relax path of every plan without in-side dynamic keys
// (the default instatic|outstatic among them), the pull gathers that stand
// for these TPU kernels of the JAX package:
//   * repro/kernels/ell_relax.py::ell_relax_batch (:97, pallas_call at :114),
//     the pull-model relaxation over the padded incoming ELL;
//   * repro/kernels/ell_relax_keys.py::ell_sliced_gather_min_batch (:311,
//     pallas_call at :334), its degree-sliced form.
// The pull kernels stay in ell_gather.cu as those kernels' counterparts; the
// function is the same, only the direction of the edges read differs.
//
// What bounds it on an H100: memory, but only the part the data needs. The
// pull reads the whole incoming adjacency every phase (1.2 GB on G(10^6,
// 10^-4)) to find the few slots whose source was settled (0.28 % of the
// lane-slots at phase 200 of the default solve). The push reads the out-rows
// of the vertices settled this phase in some lane (~3 % of them there, ~27
// MB), dmask once (B * n * 4 bytes) and upd once (B * n * 4 bytes, written
// +inf and then lowered in place): ~0.03 ms of HBM time at B = 8. Beside the
// bytes, every candidate is a scattered 4-byte read of upd in L2 and, when it
// lowers it, a scattered atomic there: the working set upd (32 MB at n = 1e6,
// B = 8) fits the 50 MB L2, and the millions of such requests a phase, not
// the bytes, are what the push pass's time tracks (PERF.md).
//
// What the design does about that:
//  * a mark pass over the vertices writes, per vertex and per tile of 32
//    lanes, a word with bit b set where dmask[b, u] is not +inf (finite, -inf
//    or NaN: whatever can give a candidate below +inf or a NaN), and fills upd
//    with +inf in the same pass;
//  * the push pass gives each warp a task of up to 32 consecutive rows of a
//    bucket: one coalesced read of their owners' mask words, a ballot of the
//    active rows, then G threads a row (G = 8, 16 or 32 by the bucket's
//    width, one geometry a bucket: a width-8 bucket keeps 4 rows in flight a
//    warp instead of idling 24 threads) stream the active rows' slots,
//    PUSH_UNROLL chunks of G in flight, with the evict-first hint
//    (ld.global.cs) so the adjacency does not push upd out of L2. A task
//    holds at most PUSH_TASK_SLOTS slots (2 rows of the width-512 bucket), so
//    a settled hub's rows (733 of them for kronecker(20)'s largest out-hub,
//    all active at once) spread over hundreds of warps instead of queueing
//    in a few. Rows are left-packed (the builders put a row's slots first and
//    sentinels after), so a row ends at its first id outside [0, n): a
//    ballot over the row's G threads finds it. An inactive row costs one mask
//    word;
//  * each slot gives one candidate per set lane, dmask[b, u] + w, the same
//    single f32 add of the same two operands as the pull. A candidate first
//    reads upd and issues the atomic only when it would lower it, so a vertex
//    many settled vertices push to (in-degree 375,439 on kronecker(20)) takes
//    few atomics once its value is low (PUSH_FILTER);
//  * an f32 atomic min that is exact in any order: atomicMin on the int bits
//    for a sign bit of 0, atomicMax on the unsigned bits for a sign bit of 1
//    (negative floats order in reverse as unsigned, and above every positive
//    one), and atomicMax with 0xffc00000 for a NaN, a value neither of the
//    other two paths can displace, so a NaN in dmask reaches every
//    out-neighbour as the pull's nan_min carries it. A tie of -0 and +0
//    gives -0 in either order, as the pull's fold does: a -0 takes the
//    unsigned max path and is above +0 there, and a +0 on the int path is
//    not below a -0's INT_MIN. Min is exact and order free, so upd is the
//    pull's bit for bit (every NaN taken as one value). The read before the
//    atomic lets a -0 through over a +0 for the same reason.
//
// A compacted list of the active rows (appended by the mark pass, walked by
// a persistent grid) was built and measured against this scan: level over
// the two default solves' inputs, with a costlier mark pass and one geometry
// for every bucket (PERF.md); the scan is what ships.
//
// Ids: an id outside [0, n) ends its row (the sentinel n does so by
// contract); an owner outside [0, n) makes its row inactive. Both are
// skipped, never read out of bounds.
//
// The rectangular form (ell_push_rect_launch) separates the two sizes the
// square form shares: dmask is (lanes, n_rows), its owners the rows of one
// rank's vertex block of a sharded graph, and upd is (lanes, n_targets),
// with a row's ids global in [0, n_targets) and ending at the first one
// outside it (the sentinel n_targets). It is the relax and the dynamic key
// scans of the sharded stepper (core/distributed.py), which stand for the
// reference's shard-local jax.ops.segment_min (XLA, no Pallas kernel) in
// repro/core/distributed.py (:536-539, :590-593). The square form is the
// rectangular one with n_rows == n_targets == n.
//
// The delta form (ell_delta_push_launch) is delta-stepping's relax, both
// turns in one push over the outgoing view:
//
//   upd[b, v] = nan_min(min over out-arcs (u -> v, w), light[b, u], of
//                           d[b, u] + (w <= delta ? w : +inf),
//                       min over out-arcs (u -> v, w), heavy[b, u], of
//                           d[b, u] + (w >  delta ? w : +inf))
//
// It replaces, on the delta policy's relax, the two dense gathers over the
// light and heavy weight-gated incoming views that stand for these TPU
// kernels of the JAX package as its delta_relax_batch
// (repro/kernels/ops.py:303) runs them:
//   * repro/kernels/ell_key_min.py::ell_key_min_batch (:86, pallas_call at
//     :108), on the padded layout;
//   * repro/kernels/ell_relax_keys.py::ell_sliced_gather_min_batch (:311,
//     pallas_call at :334), on the degree-sliced layout.
// Under delta a gate is one bucket's vertices, so a pull reads the whole
// view (1.2 GB on G(10^6, 10^-4)) to find a few slots, twice a phase; the
// function's bound is that of this push: the out-rows of the light and
// heavy sources, d, the two gates and upd once. What the design does:
//  * the mark pass writes two words per vertex and lane tile, the light
//    sources and the heavy ones (a source with d = +inf pushes nothing, as
//    in the square form), so a row read once serves both turns of every
//    lane; the two sets may overlap (the policy keeps them disjoint within
//    a lane; the function does not need it);
//  * the weight gate is formed in the kernel from the slot's weight and
//    the f32 delta, with the compare of the reference's weight_gated_ell,
//    so no gated copy of the view's weights is held in memory. Each
//    candidate is the reference's add on the reference's operands, d + w or
//    d + inf: a NaN or -inf source gives NaN at the neighbours its turn
//    gates out, as the reference's gather does. A lane's two candidates
//    fold by nan_min and land through the same filtered atomic min, so a
//    +inf candidate issues none.
#include <cuda_runtime.h>
#include <math_constants.h>

#define PUSH_MAX_BUCKETS 16  // buckets one push launch takes (a group)
#define PUSH_THREADS 256
#define PUSH_UNROLL 4          // chunks of G slots a thread loads at once
#define PUSH_TASK_SLOTS 1024   // a warp task's rows hold at most this many
#define PUSH_FILTER 1          // read upd before the atomic
#define FULL_MASK 0xffffffffu

struct PushBucket {
  const int* cols;    // (n_rows, d_pad) int32 destination ids
  const float* ws;    // (n_rows, d_pad) f32 weights
  const int* rows;    // (n_rows,) owner ids; null: row r belongs to vertex r
  long long n_rows;
  long long first_task;  // first warp task of this bucket in the launch
  int d_pad;
  int g;   // threads a row: 8, 16 or 32
  int rt;  // rows a warp task: 1 to 32
};

struct PushTable {
  PushBucket e[PUSH_MAX_BUCKETS];
  int count;
};

// *p = min(*p, x), exact in any order of the callers, -0 over +0 on a tie
// (see the note above).
__device__ __forceinline__ void atomic_min_f32(float* p, float x) {
  const unsigned bits = __float_as_uint(x);
  if (x != x) {
    atomicMax(reinterpret_cast<unsigned*>(p), 0xffc00000u);
  } else if ((bits >> 31) == 0) {
    atomicMin(reinterpret_cast<int*>(p), (int)bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(p), bits);
  }
}

// min(m, x) as the pull's fold takes it: x where it is below m, NaN, or -0
// beside a +0; m otherwise.
__device__ __forceinline__ float fold_min(float m, float x) {
  return (x < m || x != x || (x == m && signbit(x))) ? x : m;
}

// Mark: mask[t, u] bit k set iff dmask[t * 32 + k, u] != +inf, for the n
// owners u; upd = +inf on its nt targets. Grid: (blocks over max(n, nt),
// lane tiles).
__global__ void push_mark_kernel(const float* __restrict__ dmask, long long n,
                                 long long nt, int lanes,
                                 unsigned* __restrict__ mask,
                                 float* __restrict__ upd) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n && u >= nt) return;
  const int t = blockIdx.y;
  const int b1 = min(lanes, t * 32 + 32);
  unsigned bits = 0;
  for (int b = t * 32; b < b1; ++b) {
    if (u < n && dmask[(long long)b * n + u] != CUDART_INF_F) {
      bits |= 1u << (b - t * 32);
    }
    if (u < nt) upd[(long long)b * nt + u] = CUDART_INF_F;
  }
  if (u < n) mask[(long long)t * n + u] = bits;
}

// Mark of the delta form: mask[t, u] = (light word, heavy word), bit k of
// the light word set iff light[b, u] != 0 and d[b, u] != +inf (b = t * 32 +
// k), of the heavy word likewise; upd = +inf. Grid: (blocks over n, lane
// tiles).
__global__ void delta_mark_kernel(const float* __restrict__ d,
                                  const unsigned char* __restrict__ light,
                                  const unsigned char* __restrict__ heavy,
                                  long long n, int lanes,
                                  uint2* __restrict__ mask,
                                  float* __restrict__ upd) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n) return;
  const int t = blockIdx.y;
  const int b1 = min(lanes, t * 32 + 32);
  unsigned lw = 0, hw = 0;
  for (int b = t * 32; b < b1; ++b) {
    const long long i = (long long)b * n + u;
    const unsigned char l = light[i], h = heavy[i];
    if ((l | h) != 0 && d[i] != CUDART_INF_F) {
      const unsigned bit = 1u << (b - t * 32);
      if (l != 0) lw |= bit;
      if (h != 0) hw |= bit;
    }
    upd[i] = CUDART_INF_F;
  }
  mask[(long long)t * n + u] = make_uint2(lw, hw);
}

// The rows of warp task `task` of bucket `bk`, for lane tile `tile`: rows
// task * rt + [0, rt), one lane each for the mask read. Owners lie in
// [0, n) (dmask and mask rows), ids in [0, nt) (upd rows). DELTA: `mask`
// holds the delta mark's (light, heavy) word pairs, `dmask` is d, and a
// slot's weight is gated by `delta` for each turn.
template <int G, bool DELTA>
__device__ __forceinline__ void push_task(
    const PushBucket& bk, long long task, int tile,
    const float* __restrict__ dmask, long long n, long long nt,
    const unsigned* __restrict__ mask, float delta, float* upd,
    unsigned long long& n_cand, unsigned long long& n_atomic) {
  constexpr int RPW = 32 / G;  // rows in flight a warp
  constexpr int SPAN = PUSH_UNROLL * G;  // slots of a row a pass covers
  const int lane = threadIdx.x & 31;
  const int gid = lane / G, sub = lane % G;
  const unsigned low = G == 32 ? FULL_MASK : (1u << (G % 32)) - 1u;
  const unsigned gmask = low << (gid * G);
  const long long r = task * bk.rt + lane;
  unsigned m = 0, mh = 0;  // the row's lane word (DELTA: light, heavy)
  int owner = 0;
  if (lane < bk.rt && r < bk.n_rows) {
    owner = bk.rows != nullptr ? bk.rows[r] : (int)r;
    if (owner >= 0 && owner < n) {
      if (DELTA) {
        const uint2 pair =
            reinterpret_cast<const uint2*>(mask)[(long long)tile * n + owner];
        m = pair.x;
        mh = pair.y;
      } else {
        m = mask[(long long)tile * n + owner];
      }
    }
  }
  unsigned rest = __ballot_sync(FULL_MASK, (m | mh) != 0);  // warp-uniform
  while (rest != 0) {
    // group gid takes the gid-th lowest active row of what is left
    unsigned pick = rest;
    for (int q = 0; q < gid && pick != 0; ++q) pick &= pick - 1;
    const int src = pick != 0 ? __ffs(pick) - 1 : -1;
#pragma unroll
    for (int q = 0; q < RPW; ++q) rest &= rest - 1;
    const unsigned rl = __shfl_sync(FULL_MASK, m, src < 0 ? 0 : src);
    const unsigned rh = DELTA ? __shfl_sync(FULL_MASK, mh, src < 0 ? 0 : src)
                              : 0u;
    const unsigned rm = rl | rh;
    const int u = __shfl_sync(FULL_MASK, owner, src < 0 ? 0 : src);
    if (src < 0) continue;  // only on the last pass: rest is now 0
    const long long row = task * bk.rt + src;
    const int* crow = bk.cols + row * bk.d_pad;
    const float* wrow = bk.ws + row * bk.d_pad;
    for (int j0 = 0; j0 < bk.d_pad; j0 += SPAN) {
      // PUSH_UNROLL chunks in flight: ids and weights (the weights past
      // the row's end are read for nothing, but in the same round trip)
      int v[PUSH_UNROLL];
      float w[PUSH_UNROLL];
#pragma unroll
      for (int q = 0; q < PUSH_UNROLL; ++q) {
        const int j = j0 + q * G + sub;
        v[q] = j < bk.d_pad ? __ldcs(crow + j) : -1;
        w[q] = j < bk.d_pad ? __ldcs(wrow + j) : 0.0f;
      }
      // the row ends at its first id outside [0, nt): slots [0, end) of
      // this pass are the row's, the same for the whole group
      int end = SPAN;
#pragma unroll
      for (int q = 0; q < PUSH_UNROLL; ++q) {
        const unsigned e =
            (__ballot_sync(gmask, v[q] < 0 || v[q] >= nt) >> (gid * G)) & low;
        if (e != 0 && end == SPAN) end = q * G + __ffs(e) - 1;
      }
      for (unsigned bits = rm; bits != 0; bits &= bits - 1) {
        const int k = __ffs(bits) - 1;
        const long long b = (long long)tile * 32 + k;
        const float du = __ldg(dmask + b * n + u);
        const bool lt = ((rl >> k) & 1u) != 0, hv = ((rh >> k) & 1u) != 0;
        float* urow = upd + b * nt;
        float cur[PUSH_UNROLL];
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          cur[q] = (PUSH_FILTER && q * G + sub < end) ? __ldcg(urow + v[q])
                                                      : CUDART_NAN_F;
        }
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          if (q * G + sub >= end) continue;
          float cand;
          if (DELTA) {
            // the reference's gated weight for each turn, then its add
            const bool le = w[q] <= delta;
            cand = lt ? du + (le ? w[q] : CUDART_INF_F) : CUDART_INF_F;
            if (hv) cand = fold_min(cand, du + (le ? CUDART_INF_F : w[q]));
          } else {
            cand = du + w[q];
          }
          ++n_cand;
          if (!PUSH_FILTER ||
              (cand != cand ? cur[q] == cur[q]
                            : cand < cur[q] || (cand == cur[q] &&
                                                signbit(cand) &&
                                                !signbit(cur[q])))) {
            atomic_min_f32(urow + v[q], cand);
            ++n_atomic;
          }
        }
      }
      if (end < SPAN) break;
    }
  }
}

// The push pass of one launch: each warp walks warp tasks of the bucket
// table (grid-stride), the lane tile is blockIdx.y. `stats`, when not null,
// gets [candidates, atomics issued] added.
template <bool DELTA>
__device__ __forceinline__ void push_pass(
    const PushTable& tab, long long tasks, const float* __restrict__ dmask,
    long long n, long long nt, const unsigned* __restrict__ mask,
    float delta, float* upd, unsigned long long* stats) {
  constexpr int WARPS = PUSH_THREADS / 32;
  const int tile = blockIdx.y;
  unsigned long long n_cand = 0, n_atomic = 0;
  for (long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       gw < tasks; gw += (long long)gridDim.x * WARPS) {
    // constant indices only, so the table stays in parameter space
    PushBucket bk = tab.e[0];
#pragma unroll
    for (int i = 1; i < PUSH_MAX_BUCKETS; ++i) {
      if (i < tab.count && gw >= tab.e[i].first_task) bk = tab.e[i];
    }
    const long long task = gw - bk.first_task;
    if (bk.g == 8) {
      push_task<8, DELTA>(bk, task, tile, dmask, n, nt, mask, delta, upd,
                          n_cand, n_atomic);
    } else if (bk.g == 16) {
      push_task<16, DELTA>(bk, task, tile, dmask, n, nt, mask, delta, upd,
                           n_cand, n_atomic);
    } else {
      push_task<32, DELTA>(bk, task, tile, dmask, n, nt, mask, delta, upd,
                           n_cand, n_atomic);
    }
  }
  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) {
      n_cand += __shfl_xor_sync(FULL_MASK, n_cand, off);
      n_atomic += __shfl_xor_sync(FULL_MASK, n_atomic, off);
    }
    if ((threadIdx.x & 31) == 0 && (n_cand | n_atomic) != 0) {
      atomicAdd(stats, n_cand);
      atomicAdd(stats + 1, n_atomic);
    }
  }
}

// Push: dmask's candidates along the table's rows (push_pass).
__global__ void __launch_bounds__(PUSH_THREADS)
    push_kernel(PushTable tab, long long tasks,
                const float* __restrict__ dmask, long long n, long long nt,
                const unsigned* __restrict__ mask, float* upd,
                unsigned long long* stats) {
  push_pass<false>(tab, tasks, dmask, n, nt, mask, 0.0f, upd, stats);
}

// Push of the delta form: d's light and heavy candidates, gated by delta,
// along the table's rows (push_pass), `mask` the delta mark's word pairs.
__global__ void __launch_bounds__(PUSH_THREADS)
    delta_push_kernel(PushTable tab, long long tasks,
                      const float* __restrict__ d, long long n,
                      const unsigned* __restrict__ mask, float delta,
                      float* upd, unsigned long long* stats) {
  push_pass<true>(tab, tasks, d, n, n, mask, delta, upd, stats);
}

// Threads a row for a bucket of width d_pad.
static int push_threads_per_row(int d_pad) {
  return d_pad <= 8 ? 8 : (d_pad <= 16 ? 16 : 32);
}

// Rows a warp task for a bucket of width d_pad: up to PUSH_TASK_SLOTS slots,
// so the rows of a hub spread over many warps, and narrow rows fill a warp's
// 32 lanes.
static int push_rows_per_task(int d_pad) {
  const int rt = PUSH_TASK_SLOTS / d_pad;
  return rt < 1 ? 1 : (rt > 32 ? 32 : rt);
}

// The push table of the buckets with rows from bucket *i of the host
// `table` on, at most PUSH_MAX_BUCKETS of them; steps *i past them and sets
// `tasks` to their warp tasks. Returns cudaErrorInvalidValue for a bucket
// of width < 1.
static int next_group(const long long* table, int n_buckets, int* i,
                      PushTable* tab, long long* tasks) {
  tab->count = 0;
  *tasks = 0;
  for (; *i < n_buckets && tab->count < PUSH_MAX_BUCKETS; ++*i) {
    const long long* t = table + 5 * *i;
    if (t[3] == 0) continue;
    if (t[4] < 1) return (int)cudaErrorInvalidValue;
    PushBucket& e = tab->e[tab->count++];
    e.cols = (const int*)t[0];
    e.ws = (const float*)t[1];
    e.rows = (const int*)t[2];
    e.n_rows = t[3];
    e.d_pad = (int)t[4];
    e.g = push_threads_per_row(e.d_pad);
    e.rt = push_rows_per_task(e.d_pad);
    e.first_task = *tasks;
    *tasks += (e.n_rows + e.rt - 1) / e.rt;
  }
  return 0;
}

// The push, dmask (lanes, n) f32 -> upd (lanes, nt) f32 (see the entry
// points below). With `light` not null it is the delta form: dmask is d,
// `light` and `heavy` (lanes, n) bytes, nt == n, and `mask` holds two words
// a vertex and lane tile.
static int push_launch(const float* dmask, const unsigned char* light,
                       const unsigned char* heavy, float delta, long long n,
                       long long nt, int lanes, const long long* table,
                       int n_buckets, unsigned* mask, float* upd,
                       unsigned long long* stats, void* stream) {
  if (n < 1 || nt < 1 || lanes < 1 || n_buckets < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool delta_form = light != nullptr;
  if (delta_form && (heavy == nullptr || nt != n)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (lanes + 31) / 32;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  PushTable tab;
  long long tasks = 0;
  for (int i = 0; i < n_buckets;) {
    const int rc = next_group(table, n_buckets, &i, &tab, &tasks);
    if (rc != 0) return rc;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const long long span = n > nt ? n : nt;
  const dim3 mark_grid((unsigned)((span + PUSH_THREADS - 1) / PUSH_THREADS),
                       (unsigned)tiles);
  if (delta_form) {
    delta_mark_kernel<<<mark_grid, PUSH_THREADS, 0, s>>>(
        dmask, light, heavy, n, lanes, reinterpret_cast<uint2*>(mask), upd);
  } else {
    push_mark_kernel<<<mark_grid, PUSH_THREADS, 0, s>>>(dmask, n, nt, lanes,
                                                        mask, upd);
  }
  int rc = (int)cudaGetLastError();
  for (int i = 0; rc == 0 && i < n_buckets;) {
    next_group(table, n_buckets, &i, &tab, &tasks);
    if (tasks == 0) continue;
    constexpr long long WARPS = PUSH_THREADS / 32;
    long long blocks = (tasks + WARPS - 1) / WARPS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    const dim3 grid((unsigned)blocks, (unsigned)tiles);
    if (delta_form) {
      delta_push_kernel<<<grid, PUSH_THREADS, 0, s>>>(
          tab, tasks, dmask, n, mask, delta, upd, stats);
    } else {
      push_kernel<<<grid, PUSH_THREADS, 0, s>>>(tab, tasks, dmask, n, nt,
                                                mask, upd, stats);
    }
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// ell_push_relax_batch: dmask (lanes, n) f32 -> upd (lanes, n) f32. `table`
// is a host array of 5 int64 per bucket: cols, ws, rows (0: row r belongs to
// vertex r), row count, width; buckets without rows are left out. The mark
// pass runs once; the push pass once for each group of PUSH_MAX_BUCKETS
// buckets with rows, in order on the stream (every view the default
// boundaries build is one group): the atomic min is exact in any order, so
// the groups give the one launch's bits. Scratch: `mask` ceil(lanes / 32) *
// n words. `stats` (2 uint64, or null) gets [candidates, atomics issued]
// added. Returns 0, cudaErrorInvalidValue for a table that does not fit or
// a bad size (checked before any launch), or a launch's error.
extern "C" int ell_push_relax_launch(const float* dmask, long long n,
                                     int lanes, const long long* table,
                                     int n_buckets, unsigned* mask,
                                     float* upd, unsigned long long* stats,
                                     void* stream) {
  return push_launch(dmask, nullptr, nullptr, 0.0f, n, n, lanes, table,
                     n_buckets, mask, upd, stats, stream);
}

// ell_push_rect_batch: the rectangular form, dmask (lanes, n_rows) f32 ->
// upd (lanes, n_targets) f32, a row's ids in [0, n_targets) (the sentinel
// n_targets ends it). `table`, `mask` (ceil(lanes / 32) * n_rows words),
// `stats` and the return code as above.
extern "C" int ell_push_rect_launch(const float* dmask, long long n_rows,
                                    long long n_targets, int lanes,
                                    const long long* table, int n_buckets,
                                    unsigned* mask, float* upd,
                                    unsigned long long* stats, void* stream) {
  return push_launch(dmask, nullptr, nullptr, 0.0f, n_rows, n_targets, lanes,
                     table, n_buckets, mask, upd, stats, stream);
}

// ell_delta_push_batch: d (lanes, n) f32, light and heavy (lanes, n) bytes
// (0 or 1: torch.bool) -> upd (lanes, n) f32, the delta form (see the note
// at the top): light sources push their arcs of weight <= delta, heavy ones
// the others, each gated-out arc's candidate d + inf. `delta` is the f32
// bucket width. `table`, `stats` and the return code as for
// ell_push_relax_launch; scratch: `mask` 2 * ceil(lanes / 32) * n words.
extern "C" int ell_delta_push_launch(const float* d, const unsigned char* light,
                                     const unsigned char* heavy, float delta,
                                     long long n, int lanes,
                                     const long long* table, int n_buckets,
                                     unsigned* mask, float* upd,
                                     unsigned long long* stats,
                                     void* stream) {
  if (light == nullptr) return (int)cudaErrorInvalidValue;
  return push_launch(d, light, heavy, delta, n, n, lanes, table, n_buckets,
                     mask, upd, stats, stream);
}
