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

// ---------------------------------------------------------------------------
// The phase-committing pair: the settle mark and the worklist push.
//
// On every criterion plan that relaxes by the push (no in-side dynamic keys,
// no oracle; the default instatic|outstatic among them), with the
// attribution ring or without, one phase of the stepper is #2 (the
// thresholds, frontier_crit.cu), then these three launches:
//
//  1. settle_mark_kernel: per (vertex, lane tile) it computes the loop
//     predicate `go` from the per-lane fringe sizes (#2's count), live0
//     and the call's budget, then the plan's settle terms with the
//     reference's f32 ops (d <= min_F d; d - in_min_static <= min_F d;
//     d <= L_k), writes status 2 where a vertex settles, and appends each
//     relax source's out-rows, with its lane word, to a worklist (one list
//     a lane tile and bucket). It adds the per-lane settle counts and the
//     out-degrees of the relax sources (the reference's n_settled and
//     relax_inc) to per-lane counters, exact sums in any order; on a
//     state with telemetry also each settled vertex to its first true
//     term's count (the attribution ring's first-true claim, terms in the
//     plan's order: d <= min_F d, the in_min_static term, then L_1..L_k).
//  2. settle_push_kernel: a persistent grid walks the worklist by the
//     counts the mark left in device memory and lowers the next `dist`
//     in place through atomic_min_f32 (the place of the upd = +inf fill
//     and torch.minimum(d, upd)), and sets status 0 -> 1 where a
//     candidate below +inf lands (the reference's (status == 0) &
//     (upd < INF), see the rule below).
//  3. settle_tail_kernel: the stepper's B-sized bookkeeping of the phase
//     (trips, the budget, phases, sum_fringe, relax_edges, the settled
//     ring, and with telemetry the fringe, relax and attribution rings) and, on a state with target lanes, the demotion of a lane's
//     fringe in the phase its target settles; it zeroes the counters and
//     the worklist counts for the next phase, inside the captured graph.
//
// A dead phase (go false): the mark's blocks return after computing go
// (block (0, 0) records it), the push's blocks find empty lists and the
// tail's blocks read the record and return, so the phase writes nothing.
//
// It replaces #1b / #9b (push_mark_kernel and push_kernel above, with the
// PyTorch passes over B x n around them) on that path: the same TPU kernels
// as those, repro/kernels/ell_relax.py::ell_relax_batch (:97, pallas_call
// at :114) on the padded layout and repro/kernels/ell_relax_keys.py::
// ell_sliced_gather_min_batch (:311, pallas_call at :334) on the sliced one.
//
// What bounds it on an H100: memory. status read once by the mark (B * n *
// 4 bytes) and d in the sectors that hold a fringe slot (up to as much
// again), the static key (n * 4), the settled out-rows, the worklist, and
// the touched targets written once; ~0.03-0.05 ms at n =
// 1e6, B = 8 on the default solve. The phase it replaces spent ~0.47 ms
// of 0.615 in some fifteen PyTorch passes over B x n (PERF.md), and a dead
// phase ran them all.
//
// Design decisions:
//  * in place. The push lowers `dist` itself. A candidate may land on a
//    vertex settled in the same phase (the criteria compare in f32, where
//    d - in_min_static rounds), so a source must push from its ENTRY
//    distance: the mark copies d[b, u] of each relax source into a dense
//    scratch d_src (B, n), written only at those slots and read only
//    there. It costs B * n * 4 bytes of memory, and saves the fill and the
//    copy of a separate next buffer (B * n * 8 bytes moved a phase).
//  * the filter read before the atomic is part of the commit here, not a
//    tuning choice: a NaN that `dist` held at the phase's entry (a fault
//    row) must stay, as torch.minimum(d, upd) keeps it, and atomic_min_f32
//    compares a positive NaN as the largest int. No candidate of the
//    engine is NaN: a NaN distance never settles (every settle compare is
//    false for it) and the builders' views hold finite weights only.
//  * the status rule. A candidate c < +inf that issues its atomic, or that
//    reads a NaN entry, sets status 0 -> 1. Every candidate that lowers
//    `dist` issues one, so a vertex of status 0 turns 1 iff upd < +inf
//    and upd lowers its entry distance or the entry is NaN. That is the
//    reference's (status == 0) & (upd < INF) on every state the stepper
//    makes: a vertex of status 0 holds +inf or NaN (fresh rows; a relax
//    that lands makes it 1; the target lanes' demotion leaves its lane
//    without fringe, so nothing lands there again). It saves a read of
//    status for each of the millions of candidates a phase.
//  * the worklist. The mark appends entries (row of the bucket, lane word)
//    to list (tile, bucket); a sliced vertex's rows are contiguous in one
//    bucket, found through a per-vertex (bucket, first row, rows, the
//    bucket's first worklist row) table built with the view (core/graph.py).
//    Up to SETTLE_SHARED_BUCKETS buckets the appends are block-aggregated:
//    shared-memory atomics within a block, then one global atomic a block
//    and bucket; a view with more buckets (tuned slice boundaries) appends
//    with one global atomic a source vertex, so any number of buckets runs. The push walks the lists with the geometry of push_task
//    (G threads a row by the bucket's width, up to PUSH_TASK_SLOTS slots a
//    warp task), so its work scales with the settled rows, not with n.
//  * the mark reads a lane's d only where its status is 1; issuing eight
//    lanes' status and d loads before any test (as #2 does) was measured
//    5 % slower a phase on G(10^6, 10^-4) and the road grid (PERF.md);
//  * the counters are exact integer sums (atomics in any order), kept one
//    per lane at a 128-byte stride so the lanes' atomics do not share a
//    line; the tail folds them into the state and zeroes them.
//  * the operands ride as __grid_constant__ kernel parameters: the mark
//    and the push index the row offsets and the bucket table at run time
//    and read them in parameter space, without a local copy;
//  * capture: every size is fixed by the view and the lane count, the grid
//    of the push is persistent (sized once by the view), and the counters
//    live in scratch the wrapper allocates (a capture takes its own) and
//    that every live phase leaves zeroed: the stepper captures the pair in
//    its chunk's CUDA graph.
//
// Build flags: no --use_fast_math and no flush-to-zero (_build.py), so
// d - in_min_static <= min_F d is the reference's compare, bit for bit.
//
// Delta's form (delta_mode; kernels/settle_push.py's commit_delta_phase).
// Delta-stepping's phase is four launches: its threshold (frontier_crit.cu,
// delta_crit_kernel: each lane's bucket, |F| and the witness of a light
// round), then
//
//  1. delta_settle_mark_kernel: on each lane on its light round, each
//     fringe vertex of the lane's bucket below its last_proc (the work set
//     `cur`, its bucket id the same f32 divide and floorf as the
//     threshold's) gets last_proc := d and removed := 1 and is a source;
//     on each lane on its heavy turn, each removed fringe vertex settles
//     (status 2), gets last_proc := +inf and removed := 0 and is a source.
//     Its counters: the settled, the light ones (the attribution ring's
//     first slot) and relax_inc (the light out-degree of a light source,
//     the heavy one of a heavy source), as settle_mark_kernel's;
//  2. delta_settle_push_kernel: the worklist push, each slot's weight gated
//     by the lane's turn against the f32 delta: a lane on its light round
//     pushes d + w where w <= delta and d + inf elsewhere, one on its heavy
//     turn the other way round (the reference's add on its gated weights;
//     a gated-out slot of a finite source gives +inf and is not read);
//  3. settle_tail_kernel, with delta's attribution triple (light, heavy, the
//     lane's bucket id cast by __float2int_rz, as the card casts it: a NaN
//     to 0, beyond the range to its end).
//
// It replaces, on the delta policy's phase, #5c / #9c (delta_mark_kernel
// and delta_push_kernel above) and the dozen PyTorch passes over B x n
// around them (the bucket ids, cur, the drain bookkeeping, the min and the
// status select, the re-stacked keys, the counters): the same TPU kernels
// as those, repro/kernels/ell_key_min.py::ell_key_min_batch (:86,
// pallas_call at :108) on the padded layout and repro/kernels/
// ell_relax_keys.py::ell_sliced_gather_min_batch (:311, pallas_call at
// :334) on the sliced one, and #2 (frontier_crit.py:94, pallas_call at
// :136) for the threshold.
//
// What bounds it: memory, as the pair. The mark reads status whole and d,
// last_proc and removed in the sectors that hold a fringe slot; the push
// the sources' out-rows. Design decisions beside the pair's:
//  * the heavy gate is per lane: a lane's turn follows from the whole
//    lane's work set, which the mark cannot see from one vertex, so the
//    threshold gives the witness and the mark and the push read each lane's
//    turn from it; a worklist entry keeps one lane word, (row, word), the
//    turn of each of its lanes coming from the lane;
//  * the drain bookkeeping is written only where it changes: on a heavy
//    turn at the removed slots, which is the reference's whole-lane reset
//    because every state the stepper makes holds last_proc != +inf =>
//    removed => status 1 (tests/test_torch_delta_commit.py); a lane
//    without fringe then has nothing to reset;
//  * same-phase hazards: a light candidate may land on another source of
//    the phase, a heavy one on a vertex settled this phase or earlier (the
//    reference's min(d, upd) lowers those too), so sources push from d_src,
//    their entry distance, as the pair's do. A NaN candidate comes only from
//    a NaN or -inf source, which no state of the stepper holds (a NaN d is
//    never below last_proc, so it never enters the drain).

#define SETTLE_THREADS 256
#define SETTLE_MAX_OUT 8         // OUT lanes (#2's mins rows 1..) the mark takes
#define SETTLE_MAX_TERMS 10      // settle terms: d <= min_F d, in_min_static, OUT
#define SETTLE_SHARED_BUCKETS 64 // buckets whose appends a block aggregates
#define SETTLE_PAD 32            // words between two lanes' counters
#define SETTLE_ATTR 4            // a lane's first first-true count in its words
#define SETTLE_TAIL_THREADS 256
#define SETTLE_TAIL_SPAN 4096    // vertices of a lane's row a tail block demotes

// The operands of a phase (shared by the three kernels).
struct SettleArgs {
  float* d;                      // (B, n) the distances, lowered in place
  int* status;                   // (B, n) in place
  const float* mins;             // (1 + k_out, B) #2's thresholds
  const int* n_fringe;           // (B,) #2's fringe sizes
  const unsigned char* live0;    // (B,) bool: live at the call's entry
  int* budget;                   // 0-dim: trips left in the call
  const float* in_key;           // (n,) in_min_static, or null: no such term
  const int* target;             // (B,) s->t targets (-1: none), or null
  const int* out_deg;            // (n,) out-degrees, for relax_inc
  const int4* vrows;             // (n,) (bucket, first row, rows, the
                                 //   bucket's first worklist row); null:
                                 //   the padded view, row u of bucket 0
  int* go;                       // scratch: the phase's predicate
  unsigned* counts;              // scratch (tiles, nb): entries of each list
  unsigned* acc;                 // scratch (B, SETTLE_PAD): [0] settled,
                                 //   [2, 3] relax_inc as a u64, [SETTLE_ATTR
                                 //   + t] term t's first-true count
  float* d_src;                  // scratch (B, n): the relax sources' entry d
  uint2* work;                   // scratch (tiles, total_rows): (row, word)
  // the state's counters (the tail)
  int* trips;                    // 0-dim
  int* phases;                   // (B,)
  long long* sum_fringe;         // (B,)
  long long* relax_edges;        // (B,)
  int* ring;                     // (B, ring_len) settled counts
  int* fringe_ring;              // (B, ring_len) telemetry, or null (none
  int* relax_ring;               //   of the three): fringe sizes, relax_inc,
  int* attr_ring;                //   (B, ring_len, n_terms) first-true counts
  // delta's form (delta_mode): mins is the threshold's (2, B), n_fringe its
  // first count row
  float* keys;                   // (2, B, n) last_proc and removed, in place
  const int* deg_light;          // (n,) out-arcs of weight <= delta
  const int* deg_heavy;          // (n,) the others
  const int* n_cur;              // (B,) the threshold's second count row
  long long n;
  long long total_rows;          // rows of the view (every bucket)
  int lanes;
  int nb;                        // buckets with rows
  int k_out;                     // OUT lanes: mins rows 1..k_out
  int zero;                      // the DIJK term d <= min_F d
  int stop;                      // stop_on_lane_finish
  int ring_len;
  int n_terms;                   // zero + (in_key != null) + k_out; delta: 3
  float delta;                   // delta's f32 bucket width
  int delta_mode;                // 1: delta's form
};

// The reference's loop predicate from the phase's fringe sizes: some lane
// live, trips left, and under stop_on_lane_finish every lane live at entry
// still live. Every thread of the block gets it.
__device__ __forceinline__ bool settle_go(const SettleArgs& a) {
  int any_live = 0, differ = 0;
  for (int b = threadIdx.x; b < a.lanes; b += blockDim.x) {
    const bool live = a.n_fringe[b] > 0;
    any_live |= live;
    differ |= live != (a.live0[b] != 0);
  }
  any_live = __syncthreads_or(any_live);
  differ = __syncthreads_or(differ);
  return any_live != 0 && *a.budget > 0 && !(a.stop && differ != 0);
}

// Whether lane b is on delta's heavy turn: no work set (the threshold's
// witness, see frontier_crit.cu).
__device__ __forceinline__ bool delta_heavy(const SettleArgs& a, int b) {
  return !(a.n_cur[b] > 0 && a.mins[a.lanes + b] == a.mins[b]);
}

// The mark (DELTA: delta's). Grid: (blocks over n, lane tiles); a thread is
// a vertex u of its block's tile of 32 lanes.
template <bool DELTA>
__device__ __forceinline__ void settle_mark_body(const SettleArgs& a) {
  __shared__ float s_min[1 + SETTLE_MAX_OUT][32];
  __shared__ float s_bound[32];
  __shared__ unsigned s_cnt[32];
  __shared__ unsigned long long s_deg[32];
  __shared__ unsigned s_attr[SETTLE_MAX_TERMS][32];
  __shared__ unsigned s_wcnt[SETTLE_SHARED_BUCKETS];
  __shared__ unsigned s_wbase[SETTLE_SHARED_BUCKETS];
  __shared__ unsigned s_heavy;  // DELTA: bit k, lane b0 + k's heavy turn
  const bool go = settle_go(a);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *a.go = go;
  if (!go) return;
  const long long n = a.n;
  const int tile = blockIdx.y;
  const int b0 = tile * 32;
  const int nl = min(32, a.lanes - b0);
  const bool attr = a.attr_ring != nullptr;
  const bool agg = a.nb <= SETTLE_SHARED_BUCKETS;
  if (threadIdx.x < nl) {
    const int b = b0 + threadIdx.x;
    for (int k = 0; k <= a.k_out; ++k) {
      s_min[k][threadIdx.x] = a.mins[(long long)k * a.lanes + b];
    }
    // the s->t bound: the target's entry distance (+inf on a full-solve
    // lane, where it gates nothing but the +inf sources)
    float bd = CUDART_INF_F;
    if (!DELTA && a.target != nullptr && a.target[b] >= 0) {
      bd = a.d[(long long)b * n + a.target[b]];
    }
    s_bound[threadIdx.x] = bd;
    s_cnt[threadIdx.x] = 0;
    s_deg[threadIdx.x] = 0;
    for (int t = 0; attr && t < a.n_terms; ++t) s_attr[t][threadIdx.x] = 0;
  }
  if (DELTA && threadIdx.x < 32) {
    const bool h = threadIdx.x < nl && delta_heavy(a, b0 + threadIdx.x);
    const unsigned hw = __ballot_sync(FULL_MASK, h);
    if (threadIdx.x == 0) s_heavy = hw;
  }
  for (int k = threadIdx.x; agg && k < a.nb; k += blockDim.x) s_wcnt[k] = 0;
  __syncthreads();
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned pword = 0;  // lanes u pushes in: relax sources with d < +inf
  int bucket = 0, first = 0, rows = 0, base = 0;
  unsigned off = 0;
  if (u < n) {
    const float ik = !DELTA && a.in_key != nullptr ? a.in_key[u] : 0.0f;
    int deg = -1, deg_h = -1;  // DELTA: the light and heavy degrees
    for (int k = 0; k < nl; ++k) {
      const long long i = (long long)(b0 + k) * n + u;
      if (a.status[i] != 1) continue;
      if (DELTA) {
        float* removed = a.keys + (long long)a.lanes * n;
        float dv;
        if ((s_heavy >> k) & 1u) {
          // the heavy turn: the removed fringe vertices settle
          if (!(removed[i] > 0.5f)) continue;
          a.status[i] = 2;
          a.keys[i] = CUDART_INF_F;
          removed[i] = 0.0f;
          atomicAdd(&s_cnt[k], 1u);
          if (deg_h < 0) deg_h = a.deg_heavy[u];
          atomicAdd(&s_deg[k], (unsigned long long)deg_h);
          dv = a.d[i];
        } else {
          // a light round: the bucket's vertices below their last_proc
          dv = a.d[i];
          if (!(floorf(__fdiv_rn(dv, a.delta)) == s_min[0][k] &&
                dv < a.keys[i])) {
            continue;
          }
          a.keys[i] = dv;
          removed[i] = 1.0f;
          if (attr) atomicAdd(&s_attr[0][k], 1u);
          if (deg < 0) deg = a.deg_light[u];
          atomicAdd(&s_deg[k], (unsigned long long)deg);
        }
        if (dv != CUDART_INF_F) {  // a +inf source pushes nothing
          pword |= 1u << k;
          a.d_src[i] = dv;
        }
        continue;
      }
      const float dv = a.d[i];
      const float m0 = s_min[0][k];
      // the first true term, in the plan's order (t counts the terms)
      int term = -1, t = 0;
      if (a.zero) {
        if (dv <= m0) term = 0;
        t = 1;
      }
      if (a.in_key != nullptr) {
        if (term < 0 && dv - ik <= m0) term = t;
        ++t;
      }
      for (int j = 1; j <= a.k_out && term < 0; ++j, ++t) {
        if (dv <= s_min[j][k]) term = t;
      }
      if (term < 0) continue;
      a.status[i] = 2;
      atomicAdd(&s_cnt[k], 1u);
      if (attr) atomicAdd(&s_attr[term][k], 1u);
      // the relax sources: every settled vertex, or on a target state those
      // nearer than the bound (relax_from)
      if (a.target != nullptr && !(dv < s_bound[k])) continue;
      if (deg < 0) deg = a.out_deg[u];
      atomicAdd(&s_deg[k], (unsigned long long)deg);
      if (dv != CUDART_INF_F) {  // a +inf source pushes nothing
        pword |= 1u << k;
        a.d_src[i] = dv;
      }
    }
    if (pword != 0) {
      if (a.vrows != nullptr) {
        const int4 t = a.vrows[u];
        bucket = t.x;
        first = t.y;
        rows = t.z;
        base = t.w;
      } else {
        first = (int)u;
        rows = 1;
      }
      if (rows > 0) {
        off = agg ? atomicAdd(&s_wcnt[bucket], (unsigned)rows)
                  : atomicAdd(&a.counts[(long long)tile * a.nb + bucket],
                              (unsigned)rows);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; agg && k < a.nb; k += blockDim.x) {
    const unsigned c = s_wcnt[k];
    s_wbase[k] = c != 0 ? atomicAdd(&a.counts[(long long)tile * a.nb + k], c)
                        : 0u;
  }
  if (threadIdx.x < nl) {
    unsigned* acc = a.acc + (long long)(b0 + threadIdx.x) * SETTLE_PAD;
    if (s_cnt[threadIdx.x] != 0) atomicAdd(acc, s_cnt[threadIdx.x]);
    if (s_deg[threadIdx.x] != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(acc + 2),
                s_deg[threadIdx.x]);
    }
    for (int t = 0; attr && t < a.n_terms; ++t) {
      if (s_attr[t][threadIdx.x] != 0) {
        atomicAdd(acc + SETTLE_ATTR + t, s_attr[t][threadIdx.x]);
      }
    }
  }
  __syncthreads();
  if (pword != 0 && rows > 0) {
    uint2* list = a.work + (long long)tile * a.total_rows + base +
                  (agg ? s_wbase[bucket] : 0u) + off;
    for (int r = 0; r < rows; ++r) {
      list[r] = make_uint2((unsigned)(first + r), pword);
    }
  }
}

__global__ void __launch_bounds__(SETTLE_THREADS)
    settle_mark_kernel(const __grid_constant__ SettleArgs a) {
  settle_mark_body<false>(a);
}

__global__ void __launch_bounds__(SETTLE_THREADS)
    delta_settle_mark_kernel(const __grid_constant__ SettleArgs a) {
  settle_mark_body<true>(a);
}

// One bucket of the worklist push: its rows, its width's geometry, its
// global index (counts and the mark's row offsets).
struct SettleBucket {
  const int* cols;
  const float* ws;
  const int* rows;     // owner ids; null: row r belongs to vertex r
  long long row_off;   // its lists' first row (the rows of the buckets before)
  int d_pad;
  int g;
  int rt;
  int gidx;
};

struct SettleTable {
  SettleBucket e[PUSH_MAX_BUCKETS];
  int count;
};

// Warp task `task` of bucket `bk`'s list for lane tile `tile`: entries
// task * rt + [0, rt) of the list's `cnt`, one lane each. push_task's walk
// with the commit: each candidate d_src[b, u] + w lowers d[b, v] through the
// filtered atomic min and sets status 0 -> 1 (see the rule above). DELTA:
// `heavy` holds the tile's lanes on their heavy turn, and each slot's
// weight is gated by its lane's turn (delta's form above).
template <int G, bool DELTA>
__device__ __forceinline__ void settle_push_task(
    const SettleBucket& bk, const uint2* list, unsigned cnt, long long task,
    int tile, const SettleArgs& a, unsigned heavy) {
  constexpr int RPW = 32 / G;
  constexpr int SPAN = PUSH_UNROLL * G;
  const long long n = a.n;
  const int lane = threadIdx.x & 31;
  const int gid = lane / G, sub = lane % G;
  const unsigned low = G == 32 ? FULL_MASK : (1u << (G % 32)) - 1u;
  const unsigned gmask = low << (gid * G);
  const long long e = task * bk.rt + lane;
  unsigned m = 0;
  int owner = 0, row = 0;
  if (lane < bk.rt && e < (long long)cnt) {
    const uint2 ent = list[e];
    row = (int)ent.x;
    owner = bk.rows != nullptr ? bk.rows[row] : row;
    if (owner >= 0 && owner < n) m = ent.y;
  }
  unsigned left = __ballot_sync(FULL_MASK, m != 0);
  while (left != 0) {
    unsigned pick = left;
    for (int q = 0; q < gid && pick != 0; ++q) pick &= pick - 1;
    const int src = pick != 0 ? __ffs(pick) - 1 : -1;
#pragma unroll
    for (int q = 0; q < RPW; ++q) left &= left - 1;
    const int s0 = src < 0 ? 0 : src;
    const unsigned rm = __shfl_sync(FULL_MASK, m, s0);
    const int u = __shfl_sync(FULL_MASK, owner, s0);
    const long long r = __shfl_sync(FULL_MASK, row, s0);
    if (src < 0) continue;
    const int* cp = bk.cols + r * bk.d_pad;
    const float* wp = bk.ws + r * bk.d_pad;
    for (int j0 = 0; j0 < bk.d_pad; j0 += SPAN) {
      int v[PUSH_UNROLL];
      float w[PUSH_UNROLL];
#pragma unroll
      for (int q = 0; q < PUSH_UNROLL; ++q) {
        const int j = j0 + q * G + sub;
        v[q] = j < bk.d_pad ? __ldcs(cp + j) : -1;
        w[q] = j < bk.d_pad ? __ldcs(wp + j) : 0.0f;
      }
      int end = SPAN;
#pragma unroll
      for (int q = 0; q < PUSH_UNROLL; ++q) {
        const unsigned x =
            (__ballot_sync(gmask, v[q] < 0 || v[q] >= n) >> (gid * G)) & low;
        if (x != 0 && end == SPAN) end = q * G + __ffs(x) - 1;
      }
      // DELTA: bit q set where slot q's weight is light (w <= delta, the
      // reference's compare; a NaN weight is heavy)
      unsigned light = 0;
#pragma unroll
      for (int q = 0; DELTA && q < PUSH_UNROLL; ++q) {
        light |= (unsigned)(w[q] <= a.delta) << q;
      }
      for (unsigned lb = rm; lb != 0; lb &= lb - 1) {
        const int k = __ffs(lb) - 1;
        const long long b = (long long)tile * 32 + k;
        const float du = __ldg(a.d_src + b * n + u);
        float* drow = a.d + b * n;
        int* srow = a.status + b * n;
        // DELTA: bit q set where slot q is of the lane's turn; a slot of the
        // other turn gives d + inf, which is +inf and is not read unless
        // the source is NaN or -inf
        const unsigned turn =
            !DELTA ? ~0u : ((heavy >> k) & 1u) != 0 ? ~light : light;
        const unsigned take =
            DELTA && du > -CUDART_INF_F && du < CUDART_INF_F ? turn : ~0u;
        float cur[PUSH_UNROLL];
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          cur[q] = q * G + sub < end && ((take >> q) & 1u) != 0
                       ? __ldcg(drow + v[q])
                       : CUDART_NAN_F;
        }
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          if (q * G + sub >= end || ((take >> q) & 1u) == 0) continue;
          // the reference's add on its gated weight
          const float cand =
              du + (((turn >> q) & 1u) != 0 ? w[q] : CUDART_INF_F);
          const bool lowers =
              cand != cand ? cur[q] == cur[q]
                           : cand < cur[q] || (cand == cur[q] &&
                                               signbit(cand) &&
                                               !signbit(cur[q]));
          if (lowers) atomic_min_f32(drow + v[q], cand);
          if (cand < CUDART_INF_F && (lowers || cur[q] != cur[q]) &&
              __ldcg(srow + v[q]) == 0) {
            srow[v[q]] = 1;
          }
        }
      }
      if (end < SPAN) break;
    }
  }
}

// The worklist push over one group of buckets (DELTA: delta's). Grid: (a
// persistent count of blocks, lane tiles); each block reads its tile's list
// counts (DELTA: and its lanes' turns), and its warps walk the warp tasks of
// the group's lists (grid-stride).
template <bool DELTA>
__device__ __forceinline__ void settle_push_body(const SettleTable& tab,
                                                 const SettleArgs& a) {
  __shared__ unsigned s_cnt[PUSH_MAX_BUCKETS];
  __shared__ long long s_first[PUSH_MAX_BUCKETS + 1];
  __shared__ unsigned s_heavy;
  constexpr int WARPS = PUSH_THREADS / 32;
  const int tile = blockIdx.y;
  if (DELTA && threadIdx.x < 32) {
    const int b = tile * 32 + threadIdx.x;
    const bool h = b < a.lanes && delta_heavy(a, b);
    const unsigned hw = __ballot_sync(FULL_MASK, h);
    if (threadIdx.x == 0) s_heavy = hw;
  }
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int i = 0; i < tab.count; ++i) {
      const unsigned c = __ldcg(a.counts + (long long)tile * a.nb +
                                tab.e[i].gidx);
      s_cnt[i] = c;
      s_first[i] = t;
      t += ((long long)c + tab.e[i].rt - 1) / tab.e[i].rt;
    }
    s_first[tab.count] = t;
  }
  __syncthreads();
  const long long tasks = s_first[tab.count];
  for (long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       gw < tasks; gw += (long long)gridDim.x * WARPS) {
    int i = 0;
    while (i + 1 < tab.count && gw >= s_first[i + 1]) ++i;
    const SettleBucket& bk = tab.e[i];
    const uint2* list = a.work + (long long)tile * a.total_rows + bk.row_off;
    const long long task = gw - s_first[i];
    const unsigned heavy = DELTA ? s_heavy : 0u;
    if (bk.g == 8) {
      settle_push_task<8, DELTA>(bk, list, s_cnt[i], task, tile, a, heavy);
    } else if (bk.g == 16) {
      settle_push_task<16, DELTA>(bk, list, s_cnt[i], task, tile, a, heavy);
    } else {
      settle_push_task<32, DELTA>(bk, list, s_cnt[i], task, tile, a, heavy);
    }
  }
}

__global__ void __launch_bounds__(PUSH_THREADS)
    settle_push_kernel(const __grid_constant__ SettleTable tab,
                       const __grid_constant__ SettleArgs a) {
  settle_push_body<false>(tab, a);
}

__global__ void __launch_bounds__(PUSH_THREADS)
    delta_settle_push_kernel(const __grid_constant__ SettleTable tab,
                             const __grid_constant__ SettleArgs a) {
  settle_push_body<true>(tab, a);
}

// The tail. Grid: (1, 1) on a state without targets, else (blocks over
// the row in SETTLE_TAIL_SPAN chunks, lanes). Block (0, 0) folds the
// counters into the state and zeroes them and the list counts; block
// (x, b) demotes chunk x of lane b's fringe (status 1 -> 0) when lane b's
// target settled: status[b, target] == 2 after the push on a lane whose
// fringe was not empty at the phase's entry (the reference demotes where
// the target's status is 2; a lane that entered without fringe has no
// status 1 to demote).
__global__ void __launch_bounds__(SETTLE_TAIL_THREADS)
    settle_tail_kernel(const __grid_constant__ SettleArgs a, int n_counts) {
  if (*a.go == 0) return;
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int b = threadIdx.x; b < a.lanes; b += blockDim.x) {
      unsigned* acc = a.acc + (long long)b * SETTLE_PAD;
      const int nf = a.n_fringe[b];
      const unsigned long long inc =
          *reinterpret_cast<unsigned long long*>(acc + 2);
      if (nf > 0) {
        const long long slot =
            (long long)b * a.ring_len + a.phases[b] % a.ring_len;
        a.ring[slot] = (int)acc[0];
        if (a.attr_ring != nullptr) {
          a.fringe_ring[slot] = nf;
          a.relax_ring[slot] = (int)(unsigned)inc;  // the int32 cast's wrap
          if (a.delta_mode) {
            // delta's (light, heavy, the lane's bucket id)
            int* at = a.attr_ring + slot * a.n_terms;
            at[0] = (int)acc[SETTLE_ATTR];
            at[1] = (int)acc[0];
            at[2] = __float2int_rz(a.mins[b]);
          } else {
            for (int t = 0; t < a.n_terms; ++t) {
              a.attr_ring[slot * a.n_terms + t] = (int)acc[SETTLE_ATTR + t];
            }
          }
        }
        a.phases[b] += 1;
        a.sum_fringe[b] += nf;
      }
      a.relax_edges[b] += (long long)inc;
      acc[0] = 0u;
      *reinterpret_cast<unsigned long long*>(acc + 2) = 0ull;
      for (int t = 0; a.attr_ring != nullptr && t < a.n_terms; ++t) {
        acc[SETTLE_ATTR + t] = 0u;
      }
    }
    if (threadIdx.x == 0) {
      *a.trips += 1;
      *a.budget -= 1;
    }
    for (int i = threadIdx.x; i < n_counts; i += blockDim.x) a.counts[i] = 0u;
  }
  if (a.target == nullptr) return;
  const int b = blockIdx.y;
  const int t = a.target[b];
  if (t < 0 || a.n_fringe[b] <= 0) return;
  int* srow = a.status + (long long)b * a.n;
  if (__ldcg(srow + t) != 2) return;
  const long long v1 = min(a.n, (long long)(blockIdx.x + 1) * SETTLE_TAIL_SPAN);
  for (long long v = (long long)blockIdx.x * SETTLE_TAIL_SPAN + threadIdx.x;
       v < v1; v += blockDim.x) {
    if (srow[v] == 1) srow[v] = 0;
  }
}

// Blocks a lane tile of the worklist push: enough warps for the most warp
// tasks the view can give, at most PUSH_PERSIST_BLOCKS (a fixed grid, so a
// CUDA graph can capture it).
#define PUSH_PERSIST_BLOCKS 1056  // 8 blocks of 256 threads on each of 132 SMs

// One phase's mark, push or tail (`which`: 0, 1, 2) on `stream`. `args`
// is the host-filled SettleArgs (its scratch zeroed once and left zeroed by
// every tail); `table` the host bucket table (5 int64 a bucket, as for
// ell_push_relax_launch: cols, ws, rows or 0, row count, width; buckets
// without rows left out, which is the mark's bucket numbering). Returns 0,
// cudaErrorInvalidValue for sizes the kernels do not take (checked before
// any launch), or the launch's error.
extern "C" int settle_phase_launch(int which, const SettleArgs* args,
                                   const long long* table, int n_buckets,
                                   void* stream) {
  const SettleArgs& a = *args;
  const bool attr = a.attr_ring != nullptr;
  if (a.n < 1 || a.lanes < 1 || a.nb < 0 || n_buckets != a.nb ||
      a.k_out < 0 || a.k_out > SETTLE_MAX_OUT || a.ring_len < 1 ||
      (a.vrows == nullptr && a.nb != 1) ||
      attr != (a.fringe_ring != nullptr) || attr != (a.relax_ring != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // delta's form: the threshold's two rows, its operands, three slots
  const bool terms_ok =
      a.delta_mode
          ? a.k_out == 1 && a.zero == 0 && a.in_key == nullptr &&
                a.n_terms == 3 && a.keys != nullptr &&
                a.deg_light != nullptr && a.deg_heavy != nullptr &&
                a.n_cur != nullptr
          : a.n_terms == (a.zero != 0) + (a.in_key != nullptr) + a.k_out;
  if (!terms_ok) return (int)cudaErrorInvalidValue;
  const int tiles = (a.lanes + 31) / 32;
  if (tiles > 65535 || a.lanes > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) {
    const dim3 grid((unsigned)((a.n + SETTLE_THREADS - 1) / SETTLE_THREADS),
                    (unsigned)tiles);
    if (a.delta_mode) {
      delta_settle_mark_kernel<<<grid, SETTLE_THREADS, 0, s>>>(a);
    } else {
      settle_mark_kernel<<<grid, SETTLE_THREADS, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
  }
  if (which == 2) {
    const dim3 grid(
        a.target == nullptr
            ? 1u
            : (unsigned)((a.n + SETTLE_TAIL_SPAN - 1) / SETTLE_TAIL_SPAN),
        a.target == nullptr ? 1u : (unsigned)a.lanes);
    settle_tail_kernel<<<grid, SETTLE_TAIL_THREADS, 0, s>>>(a, tiles * a.nb);
    return (int)cudaGetLastError();
  }
  if (which != 1) return (int)cudaErrorInvalidValue;
  // the push: one launch a group of PUSH_MAX_BUCKETS buckets, in order (a
  // view without rows launches one that finds no list)
  SettleTable tab;
  long long row_off = 0;  // the bucket's first row of a worklist
  for (int i0 = 0; i0 < a.nb || i0 == 0; i0 += PUSH_MAX_BUCKETS) {
    tab.count = 0;
    long long tasks = 0;
    for (int i = i0; i < a.nb && i < i0 + PUSH_MAX_BUCKETS; ++i) {
      const long long* t = table + 5 * i;
      if (t[3] < 1 || t[4] < 1) return (int)cudaErrorInvalidValue;
      SettleBucket& e = tab.e[tab.count++];
      e.cols = (const int*)t[0];
      e.ws = (const float*)t[1];
      e.rows = (const int*)t[2];
      e.d_pad = (int)t[4];
      e.g = push_threads_per_row(e.d_pad);
      e.rt = push_rows_per_task(e.d_pad);
      e.gidx = i;
      e.row_off = row_off;
      row_off += t[3];
      tasks += (t[3] + e.rt - 1) / e.rt;
    }
    constexpr long long WARPS = PUSH_THREADS / 32;
    long long blocks = (tasks + WARPS - 1) / WARPS;
    if (blocks > PUSH_PERSIST_BLOCKS) blocks = PUSH_PERSIST_BLOCKS;
    if (blocks < 1) blocks = 1;
    const dim3 grid((unsigned)blocks, (unsigned)tiles);
    if (a.delta_mode) {
      delta_settle_push_kernel<<<grid, PUSH_THREADS, 0, s>>>(tab, a);
    } else {
      settle_push_kernel<<<grid, PUSH_THREADS, 0, s>>>(tab, a);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}
