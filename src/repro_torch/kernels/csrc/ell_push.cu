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

// Mark: mask[t, u] bit k set iff dmask[t * 32 + k, u] != +inf; upd = +inf.
// Grid: (vertex blocks, lane tiles).
__global__ void push_mark_kernel(const float* __restrict__ dmask, long long n,
                                 int lanes, unsigned* __restrict__ mask,
                                 float* __restrict__ upd) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n) return;
  const int t = blockIdx.y;
  const int b1 = min(lanes, t * 32 + 32);
  unsigned bits = 0;
  for (int b = t * 32; b < b1; ++b) {
    const long long i = (long long)b * n + u;
    if (dmask[i] != CUDART_INF_F) bits |= 1u << (b - t * 32);
    upd[i] = CUDART_INF_F;
  }
  mask[(long long)t * n + u] = bits;
}

// The rows of warp task `task` of bucket `bk`, for lane tile `tile`: rows
// task * rt + [0, rt), one lane each for the mask read.
template <int G>
__device__ __forceinline__ void push_task(
    const PushBucket& bk, long long task, int tile,
    const float* __restrict__ dmask, long long n,
    const unsigned* __restrict__ mask, float* upd,
    unsigned long long& n_cand, unsigned long long& n_atomic) {
  constexpr int RPW = 32 / G;  // rows in flight a warp
  constexpr int SPAN = PUSH_UNROLL * G;  // slots of a row a pass covers
  const int lane = threadIdx.x & 31;
  const int gid = lane / G, sub = lane % G;
  const unsigned low = G == 32 ? FULL_MASK : (1u << (G % 32)) - 1u;
  const unsigned gmask = low << (gid * G);
  const long long r = task * bk.rt + lane;
  unsigned m = 0;
  int owner = 0;
  if (lane < bk.rt && r < bk.n_rows) {
    owner = bk.rows != nullptr ? bk.rows[r] : (int)r;
    if (owner >= 0 && owner < n) m = mask[(long long)tile * n + owner];
  }
  unsigned rest = __ballot_sync(FULL_MASK, m != 0);  // warp-uniform
  while (rest != 0) {
    // group gid takes the gid-th lowest active row of what is left
    unsigned pick = rest;
    for (int q = 0; q < gid && pick != 0; ++q) pick &= pick - 1;
    const int src = pick != 0 ? __ffs(pick) - 1 : -1;
#pragma unroll
    for (int q = 0; q < RPW; ++q) rest &= rest - 1;
    const unsigned rm = __shfl_sync(FULL_MASK, m, src < 0 ? 0 : src);
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
      // the row ends at its first id outside [0, n): slots [0, end) of
      // this pass are the row's, the same for the whole group
      int end = SPAN;
#pragma unroll
      for (int q = 0; q < PUSH_UNROLL; ++q) {
        const unsigned e =
            (__ballot_sync(gmask, v[q] < 0 || v[q] >= n) >> (gid * G)) & low;
        if (e != 0 && end == SPAN) end = q * G + __ffs(e) - 1;
      }
      for (unsigned bits = rm; bits != 0; bits &= bits - 1) {
        const long long b = (long long)tile * 32 + __ffs(bits) - 1;
        const float du = __ldg(dmask + b * n + u);
        float* urow = upd + b * n;
        float cur[PUSH_UNROLL];
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          cur[q] = (PUSH_FILTER && q * G + sub < end) ? __ldcg(urow + v[q])
                                                      : CUDART_NAN_F;
        }
#pragma unroll
        for (int q = 0; q < PUSH_UNROLL; ++q) {
          if (q * G + sub >= end) continue;
          const float cand = du + w[q];
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

// Push: each warp walks warp tasks of the bucket table (grid-stride), the
// lane tile is blockIdx.y. `stats`, when not null, gets [candidates, atomics
// issued] added.
__global__ void __launch_bounds__(PUSH_THREADS)
    push_kernel(PushTable tab, long long tasks,
                const float* __restrict__ dmask, long long n,
                const unsigned* __restrict__ mask, float* upd,
                unsigned long long* stats) {
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
      push_task<8>(bk, task, tile, dmask, n, mask, upd, n_cand, n_atomic);
    } else if (bk.g == 16) {
      push_task<16>(bk, task, tile, dmask, n, mask, upd, n_cand, n_atomic);
    } else {
      push_task<32>(bk, task, tile, dmask, n, mask, upd, n_cand, n_atomic);
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
  if (n < 1 || lanes < 1 || n_buckets < 0) return (int)cudaErrorInvalidValue;
  const int tiles = (lanes + 31) / 32;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  PushTable tab;
  long long tasks = 0;
  for (int i = 0; i < n_buckets;) {
    const int rc = next_group(table, n_buckets, &i, &tab, &tasks);
    if (rc != 0) return rc;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 mark_grid((unsigned)((n + PUSH_THREADS - 1) / PUSH_THREADS),
                       (unsigned)tiles);
  push_mark_kernel<<<mark_grid, PUSH_THREADS, 0, s>>>(dmask, n, lanes, mask,
                                                      upd);
  int rc = (int)cudaGetLastError();
  for (int i = 0; rc == 0 && i < n_buckets;) {
    next_group(table, n_buckets, &i, &tab, &tasks);
    if (tasks == 0) continue;
    constexpr long long WARPS = PUSH_THREADS / 32;
    long long blocks = (tasks + WARPS - 1) / WARPS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    push_kernel<<<dim3((unsigned)blocks, (unsigned)tiles), PUSH_THREADS, 0,
                  s>>>(tab, tasks, dmask, n, mask, upd, stats);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
