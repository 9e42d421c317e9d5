// frontier_crit_lanes_batch: the fused frontier reduction over plan lanes.
//
//   mins[0, b]     = min_{v in F_b} d[b, v]
//   mins[1 + k, b] = min_{v in F_b} (d[b, v] + keys[k, (b,) v])
//   cnt[b]         = |F_b|                      (F_b = {v : status[b, v] == 1})
//
// Replaces the TPU kernel repro/kernels/frontier_crit.py::
// frontier_crit_lanes_batch (:94, pallas_call at :136). There the grid ran in
// order on one core and every step min/sum-accumulated into one
// VMEM-resident output block (pl.when(step == 0) init). CUDA blocks run
// concurrently and in no order. The TPU's 128-lane output padding is not
// carried over.
//
// What bounds it on an H100: memory. It reads d and status once
// (B * n * 8 bytes) plus the keys (K * n * 4 shared, K * B * n * 4
// per-lane) and writes a few bytes per lane; at n = 1e6, B = 8 that is
// 64 MB + 4 MB (~0.020 ms at 3.35 TB/s) with the shared out_min_static, or
// + 32 MB (~0.030 ms) with one per-lane key.
//
// The design it replaces (two launches: per-block partials over a
// (n / 2048, B) grid, then one fold block per lane) was latency-bound, not
// bandwidth-bound: each thread loaded one status word, branched on it and
// only then loaded d and the keys, in a loop with a runtime trip count, so
// its loads were 8 dependent round trips and the folds sat on that path
// (~1 TB/s on its first pass; the event time twice the device time, from
// the second launch, two scratch allocations and two ctypes calls). What
// this design does:
//  * one launch a call: a grid of (blocks_x, B) blocks, blocks_x * B about
//    CRIT_BLOCKS_PER_SM (kernels/config.py) blocks on each SM in one wave
//    (CRIT_MIN_BLOCKS holds the registers to that many);
//    block (x, b) walks chunks x, x + blocks_x, ... of lane b's row, each
//    chunk Unroll<K, ALIGNED> * CRIT_THREADS groups of 4 vertices. Each
//    block writes its partials, fences, and draws a ticket (atomicAdd); the
//    block that draws the last one folds every block's partials, writes
//    mins and cnt and puts the ticket back to 0 for the next launch in
//    stream order. The scratch (partials and ticket) is allocated and
//    zeroed once per device and stream by the wrapper and reused. f32 min
//    does not round and the int32 count is an exact sum, so the result is
//    the same in any order;
//  * every load issued before any fold: each thread loads
//    Unroll<K, ALIGNED> groups of 4 vertices at a time, status as int4, d
//    and each key as float4, unconditionally (a vertex off the fringe then
//    folds +inf), so each SM has tens of KB in flight. A row that does
//    not start on a 16-byte boundary (n % 4 != 0, or a view) takes the
//    vertices before the first aligned one and after the last whole group
//    as a scalar head and tail, and a stream whose groups are still not
//    aligned to 16 bytes (status or a key row at another offset) loads each
//    group's 4 words as scalars, issued the same way;
//  * a template on K (0 for no keys), so that registers hold only the lanes
//    in use; the shared and the per-lane key stacks differ only in their
//    strides.
//
// The delta threshold (delta_thresholds_launch, delta_crit_kernel) is a
// second entry point of the same body, for delta-stepping's phase:
//
//   mins[0, b] = min_{v in F_b} x[b, v]         (the lane's bucket)
//   mins[1, b] = min_{v in W_b} x[b, v]         cnt[0, b] = |F_b|
//   cnt[1, b]  = |W_b|        W_b = {v in F_b : d[b, v] < last_proc[b, v]}
//
// with the bucket ids x = floorf(d / delta), an IEEE f32 divide
// (__fdiv_rn; no __fdividef, no fast math) done in registers, delta the
// bits of the state's f32 width. It stands for the same TPU kernel (#2),
// which the reference's delta phase runs on x after a PyTorch pass builds
// x over B x n, and adds the witness of a light round: a lane has one iff
// cnt[1] > 0 and mins[1] == mins[0] (no d in W is NaN, so W's least id is
// attained, and the count tells an empty W from an attained +inf id, which
// a d / delta that overflows gives). It reads last_proc beside d and
// status (B * n * 12 bytes, ~0.03 ms at n = 1e6, B = 8). The criterion
// plans' #2 keeps its function and its launch.
//
// Min semantics: the fold keeps a NaN, as jnp.min does, and takes -0 over
// +0 on a tie in either order, as XLA's min does (the card's min.f32,
// min.NaN.f32 and fminf all give -0 on that tie). CRIT_NAN_FLAG picks the
// form: 0 folds with PTX min.NaN (one instruction, NaN wins), 1 with fminf
// (which drops a NaN) beside a flag a lane that records any NaN and makes
// the result NaN once, at the end of the block's fold (tools/crit_variants.py
// times the two; the faster ships).
#include <cuda_runtime.h>
#include <math_constants.h>

#define KMAX 8
#define CRIT_THREADS 256
#define CRIT_MIN_BLOCKS 4  // blocks an SM the registers must allow
#define CRIT_NAN_FLAG 0

// min(m, v) as jnp.minimum gives it: NaN if either is NaN (the canonical
// NaN: card parity takes every NaN as one value), and -0 for a tie of -0
// and +0 in either order: PTX min.NaN, as the gathers of ell_gather.cu fold.
__device__ __forceinline__ float nan_min(float m, float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

// The running minima of one thread (or block) for lanes l < 1 + K, with
// the NaN flags of the CRIT_NAN_FLAG form (bit l: lane l met a NaN).
// DELTA (K = 1, the key last_proc): lane 0 folds the bucket ids of F,
// lane 1 those of W, and cnt1 counts W.
template <int K, bool DELTA = false>
struct Acc {
  float m[1 + K];
  unsigned nan;
  int cnt;
  int cnt1;  // delta only
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int l = 0; l <= K; ++l) m[l] = CUDART_INF_F;
    nan = 0u;
    cnt = 0;
    if constexpr (DELTA) cnt1 = 0;
  }
  __device__ __forceinline__ void fold(int l, float x) {
#if CRIT_NAN_FLAG
    m[l] = fminf(m[l], x);
    nan |= (unsigned)(x != x) << l;
#else
    m[l] = nan_min(m[l], x);
#endif
  }
  // the minima as jnp.min gives them: NaN where a NaN was folded
  __device__ __forceinline__ float value(int l) const {
#if CRIT_NAN_FLAG
    return (nan >> l) & 1u ? CUDART_NAN_F : m[l];
#else
    return m[l];
#endif
  }
  // one vertex: its status, d and keys (DELTA: kv[0] is last_proc)
  __device__ __forceinline__ void vertex(int s, float dv, const float* kv,
                                         float delta) {
    const bool f = s == 1;
    cnt += f;
    if (DELTA) {
      const float x = floorf(__fdiv_rn(dv, delta));
      const bool w = f && dv < kv[0];
      cnt1 += w;
      fold(0, f ? x : CUDART_INF_F);
      fold(1, w ? x : CUDART_INF_F);
      return;
    }
    fold(0, f ? dv : CUDART_INF_F);
#pragma unroll
    for (int k = 0; k < K; ++k) fold(1 + k, f ? dv + kv[k] : CUDART_INF_F);
  }
  // the warp's fold, every lane of the warp gets it
  __device__ __forceinline__ void warp_fold() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int l = 0; l <= K; ++l) {
        fold(l, __shfl_xor_sync(0xffffffffu, m[l], off));
      }
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      if constexpr (DELTA) cnt1 += __shfl_xor_sync(0xffffffffu, cnt1, off);
    }
#if CRIT_NAN_FLAG
    nan = __reduce_or_sync(0xffffffffu, nan);
#endif
  }
};

// Groups of 4 vertices a thread loads before it folds any: enough bytes in
// flight without holding more than ~64 registers of loaded words. The
// scalar form (!ALIGNED) needs more registers for its addresses: under
// CRIT_MIN_BLOCKS 4 (64 registers a thread) ptxas spilled K = 1 and 4 off
// 16-byte boundaries and K = 2 in both forms at the unrolls of the first
// design (4, 4, 2), so those take one step less (the audit of
// repro_torch.analysis reads every instance's spills). K = 1 on aligned
// rows, the default plan's form at n % 4 == 0, keeps 4. K = 7 and 8 off
// the boundary still spill 36-40 bytes at an unroll of 1 (their K row
// pointers and K + 2 accumulators); no plan has more than 4 OUT keys, and
// their contract names that reason.
template <int K, bool ALIGNED>
struct Unroll {
  static constexpr int value =
      (K == 0 || (K == 1 && ALIGNED)) ? 4
      : (K <= 3 || (K == 4 && ALIGNED)) ? 2 : 1;
};

struct CritArgs {
  const float* d;        // (B, n)
  const int* status;     // (B, n)
  const float* keys;     // keys[k * key_sk + b * key_sb + v]
  long long n;
  long long key_sk;
  long long key_sb;
  float* part_min;       // (1 + K, B, blocks_x)
  int* part_cnt;         // (B, blocks_x); delta: (2, B, blocks_x)
  unsigned* ticket;      // 0 between launches
  float* mins;           // (1 + K, B)
  int* cnt;              // (B,); delta: (2, B)
  float delta;           // delta's bucket width (the delta form only)
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

template <typename T, typename V>
__device__ __forceinline__ void load4(const T* p, bool vec, T* out) {
  if (vec) {
    const V q = __ldg(reinterpret_cast<const V*>(p));
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __ldg(p + i);
  }
}

// The per-warp counts of delta's W in shared memory; the criterion forms
// declare none, so their kernels keep the shared memory they had.
template <bool DELTA>
__device__ __forceinline__ int* delta_counts() {
  if constexpr (DELTA) {
    __shared__ int sc1[CRIT_THREADS / 32];
    return sc1;
  } else {
    return nullptr;
  }
}

// K keys; the key form is in the strides (a shared (K, n) stack has
// key_sb = 0). ALIGNED: every row of every stream starts on a 16-byte
// boundary (n % 4 == 0 and aligned tensors, as at n = 1e6), so the head,
// the tail and the scalar forms go. DELTA: the delta threshold (K = 1, the
// key last_proc; see the note at the top).
template <int K, bool ALIGNED, bool DELTA>
__device__ __forceinline__ void crit_body(const CritArgs& a) {
  // the delta form holds three streams and a divide: 2 groups (4 spilled
  // 112 bytes under CRIT_MIN_BLOCKS 4)
  constexpr int U = DELTA ? 2 : Unroll<K, ALIGNED>::value;
  const int b = blockIdx.y;
  const int lanes = gridDim.y;
  const int bx = gridDim.x;
  const long long n = a.n;
  const float* drow = a.d + (long long)b * n;
  const int* srow = a.status + (long long)b * n;
  const float* krow[K > 0 ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) krow[k] = a.keys + k * a.key_sk + b * a.key_sb;
  // vertices [0, h) and [h + 4 * groups, n) are the scalar head and tail
  long long h = 0;
  if (!ALIGNED) {
    h = (long long)((16u - ((unsigned)(unsigned long long)drow & 15u)) & 15u)
        >> 2;
    if (h > n) h = n;
  }
  const long long groups = (n - h) >> 2;
  const bool svec = ALIGNED || aligned16(srow + h);
  bool kvec[K > 0 ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) kvec[k] = ALIGNED || aligned16(krow[k] + h);
  Acc<K, DELTA> acc;
  acc.init();
  const long long chunk = (long long)U * CRIT_THREADS;
  for (long long g0 = (long long)blockIdx.x * chunk + threadIdx.x;
       g0 < groups; g0 += (long long)bx * chunk) {
    int s[U][4];
    float dv[U][4];
    float kv[U][K > 0 ? K : 1][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + (long long)u * CRIT_THREADS;
      if (g < groups) {
        const long long v = h + 4 * g;
        load4<int, int4>(srow + v, svec, s[u]);
        load4<float, float4>(drow + v, true, dv[u]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          load4<float, float4>(krow[k] + v, kvec[k], kv[u][k]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[u][i] = 0;  // off the fringe
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ki[K > 0 ? K : 1];
#pragma unroll
        for (int k = 0; k < K; ++k) ki[k] = kv[u][k][i];
        acc.vertex(s[u][i], dv[u][i], ki, a.delta);
      }
    }
  }
  if (!ALIGNED && blockIdx.x == 0) {
    const long long tail0 = h + 4 * groups;
    const long long v = threadIdx.x < h ? (long long)threadIdx.x
                                        : tail0 + threadIdx.x - h;
    if (threadIdx.x < h + (n - tail0)) {
      float ki[K > 0 ? K : 1];
#pragma unroll
      for (int k = 0; k < K; ++k) ki[k] = krow[k][v];
      acc.vertex(srow[v], drow[v], ki, a.delta);
    }
  }

  // the block's partial: warps, then warp 0 over the warps' values
  __shared__ float sm[1 + K][CRIT_THREADS / 32];
  __shared__ int sc[CRIT_THREADS / 32];
  int* const sc1 = delta_counts<DELTA>();  // delta's count of W
  __shared__ unsigned sn[CRIT_THREADS / 32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  constexpr int WARPS = CRIT_THREADS / 32;
  acc.warp_fold();
  if (wl == 0) {
#pragma unroll
    for (int l = 0; l <= K; ++l) sm[l][warp] = acc.m[l];
    sc[warp] = acc.cnt;
    if constexpr (DELTA) sc1[warp] = acc.cnt1;
    sn[warp] = acc.nan;
  }
  __syncthreads();
  if (warp == 0) {
    Acc<K, DELTA> w;
    w.init();
    if (wl < WARPS) {
#pragma unroll
      for (int l = 0; l <= K; ++l) w.m[l] = sm[l][wl];
      w.cnt = sc[wl];
      if constexpr (DELTA) w.cnt1 = sc1[wl];
      w.nan = sn[wl];
    }
    w.warp_fold();
    if (wl == 0) {
#pragma unroll
      for (int l = 0; l <= K; ++l) {
        a.part_min[((long long)l * lanes + b) * bx + blockIdx.x] = w.value(l);
      }
      a.part_cnt[(long long)b * bx + blockIdx.x] = w.cnt;
      if (DELTA) {
        a.part_cnt[((long long)lanes + b) * bx + blockIdx.x] = w.cnt1;
      }
      __threadfence();  // the partials before the ticket
      const unsigned t = atomicAdd(a.ticket, 1u);
      last = t == (unsigned)(bx * lanes) - 1u;
    }
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partials are written and fenced. Warp w
  // folds lanes w, w + WARPS, ..., reading past L1 (the partials come from
  // other SMs)
  __threadfence();
  for (int lb = warp; lb < lanes; lb += WARPS) {
    Acc<K, DELTA> f;
    f.init();
    for (int x = wl; x < bx; x += 32) {
#pragma unroll
      for (int l = 0; l <= K; ++l) {
        f.fold(l, __ldcg(a.part_min + ((long long)l * lanes + lb) * bx + x));
      }
      f.cnt += __ldcg(a.part_cnt + (long long)lb * bx + x);
      if (DELTA) {
        f.cnt1 += __ldcg(a.part_cnt + ((long long)lanes + lb) * bx + x);
      }
    }
    f.warp_fold();
    if (wl == 0) {
#pragma unroll
      for (int l = 0; l <= K; ++l) {
        a.mins[(long long)l * lanes + lb] = f.value(l);
      }
      a.cnt[lb] = f.cnt;
      if (DELTA) a.cnt[lanes + lb] = f.cnt1;
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;  // for the next launch on the stream
}

template <int K, bool ALIGNED>
__global__ void __launch_bounds__(CRIT_THREADS, CRIT_MIN_BLOCKS)
crit_kernel(const CritArgs a) {
  crit_body<K, ALIGNED, false>(a);
}

// The delta threshold: the body with the key last_proc and the bucket ids.
template <bool ALIGNED>
__global__ void __launch_bounds__(CRIT_THREADS, CRIT_MIN_BLOCKS)
delta_crit_kernel(const CritArgs a) {
  crit_body<1, ALIGNED, true>(a);
}

template <int K>
static int launch_k(const CritArgs& a, int lanes, int blocks_x, bool aligned,
                    cudaStream_t s) {
  const dim3 grid((unsigned)blocks_x, (unsigned)lanes);
  if (aligned) {
    crit_kernel<K, true><<<grid, CRIT_THREADS, 0, s>>>(a);
  } else {
    crit_kernel<K, false><<<grid, CRIT_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

static int launch_keys(const CritArgs& a, int nkeys, int lanes, int blocks_x,
                       bool aligned, cudaStream_t s) {
  switch (nkeys) {
    case 1: return launch_k<1>(a, lanes, blocks_x, aligned, s);
    case 2: return launch_k<2>(a, lanes, blocks_x, aligned, s);
    case 3: return launch_k<3>(a, lanes, blocks_x, aligned, s);
    case 4: return launch_k<4>(a, lanes, blocks_x, aligned, s);
    case 5: return launch_k<5>(a, lanes, blocks_x, aligned, s);
    case 6: return launch_k<6>(a, lanes, blocks_x, aligned, s);
    case 7: return launch_k<7>(a, lanes, blocks_x, aligned, s);
    case 8: return launch_k<8>(a, lanes, blocks_x, aligned, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch on `stream`; returns cudaGetLastError() after it (0 =
// launched), or cudaErrorInvalidValue for sizes the kernel does not take.
// Keys: none (nkeys 0), shared (K, n) (key_sk = n, key_sb = 0) or per lane
// (K, B, n) (key_sk = B * n, key_sb = n). Scratch: part_min
// (1 + nkeys) * lanes * blocks_x floats, part_cnt lanes * blocks_x ints,
// ticket one word that is 0 and that the launch leaves 0. Writes mins
// (1 + nkeys, lanes) and cnt (lanes,).
extern "C" int frontier_crit_lanes_launch(
    const float* d, const int* status, const float* keys, long long n,
    int lanes, int nkeys, long long key_sk, long long key_sb, int blocks_x,
    float* part_min, int* part_cnt, unsigned* ticket, float* mins, int* cnt,
    void* stream) {
  if (n < 1 || lanes < 1 || lanes > 65535 || blocks_x < 1 || nkeys < 0 ||
      nkeys > KMAX || (nkeys > 0 && keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const CritArgs a{d, status, keys, n, key_sk, key_sb, part_min, part_cnt,
                   ticket, mins, cnt, 0.0f};
  auto al = [](const void* p) { return ((unsigned long long)p & 15ull) == 0; };
  const bool aligned = n % 4 == 0 && al(d) && al(status) &&
                       (nkeys == 0 || (al(keys) && key_sk % 4 == 0 &&
                                       key_sb % 4 == 0));
  const cudaStream_t s = (cudaStream_t)stream;
  if (nkeys == 0) return launch_k<0>(a, lanes, blocks_x, aligned, s);
  return launch_keys(a, nkeys, lanes, blocks_x, aligned, s);
}

// The delta threshold on `stream` (see the note at the top): d, status and
// last_proc (lanes, n), delta the f32 bucket width. Scratch: part_min 2 *
// lanes * blocks_x floats, part_cnt 2 * lanes * blocks_x ints, the ticket as
// above. Writes mins (2, lanes) and cnt (2, lanes). Returns as
// frontier_crit_lanes_launch does.
extern "C" int delta_thresholds_launch(
    const float* d, const int* status, const float* last_proc, float delta,
    long long n, int lanes, int blocks_x, float* part_min, int* part_cnt,
    unsigned* ticket, float* mins, int* cnt, void* stream) {
  if (n < 1 || lanes < 1 || lanes > 65535 || blocks_x < 1 ||
      last_proc == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const CritArgs a{d, status, last_proc, n, 0, n, part_min, part_cnt,
                   ticket, mins, cnt, delta};
  auto al = [](const void* p) { return ((unsigned long long)p & 15ull) == 0; };
  const bool aligned = n % 4 == 0 && al(d) && al(status) && al(last_proc);
  const dim3 grid((unsigned)blocks_x, (unsigned)lanes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (aligned) {
    delta_crit_kernel<true><<<grid, CRIT_THREADS, 0, s>>>(a);
  } else {
    delta_crit_kernel<false><<<grid, CRIT_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
