// embed_grad: the gradient of an embedding lookup, summed in a fixed order.
//
//   out[v, :] = sum over the positions i with ids[i] == v, in position
//               order, of grad[i, :]          (+0 where v never occurs)
//
// Replaces no TPU kernel: the reference's lookup (repro/models/
// transformer.py:211, jnp.take on the embedding) leaves its gradient to XLA,
// whose scatter-add gives the same bits on every run. The port's lookup
// was torch.index_select, whose CUDA backward is an index_add_ with
// atomics: two runs of one training step gave the embedding's gradient in
// different bits. This kernel fixes the order of the adds and changes
// nothing else: each add rounds to the table's type, as index_add_ does,
// so the values are the ones a sequential index_add_ gives.
//
// The wrapper (kernels/embed_grad.py) sorts the flat ids with a stable
// sort and hands over the permutation `perm` (positions in token order,
// each token's run in position order) and `starts` (rows + 1 offsets of
// the runs, a binary search of the sorted ids). The block form (a rank's
// rows [row0, row0 + rows) of a vocabulary-parallel embedding) sorts the
// ids less row0: ids before the block sort ahead of run 0 and ids after it
// behind the last, so the kernel, which reads only the runs, skips them
// with no test of its own. EMBED_ROW_BLOCKS blocks
// walk the table's rows (block x owns rows x, x + gridDim.x, ...); a
// thread owns V neighbouring columns of a row (16 bytes: 4 f32 or 8 bf16,
// or one column where the row is not 16-byte aligned), walks the row's
// run in order, one gathered grad row after another, and writes its sums
// once: no atomics, and no order left to the schedule.
//
// What bounds it on an H100: memory. It reads each grad row once (N * D
// words), the run offsets and the permutation, and writes the whole
// table's gradient once (rows * D words, zeros included): for
// internlm2-1.8b at B = 4 x 2048, f32, 8192 * 2048 * 4 + 92672 * 2048 * 4
// bytes, ~0.83 GB, ~0.25 ms at 3.35 TB/s. Most rows are zeros, so the
// stores dominate: 16-byte stores from neighbouring threads on
// neighbouring addresses, from a fixed grid of blocks that each walk many
// rows (a first form, one 256-thread block a row and a column a thread,
// spent its time starting 524,280 blocks: 0.862 ms on an H100 80GB HBM3 at
// 700 W for the shapes above, against index_add_'s 0.367).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EMBED_THREADS 256
#define EMBED_ROW_BLOCKS 2048

template <typename T>
struct Add;

template <>
struct Add<float> {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

template <>
struct Add<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.0f);
  }
  // a bf16 add as PyTorch makes it: in f32, rounded to nearest even
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

// V elements of T moved as one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(EMBED_THREADS)
embed_grad_kernel(const T* __restrict__ grad,
                  const long long* __restrict__ perm,
                  const long long* __restrict__ starts, T* __restrict__ out,
                  long long rows, int d) {
  typedef Vec<T, V> W;
  for (long long v = blockIdx.x; v < rows; v += gridDim.x) {
    const long long lo = starts[v], hi = starts[v + 1];
    W* o = reinterpret_cast<W*>(out + v * d);
    for (int c = threadIdx.x; c * V < d; c += EMBED_THREADS) {
      W acc;
#pragma unroll
      for (int k = 0; k < V; ++k) acc.x[k] = Add<T>::zero();
      for (long long i = lo; i < hi; ++i) {
        const W g = reinterpret_cast<const W*>(grad + perm[i] * d)[c];
#pragma unroll
        for (int k = 0; k < V; ++k) acc.x[k] = Add<T>::add(acc.x[k], g.x[k]);
      }
      o[c] = acc;
    }
  }
}

template <typename T>
static int launch(const void* grad, const void* perm, const void* starts,
                  void* out, long long rows, int d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks =
      (unsigned)(rows < EMBED_ROW_BLOCKS ? rows : EMBED_ROW_BLOCKS);
  const bool wide = d % V == 0 && ((uintptr_t)grad % 16) == 0 &&
                    ((uintptr_t)out % 16) == 0;
  if (wide) {
    embed_grad_kernel<T, V><<<blocks, EMBED_THREADS, 0, s>>>(
        (const T*)grad, (const long long*)perm, (const long long*)starts,
        (T*)out, rows, d);
  } else {
    embed_grad_kernel<T, 1><<<blocks, EMBED_THREADS, 0, s>>>(
        (const T*)grad, (const long long*)perm, (const long long*)starts,
        (T*)out, rows, d);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16. Returns the launch's cudaError_t (0 = ok).
extern "C" int embed_grad_launch(const void* grad, const void* perm,
                                 const void* starts, void* out,
                                 long long rows, int d, int dtype,
                                 void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(grad, perm, starts, out, rows, d, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(grad, perm, starts, out, rows, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
