// S1: the CSR row-walk segment sum for Hopper (sm_90a), fp32 accumulate
// (fp64 for fp64 inputs).
//
// Replaces no TPU kernel: it is the card's counterpart of XLA's
// segment_sum in the JAX package's segment path (gist_tpu/ops/spmm.py:84,
// gist_tpu/ops/segment.py:64 and :86), which the TPU runs as a fused XLA
// composite with no Pallas kernel behind it.  The plain PyTorch version,
// a gather and an index_add_, sums with atomics on the card, in an order
// that changes from run to run; this kernel sums every output row in edge
// order instead, so two launches give the same bits.  For output row i
// and head h:
//
//   out[i, h, :] = sum over e = indptr[i] .. indptr[i+1]-1, in that order,
//                  of w[e, h] * v[idx[e], h, :]
//
// with idx the identity where it is null (edge e reads row e of a
// per-edge array) and w 1 where it is null.  Each product is rounded
// before it is added (__fmul_rn), as the plain version's multiply and
// add are, and the sum is kept in fp32 registers (fp64 for fp64 inputs,
// which the float64 references of the training checks run); out is in
// v's dtype (fp32, bf16 or fp64).  Every output row is stored exactly
// once: a row without edges stores 0, and edges outside
// [indptr[0], indptr[n]) (the padding edges of a Graph) are never read.
//
// Design: the lanes of a warp are cut into groups of G lanes (4, 8, 16
// or 32), each group owning one (row, head) segment, each lane holding
// C vectors of V elements of it (C * V = 8 accumulators; columns
// (q * G + lane % G) * V + k for q < C, k < V, so a group covers G * 8
// columns of a block column, blockIdx.y).  A group takes its segment's
// edges G a step: each lane loads one edge's index and weight, then the
// group visits the G edges in order, shuffling each index and weight
// from the lane that loaded it and gathering that v row by index with
// V-element vector loads.  No per-edge message array is written to
// device memory.  The warp steps as long as its longest segment (the
// shuffles need every lane), as tiled_rows.cuh's walk does in rows mode.
// The host picks G from F, the smallest group that covers the row in one
// block column (gist_tpu_torch/ops/segment_csr.py:launch_plan), so a
// narrow row (the softmax denominators, F = heads) does not hold 32
// lanes for one column.
//
// What bounds it on an H100: bytes.  Every edge reads one v row at a
// random index (F values), far above the 2 * E * F operations at any
// peak rate; the least time counts each input (indptr, idx, w, v) once
// and the output once, which the gathers exceed by the mean degree where
// rows miss the 50 MB L2.

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

constexpr int COLS = 8;   // accumulators a lane holds: C * V

// The accumulator of a dtype: fp32 for fp32 and bf16, fp64 for fp64.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ void from_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void from_acc(double* p, double v) { *p = v; }
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// v[0..V) = p[0..V) in the accumulator's type; p aligned to V elements.
template <typename T, int V, typename A>
__device__ __forceinline__ void load_acc(const T* p, A* v) {
  using W = typename Word<sizeof(T) * V>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_acc(t[k]);
}

template <typename T, int V, typename A>
__device__ __forceinline__ void store_acc(T* p, const A* v) {
  using W = typename Word<sizeof(T) * V>::type;
  W w;
  T* t = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int k = 0; k < V; ++k) from_acc(t + k, v[k]);
  *reinterpret_cast<W*>(p) = w;
}

template <typename T, int V, int G>
__global__ void __launch_bounds__(THREADS)
segment_csr_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ idx,
                   const typename AccOf<T>::type* __restrict__ w,
                   const T* __restrict__ v, T* __restrict__ out, int n_rows,
                   int heads, int f) {
  using A = typename AccOf<T>::type;
  constexpr int C = COLS / V;
  const int gl = threadIdx.x % G;
  const int64_t seg = (int64_t)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const bool has_seg = seg < (int64_t)n_rows * heads;
  int64_t begin = 0, end = 0;
  int h = 0;
  if (has_seg) {
    const int row = (int)(seg / heads);
    h = (int)(seg - (int64_t)row * heads);
    begin = __ldg(indptr + row);
    end = __ldg(indptr + row + 1);
  }
  const GroupCols<V, G, C> cols(blockIdx.y * G * COLS, gl, f);
  const int64_t stride = (int64_t)heads * f;   // elements between v rows
  const T* vh = v + (int64_t)h * f + cols.base;
  A acc[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) acc[i] = 0;
  const int steps = (int)__reduce_max_sync(
      FULL, (unsigned)((end - begin + G - 1) / G));
  for (int st = 0; st < steps; ++st) {
    const int64_t e0 = begin + (int64_t)st * G;
    const int64_t left = end - e0;
    const int cnt = left <= 0 ? 0 : left < G ? (int)left : G;
    const bool live = gl < cnt;
    const int64_t e = e0 + gl;
    const int64_t s = !live ? 0 : idx ? (int64_t)__ldg(idx + e) : e;
    const A we = live && w ? __ldg(w + e * heads + h) : A(1);
#pragma unroll 4
    for (int k = 0; k < G; ++k) {
      const int64_t sk = __shfl_sync(FULL, s, k, G);
      const A wk = __shfl_sync(FULL, we, k, G);
      if (k >= cnt) continue;
      const T* p = vh + sk * stride;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (!cols.has[q]) continue;
        A x[V];
        load_acc<T, V>(p + q * G * V, x);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[q * V + j] += mul_rn(wk, x[j]);
      }
    }
  }
  if (!has_seg) return;
  T* o = out + seg * f + cols.base;
#pragma unroll
  for (int q = 0; q < C; ++q)
    if (cols.has[q]) store_acc<T, V>(o + q * G * V, acc + q * V);
}

struct Args {
  const void* indptr;
  const void* idx;
  const void* w;
  const void* v;
  void* out;
  int n_rows, heads, f;
  cudaStream_t stream;
};

template <typename T, int V, int G>
int launch(const Args& a) {
  const int64_t segs = (int64_t)a.n_rows * a.heads;
  const dim3 grid((unsigned)((segs + THREADS / G - 1) / (THREADS / G)),
                  (a.f + G * COLS - 1) / (G * COLS));
  segment_csr_kernel<T, V, G><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const int32_t*>(a.indptr),
      static_cast<const int32_t*>(a.idx),
      static_cast<const typename AccOf<T>::type*>(a.w),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.n_rows, a.heads,
      a.f);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int pick_g(int g, const Args& a) {
  if (g == 4) return launch<T, V, 4>(a);
  if (g == 8) return launch<T, V, 8>(a);
  if (g == 16) return launch<T, V, 16>(a);
  if (g == 32) return launch<T, V, 32>(a);
  return (int)cudaErrorInvalidValue;
}

// The plan's instance, or cudaErrorInvalidValue for a plan that has none
// (a vector wider than 16 bytes, a group other than 4, 8, 16 or 32).
template <typename T>
int run(const Args& a, int group, int vec) {
  if (a.n_rows <= 0 || a.heads <= 0 || a.f <= 0)
    return (int)cudaGetLastError();
  if (vec == 1) return pick_g<T, 1>(group, a);
  if (vec == 2) return pick_g<T, 2>(group, a);
  if constexpr (sizeof(T) <= 4) {
    if (vec == 4) return pick_g<T, 4>(group, a);
  }
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return pick_g<T, 8>(group, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  indptr is (n_rows + 1,) int32;
// idx (null, or int32 v rows by edge) and w (null, or (E, heads) in the
// accumulator's dtype: fp64 for the fp64 entry, else fp32) are indexed by
// edge; v is (rows, heads, f) and out (n_rows, heads, f), both in the
// function's dtype, out allocated by the caller.  The plan
// (group, vec) comes from launch_plan in
// gist_tpu_torch/ops/segment_csr.py; v, out and f are aligned to vec
// elements.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan without an instance.
extern "C" int segment_csr_f32(const void* indptr, const void* idx,
                               const void* w, const void* v, void* out,
                               int n_rows, int heads, int f, int group,
                               int vec, void* stream) {
  return run<float>({indptr, idx, w, v, out, n_rows, heads, f,
                     (cudaStream_t)stream},
                    group, vec);
}

extern "C" int segment_csr_bf16(const void* indptr, const void* idx,
                                const void* w, const void* v, void* out,
                                int n_rows, int heads, int f, int group,
                                int vec, void* stream) {
  return run<__nv_bfloat16>({indptr, idx, w, v, out, n_rows, heads, f,
                             (cudaStream_t)stream},
                            group, vec);
}

extern "C" int segment_csr_f64(const void* indptr, const void* idx,
                               const void* w, const void* v, void* out,
                               int n_rows, int heads, int f, int group,
                               int vec, void* stream) {
  return run<double>({indptr, idx, w, v, out, n_rows, heads, f,
                      (cudaStream_t)stream},
                     group, vec);
}
