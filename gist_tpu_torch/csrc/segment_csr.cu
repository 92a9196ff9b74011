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
// What bounds it on an H100: bytes, and at a batch's few rows latency.
// Every edge reads one v row at a random index (F values), far above the
// 2 * E * F operations at any peak rate; the least time counts each input
// (indptr, idx, w, v) once and the output once, which the gathers exceed
// by the mean degree where rows miss the 50 MB L2.  A flagship batch
// (~1,300 rows of ~17 edges, at most 40) is bound by latency instead:
// each lane's chain of dependent loads (indptr, the indices, the
// gathers) sets its time, as much when every gather hits L1 as when it
// reads L2, so gathers are issued several edges at a time.
//
// Design.  A row's columns are cut into vectors of VB bytes (16, or 8
// where the rows lie on 8-byte boundaries only), and the vectors into
// block columns of near-equal size, at most G * C vectors each.  A
// group of G lanes owns one (row, head, block column) unit; lane gl
// holds the vectors k0 + c * G + gl, c < C, of its block column [k0,
// k1).  The units of one row's block columns are neighbours, so the
// groups of a warp mostly walk one edge list, and a row of F=256 fp32
// fills two warps (8 groups of 8 lanes).
// A group walks its row's edges P = max(G, D) a step: each lane loads
// the index and weight of P / G of them, and the next step's are loaded
// before this step's gathers.  The step's edges go D at a time: first
// every lane issues the loads of all D rows (nothing waits between
// them), then the D rows are added in edge order.  With 16-byte vectors
// on rows that start sh bytes past a 16-byte boundary (F * item not a
// multiple of 8, a view into a tensor), the lane loads the aligned words
// that cover its vector: its columns straddle its word and the next one,
// which its neighbour lane loaded (lane 0 of the group also loads the
// word after the block column's last); one shuffle of that word and a
// byte shift put the lane's columns in place.  A word is loaded only
// where it holds a byte of the row, so no load leaves the words the row
// touches.  On the H100 that realignment costs more than it saves where
// 8-byte loads are possible (chip_smoke.py phase s1_plans, H100 80GB
// HBM3 at 700 W: F=602 fp32 1.33 against 0.73 ms, a flagship batch at
// F=100 bf16 0.0134 against 0.0066 ms), so the host takes 8-byte
// vectors there and realigns only fp32 and bf16 rows on 4- or 2-byte
// boundaries.  Where a launch takes more than a wave of the card, its
// units go block column by block column, so that one column band of v
// at a time stays in L2.  The host picks (G, C, D, VB, order) by row
// width, alignment and row count
// (gist_tpu_torch/ops/segment_csr.py:launch_plan, chosen by timing
// every plan on the card).

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

constexpr int WORD = 16;   // bytes a load

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

__device__ __forceinline__ uint4 shfl_word(unsigned mask, uint4 x, int src,
                                           int width) {
  return make_uint4(__shfl_sync(mask, x.x, src, width),
                    __shfl_sync(mask, x.y, src, width),
                    __shfl_sync(mask, x.z, src, width),
                    __shfl_sync(mask, x.w, src, width));
}

// The 16 bytes at byte sh of the 32 bytes lo:hi (sh < 16, a multiple of
// sizeof(T)): a word shift by sh / 4, then for bf16 a half-word shift.
template <typename T>
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int sh) {
  const unsigned a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int k = sh >> 2;
  // t[i] = a[i + k], i < 5 (t[4] for the half-word shift)
  unsigned t[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) t[i] = (k & 2) ? a[i + 2] : a[i];
  if constexpr (sizeof(T) < 8) {
    const unsigned t5 = (k & 2) ? a[7] : a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      t[i] = (k & 1) ? (i < 4 ? t[i + 1] : t5) : t[i];
    if constexpr (sizeof(T) == 2) {
      if (sh & 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          t[i] = __funnelshift_r(t[i], t[i + 1], 16);
      }
    }
  }
  return make_uint4(t[0], t[1], t[2], t[3]);
}

// p[0..S) = v[0..S) in T; p aligned to S elements.
template <typename T, int S, typename A>
__device__ __forceinline__ void store_acc(T* p, const A* v) {
  using W = typename Word<sizeof(T) * S>::type;
  W w;
  T* t = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int k = 0; k < S; ++k) from_acc(t + k, v[k]);
  *reinterpret_cast<W*>(p) = w;
}

// The V values of a lane's vector stored in chunks of S <= V elements
// (out rows aligned to S, f a multiple of S), the chunks past f left
// out.
template <typename T, int S, int V, typename A>
__device__ __forceinline__ void store_cols(T* o, const A* acc, int col,
                                          int f) {
  static_assert(S <= V, "a store chunk lies inside the lane's vector");
#pragma unroll
  for (int m = 0; m < V; m += S)
    if (col + m < f) store_acc<T, S>(o + col + m, acc + m);
}

template <typename T, int G, int C, int D, int VB, bool R>
__global__ void __launch_bounds__(THREADS)
segment_csr_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ idx,
                   const typename AccOf<T>::type* __restrict__ w,
                   const T* __restrict__ v, T* __restrict__ out, int n_rows,
                   int heads, int f, int nbc, int sv, int by_col) {
  static_assert(!R || VB == WORD, "rows are realigned in 16-byte words");
  using A = typename AccOf<T>::type;
  using Wd = typename Word<VB>::type;        // a vector's load
  constexpr int V = VB / (int)sizeof(T);     // elements a vector
  constexpr int P = G > D ? G : D;           // edges a step
  constexpr int J = P / G;                   // of them indexed by a lane
  constexpr int CW = R ? C + 1 : C;          // words a lane loads an edge
  const int gl = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? FULL : ((1u << (G % 32)) - 1u) << (lane - lane % G);
  const int64_t unit =
      (int64_t)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int64_t segs = (int64_t)n_rows * heads;
  const bool has_unit = unit < segs * nbc;
  int64_t seg = 0;
  int begin = 0, end = 0, h = 0, k0 = 0, k1 = 0;
  if (has_unit) {
    // units row by row (a row's block columns side by side), or block
    // column by block column (each column band of v read by all rows
    // before the next: a band stays in L2 where all of v does not)
    seg = by_col ? unit % segs : unit / nbc;
    const int y = (int)(by_col ? unit / segs : unit - seg * nbc);
    const int row = (int)(seg / heads);
    h = (int)(seg - (int64_t)row * heads);
    begin = __ldg(indptr + row);
    end = __ldg(indptr + row + 1);
    const int n_vec = (f + V - 1) / V;
    k0 = (int)((int64_t)y * n_vec / nbc);
    k1 = (int)((int64_t)(y + 1) * n_vec / nbc);
  }
  const int row_bytes = f * (int)sizeof(T);
  const int64_t stride = (int64_t)heads * f * (int)sizeof(T);  // v rows
  const char* vh = reinterpret_cast<const char*>(v + (int64_t)h * f);
  const bool weighted = w != nullptr;

  A acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[c][j] = 0;

  // the indices and weights of the step at e0: lane gl holds edges
  // e0 + j * G + gl, j < J
  int s[J];
  A wt[J];
  auto fetch = [&](int e0, int* sj, A* wj) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = e0 + j * G + gl;
      const bool live = e < end;
      sj[j] = !live ? 0 : idx ? __ldg(idx + e) : e;
      wj[j] = live && weighted ? __ldg(w + (int64_t)e * heads + h) : A(1);
    }
  };
  const int steps = (int)__reduce_max_sync(FULL, (unsigned)((end - begin
                                                             + P - 1) / P));
  if (steps > 0) fetch(begin, s, wt);
  for (int st = 0; st < steps; ++st) {
    const int e0 = begin + st * P;
    const int left = end - e0;
    const int cnt = left <= 0 ? 0 : left < P ? left : P;
    const int most = (int)__reduce_max_sync(FULL, (unsigned)cnt);
    int s_next[J];
    A w_next[J];
    if (st + 1 < steps) fetch(e0 + P, s_next, w_next);
#pragma unroll
    for (int b = 0; b < P; b += D) {
      if (b >= most) break;   // warp-uniform
      Wd buf[D][CW];
      int sh[D];
      A wk[D];
      // the D rows' loads, all issued before the first add
#pragma unroll
      for (int d = 0; d < D; ++d) {
        // the step's edge b + d, held by lane (b + d) % G; with J > 1 the
        // step is one batch (b = 0)
        const int j = J == 1 ? 0 : d / G;
        const int sk = __shfl_sync(FULL, s[j], (b + d) % G, G);
        wk[d] = __shfl_sync(FULL, wt[j], (b + d) % G, G);
        const bool live = b + d < cnt;
        const char* p = vh + (int64_t)sk * stride;
        sh[d] = R ? (int)(reinterpret_cast<uintptr_t>(p) & (WORD - 1)) : 0;
        const Wd* q = reinterpret_cast<const Wd*>(p - sh[d]);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int k = k0 + c * G + gl;
          const bool want = live && (c < C || gl == 0) &&
                            (k < k1 || (k == k1 && sh[d] != 0)) &&
                            k * VB - sh[d] < row_bytes;
          buf[d][c] = want ? __ldg(q + k) : Wd{};
        }
      }
      // the D rows added in edge order
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const bool live = b + d < cnt;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          Wd x = buf[d][c];
          if constexpr (R) {
            if (sh[d] != 0) {   // uniform in the group
              // the next word: the neighbour lane's, or for the last lane
              // lane 0's of the next vector
              const uint4 send = gl == 0 ? buf[d][c + 1] : x;
              const uint4 nxt =
                  G == 1 ? send : shfl_word(gmask, send, (gl + 1) % G, G);
              x = shift_bytes<T>(x, nxt, sh[d]);
            }
          }
          if (!live) continue;
          const T* t = reinterpret_cast<const T*>(&x);
#pragma unroll
          for (int jj = 0; jj < V; ++jj) {
            const A xv = to_acc(t[jj]);
            acc[c][jj] += weighted ? mul_rn(wk[d], xv) : xv;
          }
        }
      }
    }
    if (st + 1 < steps) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[j] = s_next[j];
        wt[j] = w_next[j];
      }
    }
  }
  if (!has_unit) return;
  T* o = out + seg * f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = k0 + c * G + gl;
    if (k >= k1) continue;
    const int col = k * V;
    if constexpr (V >= 8) {
      if (sv == 8) { store_cols<T, 8, V>(o, acc[c], col, f); continue; }
    }
    if constexpr (V >= 4) {
      if (sv == 4) { store_cols<T, 4, V>(o, acc[c], col, f); continue; }
    }
    if constexpr (V >= 2) {
      if (sv == 2) { store_cols<T, 2, V>(o, acc[c], col, f); continue; }
    }
    store_cols<T, 1, V>(o, acc[c], col, f);
  }
}

struct Args {
  const void* indptr;
  const void* idx;
  const void* w;
  const void* v;
  void* out;
  int n_rows, heads, f, sv, by_col;
  cudaStream_t stream;
};

template <typename T, int G, int C, int D, int VB, bool R>
int launch(const Args& a) {
  constexpr int V = VB / (int)sizeof(T);
  const int n_vec = (a.f + V - 1) / V;
  const int nbc = (n_vec + G * C - 1) / (G * C);
  const int64_t units = (int64_t)a.n_rows * a.heads * nbc;
  const unsigned blocks =
      (unsigned)((units + THREADS / G - 1) / (THREADS / G));
  segment_csr_kernel<T, G, C, D, VB, R><<<blocks, THREADS, 0, a.stream>>>(
      static_cast<const int32_t*>(a.indptr),
      static_cast<const int32_t*>(a.idx),
      static_cast<const typename AccOf<T>::type*>(a.w),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.n_rows, a.heads,
      a.f, nbc, a.sv, a.by_col);
  return (int)cudaGetLastError();
}

// The instance of a plan's vectors: 16 bytes on aligned rows, 16 bytes
// realigned (fp32 and bf16: fp64 rows always allow 8-byte vectors), or 8
// bytes; cudaErrorInvalidValue for any other.
template <typename T, int G, int C, int D>
int launch_vec(const Args& a, int vec_bytes, int realign) {
  if (vec_bytes == 8 && !realign) return launch<T, G, C, D, 8, false>(a);
  if (vec_bytes == WORD && !realign)
    return launch<T, G, C, D, WORD, false>(a);
  if constexpr (sizeof(T) < 8) {
    if (vec_bytes == WORD) return launch<T, G, C, D, WORD, true>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// The plan's instance, or cudaErrorInvalidValue for a plan that has none
// (gist_tpu_torch/ops/segment_csr.py: PLANS).
template <typename T>
int run(const Args& a, int group, int per_lane, int depth, int vec_bytes,
        int realign) {
  if (a.n_rows <= 0 || a.heads <= 0 || a.f <= 0)
    return (int)cudaGetLastError();
  if (a.sv < 1 || a.sv * (int)sizeof(T) > WORD)
    return (int)cudaErrorInvalidValue;
#define S1_PLAN(G, C, D)                             \
  if (group == G && per_lane == C && depth == D)     \
    return launch_vec<T, G, C, D>(a, vec_bytes, realign);
  S1_PLAN(1, 1, 8) S1_PLAN(4, 1, 8) S1_PLAN(8, 1, 4) S1_PLAN(8, 1, 8)
  S1_PLAN(16, 1, 4) S1_PLAN(16, 1, 8) S1_PLAN(32, 1, 4) S1_PLAN(32, 1, 8)
  S1_PLAN(32, 2, 4) S1_PLAN(32, 4, 4)
#undef S1_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  indptr is (n_rows + 1,) int32;
// idx (null, or int32 v rows by edge) and w (null, or (E, heads) in the
// accumulator's dtype: fp64 for the fp64 entry, else fp32) are indexed by
// edge; v is (rows, heads, f) and out (n_rows, heads, f), both contiguous
// in the function's dtype (v at any element offset), out allocated by the
// caller and aligned to sv elements, f a multiple of sv (out's stores
// are sv elements wide).  The plan (group, per_lane, depth) comes from
// launch_plan in gist_tpu_torch/ops/segment_csr.py with its vectors'
// bytes (16 or 8: every row of v aligned to 8 bytes); realign is 0 only
// where every row of v starts on a vector boundary; by_col orders the
// (row, head, block column) units by block column.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan without an
// instance.
extern "C" int segment_csr_f32(const void* indptr, const void* idx,
                               const void* w, const void* v, void* out,
                               int n_rows, int heads, int f, int sv,
                               int group, int per_lane, int depth,
                               int vec_bytes, int realign, int by_col,
                               void* stream) {
  return run<float>({indptr, idx, w, v, out, n_rows, heads, f, sv, by_col,
                     (cudaStream_t)stream},
                    group, per_lane, depth, vec_bytes, realign);
}

extern "C" int segment_csr_bf16(const void* indptr, const void* idx,
                                const void* w, const void* v, void* out,
                                int n_rows, int heads, int f, int sv,
                                int group, int per_lane, int depth,
                                int vec_bytes, int realign, int by_col,
                                void* stream) {
  return run<__nv_bfloat16>({indptr, idx, w, v, out, n_rows, heads, f, sv,
                             by_col, (cudaStream_t)stream},
                            group, per_lane, depth, vec_bytes, realign);
}

extern "C" int segment_csr_f64(const void* indptr, const void* idx,
                               const void* w, const void* v, void* out,
                               int n_rows, int heads, int f, int sv,
                               int group, int per_lane, int depth,
                               int vec_bytes, int realign, int by_col,
                               void* stream) {
  return run<double>({indptr, idx, w, v, out, n_rows, heads, f, sv, by_col,
                      (cudaStream_t)stream},
                     group, per_lane, depth, vec_bytes, realign);
}
