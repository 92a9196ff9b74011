// K3: the v1 gather-layout SpMM for Hopper (sm_90a), fp32 accumulate.
//
// Replaces the TPU kernel gist_tpu/ops/pallas_spmm.py:_reduce_kernel
// (launched by _spmm_tiled, run by _run_tiled on `tiled` forward and on
// `tiled_t` backward).  For destination row r:
//
//   out[r, f] = sum over the slots e of r's tile with receivers[e] == r
//               of x[senders[e], f]
//
// in x's dtype (fp32 or bf16), rows num_tiles * tile_rows; a row without
// edges is 0.  The TPU kernel first gathered one message row per slot
// into device memory (E_t x F) and scattered each 1024-slot chunk with a
// one-hot (TN x C) matrix product, 2 * E_t * F * TN operations where
// 2 * E * F are useful; here each row's slots are found by two binary
// searches over the tile's ascending receivers (tiled_rows.cuh), their x
// rows are gathered by index inside the kernel and summed in fp32
// registers, so the work is the useful one.  Its hi/lo bf16 split of fp32
// messages and its f-tile choice have no counterpart.
//
// Design: the lanes of a warp are cut into groups of G lanes (8 or 16).  A lane holds C vectors of V elements of a row, columns
// (q * G + lane % G) * V + k for q < C, k < V, so a group covers
// G * C * V columns of a block column (blockIdx.y).  The launch plan
// (mode, G, C, V) is chosen on the host from F and the alignment
// (gist_tpu_torch/ops/tiled_spmm.py:launch_plan), and each plan is its
// own template instance: a row of F = 41 fills 41 of 48 lane slots with
// G = 16, C = 3 where one warp of 32 lanes over 256 columns filled 41 of
// 64 and stepped through six more column steps that only tested their
// predicate.  Two modes:
//   * edges: one warp per destination row, its 32 / G groups take
//     successive slots of the row, so a warp step gathers 32 / G rows;
//     at the end the groups' sums are added by a fixed tree of xor
//     shuffles and group 0 stores.  The plan takes it where one block
//     column covers the row (F = 41: 2 rows a step).
//   * rows: each group owns one destination row (32 / G rows a warp) and
//     sums its slots in order, as the plain walk does; the warp runs as
//     long as its longest row.  The plan takes it where a row needs
//     several block columns (F = 256 fp32: two of 128 columns, two rows
//     a warp), which beat one warp over all 256 columns on an H100.
// Either way each output element is summed in a fixed order, without
// atomics, so two launches give the same bits; padding slots (receiver
// num_tiles * tile_rows, above every row) lie outside every row's range
// and are never read, and an empty row or tile stores 0.
//
// What bounds it on an H100: bytes.  Every slot reads one x row (F values
// at random rows), so the traffic is ~E * F * itemsize, far above the
// 2 * E * F additions at any peak rate; the least time counts each input
// (x, the slot arrays) once, which the gathers exceed by the mean degree
// where rows miss the 50 MB L2.  On the synth-reddit-small graph x stays
// in L2 (3.8 MB at F = 41, 23.6 MB at F = 256), so the pace is set by L2
// sectors and by the instructions each gathered row costs.

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

constexpr int MAX_ACC = 8;   // fp32 accumulators a lane holds: C * V

template <typename T, int V, int G, int C, bool ROWS>
__global__ void __launch_bounds__(THREADS)
tiled_spmm_kernel(const int32_t* __restrict__ tile_offsets,
                  const int32_t* __restrict__ senders,
                  const int32_t* __restrict__ receivers,
                  const T* __restrict__ x, T* __restrict__ out, int n_rows,
                  int tile_rows, int f) {
  constexpr int NG = 32 / G;          // groups of a warp
  constexpr int SPAN = G * C * V;     // columns of a block column
  const int lane = threadIdx.x % 32;
  const int gl = lane % G;
  const int grp = lane / G;
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int f0 = blockIdx.y * SPAN;
  const T* xs = x + f0 + gl * V;
  bool has[C];
#pragma unroll
  for (int q = 0; q < C; ++q) has[q] = f0 + (q * G + gl) * V < f;
  float acc[C * V];
#pragma unroll
  for (int i = 0; i < C * V; ++i) acc[i] = 0.f;

  // acc += the x row s (this lane's columns)
  auto add_row = [&](int64_t s) {
    const T* p = xs + s * f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (!has[q]) continue;
      float v[V];
      load_vec<T, V>(p + q * G * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q * V + k] += v[k];
    }
  };
  auto store = [&](int row) {
    T* o = out + (int64_t)row * f + f0 + gl * V;
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (has[q]) store_vec<T, V>(o + q * G * V, acc + q * V);
  };

  if constexpr (ROWS) {
    const int row = warp * NG + grp;
    const Slots sl = row < n_rows
                         ? row_slots(tile_offsets, receivers, row, tile_rows)
                         : Slots{0, 0};
    // the warp steps as long as its longest row, G slots a step
    const int steps = (int)__reduce_max_sync(
        FULL, (unsigned)((sl.end - sl.begin + G - 1) / G));
    for (int st = 0; st < steps; ++st) {
      const int64_t e0 = sl.begin + (int64_t)st * G;
      const int64_t left = sl.end - e0;
      const int cnt = left <= 0 ? 0 : left < G ? (int)left : G;
      const int s = gl < cnt ? __ldg(senders + e0 + gl) : 0;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int sk = __shfl_sync(FULL, s, k, G);
        if (k < cnt) add_row(sk);
      }
    }
    if (row < n_rows) store(row);
  } else {
    const int row = warp;
    if (row >= n_rows) return;  // the whole warp
    const Slots sl = row_slots(tile_offsets, receivers, row, tile_rows);
    for (int64_t e0 = sl.begin; e0 < sl.end; e0 += 32) {
      const int cnt = sl.end - e0 < 32 ? (int)(sl.end - e0) : 32;
      const int s = lane < cnt ? __ldg(senders + e0 + lane) : 0;
      if (cnt == 32) {
#pragma unroll 4
        for (int i = 0; i < G; ++i)
          add_row(__shfl_sync(FULL, s, i * NG + grp));
      } else {
        for (int i = 0; i * NG < cnt; ++i) {
          const int k = i * NG + grp;
          const int sk = __shfl_sync(FULL, s, k);
          if (k < cnt) add_row(sk);
        }
      }
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < C * V; ++i)
        acc[i] += __shfl_xor_sync(FULL, acc[i], o);
    if (grp == 0) store(row);
  }
}

struct Args {
  const void* tile_offsets;
  const void* senders;
  const void* receivers;
  const void* x;
  void* out;
  int n_rows, tile_rows, f;
  cudaStream_t stream;
};

template <typename T, bool ROWS, int V, int G, int C>
int launch(const Args& a) {
  constexpr int rows_per_block = ROWS ? WARPS * (32 / G) : WARPS;
  const dim3 grid((a.n_rows + rows_per_block - 1) / rows_per_block,
                  (a.f + G * C * V - 1) / (G * C * V));
  tiled_spmm_kernel<T, V, G, C, ROWS><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const int32_t*>(a.tile_offsets),
      static_cast<const int32_t*>(a.senders),
      static_cast<const int32_t*>(a.receivers), static_cast<const T*>(a.x),
      static_cast<T*>(a.out), a.n_rows, a.tile_rows, a.f);
  return (int)cudaGetLastError();
}

// The plan's template instance, or cudaErrorInvalidValue for a plan that
// has none (C * V above MAX_ACC, G other than 8 or 16).
template <typename T, bool ROWS, int V, int G, int C = 1>
int pick_c(int c, const Args& a) {
  if constexpr (C * V > MAX_ACC) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (c == C) return launch<T, ROWS, V, G, C>(a);
    return pick_c<T, ROWS, V, G, C + 1>(c, a);
  }
}

template <typename T, bool ROWS, int V>
int pick_g(int g, int c, const Args& a) {
  if (g == 8) return pick_c<T, ROWS, V, 8>(c, a);
  if (g == 16) return pick_c<T, ROWS, V, 16>(c, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool ROWS>
int pick_v(int v, int g, int c, const Args& a) {
  if (v == 4) return pick_g<T, ROWS, 4>(g, c, a);
  if (v == 2) return pick_g<T, ROWS, 2>(g, c, a);
  if (v == 1) return pick_g<T, ROWS, 1>(g, c, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const Args& a, int rows_mode, int group, int per_lane, int vec) {
  if (a.n_rows <= 0 || a.f <= 0) return (int)cudaGetLastError();
  return rows_mode ? pick_v<T, true>(vec, group, per_lane, a)
                   : pick_v<T, false>(vec, group, per_lane, a);
}

}  // namespace

// Plain C interface (loaded with ctypes).  out is (n_rows, f) in x's
// dtype, n_rows = num_tiles * tile_rows, allocated by the caller; the
// plan (rows_mode, group, per_lane, vec) comes from launch_plan in
// gist_tpu_torch/ops/tiled_spmm.py, and x, out and f are aligned to vec
// elements.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan without an instance.
extern "C" int tiled_spmm_f32(const void* tile_offsets, const void* senders,
                              const void* receivers, const void* x, void* out,
                              int n_rows, int tile_rows, int f, int rows_mode,
                              int group, int per_lane, int vec,
                              void* stream) {
  return run<float>({tile_offsets, senders, receivers, x, out, n_rows,
                     tile_rows, f, (cudaStream_t)stream},
                    rows_mode, group, per_lane, vec);
}

extern "C" int tiled_spmm_bf16(const void* tile_offsets, const void* senders,
                               const void* receivers, const void* x,
                               void* out, int n_rows, int tile_rows, int f,
                               int rows_mode, int group, int per_lane,
                               int vec, void* stream) {
  return run<__nv_bfloat16>({tile_offsets, senders, receivers, x, out,
                             n_rows, tile_rows, f, (cudaStream_t)stream},
                            rows_mode, group, per_lane, vec);
}
