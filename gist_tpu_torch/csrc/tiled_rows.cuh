// The row search and walk shared by the v1 gather-layout kernels for
// Hopper (sm_90a): K3 (tiled_spmm.cu) and K7-K9 (gat_tiled.cu).
//
// Layout (TiledCSR): destination tile i owns the slots tile_offsets[i] ..
// tile_offsets[i+1]-1, which hold its receiver-sorted edges (sender,
// receiver) followed by padding slots whose receiver is the sentinel
// num_tiles * tile_rows, above every row.  So within a tile the receivers
// ascend and each destination row's slots are one contiguous range, found
// here by two binary searches over the tile's receivers.  Slots past
// tile_offsets[-1] are never read.
//
// One walk, walk_groups, for all four kernels: it cuts the lanes of a
// warp into groups of G lanes, each lane holding C vectors of V elements
// of a row (GroupCols), and either gives each group a row of its own
// (rows mode) or puts the groups of one warp on successive slots of one
// row (edges mode); the launch plan (mode, G, C, V) is chosen on the
// host.  Feature rows are gathered by index inside the kernel with
// V-element vector loads, so no per-slot message array exists in device
// memory.  A row's slots are visited in a fixed order and summed in
// registers, and each output row is stored once: no atomics, and the
// result does not depend on the schedule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiled_rows {

constexpr int WARPS = 8;              // destination rows per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// v[0..V) = p[0..V) as floats; p is aligned to V elements.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  using W = typename Word<sizeof(T) * V>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_f(t[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  using W = typename Word<sizeof(T) * V>::type;
  W w;
  T* t = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int k = 0; k < V; ++k) from_f(t + k, v[k]);
  *reinterpret_cast<W*>(p) = w;
}

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

struct Slots {
  int64_t begin, end;
};

// First slot in [lo, hi) whose receiver is >= key.
__device__ __forceinline__ int64_t lower_bound(
    const int32_t* __restrict__ receivers, int64_t lo, int64_t hi, int key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(receivers + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The slots of destination row `row`: every lane gets the same range.
__device__ __forceinline__ Slots row_slots(
    const int32_t* __restrict__ tile_offsets,
    const int32_t* __restrict__ receivers, int row, int tile_rows) {
  const int tile = row / tile_rows;
  const int64_t lo = __ldg(tile_offsets + tile);
  const int64_t hi = __ldg(tile_offsets + tile + 1);
  const int64_t b = lower_bound(receivers, lo, hi, row);
  return {b, lower_bound(receivers, b, hi, row + 1)};
}

// v summed (or maxed) over the W lanes of its aligned segment of the warp
// (W a power of two), by a fixed xor tree: every lane of the segment gets
// the same bits.
template <int W>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, W);
  return v;
}

template <int W>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o, W));
  return v;
}

// A lane's columns of one block column of G * C * V: with gl = lane % G,
// vector q < C holds the columns base + q * G * V + 0 .. V-1, base =
// f0 + gl * V; has[q] says whether it lies inside the row's ncols.  The
// methods take p, a row's pointer already advanced by base, so a walk
// forms it once a slot from a pointer hoisted out of the loop.
template <int V, int G, int C>
struct GroupCols {
  int base;
  bool has[C];
  __device__ __forceinline__ GroupCols(int f0, int gl, int ncols)
      : base(f0 + gl * V) {
#pragma unroll
    for (int q = 0; q < C; ++q) has[q] = base + q * G * V < ncols;
  }
  // acc += the lane's columns
  template <typename T>
  __device__ __forceinline__ void add(const T* p, float* acc) const {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (!has[q]) continue;
      float v[V];
      load_vec<T, V>(p + q * G * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[q * V + k] += v[k];
    }
  }
  // acc += w * the lane's columns
  template <typename T>
  __device__ __forceinline__ void fma(const T* p, float w,
                                      float* acc) const {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (!has[q]) continue;
      float v[V];
      load_vec<T, V>(p + q * G * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[q * V + k] = fmaf(w, v[k], acc[q * V + k]);
    }
  }
  // the lane's share of the row's dot with g, g its columns of another
  template <typename T>
  __device__ __forceinline__ float dot(const T* p, const float* g) const {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (!has[q]) continue;
      float v[V];
      load_vec<T, V>(p + q * G * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) s = fmaf(v[k], g[q * V + k], s);
    }
    return s;
  }
  // v = the lane's columns (0 outside the row)
  template <typename T>
  __device__ __forceinline__ void load(const T* p, float* v) const {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (has[q]) {
        load_vec<T, V>(p + q * G * V, v + q * V);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[q * V + k] = 0.f;
      }
    }
  }
  template <typename T>
  __device__ __forceinline__ void store(T* p, const float* v) const {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (has[q]) store_vec<T, V>(p + q * G * V, v + q * V);
  }
};

// The walk of one warp over the slots of its rows, its lanes in groups of
// G (lane gl = lane % G of group grp = lane / G, NG = 32 / G groups).
//   ROWS: group grp owns the row whose slots are sl (each group its own;
//     a group without a row passes an empty range).  It takes them G a
//     step, lane gl holding slot e0 + gl; the warp steps as long as its
//     longest row.  The lanes that share a batch: the group (width G).
//   edges: the warp owns the row sl and takes its slots 32 a batch, lane
//     holding slot e0 + lane; group grp visits slots i * NG + grp of the
//     batch, i < G.  The lanes that share a batch: the warp (width 32).
// For each batch every lane calls
//   batch(live, e, s): live says whether the lane holds a slot, e its
//     index and s its sender (0 where not live); it may shuffle across
//     the lanes that share the batch;
// then, for each slot of the batch that its group visits, every lane calls
//   use(sk, k, valid): sk is the sender of the slot held by lane k of the
//     batch's width (k < G in rows mode, k < 32 in edges mode), valid
//     whether that slot exists; it may shuffle across the warp;
// and after the batch, every lane calls done(live, e, s).
// A row's slots are visited in order, the same order on every launch.
template <int G, bool ROWS, typename Batch, typename Use, typename Done>
__device__ __forceinline__ void walk_groups(
    const int32_t* __restrict__ senders, Slots sl, int lane,
    const Batch& batch, const Use& use, const Done& done) {
  constexpr int NG = 32 / G;
  if constexpr (ROWS) {
    const int gl = lane % G;
    const int steps = (int)__reduce_max_sync(
        FULL, (unsigned)((sl.end - sl.begin + G - 1) / G));
    for (int st = 0; st < steps; ++st) {
      const int64_t e0 = sl.begin + (int64_t)st * G;
      const int64_t left = sl.end - e0;
      const int cnt = left <= 0 ? 0 : left < G ? (int)left : G;
      const bool live = gl < cnt;
      const int s = live ? __ldg(senders + e0 + gl) : 0;
      batch(live, e0 + gl, s);
#pragma unroll
      for (int k = 0; k < G; ++k) use(__shfl_sync(FULL, s, k, G), k, k < cnt);
      done(live, e0 + gl, s);
    }
  } else {
    const int grp = lane / G;
    for (int64_t e0 = sl.begin; e0 < sl.end; e0 += 32) {
      const int cnt = sl.end - e0 < 32 ? (int)(sl.end - e0) : 32;
      const bool live = lane < cnt;
      const int s = live ? __ldg(senders + e0 + lane) : 0;
      batch(live, e0 + lane, s);
      if (cnt == 32) {
#pragma unroll 4
        for (int i = 0; i < G; ++i) {
          const int k = i * NG + grp;
          use(__shfl_sync(FULL, s, k), k, true);
        }
      } else {
        for (int i = 0; i * NG < cnt; ++i) {
          const int k = i * NG + grp;
          use(__shfl_sync(FULL, s, k), k, k < cnt);
        }
      }
      done(live, e0 + lane, s);
    }
  }
}

// Edges mode's end: acc summed over the warp's groups by a fixed tree of
// xor shuffles, so every group holds the row's sums.
template <int G, int N>
__device__ __forceinline__ void sum_groups(float* acc) {
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
}

struct Nothing {
  template <typename... A>
  __device__ __forceinline__ void operator()(A...) const {}
};

}  // namespace tiled_rows
