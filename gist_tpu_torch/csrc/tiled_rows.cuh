// The row walk shared by the v1 gather-layout kernels for Hopper (sm_90a):
// K3 (tiled_spmm.cu) and K7-K9 (gat_tiled.cu).
//
// Layout (TiledCSR): destination tile i owns the slots tile_offsets[i] ..
// tile_offsets[i+1]-1, which hold its receiver-sorted edges (sender,
// receiver) followed by padding slots whose receiver is the sentinel
// num_tiles * tile_rows, above every row.  So within a tile the receivers
// ascend and each destination row's slots are one contiguous range, found
// here by two binary searches over the tile's receivers.  Slots past
// tile_offsets[-1] are never read.
//
// One warp owns one destination row (WARPS rows per block).  The lanes
// run over the feature columns, a block column covering FC of them with
// ACC fp32 accumulators per lane; feature rows are gathered by index
// inside the kernel with V-element vector loads, so no per-slot message
// array exists in device memory.  A row's slots are visited in order and
// summed in registers, and each output row is stored once: no atomics,
// and the result does not depend on the schedule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiled_rows {

constexpr int WARPS = 8;              // destination rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int ACC = 8;                // fp32 accumulators per lane
constexpr int FC = 32 * ACC;          // feature columns per block column
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
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

// acc[q*V + k] += w_e * rows[s_e, f0 + (q*32 + lane)*V + k] over the
// row's slots e in order, with s_e = senders[e] and w_e = weight(s_e).
// Slots go in groups of 32: lane k loads slot k's sender and weight, then
// the warp walks the group with both broadcast.  Returns the sum of the
// weights this lane evaluated.
template <typename T, int V, typename Weight>
__device__ __forceinline__ float gather_rows(
    const int32_t* __restrict__ senders, const T* __restrict__ rows,
    int ncols, int f0, Slots sl, int lane, const Weight& weight,
    float* acc) {
  float wsum = 0.f;
  for (int64_t e0 = sl.begin; e0 < sl.end; e0 += 32) {
    const int cnt = sl.end - e0 < 32 ? (int)(sl.end - e0) : 32;
    int s = 0;
    float w = 0.f;
    if (lane < cnt) {
      s = __ldg(senders + e0 + lane);
      w = weight(s);
      wsum += w;
    }
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const int64_t sk = __shfl_sync(FULL, s, k);
      const float wk = __shfl_sync(FULL, w, k);
      const T* src = rows + sk * ncols + f0;
#pragma unroll
      for (int q = 0; q < ACC / V; ++q) {
        const int col = (q * 32 + lane) * V;
        if (f0 + col < ncols) {
          float v[V];
          load_vec<T, V>(src + col, v);
#pragma unroll
          for (int kk = 0; kk < V; ++kk)
            acc[q * V + kk] = fmaf(wk, v[kk], acc[q * V + kk]);
        }
      }
    }
  }
  return wsum;
}

// out_row[f0 + ...] = acc / div, or 0 where div is 0.
template <typename T, int V>
__device__ __forceinline__ void store_row(T* __restrict__ out_row, int ncols,
                                          int f0, int lane, const float* acc,
                                          float div) {
#pragma unroll
  for (int q = 0; q < ACC / V; ++q) {
    const int col = (q * 32 + lane) * V;
    if (f0 + col < ncols) {
      float v[V];
#pragma unroll
      for (int kk = 0; kk < V; ++kk)
        v[kk] = div > 0.f ? acc[q * V + kk] / div : 0.f;
      store_vec<T, V>(out_row + f0 + col, v);
    }
  }
}

// The widest V in {4, 2, 1} that divides ncols and to which each pointer
// is aligned (items: that pointer's element size).
inline int vec_width(int ncols, const void* a, int a_item, const void* b,
                     int b_item) {
  for (int v = 4; v > 1; v /= 2)
    if (ncols % v == 0 && (uintptr_t)a % (v * a_item) == 0 &&
        (uintptr_t)b % (v * b_item) == 0)
      return v;
  return 1;
}

}  // namespace tiled_rows
