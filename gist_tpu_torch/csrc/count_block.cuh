// The sparse walk of int8 count blocks shared by K1 (dedup_spmm.cu) and
// K2 (split_spmm.cu), for Hopper (sm_90a), fp32 FMA.
//
// tile_spmm computes, for destination rows of tile t and the FT feature
// columns of slice s:
//
//   out[t*TN + r, f] = sum_{j = job_offsets[t]}^{job_offsets[t+1]-1}
//                      sum_{k < CU} W[j, r, k] * x[row_j(k), f]
//
// with int8 counts W (jobs, TN, CU), an fp32 accumulator and the output
// in x's dtype.  The kernels differ only in where a job's rows come from:
// ``rows.job(j)`` returns a JobRows (slot k reads x[u[k]], or x[base + k]
// for a direct slab, where rows at or past n_rows read zero).
//
// One warp owns one destination row; a block of WARPS warps covers WARPS
// rows of one tile, and block blockIdx.x = (tile * TN / WARPS + row
// block) * slices + slice, so the blocks of a tile, and the slices of
// its rows, are neighbours in launch order.  For each job of its tile
// (the padding jobs of a layout are never read; a tile without jobs
// writes zeros) the warp
//   1. reads its row's CU counts, 32 bytes a lane in one coalesced
//      sweep, the next job's counts already in flight;
//   2. turns them into the row's list of nonzero slots in slot order
//      (list_nonzero, also the first step of K4-K6 in gat_dedup.cu):
//      each lane makes a bit mask of its nonzero bytes (a byte compare
//      and a multiply that gathers the bits), a warp prefix sum of their
//      popcounts places each lane's (slot, count) entries in a per-warp
//      list in shared memory;
//   3. walks the list 32 entries at a time: each lane reads one entry's
//      source row id (u[slot], or base + slot), then every entry's row is
//      read by all lanes across the feature columns, four rows in
//      flight, and acc[c] += count * x[row, c] in fp32 FMA (not TF32:
//      the fp32 path holds 1e-5 relative to the plain versions).
// So the FMAs are 2 * nnz * F, not 2 * J * TN * CU * F; W is read once
// (once per slice of FT columns, the later slices from L2); each output
// element is summed by one lane in (job, slot) order, without atomics
// and without block barriers, so two launches on the same input give the
// same bits.  Job offsets into W are size_t: one chunked W can exceed
// 2^31 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace count_block {

constexpr int WARPS = 8;         // warps (destination rows) of a block
constexpr int THREADS = WARPS * 32;
constexpr int FT = 256;          // feature columns per block
constexpr int EPL = FT / 32;     // columns per lane

// Where the CU slots of one job read their rows.
struct JobRows {
  const int32_t* u;   // row id of every slot, or nullptr for a direct slab
  int64_t base;       // first row of a direct slab
  int64_t n_rows;     // direct rows at or past n_rows read zero
};

// Launch shape for F columns of x (dtype T) at address x: the slices of
// FT columns and the elements of one row load (4, 2 or 1, as the address
// and the row width allow).
struct Plan {
  int slices;
  int vec;
};

template <typename T>
inline Plan plan(int f, const void* x) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(x) | ((uintptr_t)f * sizeof(T));
  return {(f + FT - 1) / FT,
          a % (4 * sizeof(T)) == 0 ? 4 : a % (2 * sizeof(T)) == 0 ? 2 : 1};
}

// bit b of the result: byte b of v is nonzero (the byte compare leaves
// bits 7, 15, 23, 31; the multiply moves them, carry-free, to 28..31)
__device__ __forceinline__ uint32_t nonzero4(uint32_t v) {
  return ((__vcmpne4(v, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

// V consecutive elements of x as floats
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else if constexpr (V == 2) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const unsigned short q = __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&q));
  }
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// This lane's 16 * WPL counts of row r in job j of (TN x CU) blocks: the
// lanes of a warp read the row's CU bytes in one coalesced sweep.
template <int TN, int CU, int WPL>
__device__ __forceinline__ void load_counts(const int8_t* __restrict__ w_blocks,
                                            int j, int r, int lane,
                                            uint4 (&w)[WPL]) {
  const uint4* src =
      reinterpret_cast<const uint4*>(w_blocks + ((size_t)j * TN + r) * CU);
#pragma unroll
  for (int i = 0; i < WPL; ++i) w[i] = __ldg(src + lane * WPL + i);
}

// Step 2: writes the row's (slot | count << 16) entries with a nonzero
// count, in slot order, to list and returns their number (the same on
// every lane).  w holds this lane's counts of slots lane * 16 * WPL ..;
// bit b of keep keeps slot lane * 16 * WPL + b.  Ends with __syncwarp(),
// so the list is ready for every lane.
template <int WPL>
__device__ __forceinline__ int list_nonzero(const uint4 (&w)[WPL],
                                            uint32_t keep, int lane,
                                            uint32_t* list) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int SPL = 16 * WPL;            // slots per lane
  // bit b: this lane's slot lane * SPL + b has a nonzero count
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < WPL; ++i)
    m |= (nonzero4(w[i].x) | nonzero4(w[i].y) << 4 |
          nonzero4(w[i].z) << 8 | nonzero4(w[i].w) << 12)
         << (16 * i);
  m &= keep;
  const int n = __popc(m);
  int end = n;                             // inclusive prefix sum
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(ALL, end, d);
    if (lane >= d) end += y;
  }
  const int total = __shfl_sync(ALL, end, 31);
  int pos = end - n;
#pragma unroll
  for (int i = 0; i < 4 * WPL; ++i) {
    const uint32_t word = i % 4 == 0   ? w[i / 4].x
                          : i % 4 == 1 ? w[i / 4].y
                          : i % 4 == 2 ? w[i / 4].z
                                       : w[i / 4].w;
    uint32_t mi = (m >> (4 * i)) & 0xfu;
    while (mi != 0) {
      const int b = __ffs(mi) - 1;
      mi &= mi - 1;
      list[pos++] = (uint32_t)(lane * SPL + 4 * i + b) |
                    ((word >> (8 * b)) & 0xffu) << 16;
    }
  }
  __syncwarp();
  return total;
}

template <typename T, int TN, int CU, int V, typename Rows>
__device__ __forceinline__ void tile_spmm(const int32_t* __restrict__ job_offsets,
                                          const int8_t* __restrict__ w_blocks,
                                          const Rows& rows,
                                          const T* __restrict__ x,
                                          T* __restrict__ out, int f,
                                          int slices) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int BPT = TN / WARPS;          // blocks per tile
  constexpr int SPL = CU / 32;             // slots per lane
  constexpr int WPL = SPL / 16;            // 16-byte count loads per lane
  constexpr int LOADS = EPL / V;           // row loads per entry and lane
  static_assert(TN % WARPS == 0 && (SPL == 16 || SPL == 32), "layout");

  __shared__ uint32_t lists[WARPS][CU];    // (slot | count << 16) entries

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int f0 = (blockIdx.x % slices) * FT;
  const int block = blockIdx.x / slices;
  const int tile = block / BPT;
  const int r = (block % BPT) * WARPS + warp;  // the warp's row in the tile
  const int wf = min(FT, f - f0);              // this slice's columns
  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];
  const T* xs = x + f0 + lane * V;
  uint32_t* list = lists[warp];
  bool has[LOADS];
#pragma unroll
  for (int h = 0; h < LOADS; ++h) has[h] = h * 32 * V + lane * V < wf;

  float acc[EPL];
#pragma unroll
  for (int c = 0; c < EPL; ++c) acc[c] = 0.f;

  uint4 next[WPL];
  if (j_begin < j_end) load_counts<TN, CU>(w_blocks, j_begin, r, lane, next);
  for (int j = j_begin; j < j_end; ++j) {
    uint4 w[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) w[i] = next[i];
    if (j + 1 < j_end) load_counts<TN, CU>(w_blocks, j + 1, r, lane, next);
    const JobRows job = rows.job(j);

    uint32_t keep = ~0u;
    if (job.u == nullptr) {  // direct rows at or past n_rows read zero
      const int64_t room = job.n_rows - (job.base + lane * SPL);
      if (room < SPL) keep = room <= 0 ? 0u : (1u << room) - 1u;
    }
    const int total = list_nonzero(w, keep, lane, list);

    for (int e0 = 0; e0 < total; e0 += 32) {
      int src = 0;
      float cnt = 0.f;
      if (e0 + lane < total) {
        const uint32_t entry = list[e0 + lane];
        const int slot = entry & 0xffff;
        cnt = (float)(entry >> 16);
        src = job.u != nullptr ? __ldg(job.u + slot) : (int)(job.base + slot);
      }
      const int batch = min(32, total - e0);
#pragma unroll 4
      for (int e = 0; e < batch; ++e) {
        const T* p = xs + (int64_t)__shfl_sync(ALL, src, e) * f;
        const float c = __shfl_sync(ALL, cnt, e);
#pragma unroll
        for (int h = 0; h < LOADS; ++h) {
          if (!has[h]) continue;
          float v[V];
          load<V>(p + h * 32 * V, v);
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[h * V + k] = fmaf(c, v[k], acc[h * V + k]);
        }
      }
    }
    __syncwarp();
  }

  T* o = out + ((size_t)tile * TN + r) * f + f0 + lane * V;
#pragma unroll
  for (int h = 0; h < LOADS; ++h)
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (h * 32 * V + lane * V + k < wf) store_val(o + h * 32 * V + k,
                                                    acc[h * V + k]);
}

}  // namespace count_block
