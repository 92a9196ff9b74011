// The block-dense tile loop shared by K1 (dedup_spmm.cu) and K2
// (split_spmm.cu), for Hopper (sm_90a), fp32 FMA.
//
// tile_spmm computes, for destination tile blockIdx.x and the 64 feature
// columns from blockIdx.y * 64:
//
//   out[tile*TN + r, f] = sum_{j = job_offsets[tile]}^{job_offsets[tile+1]-1}
//                         sum_{k < CU} W[j, r, k] * x[row_j(k), f]
//
// with int8 counts W (jobs, TN, CU), an fp32 accumulator and the output
// in x's dtype.  The kernels differ only in where a job's rows come from:
// ``rows.job(j)`` returns a callable whose value at slot k is the x row
// of that slot, or -1 for a slot that reads zero.
//
// The block walks its tile's jobs (bounded by job_offsets, so padding
// jobs are never read and a tile without jobs writes zeros).  Per step
// its 256 threads stage a (TN x KC) slice of W, converted to float, and
// the KC matching x rows in shared memory (rows fetched by index inside
// the kernel, neighbouring threads on neighbouring columns); each thread
// then keeps a (TN/16) x 4 block of accumulators in registers and runs
// fp32 FMAs (not TF32: the fp32 path must match the plain versions to
// ~1e-5 relative).  Job offsets into W are size_t: one chunked W can
// exceed 2^31 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense_block {

constexpr int THREADS = 256;
constexpr int FT = 64;        // feature columns per block
constexpr int CPT = 4;        // accumulator columns per thread (16 groups)

static_assert(FT == 16 * CPT, "thread layout");

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int TN, int CU, typename Rows>
__device__ __forceinline__ void tile_spmm(const int32_t* __restrict__ job_offsets,
                                          const int8_t* __restrict__ w_blocks,
                                          const Rows& rows,
                                          const T* __restrict__ x,
                                          T* __restrict__ out, int f) {
  constexpr int RPT = TN / 16;            // accumulator rows per thread
  constexpr int KC = THREADS * 16 / TN;   // slots per step: one int4 of W
  constexpr int VPR = KC / 16;            // int4 loads per W row and step
  static_assert(RPT % 4 == 0, "rows read as float4");
  static_assert(CU % KC == 0 && (KC * FT) % THREADS == 0, "steps");

  __shared__ __align__(16) float ws[KC][TN];   // W slice, transposed
  __shared__ __align__(16) float us[KC][FT];   // source rows

  const int tile = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;                     // column group
  const int ty = tid / 16;                     // row group

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];
  for (int j = j_begin; j < j_end; ++j) {
    const int8_t* w = w_blocks + (size_t)j * TN * CU;
    const auto row_of = rows.job(j);
    for (int k0 = 0; k0 < CU; k0 += KC) {
      {  // W[j, :, k0:k0+KC]: TN rows x KC bytes, one int4 per thread
        const int r = tid / VPR;
        const int c = (tid % VPR) * 16;
        const int4 v =
            __ldg(reinterpret_cast<const int4*>(w + (size_t)r * CU + k0 + c));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[c + q][r] = (float)b[q];
      }
#pragma unroll
      for (int q = 0; q < (KC * FT) / THREADS; ++q) {  // source rows
        const int idx = q * THREADS + tid;
        const int kk = idx / FT;
        const int c = idx % FT;
        const int col = f0 + c;
        const int64_t row = row_of(k0 + kk);
        us[kk][c] = (col < f && row >= 0) ? load_f32(x + row * f + col) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[RPT];
#pragma unroll
        for (int q = 0; q < RPT / 4; ++q) {
          const float4 av =
              *reinterpret_cast<const float4*>(&ws[kk][ty * RPT + 4 * q]);
          a[4 * q] = av.x;
          a[4 * q + 1] = av.y;
          a[4 * q + 2] = av.z;
          a[4 * q + 3] = av.w;
        }
        const float4 bv = *reinterpret_cast<const float4*>(&us[kk][tx * CPT]);
        const float b[CPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const size_t row = (size_t)tile * TN + ty * RPT + i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = f0 + tx * CPT + c;
      if (col < f) store_val(out + row * f + col, acc[i][c]);
    }
  }
}

}  // namespace dense_block
