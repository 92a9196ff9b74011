// K1: block-dense dedup SpMM for Hopper (sm_90a), fp32 FMA.
//
// Replaces the TPU kernel gist_tpu/ops/pallas_spmm.py:_dedup_kernel
// (launched by _spmm_dedup_call, run by _run_dedup and, on the transpose
// layout, by _spmm_bwd).  For destination tile i and feature column f:
//
//   out[i*TN + r, f] = sum_{j = job_offsets[i]}^{job_offsets[i+1]-1}
//                      sum_{c < CU} W[j, r, c] * x[u_senders[j*CU + c], f]
//
// with TN = 128 rows per tile, CU = 1024 unique-sender slots per job,
// int8 counts W and an fp32 accumulator; the output is in x's dtype.
//
// Design: one block per (destination tile, 64-column feature tile).  The
// block walks its tile's jobs (bounded by job_offsets, so the padding
// jobs of pad_dedup_tiles are never read; a tile without jobs writes
// zeros).  Per step it stages a (TN x 32) slice of W, converted to
// float, and the 32 matching x rows, gathered through u_senders inside
// the kernel (no U x F intermediate in device memory), in shared memory;
// each of the 256 threads then keeps an 8 x 4 block of the tile's
// accumulators in registers and runs fp32 FMAs (not TF32: the fp32 path
// must match the plain version to ~1e-5 relative).  Padding u slots
// point at row 0 and pair with all-zero W columns, so they add nothing.
//
// What bounds it on an H100: for the slice's batch (159 tiles, 318 jobs,
// 1.2% dense W) at F = 256 the function needs ~83 MB of traffic (W
// 39.8 MB + x 20.8 MB + out 20.8 MB + indices), ~25 us at 3.35 TB/s,
// and 0.25 GFLOP of useful work.  This design multiplies the dense
// blocks instead: 2*J*TN*CU*F ~ 21 GFLOP, >= 0.32 ms even at the 67
// TFLOP/s fp32 peak, so it is bound by its own wasted operations.  The
// dense blocks are kept for simplicity; a sparsity-aware or tensor-core
// redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;       // destination rows per tile
constexpr int CU = 1024;      // unique-sender slots per job
constexpr int FT = 64;        // feature columns per block
constexpr int KC = 32;        // slots staged in shared memory per step
constexpr int THREADS = 256;
constexpr int RPT = 8;        // accumulator rows per thread (16 groups)
constexpr int CPT = 4;        // accumulator columns per thread (16 groups)

static_assert(TN == 16 * RPT && FT == 16 * CPT, "thread layout");
static_assert(THREADS * 16 == TN * KC, "one 16-byte W load per thread");
static_assert((KC * FT) % THREADS == 0, "x slice split evenly");

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dedup_spmm_kernel(const int32_t* __restrict__ job_offsets,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_senders,
                  const T* __restrict__ x,
                  T* __restrict__ out,
                  int f) {
  __shared__ __align__(16) float ws[KC][TN];   // W slice, transposed
  __shared__ __align__(16) float us[KC][FT];   // gathered x rows

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
    const int32_t* u = u_senders + (size_t)j * CU;
    for (int k0 = 0; k0 < CU; k0 += KC) {
      {  // W[j, :, k0:k0+KC]: 128 rows x 32 bytes, one int4 per thread
        const int r = tid >> 1;
        const int c = (tid & 1) * 16;
        const int4 v =
            __ldg(reinterpret_cast<const int4*>(w + (size_t)r * CU + k0 + c));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[c + q][r] = (float)b[q];
      }
#pragma unroll
      for (int q = 0; q < (KC * FT) / THREADS; ++q) {  // gathered x rows
        const int idx = q * THREADS + tid;
        const int kk = idx / FT;
        const int c = idx % FT;
        const int col = f0 + c;
        const int64_t row = __ldg(u + k0 + kk);
        us[kk][c] = col < f ? load_f32(x + row * f + col) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&ws[kk][ty * RPT]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&ws[kk][ty * RPT + 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&us[kk][tx * CPT]);
        const float a[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
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

template <typename T>
int launch(const void* job_offsets, const void* w_blocks,
           const void* u_senders, const void* x, void* out, int num_tiles,
           int f, void* stream) {
  if (num_tiles > 0 && f > 0) {
    const dim3 grid(num_tiles, (f + FT - 1) / FT);
    dedup_spmm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(job_offsets),
        static_cast<const int8_t*>(w_blocks),
        static_cast<const int32_t*>(u_senders), static_cast<const T*>(x),
        static_cast<T*>(out), f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  out is (num_tiles * 128, f)
// in x's dtype, allocated by the caller; returns cudaGetLastError().
extern "C" int dedup_spmm_f32(const void* job_offsets, const void* w_blocks,
                              const void* u_senders, const void* x, void* out,
                              int num_tiles, int f, void* stream) {
  return launch<float>(job_offsets, w_blocks, u_senders, x, out, num_tiles, f,
                       stream);
}

extern "C" int dedup_spmm_bf16(const void* job_offsets, const void* w_blocks,
                               const void* u_senders, const void* x, void* out,
                               int num_tiles, int f, void* stream) {
  return launch<__nv_bfloat16>(job_offsets, w_blocks, u_senders, x, out,
                               num_tiles, f, stream);
}
