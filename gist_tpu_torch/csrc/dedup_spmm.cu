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
// Design: the block-dense tile loop of dense_block.cuh (shared with K2),
// one block per (destination tile, 64-column feature tile), with rows
// gathered through u_senders inside the kernel (no U x F intermediate in
// device memory).  Per step it stages a (TN x 32) slice of W and the 32
// matching x rows in shared memory; each of the 256 threads keeps an
// 8 x 4 block of the tile's accumulators in registers.  Padding u slots
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

#include "dense_block.cuh"

namespace {

constexpr int TN = 128;       // destination rows per tile
constexpr int CU = 1024;      // unique-sender slots per job

// Slot k of job j reads x[u_senders[j*CU + k]].
struct GatherRows {
  const int32_t* u_senders;
  struct Job {
    const int32_t* u;
    __device__ __forceinline__ int64_t operator()(int k) const {
      return __ldg(u + k);
    }
  };
  __device__ __forceinline__ Job job(int j) const {
    return {u_senders + (size_t)j * CU};
  }
};

template <typename T>
__global__ void __launch_bounds__(dense_block::THREADS)
dedup_spmm_kernel(const int32_t* __restrict__ job_offsets,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_senders,
                  const T* __restrict__ x,
                  T* __restrict__ out,
                  int f) {
  dense_block::tile_spmm<T, TN, CU>(job_offsets, w_blocks,
                                    GatherRows{u_senders}, x, out, f);
}

template <typename T>
int launch(const void* job_offsets, const void* w_blocks,
           const void* u_senders, const void* x, void* out, int num_tiles,
           int f, void* stream) {
  if (num_tiles > 0 && f > 0) {
    const dim3 grid(num_tiles, (f + dense_block::FT - 1) / dense_block::FT);
    dedup_spmm_kernel<T>
        <<<grid, dense_block::THREADS, 0, (cudaStream_t)stream>>>(
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
