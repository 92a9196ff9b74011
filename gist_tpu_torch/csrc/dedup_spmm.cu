// K1: the dedup SpMM for Hopper (sm_90a), fp32 FMA.
//
// Replaces the TPU kernel gist_tpu/ops/pallas_spmm.py:_dedup_kernel
// (launched by _spmm_dedup_call, run by _run_dedup and, on the transpose
// layout, by _spmm_bwd).  For destination tile i and feature column f:
//
//   out[i*TN + r, f] = sum_{j = job_offsets[i]}^{job_offsets[i+1]-1}
//                      sum_{c < CU} W[j, r, c] * x[u_senders[j*CU + c], f]
//
// with TN = 64, 128 or 256 rows per tile (the flat layouts take 128,
// the chunked ones and the benchmarks' tile sweep 64 and 256), CU = 512
// or 1024 unique-sender slots per job (the layouts' default is 1024; the
// full-scale SpMM benchmark builds 512 too), one instance for each of
// the six pairs, int8 counts W and an fp32 accumulator; the output is in
// x's dtype.  A CU of 512 halves a warp's slot list (16 KB of shared
// memory a block instead of 32) and doubles the jobs of a tile.
//
// Design: the sparse walk of count_block.cuh (shared with K2): one warp
// per destination row and 256-column feature slice, eight rows a block,
// the blocks of a tile neighbours in launch order.  The warp reads its
// row of W once per job (1 KB, coalesced, the next job's in flight),
// turns it into the row's list of nonzero slots by a byte compare, a
// bit gather and a warp prefix sum, and for each entry gathers the x row
// of u_senders[slot] inside the kernel and adds count * row in fp32 FMA:
// one FMA per nonzero count and column, no block barriers, no atomics.
// The TPU kernel multiplied the dense (128 x 1024) blocks on the MXU,
// 2*J*TN*CU*F operations for W that is ~1% nonzero; this walk does only
// the nonzero ones.  Staging the used slots' rows in shared memory once
// per tile (fewer gathered bytes) was tried and lost: its block-wide
// steps of 32 or 64 slots were bound by their own latency (PERF.md).
//
// What bounds it on an H100: bytes.  For the SAGE path's batch (159
// tiles, 314 jobs, 489k nonzero counts) at F = 256 the function needs
// ~84 MB of
// traffic (W 41 MB, x 21 MB, out 21 MB, indices), ~25 us at 3.35 TB/s,
// against 0.25 GFLOP of useful FMAs.  The kernel reads W once but one x
// row per nonzero count (~0.5 GB, from L2: x fits in it), which sets its
// pace: 0.083 ms, 3.3x the byte bound, on an H100 80GB HBM3 at 700 W
// (device time per call, chip_smoke.py); at the full-scale shapes (x of
// 238 MB, beyond the 50 MB L2; 39.6M counts) those gathers run to ~40 GB
// of L2 and HBM traffic per pass at F = 256.

#include "count_block.cuh"

namespace {

// Slot k of job j reads x[u_senders[j*CU + k]].
template <int CU>
struct GatherRows {
  const int32_t* u_senders;
  __device__ __forceinline__ count_block::JobRows job(int j) const {
    return {u_senders + (size_t)j * CU, 0, 0};
  }
};

template <typename T, int TN, int CU, int V>
__global__ void __launch_bounds__(count_block::THREADS)
dedup_spmm_kernel(const int32_t* __restrict__ job_offsets,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_senders,
                  const T* __restrict__ x,
                  T* __restrict__ out,
                  int f, int slices) {
  count_block::tile_spmm<T, TN, CU, V>(job_offsets, w_blocks,
                                       GatherRows<CU>{u_senders}, x, out, f,
                                       slices);
}

template <typename T, int TN, int CU, int V>
void launch_vec(const void* job_offsets, const void* w_blocks,
                const void* u_senders, const void* x, void* out,
                int blocks, int f, int slices, cudaStream_t stream) {
  dedup_spmm_kernel<T, TN, CU, V>
      <<<blocks, count_block::THREADS, 0, stream>>>(
      static_cast<const int32_t*>(job_offsets),
      static_cast<const int8_t*>(w_blocks),
      static_cast<const int32_t*>(u_senders), static_cast<const T*>(x),
      static_cast<T*>(out), f, slices);
}

template <typename T, int TN, int CU>
int launch_shape(const void* job_offsets, const void* w_blocks,
                 const void* u_senders, const void* x, void* out,
                 int num_tiles, int f, cudaStream_t s) {
  if (num_tiles > 0 && f > 0) {
    const count_block::Plan p = count_block::plan<T>(f, x);
    const int blocks = num_tiles * (TN / count_block::WARPS) * p.slices;
    if (p.vec == 4)
      launch_vec<T, TN, CU, 4>(job_offsets, w_blocks, u_senders, x, out,
                               blocks, f, p.slices, s);
    else if (p.vec == 2)
      launch_vec<T, TN, CU, 2>(job_offsets, w_blocks, u_senders, x, out,
                               blocks, f, p.slices, s);
    else
      launch_vec<T, TN, CU, 1>(job_offsets, w_blocks, u_senders, x, out,
                               blocks, f, p.slices, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* job_offsets, const void* w_blocks,
           const void* u_senders, const void* x, void* out, int num_tiles,
           int f, int tn, int cu, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define K1_SHAPE(TN_, CU_)                                                  \
  if (tn == TN_ && cu == CU_)                                               \
    return launch_shape<T, TN_, CU_>(job_offsets, w_blocks, u_senders, x,   \
                                     out, num_tiles, f, s);
  K1_SHAPE(64, 512)
  K1_SHAPE(64, 1024)
  K1_SHAPE(128, 512)
  K1_SHAPE(128, 1024)
  K1_SHAPE(256, 512)
  K1_SHAPE(256, 1024)
#undef K1_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  w_blocks is (jobs, tn, cu)
// int8, 16-byte aligned; out is (num_tiles * tn, f) in x's dtype,
// allocated by the caller.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a (tn, cu) without an instance.
extern "C" int dedup_spmm_f32(const void* job_offsets, const void* w_blocks,
                              const void* u_senders, const void* x, void* out,
                              int num_tiles, int f, int tn, int cu,
                              void* stream) {
  return launch<float>(job_offsets, w_blocks, u_senders, x, out, num_tiles, f,
                       tn, cu, stream);
}

extern "C" int dedup_spmm_bf16(const void* job_offsets, const void* w_blocks,
                               const void* u_senders, const void* x, void* out,
                               int num_tiles, int f, int tn, int cu,
                               void* stream) {
  return launch<__nv_bfloat16>(job_offsets, w_blocks, u_senders, x, out,
                               num_tiles, f, tn, cu, stream);
}
