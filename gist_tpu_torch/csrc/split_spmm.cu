// K2: the split dedup SpMM (direct + remote jobs) for Hopper (sm_90a),
// fp32 FMA.
//
// Replaces the TPU kernel gist_tpu/ops/pallas_spmm.py:_split_kernel
// (launched by _spmm_split_call, once per chunk by _run_dedup_split_chunked
// and, on the transpose layout, by _spmm_bwd).  For destination tile i of
// one chunk and feature column f:
//
//   out[i*TN + r, f] = sum_{j = job_offsets[i]}^{job_offsets[i+1]-1}
//                      sum_{k < CU} W[j, r, k] * R_j[k, f]
//   R_j[k] = x[dir_blk[j]*CU + k]            if is_dir[j] == 1 (direct)
//          = x[u_rem[rem_blk[j]*CU + k]]     otherwise         (remote)
//
// x is the permuted feature table (rows in the layout's permuted order);
// direct rows at or past n_rows (the last source block runs past N) read
// zero, so x needs no row padding.  Int8 counts W, fp32 accumulator,
// output in x's dtype.  TN is 64 or 128 rows and CU 512 or 1024 slots,
// one instantiation each.
//
// Design: the sparse walk of count_block.cuh (shared with K1) with a
// per-job row source: one warp per destination row and 256-column feature
// slice (at F <= 256 one warp covers every column), eight rows a block.
// For each job of its tile (the padding jobs and padding tiles of a chunk
// are never read, and a tile without jobs writes zeros) the warp reads
// its row of W once, lists the nonzero slots and gathers only their rows:
// a direct job's rows from its contiguous slab, a remote job's through
// u_rem inside the kernel (no materialised gather as on the TPU).  Plain
// fp32 FMA, one per nonzero count and column: no TF32, no hi/lo bf16
// split (the fp32 path holds 1e-5 relative to the plain version); no
// block barriers, no atomics.  The TPU's clamped job indices, alternating
// accumulators and forward-filled block indices are not needed: dir_blk
// is read only for direct jobs and rem_blk only for remote jobs.
//
// What bounds it on an H100: bytes.  On the synth-amazon2m-small split
// layout (TN 64, CU 1024, 10,502 real jobs, 5.84M nonzero counts) at
// F = 100 the function needs ~0.8 GB of traffic (W of the real jobs
// 0.69 GB, features and output ~0.1 GB), ~0.24 ms at 3.35 TB/s, and 1.2
// GFLOP of useful FMAs.  On top of W's stream the kernel reads one
// 400-byte x row per nonzero count (~2.3 GB, mostly from L2), ~3.7x the
// byte bound.

#include "count_block.cuh"

namespace {

// Slot k of job j reads x[dir_blk[j]*CU + k] (zero at or past n_rows)
// for a direct job and x[u_rem[rem_blk[j]*CU + k]] for a remote one.
template <int CU>
struct SplitRows {
  const int32_t* dir_blk;
  const int32_t* rem_blk;
  const int32_t* is_dir;
  const int32_t* u_rem;
  int64_t n_rows;
  __device__ __forceinline__ count_block::JobRows job(int j) const {
    if (__ldg(is_dir + j) == 1)
      return {nullptr, (int64_t)__ldg(dir_blk + j) * CU, n_rows};
    return {u_rem + (int64_t)__ldg(rem_blk + j) * CU, 0, n_rows};
  }
};

template <typename T, int TN, int CU, int V>
__global__ void __launch_bounds__(count_block::THREADS)
split_spmm_kernel(const int32_t* __restrict__ job_offsets,
                  const int32_t* __restrict__ dir_blk,
                  const int32_t* __restrict__ rem_blk,
                  const int32_t* __restrict__ is_dir,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_rem,
                  const T* __restrict__ x,
                  T* __restrict__ out,
                  int64_t n_rows, int f, int slices) {
  count_block::tile_spmm<T, TN, CU, V>(
      job_offsets, w_blocks,
      SplitRows<CU>{dir_blk, rem_blk, is_dir, u_rem, n_rows}, x, out, f,
      slices);
}

template <typename T, int TN, int CU, int V>
void launch_vec(const void* job_offsets, const void* dir_blk,
                const void* rem_blk, const void* is_dir, const void* w_blocks,
                const void* u_rem, const void* x, void* out, int blocks,
                int64_t n_rows, int f, int slices, cudaStream_t stream) {
  split_spmm_kernel<T, TN, CU, V>
      <<<blocks, count_block::THREADS, 0, stream>>>(
      static_cast<const int32_t*>(job_offsets),
      static_cast<const int32_t*>(dir_blk),
      static_cast<const int32_t*>(rem_blk),
      static_cast<const int32_t*>(is_dir),
      static_cast<const int8_t*>(w_blocks),
      static_cast<const int32_t*>(u_rem), static_cast<const T*>(x),
      static_cast<T*>(out), n_rows, f, slices);
}

template <typename T, int TN, int CU>
int launch_shape(const void* job_offsets, const void* dir_blk,
                 const void* rem_blk, const void* is_dir, const void* w_blocks,
                 const void* u_rem, const void* x, void* out, int num_tiles,
                 int64_t n_rows, int f, cudaStream_t stream) {
  if (num_tiles > 0 && f > 0) {
    const count_block::Plan p = count_block::plan<T>(f, x);
    const int blocks = num_tiles * (TN / count_block::WARPS) * p.slices;
#define K2_VEC(V_)                                                         \
  launch_vec<T, TN, CU, V_>(job_offsets, dir_blk, rem_blk, is_dir,         \
                            w_blocks, u_rem, x, out, blocks, n_rows, f,    \
                            p.slices, stream)
    if (p.vec == 4)
      K2_VEC(4);
    else if (p.vec == 2)
      K2_VEC(2);
    else
      K2_VEC(1);
#undef K2_VEC
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* job_offsets, const void* dir_blk, const void* rem_blk,
           const void* is_dir, const void* w_blocks, const void* u_rem,
           const void* x, void* out, int num_tiles, int64_t n_rows, int f,
           int tile_rows, int cu, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define K2_SHAPE(TN_, CU_)                                                   \
  if (tile_rows == TN_ && cu == CU_)                                         \
    return launch_shape<T, TN_, CU_>(job_offsets, dir_blk, rem_blk, is_dir,  \
                                     w_blocks, u_rem, x, out, num_tiles,     \
                                     n_rows, f, s);
  K2_SHAPE(64, 512)
  K2_SHAPE(64, 1024)
  K2_SHAPE(128, 512)
  K2_SHAPE(128, 1024)
#undef K2_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes).  One chunk: job_offsets
// (num_tiles + 1), dir_blk / rem_blk / is_dir (jobs), w_blocks
// (jobs, tile_rows, cu), u_rem (rem_jobs * cu), x (n_rows, f); out is
// (num_tiles * tile_rows, f) in x's dtype, allocated by the caller;
// w_blocks is 16-byte aligned.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape without an instantiation.
extern "C" int split_spmm_f32(const void* job_offsets, const void* dir_blk,
                              const void* rem_blk, const void* is_dir,
                              const void* w_blocks, const void* u_rem,
                              const void* x, void* out, int num_tiles,
                              int64_t n_rows, int f, int tile_rows, int cu,
                              void* stream) {
  return launch<float>(job_offsets, dir_blk, rem_blk, is_dir, w_blocks, u_rem,
                       x, out, num_tiles, n_rows, f, tile_rows, cu, stream);
}

extern "C" int split_spmm_bf16(const void* job_offsets, const void* dir_blk,
                               const void* rem_blk, const void* is_dir,
                               const void* w_blocks, const void* u_rem,
                               const void* x, void* out, int num_tiles,
                               int64_t n_rows, int f, int tile_rows, int cu,
                               void* stream) {
  return launch<__nv_bfloat16>(job_offsets, dir_blk, rem_blk, is_dir,
                               w_blocks, u_rem, x, out, num_tiles, n_rows, f,
                               tile_rows, cu, stream);
}
