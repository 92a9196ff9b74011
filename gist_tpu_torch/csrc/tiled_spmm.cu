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
// edges is 0.
//
// Design: the row walk of tiled_rows.cuh, one warp per row and block
// columns of 256 features.  The TPU kernel first gathered one message row
// per slot into device memory (E_t x F) and scattered each 1024-slot chunk
// with a one-hot (TN x C) matrix product, 2 * E_t * F * TN operations
// where 2 * E * F are useful; here each row's slots are read in place and
// summed in registers, so the work is the useful one.  Its hi/lo bf16
// split of fp32 messages and its f-tile choice have no counterpart.
//
// What bounds it on an H100: bytes.  Every slot reads one x row (F values
// at random rows), so the traffic is ~E * F * itemsize, far above the
// 2 * E * F additions at any peak rate; the least time counts each input
// (x, the slot arrays) once, which the gathers exceed by the mean degree
// where rows miss the 50 MB L2.

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

struct Unit {
  __device__ __forceinline__ float operator()(int) const {
    return 1.f;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
tiled_spmm_kernel(const int32_t* __restrict__ tile_offsets,
                  const int32_t* __restrict__ senders,
                  const int32_t* __restrict__ receivers,
                  const T* __restrict__ x, T* __restrict__ out, int n_rows,
                  int tile_rows, int f) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int f0 = blockIdx.y * FC;
  const Slots sl = row_slots(tile_offsets, receivers, row, tile_rows);
  float acc[ACC] = {};
  gather_rows<T, V>(senders, x, f, f0, sl, lane, Unit{}, acc);
  store_row<T, V>(out + (int64_t)row * f, f, f0, lane, acc, 1.f);
}

template <typename T>
int launch(const void* tile_offsets, const void* senders,
           const void* receivers, const void* x, void* out, int n_rows,
           int tile_rows, int f, void* stream) {
  if (n_rows > 0 && f > 0) {
    const dim3 grid((n_rows + WARPS - 1) / WARPS, (f + FC - 1) / FC);
    const int v = vec_width(f, x, sizeof(T), out, sizeof(T));
    auto go = [&](auto kernel) {
      kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(tile_offsets),
          static_cast<const int32_t*>(senders),
          static_cast<const int32_t*>(receivers), static_cast<const T*>(x),
          static_cast<T*>(out), n_rows, tile_rows, f);
    };
    if (v == 4)
      go(tiled_spmm_kernel<T, 4>);
    else if (v == 2)
      go(tiled_spmm_kernel<T, 2>);
    else
      go(tiled_spmm_kernel<T, 1>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  out is (n_rows, f) in x's
// dtype, n_rows = num_tiles * tile_rows, allocated by the caller; returns
// cudaGetLastError().
extern "C" int tiled_spmm_f32(const void* tile_offsets, const void* senders,
                              const void* receivers, const void* x, void* out,
                              int n_rows, int tile_rows, int f, void* stream) {
  return launch<float>(tile_offsets, senders, receivers, x, out, n_rows,
                       tile_rows, f, stream);
}

extern "C" int tiled_spmm_bf16(const void* tile_offsets, const void* senders,
                               const void* receivers, const void* x,
                               void* out, int n_rows, int tile_rows, int f,
                               void* stream) {
  return launch<__nv_bfloat16>(tile_offsets, senders, receivers, x, out,
                               n_rows, tile_rows, f, stream);
}
