// K7, K8, K9: single-head GAT attention over the v1 gather layout for
// Hopper (sm_90a), with its fused two-kernel backward; scores, softmax
// statistics and sums in fp32, z and dz in fp32 or bf16.
//
// Replaces the TPU kernels of gist_tpu/ops/pallas_gat.py:
//   K7 gat_tiled_fwd     <- _gat_kernel         (_gat_tiled, _gat_forward)
//   K8 gat_tiled_bwd_b1  <- _gat_bwd_b1_kernel  (_gat_backward_fused)
//   K9 gat_tiled_bwd_b2  <- _gat_bwd_b2_kernel  (_gat_backward_fused)
//
// With raw_e = src[s_e] + dst[r] and score_e = leaky_relu(raw_e) for the
// slots e of destination row r (senders s_e):
//
//   K7: m_r = max_e score_e, l_r = sum_e exp(score_e - m_r),
//       out_r = sum_e exp(score_e - m_r) z[s_e] / l_r;
//       a row without edges gives out 0, m -1e30, l 0.
//   K8 (forward layout): alpha_e = exp(min(score_e - m_r, 0)) / l_r (0 if
//       l_r = 0), dalpha_e = z[s_e] . G_r, c_r = sum_e alpha_e dalpha_e,
//       ds_e = alpha_e (dalpha_e - c_r) lrelu'(raw_e) written per slot,
//       ddst_r = sum_e ds_e.
//   K9 (transpose layout: rows are original senders s, slot senders the
//       original receivers r_e): dz_s = sum_e alpha_e G[r_e] with alpha
//       recomputed from m, l of r_e, dsrc_s = sum_e ds[pos_in_other[e]].
//
// Design: the row walk of tiled_rows.cuh (one warp per row, its slots
// found by searching the tile's receivers, rows gathered by index in the
// kernel, sums in registers, no atomics).  K7 walks a row's slots twice,
// the exact max first, then the weighted sum and l, so no online
// rescaling is needed; it computes each score from src and dst itself,
// so neither a per-slot score array nor a gathered message array exists.
// K8 takes the dot products dalpha_e one slot at a time across the warp
// (lanes over D, a shuffle reduction), parks them in ds and sums c_r from
// them, then forms ds in a second pass over the row.  c_r equals
// out_r . G_r, which the TPU glue passes in; summed here from the same
// alpha and dalpha it cancels against in ddst_r, the caller forms no c
// and keeps no forward output.  K9 is K7's weighted gather over G with
// ds gathered through pos_in_other.  The TPU kernels' materialised
// per-slot message gathers, one-hot products with their hi/lo bf16
// splits, bf16 probability matrix, clamped chunk indices and dummy
// trailing block, and the lane-broadcast (TN, 128) m/l/c/ddst/dsrc arrays
// are not carried over: m, l, ddst and dsrc are (rows,) vectors.
//
// What bounds them on an H100: bytes.  K7 and K9 read one D-wide row per
// slot, K8 one z row per slot (G_r is reused from L1 across the row), at
// 2 * E * D useful operations: far below any peak rate.

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

// K7's weight of a slot: exp(score - m), the exact row max known.
struct Softmax {
  const float* src;
  float dr, mx, slope;
  __device__ __forceinline__ float operator()(int s) const {
    return expf(lrelu(__ldg(src + s) + dr, slope) - mx);
  }
};

// K9's weight of a transpose slot whose sender is the original receiver r.
struct Alpha {
  const float *dst, *m, *l;
  float sr, slope;
  __device__ __forceinline__ float operator()(int r) const {
    const float lr = __ldg(l + r);
    if (!(lr > 0.f)) return 0.f;
    const float e = lrelu(sr + __ldg(dst + r), slope);
    return expf(fminf(e - __ldg(m + r), 0.f)) / fmaxf(lr, 1e-20f);
  }
};

// ---------------------------------------------------------------------------
// K7: forward.  grid (ceil(n_rows / WARPS), ceil(d / FC)).
// z (N, d) in T; src, dst (N) f32; out (n_rows, d) in T; m, l (n_rows)
// f32, written by block column 0.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gat_fwd_kernel(const int32_t* __restrict__ tile_offsets,
               const int32_t* __restrict__ senders,
               const int32_t* __restrict__ receivers,
               const T* __restrict__ z, const float* __restrict__ src,
               const float* __restrict__ dst, T* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int n_rows, int tile_rows, int d, float slope) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int f0 = blockIdx.y * FC;
  const Slots sl = row_slots(tile_offsets, receivers, row, tile_rows);
  const float dr = sl.begin < sl.end ? __ldg(dst + row) : 0.f;
  float mx = NEG_INF;
  for (int64_t e = sl.begin + lane; e < sl.end; e += 32)
    mx = fmaxf(mx, lrelu(__ldg(src + __ldg(senders + e)) + dr, slope));
  mx = warp_max(mx);
  float acc[ACC] = {};
  const float l = warp_sum(gather_rows<T, V>(
      senders, z, d, f0, sl, lane, Softmax{src, dr, mx, slope}, acc));
  store_row<T, V>(out + (int64_t)row * d, d, f0, lane, acc, l);
  if (blockIdx.y == 0 && lane == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

// K8's alpha_e of a slot with raw score `raw`.
__device__ __forceinline__ float slot_alpha(float raw, float mr, float lr,
                                            float slope) {
  return lr > 0.f
             ? expf(fminf(lrelu(raw, slope) - mr, 0.f)) / fmaxf(lr, 1e-20f)
             : 0.f;
}

// ---------------------------------------------------------------------------
// K8: backward on the forward layout.  grid (ceil(n_rows / WARPS)).
// z (N, d) in T; src, dst (N) f32; m, l (n_rows) f32; g (N, d) f32;
// ds (E_t) f32, written at the real slots; ddst (n_rows) f32.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gat_bwd_b1_kernel(const int32_t* __restrict__ tile_offsets,
                  const int32_t* __restrict__ senders,
                  const int32_t* __restrict__ receivers,
                  const T* __restrict__ z, const float* __restrict__ src,
                  const float* __restrict__ dst,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ g, float* __restrict__ ds,
                  float* __restrict__ ddst, int n_rows, int tile_rows, int d,
                  float slope) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const Slots sl = row_slots(tile_offsets, receivers, row, tile_rows);
  float part = 0.f;
  if (sl.begin < sl.end) {
    const float dr = __ldg(dst + row), mr = __ldg(m + row);
    const float lr = __ldg(l + row);
    const float* gr = g + (int64_t)row * d;
    // pass 1: dalpha_e parked in ds[e] (by the lane that owns slot e in
    // both passes), c_r = sum alpha_e dalpha_e
    float csum = 0.f;
    for (int64_t e0 = sl.begin; e0 < sl.end; e0 += 32) {
      const int cnt = sl.end - e0 < 32 ? (int)(sl.end - e0) : 32;
      int s = 0;
      if (lane < cnt) s = __ldg(senders + e0 + lane);
      float dalpha = 0.f;
#pragma unroll 2
      for (int k = 0; k < cnt; ++k) {
        const int64_t sk = __shfl_sync(FULL, s, k);
        const T* zr = z + sk * d;
        float p = 0.f;
        for (int col = lane * V; col < d; col += 32 * V) {
          float zv[V], gv[V];
          load_vec<T, V>(zr + col, zv);
          load_vec<float, V>(gr + col, gv);
#pragma unroll
          for (int kk = 0; kk < V; ++kk) p = fmaf(zv[kk], gv[kk], p);
        }
        p = warp_sum(p);
        if (lane == k) dalpha = p;
      }
      if (lane < cnt) {
        ds[e0 + lane] = dalpha;
        csum += slot_alpha(__ldg(src + s) + dr, mr, lr, slope) * dalpha;
      }
    }
    const float cr = warp_sum(csum);
    // pass 2: ds_e = alpha_e (dalpha_e - c_r) lrelu'(raw_e)
    for (int64_t e = sl.begin + lane; e < sl.end; e += 32) {
      const float raw = __ldg(src + __ldg(senders + e)) + dr;
      const float v = slot_alpha(raw, mr, lr, slope) * (ds[e] - cr) *
                      (raw > 0.f ? 1.f : slope);
      ds[e] = v;
      part += v;
    }
  }
  part = warp_sum(part);
  if (lane == 0) ddst[row] = part;
}

// ---------------------------------------------------------------------------
// K9: backward on the transpose layout.  grid (ceil(n_rows / WARPS),
// ceil(d / FC)).  pos_in_other (E_t) int32; ds (E_t of the forward layout)
// f32; g (N, d) f32; src, dst (N) f32; m, l (forward rows) f32; dz
// (n_rows, d) in T; dsrc (n_rows) f32, written by block column 0.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gat_bwd_b2_kernel(const int32_t* __restrict__ tile_offsets,
                  const int32_t* __restrict__ senders,
                  const int32_t* __restrict__ receivers,
                  const int32_t* __restrict__ pos_in_other,
                  const float* __restrict__ ds, const float* __restrict__ g,
                  const float* __restrict__ src,
                  const float* __restrict__ dst, const float* __restrict__ m,
                  const float* __restrict__ l, T* __restrict__ dz,
                  float* __restrict__ dsrc, int n_rows, int tile_rows, int d,
                  float slope) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int f0 = blockIdx.y * FC;
  const Slots sl = row_slots(tile_offsets, receivers, row, tile_rows);
  const float sr = sl.begin < sl.end ? __ldg(src + row) : 0.f;
  float acc[ACC] = {};
  gather_rows<float, V>(senders, g, d, f0, sl, lane,
                        Alpha{dst, m, l, sr, slope}, acc);
  store_row<T, V>(dz + (int64_t)row * d, d, f0, lane, acc, 1.f);
  if (blockIdx.y == 0) {
    float p = 0.f;
    for (int64_t e = sl.begin + lane; e < sl.end; e += 32)
      p += __ldg(ds + __ldg(pos_in_other + e));
    p = warp_sum(p);
    if (lane == 0) dsrc[row] = p;
  }
}

template <typename T>
int launch_fwd(const void* tile_offsets, const void* senders,
               const void* receivers, const void* z, const void* src,
               const void* dst, void* out, void* m, void* l, int n_rows,
               int tile_rows, int d, float slope, void* stream) {
  if (n_rows > 0 && d > 0) {
    const dim3 grid((n_rows + WARPS - 1) / WARPS, (d + FC - 1) / FC);
    auto go = [&](auto kernel) {
      kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(tile_offsets),
          static_cast<const int32_t*>(senders),
          static_cast<const int32_t*>(receivers), static_cast<const T*>(z),
          static_cast<const float*>(src), static_cast<const float*>(dst),
          static_cast<T*>(out), static_cast<float*>(m),
          static_cast<float*>(l), n_rows, tile_rows, d, slope);
    };
    const int v = vec_width(d, z, sizeof(T), out, sizeof(T));
    if (v == 4)
      go(gat_fwd_kernel<T, 4>);
    else if (v == 2)
      go(gat_fwd_kernel<T, 2>);
    else
      go(gat_fwd_kernel<T, 1>);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b1(const void* tile_offsets, const void* senders,
              const void* receivers, const void* z, const void* src,
              const void* dst, const void* m, const void* l, const void* g,
              void* ds, void* ddst, int n_rows, int tile_rows, int d,
              float slope, void* stream) {
  if (n_rows > 0 && d > 0) {
    const dim3 grid((n_rows + WARPS - 1) / WARPS);
    auto go = [&](auto kernel) {
      kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(tile_offsets),
          static_cast<const int32_t*>(senders),
          static_cast<const int32_t*>(receivers), static_cast<const T*>(z),
          static_cast<const float*>(src), static_cast<const float*>(dst),
          static_cast<const float*>(m), static_cast<const float*>(l),
          static_cast<const float*>(g), static_cast<float*>(ds),
          static_cast<float*>(ddst), n_rows,
          tile_rows, d, slope);
    };
    const int v = vec_width(d, z, sizeof(T), g, sizeof(float));
    if (v == 4)
      go(gat_bwd_b1_kernel<T, 4>);
    else if (v == 2)
      go(gat_bwd_b1_kernel<T, 2>);
    else
      go(gat_bwd_b1_kernel<T, 1>);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b2(const void* tile_offsets, const void* senders,
              const void* receivers, const void* pos_in_other,
              const void* ds, const void* g, const void* src, const void* dst,
              const void* m, const void* l, void* dz, void* dsrc, int n_rows,
              int tile_rows, int d, float slope, void* stream) {
  if (n_rows > 0 && d > 0) {
    const dim3 grid((n_rows + WARPS - 1) / WARPS, (d + FC - 1) / FC);
    auto go = [&](auto kernel) {
      kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(tile_offsets),
          static_cast<const int32_t*>(senders),
          static_cast<const int32_t*>(receivers),
          static_cast<const int32_t*>(pos_in_other),
          static_cast<const float*>(ds), static_cast<const float*>(g),
          static_cast<const float*>(src), static_cast<const float*>(dst),
          static_cast<const float*>(m), static_cast<const float*>(l),
          static_cast<T*>(dz), static_cast<float*>(dsrc), n_rows, tile_rows,
          d, slope);
    };
    const int v = vec_width(d, g, sizeof(float), dz, sizeof(T));
    if (v == 4)
      go(gat_bwd_b2_kernel<T, 4>);
    else if (v == 2)
      go(gat_bwd_b2_kernel<T, 2>);
    else
      go(gat_bwd_b2_kernel<T, 1>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Outputs are allocated by the
// caller; ds must be zeroed (K8 writes the real slots only).  Each
// function returns cudaGetLastError().
#define GAT_TILED_API(SUFFIX, T)                                              \
  extern "C" int gat_tiled_fwd_##SUFFIX(                                      \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* z, const void* src, const void* dst, void* out, void* m,    \
      void* l, int n_rows, int tile_rows, int d, float slope, void* stream) { \
    return launch_fwd<T>(tile_offsets, senders, receivers, z, src, dst, out,  \
                         m, l, n_rows, tile_rows, d, slope, stream);          \
  }                                                                           \
  extern "C" int gat_tiled_bwd_b1_##SUFFIX(                                   \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* z, const void* src, const void* dst, const void* m,         \
      const void* l, const void* g, void* ds, void* ddst, int n_rows,         \
      int tile_rows, int d, float slope, void* stream) {                      \
    return launch_b1<T>(tile_offsets, senders, receivers, z, src, dst, m, l,  \
                        g, ds, ddst, n_rows, tile_rows, d, slope, stream);    \
  }                                                                           \
  extern "C" int gat_tiled_bwd_b2_##SUFFIX(                                   \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* pos_in_other, const void* ds, const void* g,                \
      const void* src, const void* dst, const void* m, const void* l,         \
      void* dz, void* dsrc, int n_rows, int tile_rows, int d, float slope,    \
      void* stream) {                                                         \
    return launch_b2<T>(tile_offsets, senders, receivers, pos_in_other, ds,   \
                        g, src, dst, m, l, dz, dsrc, n_rows, tile_rows, d,    \
                        slope, stream);                                       \
  }

GAT_TILED_API(f32, float)
GAT_TILED_API(bf16, __nv_bfloat16)
