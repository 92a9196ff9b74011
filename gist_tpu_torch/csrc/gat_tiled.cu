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
// Design.  K7, K8 and K9 walk their rows with tiled_rows.cuh's
// walk_groups, as K3 does: the lanes of a warp in groups of G (8 or 16),
// a lane holding C vectors of V elements of a row, and either one warp
// per row with its groups on successive slots (edges mode, the groups'
// sums added by a fixed xor tree at the end) or one row per group (rows
// mode).  The plan (mode, G, C, V) is chosen on the host from D and the
// alignment (gist_tpu_torch/ops/gat_tiled.py:fwd_plan, b1_plan,
// b2_plan), each plan its own template instance; each was picked by
// timing every plan on an H100 (PERF.md).
//   * K7 is one pass over each row.  Each batch of slots (32 in edges
//     mode, G in rows mode) forms its scores lrelu(src[s] + dst[r]); the
//     batch max moves the running max m, and the accumulators and the
//     lane's partial l are rescaled only where m moved, so m is the exact
//     row max.  A row wider than one block column (D = 512 fp32: four of
//     128) is walked once per column with the same scalar work in the
//     same order, so every column computes the same m and l; column 0
//     stores them.  A pass over the scores for the exact max first
//     measured 2-3% slower.
//   * K8 loads G_r once per row into the registers of the group that
//     walks it (at most B1_MAX values a lane, a row per group), and each
//     group takes its own slot: the dot z[s_e] . G_r is reduced over the
//     group's G lanes (log2 G shuffles), 32 / G slots in flight a warp
//     step.  The lane that holds a slot parks its dot in ds[e] and sums
//     c_r; a second walk over the row forms ds and ddst.  A row wider
//     than the plan's span is walked once per column chunk (D = 512 fp32:
//     two of 256), each chunk's partial dots added into ds[e] in chunk
//     order by the lane that owns e: all of G_r in 32 values a lane
//     measured 1.6x slower from register pressure.  c_r equals
//     out_r . G_r, which the TPU glue passes in; summed here from the
//     same alpha and dalpha it cancels against in ddst_r, so the caller
//     forms no c and keeps no forward output.
//   * K9 is K7's weighted gather over G with final weights: the lane that
//     holds a slot forms its alpha_e from m, l and dst of the slot's
//     sender r_e (no running max, no rescale), and on block column 0 adds
//     ds[pos_in_other[e]] into its share of dsrc in the same pass; one
//     segment sum at the row's end gives dsrc_s.  A row per group won at
//     both widths measured: at D = 41 groups of 16 lanes, half the batch
//     steps a row of groups of 8, each step a chain of dependent loads
//     (the sender, then its m, l and dst, and ds through pos_in_other)
//     and an expf; at D = 512 groups of 8 with up to B2_MAX accumulators
//     a lane (four block columns of 128, each forming alpha anew).
// No kernel adds with atomics: every output element is stored once by
// the lane or warp that summed it, so two launches give the same bits.
// The TPU kernels' materialised per-slot message gathers, one-hot
// products with their hi/lo bf16 splits, bf16 probability matrix,
// clamped chunk indices and dummy trailing block, and the lane-broadcast
// (TN, 128) m/l/c/ddst/dsrc arrays are not carried over: m, l, ddst and
// dsrc are (rows,) vectors.
//
// What bounds them on an H100: the rate of the per-slot row gathers, not
// their bytes counted once.  Each reads one D-wide row per slot (K8 the
// z row; G_r stays in registers), E * D * itemsize bytes, mostly from L2
// (z is 47 MB at D = 512 fp32, 3.8 MB at D = 41); the least time counts
// z once and every useful operation (2 * E * D) once, which the walk
// exceeds by the mean in-degree.  At D = 512 every plan runs at about
// 7 TB/s of gathered rows, K3's best rate too: the L2's pace for such
// gathers.  A ring of the next slots' rows in shared memory filled by
// cp.async, more rows in flight without registers, came within 1% of the
// register walk either way and was not kept.  At D = 41 the lanes set
// the pace: groups of 8 lanes with 6 values each fill 41 of 48 lane
// slots.  A (tile, sender) pair repeats too rarely on synth-reddit-small
// (0.71 of the edges are unique per 128-row tile) for staging shared
// rows to pay.

#include <type_traits>

#include "tiled_rows.cuh"

namespace {

using namespace tiled_rows;

// fp32 values a lane may hold: K7's and K9's accumulators, K8's columns
// of G_r
constexpr int FWD_MAX = 8;
constexpr int B1_MAX = 16;
constexpr int B2_MAX = 16;

template <int N>
using Int = std::integral_constant<int, N>;
template <bool B>
using Bool = std::integral_constant<bool, B>;

// ---------------------------------------------------------------------------
// K7: forward.  grid (row blocks, ceil(d / (G * C * V))).
// z (N, d) in T; src, dst (N) f32; out (n_rows, d) in T; m, l (n_rows)
// f32, written by block column 0.
// ---------------------------------------------------------------------------
template <typename T, int V, int G, int C, bool ROWS>
__global__ void __launch_bounds__(THREADS)
tiled_gat_fwd_kernel(const int32_t* __restrict__ tile_offsets,
                     const int32_t* __restrict__ senders,
                     const int32_t* __restrict__ receivers,
                     const T* __restrict__ z, const float* __restrict__ src,
                     const float* __restrict__ dst, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int n_rows, int tile_rows, int d, float slope) {
  constexpr int NG = 32 / G;
  constexpr int W = ROWS ? G : 32;   // lanes that share a row's batch
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const GroupCols<V, G, C> cols(blockIdx.y * G * C * V, lane % G, d);
  const T* zs = z + cols.base;
  const int row = ROWS ? warp * NG + grp : warp;
  if (!ROWS && row >= n_rows) return;  // the whole warp
  const Slots sl = row < n_rows
                       ? row_slots(tile_offsets, receivers, row, tile_rows)
                       : Slots{0, 0};
  const float dr = sl.begin < sl.end ? __ldg(dst + row) : 0.f;
  float acc[C * V];
#pragma unroll
  for (int i = 0; i < C * V; ++i) acc[i] = 0.f;
  float mx = NEG_INF;   // the running max, the same on the row's lanes
  float part = 0.f;     // this lane's slots' share of l
  float p = 0.f;        // this lane's slot's weight
  walk_groups<G, ROWS>(
      senders, sl, lane,
      [&](bool live, int64_t, int s) {
        const float sc = live ? lrelu(__ldg(src + s) + dr, slope) : NEG_INF;
        const float bm = seg_max<W>(sc);
        if (bm > mx) {   // uniform over the row's lanes
          const float scale = expf(mx - bm);
#pragma unroll
          for (int i = 0; i < C * V; ++i) acc[i] *= scale;
          part *= scale;
          mx = bm;
        }
        p = live ? expf(sc - mx) : 0.f;
        part += p;
      },
      [&](int sk, int k, bool valid) {
        const float pk = __shfl_sync(FULL, p, k, W);
        if (valid) cols.fma(zs + (int64_t)sk * d, pk, acc);
      },
      Nothing{});
  const float l = seg_sum<W>(part);
  if constexpr (!ROWS) sum_groups<G, C * V>(acc);
  if (ROWS ? row < n_rows : grp == 0) {
#pragma unroll
    for (int i = 0; i < C * V; ++i) acc[i] = l > 0.f ? acc[i] / l : 0.f;
    cols.store(out + (int64_t)row * d + cols.base, acc);
    if (blockIdx.y == 0 && lane % G == 0) {
      m_out[row] = mx;
      l_out[row] = l;
    }
  }
}

// K8's and K9's alpha_e of a slot with raw score `raw`.
__device__ __forceinline__ float slot_alpha(float raw, float mr, float lr,
                                            float slope) {
  return lr > 0.f
             ? expf(fminf(lrelu(raw, slope) - mr, 0.f)) / fmaxf(lr, 1e-20f)
             : 0.f;
}

// ---------------------------------------------------------------------------
// K8: backward on the forward layout.  grid (row blocks).
// z (N, d) in T; src, dst (N) f32; m, l (n_rows) f32; g (N, d) f32;
// ds (E_t) f32, written at the real slots; ddst (n_rows) f32, every row.
// ---------------------------------------------------------------------------
template <typename T, int V, int G, int C, bool ROWS>
__global__ void __launch_bounds__(THREADS)
tiled_gat_b1_kernel(const int32_t* __restrict__ tile_offsets,
                    const int32_t* __restrict__ senders,
                    const int32_t* __restrict__ receivers,
                    const T* __restrict__ z, const float* __restrict__ src,
                    const float* __restrict__ dst,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ g, float* __restrict__ ds,
                    float* __restrict__ ddst, int n_rows, int tile_rows,
                    int d, float slope) {
  constexpr int NG = 32 / G;
  constexpr int W = ROWS ? G : 32;   // lanes that share a row's batch
  constexpr int SPAN = G * C * V;    // columns of a chunk
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const int row = ROWS ? warp * NG + grp : warp;
  if (!ROWS && row >= n_rows) return;  // the whole warp
  const Slots sl = row < n_rows
                       ? row_slots(tile_offsets, receivers, row, tile_rows)
                       : Slots{0, 0};
  const bool any = sl.begin < sl.end;
  const float dr = any ? __ldg(dst + row) : 0.f;
  const float mr = any ? __ldg(m + row) : 0.f;
  const float lr = any ? __ldg(l + row) : 0.f;
  // pass 1, once per column chunk: dalpha_e into ds[e] (chunk partials
  // added in order by the lane that holds slot e), c_r on the last chunk
  float csum = 0.f;
  for (int f0 = 0; f0 < d; f0 += SPAN) {
    const GroupCols<V, G, C> cols(f0, lane % G, d);
    const T* zs = z + cols.base;
    const bool last = f0 + SPAN >= d;
    float gr[C * V];   // this lane's columns of G_r
    if (any) {
      cols.load(g + (int64_t)row * d + cols.base, gr);
    } else {
#pragma unroll
      for (int i = 0; i < C * V; ++i) gr[i] = 0.f;
    }
    float dot = 0.f;   // the chunk's dot of the lane's own slot
    walk_groups<G, ROWS>(
        senders, sl, lane, Nothing{},
        [&](int sk, int k, bool valid) {
          const float p =
              seg_sum<G>(valid ? cols.dot(zs + (int64_t)sk * d, gr) : 0.f);
          if constexpr (ROWS) {
            if (lane % G == k) dot = p;
          } else {   // slot k's dot to lane k, from its group's first lane
            const float v = __shfl_sync(FULL, p, (lane % NG) * G);
            if (lane / NG == k / NG) dot = v;
          }
        },
        [&](bool live, int64_t e, int s) {
          if (!live) return;
          const float dalpha = f0 == 0 ? dot : ds[e] + dot;
          ds[e] = dalpha;
          if (last)
            csum = fmaf(slot_alpha(__ldg(src + s) + dr, mr, lr, slope),
                        dalpha, csum);
        });
  }
  const float cr = seg_sum<W>(csum);
  // pass 2: ds_e = alpha_e (dalpha_e - c_r) lrelu'(raw_e), by the lane
  // that holds slot e in pass 1
  float part = 0.f;
  for (int64_t e = sl.begin + lane % W; e < sl.end; e += W) {
    const float raw = __ldg(src + __ldg(senders + e)) + dr;
    const float v = slot_alpha(raw, mr, lr, slope) * (ds[e] - cr) *
                    (raw > 0.f ? 1.f : slope);
    ds[e] = v;
    part += v;
  }
  part = seg_sum<W>(part);
  if ((ROWS ? row < n_rows : grp == 0) && lane % G == 0) ddst[row] = part;
}

// ---------------------------------------------------------------------------
// K9: backward on the transpose layout.  grid (row blocks, ceil(d / (G * C
// * V))).  pos_in_other (E_t) int32; ds (E_t of the forward layout) f32;
// g (N, d) f32; src, dst (N) f32; m, l (forward rows) f32; dz (n_rows, d)
// in T; dsrc (n_rows) f32, written by block column 0.
// ---------------------------------------------------------------------------
template <typename T, int V, int G, int C, bool ROWS>
__global__ void __launch_bounds__(THREADS)
tiled_gat_b2_kernel(const int32_t* __restrict__ tile_offsets,
                    const int32_t* __restrict__ senders,
                    const int32_t* __restrict__ receivers,
                    const int32_t* __restrict__ pos_in_other,
                    const float* __restrict__ ds, const float* __restrict__ g,
                    const float* __restrict__ src,
                    const float* __restrict__ dst,
                    const float* __restrict__ m, const float* __restrict__ l,
                    T* __restrict__ dz, float* __restrict__ dsrc, int n_rows,
                    int tile_rows, int d, float slope) {
  constexpr int NG = 32 / G;
  constexpr int W = ROWS ? G : 32;   // lanes that share a row's batch
  const int lane = threadIdx.x % 32;
  const int grp = lane / G;
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  const GroupCols<V, G, C> cols(blockIdx.y * G * C * V, lane % G, d);
  const float* gs = g + cols.base;
  const bool first = blockIdx.y == 0;   // the column that sums dsrc
  const int row = ROWS ? warp * NG + grp : warp;
  if (!ROWS && row >= n_rows) return;  // the whole warp
  const Slots sl = row < n_rows
                       ? row_slots(tile_offsets, receivers, row, tile_rows)
                       : Slots{0, 0};
  const float sr = sl.begin < sl.end ? __ldg(src + row) : 0.f;
  float acc[C * V];
#pragma unroll
  for (int i = 0; i < C * V; ++i) acc[i] = 0.f;
  float p = 0.f;      // this lane's slot's alpha
  float part = 0.f;   // this lane's slots' share of dsrc
  walk_groups<G, ROWS>(
      senders, sl, lane,
      [&](bool live, int64_t e, int r) {
        p = live ? slot_alpha(sr + __ldg(dst + r), __ldg(m + r),
                              __ldg(l + r), slope)
                 : 0.f;
        if (first && live) part += __ldg(ds + __ldg(pos_in_other + e));
      },
      [&](int sk, int k, bool valid) {
        const float pk = __shfl_sync(FULL, p, k, W);
        if (valid) cols.fma(gs + (int64_t)sk * d, pk, acc);
      },
      Nothing{});
  if constexpr (!ROWS) sum_groups<G, C * V>(acc);
  const float sum = first ? seg_sum<W>(part) : 0.f;   // block-uniform
  if (ROWS ? row < n_rows : grp == 0) {
    cols.store(dz + (int64_t)row * d + cols.base, acc);
    if (first && lane % G == 0) dsrc[row] = sum;
  }
}

// The plan's instance: go(Int<V>, Int<G>, Int<C>, Bool<ROWS>) for the
// plan (rows, group, per_lane, vec), or cudaErrorInvalidValue for a plan
// without one (G other than 8 or 16, C outside {1, 2, 3, 4, 6, 8}, C * V
// above MAX).
template <int MAX, int C, typename Go, typename Vc, typename Gc, typename Rc>
int with_c(const Go& go, Vc v, Gc g, Rc r) {
  if constexpr (C * Vc::value > MAX)
    return (int)cudaErrorInvalidValue;
  else
    return go(v, g, Int<C>{}, r);
}

template <int MAX, typename Go, typename Vc, typename Gc, typename Rc>
int pick_c(int c, const Go& go, Vc v, Gc g, Rc r) {
  switch (c) {
    case 1: return with_c<MAX, 1>(go, v, g, r);
    case 2: return with_c<MAX, 2>(go, v, g, r);
    case 3: return with_c<MAX, 3>(go, v, g, r);
    case 4: return with_c<MAX, 4>(go, v, g, r);
    case 6: return with_c<MAX, 6>(go, v, g, r);
    case 8: return with_c<MAX, 8>(go, v, g, r);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MAX, typename Go, typename Vc, typename Rc>
int pick_g(int g, int c, const Go& go, Vc v, Rc r) {
  if (g == 8) return pick_c<MAX>(c, go, v, Int<8>{}, r);
  if (g == 16) return pick_c<MAX>(c, go, v, Int<16>{}, r);
  return (int)cudaErrorInvalidValue;
}

template <int MAX, typename Go, typename Rc>
int pick_v(int v, int g, int c, const Go& go, Rc r) {
  if (v == 4) return pick_g<MAX>(g, c, go, Int<4>{}, r);
  if (v == 2) return pick_g<MAX>(g, c, go, Int<2>{}, r);
  if (v == 1) return pick_g<MAX>(g, c, go, Int<1>{}, r);
  return (int)cudaErrorInvalidValue;
}

template <int MAX, typename Go>
int pick_plan(int rows, int g, int c, int v, const Go& go) {
  return rows ? pick_v<MAX>(v, g, c, go, Bool<true>{})
              : pick_v<MAX>(v, g, c, go, Bool<false>{});
}

// blocks over n_rows: 8 warps a block, one row a warp (edges) or 32 / G
// (rows)
inline unsigned row_blocks(int n_rows, bool rows, int g) {
  const int per_block = WARPS * (rows ? 32 / g : 1);
  return (unsigned)((n_rows + per_block - 1) / per_block);
}

struct Plan {
  int rows, group, per_lane, vec;
};

template <typename T>
int launch_fwd(const void* tile_offsets, const void* senders,
               const void* receivers, const void* z, const void* src,
               const void* dst, void* out, void* m, void* l, int n_rows,
               int tile_rows, int d, float slope, Plan p, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  return pick_plan<FWD_MAX>(
      p.rows, p.group, p.per_lane, p.vec,
      [&](auto v, auto g, auto c, auto r) {
        constexpr int V = decltype(v)::value, G = decltype(g)::value;
        constexpr int C = decltype(c)::value;
        constexpr bool ROWS = decltype(r)::value;
        const dim3 grid(row_blocks(n_rows, ROWS, G),
                        (d + G * C * V - 1) / (G * C * V));
        tiled_gat_fwd_kernel<T, V, G, C, ROWS>
            <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
                static_cast<const int32_t*>(tile_offsets),
                static_cast<const int32_t*>(senders),
                static_cast<const int32_t*>(receivers),
                static_cast<const T*>(z), static_cast<const float*>(src),
                static_cast<const float*>(dst), static_cast<T*>(out),
                static_cast<float*>(m), static_cast<float*>(l), n_rows,
                tile_rows, d, slope);
        return (int)cudaGetLastError();
      });
}

template <typename T>
int launch_b1(const void* tile_offsets, const void* senders,
              const void* receivers, const void* z, const void* src,
              const void* dst, const void* m, const void* l, const void* g,
              void* ds, void* ddst, int n_rows, int tile_rows, int d,
              float slope, Plan p, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  return pick_plan<B1_MAX>(
      p.rows, p.group, p.per_lane, p.vec,
      [&](auto v, auto gg, auto c, auto r) {
        constexpr int V = decltype(v)::value, G = decltype(gg)::value;
        constexpr int C = decltype(c)::value;
        constexpr bool ROWS = decltype(r)::value;
        tiled_gat_b1_kernel<T, V, G, C, ROWS>
            <<<row_blocks(n_rows, ROWS, G), THREADS, 0,
               (cudaStream_t)stream>>>(
                static_cast<const int32_t*>(tile_offsets),
                static_cast<const int32_t*>(senders),
                static_cast<const int32_t*>(receivers),
                static_cast<const T*>(z), static_cast<const float*>(src),
                static_cast<const float*>(dst), static_cast<const float*>(m),
                static_cast<const float*>(l), static_cast<const float*>(g),
                static_cast<float*>(ds), static_cast<float*>(ddst), n_rows,
                tile_rows, d, slope);
        return (int)cudaGetLastError();
      });
}

template <typename T>
int launch_b2(const void* tile_offsets, const void* senders,
              const void* receivers, const void* pos_in_other,
              const void* ds, const void* g, const void* src, const void* dst,
              const void* m, const void* l, void* dz, void* dsrc, int n_rows,
              int tile_rows, int d, float slope, Plan p, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  return pick_plan<B2_MAX>(
      p.rows, p.group, p.per_lane, p.vec,
      [&](auto v, auto gg, auto c, auto r) {
        constexpr int V = decltype(v)::value, G = decltype(gg)::value;
        constexpr int C = decltype(c)::value;
        constexpr bool ROWS = decltype(r)::value;
        const dim3 grid(row_blocks(n_rows, ROWS, G),
                        (d + G * C * V - 1) / (G * C * V));
        tiled_gat_b2_kernel<T, V, G, C, ROWS>
            <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
                static_cast<const int32_t*>(tile_offsets),
                static_cast<const int32_t*>(senders),
                static_cast<const int32_t*>(receivers),
                static_cast<const int32_t*>(pos_in_other),
                static_cast<const float*>(ds), static_cast<const float*>(g),
                static_cast<const float*>(src),
                static_cast<const float*>(dst), static_cast<const float*>(m),
                static_cast<const float*>(l), static_cast<T*>(dz),
                static_cast<float*>(dsrc), n_rows, tile_rows, d, slope);
        return (int)cudaGetLastError();
      });
}

}  // namespace

// Plain C interface (loaded with ctypes).  Outputs are allocated by the
// caller; ds must be zeroed (K8 writes the real slots only).  Each kernel
// takes its plan (rows_mode, group, per_lane, vec) from
// gist_tpu_torch/ops/gat_tiled.py, with z, out (K7), g (K8, K9), dz (K9)
// and d aligned to vec elements.  Each function returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan without an instance.
#define GAT_TILED_API(SUFFIX, T)                                              \
  extern "C" int gat_tiled_fwd_##SUFFIX(                                      \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* z, const void* src, const void* dst, void* out, void* m,    \
      void* l, int n_rows, int tile_rows, int d, float slope, int rows_mode,  \
      int group, int per_lane, int vec, void* stream) {                       \
    return launch_fwd<T>(tile_offsets, senders, receivers, z, src, dst, out,  \
                         m, l, n_rows, tile_rows, d, slope,                   \
                         {rows_mode, group, per_lane, vec}, stream);          \
  }                                                                           \
  extern "C" int gat_tiled_bwd_b1_##SUFFIX(                                   \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* z, const void* src, const void* dst, const void* m,         \
      const void* l, const void* g, void* ds, void* ddst, int n_rows,         \
      int tile_rows, int d, float slope, int rows_mode, int group,            \
      int per_lane, int vec, void* stream) {                                  \
    return launch_b1<T>(tile_offsets, senders, receivers, z, src, dst, m, l,  \
                        g, ds, ddst, n_rows, tile_rows, d, slope,             \
                        {rows_mode, group, per_lane, vec}, stream);           \
  }                                                                           \
  extern "C" int gat_tiled_bwd_b2_##SUFFIX(                                   \
      const void* tile_offsets, const void* senders, const void* receivers,   \
      const void* pos_in_other, const void* ds, const void* g,                \
      const void* src, const void* dst, const void* m, const void* l,         \
      void* dz, void* dsrc, int n_rows, int tile_rows, int d, float slope,    \
      int rows_mode, int group, int per_lane, int vec, void* stream) {        \
    return launch_b2<T>(tile_offsets, senders, receivers, pos_in_other, ds,   \
                        g, src, dst, m, l, dz, dsrc, n_rows, tile_rows, d,    \
                        slope, {rows_mode, group, per_lane, vec}, stream);    \
  }

GAT_TILED_API(f32, float)
GAT_TILED_API(bf16, __nv_bfloat16)
