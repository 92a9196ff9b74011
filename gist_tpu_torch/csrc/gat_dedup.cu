// K4, K5, K6: GAT attention over the block-dense dedup layout for Hopper
// (sm_90a), fp32 FMA throughout.
//
// Replaces the TPU kernels of gist_tpu/ops/pallas_gat.py:
//   K4 gat_fwd      <- _gat_dedup_kernel          (launched by _gat_dedup_call)
//   K5 gat_bwd_b1   <- _gat_dedup_bwd_b1_kernel   (_gat_dedup_backward_fused)
//   K6 gat_bwd_b2   <- _gat_dedup_bwd_b2_kernel   (_gat_dedup_backward_fused)
//
// Layout (as K1): destination tile i owns jobs job_offsets[i] ..
// job_offsets[i+1]-1; job j pairs the int8 COUNT block W[j] (TN x CU) with
// CU unique-sender slots u_senders[j*CU ..].  Padding slots point at node
// 0 with all-zero W columns; padding jobs past job_offsets[-1] are never
// read; a tile without jobs writes zeros.  For every slot with w > 0:
//
//   e(r, u) = leaky_relu(dst[r] + src[u], slope)
//   K4: out[r] = sum_u w e^{e - m_r} z_u / l_r,  l_r = sum_u w e^{e - m_r},
//       m_r = max_u e (per head h); out = 0, m = -1e30, l = 0 on empty rows.
//   K5: A = w e^{min(e - m_r, 0)} / max(l_r, 1e-20),  dalpha = G_r . z_u,
//       ds = A (dalpha - c_r) lrelu'(raw),  ddst_r = sum_u ds.
//   K6 (transpose layout: tile rows are senders s, slots receivers r):
//       dz_s = sum_r A(s, r) G_r,  dsrc_s = sum_r ds(s, r).
//
// Design.  All three walk only the nonzero counts, with K1's list step
// (count_block.cuh), through one row walk (walk_row below): one warp owns
// one row of a tile and keeps that row's 256-column chunk of its own
// matrix in registers.  For each job it reads the row's CU counts once,
// the next job's already in flight, lists the nonzero (slot, count)
// entries, then takes them 32 at a time: each lane loads one entry's node
// id and forms its scalars with one exp; then every entry's row chunk of
// the gathered matrix is read by all lanes across the columns, four rows
// in flight, into fp32 FMAs (not TF32).
//
// * K4 gathers z_u and keeps an online softmax: per batch a warp max of
//   the lanes' scores moves the running max m, the lane rescales its
//   accumulators and partial l by e^{m_old - m} where m moved, and forms
//   p = w e^{e - m}; acc += p z_u.  m is the exact row max, l one warp sum
//   at the end.  One warp per (row, head): a warp walking both heads of
//   its row, paying the list step once, measured no faster on an H100
//   (PERF.md), and holds twice the registers.
// * K5 keeps G_r and gathers z_u; K6 keeps z_s and gathers G_r (dz +=
//   A G_r).  ds = coef (dot - c) with coef = A lrelu'(raw) is linear in
//   the dot, so each lane keeps sum coef * (its columns of the dot) and
//   sum coef * c over its own entries, and one warp sum per row gives
//   ddst_r (K5) or dsrc_s (K6): no reduction per entry.
//
// Above 256 columns a warp walks the jobs once per chunk (rebuilding the
// lists and scalars costs less than keeping every chunk in registers or
// shared memory at any width).  Every output element is stored once by
// one lane or warp, empty rows and tiles included: no atomics, no zeroed
// output, and two launches give the same bits.
//
// What bounds them on an H100: the chain of dependent loads of each row
// (counts, list, node ids, scores, rows), not its bytes.  W of the real
// jobs (~19 MB on the GAT slice's batch, 1.3% nonzero) is read once and
// each of ~0.26M nonzero counts reads a row chunk, mostly from L2, but at
// O = 41 the three take about as long as at O = 256 (PERF.md): more rows
// in flight per SM, not fewer bytes, would make them faster.  The TPU's
// dense (TN x CU) products, bf16 probability matrix and hi/lo split, the
// lane-broadcast m/l/dst arrays and the materialised u_rows gathers are
// not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "count_block.cuh"

namespace {

constexpr int TN = 128;       // destination rows per tile
constexpr int CU = 1024;      // unique-sender slots per job
constexpr int WARPS = count_block::WARPS;
constexpr int CHUNK = count_block::FT;   // columns per pass over the jobs
constexpr int EPL = count_block::EPL;    // of them per lane
constexpr int WPL = CU / 32 / 16;        // 16-byte count loads per lane
constexpr unsigned ALL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
static_assert(TN % WARPS == 0, "layout");

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(ALL, v, o);
  return v;
}

// The lanes' share of a chunk of wf columns: load h of a lane holds
// columns h * 32 * V + lane * V + 0 .. V-1, where they exist.
template <int V>
struct Lanes {
  static constexpr int LOADS = EPL / V;
  bool has[LOADS];
  __device__ __forceinline__ Lanes(int wf, int lane) {
#pragma unroll
    for (int h = 0; h < LOADS; ++h) has[h] = h * 32 * V + lane * V < wf;
  }
  // f(col, x) for each of this lane's columns col (0 .. EPL-1) of the row
  // at p
  template <typename T, typename F>
  __device__ __forceinline__ void each(const T* p, F f) const {
#pragma unroll
    for (int h = 0; h < LOADS; ++h) {
      if (!has[h]) continue;
      float q[V];
      count_block::load<V>(p + h * 32 * V, q);
#pragma unroll
      for (int k = 0; k < V; ++k) f(h * V + k, q[k]);
    }
  }
  template <typename T>
  __device__ __forceinline__ void store(T* p, const float (&v)[EPL]) const {
#pragma unroll
    for (int h = 0; h < LOADS; ++h)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (has[h]) count_block::store_val(p + h * 32 * V + k, v[h * V + k]);
  }
};

// The walk of row r of `tile` over the nonzero counts of its jobs, 32
// entries a batch.  For each batch every lane calls
//   entry(live, node, cnt)
// (live: the lane holds an entry of the batch; node = u_senders[slot] and
// cnt its count, 0 and 0 where not live), which forms the lane's scalars
// and may use warp shuffles (every lane calls it); then for each entry e
// of the batch every lane calls
//   use(e, mat + node_e * ld)
// to read its columns of that row (with Lanes::each).
template <typename TM, typename Entry, typename Use>
__device__ __forceinline__ void walk_row(
    const int32_t* __restrict__ job_offsets,
    const int8_t* __restrict__ w_blocks,
    const int32_t* __restrict__ u_senders, int tile, int r, int lane,
    uint32_t* list, const TM* __restrict__ mat, int64_t ld, Entry entry,
    Use use) {
  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];
  uint4 next[WPL];
  if (j_begin < j_end)
    count_block::load_counts<TN, CU>(w_blocks, j_begin, r, lane, next);
  for (int j = j_begin; j < j_end; ++j) {
    uint4 w[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) w[i] = next[i];
    if (j + 1 < j_end)
      count_block::load_counts<TN, CU>(w_blocks, j + 1, r, lane, next);
    const int total = count_block::list_nonzero(w, ~0u, lane, list);
    const int32_t* uj = u_senders + (size_t)j * CU;

    for (int e0 = 0; e0 < total; e0 += 32) {
      const bool live = e0 + lane < total;
      int node = 0;
      float cnt = 0.f;
      if (live) {
        const uint32_t item = list[e0 + lane];
        node = __ldg(uj + (item & 0xffff));
        cnt = (float)(item >> 16);
      }
      entry(live, node, cnt);
      const int batch = min(32, total - e0);
#pragma unroll 4
      for (int e = 0; e < batch; ++e)
        use(e, mat + (int64_t)__shfl_sync(ALL, node, e) * ld);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K4: forward.  num_tiles * TN / WARPS * heads blocks of
// count_block::THREADS, one warp per (row, head); block b holds head
// b % heads of rows (b / heads) * WARPS .., so a row's heads are
// neighbours in launch order and share its counts in L2.
// z (N, H, O) in T; src (N, H), dst_rows (tiles*TN, H) f32;
// out (tiles*TN, H, O) in T; m, l (tiles*TN, H) f32.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(count_block::THREADS)
gat_fwd_kernel(const int32_t* __restrict__ job_offsets,
               const int8_t* __restrict__ w_blocks,
               const int32_t* __restrict__ u_senders,
               const T* __restrict__ z, const float* __restrict__ src,
               const float* __restrict__ dst_rows, T* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int heads, int o, float slope) {
  __shared__ uint32_t lists[WARPS][CU];    // (slot | count << 16) entries

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int h = (int)(blockIdx.x % heads);
  const size_t row = (size_t)(blockIdx.x / heads) * WARPS + warp;
  const size_t at = row * heads + h;       // the (row, head) pair
  const float d = dst_rows[at];

  for (int f0 = 0; f0 < o; f0 += CHUNK) {
    const Lanes<V> lanes(min(CHUNK, o - f0), lane);
    float acc[EPL] = {};
    float mx = NEG_INF;   // the running max, the same on every lane
    float part = 0.f;     // this lane's entries' share of l
    float p = 0.f;        // this lane's entry's weight
    walk_row(
        job_offsets, w_blocks, u_senders, (int)(row / TN), (int)(row % TN),
        lane, lists[warp], z + (int64_t)h * o + f0 + lane * V,
        (int64_t)heads * o,
        [&](bool live, int node, float cnt) {
          const float e =
              live ? lrelu(d + __ldg(src + (int64_t)node * heads + h), slope)
                   : NEG_INF;
          float bm = e;
#pragma unroll
          for (int s = 16; s > 0; s >>= 1)
            bm = fmaxf(bm, __shfl_xor_sync(ALL, bm, s));
          if (bm > mx) {   // warp-uniform
            const float scale = expf(mx - bm);
#pragma unroll
            for (int k = 0; k < EPL; ++k) acc[k] *= scale;
            part *= scale;
            mx = bm;
          }
          p = live ? cnt * expf(e - mx) : 0.f;
          part += p;
        },
        [&](int e, const T* zu) {
          const float pe = __shfl_sync(ALL, p, e);
          lanes.each(zu, [&](int col, float x) {
            acc[col] = fmaf(pe, x, acc[col]);
          });
        });
    const float l = warp_sum(part);
#pragma unroll
    for (int k = 0; k < EPL; ++k)
      acc[k] = l > 0.f ? acc[k] / fmaxf(l, 1e-20f) : 0.f;
    lanes.store(out + at * o + f0 + lane * V, acc);
    if (f0 == 0 && lane == 0) {
      m_out[at] = mx;
      l_out[at] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// K5: backward B1 on the forward layout.  num_tiles * TN / WARPS blocks
// of count_block::THREADS, one warp per row r.
// g_rows (tiles*TN, D) f32; z (N, D) in T; dst_rows, m_rows, l_rows,
// c_rows (tiles*TN) f32; src (N) f32; ddst (tiles*TN) f32, every element
// written.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(count_block::THREADS)
gat_bwd_b1_kernel(const int32_t* __restrict__ job_offsets,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_senders,
                  const float* __restrict__ g_rows, const T* __restrict__ z,
                  const float* __restrict__ dst_rows,
                  const float* __restrict__ src,
                  const float* __restrict__ m_rows,
                  const float* __restrict__ l_rows,
                  const float* __restrict__ c_rows, float* __restrict__ ddst,
                  int dcols, float slope) {
  __shared__ uint32_t lists[WARPS][CU];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t row = (size_t)blockIdx.x * WARPS + warp;
  const float d = dst_rows[row], mr = m_rows[row];
  const float lr = fmaxf(l_rows[row], 1e-20f), cr = c_rows[row];

  float ds_dot = 0.f;  // sum over this lane's columns and every entry of
                       // coef * G_r[col] * z_u[col]
  float ds_c = 0.f;    // sum over this lane's entries of coef * c_r
  for (int f0 = 0; f0 < dcols; f0 += CHUNK) {
    const Lanes<V> lanes(min(CHUNK, dcols - f0), lane);
    float gs[EPL] = {};
    lanes.each(g_rows + row * dcols + f0 + lane * V,
               [&](int col, float x) { gs[col] = x; });
    float coef = 0.f;
    walk_row(
        job_offsets, w_blocks, u_senders, (int)(row / TN), (int)(row % TN),
        lane, lists[warp], z + f0 + lane * V, (int64_t)dcols,
        [&](bool live, int node, float cnt) {
          if (!live) return;
          const float raw = d + __ldg(src + node);
          const float a =
              cnt * expf(fminf(lrelu(raw, slope) - mr, 0.f)) / lr;
          coef = raw > 0.f ? a : a * slope;
          if (f0 == 0) ds_c = fmaf(coef, cr, ds_c);
        },
        [&](int e, const T* zu) {
          const float ce = __shfl_sync(ALL, coef, e);
          float dot = 0.f;
          lanes.each(zu,
                     [&](int col, float x) { dot = fmaf(gs[col], x, dot); });
          ds_dot = fmaf(ce, dot, ds_dot);
        });
  }
  const float t = warp_sum(ds_dot - ds_c);
  if (lane == 0) ddst[row] = t;
}

// ---------------------------------------------------------------------------
// K6: backward B2 on the transpose layout.  num_tiles * TN / WARPS blocks
// of count_block::THREADS, one warp per row s.
// z_rows (tiles*TN, D) in T; src_rows (tiles*TN) f32; g (N, D) f32;
// dst, m, l, c (N) f32; dz (tiles*TN, D) in T; dsrc (tiles*TN) f32.
// Every element of dz and dsrc is written.
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(count_block::THREADS)
gat_bwd_b2_kernel(const int32_t* __restrict__ job_offsets,
                  const int8_t* __restrict__ w_blocks,
                  const int32_t* __restrict__ u_senders,
                  const T* __restrict__ z_rows,
                  const float* __restrict__ src_rows,
                  const float* __restrict__ g, const float* __restrict__ dst,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ c, T* __restrict__ dz,
                  float* __restrict__ dsrc, int dcols, float slope) {
  __shared__ uint32_t lists[WARPS][CU];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t row = (size_t)blockIdx.x * WARPS + warp;
  const float sr = src_rows[row];

  float ds_dot = 0.f;  // sum over this lane's columns and every entry of
                       // coef * z_s[col] * G_r[col]
  float ds_c = 0.f;    // sum over this lane's entries of coef * c_r
  for (int f0 = 0; f0 < dcols; f0 += CHUNK) {
    const Lanes<V> lanes(min(CHUNK, dcols - f0), lane);
    float zs[EPL] = {}, acc[EPL] = {};
    lanes.each(z_rows + row * dcols + f0 + lane * V,
               [&](int col, float x) { zs[col] = x; });
    float a = 0.f, coef = 0.f;
    walk_row(
        job_offsets, w_blocks, u_senders, (int)(row / TN), (int)(row % TN),
        lane, lists[warp], g + f0 + lane * V, (int64_t)dcols,
        [&](bool live, int node, float cnt) {
          if (!live) return;
          const float raw = sr + __ldg(dst + node);
          a = cnt * expf(fminf(lrelu(raw, slope) - __ldg(m + node), 0.f)) /
              fmaxf(__ldg(l + node), 1e-20f);
          coef = raw > 0.f ? a : a * slope;
          if (f0 == 0) ds_c = fmaf(coef, __ldg(c + node), ds_c);
        },
        [&](int e, const float* gr) {
          const float ae = __shfl_sync(ALL, a, e);
          const float ce = __shfl_sync(ALL, coef, e);
          float dot = 0.f;
          lanes.each(gr, [&](int col, float x) {
            acc[col] = fmaf(ae, x, acc[col]);
            dot = fmaf(zs[col], x, dot);
          });
          ds_dot = fmaf(ce, dot, ds_dot);
        });
    lanes.store(dz + row * dcols + f0 + lane * V, acc);
  }
  const float t = warp_sum(ds_dot - ds_c);
  if (lane == 0) dsrc[row] = t;
}

// The widest V in {4, 2, 1} that divides cols and to which the rows of
// the f32 arrays f32 and of the T arrays t are aligned (V elements).
template <typename T>
int row_vec(int cols, uintptr_t f32, uintptr_t t) {
  for (int v = 4; v > 1; v /= 2)
    if (cols % v == 0 && f32 % (v * sizeof(float)) == 0 &&
        t % (v * sizeof(T)) == 0)
      return v;
  return 1;
}

// The instance of a kernel for V
template <typename K>
K pick(int v, K k4, K k2, K k1) {
  return v == 4 ? k4 : v == 2 ? k2 : k1;
}

template <typename T>
int launch_fwd(const void* job_offsets, const void* w_blocks,
               const void* u_senders, const void* z, const void* src,
               const void* dst_rows, void* out, void* m, void* l,
               int num_tiles, int heads, int o, float slope, void* stream) {
  if (num_tiles > 0 && heads > 0 && o > 0) {
    const auto kernel = pick(row_vec<T>(o, 0, (uintptr_t)z | (uintptr_t)out),
                             gat_fwd_kernel<T, 4>, gat_fwd_kernel<T, 2>,
                             gat_fwd_kernel<T, 1>);
    kernel<<<num_tiles * (TN / WARPS) * heads, count_block::THREADS, 0,
             (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(job_offsets),
        static_cast<const int8_t*>(w_blocks),
        static_cast<const int32_t*>(u_senders), static_cast<const T*>(z),
        static_cast<const float*>(src), static_cast<const float*>(dst_rows),
        static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l),
        heads, o, slope);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b1(const void* job_offsets, const void* w_blocks,
              const void* u_senders, const void* g_rows, const void* z,
              const void* dst_rows, const void* src, const void* m_rows,
              const void* l_rows, const void* c_rows, void* ddst,
              int num_tiles, int dcols, float slope, void* stream) {
  if (num_tiles > 0 && dcols > 0) {
    const auto kernel =
        pick(row_vec<T>(dcols, (uintptr_t)g_rows, (uintptr_t)z),
             gat_bwd_b1_kernel<T, 4>, gat_bwd_b1_kernel<T, 2>,
             gat_bwd_b1_kernel<T, 1>);
    kernel<<<num_tiles * (TN / WARPS), count_block::THREADS, 0,
             (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(job_offsets),
        static_cast<const int8_t*>(w_blocks),
        static_cast<const int32_t*>(u_senders),
        static_cast<const float*>(g_rows), static_cast<const T*>(z),
        static_cast<const float*>(dst_rows), static_cast<const float*>(src),
        static_cast<const float*>(m_rows), static_cast<const float*>(l_rows),
        static_cast<const float*>(c_rows), static_cast<float*>(ddst), dcols,
        slope);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b2(const void* job_offsets, const void* w_blocks,
              const void* u_senders, const void* z_rows, const void* src_rows,
              const void* g, const void* dst, const void* m, const void* l,
              const void* c, void* dz, void* dsrc, int num_tiles, int dcols,
              float slope, void* stream) {
  if (num_tiles > 0 && dcols > 0) {
    const auto kernel = pick(
        row_vec<T>(dcols, (uintptr_t)g, (uintptr_t)z_rows | (uintptr_t)dz),
        gat_bwd_b2_kernel<T, 4>, gat_bwd_b2_kernel<T, 2>,
        gat_bwd_b2_kernel<T, 1>);
    kernel<<<num_tiles * (TN / WARPS), count_block::THREADS, 0,
             (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(job_offsets),
        static_cast<const int8_t*>(w_blocks),
        static_cast<const int32_t*>(u_senders),
        static_cast<const T*>(z_rows), static_cast<const float*>(src_rows),
        static_cast<const float*>(g), static_cast<const float*>(dst),
        static_cast<const float*>(m), static_cast<const float*>(l),
        static_cast<const float*>(c), static_cast<T*>(dz),
        static_cast<float*>(dsrc), dcols, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Outputs are allocated by the
// caller; every kernel writes every element of its outputs.  Each
// function returns cudaGetLastError().
#define GAT_DEDUP_API(SUFFIX, T)                                              \
  extern "C" int gat_fwd_##SUFFIX(                                            \
      const void* job_offsets, const void* w_blocks, const void* u_senders,   \
      const void* z, const void* src, const void* dst_rows, void* out,        \
      void* m, void* l, int num_tiles, int heads, int o, float slope,         \
      void* stream) {                                                         \
    return launch_fwd<T>(job_offsets, w_blocks, u_senders, z, src, dst_rows,  \
                         out, m, l, num_tiles, heads, o, slope, stream);      \
  }                                                                           \
  extern "C" int gat_bwd_b1_##SUFFIX(                                         \
      const void* job_offsets, const void* w_blocks, const void* u_senders,   \
      const void* g_rows, const void* z, const void* dst_rows,                \
      const void* src, const void* m_rows, const void* l_rows,                \
      const void* c_rows, void* ddst, int num_tiles, int dcols, float slope,  \
      void* stream) {                                                         \
    return launch_b1<T>(job_offsets, w_blocks, u_senders, g_rows, z,          \
                        dst_rows, src, m_rows, l_rows, c_rows, ddst,          \
                        num_tiles, dcols, slope, stream);                     \
  }                                                                           \
  extern "C" int gat_bwd_b2_##SUFFIX(                                         \
      const void* job_offsets, const void* w_blocks, const void* u_senders,   \
      const void* z_rows, const void* src_rows, const void* g,                \
      const void* dst, const void* m, const void* l, const void* c,           \
      void* dz, void* dsrc, int num_tiles, int dcols, float slope,            \
      void* stream) {                                                         \
    return launch_b2<T>(job_offsets, w_blocks, u_senders, z_rows, src_rows,   \
                        g, dst, m, l, c, dz, dsrc, num_tiles, dcols, slope,   \
                        stream);                                              \
  }

GAT_DEDUP_API(f32, float)
GAT_DEDUP_API(bf16, __nv_bfloat16)
