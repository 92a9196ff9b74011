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
// Design.  Every kernel walks its tile's jobs in a loop inside the block
// (Hopper blocks run in any order; there is no sequential grid to carry
// a running sum).
//
// * K4 (accumulate blocks): one block per (tile, head, 64-column slice).
//   Per step the 256 threads rebuild a (TN x 32) probability slice from W
//   and the staged per-slot scalars, gather the 32 matching rows through
//   u_senders into shared memory, and run fp32 FMAs into an 8 x 4
//   register block each.  It needs the row max first: a first pass over
//   the tile's jobs computes m_r exactly, the second accumulates with it,
//   so no rescaling is needed (the TPU kernel's online softmax gives the
//   same m and l up to rounding).
// * K5 (SDDMM blocks): one block per (tile, quarter of the slots of every
//   job).  dalpha for a (TN x 64) slot block is an NT product over the
//   feature depth, staged 32 columns at a time; the epilogue forms ds and
//   reduces it over the slots into per-row sums.  The four quarters of a
//   tile add their row sums with fp32 atomics into an output the caller
//   zeroes, so the order of those four additions changes from run to run
//   (rounding only).
// * K6 walks only the nonzero counts, with K1's list step
//   (count_block.cuh): one warp owns one row s of a transpose tile and
//   keeps z_s's 256-column chunk in registers.  For each job it reads the
//   row's CU counts once, lists the nonzero (slot, count) entries, then
//   takes them 32 at a time: each lane loads one entry's receiver r and
//   its scalars (dst_r, m_r, l_r, c_r) and forms A and
//   coef = A * lrelu'(raw) with one exp; then every entry's G_r chunk is
//   read by all lanes across the columns, four rows in flight, and
//   dz += A * G_r and the lane's partial dot z_s . G_r are fp32 FMAs
//   (not TF32).  ds = coef * (z_s . G_r - c_r) is linear in the dot, so
//   each lane keeps sum_r coef * (its columns of z_s . G_r) and
//   sum_r coef * c_r over its own entries, and one warp sum per row gives
//   dsrc_s: no warp reduction per entry.  Above 256 columns the warp
//   walks the jobs once per chunk (rebuilding the lists and the scalars
//   costs less than keeping every chunk of z_s and dz in registers or
//   shared memory at any width).  dz and dsrc are each stored once, every
//   row written (empty rows and tiles with 0): no atomics, no zeroed
//   output, and two launches give the same bits.
//
// What bounds it on an H100.  K4 and K5 by the dense blocks they
// multiply: at the GAT slice's batch (54 tiles, 136 jobs, W 1.3% dense)
// K4 at H=2, O=256 does 2*136*128*1024*512 = 18 GFLOP of FMA on the
// dense blocks where the useful work is ~0.23 GFLOP and the bytes the
// function must move are ~40 MB (~12 us).  K6 by its gathers: W of the
// transpose jobs (~18 MB) is read once, but each of ~0.29M nonzero
// counts reads a 1 KB G row (O = 256, fp32), mostly from L2.  The TPU's
// bf16 probability matrix and hi/lo split, the lane-broadcast m/l/dst
// arrays and the materialised u_rows gathers are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "count_block.cuh"

namespace {

constexpr int TN = 128;       // destination rows per tile
constexpr int CU = 1024;      // unique-sender slots per job
constexpr int THREADS = 256;
constexpr int FT = 64;        // feature columns per K4 block
constexpr int KC = 32;        // slots staged per accumulate step
constexpr int RPT = 8;        // register rows per thread (16 row groups)
constexpr int CPT = 4;        // register columns per thread (16 groups)
constexpr int KS = 64;        // slots per SDDMM step
constexpr int DK = 32;        // feature depth staged per SDDMM step
constexpr int SPLIT = 4;      // SDDMM blocks per tile
constexpr int SLOTS = CU / SPLIT;
constexpr float NEG_INF = -1e30f;

static_assert(TN == 16 * RPT && FT == 16 * CPT && KS == 16 * CPT, "layout");
static_assert(THREADS * 16 == TN * KC, "one 16-byte W load per thread");
static_assert((KC * FT) % THREADS == 0, "row slice split evenly");
static_assert((TN * DK / 4) % THREADS == 0 && (KS * DK / 4) % THREADS == 0,
              "SDDMM staging split evenly");
static_assert(SLOTS % KS == 0, "SDDMM steps");

// shared memory (floats) of a K5 block
constexpr int SDDMM_SMEM = SLOTS + DK * TN + DK * KS + 4 * TN;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float lrelu(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

// acc[i][c] += sum_kk ps[kk][ty*RPT + i] * zs[kk][tx*CPT + c]
__device__ __forceinline__ void fma_chunk(const float* ps, const float* zs,
                                          float acc[RPT][CPT], int tx,
                                          int ty) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(ps + kk * TN + ty * RPT);
    const float4 a1 =
        *reinterpret_cast<const float4*>(ps + kk * TN + ty * RPT + 4);
    const float4 bv = *reinterpret_cast<const float4*>(zs + kk * FT + tx * CPT);
    const float a[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[CPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// zs[kk][c] = mat[u[kk] * ld + off + f0 + c] (0 past ncols) for KC slots
template <typename T>
__device__ __forceinline__ void stage_rows(float* zs, const T* __restrict__ mat,
                                           int64_t ld, int64_t off, int ncols,
                                           const int32_t* __restrict__ u,
                                           int f0, int tid) {
#pragma unroll
  for (int q = 0; q < (KC * FT) / THREADS; ++q) {
    const int idx = q * THREADS + tid;
    const int kk = idx / FT;
    const int c = idx % FT;
    const int col = f0 + c;
    const int64_t row = __ldg(u + kk);
    zs[kk * FT + c] = col < ncols ? to_f(mat[row * ld + off + col]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K4: forward.  grid (num_tiles, heads, ceil(o / FT)).
// z (N, H, O) in T; src (N, H), dst_rows (tiles*TN, H) f32;
// out (tiles*TN, H, O) in T; m, l (tiles*TN, H) f32, written by slice 0.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
gat_fwd_kernel(const int32_t* __restrict__ job_offsets,
               const int8_t* __restrict__ w_blocks,
               const int32_t* __restrict__ u_senders,
               const T* __restrict__ z, const float* __restrict__ src,
               const float* __restrict__ dst_rows, T* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int heads, int o, float slope) {
  __shared__ __align__(16) float usc[CU];      // src scores of the job's slots
  __shared__ __align__(16) float ps[KC * TN];  // probability slice, transposed
  __shared__ __align__(16) float zs[KC * FT];  // gathered z rows
  __shared__ float s_row[TN];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int f0 = blockIdx.z * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r = tid >> 1, half = tid & 1;   // score-block row and half
  const size_t row = (size_t)tile * TN + r;
  const float d = dst_rows[row * heads + h];
  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];

  // pass 1: the row's max score over its edges
  float mx = NEG_INF;
  for (int j = j_begin; j < j_end; ++j) {
    const int32_t* uj = u_senders + (size_t)j * CU;
    __syncthreads();
    for (int c = tid; c < CU; c += THREADS)
      usc[c] = src[(int64_t)__ldg(uj + c) * heads + h];
    __syncthreads();
    const int8_t* wr =
        w_blocks + ((size_t)j * TN + r) * CU + half * (CU / 2);
    for (int k = 0; k < CU / 2; k += 16) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(wr + k));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (b[q] > 0)
          mx = fmaxf(mx, lrelu(d + usc[half * (CU / 2) + k + q], slope));
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));

  // pass 2: probabilities with the exact row max, accumulated
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  float s_part = 0.f;
  for (int j = j_begin; j < j_end; ++j) {
    const int32_t* uj = u_senders + (size_t)j * CU;
    const int8_t* wj = w_blocks + (size_t)j * TN * CU;
    __syncthreads();
    for (int c = tid; c < CU; c += THREADS)
      usc[c] = src[(int64_t)__ldg(uj + c) * heads + h];
    __syncthreads();
    for (int k0 = 0; k0 < CU; k0 += KC) {
      {
        const int4 v = __ldg(
            reinterpret_cast<const int4*>(wj + (size_t)r * CU + k0 + half * 16));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int c = half * 16 + q;
          float p = 0.f;
          if (b[q] > 0)
            p = (float)b[q] * expf(lrelu(d + usc[k0 + c], slope) - mx);
          s_part += p;
          ps[c * TN + r] = p;
        }
      }
      stage_rows(zs, z, (int64_t)heads * o, (int64_t)h * o, o, uj + k0, f0,
                 tid);
      __syncthreads();
      fma_chunk(ps, zs, acc, tx, ty);
      __syncthreads();
    }
  }
  const float s = s_part + __shfl_xor_sync(0xffffffffu, s_part, 1);
  if (half == 0) {
    s_row[r] = s;
    if (blockIdx.z == 0) {
      m_out[row * heads + h] = mx;
      l_out[row * heads + h] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rr = ty * RPT + i;
    const float sv = s_row[rr];
    const size_t orow = ((size_t)tile * TN + rr) * heads + h;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = f0 + tx * CPT + c;
      if (col < o)
        store_val(out + orow * o + col,
                  sv > 0.f ? acc[i][c] / fmaxf(sv, 1e-20f) : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// SDDMM block (K5): rowsum[tile*TN + r] += sum over this block's quarter
// q of every job's slots of
//   A(r, u) * (rowmat[r] . slotmat[u] - c_r) * lrelu'(row_score[r] + slot_score[u])
// with m, l, c per row (row order).
// ---------------------------------------------------------------------------
template <typename TS>
__device__ __forceinline__ void sddmm_rowsum(
    const int32_t* __restrict__ job_offsets,
    const int8_t* __restrict__ w_blocks,
    const int32_t* __restrict__ u_senders, const float* __restrict__ rowmat,
    const TS* __restrict__ slotmat, int dcols,
    const float* __restrict__ row_score, const float* __restrict__ slot_score,
    const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ c, float* __restrict__ rowsum, int tile, int q,
    float slope, float* smem) {
  float* sc_u = smem;                // SLOTS slot scores
  float* rs = sc_u + SLOTS;          // DK x TN row features, transposed
  float* ss = rs + DK * TN;          // DK x KS slot features, transposed
  float* r_sc = ss + DK * KS;        // TN row scores
  float* r_m = r_sc + TN;            // TN row stats
  float* r_l = r_m + TN;
  float* r_c = r_l + TN;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t row0 = (size_t)tile * TN;
  if (tid < TN) {
    r_sc[tid] = row_score[row0 + tid];
    r_m[tid] = m[row0 + tid];
    r_l[tid] = l[row0 + tid];
    r_c[tid] = c[row0 + tid];
  }
  float racc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) racc[i] = 0.f;

  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];
  for (int j = j_begin; j < j_end; ++j) {
    const int32_t* uj = u_senders + (size_t)j * CU + q * SLOTS;
    const int8_t* wj = w_blocks + (size_t)j * TN * CU + q * SLOTS;
    __syncthreads();
    for (int s = tid; s < SLOTS; s += THREADS)
      sc_u[s] = slot_score[__ldg(uj + s)];
    __syncthreads();
    for (int k0 = 0; k0 < SLOTS; k0 += KS) {
      float acc[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
      for (int d0 = 0; d0 < dcols; d0 += DK) {
        // row features: a warp reads 32 rows at one depth quad, so the
        // transposed stores hit 32 banks
#pragma unroll
        for (int p = 0; p < (TN * DK / 4) / THREADS; ++p) {
          const int idx = p * THREADS + tid;
          const int rr = idx % TN;
          const int dq = (idx / TN) * 4;
          const float* src_p = rowmat + (row0 + rr) * dcols + d0 + dq;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[(dq + e) * TN + rr] =
                d0 + dq + e < dcols ? to_f(src_p[e]) : 0.f;
        }
#pragma unroll
        for (int p = 0; p < (KS * DK / 4) / THREADS; ++p) {
          const int idx = p * THREADS + tid;
          const int sl = idx % KS;
          const int dq = (idx / KS) * 4;
          const TS* src_p =
              slotmat + (int64_t)__ldg(uj + k0 + sl) * dcols + d0 + dq;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ss[(dq + e) * KS + sl] =
                d0 + dq + e < dcols ? to_f(src_p[e]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < DK; ++kk) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(rs + kk * TN + ty * RPT);
          const float4 a1 =
              *reinterpret_cast<const float4*>(rs + kk * TN + ty * RPT + 4);
          const float4 bv =
              *reinterpret_cast<const float4*>(ss + kk * KS + tx * CPT);
          const float a[RPT] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
          const float b[CPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
              acc[i][cc] = fmaf(a[i], b[cc], acc[i][cc]);
        }
        __syncthreads();
      }
      // epilogue: ds for this thread's 8 x 4 entries, summed over slots
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rr = ty * RPT + i;
        const char4 wv = *reinterpret_cast<const char4*>(
            wj + (size_t)rr * CU + k0 + tx * CPT);
        const int8_t wq[CPT] = {wv.x, wv.y, wv.z, wv.w};
        float part = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          if (wq[cc] > 0) {
            const int s = k0 + tx * CPT + cc;
            const float raw = r_sc[rr] + sc_u[s];
            const float e = lrelu(raw, slope);
            const float gp = raw > 0.f ? 1.f : slope;
            const float A = (float)wq[cc] * expf(fminf(e - r_m[rr], 0.f)) /
                            fmaxf(r_l[rr], 1e-20f);
            part += A * (acc[i][cc] - r_c[rr]) * gp;
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 8);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        racc[i] += part;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      atomicAdd(rowsum + row0 + ty * RPT + i, racc[i]);
  }
}

// ---------------------------------------------------------------------------
// K5: backward B1 on the forward layout.  grid (num_tiles, SPLIT).
// g_rows (tiles*TN, D) f32; z (N, D) in T; dst_rows, m_rows, l_rows,
// c_rows (tiles*TN) f32; src (N) f32; ddst (tiles*TN) f32, zeroed.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
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
  __shared__ __align__(16) float smem[SDDMM_SMEM];
  sddmm_rowsum<T>(job_offsets, w_blocks, u_senders, g_rows, z, dcols,
                  dst_rows, src, m_rows, l_rows, c_rows, ddst, blockIdx.x,
                  blockIdx.y, slope, smem);
}

// ---------------------------------------------------------------------------
// K6: backward B2 on the transpose layout.  num_tiles * TN / WARPS blocks
// of count_block::THREADS, one warp per row s (the blocks of a tile are
// neighbours in launch order).
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
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int WARPS = count_block::WARPS;
  constexpr int CHUNK = count_block::FT;   // columns per pass over the jobs
  constexpr int EPL = count_block::EPL;    // of them per lane
  constexpr int LOADS = EPL / V;           // row loads per entry and lane
  constexpr int WPL = CU / 32 / 16;        // 16-byte count loads per lane
  static_assert(TN % WARPS == 0, "layout");

  __shared__ uint32_t lists[WARPS][CU];    // (slot | count << 16) entries

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t row = (size_t)blockIdx.x * WARPS + warp;
  const int tile = (int)(row / TN);
  const int r = (int)(row % TN);
  const int j_begin = job_offsets[tile];
  const int j_end = job_offsets[tile + 1];
  const float sr = src_rows[row];
  uint32_t* list = lists[warp];

  float ds_dot = 0.f;  // sum over this lane's columns and every entry of
                       // coef * z_s[col] * G_r[col]
  float ds_c = 0.f;    // sum over this lane's entries of coef * c_r
  for (int f0 = 0; f0 < dcols; f0 += CHUNK) {
    const int wf = min(CHUNK, dcols - f0);
    bool has[LOADS];
    float zs[EPL], acc[EPL];
#pragma unroll
    for (int h = 0; h < LOADS; ++h) {
      has[h] = h * 32 * V + lane * V < wf;
      float v[V];
      if (has[h])
        count_block::load<V>(z_rows + row * dcols + f0 + h * 32 * V +
                                 lane * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        zs[h * V + k] = has[h] ? v[k] : 0.f;
        acc[h * V + k] = 0.f;
      }
    }
    const float* gs = g + f0 + lane * V;

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
        // lane e: entry e0 + e's receiver, A and coef = A * lrelu'(raw)
        int node = 0;
        float a = 0.f, coef = 0.f;
        if (e0 + lane < total) {
          const uint32_t entry = list[e0 + lane];
          node = __ldg(uj + (entry & 0xffff));
          const float raw = sr + __ldg(dst + node);
          a = (float)(entry >> 16) *
              expf(fminf(lrelu(raw, slope) - __ldg(m + node), 0.f)) /
              fmaxf(__ldg(l + node), 1e-20f);
          coef = raw > 0.f ? a : a * slope;
          if (f0 == 0) ds_c = fmaf(coef, __ldg(c + node), ds_c);
        }
        const int batch = min(32, total - e0);
#pragma unroll 4
        for (int e = 0; e < batch; ++e) {
          const float* p = gs + (int64_t)__shfl_sync(ALL, node, e) * dcols;
          const float ae = __shfl_sync(ALL, a, e);
          const float ce = __shfl_sync(ALL, coef, e);
          float dot = 0.f;
#pragma unroll
          for (int h = 0; h < LOADS; ++h) {
            if (!has[h]) continue;
            float v[V];
            count_block::load<V>(p + h * 32 * V, v);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              acc[h * V + k] = fmaf(ae, v[k], acc[h * V + k]);
              dot = fmaf(zs[h * V + k], v[k], dot);
            }
          }
          ds_dot = fmaf(ce, dot, ds_dot);
        }
      }
      __syncwarp();
    }

    T* o = dz + row * dcols + f0 + lane * V;
#pragma unroll
    for (int h = 0; h < LOADS; ++h)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (has[h]) store_val(o + h * 32 * V + k, acc[h * V + k]);
  }
  float t = ds_dot - ds_c;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(ALL, t, o);
  if (lane == 0) dsrc[row] = t;
}

// The widest V in {4, 2, 1} that divides dcols and to which g (f32) and
// z_rows and dz (T) are aligned.
template <typename T>
int b2_vec(int dcols, const void* g, const void* z_rows, const void* dz) {
  const uintptr_t rows = (uintptr_t)z_rows | (uintptr_t)dz;
  for (int v = 4; v > 1; v /= 2)
    if (dcols % v == 0 && (uintptr_t)g % (v * sizeof(float)) == 0 &&
        rows % (v * sizeof(T)) == 0)
      return v;
  return 1;
}

template <typename T>
int launch_fwd(const void* job_offsets, const void* w_blocks,
               const void* u_senders, const void* z, const void* src,
               const void* dst_rows, void* out, void* m, void* l,
               int num_tiles, int heads, int o, float slope, void* stream) {
  if (num_tiles > 0 && heads > 0 && o > 0) {
    const dim3 grid(num_tiles, heads, (o + FT - 1) / FT);
    gat_fwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
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
    const dim3 grid(num_tiles, SPLIT);
    gat_bwd_b1_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
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
    const int blocks = num_tiles * (TN / count_block::WARPS);
    auto go = [&](auto kernel) {
      kernel<<<blocks, count_block::THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const int32_t*>(job_offsets),
          static_cast<const int8_t*>(w_blocks),
          static_cast<const int32_t*>(u_senders),
          static_cast<const T*>(z_rows), static_cast<const float*>(src_rows),
          static_cast<const float*>(g), static_cast<const float*>(dst),
          static_cast<const float*>(m), static_cast<const float*>(l),
          static_cast<const float*>(c), static_cast<T*>(dz),
          static_cast<float*>(dsrc), dcols, slope);
    };
    const int v = b2_vec<T>(dcols, g, z_rows, dz);
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
// caller; ddst must be zeroed (K5's SDDMM quarters add into it), while K6
// writes every element of dz and dsrc.  Each function returns
// cudaGetLastError().
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
