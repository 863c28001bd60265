// Generic (multi-allelic) admixture full EM step for Hopper (sm_90a): a
// rows pass, a columns pass and a p epilogue.
//
// Replaces the Pallas TPU kernels `admixture_fullstep` / `_fullstep_kernel`
// (multiclust_tpu/ops/kernels.py:200-341) and, with `finish` = 0, the
// sweep statistics `admixture_sweep_fused` / `_fused_kernel` (:1479-1552)
// and `admixture_sweep_stats` / `_istats_kernel`, `_lstats_kernel`
// (:1555-1651).  Over the L*M allele lanes j of chain b:
//
//   denom = eta @ p2,  w = x / denom where x > 0 (0 elsewhere)
//   t_i = sum_j x log(denom) where x > 0
//   A = w @ p2^T (+ a0),  eta' = Michelot(normalize(eta * (A + c)))
//   B[k, j] = sum_i eta_ik (w_ij + miss_i,l(j))
//   p' = Michelot_l(mask * p B / sum_m p B)   per (k, locus l), pads 0
//
// The generic path masks x > 0 instead of clamping the denominator
// (kernels.py:226-229): where x > 0 a zero denominator counts as 1, so
// padded and masked lanes stay free of NaN.
//
// The TPU runs its grid in order and keeps B resident in VMEM across all
// row blocks.  Hopper blocks run concurrently, so the step is split the
// way csrc/fullstep_bi.cu splits the biallelic one, with no atomics
// (deterministic):
//
// * rows pass: one block per (chain, 32 rows); loops over all L*M lanes
//   in 32-lane tiles with the p2 tile in shared memory, keeps A and t in
//   registers, and finishes eta' with one warp per row (lane = cluster).
//   eta' goes to a new buffer because the columns pass reads the old eta.
//   `finish` = 0 writes the raw A (no c, no finish) for a0 chaining and
//   the sweep statistics.
// * columns pass: one block per (chain, row segment, 16 lanes); loops
//   over its segment of I in 32-row tiles, recomputes denom and w (+ the
//   locus's miss count), keeps B [Kp, 16] in registers and writes it as
//   the segment's partial sums.
// * p epilogue: one aligned group of G lanes per (chain, k, locus) sums
//   the partials in segment order, forms p B, normalizes over the valid
//   lanes and runs the masked Michelot with plb on the card, keeping the
//   K-pad rows exactly 0 (`_normalize_p`, model/admixture.py:72-88, which
//   JAX runs in XLA after the kernel).  `finish` = 0 writes raw B instead.
//
// Bound: four contractions of I x L*M x Kp per step (denom twice, A, B),
// in IEEE f32 FMA on the CUDA cores (no TF32); x is one byte per lane and
// is read twice.  The step is bound by FMA and shared-memory issue, not by
// device memory.  Not exploited yet: x is zero on at least M - ploidy of
// each locus's M lanes, and there w and t vanish; the TPU computes the
// dense product anyway, and so does this first port.
//
// Ragged I and L*M edges are masked here; the caller pads only K, to Kp in
// {32, 64, 96, 128}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "simplex.cuh"

namespace {

constexpr int NT = 256;       // threads per block, every kernel
constexpr int ROW_R = 32;     // rows per rows-pass block
constexpr int ROW_TL = 32;    // lanes per rows-pass tile
constexpr int COL_TC = 16;    // lanes per columns-pass block
constexpr int COL_RI = 32;    // rows per columns-pass tile

using mc::michelot_warp;
using mc::warp_sum;

// x / denom and x log(denom) where x > 0; a zero denominator counts as 1
__device__ __forceinline__ float lane_weight(int x, float d) {
  return x > 0 ? (float)x / (d > 0.f ? d : 1.f) : 0.f;
}

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_rows_kernel(
    const float* __restrict__ eta, const float* __restrict__ p2,
    const int8_t* __restrict__ x2, const float* __restrict__ c,
    const float* __restrict__ a0, float* __restrict__ out,
    float* __restrict__ t_out, int I, int LM, int k_true, float lb,
    int project, int compute_t, int finish) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_R / (NT / 32);  // rows per warp
  __shared__ float eta_s[ROW_R][KP + 1];
  __shared__ float p_s[KP][ROW_TL + 1];
  __shared__ float w_s[ROW_R][ROW_TL + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROW_R;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p2 + (size_t)b * KP * LM;

  for (int e = tid; e < ROW_R * KP; e += NT) {
    const int r = e / KP, k = e % KP, row = row0 + r;
    eta_s[r][k] = row < I ? eta_b[(size_t)row * KP + k] : 0.f;
  }

  // warp w owns rows w + 8 i: in the denom/w phase lane = allele lane,
  // in the A phase and the eta finish lane = cluster (k = lane + 32 j)
  float tpart[RI], acc[RI][KJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    tpart[i] = 0.f;
    const int row = row0 + warp + 8 * i;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      acc[i][j] = (a0 != nullptr && row < I)
                      ? a0[((size_t)b * I + row) * KP + lane + 32 * j]
                      : 0.f;
  }

  for (int l0 = 0; l0 < LM; l0 += ROW_TL) {
    __syncthreads();
    for (int e = tid; e < KP * ROW_TL; e += NT) {
      const int k = e / ROW_TL, cc = e % ROW_TL, col = l0 + cc;
      p_s[k][cc] = col < LM ? p_b[(size_t)k * LM + col] : 0.f;
    }
    __syncthreads();
    float d[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) d[i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < KP; ++k) {
      const float pv = p_s[k][lane];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        d[i] = fmaf(eta_s[warp + 8 * i][k], pv, d[i]);
    }
    const int col = l0 + lane;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = warp + 8 * i, row = row0 + r;
      float w = 0.f;
      if (row < I && col < LM) {
        const int x = x2[(size_t)row * LM + col];
        w = lane_weight(x, d[i]);
        if (compute_t && x > 0)
          tpart[i] += (float)x * logf(d[i] > 0.f ? d[i] : 1.f);
      }
      w_s[r][lane] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < ROW_TL; ++cc) {
      float wv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) wv[i] = w_s[warp + 8 * i][cc];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pv = p_s[lane + 32 * j][cc];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(wv[i], pv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float tt = warp_sum(tpart[i]);
    const int r = warp + 8 * i, row = row0 + r;
    if (row >= I) continue;  // uniform across the warp
    float* o = out + ((size_t)b * I + row) * KP;
    if (lane == 0) t_out[(size_t)b * I + row] = compute_t ? tt : 0.f;
    if (!finish) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) o[lane + 32 * j] = acc[i][j];
      continue;
    }
    const float ci = c != nullptr ? c[row] : 0.f;
    float num[KJ], part = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      num[j] = eta_s[r][lane + 32 * j] * (acc[i][j] + ci);
      part += num[j];
    }
    const float tot = warp_sum(part);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      num[j] = tot > 0.f ? num[j] / tot : eta_s[r][lane + 32 * j];
    if (project) michelot_warp<KJ>(num, lane, k_true, lb);
#pragma unroll
    for (int j = 0; j < KJ; ++j) o[lane + 32 * j] = num[j];
  }
}

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_cols_kernel(
    const float* __restrict__ eta, const float* __restrict__ p2,
    const int8_t* __restrict__ x2, const int8_t* __restrict__ miss,
    float* __restrict__ part, int I, int L, int M, int seg_rows) {
  constexpr int KJ = KP / 16;
  constexpr int RG = COL_RI / (NT / COL_TC);  // rows per thread, w phase
  __shared__ float p_s[KP][COL_TC + 1];
  __shared__ float eta_s[COL_RI][KP + 1];
  __shared__ float w_s[COL_RI][COL_TC + 1];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int LM = L * M;
  const int col0 = blockIdx.x * COL_TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  // thread owns lane cl; in the w phase rows g + 16 i, in the B phase
  // clusters k = g + 16 j
  const int cl = tid % COL_TC, g = tid / COL_TC, col = col0 + cl;
  const int locus = col / M;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p2 + (size_t)b * KP * LM;

  for (int e = tid; e < KP * COL_TC; e += NT) {
    const int k = e / COL_TC, cc = e % COL_TC, cg = col0 + cc;
    p_s[k][cc] = cg < LM ? p_b[(size_t)k * LM + cg] : 0.f;
  }
  float acc[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) acc[j] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += COL_RI) {
    __syncthreads();
    for (int e = tid; e < COL_RI * KP; e += NT) {
      const int r = e / KP, k = e % KP, row = r0 + r;
      eta_s[r][k] = row < r_hi ? eta_b[(size_t)row * KP + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = g + (NT / COL_TC) * i, row = r0 + r;
      float d = 0.f;
#pragma unroll 8
      for (int k = 0; k < KP; ++k) d = fmaf(eta_s[r][k], p_s[k][cl], d);
      float w = 0.f;
      if (row < r_hi && col < LM) {
        w = lane_weight(x2[(size_t)row * LM + col], d);
        if (miss != nullptr) w += (float)miss[(size_t)row * L + locus];
      }
      w_s[r][cl] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < COL_RI; ++r) {
      const float wv = w_s[r][cl];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        acc[j] = fmaf(eta_s[r][g + 16 * j], wv, acc[j]);
    }
  }

  if (col >= LM) return;
  // part[b][seg][k][j]
  float* o = part + ((size_t)b * n_seg + seg) * KP * LM;
#pragma unroll
  for (int j = 0; j < KJ; ++j) o[(size_t)(g + 16 * j) * LM + col] = acc[j];
}

// p epilogue: one aligned group of G lanes per (chain, k, locus); lane g
// owns the allele slots m = g + G j.  B = the segments' partials summed
// in segment order (deterministic).
template <int G, int MJ>
__global__ void __launch_bounds__(NT) fullstep_p_kernel(
    const float* __restrict__ p2, const float* __restrict__ part,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int Kp,
    int L, int M, int n_seg, int k_true, float plb, int project,
    int finish) {
  const int b = blockIdx.y;
  const int g = threadIdx.x % G;
  const int row = blockIdx.x * (NT / G) + threadIdx.x / G;  // k * L + l
  const bool live = row < Kp * L;
  const int k = live ? row / L : 0, l = live ? row % L : 0;
  const size_t KLM = (size_t)Kp * L * M;
  const size_t off = (size_t)b * KLM + (size_t)row * M;  // [b][k][l][m]
  const float* pp = part + (size_t)b * n_seg * KLM + (size_t)row * M;

  float v[MJ];
  bool fr[MJ];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int m = g + G * j;
    const bool in = live && m < M;
    float bm = 0.f;
    if (in)
      for (int q = 0; q < n_seg; ++q) bm += pp[(size_t)q * KLM + m];
    if (!finish) {
      if (in) out[off + m] = bm;
      continue;
    }
    v[j] = in ? p2[off + m] * bm : 0.f;
    s += v[j];
    fr[j] = in && mask[(size_t)l * M + m] != 0;
  }
  if (!finish) return;  // uniform: the flag is the launch's
  const float tot = mc::group_sum<G>(s);
#pragma unroll
  for (int j = 0; j < MJ; ++j)
    v[j] = (fr[j] && tot > 0.f) ? v[j] / tot : 0.f;
  if (project) {
    mc::michelot_group<G, MJ>(v, fr, plb);
    if (k >= k_true) {
#pragma unroll
      for (int j = 0; j < MJ; ++j) v[j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int m = g + G * j;
    if (live && m < M) out[off + m] = v[j];
  }
}

}  // namespace

// Plain C interface, bound with ctypes (ops/build.py).  Pointers are
// device pointers, optional ones may be null; `stream` is a cudaStream_t.
// Each returns the cudaGetLastError() of its launch.

extern "C" int mc_fullstep_rows(const void* eta, const void* p2,
                                const void* x2, const void* c,
                                const void* a0, void* out, void* t_out,
                                int B, int I, int LM, int Kp, int k_true,
                                float lb, int project, int compute_t,
                                int finish, void* stream) {
  const dim3 grid((I + ROW_R - 1) / ROW_R, 1, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p2;
  const int8_t* x = (const int8_t*)x2;
  const float* cc = (const float*)c;
  const float* a = (const float*)a0;
  float* o = (float*)out;
  float* t = (float*)t_out;
#define MC_ROWS(KP)                                                        \
  fullstep_rows_kernel<KP><<<grid, NT, 0, s>>>(e, p, x, cc, a, o, t, I, LM, \
                                               k_true, lb, project,        \
                                               compute_t, finish)
  switch (Kp) {
    case 32: MC_ROWS(32); break;
    case 64: MC_ROWS(64); break;
    case 96: MC_ROWS(96); break;
    case 128: MC_ROWS(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_ROWS
  return (int)cudaGetLastError();
}

extern "C" int mc_fullstep_cols(const void* eta, const void* p2,
                                const void* x2, const void* miss,
                                void* part, int B, int I, int L, int M,
                                int Kp, int n_seg, int seg_rows,
                                void* stream) {
  const dim3 grid((L * M + COL_TC - 1) / COL_TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p2;
  const int8_t* x = (const int8_t*)x2;
  const int8_t* m = (const int8_t*)miss;
  float* pt = (float*)part;
#define MC_COLS(KP)                                                 \
  fullstep_cols_kernel<KP><<<grid, NT, 0, s>>>(e, p, x, m, pt, I, L, \
                                               M, seg_rows)
  switch (Kp) {
    case 32: MC_COLS(32); break;
    case 64: MC_COLS(64); break;
    case 96: MC_COLS(96); break;
    case 128: MC_COLS(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_COLS
  return (int)cudaGetLastError();
}

// M <= 1024: G lanes per (k, locus) row, MJ slots per lane
extern "C" int mc_fullstep_p(const void* p2, const void* part,
                             const void* mask, void* out, int B, int Kp,
                             int L, int M, int n_seg, int k_true, float plb,
                             int project, int finish, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)p2;
  const float* pt = (const float*)part;
  const uint8_t* mk = (const uint8_t*)mask;
  float* o = (float*)out;
  const int rows = Kp * L;
#define MC_P(G, MJ)                                                      \
  fullstep_p_kernel<G, MJ>                                               \
      <<<dim3((rows + NT / G - 1) / (NT / G), B), NT, 0, s>>>(           \
          p, pt, mk, o, Kp, L, M, n_seg, k_true, plb, project, finish)
  if (M <= 4) MC_P(4, 1);
  else if (M <= 8) MC_P(8, 1);
  else if (M <= 16) MC_P(16, 1);
  else if (M <= 32) MC_P(32, 1);
  else if (M <= 64) MC_P(32, 2);
  else if (M <= 128) MC_P(32, 4);
  else if (M <= 256) MC_P(32, 8);
  else if (M <= 1024) MC_P(32, 32);
  else return (int)cudaErrorInvalidValue;
#undef MC_P
  return (int)cudaGetLastError();
}
