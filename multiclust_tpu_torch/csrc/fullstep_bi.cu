// Biallelic admixture full EM step for Hopper (sm_90a): a rows pass and
// a columns pass.
//
// Replaces the Pallas TPU kernel `admixture_fullstep_biallelic` /
// `_fullstep_bi_kernel` (multiclust_tpu/ops/kernels.py:344-615, with its
// helper `_michelot_tile` at :154).  One call computes, per chain b:
//
//   d0 = eta @ p0, d1 = rowsum(eta) - d0   (both clamped to >= 1e-30)
//   w0 = x0 / d0, w1 = x1 / d1             (never written to memory)
//   t_i = sum_l x0 log d0 + x1 log d1
//   A = (w0 - w1) @ p0^T + sum_l w1 + c
//   eta' = Michelot(normalize(eta * A))   over lanes < k_true, lb
//   B0 = eta^T (w0 + miss), B1 = eta^T (w1 + miss)
//   p0' = clip(p0 B0 / (p0 B0 + (1 - p0) B1), plb, pub)
//
// The TPU runs its grid in order and keeps B0/B1 resident in VMEM across
// all row blocks.  Hopper blocks run concurrently, so the step is split
// into two passes that each read x once, with no atomics (deterministic):
//
// * rows pass: one block per (chain, 32 rows); loops over all L in
//   32-column tiles with the p0 tile in shared memory, keeps A, sum w1 and
//   t in registers, and finishes eta' with one warp per row (normalize,
//   then Michelot with warp shuffles).  eta' goes to a new buffer because
//   the columns pass reads the old eta.
// * columns pass: one block per (chain, row segment, 16 columns); loops
//   over its segment of I in 32-row tiles, recomputes d and w (+ miss),
//   keeps B0/B1 [Kp, 16] in registers and writes them as the segment's
//   partial sums; a small epilogue kernel adds the partials in segment
//   order and applies the p0' update.  The caller picks the segment count
//   so that the grid fills the card even for one chain.
//
// Bound: three contractions of I x L x Kp per pass pair (d0 twice, A, and
// B0/B1 as two), all in IEEE f32 FMA on the CUDA cores (no TF32), so the
// step is bound by f32 FMA and shared-memory issue rate, not by device
// memory: x is 2-3 bytes per cell and is read twice (once per pass),
// against once on the TPU.  Ragged I and L edges are masked here; the
// caller pads only K, to Kp in {32, 64, 96, 128}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "simplex.cuh"

namespace {

constexpr int NT = 256;       // threads per block, both passes
constexpr int ROW_R = 32;     // rows per rows-pass block
constexpr int ROW_TL = 32;    // columns per rows-pass tile
constexpr int COL_TC = 16;    // columns per columns-pass block
constexpr int COL_RI = 32;    // rows per columns-pass tile
constexpr float DMIN = 1e-30f;

using mc::michelot_warp;
using mc::warp_sum;

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_rows_kernel(
    const float* __restrict__ eta, const float* __restrict__ p0,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const float* __restrict__ c, float* __restrict__ eta_new,
    float* __restrict__ t_out, int I, int L, int k_true, float lb,
    int project, int compute_t) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_R / (NT / 32);  // rows per warp
  __shared__ float eta_s[ROW_R][KP + 1];
  __shared__ float p_s[KP][ROW_TL + 1];
  __shared__ float w_s[ROW_R][ROW_TL + 1];
  __shared__ float s_s[ROW_R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROW_R;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  for (int e = tid; e < ROW_R * KP; e += NT) {
    const int r = e / KP, k = e % KP, row = row0 + r;
    eta_s[r][k] = row < I ? eta_b[(size_t)row * KP + k] : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < ROW_R; r += NT / 32) {
    float v = 0.f;
    for (int k = lane; k < KP; k += 32) v += eta_s[r][k];
    v = warp_sum(v);
    if (lane == 0) s_s[r] = v;
  }

  // warp w owns rows w + 8 i: in the d/w phase lane = column, in the A
  // phase and the eta finish lane = cluster (k = lane + 32 j)
  float tpart[RI], rpart[RI], acc[RI][KJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    tpart[i] = 0.f;
    rpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += ROW_TL) {
    __syncthreads();
    for (int e = tid; e < KP * ROW_TL; e += NT) {
      const int k = e / ROW_TL, cc = e % ROW_TL, col = l0 + cc;
      p_s[k][cc] = col < L ? p_b[(size_t)k * L + col] : 0.f;
    }
    __syncthreads();
    float d0[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) d0[i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < KP; ++k) {
      const float pv = p_s[k][lane];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        d0[i] = fmaf(eta_s[warp + 8 * i][k], pv, d0[i]);
    }
    const int col = l0 + lane;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = warp + 8 * i, row = row0 + r;
      float w = 0.f;
      if (row < I && col < L) {
        const size_t off = (size_t)row * L + col;
        const float a0 = (float)x0[off], a1 = (float)x1[off];
        const float dd0 = fmaxf(d0[i], DMIN);
        const float dd1 = fmaxf(s_s[r] - d0[i], DMIN);
        const float w0 = a0 / dd0, w1 = a1 / dd1;
        if (compute_t) tpart[i] += a0 * logf(dd0) + a1 * logf(dd1);
        rpart[i] += w1;
        w = w0 - w1;
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
    const float rr = warp_sum(rpart[i]);
    const int r = warp + 8 * i, row = row0 + r;
    if (row >= I) continue;  // uniform across the warp
    const float ci = c[row];
    float num[KJ], part = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      num[j] = eta_s[r][lane + 32 * j] * (acc[i][j] + rr + ci);
      part += num[j];
    }
    const float tot = warp_sum(part);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      num[j] = tot > 0.f ? num[j] / tot : eta_s[r][lane + 32 * j];
    if (project) michelot_warp<KJ>(num, lane, k_true, lb);
    float* out = eta_new + ((size_t)b * I + row) * KP;
#pragma unroll
    for (int j = 0; j < KJ; ++j) out[lane + 32 * j] = num[j];
    if (lane == 0) t_out[(size_t)b * I + row] = compute_t ? tt : 0.f;
  }
}

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_cols_kernel(
    const float* __restrict__ eta, const float* __restrict__ p0,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const int8_t* __restrict__ miss, float* __restrict__ part, int I,
    int L, int seg_rows) {
  constexpr int KJ = KP / 16;
  constexpr int RG = COL_RI / (NT / COL_TC);  // rows per thread, d/w phase
  __shared__ float p_s[KP][COL_TC + 1];
  __shared__ float eta_s[COL_RI][KP + 1];
  __shared__ float w0_s[COL_RI][COL_TC + 1];
  __shared__ float w1_s[COL_RI][COL_TC + 1];
  __shared__ float s_s[COL_RI];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = blockIdx.x * COL_TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  // thread owns column cl; in the d/w phase rows g + 16 i, in the B phase
  // clusters k = g + 16 j
  const int cl = tid % COL_TC, g = tid / COL_TC, col = col0 + cl;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  for (int e = tid; e < KP * COL_TC; e += NT) {
    const int k = e / COL_TC, cc = e % COL_TC, cg = col0 + cc;
    p_s[k][cc] = cg < L ? p_b[(size_t)k * L + cg] : 0.f;
  }
  float acc0[KJ], acc1[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    acc0[j] = 0.f;
    acc1[j] = 0.f;
  }

  for (int r0 = r_lo; r0 < r_hi; r0 += COL_RI) {
    __syncthreads();
    for (int e = tid; e < COL_RI * KP; e += NT) {
      const int r = e / KP, k = e % KP, row = r0 + r;
      eta_s[r][k] = row < r_hi ? eta_b[(size_t)row * KP + k] : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < COL_RI; r += NT / 32) {
      float v = 0.f;
      for (int k = lane; k < KP; k += 32) v += eta_s[r][k];
      v = warp_sum(v);
      if (lane == 0) s_s[r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = g + (NT / COL_TC) * i, row = r0 + r;
      float d0 = 0.f;
#pragma unroll 8
      for (int k = 0; k < KP; ++k) d0 = fmaf(eta_s[r][k], p_s[k][cl], d0);
      float w0 = 0.f, w1 = 0.f;
      if (row < r_hi && col < L) {
        const size_t off = (size_t)row * L + col;
        const float m = miss != nullptr ? (float)miss[off] : 0.f;
        w0 = (float)x0[off] / fmaxf(d0, DMIN) + m;
        w1 = (float)x1[off] / fmaxf(s_s[r] - d0, DMIN) + m;
      }
      w0_s[r][cl] = w0;
      w1_s[r][cl] = w1;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < COL_RI; ++r) {
      const float wa = w0_s[r][cl], wb = w1_s[r][cl];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = eta_s[r][g + 16 * j];
        acc0[j] = fmaf(e, wa, acc0[j]);
        acc1[j] = fmaf(e, wb, acc1[j]);
      }
    }
  }

  if (col >= L) return;
  // part[b][seg][allele][k][l]
  float* out = part + ((size_t)b * n_seg + seg) * 2 * KP * L;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const size_t kl = (size_t)(g + 16 * j) * L + col;
    out[kl] = acc0[j];
    out[(size_t)KP * L + kl] = acc1[j];
  }
}

// p0' epilogue: B0/B1 = the segments' partials summed in segment order
// (deterministic), then p0' = clip(p0 B0 / (p0 B0 + (1 - p0) B1)).
__global__ void __launch_bounds__(NT) fullstep_bi_p0_kernel(
    const float* __restrict__ p0, const float* __restrict__ part,
    float* __restrict__ p0_new, int KL, int n_seg, float plb, float pub,
    int project) {
  const int b = blockIdx.y;
  const int kl = blockIdx.x * NT + threadIdx.x;
  if (kl >= KL) return;
  const float* pb = part + (size_t)b * n_seg * 2 * KL + kl;
  float b0 = 0.f, b1 = 0.f;
  for (int s = 0; s < n_seg; ++s) {
    b0 += pb[(size_t)(2 * s) * KL];
    b1 += pb[(size_t)(2 * s + 1) * KL];
  }
  const float p = p0[(size_t)b * KL + kl];
  const float pc0 = p * b0, pc1 = (1.f - p) * b1;
  const float tot = pc0 + pc1;
  float q = tot > 0.f ? pc0 / tot : 0.f;
  if (project && tot > 0.f) q = fminf(fmaxf(q, plb), pub);
  p0_new[(size_t)b * KL + kl] = q;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/build.py).  Pointers are
// device pointers; `stream` is a cudaStream_t.  Each returns the
// cudaGetLastError() of its launch.

extern "C" int mc_fullstep_bi_rows(const void* eta, const void* p0,
                                   const void* x0, const void* x1,
                                   const void* c, void* eta_new, void* t_out,
                                   int B, int I, int L, int Kp, int k_true,
                                   float lb, int project, int compute_t,
                                   void* stream) {
  const dim3 grid((I + ROW_R - 1) / ROW_R, 1, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const float* cc = (const float*)c;
  float* en = (float*)eta_new;
  float* t = (float*)t_out;
#define MC_ROWS(KP)                                                       \
  fullstep_bi_rows_kernel<KP><<<grid, NT, 0, s>>>(e, p, a, z, cc, en, t, \
                                                  I, L, k_true, lb,      \
                                                  project, compute_t)
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

extern "C" int mc_fullstep_bi_cols(const void* eta, const void* p0,
                                   const void* x0, const void* x1,
                                   const void* miss, void* part,
                                   void* p0_new, int B, int I, int L, int Kp,
                                   int n_seg, int seg_rows, float plb,
                                   float pub, int project, void* stream) {
  const dim3 grid((L + COL_TC - 1) / COL_TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const int8_t* m = (const int8_t*)miss;
  float* pt = (float*)part;
#define MC_COLS(KP)                                                  \
  fullstep_bi_cols_kernel<KP><<<grid, NT, 0, s>>>(e, p, a, z, m, pt, \
                                                  I, L, seg_rows)
  switch (Kp) {
    case 32: MC_COLS(32); break;
    case 64: MC_COLS(64); break;
    case 96: MC_COLS(96); break;
    case 128: MC_COLS(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_COLS
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int KL = Kp * L;
  const dim3 grid2((KL + NT - 1) / NT, B);
  fullstep_bi_p0_kernel<<<grid2, NT, 0, s>>>(p, pt, (float*)p0_new, KL,
                                             n_seg, plb, pub, project);
  return (int)cudaGetLastError();
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
