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
// Streamed and chunked steps (the TPU's
// `admixture_fullstep_biallelic_streamed`, kernels.py:1007 with bodies
// `_bi_istats_kernel` :887 and `_bi_lstats_kernel` :944, and
// `admixture_fullstep_biallelic_chunked`, :829).  On the TPU "unbounded L"
// means p0 streams through VMEM; both passes here already stream p0
// through shared memory.  What a wide and short panel lacks on this card
// is blocks: one rows-pass block per (chain, 32 rows) leaves SMs idle when
// I / 32 is small however large L is.  So:
//
// * segmented rows pass: one block per (chain, 32 rows, column segment)
//   writes its raw A + r [Kp] and t per row as that segment's partials;
// * finish kernel: one warp per row sums the partials in segment order
//   (no atomics; t in float64, since a row's float32 sum over 10^5 loci
//   loses digits that the convergence test reads), adds the a0 seed and
//   either writes the raw A + r (emit_a) or adds c, normalizes and runs
//   the Michelot projection with the static k_true or a runtime kmask;
// * both passes take a column window [l_lo, l_hi) on arrays that keep
//   their full-L strides, so the chunked loop slices nothing; the
//   columns pass's partials cover only the window, which is what bounds
//   its scratch; its epilogue writes the p0 update or, under emit_b, the
//   raw B0/B1 (miss fold included) into full-width outputs.
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

constexpr int ROW_RI = ROW_R / (NT / 32);  // rows per warp, rows passes

// eta rows of a rows-pass block into shared memory, with their sums
template <int KP>
__device__ __forceinline__ void rows_load_eta(
    float (&eta_s)[ROW_R][KP + 1], float (&s_s)[ROW_R],
    const float* __restrict__ eta_b, int row0, int I) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
}

// The rows passes' loop over the columns [c_lo, c_hi) of arrays with row
// stride L.  Warp w owns rows w + 8 i: in the d/w phase lane = column, in
// the A phase lane = cluster (k = lane + 32 j).  Adds into tpart (t, per
// lane), rpart (sum of w1, per lane) and acc ((w0 - w1) @ p0^T); with
// compute_a == 0 only t is wanted and the A phase is skipped.
template <int KP>
__device__ __forceinline__ void rows_accumulate(
    float (&eta_s)[ROW_R][KP + 1], float (&p_s)[KP][ROW_TL + 1],
    float (&w_s)[ROW_R][ROW_TL + 1], float (&s_s)[ROW_R],
    const float* __restrict__ p_b, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, int row0, int I, int L, int c_lo,
    int c_hi, int compute_t, int compute_a, float (&tpart)[ROW_RI],
    float (&rpart)[ROW_RI], float (&acc)[ROW_RI][KP / 32]) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_RI;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    tpart[i] = 0.f;
    rpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
  }

  for (int l0 = c_lo; l0 < c_hi; l0 += ROW_TL) {
    __syncthreads();
    for (int e = tid; e < KP * ROW_TL; e += NT) {
      const int k = e / ROW_TL, cc = e % ROW_TL, col = l0 + cc;
      p_s[k][cc] = col < c_hi ? p_b[(size_t)k * L + col] : 0.f;
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
      if (row < I && col < c_hi) {
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
    if (!compute_a) continue;  // uniform across the block
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
}

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_rows_kernel(
    const float* __restrict__ eta, const float* __restrict__ p0,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const float* __restrict__ c, float* __restrict__ eta_new,
    float* __restrict__ t_out, int I, int L, int k_true, float lb,
    int project, int compute_t) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_RI;
  __shared__ float eta_s[ROW_R][KP + 1];
  __shared__ float p_s[KP][ROW_TL + 1];
  __shared__ float w_s[ROW_R][ROW_TL + 1];
  __shared__ float s_s[ROW_R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROW_R;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  rows_load_eta<KP>(eta_s, s_s, eta_b, row0, I);
  float tpart[RI], rpart[RI], acc[RI][KJ];
  rows_accumulate<KP>(eta_s, p_s, w_s, s_s, p_b, x0, x1, row0, I, L, 0, L,
                      compute_t, 1, tpart, rpart, acc);

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

// Segmented rows pass: block (x = 32 rows, y = column segment, z = chain)
// covers the columns [l_lo + y seg_cols, + seg_cols) of the window
// [l_lo, l_hi) and writes its raw A + r and t as that segment's partials,
// apart [B, n_seg, I, KP] and tpart [B, n_seg, I].
template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_rows_seg_kernel(
    const float* __restrict__ eta, const float* __restrict__ p0,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    float* __restrict__ apart, float* __restrict__ tpart_out, int I, int L,
    int l_lo, int l_hi, int seg_cols, int compute_t, int compute_a) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_RI;
  __shared__ float eta_s[ROW_R][KP + 1];
  __shared__ float p_s[KP][ROW_TL + 1];
  __shared__ float w_s[ROW_R][ROW_TL + 1];
  __shared__ float s_s[ROW_R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int row0 = blockIdx.x * ROW_R;
  const int c_lo = l_lo + seg * seg_cols;
  const int c_hi = min(l_hi, c_lo + seg_cols);
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  rows_load_eta<KP>(eta_s, s_s, eta_b, row0, I);
  float tpart[RI], rpart[RI], acc[RI][KJ];
  rows_accumulate<KP>(eta_s, p_s, w_s, s_s, p_b, x0, x1, row0, I, L, c_lo,
                      c_hi, compute_t, compute_a, tpart, rpart, acc);

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float tt = warp_sum(tpart[i]);
    const float rr = warp_sum(rpart[i]);
    const int row = row0 + warp + 8 * i;
    if (row >= I) continue;  // uniform across the warp
    const size_t o = ((size_t)b * n_seg + seg) * I + row;
    if (compute_a) {
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        apart[o * KP + lane + 32 * j] = acc[i][j] + rr;
    }
    if (lane == 0) tpart_out[o] = tt;
  }
}

// Finish of the segmented rows pass, one warp per row: the segments'
// partials summed in segment order (t in float64), the a0 seed added,
// then either the raw A + r (emit_a: c is not added, the caller finishes)
// or eta' = Michelot(normalize(eta (A + r + c))) over the static lanes
// k < k_true or the runtime kmask.  `out` null: only t is wanted.
template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_finish_kernel(
    const float* __restrict__ eta, const float* __restrict__ apart,
    const float* __restrict__ tpart, const float* __restrict__ a0,
    const float* __restrict__ c, const float* __restrict__ kmask,
    float* __restrict__ out, double* __restrict__ t_out, int I, int n_seg,
    int k_true, float lb, int emit_a, int project_eta, int compute_t) {
  constexpr int KJ = KP / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int row = blockIdx.x * (NT / 32) + warp;
  if (row >= I) return;  // uniform across the warp
  const size_t br = (size_t)b * I + row;
  if (lane == 0) {
    double tt = 0.0;
    if (compute_t)
      for (int s = 0; s < n_seg; ++s)
        tt += (double)tpart[((size_t)b * n_seg + s) * I + row];
    t_out[br] = tt;
  }
  if (out == nullptr) return;
  float a[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    a[j] = a0 != nullptr ? a0[br * KP + lane + 32 * j] : 0.f;
  for (int s = 0; s < n_seg; ++s) {
    const float* ap = apart + (((size_t)b * n_seg + s) * I + row) * KP;
#pragma unroll
    for (int j = 0; j < KJ; ++j) a[j] += ap[lane + 32 * j];
  }
  float* o = out + br * KP;
  if (emit_a) {
#pragma unroll
    for (int j = 0; j < KJ; ++j) o[lane + 32 * j] = a[j];
    return;
  }
  const float ci = c[row];
  float e[KJ], num[KJ], part = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    e[j] = eta[br * KP + lane + 32 * j];
    num[j] = e[j] * (a[j] + ci);
    part += num[j];
  }
  const float tot = warp_sum(part);
#pragma unroll
  for (int j = 0; j < KJ; ++j) num[j] = tot > 0.f ? num[j] / tot : e[j];
  if (project_eta) {
    bool valid[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      valid[j] = kmask != nullptr ? kmask[k] > 0.5f : k < k_true;
    }
    mc::michelot_warp_mask<KJ>(num, valid, lb);
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) o[lane + 32 * j] = num[j];
}

template <int KP>
__global__ void __launch_bounds__(NT) fullstep_bi_cols_kernel(
    const float* __restrict__ eta, const float* __restrict__ p0,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const int8_t* __restrict__ miss, float* __restrict__ part, int I,
    int L, int l_lo, int l_hi, int seg_rows) {
  constexpr int KJ = KP / 16;
  constexpr int RG = COL_RI / (NT / COL_TC);  // rows per thread, d/w phase
  __shared__ float p_s[KP][COL_TC + 1];
  __shared__ float eta_s[COL_RI][KP + 1];
  __shared__ float w0_s[COL_RI][COL_TC + 1];
  __shared__ float w1_s[COL_RI][COL_TC + 1];
  __shared__ float s_s[COL_RI];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = l_lo + blockIdx.x * COL_TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  // thread owns column cl; in the d/w phase rows g + 16 i, in the B phase
  // clusters k = g + 16 j
  const int cl = tid % COL_TC, g = tid / COL_TC, col = col0 + cl;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  for (int e = tid; e < KP * COL_TC; e += NT) {
    const int k = e / COL_TC, cc = e % COL_TC, cg = col0 + cc;
    p_s[k][cc] = cg < l_hi ? p_b[(size_t)k * L + cg] : 0.f;
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
      if (row < r_hi && col < l_hi) {
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

  if (col >= l_hi) return;
  // part[b][seg][allele][k][column of the window]
  const size_t W = (size_t)(l_hi - l_lo);
  float* out = part + ((size_t)b * n_seg + seg) * 2 * KP * W;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const size_t kw = (size_t)(g + 16 * j) * W + (col - l_lo);
    out[kw] = acc0[j];
    out[(size_t)KP * W + kw] = acc1[j];
  }
}

// p0' epilogue over the window [l_lo, l_lo + W): B0/B1 = the segments'
// partials summed in segment order (deterministic), then p0' = clip(p0 B0
// / (p0 B0 + (1 - p0) B1)), or under emit_b the raw B0/B1, written at the
// window's columns of full-width [B, Kp, L] outputs.
__global__ void __launch_bounds__(NT) fullstep_bi_p0_kernel(
    const float* __restrict__ p0, const float* __restrict__ part,
    float* __restrict__ p0_new, float* __restrict__ b0_out,
    float* __restrict__ b1_out, int Kp, int L, int l_lo, int W, int n_seg,
    float plb, float pub, int project) {
  const int b = blockIdx.y;
  const size_t KW = (size_t)Kp * W;
  const size_t kw = (size_t)blockIdx.x * NT + threadIdx.x;
  if (kw >= KW) return;
  const float* pb = part + (size_t)b * n_seg * 2 * KW + kw;
  float b0 = 0.f, b1 = 0.f;
  for (int s = 0; s < n_seg; ++s) {
    b0 += pb[(size_t)(2 * s) * KW];
    b1 += pb[(size_t)(2 * s + 1) * KW];
  }
  const size_t o =
      ((size_t)b * Kp + kw / W) * L + l_lo + kw % W;
  if (b0_out != nullptr) {
    b0_out[o] = b0;
    b1_out[o] = b1;
    return;
  }
  const float p = p0[o];
  const float pc0 = p * b0, pc1 = (1.f - p) * b1;
  const float tot = pc0 + pc1;
  float q = tot > 0.f ? pc0 / tot : 0.f;
  if (project && tot > 0.f) q = fminf(fmaxf(q, plb), pub);
  p0_new[o] = q;
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

// Segmented rows pass over the window [l_lo, l_hi) in n_seg segments of
// seg_cols columns (n_seg <= 65535, the grid's y limit).
extern "C" int mc_fullstep_bi_rows_seg(const void* eta, const void* p0,
                                       const void* x0, const void* x1,
                                       void* apart, void* tpart, int B,
                                       int I, int L, int Kp, int l_lo,
                                       int l_hi, int seg_cols, int n_seg,
                                       int compute_t, int compute_a,
                                       void* stream) {
  const dim3 grid((I + ROW_R - 1) / ROW_R, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  float* ap = (float*)apart;
  float* tp = (float*)tpart;
#define MC_ROWS_SEG(KP)                                                  \
  fullstep_bi_rows_seg_kernel<KP><<<grid, NT, 0, s>>>(                   \
      e, p, a, z, ap, tp, I, L, l_lo, l_hi, seg_cols, compute_t, compute_a)
  switch (Kp) {
    case 32: MC_ROWS_SEG(32); break;
    case 64: MC_ROWS_SEG(64); break;
    case 96: MC_ROWS_SEG(96); break;
    case 128: MC_ROWS_SEG(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_ROWS_SEG
  return (int)cudaGetLastError();
}

// Finish of the segmented rows pass; a0, kmask and out may be null.
extern "C" int mc_fullstep_bi_finish(const void* eta, const void* apart,
                                     const void* tpart, const void* a0,
                                     const void* c, const void* kmask,
                                     void* out, void* t_out, int B, int I,
                                     int Kp, int n_seg, int k_true,
                                     float lb, int emit_a, int project_eta,
                                     int compute_t, void* stream) {
  const dim3 grid((I + NT / 32 - 1) / (NT / 32), B);
  cudaStream_t s = (cudaStream_t)stream;
#define MC_FINISH(KP)                                                     \
  fullstep_bi_finish_kernel<KP><<<grid, NT, 0, s>>>(                      \
      (const float*)eta, (const float*)apart, (const float*)tpart,        \
      (const float*)a0, (const float*)c, (const float*)kmask, (float*)out, \
      (double*)t_out, I, n_seg, k_true, lb, emit_a, project_eta, compute_t)
  switch (Kp) {
    case 32: MC_FINISH(32); break;
    case 64: MC_FINISH(64); break;
    case 96: MC_FINISH(96); break;
    case 128: MC_FINISH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_FINISH
  return (int)cudaGetLastError();
}

// Columns pass and epilogue over the window [l_lo, l_hi); `part` holds
// [B, n_seg, 2, Kp, l_hi - l_lo].  b0_out/b1_out non-null: the epilogue
// writes the raw B0/B1 there instead of the p0 update (emit_b).
extern "C" int mc_fullstep_bi_cols(const void* eta, const void* p0,
                                   const void* x0, const void* x1,
                                   const void* miss, void* part,
                                   void* p0_new, void* b0_out, void* b1_out,
                                   int B, int I, int L, int Kp, int l_lo,
                                   int l_hi, int n_seg, int seg_rows,
                                   float plb, float pub, int project,
                                   void* stream) {
  const int W = l_hi - l_lo;
  const dim3 grid((W + COL_TC - 1) / COL_TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const int8_t* m = (const int8_t*)miss;
  float* pt = (float*)part;
#define MC_COLS(KP)                                                  \
  fullstep_bi_cols_kernel<KP><<<grid, NT, 0, s>>>(e, p, a, z, m, pt, \
                                                  I, L, l_lo, l_hi,  \
                                                  seg_rows)
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
  const size_t KW = (size_t)Kp * W;
  const dim3 grid2((unsigned)((KW + NT - 1) / NT), B);
  fullstep_bi_p0_kernel<<<grid2, NT, 0, s>>>(
      p, pt, (float*)p0_new, (float*)b0_out, (float*)b1_out, Kp, L, l_lo, W,
      n_seg, plb, pub, project);
  return (int)cudaGetLastError();
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
