// Biallelic mixture EM step for Hopper (sm_90a): a rows pass, a columns
// pass, an eta finish and a p0 epilogue.
//
// Replaces the Pallas TPU kernels `mixture_fullstep_biallelic` /
// `_mix_scores_kernel`, `_mix_counts_kernel`
// (multiclust_tpu/ops/kernels.py:1139-1313) and, with `finish` = 0, the
// single-pass sweep `mixture_sweep_resident` / `_mix_resident_kernel`
// (:1316-1415).  Over the loci l of chain b, with lp0/lp1 [Kp, L] and the
// bias [Kp] built by the caller (model/mixture.py):
//
//   s_ik = sum_l x0_il lp0_kl (+ x1_il lp1_kl) + bias_k
//   v_ik = softmax_k(s_i),  t_i = logsumexp_k(s_i)
//   B0 = v^T x0 (B1 = v^T x1),  vtot_k = sum_i v_ik
//   eta' = Michelot(vtot / sum vtot)   over lanes < k_true, lb
//   p0' = clip((B0 + plb) / ((B0 + plb) + pc1), plb, pub),
//   pc1 = B1 + plb, or ploidy vtot - B0 + plb when x1 = ploidy - x0
//
// Missing-free panels stream x0 alone: the caller folds x1 = ploidy - x0
// into lp0 = log p0 - log p1 and bias = ploidy sum_l log p1 + log eta.
// Panels with missing data stream both planes (lp0 = log p0, lp1 = log p1,
// bias = log eta).  K-pad lanes carry lp 0 and bias -1e30, so their
// posterior mass is exactly 0.
//
// The TPU runs its grid in order and keeps B0/B1 in VMEM across the row
// blocks.  Hopper blocks run concurrently, so the step is split the way
// csrc/fullstep_bi.cu splits the admixture one, with no atomics
// (deterministic):
//
// * rows pass: one block per (chain, 64 rows); loops over L in 16-locus
//   tiles (x tile and transposed lp tile in shared memory), keeps the
//   scores in registers with lane = cluster, and finishes the softmax and
//   the logsumexp with warp shuffles.  Writes v [B, I, Kp] and t [B, I].
// * columns pass: one block per (chain, row segment, 128 loci); loops over
//   its segment of I in 16-row tiles, each thread an outer-product tile of
//   Kp/8 clusters by 4 loci, and writes B0 (B1) as the segment's partial
//   sums; the blocks of the first locus tile also write the segment's sum
//   of v (for vtot).
// * eta finish: one warp per chain sums the vtot partials in segment order,
//   normalizes and projects eta with the warp Michelot of simplex.cuh.
//   It never reads the host.
// * p0 epilogue: one thread per (chain, k, l) sums the B partials in
//   segment order and applies the p0 update; `finish` = 0 writes the raw
//   B0 (B1) instead (the sweep statistics).
//
// Precision: at L in the thousands the scores reach |s| ~ 10^3, where one
// float32 rounding step (6e-5 at 1000) moves v by as much, so the rows
// pass sums each 16-locus tile in float32 and the tiles in float64, and
// takes the row max and s - m in float64 (the plain version scores in
// float64 too).
//
// Bound: two contractions of I x L x Kp per stream (scores and B), in IEEE
// f32 FMA on the CUDA cores (no TF32); x is one byte per cell per stream
// and is read twice, against once by the TPU's single-pass kernel.  The
// rows pass issues about one shared-memory load per 2.7 FMA and is bound
// by shared-memory issue; the columns pass's register tile lifts that to
// about 3 FMA per load at Kp = 32 and more at larger Kp.  Ragged I and L
// are masked here; the caller pads only K, to Kp in {32, 64, 96, 128}.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "simplex.cuh"

namespace {

constexpr int NT = 256;       // threads per block, rows and columns passes
constexpr int NW = NT / 32;   // warps per block
constexpr int ROW_R = 64;     // rows per rows-pass block (8 per warp)
constexpr int ROW_TL = 16;    // loci per rows-pass tile
constexpr int COL_TC = 128;   // loci per columns-pass block (4 per lane)
constexpr int COL_RI = 16;    // rows per columns-pass tile

using mc::michelot_warp;
using mc::warp_sum;

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(mc::FULL, v, o));
  return v;
}

template <int KP, bool X1>
__global__ void __launch_bounds__(NT) mix_rows_kernel(
    const float* __restrict__ lp0, const float* __restrict__ lp1,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const float* __restrict__ bias, float* __restrict__ v_out,
    float* __restrict__ t_out, int I, int L) {
  constexpr int KJ = KP / 32;
  constexpr int RI = ROW_R / NW;  // rows per warp
  constexpr int NS = X1 ? 2 : 1;  // genotype streams
  __shared__ __align__(16) float x_s[NS][ROW_R][ROW_TL + 4];
  __shared__ float p_s[NS][ROW_TL][KP + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROW_R;
  const float* lps[2] = {lp0 + (size_t)b * KP * L,
                         X1 ? lp1 + (size_t)b * KP * L : nullptr};
  const int8_t* xs[2] = {x0, x1};

  // warp w owns rows w + 8 i; lane owns clusters k = lane + 32 j.  Each
  // tile's float32 partial joins a float64 score: |s| reaches thousands
  // at L in the thousands, where float32 rounding alone would move v by
  // more than 1e-4
  double acc[RI][KJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.0;

  for (int l0 = 0; l0 < L; l0 += ROW_TL) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      for (int e = tid; e < ROW_R * ROW_TL; e += NT) {
        const int r = e / ROW_TL, cc = e % ROW_TL;
        const int row = row0 + r, col = l0 + cc;
        x_s[s][r][cc] = (row < I && col < L)
                            ? (float)xs[s][(size_t)row * L + col] : 0.f;
      }
      for (int e = tid; e < KP * ROW_TL; e += NT) {
        const int k = e / ROW_TL, cc = e % ROW_TL, col = l0 + cc;
        p_s[s][cc][k] = col < L ? lps[s][(size_t)k * L + col] : 0.f;
      }
    }
    __syncthreads();
    float tile[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) tile[i][j] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int cc = 0; cc < ROW_TL; cc += 4) {
        float pv[4][KJ];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < KJ; ++j) pv[q][j] = p_s[s][cc + q][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&x_s[s][warp + NW * i][cc]);
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            float a = tile[i][j];
            a = fmaf(xv.x, pv[0][j], a);
            a = fmaf(xv.y, pv[1][j], a);
            a = fmaf(xv.z, pv[2][j], a);
            a = fmaf(xv.w, pv[3][j], a);
            tile[i][j] = a;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] += (double)tile[i][j];
  }

  const float* bias_b = bias + (size_t)b * KP;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + warp + NW * i;
    if (row >= I) continue;  // uniform across the warp
    // the max is taken in float64, so s - m is small and exact enough
    double sd[KJ], m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      sd[j] = acc[i][j] + (double)bias_b[lane + 32 * j];
      m = fmax(m, sd[j]);
    }
    m = warp_max(m);
    float e[KJ], part = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      e[j] = expf((float)(sd[j] - m));
      part += e[j];
    }
    const float tot = warp_sum(part);
    float* v = v_out + ((size_t)b * I + row) * KP;
#pragma unroll
    for (int j = 0; j < KJ; ++j) v[lane + 32 * j] = e[j] / tot;
    if (lane == 0) t_out[(size_t)b * I + row] = (float)((double)logf(tot) + m);
  }
}

template <int KP, bool X1>
__global__ void __launch_bounds__(NT) mix_cols_kernel(
    const float* __restrict__ v, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, float* __restrict__ part,
    float* __restrict__ vpart, int I, int L, int seg_rows) {
  constexpr int KJ = KP / NW;     // clusters per thread: k = warp KJ + j
  constexpr int NS = X1 ? 2 : 1;  // genotype streams
  __shared__ __align__(16) float x_s[NS][COL_RI][COL_TC];
  __shared__ __align__(16) float v_s[COL_RI][KP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = blockIdx.x * COL_TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const bool first = blockIdx.x == 0;
  const float* v_b = v + (size_t)b * I * KP;
  const int8_t* xs[2] = {x0, x1};

  // lane owns loci col0 + 4 lane .. + 3, warp owns clusters warp KJ + j
  float acc[NS][KJ][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][j][q] = 0.f;
  float vsum = 0.f;  // first locus tile, tid < KP: sum of v[:, tid]

  for (int r0 = r_lo; r0 < r_hi; r0 += COL_RI) {
    __syncthreads();
    for (int e = tid; e < COL_RI * KP; e += NT) {
      const int r = e / KP, k = e % KP, row = r0 + r;
      v_s[r][k] = row < r_hi ? v_b[(size_t)row * KP + k] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      for (int e = tid; e < COL_RI * COL_TC; e += NT) {
        const int r = e / COL_TC, c = e % COL_TC;
        const int row = r0 + r, col = col0 + c;
        x_s[s][r][c] = (row < r_hi && col < L)
                           ? (float)xs[s][(size_t)row * L + col] : 0.f;
      }
    }
    __syncthreads();
    if (first && tid < KP) {
#pragma unroll
      for (int r = 0; r < COL_RI; ++r) vsum += v_s[r][tid];
    }
#pragma unroll 4
    for (int r = 0; r < COL_RI; ++r) {
      float vv[KJ];
#pragma unroll
      for (int q = 0; q < KJ / 4; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(&v_s[r][warp * KJ + 4 * q]);
        vv[4 * q] = t.x;
        vv[4 * q + 1] = t.y;
        vv[4 * q + 2] = t.z;
        vv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&x_s[s][r][4 * lane]);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          acc[s][j][0] = fmaf(vv[j], xv.x, acc[s][j][0]);
          acc[s][j][1] = fmaf(vv[j], xv.y, acc[s][j][1]);
          acc[s][j][2] = fmaf(vv[j], xv.z, acc[s][j][2]);
          acc[s][j][3] = fmaf(vv[j], xv.w, acc[s][j][3]);
        }
      }
    }
  }

  if (first && tid < KP) vpart[((size_t)b * n_seg + seg) * KP + tid] = vsum;
  // part[b][seg][stream][k][l]
  float* out = part + ((size_t)b * n_seg + seg) * NS * KP * L;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = col0 + 4 * lane + q;
        if (col < L)
          out[((size_t)s * KP + warp * KJ + j) * L + col] = acc[s][j][q];
      }
}

// eta finish: one warp per chain; vtot = the segments' v sums in segment
// order (deterministic), then eta' = Michelot(vtot / sum vtot).  Pad lanes
// of vtot are exactly 0.
template <int KP>
__global__ void __launch_bounds__(32) mix_eta_kernel(
    const float* __restrict__ vpart, float* __restrict__ vtot,
    float* __restrict__ eta, int n_seg, int k_true, float lb, int project) {
  constexpr int KJ = KP / 32;
  const int b = blockIdx.x, lane = threadIdx.x;
  float w[KJ], part = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    float s = 0.f;
    for (int q = 0; q < n_seg; ++q)
      s += vpart[((size_t)b * n_seg + q) * KP + k];
    vtot[(size_t)b * KP + k] = s;
    w[j] = s;
    part += s;
  }
  const float tot = warp_sum(part);
#pragma unroll
  for (int j = 0; j < KJ; ++j) w[j] = w[j] / tot;
  if (project) michelot_warp<KJ>(w, lane, k_true, lb);
#pragma unroll
  for (int j = 0; j < KJ; ++j) eta[(size_t)b * KP + lane + 32 * j] = w[j];
}

// p0 epilogue: B0 (B1) = the segments' partials summed in segment order
// (deterministic), then the p0 update; `finish` = 0 writes raw B0 (B1).
__global__ void __launch_bounds__(NT) mix_p_kernel(
    const float* __restrict__ part, const float* __restrict__ vtot,
    float* __restrict__ out0, float* __restrict__ out1, int Kp, int L,
    int n_seg, int two, float plb, float pub, float ploidy, int project,
    int finish) {
  const int b = blockIdx.y;
  const int KL = Kp * L;
  const int kl = blockIdx.x * NT + threadIdx.x;
  if (kl >= KL) return;
  const int ns = two ? 2 : 1;
  const float* pb = part + (size_t)b * n_seg * ns * KL + kl;
  float b0 = 0.f, b1 = 0.f;
  for (int s = 0; s < n_seg; ++s) {
    b0 += pb[(size_t)(s * ns) * KL];
    if (two) b1 += pb[(size_t)(s * ns + 1) * KL];
  }
  const size_t o = (size_t)b * KL + kl;
  if (!finish) {
    out0[o] = b0;
    if (two) out1[o] = b1;
    return;
  }
  const float pc0 = b0 + plb;
  const float pc1 = two ? b1 + plb
                        : ploidy * vtot[(size_t)b * Kp + kl / L] - b0 + plb;
  float q = pc0 / (pc0 + pc1);
  if (project) q = fminf(fmaxf(q, plb), pub);
  out0[o] = q;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/build.py).  Pointers are
// device pointers; lp1/x1 (and out1) are null for the one-stream variant.
// `stream` is a cudaStream_t.  Each returns the cudaGetLastError() of its
// launch.

extern "C" int mc_mix_rows(const void* lp0, const void* lp1, const void* x0,
                           const void* x1, const void* bias, void* v_out,
                           void* t_out, int B, int I, int L, int Kp,
                           void* stream) {
  const dim3 grid((I + ROW_R - 1) / ROW_R, 1, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)lp0;
  const float* c = (const float*)lp1;
  const int8_t* x = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const float* bs = (const float*)bias;
  float* v = (float*)v_out;
  float* t = (float*)t_out;
  const bool two = lp1 != nullptr;
#define MC_ROWS(KP)                                                       \
  if (two)                                                                \
    mix_rows_kernel<KP, true><<<grid, NT, 0, s>>>(a, c, x, z, bs, v, t, I, \
                                                  L);                     \
  else                                                                    \
    mix_rows_kernel<KP, false><<<grid, NT, 0, s>>>(a, c, x, z, bs, v, t,  \
                                                   I, L)
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

extern "C" int mc_mix_cols(const void* v, const void* x0, const void* x1,
                           void* part, void* vpart, int B, int I, int L,
                           int Kp, int n_seg, int seg_rows, void* stream) {
  const dim3 grid((L + COL_TC - 1) / COL_TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* vv = (const float*)v;
  const int8_t* x = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  float* pt = (float*)part;
  float* vp = (float*)vpart;
  const bool two = x1 != nullptr;
#define MC_COLS(KP)                                                          \
  if (two)                                                                   \
    mix_cols_kernel<KP, true><<<grid, NT, 0, s>>>(vv, x, z, pt, vp, I, L,    \
                                                  seg_rows);                 \
  else                                                                       \
    mix_cols_kernel<KP, false><<<grid, NT, 0, s>>>(vv, x, z, pt, vp, I, L,   \
                                                   seg_rows)
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

extern "C" int mc_mix_eta(const void* vpart, void* vtot, void* eta, int B,
                          int Kp, int n_seg, int k_true, float lb,
                          int project, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* vp = (const float*)vpart;
  float* vt = (float*)vtot;
  float* e = (float*)eta;
#define MC_ETA(KP)                                                           \
  mix_eta_kernel<KP><<<B, 32, 0, s>>>(vp, vt, e, n_seg, k_true, lb, project)
  switch (Kp) {
    case 32: MC_ETA(32); break;
    case 64: MC_ETA(64); break;
    case 96: MC_ETA(96); break;
    case 128: MC_ETA(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_ETA
  return (int)cudaGetLastError();
}

extern "C" int mc_mix_p(const void* part, const void* vtot, void* out0,
                        void* out1, int B, int Kp, int L, int n_seg, int two,
                        float plb, float pub, float ploidy, int project,
                        int finish, void* stream) {
  const int KL = Kp * L;
  const dim3 grid((KL + NT - 1) / NT, B);
  mix_p_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const float*)vtot, (float*)out0, (float*)out1, Kp,
      L, n_seg, two, plb, pub, ploidy, project, finish);
  return (int)cudaGetLastError();
}
