// The admixture step's passes for 128 < Kp <= 1024: the wide rows pass
// (biallelic and generic cells), its wide finish, and the wide columns
// pass (biallelic and generic cells).  csrc/fullstep_bi.cu and
// csrc/fullstep.cu send every Kp in that range here; Kp <= 128 keeps the
// kernels of tiles.cuh and of those sources.
//
// Replace, above 128 lanes, what the narrow kernels replace: the rows and
// columns passes of the TPU's `admixture_fullstep` (`_fullstep_kernel`,
// multiclust_tpu/ops/kernels.py:200) and of its streamed biallelic step
// (`admixture_fullstep_biallelic_streamed`, kernels.py:1007, with bodies
// `_bi_istats_kernel` :887 and `_bi_lstats_kernel` :944), which the TPU
// admits up to Kp = 1024 (`_fullstep_k_fits` :94, `_stream_vmem_fits`
// :709).  The functions are those of the narrow kernels (the cells, w =
// x * __frcp_rn(d), the raw A + r and t partials a column segment, B0/B1
// or B partials a row segment, the finish of eta); only the tiles differ.
//
// Why other tiles.  The narrow kernels keep a row's (or a column's) whole
// cluster axis in registers: 4 JT clusters x 4 rows a thread, which at Kp
// = 1024 would be 512 floats a thread against the 255 registers there are,
// and eta rows of a 128-row block of 512 KiB against 227 KiB of shared
// memory.  Here the cluster axis is cut into chunks of WK = 64 lanes and
// the accumulators live in shared memory:
//
// * rows pass: a block owns WR = 32 rows of one column segment and keeps
//   their A [32][kc] in shared memory (130 KiB at Kp = 1024).  For each
//   tile of WTL = 64 columns it runs one stage a chunk for d = eta @ p
//   (the chunk's eta [32][64] and p [64][64] arrive by cp.async into a
//   ring of two stages), the cells into w [32][64], then one stage a chunk
//   for A += w @ p^T (the chunk's p again, from L2).  A thread computes 2
//   rows x 4 columns of d and 2 rows x 4 lanes of A.
// * columns pass: a block owns WTC = 16 columns (lanes) of one row segment
//   and keeps their B0/B1 (or B) [16][kc] in shared memory.  For each tile
//   of WRI = 64 rows: one stage a chunk for d (eta [64][64] and p [64][16]
//   chunks), the cells into u [16][64] (transposed, so that the B stages
//   read four rows as a float4), then one stage a chunk for B += eta^T u
//   (the chunk's eta again).  A thread computes 1 row x 4 columns of d and
//   4 lanes x 1 column x both alleles of B.
// * finish: one warp a row as in tiles.cuh, but the partials are read
//   straight from device memory into registers (a row's KJ = Kp / 32
//   values a lane, at most 32), with Kp taken at run time: one
//   instantiation, KJ = 32 (a second one at KJ = 8 for Kp <= 256 built
//   with 48 registers and an 8-byte spill, PERF.md; the finish is a small
//   part of a step).  The t-only finish is tiles.cuh's
//   rows_finish_t_kernel, which takes any Kp.
//
// Bound, and what the design does about it: the same four contractions as
// the narrow kernels (d twice, A, B0/B1), 2 Kp FMA a cell and pass, IEEE
// float32 fmaf on the CUDA cores (no TF32, no fast-math); against a few
// bytes of x a cell this is instruction issue first, and the staged
// chunks come from L2 (each eta chunk of the rows pass and each p chunk of
// the columns pass once a tile, the other operand twice).  This first
// version wants to be right and simple: 0.19-0.31 shared-memory loads a
// FMA, one or two blocks an SM (shared memory), two barriers a stage.
// Faster versions (wgmma, TMA, 3xTF32) are later work (ROADMAP queue 2).
//
// Where the loops stop: the cluster loops run over kc = k_true rounded up
// to 4 lanes (the d stages stop there; the last chunk's A and B stages
// compute their 64 lanes, the lanes past kc on zeros), and the outputs
// past kc are written as the narrow kernels write them: the row's sum of
// w1 (biallelic A + r) or 0.  K stays padded to 32 lanes (Kp = 224 for K
// = 200): no layout of runtime/multistart.py changes.
//
// No atomics: every sum runs in a fixed order (d and the row sums over
// lanes in order, A over columns, B over rows, the finish over segments,
// t in float64), so reruns are bit-equal.  Ragged I and L edges and the
// lanes past kc are zeros in the staged chunks and in x, not masks in the
// arithmetic.
#pragma once

#include "tiles.cuh"

namespace {

constexpr int KP_WIDE_MAX = 1024;
constexpr int WK = 64;     // cluster lanes a chunk
constexpr int WR = 32;     // rows a rows-pass block
constexpr int WTL = 64;    // columns a rows-pass tile
constexpr int WTC = 16;    // columns (lanes) a columns-pass block
constexpr int WRI = 64;    // rows a columns-pass tile
constexpr int WES = WK + 4;    // a staged eta chunk row
constexpr int WPS = WTL + 4;   // a staged p chunk row (rows pass), a w row
constexpr int WCS = WTC + 4;   // a staged p chunk row (columns pass)
constexpr int WUS = WRI + 4;   // a u row (columns pass, one column)

// the wide test beside tiles.cuh's kp_ok (Kp <= 128)
inline bool kp_wide(int Kp) {
  return Kp > 128 && Kp <= KP_WIDE_MAX && Kp % 32 == 0;
}

// lanes the wide loops compute for k_true clusters (outside [1, Kp]: Kp)
__host__ __device__ inline int wide_kc(int k_true, int Kp) {
  const int k = k_true < 1 || k_true > Kp ? Kp : k_true;
  return (k + 3) / 4 * 4;
}

// the lanes the passes of Kp compute: the lane tile's (narrow) or wide_kc
inline int pass_kc(int k_true, int Kp) {
  return kp_wide(Kp) ? wide_kc(k_true, Kp) : lane_tile(k_true, Kp, 32).kc;
}

// row stride of the shared accumulators: whole chunks, then 16 floats so
// that rows r and r + 1 start 16 banks apart
__host__ __device__ inline int wide_acc_stride(int kc) {
  return (kc + WK - 1) / WK * WK + 16;
}

constexpr int ROWS_STAGE = WR * WES + WK * WPS;
constexpr int COLS_STAGE = WRI * WES + WK * WCS;

// shared memory of a rows-pass block, in floats: a_s [WR][KA], w_s [WR]
// [WPS], a ring of two stages (eta chunk [WR][WES], p chunk [WK][WPS]),
// t_s [WR], r_s [WR]
inline int rows_wide_smem_floats(int kc) {
  return WR * wide_acc_stride(kc) + WR * WPS + 2 * ROWS_STAGE + 2 * WR;
}

// shared memory of a columns-pass block, in floats: b_s [NA][WTC][KA],
// u_s [NA][WTC][WUS], a ring of two stages (eta chunk [WRI][WES], p chunk
// [WK][WCS])
inline int cols_wide_smem_floats(int kc, int NA) {
  return NA * WTC * wide_acc_stride(kc) + NA * WTC * WUS + 2 * COLS_STAGE;
}

// ---------------------------------------------------------------------------
// rows pass

// Block (x = WR rows, y = column segment, z = chain) covers the columns
// [l_lo + y seg_cols, + seg_cols) of the window [l_lo, l_hi) of arrays
// with row stride L and writes its raw A (+ r) and t as that segment's
// partials, apart [B, n_seg, I, Kp] (lanes past kc: r, or 0) and tpart
// [B, n_seg, I].  C = kBi: the biallelic cells over the planes x0, x1
// (rows_accumulate's, tiles.cuh); kDense: the generic cells over x0 (x1
// unused).  compute_a == 0: only t (the A stages are not run).
template <Cells C>
__global__ void __launch_bounds__(NT, 2) wide_rows_kernel(
    const float* __restrict__ eta, const float* __restrict__ p,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    float* __restrict__ apart, float* __restrict__ tpart_out, int I, int L,
    int Kp, int kc, int l_lo, int l_hi, int seg_cols, int compute_t,
    int compute_a, int vec) {
  constexpr bool BI = C == Cells::kBi;
  const int n_ch = (kc + WK - 1) / WK, KA = wide_acc_stride(kc);
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int row0 = blockIdx.x * WR;
  const int c_lo = l_lo + seg * seg_cols;
  const int c_hi = min(l_hi, c_lo + seg_cols);
  const float* eta_b = eta + (size_t)b * I * Kp;
  const float* p_b = p + (size_t)b * Kp * L;
  float* a_s = reinterpret_cast<float*>(dyn_smem4);
  float* w_s = a_s + WR * KA;
  float* ring = w_s + WR * WPS;
  float* t_s = ring + 2 * ROWS_STAGE;
  float* r_s = t_s + WR;

  // the block's stages: each column tile has n_ch d stages, then (with
  // compute_a) n_ch A stages
  const int n_tile = (c_hi - c_lo + WTL - 1) / WTL;
  const int per_tile = compute_a ? 2 * n_ch : n_ch;
  const int n_stage = n_tile * per_tile;

  // stage s into ring slot s % 2: a d stage brings the chunk's eta rows
  // and p columns, an A stage the chunk's p columns
  auto issue = [&](int s) {
    if (s < n_stage) {
      const int tile = s / per_tile, j = s % per_tile;
      const int l0 = c_lo + tile * WTL;
      const int k0 = (j < n_ch ? j : j - n_ch) * WK;
      float* e_st = ring + (s & 1) * ROWS_STAGE;
      float* p_st = e_st + WR * WES;
      if (j < n_ch) {
        for (int e = tid; e < WR * (WK / 4); e += NT) {
          const int r = e / (WK / 4), k4 = 4 * (e % (WK / 4));
          const int row = row0 + r, k = k0 + k4;
          const bool ok = row < I && k < kc;
          cp_async16(e_st + r * WES + k4,
                     ok ? eta_b + (size_t)row * Kp + k : eta_b, ok ? 16 : 0);
        }
      }
      for (int e = tid; e < WK * (WTL / 4); e += NT) {
        const int k = e / (WTL / 4), c4 = 4 * (e % (WTL / 4));
        const int kk = k0 + k, col = l0 + c4;
        const int n = kk < kc ? min(4, c_hi - col) : 0;
        float* dst = p_st + k * WPS + c4;
        if (vec) {
          cp_async16(dst, n > 0 ? p_b + (size_t)kk * L + col : p_b,
                     n > 0 ? 4 * n : 0);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[q] = q < n ? p_b[(size_t)kk * L + col + q] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  // d and the cells: rows hi + 16 i (i < 2) x columns 4 lo .. 4 lo + 3 of
  // the tile; A: rows hi + 16 i x lanes k0 + lo + 16 q (q < 4) of a chunk
  float d[2][4], srow[2];
  uint32_t xa[2], xb[2];
  float tacc[2] = {0.f, 0.f}, racc[2] = {0.f, 0.f};
  issue(0);
  for (int s = 0; s < n_stage; ++s) {
    issue(s + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int tile = s / per_tile, j = s % per_tile;
    const float* e_st = ring + (s & 1) * ROWS_STAGE;
    const float* p_st = e_st + WR * WES;
    if (j < n_ch) {
      if (j == 0) {
        const int col = c_lo + tile * WTL + 4 * lo;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          srow[i] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) d[i][q] = 0.f;
          const int row = row0 + hi + 16 * i;
          const int n = row < I ? c_hi - col : 0;
          const size_t off = (size_t)row * L + col;
          xa[i] = load_x4(x0, off, n, vec);
          if constexpr (BI) xb[i] = load_x4(x1, off, n, vec);
        }
      }
      const int kn = min(WK, kc - j * WK);
      for (int k4 = 0; k4 < kn; k4 += 4) {
        float4 pv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) pv[q] = ld4(p_st + (k4 + q) * WPS + 4 * lo);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 ev = ld4(e_st + (hi + 16 * i) * WES + k4);
          d_row(d[i], ev, pv);
          if constexpr (BI) srow[i] += (ev.x + ev.y) + (ev.z + ev.w);
        }
      }
      if (j == n_ch - 1) {   // the tile's cells
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float wv[4], tt = 0.f, rr = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (BI) {
              const float a0 = x_byte(xa[i], q), a1 = x_byte(xb[i], q);
              const float dd0 = fmaxf(d[i][q], DMIN);
              const float dd1 = fmaxf(srow[i] - d[i][q], DMIN);
              const float w0 = a0 * __frcp_rn(dd0), w1 = a1 * __frcp_rn(dd1);
              if (compute_t) tt += a0 * logf(dd0) + a1 * logf(dd1);
              rr += w1;
              wv[q] = w0 - w1;
            } else {
              const float xv = x_byte(xa[i], q);
              const float sd = d[i][q] > 0.f ? d[i][q] : 1.f;
              wv[q] = xv * __frcp_rn(sd);   // 0 where x = 0
              if (compute_t && xv > 0.f) tt += xv * logf(sd);
            }
          }
          tacc[i] += tt;
          racc[i] += rr;
          if (compute_a)
            *reinterpret_cast<float4*>(w_s + (hi + 16 * i) * WPS + 4 * lo) =
                make_float4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
    } else {   // an A stage: the chunk's lanes, over the tile's columns
      const int k0 = (j - n_ch) * WK;
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][q] = tile == 0 ? 0.f
                                : a_s[(hi + 16 * i) * KA + k0 + lo + 16 * q];
#pragma unroll 4
      for (int c4 = 0; c4 < WTL; c4 += 4) {
        const float4 wa = ld4(w_s + hi * WPS + c4);
        const float4 wb = ld4(w_s + (hi + 16) * WPS + c4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 pk = ld4(p_st + (lo + 16 * q) * WPS + c4);
          float v = acc[0][q];
          v = fmaf(wa.x, pk.x, v);
          v = fmaf(wa.y, pk.y, v);
          v = fmaf(wa.z, pk.z, v);
          v = fmaf(wa.w, pk.w, v);
          acc[0][q] = v;
          v = acc[1][q];
          v = fmaf(wb.x, pk.x, v);
          v = fmaf(wb.y, pk.y, v);
          v = fmaf(wb.z, pk.z, v);
          v = fmaf(wb.w, pk.w, v);
          acc[1][q] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a_s[(hi + 16 * i) * KA + k0 + lo + 16 * q] = acc[i][q];
    }
    __syncthreads();
  }

  // each row's t and sum of w1 over its 16 column lanes, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float tt = tacc[i], rr = racc[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      tt += __shfl_xor_sync(mc::FULL, tt, o);
      if constexpr (BI) rr += __shfl_xor_sync(mc::FULL, rr, o);
    }
    if (lo == 0) {
      t_s[hi + 16 * i] = tt;
      r_s[hi + 16 * i] = rr;
    }
  }
  __syncthreads();
  const size_t o0 = ((size_t)b * n_seg + seg) * I;
  if (tid < WR && row0 + tid < I) tpart_out[o0 + row0 + tid] = t_s[tid];
  if (!compute_a) return;
  for (int e = tid; e < WR * Kp; e += NT) {
    const int r = e / Kp, k = e % Kp, row = row0 + r;
    if (row < I) {
      const float rr = BI ? r_s[r] : 0.f;
      apart[(o0 + row) * Kp + k] = k < kc ? a_s[r * KA + k] + rr : rr;
    }
  }
}

// launches the wide rows pass over B chains (n_seg <= 65535); returns the
// launch's cudaError_t
template <Cells C>
inline int launch_rows_wide(const void* eta, const void* p, const void* x0,
                            const void* x1, void* apart, void* tpart, int B,
                            int I, int L, int Kp, int k_true, int l_lo,
                            int l_hi, int seg_cols, int n_seg, int compute_t,
                            int compute_a, int vec, cudaStream_t s) {
  const int kc = wide_kc(k_true, Kp);
  const size_t smem = sizeof(float) * (size_t)rows_wide_smem_floats(kc);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(wide_rows_kernel<C>);
  if (err != 0) return err;
  wide_rows_kernel<C><<<dim3((I + WR - 1) / WR, n_seg, B), NT, smem, s>>>(
      (const float*)eta, (const float*)p, (const int8_t*)x0,
      (const int8_t*)x1, (float*)apart, (float*)tpart, I, L, Kp, kc, l_lo,
      l_hi, seg_cols, compute_t, compute_a, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rows finish

// The finish of rows_finish_kernel (tiles.cuh) for 128 < Kp <= 32 KJ: the
// segments' partials on top of the a0 seed, in segment order (A in
// float32, t in float64), then the raw A (emit_a) or eta' =
// Michelot(normalize(eta (A + c))) over the lanes k < k_true or the
// runtime kmask.  One warp a row, lane owns k = lane + 32 j; the lanes
// read are those below kc and, under emit_a, lane kc for every pad lane
// (the value the rows passes write to each of them).  c, a0 and kmask may
// be null; pad lanes of eta must be zero.
template <int KJ>
__global__ void __launch_bounds__(NT) wide_finish_kernel(
    const float* __restrict__ eta, const float* __restrict__ apart,
    const float* __restrict__ tpart, const float* __restrict__ a0,
    const float* __restrict__ c, const float* __restrict__ kmask,
    float* __restrict__ out, double* __restrict__ t_out, int I, int Kp,
    int n_seg, int kc, int k_true, float lb, int emit_a, int project_eta,
    int compute_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * NW + warp;
  if (row >= I) return;   // warps share nothing
  const int b = blockIdx.y;
  const size_t br = (size_t)b * I + row;
  const int pad = emit_a && kc < Kp ? kc : -1;
  int kcol[KJ];
  float a[KJ], e[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    kcol[j] = k >= Kp ? -1 : k < kc ? k : pad;
    a[j] = a0 != nullptr && kcol[j] >= 0 ? a0[br * Kp + k] : 0.f;
    e[j] = !emit_a && k < kc ? eta[br * Kp + k] : 0.f;
  }
  const float ci = c != nullptr ? c[row] : 0.f;
  double tt = 0.0;
  for (int s = 0; s < n_seg; ++s) {
    const size_t bs = ((size_t)b * n_seg + s) * I + row;
    const float* ap = apart + bs * Kp;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      if (kcol[j] >= 0) a[j] += ap[kcol[j]];
    if (compute_t && lane == 0) tt += (double)tpart[bs];
  }
  if (lane == 0) t_out[br] = tt;
  float* o = out + br * Kp;
  if (!emit_a) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      a[j] = e[j] * (a[j] + ci);
      part += a[j];
    }
    const float tot = warp_sum(part);
#pragma unroll
    for (int j = 0; j < KJ; ++j) a[j] = tot > 0.f ? a[j] / tot : e[j];
    if (project_eta) {
      bool valid[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = lane + 32 * j;
        valid[j] = k < Kp && (kmask != nullptr ? kmask[k] > 0.5f : k < k_true);
      }
      mc::michelot_warp_mask<KJ>(a, valid, lb);
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < Kp) o[lane + 32 * j] = a[j];
}

// launches the finish over B chains of I rows at a wide Kp; `out` null:
// only t (tiles.cuh's t-only kernel, which takes any Kp); returns the
// launch's cudaError_t
inline int launch_rows_finish_wide(const void* eta, const void* apart,
                                   const void* tpart, const void* a0,
                                   const void* c, const void* kmask,
                                   void* out, void* t_out, int B, int I,
                                   int Kp, int n_seg, int k_true, float lb,
                                   int emit_a, int project_eta,
                                   int compute_t, cudaStream_t s) {
  if (out == nullptr)
    return launch_rows_finish(eta, apart, tpart, a0, c, kmask, out, t_out, B,
                              I, Kp, n_seg, k_true, lb, emit_a, project_eta,
                              compute_t, s);
  const int kc = wide_kc(k_true, Kp);
  const dim3 grid((I + NW - 1) / NW, B);
  wide_finish_kernel<KP_WIDE_MAX / 32><<<grid, NT, 0, s>>>(
      (const float*)eta, (const float*)apart, (const float*)tpart,
      (const float*)a0, (const float*)c, (const float*)kmask, (float*)out,
      (double*)t_out, I, Kp, n_seg, kc, k_true, lb, emit_a, project_eta,
      compute_t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// columns pass

// Block (x = WTC columns of the window, y = row segment, z = chain) covers
// the rows [y seg_rows, + seg_rows) and the columns [l_lo + x WTC, + WTC)
// of the window [l_lo, l_hi) of arrays with row stride L (x and p) and
// ML (miss, a locus per M columns), and writes that segment's partials
// part [B, n_seg, NA, Kp, l_hi - l_lo], lanes past kc written 0.  C = kBi
// (NA = 2): B0/B1 = eta^T (x0 / d0 + miss), eta^T (x1 / d1 + miss) with the
// clamped d0, d1; kDense (NA = 1): B = eta^T (x0 / d + miss) over lanes,
// a zero d counting as 1.  miss may be null.
template <Cells C>
__global__ void __launch_bounds__(NT, 2) wide_cols_kernel(
    const float* __restrict__ eta, const float* __restrict__ p,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const int8_t* __restrict__ miss, float* __restrict__ part, int I, int L,
    int ML, int M, int Kp, int kc, int l_lo, int l_hi, int seg_rows,
    int vec) {
  constexpr bool BI = C == Cells::kBi;
  constexpr int NA = BI ? 2 : 1;
  const int n_ch = (kc + WK - 1) / WK, KA = wide_acc_stride(kc);
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const int dr = tid >> 2, dc = tid & 3;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = l_lo + blockIdx.x * WTC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const float* eta_b = eta + (size_t)b * I * Kp;
  const float* p_b = p + (size_t)b * Kp * L;
  float* b_s = reinterpret_cast<float*>(dyn_smem4);
  float* u_s = b_s + NA * WTC * KA;
  float* ring = u_s + NA * WTC * WUS;

  const int n_tile = r_hi > r_lo ? (r_hi - r_lo + WRI - 1) / WRI : 0;
  const int per_tile = 2 * n_ch;
  const int n_stage = n_tile * per_tile;

  // stage s into ring slot s % 2: a d stage brings the chunk's eta rows
  // and p columns, a B stage the chunk's eta rows
  auto issue = [&](int s) {
    if (s < n_stage) {
      const int tile = s / per_tile, j = s % per_tile;
      const int r0 = r_lo + tile * WRI;
      const int k0 = (j < n_ch ? j : j - n_ch) * WK;
      float* e_st = ring + (s & 1) * COLS_STAGE;
      float* p_st = e_st + WRI * WES;
      for (int e = tid; e < WRI * (WK / 4); e += NT) {
        const int r = e / (WK / 4), k4 = 4 * (e % (WK / 4));
        const int row = r0 + r, k = k0 + k4;
        const bool ok = row < r_hi && k < kc;
        cp_async16(e_st + r * WES + k4,
                   ok ? eta_b + (size_t)row * Kp + k : eta_b, ok ? 16 : 0);
      }
      if (j < n_ch) {
        for (int e = tid; e < WK * (WTC / 4); e += NT) {
          const int k = e / (WTC / 4), c4 = 4 * (e % (WTC / 4));
          const int kk = k0 + k, col = col0 + c4;
          const int n = kk < kc ? min(4, l_hi - col) : 0;
          float* dst = p_st + k * WCS + c4;
          if (vec) {
            cp_async16(dst, n > 0 ? p_b + (size_t)kk * L + col : p_b,
                       n > 0 ? 4 * n : 0);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dst[q] = q < n ? p_b[(size_t)kk * L + col + q] : 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  // d and the cells: row dr of the tile x columns 4 dc .. 4 dc + 3; B:
  // column hi x lanes k0 + 4 lo .. + 3 of a chunk, both alleles
  float d[4], srow = 0.f;
  uint32_t xa = 0u, xb = 0u, xm = 0u;
  issue(0);
  for (int s = 0; s < n_stage; ++s) {
    issue(s + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int tile = s / per_tile, j = s % per_tile;
    const float* e_st = ring + (s & 1) * COLS_STAGE;
    const float* p_st = e_st + WRI * WES;
    if (j < n_ch) {
      if (j == 0) {
        srow = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = 0.f;
        const int row = r_lo + tile * WRI + dr, col = col0 + 4 * dc;
        const int n = row < r_hi ? l_hi - col : 0;
        const size_t off = (size_t)row * L + col;
        xa = load_x4(x0, off, n, vec);
        if constexpr (BI) {
          xb = load_x4(x1, off, n, vec);
          xm = miss != nullptr ? load_x4(miss, (size_t)row * ML + col, n, vec)
                               : 0u;
        } else {
          // each lane's locus count, byte q for lane col + q
          xm = 0u;
          if (miss != nullptr) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < n)
                xm |= (uint32_t)(uint8_t)miss[(size_t)row * ML + (col + q) / M]
                      << (8 * q);
          }
        }
      }
      const int kn = min(WK, kc - j * WK);
      for (int k4 = 0; k4 < kn; k4 += 4) {
        float4 pv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) pv[q] = ld4(p_st + (k4 + q) * WCS + 4 * dc);
        const float4 ev = ld4(e_st + dr * WES + k4);
        d_row(d, ev, pv);
        if constexpr (BI) srow += (ev.x + ev.y) + (ev.z + ev.w);
      }
      if (j == n_ch - 1) {   // the tile's cells, into u_s [a][column][row]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float m = x_byte(xm, q);
          float* u = u_s + (4 * dc + q) * WUS + dr;
          if constexpr (BI) {
            u[0] = fmaf(x_byte(xa, q), __frcp_rn(fmaxf(d[q], DMIN)), m);
            u[WTC * WUS] =
                fmaf(x_byte(xb, q), __frcp_rn(fmaxf(srow - d[q], DMIN)), m);
          } else {
            const float sd = d[q] > 0.f ? d[q] : 1.f;
            u[0] = fmaf(x_byte(xa, q), __frcp_rn(sd), m);
          }
        }
      }
    } else {   // a B stage: the chunk's lanes, over the tile's rows
      const int k0 = (j - n_ch) * WK;
      float acc[NA][4];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float* bp = b_s + (a * WTC + hi) * KA + k0 + 4 * lo;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = tile == 0 ? 0.f : bp[q];
      }
#pragma unroll 2
      for (int r = 0; r < WRI; r += 4) {
        float4 ev[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[i] = ld4(e_st + (r + i) * WES + 4 * lo);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const float4 u = ld4(u_s + (a * WTC + hi) * WUS + r);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = acc[a][q];
            v = fmaf(f4_get(ev[0], q), u.x, v);
            v = fmaf(f4_get(ev[1], q), u.y, v);
            v = fmaf(f4_get(ev[2], q), u.z, v);
            v = fmaf(f4_get(ev[3], q), u.w, v);
            acc[a][q] = v;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        float* bp = b_s + (a * WTC + hi) * KA + k0 + 4 * lo;
#pragma unroll
        for (int q = 0; q < 4; ++q) bp[q] = acc[a][q];
      }
    }
    __syncthreads();
  }

  // part[b][seg][a][k][column of the window]: lanes k < kc, then zeros
  const size_t W = (size_t)(l_hi - l_lo);
  float* out = part + ((size_t)b * n_seg + seg) * NA * Kp * W;
  for (int e = tid; e < NA * Kp * WTC; e += NT) {
    const int cc = e % WTC, k = (e / WTC) % Kp, a = e / (WTC * Kp);
    const int col = col0 + cc;
    if (col < l_hi)
      out[((size_t)a * Kp + k) * W + (col - l_lo)] =
          k < kc && n_tile > 0 ? b_s[(a * WTC + cc) * KA + k] : 0.f;
  }
}

// launches the wide columns pass over B chains (n_seg <= 65535); returns
// the launch's cudaError_t
template <Cells C>
inline int launch_cols_wide(const void* eta, const void* p, const void* x0,
                            const void* x1, const void* miss, void* part,
                            int B, int I, int L, int ML, int M, int Kp,
                            int k_true, int l_lo, int l_hi, int n_seg,
                            int seg_rows, int vec, cudaStream_t s) {
  const int kc = wide_kc(k_true, Kp);
  const int NA = C == Cells::kBi ? 2 : 1;
  const size_t smem = sizeof(float) * (size_t)cols_wide_smem_floats(kc, NA);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(wide_cols_kernel<C>);
  if (err != 0) return err;
  const dim3 grid((l_hi - l_lo + WTC - 1) / WTC, n_seg, B);
  wide_cols_kernel<C><<<grid, NT, smem, s>>>(
      (const float*)eta, (const float*)p, (const int8_t*)x0,
      (const int8_t*)x1, (const int8_t*)miss, (float*)part, I, L, ML, M, Kp,
      kc, l_lo, l_hi, seg_rows, vec);
  return (int)cudaGetLastError();
}

}  // namespace
