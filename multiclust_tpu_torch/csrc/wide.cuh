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
// memory.
//
// * rows pass: the cluster axis in chunks of WK = 64 lanes, the
//   accumulators in shared memory.  A block owns WR = 32 rows of one
//   column segment and keeps their A [32][kc] in shared memory (130 KiB
//   at Kp = 1024).  For each tile of WTL = 64 columns it runs one stage a
//   chunk for d = eta @ p (the chunk's eta [32][64] and p [64][64] arrive
//   by cp.async into a ring of two stages), the cells into w [32][64],
//   then one stage a chunk for A += w @ p^T (the chunk's p again, from
//   L2).  A thread computes 2 rows x 4 columns of d and 2 rows x 4 lanes
//   of A, IEEE float32 fmaf on the CUDA cores: 0.19-0.31 shared-memory
//   loads a FMA, one or two blocks an SM, two barriers a stage (a first
//   version, 22 % of its bound, PERF.md).
// * finish: one warp a row as in tiles.cuh, but the partials are read
//   straight from device memory into registers (a row's KJ = Kp / 32
//   values a lane, at most 32), with Kp taken at run time: one
//   instantiation, KJ = 32 (a second one at KJ = 8 for Kp <= 256 built
//   with 48 registers and an 8-byte spill, PERF.md; the finish is a small
//   part of a step).  The t-only finish is tiles.cuh's
//   rows_finish_t_kernel, which takes any Kp.
// * columns pass: two launches for each column sub-window, both products
//   on the float64 tensor cores (`mma.sync` m16n8k16 DMMA, csrc/dmma.cuh;
//   `wgmma` has no float64 form).  d needs a row's whole cluster axis and
//   B's accumulators [kc x columns x alleles] fit a block only for a few
//   columns (B0/B1 [16][kc] in shared memory would stream eta W / 16
//   times), so d is written once and read once a lane chunk:
//   - d launch (`wide_cols_d_kernel`): a persistent grid over tiles of
//     128 rows x 128 columns; eta and p stream as float32 by cp.async in
//     stages of 64 lanes (a ring of two, one barrier a stage, a block's
//     tiles one stream of stages) and are converted to float64 as a
//     warp's fragments are built; 4 x 4 DMMA
//     tiles a warp (64 rows x 32 columns).  d is rounded to float32 once
//     into a scratch plane [B, I, sub-window]; with the biallelic cells
//     the first column tile also writes each row's eta summed over its kc
//     lanes (one warp a row, float64, lanes in a fixed order).
//   - B launch (`wide_cols_b_kernel`): block (column tile, row segment,
//     chain x lane chunk), the live lanes (ceil(kc / 8) tiles of 8) in
//     balanced chunks of at most 128 (csrc/dmma.cuh), stages of 64 rows
//     (48 with the generic cells).  cp.async rings of two bring the
//     chunk's eta and, a stage ahead, the cells' inputs (d, x, miss, the
//     rows' eta sums).  The cells are formed in float32 into shared
//     memory (two stages of u), as the narrow kernels form them (u = x *
//     __frcp_rn(max(d, DMIN)) + miss, the second allele on srow - d; the
//     generic cells a zero d counting as 1, miss by the lane's locus);
//     B += eta^T u runs on DMMA, 4 x 4 tiles a warp (2 x 4 a stream with
//     two, which share each eta fragment), through code made for the
//     warp's number of live lane tiles.  One barrier a stage: between two
//     a warp forms the next stage's cells and runs this stage's products,
//     half the warps in each order, so that forming the cells overlaps
//     the tensor cores (with a barrier between the two, W3 and W4 took
//     6-31 % longer, PERF.md).  The block's
//     float64 sums are rounded to float32 once, as the segment's
//     partials.  Biallelic blocks take 64 columns, generic ones 128.
//   - The wrapper (ops/fullstep_bi.cols_sub_cols) cuts the window into
//     sub-windows of whole d tiles so that the scratch stays within
//     SCRATCH_CAP (192 MiB: 1536 columns at 2 chains x 16384 rows); the
//     launcher loops the two launches over them, each writing its columns
//     of the same partials.
//   d is written rather than the cells u: one plane against the
//   biallelic cells' two, and one d kernel for both cells; the B launch
//   reads x (a byte a cell) beside d and forms the cells again a chunk.
//
// Bound: the same contractions as the narrow kernels (d twice, A, B0/B1;
// the generic d twice, A, B), 2 kc FMA a cell and product: against a few
// bytes of x a cell, operations first, on fmaf (rows pass) or DMMA
// (columns pass) at the same 67 TFLOP/s.  The columns pass's d scratch
// adds 4 bytes a cell written and 4 read a chunk.
//
// Sums that are float64 in the columns pass since the DMMA redesign: d
// over the lanes, each row's eta sum srow, and B within a row segment
// (the fmaf version summed all three in float32); d and srow are rounded
// to float32 before the cells (d1 = srow - d in float32), the partials
// once at the end of a segment; the segments still add in float32 in
// segment order in the epilogues.
//
// Where the loops stop: the cluster loops run over kc = k_true rounded up
// to 4 lanes (the rows pass's d stages stop there; its last chunk's A
// stages compute their 64 lanes on zeros past kc; the columns pass's d
// stages stop at kc rounded up to 16, its B launch at the live tiles of
// 8), and the outputs past kc are written as the narrow kernels write
// them: the row's sum of w1 (biallelic A + r) or 0.  K stays padded to 32
// lanes (Kp = 224 for K = 200): no layout of runtime/multistart.py
// changes.
//
// No atomics: every sum runs in a fixed order (d and the row sums over
// lanes in order, A over columns, B over rows, the finish over segments,
// t in float64), so reruns are bit-equal.  Ragged I and L edges and the
// lanes past kc are zeros in the staged tiles and in x, not masks in the
// arithmetic.
#pragma once

#include "dmma.cuh"
#include "tiles.cuh"

namespace {

constexpr int KP_WIDE_MAX = 1024;
constexpr int WK = 64;     // cluster lanes a chunk
constexpr int WR = 32;     // rows a rows-pass block
constexpr int WTL = 64;    // columns a rows-pass tile
constexpr int WES = WK + 4;    // a staged eta chunk row
constexpr int WPS = WTL + 4;   // a staged p chunk row, a w row

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

// shared memory of a rows-pass block, in floats: a_s [WR][KA], w_s [WR]
// [WPS], a ring of two stages (eta chunk [WR][WES], p chunk [WK][WPS]),
// t_s [WR], r_s [WR]
inline int rows_wide_smem_floats(int kc) {
  return WR * wide_acc_stride(kc) + WR * WPS + 2 * ROWS_STAGE + 2 * WR;
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
// columns pass: a d launch, then a B launch, for each column sub-window

// Both launches: 8 warps in WC_WM warp rows x WC_WN warp columns, a warp
// 16 MT rows (or columns) x WC_NTW tiles of 8 columns (or lanes).
constexpr int WC_WM = 2, WC_WN = 4, WC_NTW = 4;
static_assert(WC_WM * WC_WN == NW, "the warps tile the block");
static_assert(8 * WC_NTW * WC_WN == CHUNK_LANES, "a B block takes a chunk");

// d launch: tiles of WD_M rows x WD_N columns, stages of WD_K lanes.  WD_ES
// = WD_K + 4: a fragment's scalar eta reads (rows g, lanes t + 4 p) hit
// banks 4 g + t; WD_PS = WD_N + 8: its p reads (lanes t + 4 p, columns g)
// hit 8 t + g.
constexpr int WD_M = 16 * 4 * WC_WM, WD_N = 8 * WC_NTW * WC_WN, WD_K = 64;
constexpr int WD_ES = WD_K + 4, WD_PS = WD_N + 8;
constexpr int WD_STAGE = 4 * (WD_M * WD_ES + WD_K * WD_PS);   // bytes
constexpr int WD_SMEM = 2 * WD_STAGE;

// B launch: WB_ES = CHUNK_LANES + 8: a fragment's eta reads (rows t + 4
// p, lanes g) hit banks 8 t + g.
constexpr int WB_ES = CHUNK_LANES + 8;

// The B block of the cells C: BC columns (MT tiles of 16 a warp and
// stream), NS streams, stages of TK rows.  Shared memory, in bytes: a ring
// of two eta-chunk stages [TK][WB_ES] floats; a ring of two stages of the
// cells' inputs (d [TK][DS] floats, x0 (x1) [TK][BC] bytes, miss [TK][MS]
// bytes, kBi: the rows' eta sums [TK] floats); two stages of the cells u
// [NS][TK][US] floats.  US = BC + 8: a fragment's float2 reads of u (rows
// t + 4 p, columns 2 g, 2 g + 1) hit banks 8 t + 2 g (+ 1).  MS: the
// generic cells' loci of BC lanes from a 4-byte boundary.  The generic
// block takes 48-row stages, so that its three rings fit.
template <Cells C>
struct WideColsTile {
  static constexpr int NS = C == Cells::kBi ? 2 : 1;
  static constexpr int MT = NS == 2 ? 2 : 4;
  static constexpr int BC = 16 * MT * WC_WM;
  static constexpr int TK = NS == 2 ? 64 : 48;
  static constexpr int DS = BC + 4, US = BC + 8;
  static constexpr int MS = NS == 2 ? BC : BC + 8;
  static constexpr int E_STAGE = 4 * TK * WB_ES;
  static constexpr int C_X = 4 * TK * DS;   // offsets in a cells stage
  static constexpr int C_M = C_X + NS * TK * BC;
  static constexpr int C_S = C_M + TK * MS;
  static constexpr int C_STAGE = C_S + (NS == 2 ? 4 * TK : 0);
  static constexpr int U_STAGE = 4 * NS * TK * US;
  static constexpr int C_OFF = 2 * E_STAGE;
  static constexpr int U_OFF = C_OFF + 2 * C_STAGE;
  static constexpr int SMEM = U_OFF + 2 * U_STAGE;
  static_assert(E_STAGE % 16 == 0 && C_STAGE % 16 == 0 && C_X % 16 == 0 &&
                SMEM <= SMEM_MAX, "B block smem");
};
static_assert(WD_SMEM <= SMEM_MAX, "d block smem");

// The d launch: a persistent grid over the tiles (WD_M rows, WD_N columns
// of the sub-window [s0, s1), chain), each block taking every
// gridDim.x-th, their stages one stream through the ring (the next
// tile's first stage lands while a tile's d is written).  d = eta @ p
// over the lanes below kc on the float64 tensor cores (4 x 4 DMMA tiles a
// warp, 64 rows x 32 columns; eta and p staged as float32 by cp.async,
// converted in registers), summed in float64 over the lanes in order and
// rounded to float32 once into d_out [B, I, ds] (column c at c - s0).
// With srow non-null the tiles of the first column tile also write each
// row's eta summed over its kc lanes (float64, one warp a row, lanes in a
// fixed order) to srow [B, I].  p has row stride L.
__global__ void __launch_bounds__(NT, 1) wide_cols_d_kernel(
    const float* __restrict__ eta, const float* __restrict__ p,
    float* __restrict__ d_out, float* __restrict__ srow, int B, int I,
    int L, int Kp, int kc, int s0, int s1, int ds, int vec) {
  constexpr int MT = 4, ST = 2;
  char* smem = reinterpret_cast<char*>(dyn_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WC_WM, wc = warp / WC_WM;
  const int n_rt = (I + WD_M - 1) / WD_M;
  const int n_ct = (s1 - s0 + WD_N - 1) / WD_N;
  const int n_tiles = n_rt * n_ct * B;
  const int n_st = (kc + WD_K - 1) / WD_K;
  const int n_mine = (int)blockIdx.x < n_tiles
      ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = n_mine * n_st;   // the block's stages

  // stage gs of the block: stage gs % n_st of its tile gs / n_st
  struct Where {
    int st, ct, b, row0, col0;
  };
  auto where = [&](int gs) {
    const int tile = blockIdx.x + gs / n_st * gridDim.x;
    const int ct = tile % n_ct, rt = tile / n_ct % n_rt;
    return Where{gs % n_st, ct, tile / (n_ct * n_rt), rt * WD_M,
                 s0 + ct * WD_N};
  };
  auto issue = [&](int gs) {
    if (gs < total) {
      const Where w = where(gs);
      const float* eta_b = eta + (size_t)w.b * I * Kp;
      const float* p_b = p + (size_t)w.b * Kp * L;
      float* es = reinterpret_cast<float*>(smem + (gs % ST) * WD_STAGE);
      float* ps = es + WD_M * WD_ES;
      const int k0 = w.st * WD_K;
      for (int e = tid; e < WD_M * (WD_K / 4); e += NT) {
        const int r = e / (WD_K / 4), k4 = 4 * (e % (WD_K / 4));
        const int row = w.row0 + r, k = k0 + k4;
        const bool ok = row < I && k < kc;
        cp_async16(es + r * WD_ES + k4,
                   ok ? eta_b + (size_t)row * Kp + k : eta_b, ok ? 16 : 0);
      }
      for (int e = tid; e < WD_K * (WD_N / 4); e += NT) {
        const int k = e / (WD_N / 4), c4 = 4 * (e % (WD_N / 4));
        const int kk = k0 + k, col = w.col0 + c4;
        const int n = kk < kc ? max(0, min(4, s1 - col)) : 0;
        float* dst = ps + k * WD_PS + c4;
        if (vec) {
          cp_async16(dst, n > 0 ? p_b + (size_t)kk * L + col : p_b, 4 * n);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[q] = q < n ? p_b[(size_t)kk * L + col + q] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  double acc[MT][WC_NTW][4];
  issue(0);
  for (int gs = 0; gs < total; ++gs) {
    const Where w = where(gs);
    if (w.st == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < WC_NTW; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.0;
      if (srow != nullptr && w.ct == 0) {
        for (int r = warp; r < WD_M && w.row0 + r < I; r += NW) {
          const float* er = eta + ((size_t)w.b * I + w.row0 + r) * Kp;
          double sum = 0.0;
          for (int k = lane; k < kc; k += 32) sum += (double)er[k];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(mc::FULL, sum, o);
          if (lane == 0) srow[(size_t)w.b * I + w.row0 + r] = (float)sum;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // stage gs landed; every warp is done with gs - 1
    issue(gs + 1);
    const float* es =
        reinterpret_cast<const float*>(smem + (gs % ST) * WD_STAGE);
    const float* ps = es + WD_M * WD_ES;
    const int nc = (min(WD_K, kc - w.st * WD_K) + 15) / 16;
    for (int c = 0; c < nc; ++c) {
      double bb[WC_NTW][4];
#pragma unroll
      for (int j = 0; j < WC_NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bb[j][q] = ps[(16 * c + t + 4 * q) * WD_PS + 32 * wc + 8 * j + g];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* ea = es + (64 * wm + 16 * m + g) * WD_ES + 16 * c + t;
        double a[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[2 * q] = ea[4 * q];
          a[2 * q + 1] = ea[8 * WD_ES + 4 * q];
        }
#pragma unroll
        for (int j = 0; j < WC_NTW; ++j) dmma16(acc[m][j], a, bb[j]);
      }
    }
    if (w.st + 1 < n_st) continue;
    // the tile's d: rows g and g + 8 of each DMMA tile, columns 32 wc + 8
    // j + 2 t + {0, 1}
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w.row0 + 64 * wm + 16 * m + g + 8 * h;
        if (row >= I) continue;
        float* dr = d_out + ((size_t)w.b * I + row) * ds + (w.col0 - s0);
#pragma unroll
        for (int j = 0; j < WC_NTW; ++j) {
          const int c = 32 * wc + 8 * j + 2 * t;
          const float o0 = (float)acc[m][j][2 * h];
          const float o1 = (float)acc[m][j][2 * h + 1];
          if (w.col0 + c + 1 < s1)
            *reinterpret_cast<float2*>(dr + c) = make_float2(o0, o1);
          else if (w.col0 + c < s1)
            dr[c] = o0;
        }
      }
  }
}

// bytes [c0, c0 + 4 nw) of the rows r0 .. r0 + TK - 1 of an int8 plane
// with row stride ld into dst (row stride dstride), zeros at rows >= r_hi
// and at bytes >= c_hi; vec: 4-byte cp.async (c0 and ld multiples of 4,
// the plane 4-byte aligned), else plain loads
template <int TK>
__device__ __forceinline__ void stage_bytes(int8_t* dst, int dstride,
                                            const int8_t* src, int ld,
                                            int r0, int r_hi, int c0,
                                            int c_hi, int nw, int vec) {
  for (int e = threadIdx.x; e < TK * nw; e += NT) {
    const int r = e / nw, w = e % nw, row = r0 + r, col = c0 + 4 * w;
    const int n = row < r_hi ? max(0, min(4, c_hi - col)) : 0;
    int8_t* o = dst + r * dstride + 4 * w;
    if (vec) {
      cp_async4(o, n > 0 ? src + (size_t)row * ld + col : src, n);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = q < n ? src[(size_t)row * ld + col + q] : (int8_t)0;
    }
  }
}

// One stage of the B launch's products for a warp with NJ live lane
// tiles: A = u^T (a tile's rows g and g + 8 are columns 2 g and 2 g + 1,
// one float2 read), B = eta, slot p of thread t row t + 4 p of a 16-row
// step.
template <Cells C, int NJ>
__device__ __forceinline__ void wide_cols_b_stage(
    double (&acc)[WideColsTile<C>::NS][WideColsTile<C>::MT][WC_NTW][4],
    const float* es, const float* us, int wm, int wc, int g, int t) {
  using T = WideColsTile<C>;
  constexpr int MT = T::MT, US = T::US, TK = T::TK;
  // two streams: one 16-row step at a time (fully unrolled, the kernel
  // built at 254 registers with an 8-byte spill)
  constexpr int STEPS = T::NS == 2 ? 1 : TK / 16;
#pragma unroll STEPS
  for (int c = 0; c < TK / 16; ++c) {
    const float* et = es + (16 * c + t) * WB_ES + 8 * wc + g;
    double bb[NJ > 0 ? NJ : 1][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bb[j][q] = et[4 * q * WB_ES + 8 * WC_WN * j];
#pragma unroll
    for (int s = 0; NJ > 0 && s < T::NS; ++s) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* ut = us + (s * TK + 16 * c + t) * US +
                          16 * (wm * MT + m) + 2 * g;
        double a[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = *reinterpret_cast<const float2*>(ut + 4 * q * US);
          a[2 * q] = f.x;
          a[2 * q + 1] = f.y;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma16(acc[s][m][j], a, bb[j]);
      }
    }
  }
}

// The B launch: block (BC columns of the sub-window [s0, s1), row
// segment, chain x chunk of the live lane tiles of kc) forms the cells of
// each stage in float32 from d (the d launch's, at row stride ds), x and
// miss, as the narrow kernels form them: kBi u0/u1 = x0 / d0 + m, x1 / d1
// + m with d0 = max(d, DMIN), d1 = max(srow - d, DMIN); kDense u = x / d +
// m with a zero d counting as 1 and m the lane's locus count (locus c /
// M, miss at row stride ML).  Then B = eta^T u over the segment's rows on
// the chunk's lanes on the float64 tensor cores, summed in float64 in row
// order and rounded once into part [B, n_seg, NS, Kp, WP] (column c at c
// - p_lo).  One barrier a stage: between two barriers a warp forms the
// next stage's cells and runs this stage's products, half the warps in
// one order and half in the other, so that each SM sub-partition has a
// warp on the tensor cores while the other forms cells.  The first
// chunk's blocks write zeros to the lanes past the live tiles.  x, miss
// have row stride L (kBi: miss too); miss may be null.
template <Cells C>
__global__ void __launch_bounds__(NT, 1) wide_cols_b_kernel(
    const float* __restrict__ eta, const float* __restrict__ d,
    const float* __restrict__ srow, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, const int8_t* __restrict__ miss,
    float* __restrict__ part, int I, int L, int ML, int M, int Kp, int kc,
    int s0, int s1, int ds, int p_lo, int WP, int seg_rows, int vec_x,
    int vec_m) {
  using T = WideColsTile<C>;
  constexpr bool BI = C == Cells::kBi;
  constexpr int NS = T::NS, MT = T::MT, BC = T::BC, TK = T::TK;
  constexpr int DS = T::DS, MS = T::MS, US = T::US;
  // a thread forms the cells of columns cq .. cq + 3 of rows rq + RSTEP i
  constexpr int RSTEP = NT / (BC / 4);
  char* smem = reinterpret_cast<char*>(dyn_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WC_WM, wc = warp / WC_WM;
  const int cq = 4 * (tid % (BC / 4)), rq = tid / (BC / 4);
  const int n_ch = wide_chunks(kc), c = blockIdx.z % n_ch;
  const int b = blockIdx.z / n_ch;
  int t0, nt_live;
  chunk_tiles(c, kc, &t0, &nt_live);
  const int k0 = 8 * t0, kv = 8 * nt_live;   // the chunk's lanes
  const int nj = live_tiles<WC_NTW, WC_WN>(nt_live, wc);
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = s0 + blockIdx.x * BC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const int n_st = r_hi > r_lo ? (r_hi - r_lo + TK - 1) / TK : 0;
  const float* eta_b = eta + (size_t)b * I * Kp + k0;
  const float* d_b = d + (size_t)b * I * ds + (col0 - s0);
  const float* srow_b = BI ? srow + (size_t)b * I : nullptr;
  // the generic cells' loci: [m_lo, m_hi) cover the block's lanes below
  // s1, staged from m_base (a 4-byte boundary on the vector path); a byte
  // a column of the thread's, its locus's offset there (255: no miss)
  const int m_lo = col0 / M;
  const int m_hi = min(ML, (min(s1, col0 + BC) - 1) / M + 1);
  const int m_base = vec_m ? m_lo & ~3 : m_lo;
  uint32_t m_off = 0xffffffffu;
  if (!BI && miss != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + cq + q;
      const uint32_t o = col < s1 ? (uint32_t)(col / M - m_base) : 255u;
      m_off = (m_off & ~(255u << (8 * q))) | (o << (8 * q));
    }
  }

  auto issue_eta = [&](int st) {
    float* es = reinterpret_cast<float*>(smem + (st & 1) * T::E_STAGE);
    const int r0 = r_lo + st * TK;
    for (int e = tid; e < TK * (CHUNK_LANES / 4); e += NT) {
      const int r = e / (CHUNK_LANES / 4), c4 = 4 * (e % (CHUNK_LANES / 4));
      if (c4 >= kv) continue;   // lanes past the chunk: not read
      const int row = r0 + r;
      const bool ok = row < r_hi;
      cp_async16(es + r * WB_ES + c4, ok ? eta_b + (size_t)row * Kp + c4
                                         : eta_b, ok ? 16 : 0);
    }
  };
  auto issue_cells = [&](int st) {
    char* stage = smem + T::C_OFF + (st & 1) * T::C_STAGE;
    const int r0 = r_lo + st * TK;
    float* dst = reinterpret_cast<float*>(stage);
    for (int e = tid; e < TK * (BC / 4); e += NT) {
      const int r = e / (BC / 4), c4 = 4 * (e % (BC / 4));
      const int row = r0 + r;
      const int n = row < r_hi ? max(0, min(4, s1 - col0 - c4)) : 0;
      cp_async16(dst + r * DS + c4, n > 0 ? d_b + (size_t)row * ds + c4
                                          : d_b, 4 * n);
    }
    int8_t* xs = reinterpret_cast<int8_t*>(stage + T::C_X);
    stage_bytes<TK>(xs, BC, x0, L, r0, r_hi, col0, s1, BC / 4, vec_x);
    if constexpr (BI) {
      stage_bytes<TK>(xs + TK * BC, BC, x1, L, r0, r_hi, col0, s1, BC / 4,
                      vec_x);
      if (miss != nullptr)
        stage_bytes<TK>(reinterpret_cast<int8_t*>(stage + T::C_M), MS, miss,
                        L, r0, r_hi, col0, s1, BC / 4, vec_m);
      if (tid < TK) {
        const int row = r0 + tid;
        const bool ok = row < r_hi;
        cp_async4(reinterpret_cast<float*>(stage + T::C_S) + tid,
                  ok ? srow_b + row : srow_b, ok ? 4 : 0);
      }
    } else if (miss != nullptr) {
      stage_bytes<TK>(reinterpret_cast<int8_t*>(stage + T::C_M), MS, miss,
                      ML, r0, r_hi, m_base, m_hi, (m_hi - m_base + 3) / 4,
                      vec_m);
    }
  };

  // stage st's cells, four columns a thread, into its u stage [NS][TK][US]
  auto cells = [&](int st) {
    const char* stage = smem + T::C_OFF + (st & 1) * T::C_STAGE;
    float* us = reinterpret_cast<float*>(smem + T::U_OFF +
                                         (st & 1) * T::U_STAGE);
    const float* dst = reinterpret_cast<const float*>(stage);
    const int8_t* xs = reinterpret_cast<const int8_t*>(stage + T::C_X);
    const int8_t* ms = reinterpret_cast<const int8_t*>(stage + T::C_M);
#pragma unroll 2
    for (int r = rq; r < TK; r += RSTEP) {
      const float4 dv = *reinterpret_cast<const float4*>(dst + r * DS + cq);
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
      const uint32_t xa = *reinterpret_cast<const uint32_t*>(xs + r * BC + cq);
      float u0[4], u1[4];
      if constexpr (BI) {
        const uint32_t xb = *reinterpret_cast<const uint32_t*>(
            xs + (TK + r) * BC + cq);
        const uint32_t xm = miss != nullptr
            ? *reinterpret_cast<const uint32_t*>(ms + r * MS + cq) : 0u;
        const float sr = reinterpret_cast<const float*>(stage + T::C_S)[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float m = x_byte(xm, q);
          u0[q] = fmaf(x_byte(xa, q), __frcp_rn(fmaxf(dd[q], DMIN)), m);
          u1[q] = fmaf(x_byte(xb, q), __frcp_rn(fmaxf(sr - dd[q], DMIN)), m);
        }
        *reinterpret_cast<float4*>(us + (TK + r) * US + cq) =
            make_float4(u1[0], u1[1], u1[2], u1[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t o = (m_off >> (8 * q)) & 255u;
          const float m = o != 255u ? (float)ms[r * MS + o] : 0.f;
          const float sd = dd[q] > 0.f ? dd[q] : 1.f;
          u0[q] = fmaf(x_byte(xa, q), __frcp_rn(sd), m);
        }
      }
      *reinterpret_cast<float4*>(us + r * US + cq) =
          make_float4(u0[0], u0[1], u0[2], u0[3]);
    }
  };

  double acc[NS][MT][WC_NTW][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < WC_NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][m][j][q] = 0.0;

  auto products = [&](int st) {
    const float* es =
        reinterpret_cast<const float*>(smem + (st & 1) * T::E_STAGE);
    const float* us = reinterpret_cast<const float*>(smem + T::U_OFF +
                                                     (st & 1) * T::U_STAGE);
    with_count<WC_NTW>(nj, [&](auto n) {
      wide_cols_b_stage<C, decltype(n)::value>(acc, es, us, wm, wc, g, t);
    });
  };

  // the rings: eta of stage st and the cells' inputs of stage st + 1 land
  // together, one commit group an iteration
  if (n_st > 0) {
    issue_eta(0);
    issue_cells(0);
  }
  cp_async_commit();
  if (n_st > 1) issue_cells(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // stage 0's eta and cell inputs landed
  if (n_st > 0) cells(0);
  const bool cells_first = warp < NW / 2;
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<0>();
    // stage st's cells are in u; its eta and the next stage's cell inputs
    // landed; every warp is done with the slots the copies below take
    __syncthreads();
    if (st + 1 < n_st) issue_eta(st + 1);
    if (st + 2 < n_st) issue_cells(st + 2);
    cp_async_commit();
    const bool more = st + 1 < n_st;
    if (cells_first && more) cells(st + 1);
    products(st);
    if (!cells_first && more) cells(st + 1);
  }

  // a thread holds columns 2 g, 2 g + 1 of each tile for lanes 8 (wc +
  // WC_WN j) + 2 t + {0, 1} of the chunk; the warp's dead tiles hold zeros
  const size_t bs = (size_t)b * n_seg + seg;
  float* out = part + (bs * NS * Kp + k0) * (size_t)WP;
  const bool pair = WP % 2 == 0;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int lc = col0 + 16 * (wm * MT + m) + 2 * g;
#pragma unroll
      for (int j = 0; j < WC_NTW; ++j)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k = 8 * (wc + WC_WN * j) + 2 * t + jj;
          if (k >= kv) continue;
          const float o0 = (float)acc[s][m][j][jj];
          const float o1 = (float)acc[s][m][j][2 + jj];
          float* o = out + ((size_t)s * Kp + k) * WP + (lc - p_lo);
          if (pair && lc + 1 < s1) {
            *reinterpret_cast<float2*>(o) = make_float2(o0, o1);
          } else {
            if (lc < s1) o[0] = o0;
            if (lc + 1 < s1) o[1] = o1;
          }
        }
    }
  // the lanes past the live tiles: zeros, from the first chunk's blocks
  const int k_dead = 8 * ((kc + 7) / 8);
  if (c == 0 && k_dead < Kp) {
    const int nl = min(BC, s1 - col0), nd = Kp - k_dead;
    for (int e = tid; e < NS * nd * nl; e += NT) {
      const int s = e / (nd * nl), k = k_dead + e / nl % nd;
      part[((bs * NS + s) * Kp + k) * WP + (col0 - p_lo) + e % nl] = 0.f;
    }
  }
}

// launches the wide columns pass over B chains on the columns [l_lo, l_hi)
// of arrays with row stride L (p, x; kBi: miss) and ML (the generic
// cells' miss, a locus per M columns): for each sub-window of sub_cols
// columns a d launch into the scratch (d [B, I, sub_cols], then, for kBi,
// the rows' eta sums [B, I], which the first sub-window's d launch writes)
// and a B launch into part [B, n_seg, NS, Kp, WP] (column c at c - p_lo).
// vec_p, vec_x, vec_m: p, x and miss may be staged by cp.async (16-byte
// rows of p, 4-byte words of x and miss).  Returns the first nonzero
// cudaError_t.
template <Cells C>
inline int launch_cols_wide(const void* eta, const void* p, const void* x0,
                            const void* x1, const void* miss, void* part,
                            void* scratch, int B, int I, int L, int ML,
                            int M, int Kp, int k_true, int l_lo, int l_hi,
                            int p_lo, int WP, int n_seg, int seg_rows,
                            int sub_cols, int vec_p, int vec_x, int vec_m,
                            cudaStream_t s) {
  using T = WideColsTile<C>;
  const int kc = wide_kc(k_true, Kp), n_ch = wide_chunks(kc);
  if (scratch == nullptr || ((uintptr_t)scratch & 15) || sub_cols < 4 ||
      sub_cols % 4 || M < 1 || (size_t)B * n_ch > 65535)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0) err = allow_smem(wide_cols_d_kernel);
  if (err == 0) err = allow_smem(wide_cols_b_kernel<C>);
  if (err != 0) return err;
  float* d = (float*)scratch;
  float* srow = C == Cells::kBi ? d + (size_t)B * I * sub_cols : nullptr;
  for (int s0 = l_lo; s0 < l_hi; s0 += sub_cols) {
    const int s1 = l_hi - s0 < sub_cols ? l_hi : s0 + sub_cols;
    const int tiles = (I + WD_M - 1) / WD_M * ((s1 - s0 + WD_N - 1) / WD_N)
                      * B;
    wide_cols_d_kernel<<<tiles < n_sm ? tiles : n_sm, NT, WD_SMEM, s>>>(
        (const float*)eta, (const float*)p, d, s0 == l_lo ? srow : nullptr,
        B, I, L, Kp, kc, s0, s1, sub_cols, vec_p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const dim3 grid((s1 - s0 + T::BC - 1) / T::BC, n_seg, B * n_ch);
    wide_cols_b_kernel<C><<<grid, NT, T::SMEM, s>>>(
        (const float*)eta, d, srow, (const int8_t*)x0, (const int8_t*)x1,
        (const int8_t*)miss, (float*)part, I, L, ML, M, Kp, kc, s0, s1,
        sub_cols, p_lo, WP, seg_rows, vec_x, vec_m);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace
