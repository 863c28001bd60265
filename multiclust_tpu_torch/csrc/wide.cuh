// The admixture step's passes for 128 < Kp <= 1024: the wide rows pass
// and the wide columns pass (biallelic and generic cells), on one d launch
// for both, and the rows pass's wide finish.  csrc/fullstep_bi.cu and
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
// memory.  So d = eta @ p, which needs a row's whole cluster axis, is
// written once to a scratch plane and read by the contractions that need
// a lane chunk at a time; all three products run on the float64 tensor
// cores (`mma.sync` m16n8k16 DMMA, csrc/dmma.cuh; `wgmma` has no float64
// form) on float32 operands converted in registers, 4 x 4 DMMA tiles a
// warp.
//
// * d launch (`wide_cols_d_kernel`): a persistent grid over tiles of 128
//   rows x 128 columns of a column sub-window; eta and p stream by
//   cp.async in stages of 64 lanes (a ring of two, one barrier a stage, a
//   block's tiles one stream of stages).  d is summed in float64 over the
//   lanes in order and rounded to float32 once into a scratch plane [B, I,
//   sub-window]; with the biallelic cells the first column tile also
//   writes each row's eta summed over its kc lanes (one warp a row,
//   float64, lanes in a fixed order).
// * A launch, the rows pass (`wide_rows_a_kernel`): block (64 rows x a
//   lane chunk, column segment, chain), the live lanes (ceil(kc / 8) tiles
//   of 8) in balanced chunks of at most 256 (csrc/dmma.cuh), so that each
//   cell is formed for as few chunks as the accumulators allow.  It walks
//   the segment's columns of the sub-window in stages of 32; cp.async
//   rings of two bring, a stage ahead, the chunk's p columns and the
//   cells' inputs (d, x0 / x1; the rows' eta sums once).  The cells are
//   formed in float32 into shared memory as the narrow kernels form them
//   (kBi: u = x0 / max(d, DMIN) - x1 / max(srow - d, DMIN), r = the row's
//   sum of the second term, t = x0 log d0 + x1 log d1; kDense: u = x / d
//   with a zero d counting as 1), then A += u p^T on DMMA, summed in
//   float64 over the segment's columns in order and rounded to float32
//   once.  One barrier a stage: between two, a warp forms the next stage's
//   cells and runs this stage's products, half the warps in each order.
//   Every chunk sums r (it forms w1 anyway); only the first chunk's blocks
//   take the logs of t and write t and the lanes past the live tiles.
//   compute_a == 0 (the t-only logL): one chunk, no products.
// * B launch, the columns pass (`wide_cols_b_kernel`): block (column tile,
//   row segment, chain x lane chunk), stages of 64 rows (48 with the
//   generic cells); cp.async rings of two bring the chunk's eta and, a
//   stage ahead, the cells' inputs (d, x, miss, the rows' eta sums).  The
//   cells are formed in float32 into shared memory (u = x *
//   __frcp_rn(max(d, DMIN)) + miss, the second allele on srow - d; the
//   generic cells a zero d counting as 1, miss by the lane's locus); B +=
//   eta^T u runs on DMMA (2 x 4 tiles a stream with two, which share each
//   eta fragment), through code made for the warp's number of live lane
//   tiles, with the same one barrier a stage (with a barrier between cells
//   and products, W3 and W4 took 6-31 % longer, PERF.md).  The block's
//   float64 sums are rounded to float32 once, as the segment's partials.
//   Biallelic blocks take 64 columns, generic ones 128.
// * The launcher (`launch_wide`) cuts the window into sub-windows of whole
//   d tiles so that the scratch stays within SCRATCH_CAP (192 MiB: 1536
//   columns at 2 chains x 16384 rows; ops/fullstep_bi.cols_sub_cols) and
//   runs, for each, the d launch and then the A launch, the B launch or
//   both on that d: a step that runs both passes on the same (eta, p)
//   computes d once (three contractions, not four).  A column segment of
//   the rows pass that spans several sub-windows gets each sub-window's
//   part added to its partials in sub-window order (float32; no atomics).
// * finish (`wide_finish_kernel<KJ>`): one warp a row as in tiles.cuh, the
//   partials read straight from device memory into registers (KJ = 8, 16
//   or 32 values a lane for Kp <= 256, 512, 1024), the Michelot passes of
//   simplex.cuh.  The t-only finish is tiles.cuh's rows_finish_t_kernel,
//   which takes any Kp.
//
// Bound: the contractions d, A and B0/B1 (the generic d, A and B), 2 kc
// FMA a cell and product: against a few bytes of x a cell, operations
// first, on DMMA at 67 TFLOP/s.  The d scratch adds 4 bytes a cell written
// and 4 read a lane chunk and pass.
//
// Sums that are float64: d over the lanes, each row's eta sum srow, A
// within a segment's sub-window and B within a row segment (the fmaf
// versions summed them in float32); d and srow are rounded to float32
// before the cells (d1 = srow - d in float32), the partials once at the
// end of a block; a segment's sub-windows, and the segments in the finish
// and the epilogues, add in float32 in order; t in float32 within a
// segment, float64 across segments.
//
// Where the loops stop: kc = k_true rounded up to 4 lanes (the d stages
// stop at kc rounded up to 16, the A and B launches at the live tiles of
// 8, on zeros past kc), and the outputs past kc are written as the narrow
// kernels write them: the row's sum of w1 (biallelic A + r) or 0.  K stays
// padded to 32 lanes (Kp = 224 for K = 200): no layout of
// runtime/multistart.py changes.
//
// No atomics: every sum runs in a fixed order (d and the row sums over
// lanes in order, A over columns, B over rows, the sub-windows, the
// finish over segments), so reruns are bit-equal.  Ragged I and L edges
// and the lanes past kc are zeros in the staged tiles and in x, not masks
// in the arithmetic.
#pragma once

#include "dmma.cuh"
#include "tiles.cuh"

namespace {

constexpr int KP_WIDE_MAX = 1024;

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

// ---------------------------------------------------------------------------
// the d launch and the columns pass's B launch

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

// ---------------------------------------------------------------------------
// rows pass: the A launch on a sub-window's d

// A block: WA_M rows (4 tiles of 16, every warp) x a lane chunk of at most
// WA_LANES (WA_WN warps of WA_NTW tiles of 8, tile warp + WA_WN j), stages
// of WA_K columns.  A chunk twice as wide as the B launch's, on half the
// rows, keeps the accumulators a thread holds and forms each cell for
// half as many chunks: at K = 200 one chunk, at 1024 four (with 128 x 128
// blocks the cells took as long as the products, PERF.md).  WA_S = WA_K +
// 4: a fragment's reads of u (rows g, columns t + 4 q) and of p (lanes g,
// columns t + 4 q) hit banks 4 g + t.  Shared memory, in bytes: a ring of
// two p-chunk stages [WA_LANES][WA_S] floats, two stages of the cells u
// [WA_M][WA_S], a ring of two stages of the cells' inputs (d [WA_M][WA_S]
// floats, x0 and x1 [WA_M][WA_K] bytes), the rows' eta sums, their t and
// r.
constexpr int WA_M = 64, WA_K = 32, WA_S = WA_K + 4;
constexpr int WA_WN = NW, WA_NTW = 4, WA_LANES = 8 * WA_NTW * WA_WN;
constexpr int WA_P_STAGE = 4 * WA_LANES * WA_S;
constexpr int WA_U_STAGE = 4 * WA_M * WA_S;
constexpr int WA_C_X = 4 * WA_M * WA_S;   // x0 in a cells-input stage
constexpr int WA_C_STAGE = WA_C_X + 2 * WA_M * WA_K;
constexpr int WA_U_OFF = 2 * WA_P_STAGE;
constexpr int WA_C_OFF = WA_U_OFF + 2 * WA_U_STAGE;
constexpr int WA_S_OFF = WA_C_OFF + 2 * WA_C_STAGE;   // srow, t, r [WA_M]
constexpr int WA_SMEM = WA_S_OFF + 3 * 4 * WA_M;
static_assert(WA_P_STAGE % 16 == 0 && WA_C_STAGE % 16 == 0 &&
              WA_C_X % 16 == 0 && WA_SMEM <= SMEM_MAX, "A block smem");
static_assert(WA_M == 16 * 4 && NT / (WA_K / 4) == 32,
              "a warp's 4 row tiles; cells: 2 rows a thread");

// One stage of the A launch's products for a warp with NJ live lane tiles:
// A = u (rows g, g + 8 of a 16-row tile), B = p^T (lanes g of an 8-lane
// tile), slot q of thread t column t + 4 q of a 16-column step.
template <int NJ>
__device__ __forceinline__ void wide_rows_a_stage(
    double (&acc)[4][WA_NTW][4], const float* ps, const float* us, int wc,
    int g, int t) {
#pragma unroll
  for (int c = 0; c < WA_K / 16; ++c) {
    double bb[NJ > 0 ? NJ : 1][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* pt = ps + (8 * (wc + WA_WN * j) + g) * WA_S + 16 * c + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) bb[j][q] = pt[4 * q];
    }
#pragma unroll
    for (int m = 0; NJ > 0 && m < 4; ++m) {
      const float* ut = us + (16 * m + g) * WA_S + 16 * c + t;
      double a[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[2 * q] = ut[4 * q];
        a[2 * q + 1] = ut[8 * WA_S + 4 * q];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) dmma16(acc[m][j], a, bb[j]);
    }
  }
}

// The A launch: block (x: lane chunk + n_ch x row tile of WA_M rows, y:
// column segment among those the sub-window [s0, s1) meets, z: chain)
// forms the cells of the segment's columns in [s0, s1) from d (the d
// launch's, column c at c - s0, row stride ds), x and (kBi) the rows' eta
// sums srow, then A = u p^T over those columns on the chunk's lanes, summed
// in float64 and rounded once; it writes A + r (kBi; A with kDense) to the
// segment's partials apart [B, n_seg, I, Kp] and, for the first chunk, t to
// tpart [B, n_seg, I] and r (or 0) to the lanes past the live tiles, or
// adds them there when the segment began in an earlier sub-window.  The
// segments are [l_lo + s seg_cols, + seg_cols).  x and p have row stride
// L; vec: p, d and x staged by cp.async (every stage's first column a
// multiple of 4), else by plain loads.  compute_a == 0: one chunk on the
// grid, t alone (apart unused).
template <Cells C>
__global__ void __launch_bounds__(NT, 1) wide_rows_a_kernel(
    const float* __restrict__ p, const float* __restrict__ d,
    const float* __restrict__ srow, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, float* __restrict__ apart,
    float* __restrict__ tpart, int I, int L, int Kp, int kc, int l_lo,
    int seg_cols, int n_seg, int s0, int s1, int ds, int compute_t,
    int compute_a, int vec) {
  constexpr bool BI = C == Cells::kBi;
  // a thread forms the cells of columns cq .. cq + 3 of rows rq + RSTEP i
  constexpr int RSTEP = NT / (WA_K / 4), RI = WA_M / RSTEP;
  char* smem = reinterpret_cast<char*>(dyn_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp;
  const int cq = 4 * (tid % (WA_K / 4)), rq = tid / (WA_K / 4);
  const int n_ch = compute_a ? wide_chunks<WA_LANES>(kc) : 1;
  const int c = blockIdx.x % n_ch, row0 = blockIdx.x / n_ch * WA_M;
  const int b = blockIdx.z;
  const int seg = (s0 - l_lo) / seg_cols + blockIdx.y;
  const int start = l_lo + seg * seg_cols;
  const int c_lo = max(start, s0), c_hi = min(start + seg_cols, s1);
  const bool accumulate = start < s0;
  const bool t_on = compute_t && c == 0;
  int t0, nt_live;
  chunk_tiles<WA_LANES>(c, kc, &t0, &nt_live);
  const int k0 = 8 * t0, kv = compute_a ? 8 * nt_live : 0;
  const int nj = compute_a ? live_tiles<WA_NTW, WA_WN>(nt_live, wc) : 0;
  const int n_st = (c_hi - c_lo + WA_K - 1) / WA_K;
  const float* p_b = p + ((size_t)b * Kp + k0) * L;
  const float* d_b = d + (size_t)b * I * ds - s0;
  float* srow_s = reinterpret_cast<float*>(smem + WA_S_OFF);
  float* t_s = srow_s + WA_M;
  float* r_s = t_s + WA_M;

  auto issue_p = [&](int st) {
    float* ps = reinterpret_cast<float*>(smem + (st & 1) * WA_P_STAGE);
    const int col0 = c_lo + st * WA_K;
    for (int e = tid; e < kv * (WA_K / 4); e += NT) {
      const int k = e / (WA_K / 4), c4 = 4 * (e % (WA_K / 4));
      const int col = col0 + c4;
      const int n = k0 + k < kc ? max(0, min(4, c_hi - col)) : 0;
      float* dst = ps + k * WA_S + c4;
      if (vec) {
        cp_async16(dst, n > 0 ? p_b + (size_t)k * L + col : p_b, 4 * n);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = q < n ? p_b[(size_t)k * L + col + q] : 0.f;
      }
    }
  };
  auto issue_cells = [&](int st) {
    char* stage = smem + WA_C_OFF + (st & 1) * WA_C_STAGE;
    const int col0 = c_lo + st * WA_K;
    float* dd = reinterpret_cast<float*>(stage);
    for (int e = tid; e < WA_M * (WA_K / 4); e += NT) {
      const int r = e / (WA_K / 4), c4 = 4 * (e % (WA_K / 4));
      const int row = row0 + r, col = col0 + c4;
      const int n = row < I ? max(0, min(4, c_hi - col)) : 0;
      const float* src = d_b + (size_t)row * ds + col;
      float* dst = dd + r * WA_S + c4;
      if (vec) {
        cp_async16(dst, n > 0 ? src : d, 4 * n);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = q < n ? src[q] : 0.f;
      }
    }
    int8_t* xs = reinterpret_cast<int8_t*>(stage + WA_C_X);
    stage_bytes<WA_M>(xs, WA_K, x0, L, row0, I, col0, c_hi, WA_K / 4, vec);
    if constexpr (BI)
      stage_bytes<WA_M>(xs + WA_M * WA_K, WA_K, x1, L, row0, I, col0, c_hi,
                        WA_K / 4, vec);
  };

  // stage st's cells into its u stage; t and r of the thread's rows
  float tacc[RI], racc[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) tacc[i] = racc[i] = 0.f;
  auto cells = [&](int st) {
    const char* stage = smem + WA_C_OFF + (st & 1) * WA_C_STAGE;
    float* us = reinterpret_cast<float*>(smem + WA_U_OFF +
                                         (st & 1) * WA_U_STAGE);
    const float* dd = reinterpret_cast<const float*>(stage);
    const int8_t* xs = reinterpret_cast<const int8_t*>(stage + WA_C_X);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rq + RSTEP * i;
      const float4 dv = *reinterpret_cast<const float4*>(dd + r * WA_S + cq);
      const float dq[4] = {dv.x, dv.y, dv.z, dv.w};
      const uint32_t xa = *reinterpret_cast<const uint32_t*>(
          xs + r * WA_K + cq);
      float u[4], tt = 0.f, rr = 0.f;
      if constexpr (BI) {
        const uint32_t xb = *reinterpret_cast<const uint32_t*>(
            xs + (WA_M + r) * WA_K + cq);
        const float sr = srow_s[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a0 = x_byte(xa, q), a1 = x_byte(xb, q);
          const float dd0 = fmaxf(dq[q], DMIN);
          const float dd1 = fmaxf(sr - dq[q], DMIN);
          const float w0 = a0 * __frcp_rn(dd0), w1 = a1 * __frcp_rn(dd1);
          if (t_on) tt += a0 * logf(dd0) + a1 * logf(dd1);
          rr += w1;
          u[q] = w0 - w1;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xv = x_byte(xa, q);
          const float sd = dq[q] > 0.f ? dq[q] : 1.f;
          u[q] = xv * __frcp_rn(sd);   // 0 where x = 0
          if (t_on && xv > 0.f) tt += xv * logf(sd);
        }
      }
      tacc[i] += tt;
      racc[i] += rr;
      if (compute_a)
        *reinterpret_cast<float4*>(us + r * WA_S + cq) =
            make_float4(u[0], u[1], u[2], u[3]);
    }
  };

  double acc[4][WA_NTW][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < WA_NTW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.0;
  auto products = [&](int st) {
    const float* ps =
        reinterpret_cast<const float*>(smem + (st & 1) * WA_P_STAGE);
    const float* us = reinterpret_cast<const float*>(smem + WA_U_OFF +
                                                     (st & 1) * WA_U_STAGE);
    with_count<WA_NTW>(nj, [&](auto n) {
      wide_rows_a_stage<decltype(n)::value>(acc, ps, us, wc, g, t);
    });
  };

  // the rings: p of stage st and the cells' inputs of stage st + 1 land
  // together, one commit group an iteration; the rows' eta sums with the
  // first group
  if (BI && tid < WA_M) {
    const int row = row0 + tid;
    const float* sb = srow + (size_t)b * I;
    cp_async4(srow_s + tid, row < I ? sb + row : sb, row < I ? 4 : 0);
  }
  issue_p(0);
  issue_cells(0);
  cp_async_commit();
  if (n_st > 1) issue_cells(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // stage 0's p and cell inputs landed
  cells(0);
  const bool cells_first = warp < NW / 2;
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<0>();
    // stage st's cells are in u; its p and the next stage's cell inputs
    // landed; every warp is done with the slots the copies below take
    __syncthreads();
    if (st + 1 < n_st) issue_p(st + 1);
    if (st + 2 < n_st) issue_cells(st + 2);
    cp_async_commit();
    const bool more = st + 1 < n_st;
    if (cells_first && more) cells(st + 1);
    products(st);
    if (!cells_first && more) cells(st + 1);
  }

  // each row's t and r over its WA_K / 4 column threads, in a fixed order
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float tt = tacc[i], rr = racc[i];
#pragma unroll
    for (int o = 1; o < WA_K / 4; o <<= 1) {
      tt += __shfl_xor_sync(mc::FULL, tt, o);
      rr += __shfl_xor_sync(mc::FULL, rr, o);
    }
    if (tid % (WA_K / 4) == 0) {
      t_s[rq + RSTEP * i] = tt;
      r_s[rq + RSTEP * i] = BI ? rr : 0.f;
    }
  }
  __syncthreads();
  const size_t o0 = ((size_t)b * n_seg + seg) * I;
  if (c == 0 && tid < WA_M && row0 + tid < I) {
    float* o = tpart + o0 + row0 + tid;
    *o = accumulate ? *o + t_s[tid] : t_s[tid];
  }
  if (!compute_a) return;
  // a thread holds rows g, g + 8 of each tile and lanes 8 (wc + WA_WN j) +
  // 2 t + {0, 1} of the chunk; the warp's dead tiles hold zeros
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * m + g + 8 * h, row = row0 + rl;
      if (row >= I) continue;
      const float rr = r_s[rl];
      float* ar = apart + (o0 + row) * Kp + k0;
#pragma unroll
      for (int j = 0; j < WA_NTW; ++j) {
        const int k = 8 * (wc + WA_WN * j) + 2 * t;
        if (k >= kv) continue;
        float2 v = make_float2((float)acc[m][j][2 * h] + rr,
                               (float)acc[m][j][2 * h + 1] + rr);
        float2* o = reinterpret_cast<float2*>(ar + k);
        if (accumulate) {
          const float2 old = *o;
          v = make_float2(old.x + v.x, old.y + v.y);
        }
        *o = v;
      }
    }
  // the lanes past the live tiles: r (or 0), from the first chunk's blocks
  const int k_dead = 8 * ((kc + 7) / 8);
  if (c == 0 && k_dead < Kp) {
    const int nd = Kp - k_dead;
    for (int e = tid; e < WA_M * nd; e += NT) {
      const int r = e / nd, row = row0 + r;
      if (row >= I) continue;
      float* o = apart + (o0 + row) * Kp + k_dead + e % nd;
      *o = accumulate ? *o + r_s[r] : r_s[r];
    }
  }
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
// be null; pad lanes of eta must be zero.  Built for KJ = 8, 16 and 32
// (Kp <= 256, 512, 1024), each bounded to the blocks an SM its registers
// allow.
template <int KJ>
__global__ void __launch_bounds__(NT, KJ <= 8 ? 4 : KJ <= 16 ? 3 : 2)
    wide_finish_kernel(const float* __restrict__ eta,
                       const float* __restrict__ apart,
                       const float* __restrict__ tpart,
                       const float* __restrict__ a0,
                       const float* __restrict__ c,
                       const float* __restrict__ kmask,
                       float* __restrict__ out, double* __restrict__ t_out,
                       int I, int Kp, int n_seg, int kc, int k_true,
                       float lb, int emit_a, int project_eta,
                       int compute_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * NW + warp;
  if (row >= I) return;   // warps share nothing
  const int b = blockIdx.y;
  const size_t br = (size_t)b * I + row;
  const int pad = emit_a && kc < Kp ? kc : -1;
  // the lane of apart that slot j reads (-1: none)
  auto col = [&](int j) {
    const int k = lane + 32 * j;
    return k >= Kp ? -1 : k < kc ? k : pad;
  };
  float a[KJ], e[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    a[j] = a0 != nullptr && col(j) >= 0 ? a0[br * Kp + k] : 0.f;
    e[j] = !emit_a && k < kc ? eta[br * Kp + k] : 0.f;
  }
  const float ci = c != nullptr ? c[row] : 0.f;
  double tt = 0.0;
  for (int s = 0; s < n_seg; ++s) {
    const size_t bs = ((size_t)b * n_seg + s) * I + row;
    const float* ap = apart + bs * Kp;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      if (col(j) >= 0) a[j] += ap[col(j)];
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
      unsigned valid = 0u;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = lane + 32 * j;
        if (k < Kp && (kmask != nullptr ? kmask[k] > 0.5f : k < k_true))
          valid |= 1u << j;
      }
      mc::michelot_warp_mask<KJ>(a, valid, lb);
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < Kp) o[lane + 32 * j] = a[j];
}

// launches the finish over B chains of I rows at a wide Kp, at the KJ of
// Kp; `out` null: only t (tiles.cuh's t-only kernel, which takes any Kp);
// returns the launch's cudaError_t
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
#define MC_FINISH(KJ)                                                       \
  wide_finish_kernel<KJ><<<grid, NT, 0, s>>>(                               \
      (const float*)eta, (const float*)apart, (const float*)tpart,          \
      (const float*)a0, (const float*)c, (const float*)kmask, (float*)out,  \
      (double*)t_out, I, Kp, n_seg, kc, k_true, lb, emit_a, project_eta,    \
      compute_t)
  if (Kp <= 256)
    MC_FINISH(8);
  else if (Kp <= 512)
    MC_FINISH(16);
  else
    MC_FINISH(32);
#undef MC_FINISH
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the launcher: a d launch, then the A launch, the B launch or both, for
// each column sub-window

// One wide launch sequence over B chains on the columns [l_lo, l_hi) of
// arrays with row stride L (p, x; kBi: miss) and ML (the generic cells'
// miss, a locus per M columns).  scratch: d [B, I, sub_cols] float32,
// then, for kBi, the rows' eta sums [B, I] (16-byte aligned).
// * the rows pass (tpart non-null): its partials apart [B, n_cseg, I, Kp]
//   (with compute_a) and tpart [B, n_cseg, I] over column segments of
//   seg_cols; vec_a: p, d and x of its stages by cp.async;
// * the columns pass (part non-null): its partials part [B, n_rseg, NS,
//   Kp, WP] (column c at c - p_lo) over row segments of seg_rows; vec_p,
//   vec_x, vec_m: p, x and miss by cp.async (16-byte rows of p, 4-byte
//   words of x and miss).
struct WideLaunch {
  const void *eta, *p, *x0, *x1, *miss;
  void* scratch;
  int B, I, L, Kp, k_true, l_lo, l_hi, sub_cols, vec_p;
  void *apart, *tpart;
  int seg_cols, n_cseg, compute_t, compute_a, vec_a;
  void* part;
  int ML, M, p_lo, WP, n_rseg, seg_rows, vec_x, vec_m;
};

// runs `w`: for each sub-window of sub_cols columns a d launch into the
// scratch (the first also writes the rows' eta sums), then the A launch
// and the B launch on that d, each where `w` asks for it; returns the
// first nonzero cudaError_t
template <Cells C>
inline int launch_wide(const WideLaunch& w, cudaStream_t s) {
  using T = WideColsTile<C>;
  const bool rows = w.tpart != nullptr, cols = w.part != nullptr;
  const int kc = wide_kc(w.k_true, w.Kp), n_ch = wide_chunks(kc);
  const int n_a = w.compute_a ? wide_chunks<WA_LANES>(kc) : 1;
  const int n_rt = (w.I + WA_M - 1) / WA_M;
  if (w.scratch == nullptr || ((uintptr_t)w.scratch & 15) ||
      w.sub_cols < 4 || w.sub_cols % 4 || (size_t)w.B * n_ch > 65535 ||
      (rows && (w.seg_cols < 1 || w.n_cseg > 65535 ||
                (size_t)n_rt * n_a > 0x7fffffff)) ||
      (cols && w.M < 1))
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0) err = allow_smem(wide_cols_d_kernel);
  if (err == 0 && rows) err = allow_smem(wide_rows_a_kernel<C>);
  if (err == 0 && cols) err = allow_smem(wide_cols_b_kernel<C>);
  if (err != 0) return err;
  float* d = (float*)w.scratch;
  float* srow =
      C == Cells::kBi ? d + (size_t)w.B * w.I * w.sub_cols : nullptr;
  for (int s0 = w.l_lo; s0 < w.l_hi; s0 += w.sub_cols) {
    const int s1 = w.l_hi - s0 < w.sub_cols ? w.l_hi : s0 + w.sub_cols;
    const int tiles = (w.I + WD_M - 1) / WD_M * ((s1 - s0 + WD_N - 1) / WD_N)
                      * w.B;
    wide_cols_d_kernel<<<tiles < n_sm ? tiles : n_sm, NT, WD_SMEM, s>>>(
        (const float*)w.eta, (const float*)w.p, d,
        s0 == w.l_lo ? srow : nullptr, w.B, w.I, w.L, w.Kp, kc, s0, s1,
        w.sub_cols, w.vec_p);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (rows) {
      // the column segments the sub-window meets
      const int g0 = (s0 - w.l_lo) / w.seg_cols;
      const int g1 = (s1 - 1 - w.l_lo) / w.seg_cols;
      wide_rows_a_kernel<C><<<dim3(n_rt * n_a, g1 - g0 + 1, w.B), NT,
                              WA_SMEM, s>>>(
          (const float*)w.p, d, srow, (const int8_t*)w.x0,
          (const int8_t*)w.x1, (float*)w.apart, (float*)w.tpart, w.I, w.L,
          w.Kp, kc, w.l_lo, w.seg_cols, w.n_cseg, s0, s1, w.sub_cols,
          w.compute_t, w.compute_a, w.vec_a);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    if (cols) {
      const dim3 grid((s1 - s0 + T::BC - 1) / T::BC, w.n_rseg, w.B * n_ch);
      wide_cols_b_kernel<C><<<grid, NT, T::SMEM, s>>>(
          (const float*)w.eta, d, srow, (const int8_t*)w.x0,
          (const int8_t*)w.x1, (const int8_t*)w.miss, (float*)w.part, w.I,
          w.L, w.ML, w.M, w.Kp, kc, s0, s1, w.sub_cols, w.p_lo, w.WP,
          w.seg_rows, w.vec_x, w.vec_m);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // namespace
