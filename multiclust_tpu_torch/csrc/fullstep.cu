// Generic (multi-allelic) admixture full EM step for Hopper (sm_90a): a
// rows pass with its finish, a columns pass and a p epilogue.
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
// row blocks.  Hopper blocks run concurrently, so the step is split as
// csrc/fullstep_bi.cu splits the biallelic one, with no atomics
// (deterministic), and built from the same register tiles and cp.async
// rings (csrc/tiles.cuh):
//
// * rows pass: block (chain, rows, column segment) runs the rows loop of
//   tiles.cuh with the generic cells: its eta rows resident in shared
//   memory, p2 tiles of 32 lanes streamed through a ring of two, d as a
//   register tile of CW rows x 4 lanes a thread, w once through the warp's
//   shared memory, A = w p2^T as a register tile of 4 rows x 4 JT clusters
//   kept across all tiles.  It writes the segment's raw A and t; the
//   finish kernel of tiles.cuh sums the segments in order (t in float64),
//   adds a0 and c and runs the eta finish and Michelot one warp a row, or
//   writes the raw A under `finish` = 0.  The segments (ops/fullstep.py
//   picks them as the biallelic streamed step does) fill the card when
//   the chain batch's rows alone do not.  Where M is a multiple of 4 a
//   thread's four lanes are one locus, at most ploidy of them non-zero,
//   and the sparse cells take the reciprocal and the log of those only.
// * columns pass: block (chain, row segment, TC lanes) keeps its p2 block
//   [KC][TC] resident and streams eta, x and miss tiles of 4 GL rows
//   through a cp.async ring of two (x and miss as whole 4-byte words of
//   the block's lanes and loci), one barrier a tile; d is a register tile
//   of 4 rows x 4 lanes a thread, B = eta^T (w + miss) one of 4 JT
//   clusters x the same 4 lanes, kept across the segment and written as
//   its partials (rows k >= KC written 0).  A thread reads its four lanes'
//   x as one word and the miss count once per (row, locus).  No load is
//   held in registers, so the kernel fits 80 registers and three blocks
//   an SM at Kp = 32 (the register lookahead of x and miss that the
//   biallelic kernel keeps took 113 and two blocks, 1.66-1.69 ms against
//   1.24-1.27 at 16384 x 2048 x M = 4, 2 chains, K = 20; NVIDIA H100
//   80GB HBM3, 700 W, PERF.md).  TC = 8 x 4 CW lanes (K = 20: 192), so eta
//   passes through L2 L*M / TC times a step and not L*M / 16.
// * p epilogue: one aligned group of G lanes per (chain, k, locus) sums
//   the partials in segment order, forms p B, normalizes over the valid
//   lanes and runs the masked Michelot with plb on the card, keeping the
//   K-pad rows exactly 0 (`_normalize_p`, model/admixture.py:72-88, which
//   JAX runs in XLA after the kernel).  `finish` = 0 writes raw B instead.
//
// Bound: four contractions of I x L*M x K per step (denom twice, A, B) in
// IEEE f32 FMA on the CUDA cores (no TF32), against one byte of x a lane
// read twice: instruction issue and latency, not device memory.  The k
// loops stop at the lane tile of k_true (K = 20: 20 of Kp = 32 lanes).
// Per lane the passes do 2 K FMA of products, a reciprocal, and in the
// rows pass a logf under x > 0.  w = x * __frcp_rn(d): a division x / d
// with x = 0 leaves the division's fast path (its range check sends a
// zero numerator to the slow routine), and x is 0 on at least M - ploidy
// of a locus's M lanes.  For counts 0, 1, 2 and 4 (ploidy <= 2, and the
// power-of-two counts of any ploidy) the product is bit-equal to the
// quotient; a count of 3 may differ from x / d in the last bit.  Not
// exploited yet: the dense products are computed where x = 0 all the same
// (ROADMAP queue 3, zero lanes).
//
// Ragged I and L*M edges are masked in the loads; the caller pads only K,
// to Kp in {32, 64, 96, 128} for these kernels.  For 128 < Kp <= 1024 the
// rows pass, its finish and the columns pass are the wide kernels of
// wide.cuh (the generic cells, over L*M lanes); the p epilogue takes any
// Kp.  Sums are in a fixed order: reruns are bit-equal.

#include "wide.cuh"

namespace {

// rows of w a step of the columns pass's B-phase loop unrolled together
constexpr int GB_UNROLL = 4;

// Segmented rows pass: block (x = R rows, y = column segment, z = chain)
// covers the lanes [y seg_cols, + seg_cols) of [0, LM) and writes its raw
// A and t as that segment's partials, apart [B, n_seg, I, KP] (lanes k >=
// KC written 0: p2 is zero there) and tpart [B, n_seg, I].  C: the
// generic cells, kSparse where each thread's four lanes are one locus.
template <int KP, Cells C>
__global__ void __launch_bounds__(NT, KP <= 32 ? 2 : 1)
    fullstep_rows_kernel(const float* __restrict__ eta,
                         const float* __restrict__ p2,
                         const int8_t* __restrict__ x2,
                         float* __restrict__ apart,
                         float* __restrict__ tpart_out, int I, int LM,
                         int seg_cols, int compute_t, LaneTile lt, int vec) {
  constexpr int JTM = KP / 32, ES = KP + 4;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RW = ROW_AR * CW, R = NW * RW;
  float* smem = reinterpret_cast<float*>(dyn_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int row0 = blockIdx.x * R, rw0 = warp * RW;
  const int c_lo = seg * seg_cols, c_hi = min(LM, c_lo + seg_cols);
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p2 + (size_t)b * KP * LM;

  float acc[JTM][4][ROW_AR];
  rows_accumulate<KP, C>(smem, eta_b, p_b, x2, nullptr, row0, I, LM, c_lo,
                         c_hi, compute_t, 1, lt, vec, acc);
  const float* t_s = smem + R * ES + 2 * KC * ROW_PS + R * ROW_PS;
  const size_t o0 = ((size_t)b * n_seg + seg) * I;

  for (int rl = lane; rl < RW; rl += 32) {
    const int row = row0 + rw0 + rl;
    if (row < I) tpart_out[o0 + row] = t_s[rw0 + rl];
  }
  int a = lane / CW, cr = lane % CW;
  if (a >= GL) a = 0, cr = 0;
#pragma unroll
  for (int i = 0; i < ROW_AR; ++i) {
    const int row = row0 + rw0 + cr + CW * i;
    if (row >= I) continue;
    float* out = apart + (o0 + row) * KP;
#pragma unroll
    for (int j = 0; j < JTM; ++j)
      if (j == 0 || j < JT)
#pragma unroll
        for (int q = 0; q < 4; ++q) out[a + GL * (4 * j + q)] = acc[j][q][i];
  }
  for (int rl = 0; rl < RW; ++rl) {
    const int row = row0 + rw0 + rl;
    if (row >= I) break;
    for (int k = KC + lane; k < KP; k += 32) apart[(o0 + row) * KP + k] = 0.f;
  }
}

// Bytes a row of a columns-pass block's miss tile takes: the loci of TC
// lanes at M a locus, from a multiple of 4 below the first, in words.
__host__ __device__ inline int miss_tile_bytes(int TC, int M) {
  return ((TC + M - 1) / M + 8) & ~3;
}

// Shared memory of a columns-pass block: in floats eta_s [2][RI][KP + 4],
// p_s [KC][TC], w_s [NW][RI][TCW]; then in bytes x_s [2][RI][TC] and m_s
// [2][RI][MS]; RI = 4 GL rows a tile, TCW = 4 CW lanes a warp, TC = NW TCW
// lanes a block, MS = miss_tile_bytes(TC, M).
__host__ __device__ inline int cols_smem_bytes(int KP, const LaneTile& lt,
                                               int M) {
  const int RI = COL_DR * lt.gl, TCW = COL_CT * lt.cw, TC = NW * TCW;
  return 4 * (2 * RI * (KP + 4) + lt.kc * TC + NW * RI * TCW) +
         2 * RI * (TC + miss_tile_bytes(TC, M));
}

// The x and miss tiles of the rows [r0, r0 + RI) below r_hi into x_s
// [RI][TC] (the lanes [col0, col0 + TC)) and m_s [RI][MS] (the loci from
// lstart, a multiple of 4), zeros past the edges: 4-byte asynchronous
// copies where the rows are aligned (xv, mv), plain loads otherwise.
__device__ __forceinline__ void cols_issue_xm(
    int8_t* x_s, int8_t* m_s, const int8_t* __restrict__ x2,
    const int8_t* __restrict__ miss, int r0, int r_hi, int RI, int col0,
    int TC, int MS, int LM, int L, int lstart, int xv, int mv) {
  const int XW = TC / 4, MW = MS / 4;
  for (int e = threadIdx.x; e < RI * XW; e += NT) {
    const int r = e / XW, c4 = 4 * (e % XW), row = r0 + r, col = col0 + c4;
    const int n = row < r_hi ? min(4, LM - col) : 0;
    int8_t* dst = x_s + r * TC + c4;
    if (xv)
      cp_async4(dst, n > 0 ? x2 + (size_t)row * LM + col : x2, max(n, 0));
    else
      *reinterpret_cast<uint32_t*>(dst) =
          load_x4(x2, (size_t)row * LM + col, n, 0);
  }
  if (miss == nullptr) return;
  for (int e = threadIdx.x; e < RI * MW; e += NT) {
    const int r = e / MW, c4 = 4 * (e % MW), row = r0 + r, l = lstart + c4;
    const int n = row < r_hi ? min(4, L - l) : 0;
    int8_t* dst = m_s + r * MS + c4;
    if (mv)
      cp_async4(dst, n > 0 ? miss + (size_t)row * L + l : miss, max(n, 0));
    else
      *reinterpret_cast<uint32_t*>(dst) =
          load_x4(miss, (size_t)row * L + l, n, 0);
  }
}

// Block (x = TC lanes, y = row segment, z = chain).  Warp w owns the lanes
// colw = w TCW ... of the block's tile: lane = (a cluster lane, cg lane
// of the allele axis); in the d phase a thread computes rows a + GL i (i <
// 4) x lanes 4 cg .. 4 cg + 3 of the eta tile, in the B phase it owns
// clusters 4 (a + GL j) .. + 3 (j < JT) x the same four lanes.  The eta,
// x and miss tiles of the next rows arrive by cp.async while a tile is
// computed, so no thread holds loads in flight in its registers; the
// warp's w goes through its own shared memory, so the ring needs the
// block's barrier once a tile.  part[b][seg][k][lane] over all KP rows.
template <int KP>
__global__ void __launch_bounds__(NT, KP <= 32 ? 3 : 2)
    fullstep_cols_kernel(const float* __restrict__ eta,
                         const float* __restrict__ p2,
                         const int8_t* __restrict__ x2,
                         const int8_t* __restrict__ miss,
                         float* __restrict__ part, int I, int L, int M,
                         int seg_rows, LaneTile lt, int xv, int mv) {
  constexpr int JTM = KP / 32, ES = KP + 4;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RI = COL_DR * GL, TCW = COL_CT * CW, TC = NW * TCW;
  const int LM = L * M, MS = miss_tile_bytes(TC, M);
  float* smem = reinterpret_cast<float*>(dyn_smem4);
  float* eta_s = smem;
  float* p_s = eta_s + 2 * RI * ES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w_w = p_s + KC * TC + warp * RI * TCW;
  int8_t* x_s = reinterpret_cast<int8_t*>(p_s + KC * TC + NW * RI * TCW);
  int8_t* m_s = x_s + 2 * RI * TC;

  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = blockIdx.x * TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const int lstart = (col0 / M) & ~3;
  int a = lane / CW, cg = lane % CW;
  if (a >= GL) a = 0, cg = 0;   // spare lanes repeat lane 0's work
  const int colw = warp * TCW + COL_CT * cg;  // within the block's tile
  const int col = col0 + colw;
  const int ncol = LM - col;  // the thread's lanes below LM (if < 4)
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p2 + (size_t)b * KP * LM;

  cols_issue_xm(x_s, m_s, x2, miss, r_lo, r_hi, RI, col0, TC, MS, LM, L,
                lstart, xv, mv);
  cols_issue_eta<KP>(eta_s, eta_b, r_lo, r_hi, RI, KC);
  for (int e = tid; e < KC * TC; e += NT) {
    const int k = e / TC, cc = e % TC, cgl = col0 + cc;
    p_s[e] = cgl < LM ? p_b[(size_t)k * LM + cgl] : 0.f;
  }

  // The loci of the thread's four lanes (col is a multiple of 4): for M
  // >= 2 they are l0 for the lanes q < qs and l0 + 1 for the others (qs =
  // 4 when M is a multiple of 4), so miss is read once per (row, locus)
  // and spread over the lanes by the byte masks; M = 1: four loci, one
  // word.
  const int lm = col / M - lstart;   // l0 within the miss tile
  const int qs = M >= 2 ? min(4, M - col % M) : 4;
  const uint32_t lo_mask =
      0x01010101u & (qs >= 4 ? ~0u : (1u << (8 * qs)) - 1u);
  const uint32_t hi_mask = 0x01010101u & ~lo_mask;

  float acc[JTM][4][COL_CT];
#pragma unroll
  for (int j = 0; j < JTM; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int cc = 0; cc < COL_CT; ++cc) acc[j][q][cc] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  for (int r0 = r_lo; r0 < r_hi; r0 += RI, buf ^= 1) {
    const float* es = eta_s + buf * RI * ES;
    const int8_t* xs = x_s + buf * RI * TC;
    const int8_t* ms = m_s + buf * RI * MS;
    if (r0 + RI < r_hi) {
      cols_issue_xm(x_s + (buf ^ 1) * RI * TC, m_s + (buf ^ 1) * RI * MS,
                    x2, miss, r0 + RI, r_hi, RI, col0, TC, MS, LM, L, lstart,
                    xv, mv);
      cols_issue_eta<KP>(eta_s + (buf ^ 1) * RI * ES, eta_b, r0 + RI, r_hi,
                         RI, KC);
    }
    // d phase: the contracted cluster index in eta's vector
    float d[COL_DR][4];
#pragma unroll
    for (int i = 0; i < COL_DR; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[i][q] = 0.f;
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pv[q] = ld4(p_s + (k4 + q) * TC + colw);
#pragma unroll
      for (int i = 0; i < COL_DR; ++i)
        d_row(d[i], ld4(es + (a + GL * i) * ES + k4), pv);
    }
    // w + miss of the cells; rows and lanes past the edges hold x = 0 and
    // miss = 0 (and eta = 0)
#pragma unroll
    for (int i = 0; i < COL_DR; ++i) {
      const int r = a + GL * i;
      const uint32_t xw =
          *reinterpret_cast<const uint32_t*>(xs + r * TC + colw);
      uint32_t mw = 0u;
      if (miss != nullptr) {
        const int8_t* mr = ms + r * MS + lm;
        if (M == 1)
          mw = *reinterpret_cast<const uint32_t*>(mr);
        else
          mw = (uint32_t)(uint8_t)mr[0] * lo_mask |
               (qs < 4 ? (uint32_t)(uint8_t)mr[1] * hi_mask : 0u);
      }
      float u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float sd = d[i][q] > 0.f ? d[i][q] : 1.f;
        u[q] = fmaf(x_byte(xw, q), __frcp_rn(sd), x_byte(mw, q));
      }
      *reinterpret_cast<float4*>(w_w + r * TCW + COL_CT * cg) =
          make_float4(u[0], u[1], u[2], u[3]);
    }
    __syncwarp();
    // B phase
#pragma unroll GB_UNROLL
    for (int r = 0; r < RI; ++r) {
      const float4 u = ld4(w_w + r * TCW + COL_CT * cg);
#pragma unroll
      for (int j = 0; j < JTM; ++j) {
        if (j == 0 || j < JT) {
          const float4 e = ld4(es + r * ES + 4 * (a + GL * j));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ev = f4_get(e, q);
            acc[j][q][0] = fmaf(ev, u.x, acc[j][q][0]);
            acc[j][q][1] = fmaf(ev, u.y, acc[j][q][1]);
            acc[j][q][2] = fmaf(ev, u.z, acc[j][q][2]);
            acc[j][q][3] = fmaf(ev, u.w, acc[j][q][3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // part[b][seg][k][lane]: the computed rows, then zeros on k >= KC
  float* out = part + ((size_t)b * n_seg + seg) * KP * LM + col;
  const int vec = LM % 4 == 0;
#pragma unroll
  for (int j = 0; j < JTM; ++j) {
    if (j == 0 || j < JT) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* o = out + (size_t)(4 * (a + GL * j) + q) * LM;
        if (vec && ncol >= COL_CT) {
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[j][q][0], acc[j][q][1], acc[j][q][2], acc[j][q][3]);
        } else {
#pragma unroll
          for (int cc = 0; cc < COL_CT; ++cc)
            if (cc < ncol) o[cc] = acc[j][q][cc];
        }
      }
    }
  }
  for (int k = KC + a; k < KP; k += GL)
    for (int cc = 0; cc < COL_CT; ++cc)
      if (cc < ncol) out[(size_t)k * LM + cc] = 0.f;
}

// p epilogue: one aligned group of G lanes per (chain, k, locus) of the
// live lanes k < kl; lane g owns the allele slots m = g + G j.  B = the
// segments' partials summed in segment order (deterministic), then p' as
// in the header, or raw B under `finish` = 0.
//
// Bound by device memory: each partial is read once for one add.  A
// thread streams its slots' partials through its own cp.async ring in
// shared memory, P_RING floats (P_RING / MJ segments, at least one, in
// flight), and adds each segment as it lands; no thread reads another's
// copies, so the ring needs no barrier.  Rows k >= kl (the lanes past the
// lane tile of k_true, which the columns pass writes 0) are not read:
// their threads do not exist, and the live rows' threads write them 0,
// the value p' and B take there.  The free-slot set is one bit a slot,
// so no array of the group's Michelot leaves registers (MJ <= 32).
constexpr int P_RING = 16;   // floats of a thread's ring

__host__ __device__ constexpr int p_depth(int MJ) {
  return MJ >= P_RING ? 1 : P_RING / MJ;
}

template <int G, int MJ>
__global__ void __launch_bounds__(NT) fullstep_p_kernel(
    const float* __restrict__ p2, const float* __restrict__ part,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int Kp,
    int kl, int L, int M, int n_seg, int k_true, float plb, int project,
    int finish) {
  constexpr int D = p_depth(MJ);
  static_assert(MJ <= 32, "the free set holds one bit a slot");
  static_assert(4 * NT * MJ * D <= 48 * 1024,
                "the ring outgrows the shared memory a block gets unasked");
  float* ring = reinterpret_cast<float*>(dyn_smem4);  // [slot][j][NT]
  const int b = blockIdx.y, tid = threadIdx.x;
  const int g = tid % G;
  const size_t rows = (size_t)kl * L;   // live (k, locus) rows a chain
  const size_t row = (size_t)blockIdx.x * (NT / G) + tid / G;  // k L + l
  const bool live = row < rows;  // every lane takes part in the shuffles
  const int k = live ? (int)(row / L) : 0, l = live ? (int)(row % L) : 0;
  const size_t KLM = (size_t)Kp * L * M;
  const size_t off = (size_t)b * KLM + (live ? row : 0) * M;  // [b][k][l][m]
  const float* pp = part + (size_t)b * n_seg * KLM + (live ? row : 0) * M;

  auto issue = [&](int s) {
    if (live && s < n_seg) {
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int m = g + G * j;
        if (m < M)
          cp_async4(ring + ((s % D) * MJ + j) * NT + tid,
                    pp + (size_t)s * KLM + m, 4);
      }
    }
    cp_async_commit();
  };
  float v[MJ];
#pragma unroll
  for (int j = 0; j < MJ; ++j) v[j] = 0.f;
#pragma unroll
  for (int s = 0; s < D - 1; ++s) issue(s);
  for (int s = 0; s < n_seg; ++s) {
    // the slot refilled here was read a step before: that read stays
    // ahead of the copy
    asm volatile("" ::: "memory");
    issue(s + D - 1);
    cp_async_wait<D - 1>();
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      if (live && g + G * j < M) v[j] += ring[((s % D) * MJ + j) * NT + tid];
  }

  // the rows k >= kl of the chain, zeros, written by the live rows' lanes
  if (live) {
    for (size_t pr = row; pr < (size_t)(Kp - kl) * L; pr += rows)
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int m = g + G * j;
        if (m < M) out[(size_t)b * KLM + (rows + pr) * M + m] = 0.f;
      }
  }
  if (!finish) {  // uniform: the flag is the launch's
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = g + G * j;
      if (live && m < M) out[off + m] = v[j];
    }
    return;
  }
  unsigned fr = 0u;   // the free slots: valid alleles of a live row
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int m = g + G * j;
    const bool in = live && m < M;
    v[j] = in ? p2[off + m] * v[j] : 0.f;
    s += v[j];
    if (in && mask[(size_t)l * M + m] != 0) fr |= 1u << j;
  }
  const float tot = mc::group_sum<G>(s);
#pragma unroll
  for (int j = 0; j < MJ; ++j)
    v[j] = ((fr >> j & 1u) && tot > 0.f) ? v[j] / tot : 0.f;
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
// Each returns the cudaGetLastError() of its launches.  k_true outside
// [1, Kp] means Kp.

// Rows pass in n_seg segments of seg_cols lanes (n_seg <= 65535) into the
// scratch apart [B, n_seg, I, Kp] and tpart [B, n_seg, I], then its
// finish: eta' (or the raw A when finish = 0) into out [B, I, Kp] and t
// into t_out [B, I] float64.  c and a0 may be null.  M: the allele slots
// a locus, or 0 when the caller does not say (the dense cells).
extern "C" int mc_fullstep_rows(const void* eta, const void* p2,
                                const void* x2, const void* c,
                                const void* a0, void* apart, void* tpart,
                                void* out, void* t_out, int B, int I, int LM,
                                int M, int Kp, int k_true, float lb,
                                int project, int compute_t, int finish,
                                int seg_cols, int n_seg, void* stream) {
  if (seg_cols < 1) return (int)cudaErrorInvalidValue;
  // every segment starts at a multiple of 4 when the rows and the
  // segment size do
  const int vec =
      LM % 4 == 0 && seg_cols % 4 == 0 && ((uintptr_t)x2 & 3) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (kp_wide(Kp)) {
    // the generic cells at every M: at these Kp the cells are a few
    // percent of a lane's work, so the sparse cells would save little
    const int err = launch_rows_wide<Cells::kDense>(
        eta, p2, x2, nullptr, apart, tpart, B, I, LM, Kp, k_true, 0, LM,
        seg_cols, n_seg, compute_t, 1, vec, s);
    if (err != 0) return err;
    return launch_rows_finish_wide(eta, apart, tpart, a0, c, nullptr, out,
                                   t_out, B, I, Kp, n_seg, k_true, lb,
                                   !finish, project, compute_t, s);
  }
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  const LaneTile lt = lane_tile(k_true, Kp, ROW_CW_MAX);
  const int R = NW * ROW_AR * lt.cw;
  const size_t smem = sizeof(float) * (size_t)rows_smem_floats(Kp, lt, 0);
  const dim3 grid((I + R - 1) / R, n_seg, B);
  const float* e = (const float*)eta;
  const float* p = (const float*)p2;
  const int8_t* x = (const int8_t*)x2;
  float* ap = (float*)apart;
  float* tp = (float*)tpart;
  int err = 0;
  // a segment starts at a multiple of 32 lanes, so a thread's four lanes
  // are one locus when M is a multiple of 4 (and vec holds)
  const bool sparse = vec && M > 0 && M % 4 == 0;
#define MC_ROWS(KP, C)                                                  \
  err = allow_smem(fullstep_rows_kernel<KP, C>);                        \
  if (err == 0)                                                         \
  fullstep_rows_kernel<KP, C><<<grid, NT, smem, s>>>                    \
  (e, p, x, ap, tp, I, LM, seg_cols, compute_t, lt, vec)
#define MC_ROWS_KP(C)                      \
  switch (Kp) {                            \
    case 32: MC_ROWS(32, C); break;        \
    case 64: MC_ROWS(64, C); break;        \
    case 96: MC_ROWS(96, C); break;        \
    default: MC_ROWS(128, C); break;       \
  }
  if (sparse) {
    MC_ROWS_KP(Cells::kSparse)
  } else {
    MC_ROWS_KP(Cells::kDense)
  }
#undef MC_ROWS_KP
#undef MC_ROWS
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_rows_finish(eta, apart, tpart, a0, c, nullptr, out, t_out,
                            B, I, Kp, n_seg, k_true, lb, !finish, project,
                            compute_t, s);
}

// Columns pass in n_seg row segments of seg_rows rows (n_seg <= 65535):
// part [B, n_seg, Kp, L*M]; miss may be null.  At 128 < Kp <= 1024 the
// wide pass runs in lane sub-windows of sub_cols lanes through `scratch`
// (16-byte aligned, 4 B I sub_cols bytes: d of a sub-window); narrower Kp
// take neither.
extern "C" int mc_fullstep_cols(const void* eta, const void* p2,
                                const void* x2, const void* miss,
                                void* part, int B, int I, int L, int M,
                                int Kp, int k_true, int n_seg, int seg_rows,
                                void* scratch, int sub_cols, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  const int LM = L * M;
  // the tiles of x and miss arrive by cp.async where every row starts at
  // a multiple of 4 bytes, else by plain loads
  const int xv = LM % 4 == 0 && ((uintptr_t)x2 & 3) == 0;
  if (kp_wide(Kp))
    return launch_cols_wide<Cells::kDense>(
        eta, p2, x2, nullptr, miss, part, scratch, B, I, LM, L, M, Kp,
        k_true, 0, LM, 0, LM, n_seg, seg_rows, sub_cols,
        LM % 4 == 0 && ((uintptr_t)p2 & 15) == 0, xv,
        L % 4 == 0 && ((uintptr_t)miss & 3) == 0, (cudaStream_t)stream);
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  const LaneTile lt = lane_tile(k_true, Kp, 32);
  const int TC = NW * COL_CT * lt.cw;
  const size_t smem = (size_t)cols_smem_bytes(Kp, lt, M);
  const int mv = L % 4 == 0 && ((uintptr_t)miss & 3) == 0;
  const dim3 grid((LM + TC - 1) / TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p2;
  const int8_t* x = (const int8_t*)x2;
  const int8_t* m = (const int8_t*)miss;
  float* pt = (float*)part;
  int err = 0;
#define MC_COLS(KP)                                                     \
  err = allow_smem(fullstep_cols_kernel<KP>);                           \
  if (err == 0)                                                         \
  fullstep_cols_kernel<KP><<<grid, NT, smem, s>>>                       \
  (e, p, x, m, pt, I, L, M, seg_rows, lt, xv, mv)
  switch (Kp) {
    case 32: MC_COLS(32); break;
    case 64: MC_COLS(64); break;
    case 96: MC_COLS(96); break;
    default: MC_COLS(128); break;
  }
#undef MC_COLS
  return err != 0 ? err : (int)cudaGetLastError();
}

// the tiles of the wide columns pass (csrc/wide.cuh) for the biallelic
// (generic = 0) or the generic cells: columns of a B-launch block, rows of
// its stage, cluster lanes of a chunk at most, rows and columns of a
// d-launch tile, lanes of a d stage; for the tests of their mirror
extern "C" void mc_wide_cols_tiles(int generic, int* cols, int* stage_rows,
                                   int* chunk, int* d_rows, int* d_cols,
                                   int* d_lanes) {
  *cols = generic ? WideColsTile<Cells::kDense>::BC
                  : WideColsTile<Cells::kBi>::BC;
  *stage_rows = generic ? WideColsTile<Cells::kDense>::TK
                        : WideColsTile<Cells::kBi>::TK;
  *chunk = CHUNK_LANES;
  *d_rows = WD_M;
  *d_cols = WD_N;
  *d_lanes = WD_K;
}

// M <= 1024: G lanes per (k, locus) row, MJ slots per lane; the lanes of
// part past the lane tile of k_true must be zero (the columns pass writes
// them so) and are not read
extern "C" int mc_fullstep_p(const void* p2, const void* part,
                             const void* mask, void* out, int B, int Kp,
                             int L, int M, int n_seg, int k_true, float plb,
                             int project, int finish, void* stream) {
  if (n_seg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)p2;
  const float* pt = (const float*)part;
  const uint8_t* mk = (const uint8_t*)mask;
  float* o = (float*)out;
  const int kc = pass_kc(k_true, Kp);
  const int kl = kc < Kp ? kc : Kp;   // Kp = K = 3: the multi-allelic mixture
  // NT / G live (k, locus) rows a block; a thread's ring of p_depth(MJ)
  // segments, or of all of them where there are fewer
#define MC_P(G, MJ)                                                        \
  fullstep_p_kernel<G, MJ>                                                 \
      <<<dim3((unsigned)(((size_t)kl * L + NT / G - 1) / (NT / G)), B), NT, \
          4 * NT * MJ * (n_seg < p_depth(MJ) ? n_seg : p_depth(MJ)), s>>>(  \
          p, pt, mk, o, Kp, kl, L, M, n_seg, k_true, plb, project, finish)
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
