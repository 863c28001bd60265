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
// a rows pass (d, w, t, A, eta') and a columns pass (d, w again, B0/B1 as
// per-row-segment partials, then an epilogue that adds the partials in
// segment order and applies the p0' update).  The streamed and chunked
// steps (the TPU's `admixture_fullstep_biallelic_streamed`, kernels.py:1007
// with bodies `_bi_istats_kernel` :887 and `_bi_lstats_kernel` :944, and
// `admixture_fullstep_biallelic_chunked`, :829) are the same passes with
// the rows pass also split into column segments (a finish kernel sums the
// segments' partials in order, t in float64) and both passes taking a
// column window [l_lo, l_hi) on arrays that keep their full-L strides.
//
// What bounds the two passes, and what the design does about it.  All four
// products (d0 twice, A, B0/B1) are IEEE f32 FMA on the CUDA cores (no
// TF32), 2-3 bytes of x a cell against 40-60 FMA and two reciprocals (the
// rows pass: two logf as well): the limit is instruction issue, and
// before it the SM's shared-memory path (32 lanes of load a clock against
// 128 FMA).  So:
//
// * Register tiles.  Every product is done on small per-thread output
//   tiles whose operands are read from shared memory as float4, with the
//   contracted index in the vector where that saves a transposed copy:
//   one layout of each tile serves both products of a pass (eta as (row,
//   clusters), p0 as (cluster, columns), w as (row, columns)).  The lanes
//   of a warp split as GL cluster lanes x CW lanes of the other index, so
//   that a warp's loads are GL + CW distinct float4 and not 32: 0.09-0.13
//   loads a FMA, 0.4-0.5 shared-memory wavefronts per clock of FMA.
// * Stop at K.  The host picks the lane tile from k_true (`lane_tile`):
//   G = ceil(k_true / 4) cluster groups of four, JT = ceil(G / 8) groups a
//   thread, GL = ceil(G / JT) cluster lanes, CW = 32 / GL; the k loops run
//   over KC = 4 GL JT lanes (K = 20: 20), lanes beyond KC are neither
//   loaded nor computed, and what is written there is exact (zeros, or
//   the row's sum of w1 in the raw A + r, as the plain version has it).
//   With a runtime kmask the caller states the largest K; the mask is not
//   read in these loops.  It is read where eta is finished: the pair's
//   rows pass and the finish of the segmented one project each chain
//   over its row of the mask (kmask + b km_stride: km_stride 0 gives
//   every chain one [Kp] mask, Kp a [B, Kp] mask of a mixed-K lattice),
//   and a lane outside it ends at 0.  Its eta is 0 there, so it adds
//   nothing to d, A or B0/B1 of its chain, and p0' there is 0.
// * Columns pass: a warp owns 4 CW columns for a whole row segment, its
//   p0 tile resident in shared memory and its B0/B1 tile (4 JT clusters x
//   4 columns x 2 alleles a thread) in registers; the block's eight warps
//   share the streamed eta tile of 4 GL rows (K = 20: 192 columns x 20
//   rows a tile), which arrives by cp.async into a ring of two buffers
//   while the tile before it is computed: one barrier a tile.  The d
//   phase computes 4 rows x 4 columns a thread, the rowsum of eta once a
//   tile a warp.
// * Rows pass: a warp owns 4 CW rows (at most 32), its eta rows resident
//   in shared memory and its A tile (4 rows x 4 JT clusters a thread) in
//   registers; the block shares the streamed p0 tile of 32 columns
//   (cp.async, ring of two, one barrier a tile).  The d phase computes CW
//   rows x 4 columns a thread, then the divisions and logs of those cells;
//   t and sum w1 stay in registers for the whole segment.
// * The cells' elementwise part is IEEE float32: w = x * __frcp_rn(d)
//   and logf.  The reciprocal has a numerator of 1 because x / d with x =
//   0, a third of all cells, leaves the division's fast path (its range
//   check sends a zero numerator to the slow routine); for counts 0, 1
//   and 2 the product is bit-equal to the quotient.  With the products
//   tiled, the two logf (~25 instructions each) and the two reciprocals
//   (~10 each) are most of what a rows-pass cell costs; the instruction
//   mix is in PERF.md.
// * x0, x1 and miss are read four bytes a thread (a warp reads whole
//   32-byte sectors of a row) straight into registers, one tile ahead of
//   their use; the vector path needs L % 4 == 0 and a window start that is
//   a multiple of 4, else the same loads are made byte by byte.  Ragged I
//   and L edges are masked in the loads (zero x, zero eta or p0), not in
//   the arithmetic.
//
// The caller pads only K, to Kp in {32, 64, 96, 128} for these kernels.
// Sums are in a fixed order: reruns are bit-equal.  The tiles, the
// cp.async helpers, the rows loop (rows_accumulate) and the rows finish
// live in tiles.cuh, which the generic step (csrc/fullstep.cu) shares.
// For 128 < Kp <= 1024 the segmented rows pass, the finish and the
// columns pass are the wide kernels of wide.cuh (the p0 epilogue takes
// any Kp), and a step's window runs both passes on one d
// (mc_fullstep_bi_window); the pair (mc_fullstep_bi_rows) refuses those
// Kp: the streamed step runs them.

#include "wide.cuh"

namespace {

// rows of w a step of the columns pass's B-phase loop unrolled together
// (measured: 4 beats 1 and 2)
constexpr int B_UNROLL = 4;

template <int KP>
__global__ void __launch_bounds__(NT, KP <= 32 ? 2 : 1)
    fullstep_bi_rows_kernel(const float* __restrict__ eta,
                            const float* __restrict__ p0,
                            const int8_t* __restrict__ x0,
                            const int8_t* __restrict__ x1,
                            const float* __restrict__ c,
                            const float* __restrict__ kmask,
                            float* __restrict__ eta_new,
                            float* __restrict__ t_out, int I, int L,
                            int k_true, float lb, int project, int compute_t,
                            int km_stride, LaneTile lt, int vec) {
  constexpr int KJ = KP / 32, JTM = KP / 32, ES = KP + 4, AS = KP + 1;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RW = ROW_AR * CW, R = NW * RW;
  float* smem = reinterpret_cast<float*>(dyn_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * R, rw0 = warp * RW;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  float acc[JTM][4][ROW_AR];
  rows_accumulate<KP, Cells::kBi>(smem, eta_b, p_b, x0, x1, row0, I, L, 0,
                                  L, compute_t, 1, lt, vec, acc);
  const float* eta_s = smem;
  const float* t_s = smem + R * ES + 2 * KC * ROW_PS + R * ROW_PS;
  const float* r_s = t_s + R;
  float* a_s = smem + R * ES + 2 * KC * ROW_PS + R * ROW_PS + 2 * R;

  // raw A + r of the warp's rows through shared memory, so that the finish
  // has lane = cluster; lanes past KC hold 0 (their eta is 0)
  int a = lane / CW, cr = lane % CW;
  if (a >= GL) a = 0, cr = 0;
#pragma unroll
  for (int i = 0; i < ROW_AR; ++i) {
    const int r = rw0 + cr + CW * i;
    const float rr = r_s[r];
#pragma unroll
    for (int j = 0; j < JTM; ++j)
      if (j == 0 || j < JT)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a_s[r * AS + a + GL * (4 * j + q)] = acc[j][q][i] + rr;
  }
  for (int r = 0; r < RW; ++r)
    for (int k = KC + lane; k < KP; k += 32) a_s[(rw0 + r) * AS + k] = 0.f;
  __syncwarp();
  // the lanes the Michelot projects: below k_true, or the chain's kmask row
  unsigned valid = 0u;
  const float* km = kmask != nullptr ? kmask + (size_t)b * km_stride : nullptr;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    if (km != nullptr ? km[k] > 0.5f : k < k_true) valid |= 1u << j;
  }

  for (int rl = 0; rl < RW; ++rl) {
    const int r = rw0 + rl, row = row0 + r;
    if (row >= I) break;  // uniform across the warp
    const float ci = c[row];
    float num[KJ], part = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      num[j] = eta_s[r * ES + lane + 32 * j] * (a_s[r * AS + lane + 32 * j] + ci);
      part += num[j];
    }
    const float tot = warp_sum(part);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      num[j] = tot > 0.f ? num[j] / tot : eta_s[r * ES + lane + 32 * j];
    if (project) mc::michelot_warp_mask<KJ>(num, valid, lb);
    float* out = eta_new + ((size_t)b * I + row) * KP;
#pragma unroll
    for (int j = 0; j < KJ; ++j) out[lane + 32 * j] = num[j];
    if (lane == 0) t_out[(size_t)b * I + row] = compute_t ? t_s[r] : 0.f;
  }
}

// Segmented rows pass: block (x = R rows, y = column segment, z = chain)
// covers the columns [l_lo + y seg_cols, + seg_cols) of the window
// [l_lo, l_hi) and writes its raw A + r and t as that segment's partials,
// apart [B, n_seg, I, KP] and tpart [B, n_seg, I].
template <int KP>
__global__ void __launch_bounds__(NT, KP <= 32 ? 2 : 1)
    fullstep_bi_rows_seg_kernel(const float* __restrict__ eta,
                                const float* __restrict__ p0,
                                const int8_t* __restrict__ x0,
                                const int8_t* __restrict__ x1,
                                float* __restrict__ apart,
                                float* __restrict__ tpart_out, int I, int L,
                                int l_lo, int l_hi, int seg_cols,
                                int compute_t, int compute_a, LaneTile lt,
                                int vec) {
  constexpr int JTM = KP / 32, ES = KP + 4;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RW = ROW_AR * CW, R = NW * RW;
  float* smem = reinterpret_cast<float*>(dyn_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int row0 = blockIdx.x * R, rw0 = warp * RW;
  const int c_lo = l_lo + seg * seg_cols;
  const int c_hi = min(l_hi, c_lo + seg_cols);
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  float acc[JTM][4][ROW_AR];
  rows_accumulate<KP, Cells::kBi>(smem, eta_b, p_b, x0, x1, row0, I, L,
                                  c_lo, c_hi, compute_t, compute_a, lt, vec,
                                  acc);
  const float* t_s = smem + R * ES + 2 * KC * ROW_PS + R * ROW_PS;
  const float* r_s = t_s + R;
  const size_t o0 = ((size_t)b * n_seg + seg) * I;

  for (int rl = lane; rl < RW; rl += 32) {
    const int row = row0 + rw0 + rl;
    if (row < I) tpart_out[o0 + row] = t_s[rw0 + rl];
  }
  if (!compute_a) return;
  int a = lane / CW, cr = lane % CW;
  if (a >= GL) a = 0, cr = 0;
#pragma unroll
  for (int i = 0; i < ROW_AR; ++i) {
    const int r = rw0 + cr + CW * i, row = row0 + r;
    if (row >= I) continue;
    const float rr = r_s[r];
    float* out = apart + (o0 + row) * KP;
#pragma unroll
    for (int j = 0; j < JTM; ++j)
      if (j == 0 || j < JT)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          out[a + GL * (4 * j + q)] = acc[j][q][i] + rr;
  }
  // lanes past KC: p0 is zero there, so A + r is the row's sum of w1
  for (int rl = 0; rl < RW; ++rl) {
    const int row = row0 + rw0 + rl;
    if (row >= I) break;
    const float rr = r_s[rw0 + rl];
    for (int k = KC + lane; k < KP; k += 32) apart[(o0 + row) * KP + k] = rr;
  }
}

// ---------------------------------------------------------------------------
// columns pass

// Shared memory of a columns-pass block, in floats: eta_s [2][RI][KP + 4],
// p_s [KC][TC], w_s [NW][2][RI][TCW], s_s [NW][RI]; RI = 4 GL rows a tile,
// TCW = 4 CW columns a warp, TC = NW TCW columns a block.
__host__ __device__ inline int cols_smem_floats(int KP, const LaneTile& lt) {
  const int RI = COL_DR * lt.gl, TCW = COL_CT * lt.cw, TC = NW * TCW;
  return 2 * RI * (KP + 4) + lt.kc * TC + NW * 2 * RI * TCW + NW * RI;
}

// Block (x = TC columns of the window, y = row segment, z = chain).  Warp
// w owns the columns colw = w TCW ... of the block's tile: lane = (a
// cluster lane, cg column lane); in the d phase a thread computes rows a +
// GL i (i < 4) x columns 4 cg .. 4 cg + 3 of the eta tile, in the B phase
// it owns clusters 4 (a + GL j) .. + 3 (j < JT) x the same four columns x
// both alleles.  The warp's w0 and w1 go through its own shared memory, so
// only the shared eta tiles need the block's barrier.
template <int KP>
__global__ void __launch_bounds__(NT, KP <= 32 ? 2 : 1)
    fullstep_bi_cols_kernel(const float* __restrict__ eta,
                            const float* __restrict__ p0,
                            const int8_t* __restrict__ x0,
                            const int8_t* __restrict__ x1,
                            const int8_t* __restrict__ miss,
                            float* __restrict__ part, int I, int L, int l_lo,
                            int l_hi, int seg_rows, LaneTile lt, int vec) {
  constexpr int JTM = KP / 32, ES = KP + 4;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RI = COL_DR * GL, TCW = COL_CT * CW, TC = NW * TCW;
  float* smem = reinterpret_cast<float*>(dyn_smem4);
  float* eta_s = smem;
  float* p_s = eta_s + 2 * RI * ES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w0_w = p_s + KC * TC + warp * 2 * RI * TCW;
  float* w1_w = w0_w + RI * TCW;
  float* s_w = p_s + KC * TC + NW * 2 * RI * TCW + warp * RI;

  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = l_lo + blockIdx.x * TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  int a = lane / CW, cg = lane % CW;
  if (a >= GL) a = 0, cg = 0;   // spare lanes repeat lane 0's work
  const int colw = warp * TCW + COL_CT * cg;  // within the block's tile
  const int col = col0 + colw;
  const float* eta_b = eta + (size_t)b * I * KP;
  const float* p_b = p0 + (size_t)b * KP * L;

  cols_issue_eta<KP>(eta_s, eta_b, r_lo, r_hi, RI, KC);
  for (int e = tid; e < KC * TC; e += NT) {
    const int k = e / TC, cc = e % TC, cgl = col0 + cc;
    p_s[e] = cgl < l_hi ? p_b[(size_t)k * L + cgl] : 0.f;
  }

  uint32_t xa[COL_DR], xb[COL_DR], xm[COL_DR];
  auto load_x = [&](int r0) {
#pragma unroll
    for (int i = 0; i < COL_DR; ++i) {
      const int row = r0 + a + GL * i;
      const int n = row < r_hi ? l_hi - col : 0;
      const size_t off = (size_t)row * L + col;
      xa[i] = load_x4(x0, off, n, vec);
      xb[i] = load_x4(x1, off, n, vec);
      xm[i] = miss != nullptr ? load_x4(miss, off, n, vec) : 0u;
    }
  };
  load_x(r_lo);

  float acc0[JTM][4][COL_CT], acc1[JTM][4][COL_CT];
#pragma unroll
  for (int j = 0; j < JTM; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int cc = 0; cc < COL_CT; ++cc) {
        acc0[j][q][cc] = 0.f;
        acc1[j][q][cc] = 0.f;
      }
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  for (int r0 = r_lo; r0 < r_hi; r0 += RI, buf ^= 1) {
    const float* es = eta_s + buf * RI * ES;
    if (r0 + RI < r_hi)
      cols_issue_eta<KP>(eta_s + (buf ^ 1) * RI * ES, eta_b, r0 + RI, r_hi,
                         RI, KC);
    // rowsum(eta) of the tile's rows, once a warp
    for (int r = lane; r < RI; r += 32) {
      float s = 0.f;
      for (int k4 = 0; k4 < KC; k4 += 4) {
        const float4 v = ld4(es + r * ES + k4);
        s += (v.x + v.y) + (v.z + v.w);
      }
      s_w[r] = s;
    }
    __syncwarp();
    // d phase: the contracted cluster index in eta's vector
    float d0[COL_DR][4];
#pragma unroll
    for (int i = 0; i < COL_DR; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) d0[i][q] = 0.f;
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pv[q] = ld4(p_s + (k4 + q) * TC + colw);
#pragma unroll
      for (int i = 0; i < COL_DR; ++i)
        d_row(d0[i], ld4(es + (a + GL * i) * ES + k4), pv);
    }
#pragma unroll
    for (int i = 0; i < COL_DR; ++i) {
      const int r = a + GL * i;
      const float s = s_w[r];
      float u0[4], u1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m = x_byte(xm[i], q);
        u0[q] = fmaf(x_byte(xa[i], q), __frcp_rn(fmaxf(d0[i][q], DMIN)), m);
        u1[q] = fmaf(x_byte(xb[i], q), __frcp_rn(fmaxf(s - d0[i][q], DMIN)),
                     m);
      }
      *reinterpret_cast<float4*>(w0_w + r * TCW + COL_CT * cg) =
          make_float4(u0[0], u0[1], u0[2], u0[3]);
      *reinterpret_cast<float4*>(w1_w + r * TCW + COL_CT * cg) =
          make_float4(u1[0], u1[1], u1[2], u1[3]);
    }
    if (r0 + RI < r_hi) load_x(r0 + RI);
    __syncwarp();
    // B phase
#pragma unroll B_UNROLL
    for (int r = 0; r < RI; ++r) {
      const float4 u0 = ld4(w0_w + r * TCW + COL_CT * cg);
      const float4 u1 = ld4(w1_w + r * TCW + COL_CT * cg);
#pragma unroll
      for (int j = 0; j < JTM; ++j) {
        if (j == 0 || j < JT) {
          const float4 e = ld4(es + r * ES + 4 * (a + GL * j));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ev = f4_get(e, q);
            acc0[j][q][0] = fmaf(ev, u0.x, acc0[j][q][0]);
            acc0[j][q][1] = fmaf(ev, u0.y, acc0[j][q][1]);
            acc0[j][q][2] = fmaf(ev, u0.z, acc0[j][q][2]);
            acc0[j][q][3] = fmaf(ev, u0.w, acc0[j][q][3]);
            acc1[j][q][0] = fmaf(ev, u1.x, acc1[j][q][0]);
            acc1[j][q][1] = fmaf(ev, u1.y, acc1[j][q][1]);
            acc1[j][q][2] = fmaf(ev, u1.z, acc1[j][q][2]);
            acc1[j][q][3] = fmaf(ev, u1.w, acc1[j][q][3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // part[b][seg][allele][k][column of the window], lanes k < KC only
  const size_t W = (size_t)(l_hi - l_lo);
  float* out = part + ((size_t)b * n_seg + seg) * 2 * KP * W;
#pragma unroll
  for (int j = 0; j < JTM; ++j) {
    if (j == 0 || j < JT) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t kw = (size_t)(4 * (a + GL * j) + q) * W + (col - l_lo);
#pragma unroll
        for (int cc = 0; cc < COL_CT; ++cc) {
          if (col + cc < l_hi) {
            out[kw + cc] = acc0[j][q][cc];
            out[(size_t)KP * W + kw + cc] = acc1[j][q][cc];
          }
        }
      }
    }
  }
}

// p0' epilogue over the window [l_lo, l_lo + W): B0/B1 = the segments'
// partials summed in segment order (deterministic; lanes k >= kc were not
// computed and count as the zeros they are), then p0' = clip(p0 B0 / (p0
// B0 + (1 - p0) B1)), or under emit_b the raw B0/B1, written at the
// window's columns of full-width [B, Kp, L] outputs.
__global__ void __launch_bounds__(NT) fullstep_bi_p0_kernel(
    const float* __restrict__ p0, const float* __restrict__ part,
    float* __restrict__ p0_new, float* __restrict__ b0_out,
    float* __restrict__ b1_out, int Kp, int kc, int L, int l_lo, int W,
    int n_seg, float plb, float pub, int project) {
  const int b = blockIdx.y;
  const size_t KW = (size_t)Kp * W;
  const size_t kw = (size_t)blockIdx.x * NT + threadIdx.x;
  if (kw >= KW) return;
  const float* pb = part + (size_t)b * n_seg * 2 * KW + kw;
  float b0 = 0.f, b1 = 0.f;
  if (kw < (size_t)kc * W) {
    for (int s = 0; s < n_seg; ++s) {
      b0 += pb[(size_t)(2 * s) * KW];
      b1 += pb[(size_t)(2 * s + 1) * KW];
    }
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

// launches the epilogue over B chains (the columns pass's partials `part`
// [B, n_seg, 2, Kp, W]); returns the launch's cudaError_t
inline int launch_p0(const float* p0, const float* part, float* p0_new,
                     float* b0_out, float* b1_out, int B, int Kp, int kc,
                     int L, int l_lo, int W, int n_seg, float plb, float pub,
                     int project, cudaStream_t s) {
  const size_t KW = (size_t)Kp * W;
  const dim3 grid((unsigned)((KW + NT - 1) / NT), B);
  fullstep_bi_p0_kernel<<<grid, NT, 0, s>>>(p0, part, p0_new, b0_out, b1_out,
                                            Kp, kc, L, l_lo, W, n_seg, plb,
                                            pub, project);
  return (int)cudaGetLastError();
}

// The wide launches of a biallelic window [l_lo, l_hi): the rows pass
// (tpart non-null; apart null: t alone) over column segments of seg_cols,
// the columns pass (part non-null) over row segments of seg_rows, through
// the scratch of d (sub_cols columns) and the rows' eta sums.
inline WideLaunch wide_window(const void* eta, const void* p0,
                              const void* x0, const void* x1,
                              const void* miss, void* apart, void* tpart,
                              void* part, void* scratch, int B, int I, int L,
                              int Kp, int k_true, int l_lo, int l_hi,
                              int seg_cols, int n_cseg, int compute_t,
                              int n_rseg, int seg_rows, int sub_cols) {
  const int row4 = L % 4 == 0 && l_lo % 4 == 0;
  const int vec_x = row4 && ((uintptr_t)x0 & 3) == 0 &&
                    ((uintptr_t)x1 & 3) == 0;
  const int vec_p = row4 && ((uintptr_t)p0 & 15) == 0;
  WideLaunch w{};
  w.eta = eta;
  w.p = p0;
  w.x0 = x0;
  w.x1 = x1;
  w.miss = miss;
  w.scratch = scratch;
  w.B = B;
  w.I = I;
  w.L = L;
  w.Kp = Kp;
  w.k_true = k_true;
  w.l_lo = l_lo;
  w.l_hi = l_hi;
  w.sub_cols = sub_cols;
  w.vec_p = vec_p;
  w.apart = apart;
  w.tpart = tpart;
  w.seg_cols = seg_cols;
  w.n_cseg = n_cseg;
  w.compute_t = compute_t;
  w.compute_a = apart != nullptr;
  w.vec_a = vec_p && vec_x && seg_cols % 4 == 0;
  w.part = part;
  w.ML = L;
  w.M = 1;
  w.p_lo = l_lo;
  w.WP = l_hi - l_lo;
  w.n_rseg = n_rseg;
  w.seg_rows = seg_rows;
  w.vec_x = vec_x;
  w.vec_m = row4 && ((uintptr_t)miss & 3) == 0;
  return w;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/build.py).  Pointers are
// device pointers; `stream` is a cudaStream_t.  Each returns the
// cudaGetLastError() of its launch.  k_true outside [1, Kp] means Kp.

// the tiles the kernels of tiles.cuh take for k_true clusters, here and
// in csrc/fullstep.cu (pass_tiles)
extern "C" void mc_fullstep_bi_tiles(int k_true, int Kp, int* kc,
                                     int* row_block, int* col_block,
                                     int* col_tile_rows) {
  if (kp_wide(Kp)) {
    *kc = wide_kc(k_true, Kp);
    *row_block = WA_M;
    *col_block = WideColsTile<Cells::kBi>::BC;
    *col_tile_rows = WideColsTile<Cells::kBi>::TK;
    return;
  }
  pass_tiles(k_true, Kp, kc, row_block, col_block, col_tile_rows);
}

extern "C" int mc_fullstep_bi_rows(const void* eta, const void* p0,
                                   const void* x0, const void* x1,
                                   const void* c, const void* kmask,
                                   void* eta_new, void* t_out, int B, int I,
                                   int L, int Kp, int k_true, float lb,
                                   int project, int compute_t, int km_stride,
                                   void* stream) {
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  const LaneTile lt = lane_tile(k_true, Kp, ROW_CW_MAX);
  const int R = NW * ROW_AR * lt.cw;
  const size_t smem = sizeof(float) * (size_t)rows_smem_floats(Kp, lt, 1);
  const int vec = L % 4 == 0;
  const dim3 grid((I + R - 1) / R, 1, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const float* cc = (const float*)c;
  const float* km = (const float*)kmask;
  float* en = (float*)eta_new;
  float* t = (float*)t_out;
  int err = 0;
#define MC_ROWS(KP)                                         \
  err = allow_smem(fullstep_bi_rows_kernel<KP>);            \
  if (err == 0)                                             \
  fullstep_bi_rows_kernel<KP><<<grid, NT, smem, s>>>        \
  (e, p, a, z, cc, km, en, t, I, L, k_true, lb, project, compute_t,      \
   km_stride, lt, vec)
  switch (Kp) {
    case 32: MC_ROWS(32); break;
    case 64: MC_ROWS(64); break;
    case 96: MC_ROWS(96); break;
    default: MC_ROWS(128); break;
  }
#undef MC_ROWS
  return err != 0 ? err : (int)cudaGetLastError();
}

// Segmented rows pass over the window [l_lo, l_hi) in n_seg segments of
// seg_cols columns (n_seg <= 65535, the grid's y limit).  At 128 < Kp <=
// 1024 a d launch and the A launch for each column sub-window of sub_cols
// columns through `scratch` (16-byte aligned, 4 B I (sub_cols + 1) bytes:
// d of a sub-window and the rows' eta sums); narrower Kp take neither.
extern "C" int mc_fullstep_bi_rows_seg(const void* eta, const void* p0,
                                       const void* x0, const void* x1,
                                       void* apart, void* tpart, int B,
                                       int I, int L, int Kp, int k_true,
                                       int l_lo, int l_hi, int seg_cols,
                                       int n_seg, int compute_t,
                                       int compute_a, void* scratch,
                                       int sub_cols, void* stream) {
  // every segment starts at a multiple of 4 when the window and the
  // segment size do
  const int vec = L % 4 == 0 && l_lo % 4 == 0 && seg_cols % 4 == 0;
  if (kp_wide(Kp))
    return launch_wide<Cells::kBi>(
        wide_window(eta, p0, x0, x1, nullptr, compute_a ? apart : nullptr,
                    tpart, nullptr, scratch, B, I, L, Kp, k_true, l_lo, l_hi,
                    seg_cols, n_seg, compute_t, 0, 0, sub_cols),
        (cudaStream_t)stream);
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  const LaneTile lt = lane_tile(k_true, Kp, ROW_CW_MAX);
  const int R = NW * ROW_AR * lt.cw;
  const size_t smem = sizeof(float) * (size_t)rows_smem_floats(Kp, lt, 0);
  const dim3 grid((I + R - 1) / R, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  float* ap = (float*)apart;
  float* tp = (float*)tpart;
  int err = 0;
#define MC_ROWS_SEG(KP)                                                      \
  err = allow_smem(fullstep_bi_rows_seg_kernel<KP>);                         \
  if (err == 0)                                                              \
  fullstep_bi_rows_seg_kernel<KP><<<grid, NT, smem, s>>>                     \
  (e, p, a, z, ap, tp, I, L, l_lo, l_hi, seg_cols, compute_t, compute_a, lt, \
   vec)
  switch (Kp) {
    case 32: MC_ROWS_SEG(32); break;
    case 64: MC_ROWS_SEG(64); break;
    case 96: MC_ROWS_SEG(96); break;
    default: MC_ROWS_SEG(128); break;
  }
#undef MC_ROWS_SEG
  return err != 0 ? err : (int)cudaGetLastError();
}

// Finish of the segmented rows pass; a0, kmask and out may be null.
// Chain b's lanes are kmask[b km_stride + k] (km_stride 0 or Kp).
extern "C" int mc_fullstep_bi_finish(const void* eta, const void* apart,
                                     const void* tpart, const void* a0,
                                     const void* c, const void* kmask,
                                     void* out, void* t_out, int B, int I,
                                     int Kp, int n_seg, int k_true,
                                     float lb, int emit_a, int project_eta,
                                     int compute_t, int km_stride,
                                     void* stream) {
  if (kp_wide(Kp))
    return launch_rows_finish_wide(eta, apart, tpart, a0, c, kmask, out,
                                   t_out, B, I, Kp, n_seg, k_true, lb, emit_a,
                                   project_eta, compute_t, km_stride,
                                   (cudaStream_t)stream);
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  return launch_rows_finish(eta, apart, tpart, a0, c, kmask, out, t_out, B,
                            I, Kp, n_seg, k_true, lb, emit_a, project_eta,
                            compute_t, km_stride, (cudaStream_t)stream);
}

// Columns pass and epilogue over the window [l_lo, l_hi); `part` holds
// [B, n_seg, 2, Kp, l_hi - l_lo].  b0_out/b1_out non-null: the epilogue
// writes the raw B0/B1 there instead of the p0 update (emit_b); all three
// null: the pass alone, its partials in `part`.  At 128 <
// Kp <= 1024 the wide pass runs in column sub-windows of sub_cols columns
// through `scratch` (16-byte aligned, 4 B I (sub_cols + 1) bytes: d of a
// sub-window and the rows' eta sums); narrower Kp take neither.
extern "C" int mc_fullstep_bi_cols(const void* eta, const void* p0,
                                   const void* x0, const void* x1,
                                   const void* miss, void* part,
                                   void* p0_new, void* b0_out, void* b1_out,
                                   int B, int I, int L, int Kp, int k_true,
                                   int l_lo, int l_hi, int n_seg,
                                   int seg_rows, float plb, float pub,
                                   int project, void* scratch, int sub_cols,
                                   void* stream) {
  if (kp_wide(Kp)) {
    const int err = launch_wide<Cells::kBi>(
        wide_window(eta, p0, x0, x1, miss, nullptr, nullptr, part, scratch,
                    B, I, L, Kp, k_true, l_lo, l_hi, 0, 0, 0, n_seg,
                    seg_rows, sub_cols), (cudaStream_t)stream);
    if (err != 0 || (!p0_new && !b0_out && !b1_out)) return err;
    return launch_p0((const float*)p0, (const float*)part, (float*)p0_new,
                     (float*)b0_out, (float*)b1_out, B, Kp,
                     wide_kc(k_true, Kp), L, l_lo, l_hi - l_lo, n_seg, plb,
                     pub, project, (cudaStream_t)stream);
  }
  if (!kp_ok(Kp)) return (int)cudaErrorInvalidValue;
  const LaneTile lt = lane_tile(k_true, Kp, 32);
  const int TC = NW * COL_CT * lt.cw;
  const size_t smem = sizeof(float) * (size_t)cols_smem_floats(Kp, lt);
  const int vec = L % 4 == 0 && l_lo % 4 == 0;
  const int W = l_hi - l_lo;
  const dim3 grid((W + TC - 1) / TC, n_seg, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* e = (const float*)eta;
  const float* p = (const float*)p0;
  const int8_t* a = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const int8_t* m = (const int8_t*)miss;
  float* pt = (float*)part;
  int err = 0;
#define MC_COLS(KP)                                         \
  err = allow_smem(fullstep_bi_cols_kernel<KP>);            \
  if (err == 0)                                             \
  fullstep_bi_cols_kernel<KP><<<grid, NT, smem, s>>>        \
  (e, p, a, z, m, pt, I, L, l_lo, l_hi, seg_rows, lt, vec)
  switch (Kp) {
    case 32: MC_COLS(32); break;
    case 64: MC_COLS(64); break;
    case 96: MC_COLS(96); break;
    default: MC_COLS(128); break;
  }
#undef MC_COLS
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0 || (!p0_new && !b0_out && !b1_out)) return err;
  return launch_p0(p, pt, (float*)p0_new, (float*)b0_out, (float*)b1_out, B,
                   Kp, lt.kc, L, l_lo, W, n_seg, plb, pub, project, s);
}

// Both passes of a window [l_lo, l_hi) at 128 < Kp <= 1024 on one d for
// each column sub-window of sub_cols columns (`scratch` as for
// mc_fullstep_bi_cols): the rows pass's partials apart [B, n_cseg, I, Kp]
// and tpart [B, n_cseg, I] over segments of seg_cols columns, and the
// columns pass's partials part [B, n_rseg, 2, Kp, l_hi - l_lo] over
// segments of seg_rows rows (miss may be null).  The finish
// (mc_fullstep_bi_finish) and the epilogue (mc_fullstep_bi_p0) follow.
extern "C" int mc_fullstep_bi_window(const void* eta, const void* p0,
                                     const void* x0, const void* x1,
                                     const void* miss, void* apart,
                                     void* tpart, void* part, void* scratch,
                                     int B, int I, int L, int Kp,
                                     int k_true, int l_lo, int l_hi,
                                     int seg_cols, int n_cseg,
                                     int compute_t, int n_rseg,
                                     int seg_rows, int sub_cols,
                                     void* stream) {
  if (!kp_wide(Kp) || apart == nullptr || tpart == nullptr ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_wide<Cells::kBi>(
      wide_window(eta, p0, x0, x1, miss, apart, tpart, part, scratch, B, I,
                  L, Kp, k_true, l_lo, l_hi, seg_cols, n_cseg, compute_t,
                  n_rseg, seg_rows, sub_cols),
      (cudaStream_t)stream);
}

// The epilogue alone over the window [l_lo, l_hi) from partials `part`
// [B, n_seg, 2, Kp, l_hi - l_lo] (lanes k < kc read): p0' into p0_new, or
// the raw B0/B1 into b0_out/b1_out when they are non-null (emit_b).
extern "C" int mc_fullstep_bi_p0(const void* p0, const void* part,
                                 void* p0_new, void* b0_out, void* b1_out,
                                 int B, int L, int Kp, int k_true, int l_lo,
                                 int l_hi, int n_seg, float plb, float pub,
                                 int project, void* stream) {
  if (!(kp_ok(Kp) || kp_wide(Kp)) || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  return launch_p0((const float*)p0, (const float*)part, (float*)p0_new,
                   (float*)b0_out, (float*)b1_out, B, Kp,
                   pass_kc(k_true, Kp), L, l_lo, l_hi - l_lo, n_seg,
                   plb, pub, project, (cudaStream_t)stream);
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
