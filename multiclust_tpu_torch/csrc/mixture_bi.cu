// Biallelic mixture EM step for Hopper (sm_90a): a rows pass, a columns
// pass and a finish (eta and p0).
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
// * rows pass: one block per (chain, 128 rows), a warp per 16 rows; loops
//   over L in stages of 32 loci (16 where Kp x streams > 192).  Writes v
//   [B, I, Kp] and t [B, I].
// * columns pass: one block per (chain, row segment, TC loci); loops over
//   its segment of I in stages of 32 rows and writes B0 (B1) as the
//   segment's partial sums; the blocks of the first locus tile also write
//   the segment's sum of v (for vtot).
// * finish, one launch a step (`mix_finish_kernel`): the first block of a
//   chain's row runs the eta half, one warp that sums each lane's v
//   partials in segment order (a batch of segments' slots loaded before
//   any is added), normalizes and projects eta with a warp Michelot; the
//   other blocks run the p half, a thread a (chain, k, 4 loci) that sums
//   its B0 (B1) partials in segment order, 16-byte loads where L % 4 = 0,
//   and with one stream its lane's vtot from the same v partials, so it
//   waits for no other block, then applies the p0 update.  It writes eta'
//   [B, Kp], vtot and p0' [B, Kp, L], or the model's parameters eta [B,
//   K] and p [B, K, L, 2] = (p0', 1 - p0'), so the step makes no launch
//   after it.  One half alone serves the other mixtures' eta
//   (`mixture_eta`) and the sweep's raw B0 (B1) (`finish` = 0).  It
//   never reads the host.  Bound: bytes, the partials read once and the
//   outputs written once; the eta half is latency (a round trip to L2 a
//   batch of segments, two warp reductions a Michelot pass), hidden
//   behind the p blocks.  Measured slower at K = 1024 (PERF.md): a Michelot
//   pass written as selects, every slot tested at once, took the eta
//   half from 5.5 to 4.4 us alone but 110 registers at KJ = 32, a third
//   of the p blocks' warps gone, the launch 25 % slower; bounded to 3
//   blocks an SM it spilled.  So the eta half keeps to the p half's
//   registers (78 at most).  It replaces the last row block of the TPU's
//   counts pass (kernels.py:1196-1210), the eta update the JAX step runs
//   in XLA (model/mixture.py:106-113) and the step's stack of (p0', 1 -
//   p0') (:270-272).
//
// Both contractions run on the float64 tensor cores (`mma.sync` m16n8k16,
// DMMA): x holds counts and lp and v are float32, so every product is
// exact in float64, and the scores and B0/B1 are summed in float64 over
// the whole of L (rows) or of the row segment (columns), as the plain
// version's float64 product does.  At L in the thousands |s| reaches 10^3,
// where a float32 rounding of s alone would move v by 1e-4; the rows pass
// takes the row max and s - m in float64, then expf(s - m) and t =
// log(tot) + m.  The columns pass rounds its partials to float32 once, at
// the end of the segment.
//
// Operands: x (int8) and lp or v (float32) tiles stream through cp.async
// rings in shared memory, two stages in flight, one barrier a stage.  The
// float32 tile of the operand that every warp reads (lp, v) is converted
// once a stage into a float64 tile, each thread converting the elements
// it copied (its own copies are complete after its cp.async wait, so that
// takes no barrier); x is converted to float64 while a fragment is built.
// A fragment's contraction slot p of thread t stands for locus 4 t + p of
// a 16-locus step (rows pass: one 32-bit load of four counts a row) or
// row t + 4 p of a 16-row step (columns pass: bank-free float64 loads of
// v).
//
// Cluster tiles stop at K: both passes take k_true (clipped to [1, Kp])
// and compute ceil(K / 8) tiles of 8; the rows pass writes v = 0 past K,
// the columns pass writes zeros for the pad rows, which the finish
// reads.  The caller's K-pad lanes (lp 0, bias -1e30) are those of the
// plain versions, which know no k_true.
//
// A mixed-K lattice (a K-sweep's chains in one batch, each with its own
// K) states its largest K as k_true and gives a runtime mask, chain b's
// lanes at kmask + b km_stride (km_stride 0: one [Kp] mask for every
// chain; Kp: a [B, Kp] mask).  The rows pass (its softmax, above 128
// lanes) writes v = 0 outside the chain's lanes and keeps them out of
// the row max and the logsumexp, as the JAX step masks its scores to
// -inf (`_mask_scores`, multiclust_tpu/model/mixture.py:33-38); the
// columns pass needs no mask, v being 0 there; the finish's eta half
// normalizes over, and projects onto, the chain's lanes.  The p half
// then finds B0 = B1 = 0 outside them, the lb-smoothed row (p0' = 1/2)
// that the JAX step's M-step gives them too.
//
// Wide passes (128 < Kp <= 1024, the TPU kernels' own range: the Pallas
// step admits Kp up to 1024, `_stream_vmem_fits`, kernels.py:709-735).
// The narrow passes keep a row's (or a locus tile's) whole cluster axis in
// float64 accumulators, 4 doubles a thread per 8 clusters: 512 a thread
// at Kp = 1024 against 255 registers.  The wide passes cut the live lanes
// (ceil(k_true / 8) tiles of 8) into chunks of at most MIX_WK = 128 lanes
// that differ by at most one tile (K = 200: 104 + 96 lanes, not 128 + 72),
// and give each chunk kernels of their own:
//
// * What bounds them on this card: the float64 tensor cores (67 TFLOP/s,
//   about 128 FMA an SM-clock: one m16n8k16 DMMA is 16 SM-clocks of the
//   SM's rate) are reached only through `mma.sync`; `wgmma` has no
//   float64 form, so the lever is how DMMA is fed.  Both contractions are
//   bound by operations (2 I L K a stream each); the rest is feeding them.
// * Warp tiles of 4 x 4 DMMA tiles (64 rows or loci x 32 lanes, 64
//   float64 accumulators a thread; 2 x 4 a stream in the two-stream
//   columns pass), 8 warps a block of 128 (64) x 128: each B fragment
//   serves 4 DMMAs and each A fragment 4, about a third of the narrow
//   tiles' shared-memory bytes a DMMA.  Fragments are converted to
//   float64 in registers (x from int8, lp and v from float32) as they are
//   built: no conversion pass through shared memory (converting each x
//   tile once a block into float64 high words there measured slower).
// * Operands stream as they lie in device memory (int8 x, float32 lp or
//   v) through cp.async rings of two stages of 128 loci or rows (64 loci
//   with two streams), one barrier a stage: 8 16-locus steps of products
//   between barriers.
// * A warp owns the chunk's lane tiles wc, wc + 4, ...; a stage's products
//   run through code made for the warp's number of live tiles, chosen once
//   a stage, so no test sits between two DMMAs (a test before each DMMA
//   measured markedly slower).
// * rows pass, two launches: a persistent grid over (128 rows, chunk,
//   chain) tiles, each block taking every gridDim.x-th, writes the float64
//   scores s [B, I, Kp] (268 MB at 16384 x 1024 x 2 chains); then one warp
//   a row loads all its scores, takes the float64 max, expf(s - m), the
//   float32 total, v = e / total and t = log(total) + m, as the narrow
//   epilogue forms them.
// * columns pass: grid (128 loci, row segment, chain x chunk); v is read
//   at row stride Kp; each locus tile also sums v over its segment for
//   its share of the chunk's lanes (float32 within a stage, float64
//   across, a fixed order), so no block carries the v sums alone; the
//   first chunk's blocks write zeros past the live tiles.
// * finish: the narrow kernel, its eta half at KJ = 8 / 16 / 32 values a
//   lane by Kp <= 256 / 512 / 1024.
//
// The products stay IEEE float64 on the tensor cores, summed in a fixed
// order over L (rows) or the segment's rows (columns); no atomics, so
// reruns are bit-equal.  The bound is the narrow passes' (below) at K
// lanes; the scratch s adds 16 bytes a row and lane to the rows pass.
// PERF.md (PR 15) holds their shares of it at 16384 x 2048.

// Bound: two contractions of I x L x K per stream (scores and B) on the
// float64 tensor cores (67 TFLOP/s dense, the rate of float32 outside
// them); x is one byte per cell per stream and is read twice, against
// once by the TPU's single-pass kernel.  Both passes reach about 40 % of
// that bound at 16384 x 2048, K = 20, and 44-47 % at K = 100 (PERF.md):
// a warp issues its fragment loads and conversions beside each DMMA.
// Ragged I and L are masked here; the caller pads only K, to Kp a
// multiple of 32 up to 1024.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dmma.cuh"
#include "simplex.cuh"
#include "smem.cuh"

namespace {

constexpr int NT = 256;       // threads per block, every kernel
constexpr int NW = NT / 32;   // warps per block
constexpr int ROW_R = 16 * NW;  // rows per rows-pass block (16 per warp)
constexpr int COL_RI = 32;    // rows per columns-pass stage
// the wide passes (128 < Kp <= KP_WIDE_MAX): cluster lanes a chunk, at
// most
constexpr int MIX_WK = CHUNK_LANES;
constexpr int KP_WIDE_MAX = 1024;
// v sums: stages a thread sums in float32 before it adds them to its
// float64 slots (the v sums of a segment stay float64 at any length)
constexpr int VSUM_ST = 32;

using mc::FULL;
using mc::warp_sum;

// count q (0-3) of four int8 counts packed in w, as float64
__device__ __forceinline__ double xcount(uint32_t w, int q) {
  return (double)(int)(int8_t)(w >> (8 * q));
}

__device__ __forceinline__ double warp4_max(double v) {
  v = fmax(v, __shfl_xor_sync(FULL, v, 1));
  return fmax(v, __shfl_xor_sync(FULL, v, 2));
}

// ---------------------------------------------------------------------------
// rows pass

// Shared memory of a rows-pass block: the float64 lp tiles [2][NS][KP][PS]
// (two stages), the float32 lp ring [2][NS][KP][TL] and the x ring
// [3][NS][ROW_R][XS] bytes.  TL loci a stage; XS bytes an x row (16 or 48,
// so that the 32-bit reads of 8 rows x 4 words hit 32 banks); PS doubles
// an lp row (TL + 2: 16 bytes past a multiple of 128).
template <int KP, bool X1>
struct RowsTile {
  static constexpr int NS = X1 ? 2 : 1;
  static constexpr int TL = KP * NS > 192 ? 16 : 32;
  static constexpr int XS = TL == 16 ? 16 : 48;
  static constexpr int PS = TL + 2;
  static constexpr int D_BYTES = 2 * NS * KP * PS * 8;
  static constexpr int F_BYTES = 2 * NS * KP * TL * 4;
  static constexpr int X_BYTES = 3 * NS * ROW_R * XS;
  static constexpr int SMEM = D_BYTES + F_BYTES + X_BYTES;
};

// The scores of a rows-pass block: warp w owns rows row0 + 16 w .. + 15
// and the first nt_live cluster tiles of the KP lanes whose lp rows start
// at lp0_b (lp1_b), row stride L: an m16 x n8 float64 accumulator per 8
// clusters (A = x, B = lp^T, the contraction over loci), kept over the
// whole of L.  `vec`: every row of x and lp is 16-byte aligned (cp.async);
// otherwise plain loads.
template <int KP, bool X1>
__device__ __forceinline__ void rows_scores(
    double (&acc)[KP / 8][4], const float* __restrict__ lp0_b,
    const float* __restrict__ lp1_b, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, int row0, int I, int L, int nt_live,
    int vec) {
  using T = RowsTile<KP, X1>;
  constexpr int NS = T::NS, TL = T::TL, XS = T::XS, PS = T::PS;
  constexpr int NT8 = KP / 8;
  double* lpd = reinterpret_cast<double*>(dyn_smem4);
  float* lpf = reinterpret_cast<float*>(dyn_smem4) + T::D_BYTES / 4;
  int8_t* xs = reinterpret_cast<int8_t*>(dyn_smem4) + T::D_BYTES + T::F_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KC = 8 * nt_live;
  const int n_st = (L + TL - 1) / TL;

  // copies of stage st: x into ring slot st % 3, lp (KC lanes) into float32
  // slot st % 2
  auto issue = [&](int st) {
    const int l0 = st * TL;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int8_t* x = s ? x1 : x0;
      const float* lp = s ? lp1_b : lp0_b;
      int8_t* xd = xs + ((st % 3) * NS + s) * ROW_R * XS;
      for (int e = tid; e < ROW_R * (TL / 16); e += NT) {
        const int r = e / (TL / 16), c16 = 16 * (e % (TL / 16));
        const int row = row0 + r, col = l0 + c16;
        const int n = row < I ? min(16, L - col) : 0;
        const int8_t* src = x + (size_t)row * L + col;
        int8_t* dst = xd + r * XS + c16;
        if (vec) {
          cp_async16(dst, n > 0 ? src : x, max(n, 0));
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) dst[q] = q < n ? src[q] : 0;
        }
      }
      float* fd = lpf + ((st & 1) * NS + s) * KP * TL;
      for (int e = tid; e < KC * (TL / 4); e += NT) {
        const int k = e / (TL / 4), c4 = 4 * (e % (TL / 4)), col = l0 + c4;
        const int n = min(4, L - col);
        const float* src = lp + (size_t)k * L + col;
        float* dst = fd + k * TL + c4;
        if (vec) {
          cp_async16(dst, n > 0 ? src : lp, 4 * max(n, 0));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) dst[q] = q < n ? src[q] : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  // the float64 lp tile of stage st from the elements this thread copied
  auto convert = [&](int st) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float* fs = lpf + ((st & 1) * NS + s) * KP * TL;
      double* ds = lpd + ((st & 1) * NS + s) * KP * PS;
      for (int e = tid; e < KC * (TL / 4); e += NT) {
        const int k = e / (TL / 4), c4 = 4 * (e % (TL / 4));
        const float4 f = *reinterpret_cast<const float4*>(fs + k * TL + c4);
        double2* d = reinterpret_cast<double2*>(ds + k * PS + c4);
        d[0] = make_double2(f.x, f.y);
        d[1] = make_double2(f.z, f.w);
      }
    }
  };

#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0;

  issue(0);
  if (n_st > 1) issue(1); else cp_async_commit();
  cp_async_wait<1>();
  convert(0);
  __syncthreads();
  for (int st = 0; st < n_st; ++st) {
    if (st + 2 < n_st) issue(st + 2); else cp_async_commit();
    cp_async_wait<1>();
    if (st + 1 < n_st) convert(st + 1);
    const int8_t* xt = xs + (st % 3) * NS * ROW_R * XS;
    const double* dt = lpd + (st & 1) * NS * KP * PS;
#pragma unroll
    for (int c = 0; c < TL / 16; ++c) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        // slot p of thread t: locus 16 c + 4 t + p; rows g and g + 8
        const int8_t* xr =
            xt + (s * ROW_R + 16 * warp + g) * XS + 16 * c + 4 * t;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(xr + 8 * XS);
        double a[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          a[2 * p] = xcount(w0, p);
          a[2 * p + 1] = xcount(w1, p);
        }
        const double* dr = dt + (s * KP + g) * PS + 16 * c + 4 * t;
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          if (n < nt_live) {
            const double2 b01 =
                *reinterpret_cast<const double2*>(dr + 8 * n * PS);
            const double2 b23 =
                *reinterpret_cast<const double2*>(dr + 8 * n * PS + 2);
            const double bb[4] = {b01.x, b01.y, b23.x, b23.y};
            dmma16(acc[n], a, bb);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The rows pass at Kp = KP <= 128: a block's 128 rows over all kt live
// lanes (k_true clipped to [1, KP]), then the row softmax and t.
template <int KP, bool X1>
__global__ void __launch_bounds__(NT, 1) mix_rows_kernel(
    const float* __restrict__ lp0, const float* __restrict__ lp1,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const float* __restrict__ bias, const float* __restrict__ kmask,
    float* __restrict__ v_out, float* __restrict__ t_out, int I, int L,
    int kt, int vec, int km_stride) {
  constexpr int NT8 = KP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROW_R;
  const float* bias_b = bias + (size_t)b * KP;
  const float* lp0_b = lp0 + (size_t)b * KP * L;
  const int nt_live = (kt + 7) / 8;
  double acc[NT8][4];
  rows_scores<KP, X1>(acc, lp0_b, X1 ? lp1 + (size_t)b * KP * L : lp0_b, x0,
                      x1, row0, I, L, nt_live, vec);

  // the lanes of this thread's clusters 8 n + 2 t + {0, 1} that count:
  // below kt, and in the chain's kmask row where one is given
  bool on[NT8][2];
  const float* km = kmask != nullptr ? kmask + (size_t)b * km_stride : nullptr;
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 8 * n + 2 * t + j;
      on[n][j] = k < kt && (km == nullptr || km[k] > 0.5f);
    }
  // epilogue, rows g and g + 8 of the warp: lanes 4 g .. 4 g + 3 hold a
  // row's scores, clusters 8 n + 2 t + {0, 1}
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + g + 8 * h;
    // s = acc + bias in float64, formed again for the exponentials (the
    // same bits) rather than held
    double m = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (on[n][j])
          m = fmax(m, acc[n][2 * h + j] + (double)bias_b[8 * n + 2 * t + j]);
    m = warp4_max(m);
    float e[NT8][2], part = 0.f;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        e[n][j] = on[n][j]
                      ? expf((float)(acc[n][2 * h + j] +
                                     (double)bias_b[8 * n + 2 * t + j] - m))
                      : 0.f;
        part += e[n][j];
      }
    part += __shfl_xor_sync(FULL, part, 1);
    const float tot = part + __shfl_xor_sync(FULL, part, 2);
    if (row < I) {
      float* v = v_out + ((size_t)b * I + row) * KP + 2 * t;
#pragma unroll
      for (int n = 0; n < NT8; ++n)
        *reinterpret_cast<float2*>(v + 8 * n) =
            make_float2(e[n][0] / tot, e[n][1] / tot);
      if (t == 0)
        t_out[(size_t)b * I + row] = (float)((double)logf(tot) + m);
    }
  }
}

// The wide rows pass, second launch: one warp a row takes the row max of
// its float64 scores over the lanes k < kt (lane owns k = 2 (lane + 32 j)
// + {0, 1}, KJ >= Kp / 64 pairs a lane), then e = expf(s - m),
// the float32 total, v = e / total (0 past kt, up to Kp) and t =
// log(total) + m, as the narrow epilogue does.  Every pair is loaded
// before the first is used (a pair at or past kt loads the last live
// lane's, which the scores kernel wrote, and is masked after).  With a
// kmask, a lane outside the chain's row counts as one past kt: out of
// the max and the total, v = 0.
template <int KJ>
__global__ void __launch_bounds__(NT) mix_softmax_kernel(
    const double* __restrict__ s_in, const float* __restrict__ kmask,
    float* __restrict__ v_out, float* __restrict__ t_out, int I, int Kp,
    int kt, int km_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * NW + warp;
  if (row >= I) return;   // warps share nothing
  const size_t br = (size_t)blockIdx.y * I + row;
  const double2* s = reinterpret_cast<const double2*>(s_in + br * Kp);
  const int last = (kt - 1) / 2;
  const float* km =
      kmask != nullptr ? kmask + (size_t)blockIdx.y * km_stride : nullptr;
  double2 sv[KJ];
  bool on[KJ][2];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    sv[j] = s[min(lane + 32 * j, last)];
    const int k = 2 * (lane + 32 * j);
    on[j][0] = k < kt && (km == nullptr || km[k] > 0.5f);
    on[j][1] = k + 1 < kt && (km == nullptr || km[k + 1] > 0.5f);
  }
  double m = -INFINITY;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    if (on[j][0]) m = fmax(m, sv[j].x);
    if (on[j][1]) m = fmax(m, sv[j].y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(FULL, m, o));
  float2 e[KJ];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    e[j].x = on[j][0] ? expf((float)(sv[j].x - m)) : 0.f;
    e[j].y = on[j][1] ? expf((float)(sv[j].y - m)) : 0.f;
    part += e[j].x + e[j].y;
  }
  const float tot = warp_sum(part);
  float2* v = reinterpret_cast<float2*>(v_out + br * Kp);
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (2 * (lane + 32 * j) < Kp)
      v[lane + 32 * j] = make_float2(e[j].x / tot, e[j].y / tot);
  if (lane == 0) t_out[br] = (float)((double)logf(tot) + m);
}

// ---------------------------------------------------------------------------
// columns pass

// Tiles of the columns pass for Kp and the streams: a warp computes one
// tile of 16 loci by NTW tiles of 8 clusters (A = x^T, B = v, the
// contraction over rows), 4 NS NTW float64 accumulators a thread (at most
// 32); the block's NW warps are WL locus warps x WN cluster warps, TC = 16
// WL loci.  MINB blocks an SM: two where ptxas fits the kernel in 128
// registers with no spill (one stream at Kp = 32 and 96: 89 and 128
// registers with one block an SM asked, measured; the others take 140-227
// there), else one.  ops/mixture_bi.cols_tile and cols_blocks_per_sm
// mirror TC and MINB (and WideColsTile's, above 128 lanes).
constexpr int cols_ntw(int nt8, int ns) {
  for (int d = nt8; d > 1; --d)
    if (nt8 % d == 0 && ns * d <= 8 && NW % (nt8 / d) == 0) return d;
  return 1;
}

template <int KP, bool X1>
struct ColsTile {
  static constexpr int NS = X1 ? 2 : 1;
  static constexpr int NT8 = KP / 8;
  static constexpr int NTW = cols_ntw(NT8, NS);
  static constexpr int WN = NT8 / NTW;
  static constexpr int WL = NW / WN;
  static constexpr int TC = 16 * WL;
  static constexpr int MINB = (KP == 32 || KP == 96) && !X1 ? 2 : 1;
  // bytes an x row (the 16-bit reads of 4 rows x 4 words hit distinct
  // banks), doubles a v row (4 past a multiple of 16, likewise)
  static constexpr int XS = TC + 16;
  static constexpr int VS = KP + 4;
  static constexpr int D_BYTES = 2 * COL_RI * VS * 8;
  static constexpr int F_BYTES = 2 * COL_RI * KP * 4;
  static constexpr int X_BYTES = 3 * NS * COL_RI * XS;
  static constexpr int S_BYTES = COL_RI * KP * 8;   // float64 v sums
  static constexpr int SMEM = D_BYTES + F_BYTES + X_BYTES + S_BYTES;
};

// One columns-pass block: the loci col0 .. col0 + TC - 1 over the rows of
// row segment `seg` of this chain, for the KP lanes of v starting at v_b
// (row stride vs; lanes at or past kv are read as zeros), of which the
// first nt_live tiles of 8 are computed (the others stay 0).  Writes the
// segment's partials to out [NS][.][L] (lane k at out + (s ko + k) L, for
// k < kv) and, from the first locus tile's blocks, the segment's v sums
// to vp_out[k], k < kv.  Warp (wl, wn) owns loci col0 + 16 wl .. + 15 and
// cluster tiles wn NTW ..; in a 16-row step, slot p of thread t is row t +
// 4 p.  The v sums are taken from the thread's own copies of v: float32
// over at most VSUM_ST stages, then added to the thread's own float64
// slots of `vs` (no barrier), and summed over the rows of a stage in
// float64 at the end.
template <int KP, bool X1>
__device__ __forceinline__ void cols_block(
    const float* __restrict__ v_b, int vs_row, int kv, int nt_live,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    float* __restrict__ out, int ko, float* __restrict__ vp_out, int I,
    int L, int seg, int seg_rows, int vec) {
  using T = ColsTile<KP, X1>;
  constexpr int NS = T::NS, NTW = T::NTW, TC = T::TC;
  constexpr int XS = T::XS, VS = T::VS, RI = COL_RI;
  constexpr int JV = RI * KP / 4 / NT;   // v chunks of 4 a thread a stage
  double* vd = reinterpret_cast<double*>(dyn_smem4);
  float* vf = reinterpret_cast<float*>(dyn_smem4) + T::D_BYTES / 4;
  int8_t* xs = reinterpret_cast<int8_t*>(dyn_smem4) + T::D_BYTES + T::F_BYTES;
  double* vs = reinterpret_cast<double*>(xs + T::X_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wl = warp % T::WL, wn = warp / T::WL;
  const int col0 = blockIdx.x * TC;
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const bool first = blockIdx.x == 0;
  const int n_st = (r_hi - r_lo + RI - 1) / RI;

  auto issue = [&](int st) {
    const int r0 = r_lo + st * RI;
    float* fd = vf + (st & 1) * RI * KP;
#pragma unroll
    for (int j = 0; j < JV; ++j) {
      const int e = tid + NT * j, r = e / (KP / 4), c4 = 4 * (e % (KP / 4));
      const int row = r0 + r;
      const bool ok = row < r_hi && c4 < kv;
      cp_async16(fd + r * KP + c4,
                 ok ? v_b + (size_t)row * vs_row + c4 : v_b, ok ? 16 : 0);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int8_t* x = s ? x1 : x0;
      int8_t* xd = xs + ((st % 3) * NS + s) * RI * XS;
      for (int e = tid; e < RI * (TC / 16); e += NT) {
        const int r = e / (TC / 16), c16 = 16 * (e % (TC / 16));
        const int row = r0 + r, col = col0 + c16;
        const int n = row < r_hi ? min(16, L - col) : 0;
        const int8_t* src = x + (size_t)row * L + col;
        int8_t* dst = xd + r * XS + c16;
        if (vec) {
          cp_async16(dst, n > 0 ? src : x, max(n, 0));
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) dst[q] = q < n ? src[q] : 0;
        }
      }
    }
    cp_async_commit();
  };
  // the float64 v tile of stage st from this thread's own copies and
  // (first locus tile) the v sums of the thread's chunks, element 4 (tid +
  // NT j) + q of a [RI, KP] stage: float32 in registers over VSUM_ST
  // stages, then added to the same element of vs in float64
  float vsum[JV][4];
  auto flush_vsum = [&]() {
#pragma unroll
    for (int j = 0; j < JV; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vs[4 * (tid + NT * j) + q] += (double)vsum[j][q];
        vsum[j][q] = 0.f;
      }
  };
#pragma unroll
  for (int j = 0; j < JV; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      vsum[j][q] = 0.f;
      if (first) vs[4 * (tid + NT * j) + q] = 0.0;
    }
  auto convert = [&](int st) {
    const float* fs = vf + (st & 1) * RI * KP;
    double* ds = vd + (st & 1) * RI * VS;
#pragma unroll
    for (int j = 0; j < JV; ++j) {
      const int e = tid + NT * j, r = e / (KP / 4), c4 = 4 * (e % (KP / 4));
      const float4 f = *reinterpret_cast<const float4*>(fs + r * KP + c4);
      double2* d = reinterpret_cast<double2*>(ds + r * VS + c4);
      d[0] = make_double2(f.x, f.y);
      d[1] = make_double2(f.z, f.w);
      if (first) {
        vsum[j][0] += f.x;
        vsum[j][1] += f.y;
        vsum[j][2] += f.z;
        vsum[j][3] += f.w;
      }
    }
    if (first && st % VSUM_ST == VSUM_ST - 1) flush_vsum();
  };

  double acc[NS][NTW][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][n][j] = 0.0;

  issue(0);
  if (n_st > 1) issue(1); else cp_async_commit();
  cp_async_wait<1>();
  convert(0);
  __syncthreads();
  for (int st = 0; st < n_st; ++st) {
    if (st + 2 < n_st) issue(st + 2); else cp_async_commit();
    cp_async_wait<1>();
    if (st + 1 < n_st) convert(st + 1);
    const int8_t* xt = xs + (st % 3) * NS * RI * XS + 16 * wl + 2 * g;
    const double* dt = vd + (st & 1) * RI * VS;
#pragma unroll
    for (int c = 0; c < RI / 16; ++c) {
      // A: loci 2 g (m = g) and 2 g + 1 (m = g + 8) of the warp's tile
      double a[NS][8];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(
              xt + (s * RI + 16 * c + t + 4 * p) * XS);
          a[s][2 * p] = xcount(w, 0);
          a[s][2 * p + 1] = xcount(w, 1);
        }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int nt = wn * NTW + n;
        if (nt < nt_live) {
          double bb[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            bb[p] = dt[(16 * c + t + 4 * p) * VS + 8 * nt + g];
#pragma unroll
          for (int s = 0; s < NS; ++s) dmma16(acc[s][n], a[s], bb);
        }
      }
    }
    __syncthreads();
  }

  // a thread holds loci 2 g, 2 g + 1 of its warp's tile for clusters
  // 8 nt + 2 t + {0, 1}
  const int lc = col0 + 16 * wl + 2 * g;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int k = 8 * (wn * NTW + n) + 2 * t + jj;
        if (k >= kv) continue;
        const float o0 = (float)acc[s][n][jj], o1 = (float)acc[s][n][2 + jj];
        float* dst = out + ((size_t)s * ko + k) * L + lc;
        if (vec && lc + 2 <= L) {
          *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
        } else {
          if (lc < L) dst[0] = o0;
          if (lc + 1 < L) dst[1] = o1;
        }
      }

  if (first) {   // uniform across the block
    // the v sums over the segment: each thread's last stages into its
    // slots, then summed over the stage's rows in order in float64
    flush_vsum();
    __syncthreads();
    if (tid < KP && tid < kv) {
      double sum = 0.0;
      for (int r = 0; r < RI; ++r) sum += vs[r * KP + tid];
      vp_out[tid] = (float)sum;
    }
  }
}

// The columns pass at Kp = KP <= 128: block (locus tile, row segment,
// chain) over the live tiles of kt lanes; writes part[b][seg][stream][k]
// [l] and, from the first locus tile, vpart[b][seg][k].
template <int KP, bool X1>
__global__ void __launch_bounds__(NT, ColsTile<KP, X1>::MINB) mix_cols_kernel(
    const float* __restrict__ v, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, float* __restrict__ part,
    float* __restrict__ vpart, int I, int L, int seg_rows, int kt, int vec) {
  constexpr int NS = X1 ? 2 : 1;
  const int b = blockIdx.z, seg = blockIdx.y, n_seg = gridDim.y;
  const size_t bs = (size_t)b * n_seg + seg;
  cols_block<KP, X1>(v + (size_t)b * I * KP, KP, KP, (kt + 7) / 8, x0, x1,
                     part + bs * NS * KP * L, KP, vpart + bs * KP, I, L, seg,
                     seg_rows, vec);
}

// ---------------------------------------------------------------------------
// the wide passes (128 < Kp <= 1024)

// A block of either wide pass owns a chunk of at most MIX_WK cluster lanes
// and BM rows (rows pass) or loci (columns pass).  Its 8 warps form WM
// warp rows of MT tiles of 16 by WN warp columns of NTW tiles of 8 lanes;
// warp column wc owns the chunk's lane tiles wc, wc + WN, wc + 2 WN, ...,
// and warp w sits in warp row w % WM (the two warps of one SM
// sub-partition, w and w + 4, hold different lane tiles).  A stage is TK
// loci (rows pass) or rows (columns pass) of both operands as they lie in
// device memory (int8 x, float32 lp or v), copied by cp.async into a ring
// of WIDE_ST stages with one barrier a stage; a fragment converts its
// values to float64 in registers.  A warp runs a stage's products through
// code made for its number of live lane tiles NJ (0 to NTW), chosen once
// a stage: no test between two DMMAs.
constexpr int WIDE_ST = 2;

template <int MT, int NTW>
struct WideWarps {
  static constexpr int WN = MIX_WK / (8 * NTW);
  static constexpr int WM = NW / WN;
  static constexpr int BM = 16 * MT * WM;
  static_assert(WN * WM == NW, "the warps tile the block");
};

// The wide rows-pass block: 4 x 4 DMMA tiles a warp (64 rows x 32 lanes,
// 64 float64 accumulators a thread), 128 rows; TK = 128 loci a stage (64
// with two streams).  Shared memory a stage, for each stream: the x tile
// [BM][XS] bytes and the lp tile [MIX_WK][LS] floats.  XS = TK + 16: the
// 32-bit reads of rows g (8) and words t hit 32 banks; LS = TK + 16: the
// 16-byte reads of a quarter warp (lanes 2 g, t) hit distinct banks.
template <bool X1>
struct WideRowsTile {
  static constexpr int MT = 4, NTW = 4;
  using W = WideWarps<MT, NTW>;
  static constexpr int NS = X1 ? 2 : 1;
  static constexpr int TK = X1 ? 64 : 128;
  static constexpr int XS = TK + 16;
  static constexpr int LS = TK + 16;
  static constexpr int X_BYTES = W::BM * XS;
  static constexpr int S_BYTES = X_BYTES + MIX_WK * LS * 4;   // a stream
  static constexpr int STAGE = NS * S_BYTES;
  static constexpr int SMEM = WIDE_ST * STAGE;
};

// One stage of the rows pass's products for a warp with NJ live lane
// tiles: A = x (rows g and g + 8 of a tile), B = lp^T, slot p of thread t
// locus 4 t + p of a 16-locus step.
template <bool X1, int NJ>
__device__ __forceinline__ void wide_rows_stage(
    double (&acc)[WideRowsTile<X1>::MT][WideRowsTile<X1>::NTW][4],
    const char* stage, int wm, int wc, int g, int t) {
  using T = WideRowsTile<X1>;
  constexpr int MT = T::MT, XS = T::XS, LS = T::LS, WN = T::W::WN;
#pragma unroll
  for (int c = 0; c < T::TK / 16; ++c) {
#pragma unroll
    for (int s = 0; s < T::NS; ++s) {
      const int8_t* xt =
          reinterpret_cast<const int8_t*>(stage + s * T::S_BYTES) +
          (16 * wm * MT + g) * XS + 16 * c + 4 * t;
      const float* lt =
          reinterpret_cast<const float*>(stage + s * T::S_BYTES +
                                         T::X_BYTES) +
          (8 * wc + g) * LS + 16 * c + 4 * t;
      double bb[NJ > 0 ? NJ : 1][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 f =
            *reinterpret_cast<const float4*>(lt + 8 * WN * j * LS);
        bb[j][0] = f.x;
        bb[j][1] = f.y;
        bb[j][2] = f.z;
        bb[j][3] = f.w;
      }
#pragma unroll
      for (int m = 0; NJ > 0 && m < MT; ++m) {
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(xt + 16 * m * XS);
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(xt + (16 * m + 8) * XS);
        double a[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          a[2 * p] = xcount(w0, p);
          a[2 * p + 1] = xcount(w1, p);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma16(acc[m][j], a, bb[j]);
      }
    }
  }
}

// The wide rows pass (128 < Kp <= 1024), first launch: a persistent grid
// over the tiles (BM rows, chunk of live lane tiles, chain), each block
// taking every gridDim.x-th.  A tile's scores over the whole of L on its
// chunk's lanes are written as s = acc + bias in float64 to s_out [B, I,
// Kp] (the lanes past the live tiles are not written: the softmax reads
// the lanes below kt only).
template <bool X1>
__global__ void __launch_bounds__(NT, 1) mix_rows_wide_kernel(
    const float* __restrict__ lp0, const float* __restrict__ lp1,
    const int8_t* __restrict__ x0, const int8_t* __restrict__ x1,
    const float* __restrict__ bias, double* __restrict__ s_out, int I,
    int L, int Kp, int kt, int B, int vec) {
  using T = WideRowsTile<X1>;
  using W = typename T::W;
  constexpr int NS = T::NS, TK = T::TK, XS = T::XS, LS = T::LS;
  constexpr int MT = T::MT, NTW = T::NTW, BM = W::BM, WN = W::WN;
  constexpr int ST = WIDE_ST;
  char* smem = reinterpret_cast<char*>(dyn_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % W::WM, wc = warp / W::WM;
  const int n_rt = (I + BM - 1) / BM;
  const int n_tiles = n_rt * B * wide_chunks(kt);
  const int n_st = (L + TK - 1) / TK;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = (tile % n_rt) * BM;
    const int b = (tile / n_rt) % B;
    int t0, nt_live;
    chunk_tiles(tile / (n_rt * B), kt, &t0, &nt_live);
    const int k0 = 8 * t0;
    const int nj = live_tiles<NTW, WN>(nt_live, wc);
    const int KC = 8 * nt_live;   // lp rows copied
    const float* lp0_b = lp0 + ((size_t)b * Kp + k0) * L;
    const float* lp1_b = X1 ? lp1 + ((size_t)b * Kp + k0) * L : lp0_b;

    auto issue = [&](int st) {
      char* stage = smem + (st % ST) * T::STAGE;
      const int l0 = st * TK;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int8_t* x = s ? x1 : x0;
        const float* lp = s ? lp1_b : lp0_b;
        int8_t* xd = reinterpret_cast<int8_t*>(stage + s * T::S_BYTES);
        float* ld = reinterpret_cast<float*>(stage + s * T::S_BYTES +
                                             T::X_BYTES);
        for (int e = tid; e < BM * (TK / 16); e += NT) {
          const int r = e / (TK / 16), c16 = 16 * (e % (TK / 16));
          const int row = row0 + r, col = l0 + c16;
          const int n = row < I ? min(16, L - col) : 0;
          const int8_t* src = x + (size_t)row * L + col;
          int8_t* dst = xd + r * XS + c16;
          if (vec) {
            cp_async16(dst, n > 0 ? src : x, max(n, 0));
          } else {
#pragma unroll
            for (int q = 0; q < 16; ++q) dst[q] = q < n ? src[q] : 0;
          }
        }
        for (int e = tid; e < KC * (TK / 4); e += NT) {
          const int k = e / (TK / 4), c4 = 4 * (e % (TK / 4)), col = l0 + c4;
          const int n = min(4, L - col);
          const float* src = lp + (size_t)k * L + col;
          float* dst = ld + k * LS + c4;
          if (vec) {
            cp_async16(dst, n > 0 ? src : lp, 4 * max(n, 0));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) dst[q] = q < n ? src[q] : 0.f;
          }
        }
      }
      cp_async_commit();
    };

    double acc[MT][NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.0;

    __syncthreads();   // every warp is done with the last tile's ring
#pragma unroll
    for (int st = 0; st < ST - 1; ++st) {
      if (st < n_st) issue(st); else cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      // stage st has landed for every thread, and every warp is done with
      // stage st - 1, whose slot the next copies take
      cp_async_wait<ST - 2>();
      __syncthreads();
      if (st + ST - 1 < n_st) issue(st + ST - 1); else cp_async_commit();
      const char* stage = smem + (st % ST) * T::STAGE;
      with_count<NTW>(nj, [&](auto n) {
        wide_rows_stage<X1, decltype(n)::value>(acc, stage, wm, wc, g, t);
      });
    }

    // rows g and g + 8 of each tile, lanes 8 (wc + WN j) + 2 t + {0, 1}
    const float* bias_b = bias + (size_t)b * Kp + k0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * (wm * MT + m) + g + 8 * h;
        if (row >= I) continue;
        double* s = s_out + ((size_t)b * I + row) * Kp + k0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int k = 8 * (wc + WN * j);
          if (j < nj)
            *reinterpret_cast<double2*>(s + k) = make_double2(
                acc[m][j][2 * h] + (double)bias_b[k + 2 * t],
                acc[m][j][2 * h + 1] + (double)bias_b[k + 2 * t + 1]);
        }
      }
  }
}

// The wide columns-pass block: 4 x 4 DMMA tiles a warp with one stream
// (64 loci x 32 lanes, 128 loci a block), 2 x 4 a stream with two (64
// loci a block), 64 float64 accumulators a thread; TK = 128 rows a stage.
// Shared memory a stage: the v tile [TK][VS] floats and for each stream
// the x tile [TK][XS] bytes.  VS = MIX_WK + 8: the reads of rows t (4) and
// lanes g (8) hit 32 banks; XS = BM + 16: the 16-bit reads of rows t and
// locus pairs g hit distinct banks.
template <bool X1>
struct WideColsTile {
  static constexpr int MT = X1 ? 2 : 4, NTW = 4;
  using W = WideWarps<MT, NTW>;
  static constexpr int NS = X1 ? 2 : 1;
  static constexpr int TK = 128;
  static constexpr int XS = W::BM + 16;
  static constexpr int VS = MIX_WK + 8;
  static constexpr int X_BYTES = TK * XS;   // a stream
  static constexpr int V_BYTES = TK * VS * 4;
  static constexpr int STAGE = V_BYTES + NS * X_BYTES;
  static constexpr int SMEM = WIDE_ST * STAGE;
};

// One stage of the columns pass's products for a warp with NJ live lane
// tiles: A = x^T (a tile's rows g and g + 8 are loci 2 g and 2 g + 1, one
// 16-bit read), B = v, slot p of thread t row t + 4 p of a 16-row step.
template <bool X1, int NJ>
__device__ __forceinline__ void wide_cols_stage(
    double (&acc)[X1 ? 2 : 1][WideColsTile<X1>::MT][4][4],
    const char* stage, int wm, int wc, int g, int t) {
  using T = WideColsTile<X1>;
  constexpr int MT = T::MT, XS = T::XS, VS = T::VS, WN = T::W::WN;
#pragma unroll
  for (int c = 0; c < T::TK / 16; ++c) {
    const float* vt = reinterpret_cast<const float*>(stage) +
                      (16 * c + t) * VS + 8 * wc + g;
    const int8_t* xt = reinterpret_cast<const int8_t*>(stage + T::V_BYTES) +
                       (16 * c + t) * XS + 16 * wm * MT + 2 * g;
    double bb[NJ > 0 ? NJ : 1][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p) bb[j][p] = vt[4 * p * VS + 8 * WN * j];
#pragma unroll
    for (int s = 0; NJ > 0 && s < T::NS; ++s) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        double a[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(
              xt + s * T::X_BYTES + 4 * p * XS + 16 * m);
          a[2 * p] = xcount(w, 0);
          a[2 * p + 1] = xcount(w, 1);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma16(acc[s][m][j], a, bb[j]);
      }
    }
  }
}

// The wide columns pass (128 < Kp <= 1024): block (BM loci, row segment,
// chain x chunk of live lane tiles) sums x^T v over the segment's rows on
// the chunk's lanes (v at row stride Kp) and writes them to part [B,
// n_seg, NS, Kp, L], and the segment's v sums of its share of those lanes
// to vpart [B, n_seg, Kp] (each locus tile sums ceil(lanes / tiles) of
// them, a thread one lane over every rg_n-th row: float32 within a stage,
// float64 across, the row groups in order at the end).  The first chunk's
// blocks write zeros to the lanes past the live tiles.
template <bool X1>
__global__ void __launch_bounds__(NT, 1) mix_cols_wide_kernel(
    const float* __restrict__ v, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, float* __restrict__ part,
    float* __restrict__ vpart, int I, int L, int Kp, int seg_rows, int kt,
    int vec) {
  using T = WideColsTile<X1>;
  using W = typename T::W;
  constexpr int NS = T::NS, TK = T::TK, XS = T::XS, VS = T::VS;
  constexpr int MT = T::MT, NTW = T::NTW, BM = W::BM, WN = W::WN;
  constexpr int ST = WIDE_ST;
  char* smem = reinterpret_cast<char*>(dyn_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % W::WM, wc = warp / W::WM;
  const int n_ch = wide_chunks(kt), c = blockIdx.z % n_ch;
  const int b = blockIdx.z / n_ch;
  int t0, nt_live;
  chunk_tiles(c, kt, &t0, &nt_live);
  const int k0 = 8 * t0, kv = 8 * nt_live;   // the chunk's lanes
  const int seg = blockIdx.y, n_seg = gridDim.y;
  const int col0 = blockIdx.x * BM;
  const int nj = live_tiles<NTW, WN>(nt_live, wc);
  const int r_lo = seg * seg_rows, r_hi = min(I, r_lo + seg_rows);
  const int n_st = (r_hi - r_lo + TK - 1) / TK;
  const float* v_b = v + (size_t)b * I * Kp + k0;
  // the v sums: this locus tile's share of the chunk's lanes, ks from k_lo
  // (a thread: lane k_lo + tid % ks, rows tid / ks + rg_n i of a stage)
  const int ks = (kv + gridDim.x - 1) / gridDim.x;
  const int k_lo = blockIdx.x * ks, nk = max(0, min(ks, kv - k_lo));
  const int rg_n = NT / ks, rg = tid / ks;
  const bool summing = nk > 0 && rg < rg_n && tid % ks < nk;

  auto issue = [&](int st) {
    char* stage = smem + (st % ST) * T::STAGE;
    const int r0 = r_lo + st * TK;
    float* vd = reinterpret_cast<float*>(stage);
    for (int e = tid; e < TK * (MIX_WK / 4); e += NT) {
      const int r = e / (MIX_WK / 4), c4 = 4 * (e % (MIX_WK / 4));
      const int row = r0 + r;
      const bool ok = row < r_hi && c4 < kv;
      cp_async16(vd + r * VS + c4, ok ? v_b + (size_t)row * Kp + c4 : v_b,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int8_t* x = s ? x1 : x0;
      int8_t* xd = reinterpret_cast<int8_t*>(stage + T::V_BYTES +
                                             s * T::X_BYTES);
      for (int e = tid; e < TK * (BM / 16); e += NT) {
        const int r = e / (BM / 16), c16 = 16 * (e % (BM / 16));
        const int row = r0 + r, col = col0 + c16;
        const int n = row < r_hi ? min(16, L - col) : 0;
        const int8_t* src = x + (size_t)row * L + col;
        int8_t* dst = xd + r * XS + c16;
        if (vec) {
          cp_async16(dst, n > 0 ? src : x, max(n, 0));
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) dst[q] = q < n ? src[q] : 0;
        }
      }
    }
    cp_async_commit();
  };

  double acc[NS][MT][NTW][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][m][j][q] = 0.0;
  double vsum = 0.0;

#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < n_st) issue(st); else cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (st + ST - 1 < n_st) issue(st + ST - 1); else cp_async_commit();
    const char* stage = smem + (st % ST) * T::STAGE;
    if (summing) {
      const float* vc = reinterpret_cast<const float*>(stage) + rg * VS +
                        k_lo + tid % ks;
      float part = 0.f;
      for (int r = 0; rg + r < TK; r += rg_n) part += vc[r * VS];
      vsum += (double)part;
    }
    with_count<NTW>(nj, [&](auto n) {
      wide_cols_stage<X1, decltype(n)::value>(acc, stage, wm, wc, g, t);
    });
  }

  // a thread holds loci 2 g, 2 g + 1 of each tile for lanes 8 (wc + WN j)
  // + 2 t + {0, 1}; the warp's dead tiles hold zeros
  const size_t bs = (size_t)b * n_seg + seg;
  float* out = part + (bs * NS * Kp + k0) * L;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int lc = col0 + 16 * (wm * MT + m) + 2 * g;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k = 8 * (wc + WN * j) + 2 * t + jj;
          if (k >= kv) continue;
          const float o0 = (float)acc[s][m][j][jj];
          const float o1 = (float)acc[s][m][j][2 + jj];
          float* dst = out + ((size_t)s * Kp + k) * L + lc;
          if (vec && lc + 2 <= L) {
            *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
          } else {
            if (lc < L) dst[0] = o0;
            if (lc + 1 < L) dst[1] = o1;
          }
        }
    }

  // each lane's row groups summed in order
  __syncthreads();   // every warp is done with the ring
  double* sums = reinterpret_cast<double*>(smem);
  sums[tid] = vsum;
  __syncthreads();
  if (tid < nk) {
    double tot = 0.0;
    for (int q = 0; q < rg_n; ++q) tot += sums[q * ks + tid];
    vpart[bs * Kp + k0 + k_lo + tid] = (float)tot;
  }
  // the lanes past the live tiles: zeros, from the first chunk's blocks
  const int k_dead = 8 * ((kt + 7) / 8);
  if (c == 0) {
    const int nl = min(BM, L - col0), nd = Kp - k_dead;
    for (int e = tid; e < NS * nd * nl; e += NT) {
      const int s = e / (nd * nl), k = k_dead + e / nl % nd;
      part[((bs * NS + s) * Kp + k) * L + col0 + e % nl] = 0.f;
    }
    if (blockIdx.x == 0)
      for (int k = k_dead + tid; k < Kp; k += NT) vpart[bs * Kp + k] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// finish: eta' and p0' (or the raw B0/B1) from the columns pass's partials,
// one launch a step

// The finish's arguments.  part [B, n_seg, 1|2, Kp, L]; vpart [B, v_seg,
// Kp], the v sums (v_seg = n_seg, or 1 where the caller hands a vtot
// already summed).  Eta half (eta non-null): vtot [B, Kp] (written where
// non-null) and eta [B, Kp], or [B, k_true] under `params`.  p half (out0
// non-null) over the lanes k < nk (Kp, or k_true under `params`) and
// nq = ceil(L / 4) groups of 4 loci: out0 = p0' [B, Kp, L], the raw B0
// under `finish` = 0 (out1 the raw B1 of two streams), or under `params`
// the model's p [B, k_true, L, 2] = (p0', 1 - p0').  kmask (may be null):
// chain b's lanes at kmask + b km_stride, which the eta half keeps to.
struct FinishArgs {
  const float* part;
  const float* vpart;
  const float* kmask;
  float* vtot;
  float* eta;
  float* out0;
  float* out1;
  int Kp, L, n_seg, v_seg, two, k_true, nk, nq, km_stride;
  float lb, plb, pub, ploidy;
  int project, finish, params, vec;
};

// segments a p thread loads (4 loci of each stream) before it adds any
constexpr int FIN_SEG = 4;

// The eta half, one warp (lane owns k = lane + 32 j, KJ slots a lane, the
// slots at or past Kp none): vtot_k = the segments' v sums added in
// segment order, the slots of a batch of SQ segments loaded before any is
// added (one round trip to L2 a batch, not one a slot and segment; at
// most 32 loads, and 8 segments, in flight a lane); then eta' =
// Michelot(vtot / sum vtot) over the lanes k < k_true, or over the
// chain's kmask row, the sum too.  Pad lanes of vtot are exactly 0.
template <int KJ>
__device__ __forceinline__ void finish_eta(const FinishArgs& a, int b,
                                           int lane) {
  constexpr int SQ = KJ >= 32 ? 1 : 32 / KJ < 8 ? 32 / KJ : 8;
  const float* vp = a.vpart + (size_t)b * a.v_seg * a.Kp;
  float w[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) w[j] = 0.f;
  for (int q0 = 0; q0 < a.v_seg; q0 += SQ) {
    float r[SQ][KJ];
#pragma unroll
    for (int u = 0; u < SQ; ++u)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = lane + 32 * j;
        r[u][j] = q0 + u < a.v_seg && k < a.Kp
                      ? vp[(size_t)(q0 + u) * a.Kp + k] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < SQ; ++u)
      if (q0 + u < a.v_seg)
#pragma unroll
        for (int j = 0; j < KJ; ++j) w[j] += r[u][j];
  }
  const float* km =
      a.kmask != nullptr ? a.kmask + (size_t)b * a.km_stride : nullptr;
  unsigned valid = 0u;
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    if (a.vtot != nullptr && k < a.Kp) a.vtot[(size_t)b * a.Kp + k] = w[j];
    if (km != nullptr ? k < a.Kp && km[k] > 0.5f : k < a.k_true)
      valid |= 1u << j;
    if (km != nullptr && !(valid >> j & 1u)) w[j] = 0.f;
    part += w[j];
  }
  const float tot = warp_sum(part);
#pragma unroll
  for (int j = 0; j < KJ; ++j) w[j] = w[j] / tot;
  if (a.project) mc::michelot_warp_mask<KJ>(w, valid, a.lb);
  const int ld = a.params ? a.k_true : a.Kp;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (lane + 32 * j < ld) a.eta[(size_t)b * ld + lane + 32 * j] = w[j];
}

// 4 loci from p: one 16-byte load where `vec`, else the n < 4 left and
// zeros past them
__device__ __forceinline__ void load4(float (&r)[4], const float* p, int vec,
                                      int n) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = i < n ? p[i] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&r)[4],
                                       int vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = r[i];
  }
}

// The p half, one thread a (chain, lane k < nk, 4 loci): B0 (B1) = the
// segments' partials added in segment order, FIN_SEG segments' loads
// issued before any is added; with one stream the lane's vtot too, from
// vpart in the eta half's order, so that no p block waits for the eta
// half; then the p0 update, as the TPU kernel's last row block
// (kernels.py:1196-1210) and the model's (p0', 1 - p0') under `params`.
__device__ __forceinline__ void finish_p(const FinishArgs& a, int b,
                                         int item) {
  const int k = item / a.nq, l0 = 4 * (item - k * a.nq);
  if (k >= a.nk) return;
  const int L = a.L, n = min(4, L - l0), ns = a.two ? 2 : 1;
  const size_t KL = (size_t)a.Kp * L;
  const float* pb =
      a.part + (size_t)b * a.n_seg * ns * KL + (size_t)k * L + l0;
  float vt = 0.f;
  if (a.finish && !a.two) {
    const float* vb = a.vpart + (size_t)b * a.v_seg * a.Kp + k;
    for (int q0 = 0; q0 < a.v_seg; q0 += FIN_SEG) {
      float r[FIN_SEG];
#pragma unroll
      for (int u = 0; u < FIN_SEG; ++u)
        r[u] = q0 + u < a.v_seg ? vb[(size_t)(q0 + u) * a.Kp] : 0.f;
#pragma unroll
      for (int u = 0; u < FIN_SEG; ++u)
        if (q0 + u < a.v_seg) vt += r[u];
    }
  }
  float b0[4] = {0.f, 0.f, 0.f, 0.f}, b1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < a.n_seg; s0 += FIN_SEG) {
    float r0[FIN_SEG][4], r1[FIN_SEG][4];
#pragma unroll
    for (int u = 0; u < FIN_SEG; ++u)
      if (s0 + u < a.n_seg) {
        const float* src = pb + (size_t)(s0 + u) * ns * KL;
        load4(r0[u], src, a.vec, n);
        if (a.two) load4(r1[u], src + KL, a.vec, n);
      }
#pragma unroll
    for (int u = 0; u < FIN_SEG; ++u)
      if (s0 + u < a.n_seg)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] += r0[u][i];
          if (a.two) b1[i] += r1[u][i];
        }
  }
  if (!a.finish) {
    const size_t o = ((size_t)b * a.Kp + k) * L + l0;
    store4(a.out0 + o, b0, a.vec, n);
    if (a.two) store4(a.out1 + o, b1, a.vec, n);
    return;
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float pc0 = b0[i] + a.plb;
    const float pc1 = a.two ? b1[i] + a.plb : a.ploidy * vt - b0[i] + a.plb;
    float p = pc0 / (pc0 + pc1);
    if (a.project) p = fminf(fmaxf(p, a.plb), a.pub);
    q[i] = p;
  }
  if (!a.params) {
    store4(a.out0 + ((size_t)b * a.Kp + k) * L + l0, q, a.vec, n);
    return;
  }
  // 1 - p0' in float32: the IEEE subtraction torch's 1.0 - p0n makes
  float* dst = a.out0 + (((size_t)b * a.nk + k) * L + l0) * 2;
  const float lo[4] = {q[0], 1.f - q[0], q[1], 1.f - q[1]};
  const float hi[4] = {q[2], 1.f - q[2], q[3], 1.f - q[3]};
  store4(dst, lo, a.vec, min(4, 2 * n));
  store4(dst + 4, hi, a.vec, 2 * n - 4);
}

// The finish: block 0 of each chain's row runs the eta half (its first
// warp; with an eta), the other blocks (all, without one) the p half,
// NT threads a block of (lane, 4 loci) items.  KJ = 0 is the p half
// alone, with no eta half compiled in.
template <int KJ>
__global__ void __launch_bounds__(NT) mix_finish_kernel(const FinishArgs a) {
  const int b = blockIdx.y;
  int eta_on = 0;
  if constexpr (KJ > 0) {
    eta_on = a.eta != nullptr;
    if (eta_on && blockIdx.x == 0) {
      if (threadIdx.x < 32) finish_eta<KJ>(a, b, threadIdx.x);
      return;
    }
  }
  finish_p(a, b, (blockIdx.x - eta_on) * NT + threadIdx.x);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/build.py).  Pointers are
// device pointers; lp1/x1 (and out1) are null for the one-stream variant.
// `stream` is a cudaStream_t.  Each returns the error of its shared-memory
// opt-in, or else the cudaGetLastError() of its launch.

static bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

static bool kp_narrow(int Kp) {
  return Kp == 32 || Kp == 64 || Kp == 96 || Kp == 128;
}
static bool kp_wide(int Kp) {
  return Kp > 128 && Kp <= KP_WIDE_MAX && Kp % 32 == 0;
}
// the lanes the passes compute for k_true clusters (outside [1, Kp]: Kp)
static int live_lanes(int k_true, int Kp) {
  return k_true < 1 || k_true > Kp ? Kp : k_true;
}

// The rows pass: v [B, I, Kp] and t [B, I].  At 128 < Kp <= 1024 `s_buf`
// is the [B, I, Kp] float64 scratch of the wide pass's two launches (the
// scores, on at most one block an SM, and the softmax); it is not read at
// Kp <= 128 and may be null.  kmask may be null: chain b's lanes are
// kmask[b km_stride + k] (km_stride 0 or Kp).
extern "C" int mc_mix_rows(const void* lp0, const void* lp1, const void* x0,
                           const void* x1, const void* bias,
                           const void* kmask, void* v_out, void* t_out,
                           void* s_buf, int B, int I, int L, int Kp,
                           int k_true, int km_stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)lp0;
  const float* c = (const float*)lp1;
  const int8_t* x = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  const float* bs = (const float*)bias;
  const float* km = (const float*)kmask;
  float* v = (float*)v_out;
  float* t = (float*)t_out;
  const bool two = lp1 != nullptr;
  const int vec = L % 16 == 0 && aligned16(lp0) && aligned16(lp1) &&
                  aligned16(x0) && aligned16(x1);
  const int kt = live_lanes(k_true, Kp);
  int err = 0;
  if (kp_wide(Kp)) {
    if (s_buf == nullptr || !aligned16(s_buf))
      return (int)cudaErrorInvalidValue;
    double* sb = (double*)s_buf;
    int n_sm = 0, dev = 0;
    err = (int)cudaGetDevice(&dev);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                        dev);
    if (err) return err;
#define MC_ROWS_WIDE(X1)                                                     \
  {                                                                          \
    auto kern = mix_rows_wide_kernel<X1>;                                    \
    constexpr int smem = WideRowsTile<X1>::SMEM;                             \
    static_assert(smem <= SMEM_MAX, "wide rows tiles exceed shared memory"); \
    constexpr int BM = WideRowsTile<X1>::W::BM;                              \
    const int tiles = (I + BM - 1) / BM * B * wide_chunks(kt);               \
    err = allow_smem(kern);                                                  \
    if (err == 0)                                                            \
      kern<<<tiles < n_sm ? tiles : n_sm, NT, smem, s>>>(                    \
          a, c, x, z, bs, sb, I, L, Kp, kt, B, vec);                         \
  }
    if (two) MC_ROWS_WIDE(true) else MC_ROWS_WIDE(false)
#undef MC_ROWS_WIDE
    if (err == 0) err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 sgrid((I + NW - 1) / NW, B);
    if (Kp <= 256)
      mix_softmax_kernel<4><<<sgrid, NT, 0, s>>>(sb, km, v, t, I, Kp, kt,
                                                 km_stride);
    else if (Kp <= 512)
      mix_softmax_kernel<8><<<sgrid, NT, 0, s>>>(sb, km, v, t, I, Kp, kt,
                                                 km_stride);
    else
      mix_softmax_kernel<16><<<sgrid, NT, 0, s>>>(sb, km, v, t, I, Kp, kt,
                                                  km_stride);
    return (int)cudaGetLastError();
  }
  const dim3 grid((I + ROW_R - 1) / ROW_R, 1, B);
#define MC_ROWS_ONE(KP, X1)                                                  \
  {                                                                          \
    auto kern = mix_rows_kernel<KP, X1>;                                     \
    constexpr int smem = RowsTile<KP, X1>::SMEM;                             \
    static_assert(smem <= SMEM_MAX, "rows-pass tiles exceed shared memory");\
    err = allow_smem(kern);                                                  \
    if (err == 0)                                                            \
      kern<<<grid, NT, smem, s>>>(a, c, x, z, bs, km, v, t, I, L, kt, vec,   \
                                  km_stride);                              \
  }
#define MC_ROWS(KP)              \
  if (two) MC_ROWS_ONE(KP, true) \
  else MC_ROWS_ONE(KP, false)
  switch (Kp) {
    case 32: MC_ROWS(32); break;
    case 64: MC_ROWS(64); break;
    case 96: MC_ROWS(96); break;
    case 128: MC_ROWS(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_ROWS
#undef MC_ROWS_ONE
  return err ? err : (int)cudaGetLastError();
}

// The columns pass: part [B, n_seg, 1|2, Kp, L] and vpart [B, n_seg, Kp];
// at 128 < Kp <= 1024 the grid's z axis runs the chains x the chunks of
// k_true's live lanes (wide_chunks).
extern "C" int mc_mix_cols(const void* v, const void* x0, const void* x1,
                           void* part, void* vpart, int B, int I, int L,
                           int Kp, int n_seg, int seg_rows, int k_true,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* vv = (const float*)v;
  const int8_t* x = (const int8_t*)x0;
  const int8_t* z = (const int8_t*)x1;
  float* pt = (float*)part;
  float* vp = (float*)vpart;
  const bool two = x1 != nullptr;
  if (!aligned16(v)) return (int)cudaErrorMisalignedAddress;
  const int vec = L % 16 == 0 && aligned16(x0) && aligned16(x1) &&
                  aligned16(part);
  const int kt = live_lanes(k_true, Kp);
  int err = 0;
  if (kp_wide(Kp)) {
    const int n_ch = wide_chunks(kt);
#define MC_COLS_WIDE(X1)                                                     \
  {                                                                          \
    using T = WideColsTile<X1>;                                              \
    auto kern = mix_cols_wide_kernel<X1>;                                    \
    static_assert(T::SMEM <= SMEM_MAX, "wide columns tiles exceed shared "   \
                                       "memory");                            \
    const dim3 grid((L + T::W::BM - 1) / T::W::BM, n_seg, B * n_ch);         \
    err = allow_smem(kern);                                                  \
    if (err == 0)                                                            \
      kern<<<grid, NT, T::SMEM, s>>>(vv, x, z, pt, vp, I, L, Kp, seg_rows,   \
                                     kt, vec);                               \
  }
    if (two) MC_COLS_WIDE(true) else MC_COLS_WIDE(false)
#undef MC_COLS_WIDE
    return err ? err : (int)cudaGetLastError();
  }
#define MC_COLS_ONE(KP, X1)                                                  \
  {                                                                          \
    using T = ColsTile<KP, X1>;                                              \
    auto kern = mix_cols_kernel<KP, X1>;                                     \
    static_assert(T::SMEM <= SMEM_MAX, "columns tiles exceed shared memory");\
    const dim3 grid((L + T::TC - 1) / T::TC, n_seg, B);                      \
    err = allow_smem(kern);                                                  \
    if (err == 0)                                                            \
      kern<<<grid, NT, T::SMEM, s>>>(vv, x, z, pt, vp, I, L, seg_rows, kt,   \
                                     vec);                                   \
  }
#define MC_COLS(KP)              \
  if (two) MC_COLS_ONE(KP, true) \
  else MC_COLS_ONE(KP, false)
  switch (Kp) {
    case 32: MC_COLS(32); break;
    case 64: MC_COLS(64); break;
    case 96: MC_COLS(96); break;
    case 128: MC_COLS(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_COLS
#undef MC_COLS_ONE
  return err ? err : (int)cudaGetLastError();
}

template <int KP, bool X1, typename Kernel>
static int cols_tile_info(Kernel kern, int* tc, int* blocks) {
  using T = ColsTile<KP, X1>;
  *tc = T::TC;
  const int err = allow_smem(kern);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NT,
                                                            T::SMEM);
}

template <typename T, typename Kernel>
static int wide_cols_tile_info(Kernel kern, int* tc, int* blocks) {
  *tc = T::W::BM;
  const int err = allow_smem(kern);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NT,
                                                            T::SMEM);
}

// The columns pass's tile for Kp and one (two = 0) or two streams: loci a
// block (TC), rows a stage, and the blocks an SM of the current device
// holds (at 128 < Kp <= 1024 the wide kernel's, WideColsTile);
// ops/mixture_bi.cols_tile, cols_stage_rows and cols_blocks_per_sm mirror
// them.
// Returns cudaErrorInvalidValue for a Kp the kernels do not take.
extern "C" int mc_mix_tiles(int Kp, int two, int* tc, int* rows,
                            int* blocks) {
  *rows = COL_RI;
  if (kp_wide(Kp)) {
    *rows = WideColsTile<false>::TK;
    return two ? wide_cols_tile_info<WideColsTile<true>>(
                     mix_cols_wide_kernel<true>, tc, blocks)
               : wide_cols_tile_info<WideColsTile<false>>(
                     mix_cols_wide_kernel<false>, tc, blocks);
  }
#define MC_TILE(KP)                                                      \
  return two ? cols_tile_info<KP, true>(mix_cols_kernel<KP, true>, tc,   \
                                        blocks)                          \
             : cols_tile_info<KP, false>(mix_cols_kernel<KP, false>, tc, \
                                         blocks)
  switch (Kp) {
    case 32: MC_TILE(32);
    case 64: MC_TILE(64);
    case 96: MC_TILE(96);
    case 128: MC_TILE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MC_TILE
}

// The finish, one launch: the eta half where eta is non-null (vtot too
// where vtot is), the p half where out0 is (FinishArgs); the eta half's
// slots a lane by Kp as the admixture's wide finish sizes them
// (wide.cuh): Kp / 32 up to 128, then 8 / 16 / 32 at Kp <= 256 / 512 /
// 1024; without the eta half the KJ = 0 instance, the p half alone.
// Returns cudaErrorInvalidValue for a Kp the kernels do not take or
// arguments that do not go together.
extern "C" int mc_mix_finish(const void* part, const void* vpart,
                             const void* kmask, void* vtot, void* eta,
                             void* out0, void* out1, int B, int Kp, int L,
                             int n_seg, int v_seg, int two, int k_true,
                             float lb, float plb, float pub, float ploidy,
                             int project, int finish, int params,
                             int km_stride, void* stream) {
  const bool eta_on = eta != nullptr, p_on = out0 != nullptr;
  const int kt = k_true > Kp ? Kp : k_true;
  if ((!kp_narrow(Kp) && !kp_wide(Kp)) || B < 1 || (!eta_on && !p_on) ||
      (eta_on && (vpart == nullptr || v_seg < 1)) ||
      (p_on && (part == nullptr || n_seg < 1 || L < 1)) ||
      (p_on && finish && !two && (vpart == nullptr || v_seg < 1)) ||
      (p_on && !finish && two && out1 == nullptr) ||
      (params && (!finish || !eta_on || !p_on || kt < 1)))
    return (int)cudaErrorInvalidValue;
  FinishArgs a;
  a.part = (const float*)part;
  a.vpart = (const float*)vpart;
  a.kmask = (const float*)kmask;
  a.km_stride = km_stride;
  a.vtot = (float*)vtot;
  a.eta = (float*)eta;
  a.out0 = (float*)out0;
  a.out1 = (float*)out1;
  a.Kp = Kp;
  a.L = L;
  a.n_seg = n_seg;
  a.v_seg = v_seg;
  a.two = two;
  a.k_true = kt;
  a.nk = params ? kt : Kp;
  a.nq = (L + 3) / 4;
  a.lb = lb;
  a.plb = plb;
  a.pub = pub;
  a.ploidy = ploidy;
  a.project = project;
  a.finish = finish;
  a.params = params;
  a.vec = L % 4 == 0 && aligned16(part) && aligned16(out0) &&
          aligned16(out1);
  const long long items = p_on ? (long long)a.nk * a.nq : 0;
  const long long blocks = (items + NT - 1) / NT + (eta_on ? 1 : 0);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, B);
  cudaStream_t s = (cudaStream_t)stream;
  const int kj = !eta_on ? 0 : Kp <= 128 ? Kp / 32 : Kp <= 256 ? 8
                 : Kp <= 512 ? 16 : 32;
  switch (kj) {
    case 0: mix_finish_kernel<0><<<grid, NT, 0, s>>>(a); break;
    case 1: mix_finish_kernel<1><<<grid, NT, 0, s>>>(a); break;
    case 2: mix_finish_kernel<2><<<grid, NT, 0, s>>>(a); break;
    case 3: mix_finish_kernel<3><<<grid, NT, 0, s>>>(a); break;
    case 4: mix_finish_kernel<4><<<grid, NT, 0, s>>>(a); break;
    case 8: mix_finish_kernel<8><<<grid, NT, 0, s>>>(a); break;
    case 16: mix_finish_kernel<16><<<grid, NT, 0, s>>>(a); break;
    default: mix_finish_kernel<32><<<grid, NT, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}
