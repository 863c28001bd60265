// Register tiles, cp.async rings and the rows-pass loop shared by the
// admixture kernels of csrc/fullstep_bi.cu (biallelic) and csrc/fullstep.cu
// (generic, multi-allelic).  What the tiles are for is in the header of
// csrc/fullstep_bi.cu; in short: every product runs on small per-thread
// output tiles read from shared memory as float4, the lanes of a warp split
// as GL cluster lanes x CW lanes of the other axis, the cluster loops stop
// at the lane tile of k_true, and the streamed operand arrives by cp.async
// into a ring of two buffers, one barrier a tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "simplex.cuh"
#include "smem.cuh"

namespace {

constexpr int NT = 256;       // threads per block, every kernel
constexpr int NW = NT / 32;   // warps per block
constexpr int ROW_AR = 4;     // rows per thread, A phase of the rows pass
constexpr int ROW_TL = 32;    // columns per rows-pass tile
constexpr int ROW_CW_MAX = 8; // at most 4 x 8 rows a warp
constexpr int COL_CT = 4;     // columns per thread, columns pass
constexpr int COL_DR = 4;     // rows per thread, d phase of the columns pass
// 4-column steps of the rows pass's A-phase loop unrolled together
// (measured: 8 beats 2 and 4)
constexpr int A_UNROLL = 8;
constexpr float DMIN = 1e-30f;

using mc::warp_sum;

// How the lanes of a warp and the registers of a thread split the cluster
// axis for k_true clusters: kc lanes are computed (a multiple of 4, >=
// k_true, <= Kp), in jt groups of four a thread on gl cluster lanes; cw
// lanes are left for the other axis.  ops/fullstep_bi.lane_tile mirrors it.
struct LaneTile {
  int kc, jt, gl, cw;
};

inline LaneTile lane_tile(int k_true, int Kp, int cw_max) {
  const int k = k_true < 1 || k_true > Kp ? Kp : k_true;
  const int g = (k + 3) / 4;
  LaneTile t;
  t.jt = (g + 7) / 8;
  t.gl = (g + t.jt - 1) / t.jt;
  t.cw = 32 / t.gl < cw_max ? 32 / t.gl : cw_max;
  t.kc = 4 * t.gl * t.jt;
  return t;
}

// four int8 of a row starting at `off`, of which the first n are wanted
// (n <= 0: none); one 4-byte load where the address is aligned
__device__ __forceinline__ uint32_t load_x4(const int8_t* __restrict__ x,
                                            size_t off, int n, int vec) {
  if (n <= 0) return 0u;
  if (vec && n >= 4) return *reinterpret_cast<const uint32_t*>(x + off);
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) v |= (uint32_t)(uint8_t)x[off + q] << (8 * q);
  return v;
}

__device__ __forceinline__ float x_byte(uint32_t v, int q) {
  return (float)(int8_t)(v >> (8 * q));
}

__device__ __forceinline__ float f4_get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[q] += sum over the four k of e.k * pv[k].q: one row of a d tile
__device__ __forceinline__ void d_row(float (&acc)[4], const float4& e,
                                      const float4 (&pv)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[q] = fmaf(e.x, f4_get(pv[0], q), acc[q]);
    acc[q] = fmaf(e.y, f4_get(pv[1], q), acc[q]);
    acc[q] = fmaf(e.z, f4_get(pv[2], q), acc[q]);
    acc[q] = fmaf(e.w, f4_get(pv[3], q), acc[q]);
  }
}

// ---------------------------------------------------------------------------
// rows pass

// the cells of a rows pass (rows_accumulate)
enum class Cells { kBi, kDense, kSparse };

// Shared memory of a rows-pass block, in floats: eta_s [R][KP + 4], p_s
// [2][KC][ROW_TL + 4], w_s [NW][RW][ROW_TL + 4], t_s [R], r_s [R], and
// for the fused kernel a_s [R][KP + 1]; R = NW RW rows, RW = 4 CW.
constexpr int ROW_PS = ROW_TL + 4;

__host__ __device__ inline int rows_smem_floats(int KP, const LaneTile& lt,
                                                int fused) {
  const int R = NW * ROW_AR * lt.cw;
  return R * (KP + 4) + 2 * lt.kc * ROW_PS + R * ROW_PS + 2 * R +
         (fused ? R * (KP + 1) : 0);
}

// the p tile of the columns [l0, l0 + ROW_TL) below c_hi into p_s
// [KC][ROW_PS], zeros past c_hi: 16-byte asynchronous copies where rows
// are aligned, plain loads otherwise
__device__ __forceinline__ void rows_issue_p(float* p_s,
                                             const float* __restrict__ p_b,
                                             int L, int l0, int c_hi, int KC,
                                             int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int e = tid; e < KC * (ROW_TL / 4); e += NT) {
      const int k = e / (ROW_TL / 4), c4 = 4 * (e % (ROW_TL / 4));
      const int n = min(4, c_hi - (l0 + c4));
      const float* src = p_b + (size_t)k * L + (n > 0 ? l0 + c4 : 0);
      cp_async16(p_s + k * ROW_PS + c4, src, n > 0 ? 4 * n : 0);
    }
  } else {
    for (int e = tid; e < KC * ROW_TL; e += NT) {
      const int k = e / ROW_TL, cc = e % ROW_TL, col = l0 + cc;
      p_s[k * ROW_PS + cc] = col < c_hi ? p_b[(size_t)k * L + col] : 0.f;
    }
  }
  cp_async_commit();
}

// The rows passes' loop over the columns [c_lo, c_hi) of arrays with row
// stride L, for the block's rows [row0, row0 + R).  Warp w owns the rows
// rw0 = w RW ...; in the d phase lane = (ar = lane / 8 row lane, cl = lane
// % 8 column lane) and a thread computes rows ar + 4 i (i < CW) x columns
// 4 cl .. 4 cl + 3; in the A phase lane = (a cluster lane, c row lane) and
// a thread owns rows c + CW i (i < 4) x clusters a + GL (4 j + q).  Leaves
// w @ p^T in acc and each row's t in t_s; with compute_a == 0 only t is
// wanted and the A phase is skipped.
//
// C = kBi: the biallelic cells, d0 = eta @ p0 and d1 = rowsum(eta) - d0
// over the planes x0, x1 (both clamped to DMIN), w = w0 - w1, t = x0 log
// d0 + x1 log d1, and each row's sum of w1 in r_s.  Otherwise the generic
// cells over the one plane x0 (x1 unused): d = eta @ p, w = x / d and t =
// x log d where x > 0, a zero d counting as 1; r_s holds 0.  kSparse
// computes the reciprocal and the log only on the lanes with x > 0 (a
// loop over a thread's set lanes), kDense on all four a thread.
template <int KP, Cells C>
__device__ __forceinline__ void rows_accumulate(
    float* smem, const float* __restrict__ eta_b,
    const float* __restrict__ p_b, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ x1, int row0, int I, int L, int c_lo,
    int c_hi, int compute_t, int compute_a, const LaneTile& lt, int vec,
    float (&acc)[KP / 32][4][ROW_AR]) {
  constexpr int JTM = KP / 32, ES = KP + 4;
  const int KC = lt.kc, JT = lt.jt, GL = lt.gl, CW = lt.cw;
  const int RW = ROW_AR * CW, R = NW * RW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* eta_s = smem;
  float* p_s = eta_s + R * ES;
  float* w_w = p_s + 2 * KC * ROW_PS + warp * RW * ROW_PS;
  float* t_s = p_s + 2 * KC * ROW_PS + R * ROW_PS;
  float* r_s = t_s + R;
  const int rw0 = warp * RW;
  const int ar = lane >> 3, cl = lane & 7;
  int a = lane / CW, c = lane % CW;
  if (a >= GL) a = 0, c = 0;   // spare lanes repeat lane 0's work

#pragma unroll
  for (int j = 0; j < JTM; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < ROW_AR; ++i) acc[j][q][i] = 0.f;

  // the block's eta rows, all Kp lanes (the fused finish reads them)
  for (int e = tid; e < R * (KP / 4); e += NT) {
    const int r = e / (KP / 4), k4 = 4 * (e % (KP / 4)), row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < I) v = ld4(eta_b + (size_t)row * KP + k4);
    *reinterpret_cast<float4*>(eta_s + r * ES + k4) = v;
  }
  rows_issue_p(p_s, p_b, L, c_lo, c_hi, KC, vec);

  // x of the thread's cells, one tile ahead
  uint32_t xa[ROW_CW_MAX], xb[ROW_CW_MAX];
  auto load_x = [&](int l0) {
    const int col = l0 + 4 * cl;
#pragma unroll
    for (int i = 0; i < ROW_CW_MAX; ++i) {
      const int row = row0 + rw0 + ar + 4 * i;
      const int n = (i < CW && row < I) ? c_hi - col : 0;
      const size_t off = (size_t)row * L + col;
      xa[i] = load_x4(x0, off, n, vec);
      if constexpr (C == Cells::kBi) xb[i] = load_x4(x1, off, n, vec);
    }
  };
  load_x(c_lo);
  cp_async_wait_all();
  __syncthreads();

  // rowsum(eta) of the warp's rows, kept in r_s until the loop is over
  if constexpr (C == Cells::kBi) {
    for (int r = lane; r < RW; r += 32) {
      float s = 0.f;
      for (int k4 = 0; k4 < KC; k4 += 4) {
        const float4 v = ld4(eta_s + (rw0 + r) * ES + k4);
        s += (v.x + v.y) + (v.z + v.w);
      }
      r_s[rw0 + r] = s;
    }
    __syncwarp();
  }
  float tacc[ROW_CW_MAX], racc[ROW_CW_MAX];
#pragma unroll
  for (int i = 0; i < ROW_CW_MAX; ++i) {
    tacc[i] = 0.f;
    racc[i] = 0.f;
  }

  int buf = 0;
  for (int l0 = c_lo; l0 < c_hi; l0 += ROW_TL, buf ^= 1) {
    const float* pt = p_s + buf * KC * ROW_PS;
    if (l0 + ROW_TL < c_hi)
      rows_issue_p(p_s + (buf ^ 1) * KC * ROW_PS, p_b, L, l0 + ROW_TL, c_hi,
                   KC, vec);
    // d phase
    float d0[ROW_CW_MAX][4];
#pragma unroll
    for (int i = 0; i < ROW_CW_MAX; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) d0[i][q] = 0.f;
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pv[q] = ld4(pt + (k4 + q) * ROW_PS + 4 * cl);
#pragma unroll
      for (int i = 0; i < ROW_CW_MAX; ++i)
        if (i < CW)
          d_row(d0[i], ld4(eta_s + (rw0 + ar + 4 * i) * ES + k4), pv);
    }
    // the cells' divisions and logs
#pragma unroll
    for (int i = 0; i < ROW_CW_MAX; ++i) {
      if (i < CW) {
        float wv[4], tt = 0.f, rr = 0.f;
        if constexpr (C == Cells::kBi) {
          const float srow = r_s[rw0 + ar + 4 * i];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float a0 = x_byte(xa[i], q), a1 = x_byte(xb[i], q);
            const float dd0 = fmaxf(d0[i][q], DMIN);
            const float dd1 = fmaxf(srow - d0[i][q], DMIN);
            const float w0 = a0 * __frcp_rn(dd0), w1 = a1 * __frcp_rn(dd1);
            if (compute_t) tt += a0 * logf(dd0) + a1 * logf(dd1);
            rr += w1;
            wv[q] = w0 - w1;
          }
        } else if constexpr (C == Cells::kSparse) {
          // only the lanes with x > 0, in lane order as in the dense loop
          // (the same bits): at M a multiple of 4 a thread's four lanes
          // are one locus, so at most ploidy of them are set
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = 0.f;
          uint32_t left = __vcmpne4(xa[i], 0u);
          while (left != 0u) {
            const int q = (__ffs(left) - 1) >> 3;
            left &= ~(0xffu << (8 * q));
            const float xv = x_byte(xa[i], q);
            const float dq = q == 0 ? d0[i][0] : q == 1 ? d0[i][1]
                           : q == 2 ? d0[i][2] : d0[i][3];
            const float sd = dq > 0.f ? dq : 1.f;
            const float w = xv * __frcp_rn(sd);
#pragma unroll
            for (int r = 0; r < 4; ++r) wv[r] = r == q ? w : wv[r];
            if (compute_t) tt += xv * logf(sd);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xv = x_byte(xa[i], q);
            const float sd = d0[i][q] > 0.f ? d0[i][q] : 1.f;
            wv[q] = xv * __frcp_rn(sd);   // 0 where x = 0
            if (compute_t && xv > 0.f) tt += xv * logf(sd);
          }
        }
        tacc[i] += tt;
        racc[i] += rr;
        if (compute_a)
          *reinterpret_cast<float4*>(w_w + (ar + 4 * i) * ROW_PS + 4 * cl) =
              make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
    if (l0 + ROW_TL < c_hi) load_x(l0 + ROW_TL);
    if (compute_a) {  // uniform across the block
      __syncwarp();
      // A phase: the contracted column index in the vector
#pragma unroll A_UNROLL
      for (int l4 = 0; l4 < ROW_TL; l4 += 4) {
        float4 wr[ROW_AR];
#pragma unroll
        for (int i = 0; i < ROW_AR; ++i)
          wr[i] = ld4(w_w + (c + CW * i) * ROW_PS + l4);
#pragma unroll
        for (int j = 0; j < JTM; ++j) {
          if (j == 0 || j < JT) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 pk = ld4(pt + (a + GL * (4 * j + q)) * ROW_PS + l4);
#pragma unroll
              for (int i = 0; i < ROW_AR; ++i) {
                float v = acc[j][q][i];
                v = fmaf(wr[i].x, pk.x, v);
                v = fmaf(wr[i].y, pk.y, v);
                v = fmaf(wr[i].z, pk.z, v);
                v = fmaf(wr[i].w, pk.w, v);
                acc[j][q][i] = v;
              }
            }
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // each row's t and sum of w1: over the 8 column lanes, in a fixed order
  __syncwarp();   // the row sums in r_s have been read
#pragma unroll
  for (int i = 0; i < ROW_CW_MAX; ++i) {
    float tt = tacc[i], rr = racc[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      tt += __shfl_xor_sync(mc::FULL, tt, o);
      if constexpr (C == Cells::kBi) rr += __shfl_xor_sync(mc::FULL, rr, o);
    }
    if (i < CW && cl == 0) {
      t_s[rw0 + ar + 4 * i] = tt;
      r_s[rw0 + ar + 4 * i] = rr;
    }
  }
  __syncwarp();
}

// Finish of a segmented rows pass: the segments' partials summed in
// segment order on top of the a0 seed (A in float32, t in float64), then
// either the raw A (emit_a: c is not added, the caller finishes) or eta' =
// Michelot(normalize(eta (A + c))) over the static lanes k < k_true or the
// runtime kmask, chain b's row at kmask + b km_stride (km_stride 0: one
// [Kp] mask for every chain; Kp: a [B, Kp] mask, a mixed-K lattice's
// chains each with its own lanes).  It replaces the last column step of the TPU's streamed
// pass A (`_bi_istats_kernel`, multiclust_tpu/ops/kernels.py:887).
//
// Bound by device memory and by the latency of a row's finish (its warp
// sums and Michelot passes are chains of shuffles), so it wants many rows
// in flight at once and few registers.  One warp a row, lane = cluster;
// the row's partials arrive as units of `sc` segments (only the
// kc live lanes of each, and under emit_a the first pad lane, whose value
// every pad lane of the producer carries: the row's sum of w1 in the
// biallelic pass, 0 in the generic one), their t partials and, in the
// first unit, the row's eta, a0 and c, by 16-byte cp.async copies into
// the warp's ring of FIN_DEPTH slots in shared memory: every load of a
// row's first units is in flight at once, and no warp waits for another.
// The sums keep segment order and each row's finish the arithmetic and
// lane layout of a one-warp-a-row finish (the Michelot counts its free
// lanes by ballot: whole numbers, the same bits), so the raw A and t are
// the ordered sums of the partials.  Four rows a warp, their finishes
// interleaved or not, measured slower on an H100 (PERF.md): the
// registers they hold cut the warps an SM keeps.  Loading the partials
// straight into registers was faster at Kp = 32 on 16384 x 2048, where
// the rows pass's partials still sit in L2, and slower at Kp = 64-128
// and at 8192 x 131072 (PERF.md).  c, a0 and kmask may be null.  Pad
// lanes of eta must be zero: they are not read, and eta' there is
// written 0.
struct FinishTile {
  // live lanes, staged lanes a partial, segments a unit; a unit's layout
  // in floats (eta, a0, c, A partials, t partials) and size; ring slots;
  // the block's shared memory in bytes
  int kc, kcl, sc, eta_off, a0_off, c_off, a_off, t_off, unit, slots,
      smem_bytes;
};

constexpr int FIN_DEPTH = 3;            // units of a warp's ring
constexpr int FIN_UNIT_BYTES = 1024;    // A partials a unit holds at least

// every part of a unit at a multiple of 4 floats (16-byte copies): kc
// and kcl are multiples of 4, Kp of 32
inline FinishTile finish_tile(int k_true, int Kp, int n_seg, int emit_a,
                              int compute_t, int has_a0) {
  FinishTile f;
  f.kc = lane_tile(k_true, Kp, 32).kc;
  f.kcl = emit_a && f.kc < Kp ? f.kc + 4 : f.kc;
  if (n_seg < 1) n_seg = 1;
  f.sc = (FIN_UNIT_BYTES + 4 * f.kcl - 1) / (4 * f.kcl);
  if (f.sc > n_seg) f.sc = n_seg;
  int off = 0;
  f.eta_off = off;
  off += emit_a ? 0 : f.kc;
  f.a0_off = off;
  off += has_a0 ? Kp : 0;
  f.c_off = off;
  off += 4;
  f.a_off = off;
  off += f.sc * f.kcl;
  f.t_off = off;
  off += compute_t ? f.sc : 0;
  f.unit = (off + 3) / 4 * 4;
  const int chunks = (n_seg + f.sc - 1) / f.sc;
  f.slots = chunks < FIN_DEPTH ? chunks : FIN_DEPTH;
  f.smem_bytes = 4 * NW * f.slots * f.unit;
  return f;
}

// blocks an SM the finish asks room for: the more warps (rows) an SM
// holds, the more of the rows' load and Michelot latency overlaps; the
// counts are the most that build without spills at each Kp
__host__ __device__ constexpr int fin_blocks(int KP) {
  return KP <= 32 ? 6 : 4;
}

template <int KP>
__global__ void __launch_bounds__(NT, fin_blocks(KP)) rows_finish_kernel(
    const float* __restrict__ eta, const float* __restrict__ apart,
    const float* __restrict__ tpart, const float* __restrict__ a0,
    const float* __restrict__ c, const float* __restrict__ kmask,
    float* __restrict__ out, double* __restrict__ t_out, int I, int n_seg,
    int k_true, float lb, int emit_a, int project_eta, int compute_t,
    int km_stride, FinishTile ft) {
  constexpr int KJ = KP / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * NW + warp;
  if (row >= I) return;   // warps share nothing
  const size_t br = (size_t)blockIdx.y * I + row;
  float* ring = reinterpret_cast<float*>(dyn_smem4) + warp * ft.slots * ft.unit;
  const int kc = ft.kc, kcl = ft.kcl, sc = ft.sc;
  const int n_chunk = (n_seg + sc - 1) / sc;
  // the row's partials of segment s: A at ap + s I KP, t at tp + s I
  const float* ap = apart + ((size_t)blockIdx.y * n_seg * I + row) * KP;
  const float* tp = tpart + (size_t)blockIdx.y * n_seg * I + row;
  // a lane copies lanes k4 .. k4 + 3 of the segments s_in, s_in + spl, ..
  const int k4n = kcl / 4, spl = 32 / k4n, s_in = lane / k4n;
  const int k4 = 4 * (lane - s_in * k4n);

  // chunk q of the row's segments (and on q = 0 its eta, a0, c) into
  // its slot
  auto issue = [&](int q) {
    if (q < n_chunk) {
      float* d = ring + (q % FIN_DEPTH) * ft.unit;
      const int s0 = sc * q, ns = min(sc, n_seg - s0);
      if (s_in < spl)
        for (int s = s_in; s < ns; s += spl)
          cp_async16(d + ft.a_off + s * kcl + k4,
                     ap + (size_t)(s0 + s) * I * KP + k4, 16);
      if (compute_t)
        for (int s = lane; s < ns; s += 32)
          cp_async4(d + ft.t_off + s, tp + (size_t)(s0 + s) * I, 4);
      if (q == 0) {
        if (!emit_a && 4 * lane < kc)
          cp_async16(d + ft.eta_off + 4 * lane, eta + br * KP + 4 * lane, 16);
        if (a0 != nullptr && 4 * lane < KP)
          cp_async16(d + ft.a0_off + 4 * lane, a0 + br * KP + 4 * lane, 16);
        if (c != nullptr && lane == 0) cp_async4(d + ft.c_off, c + row, 4);
      }
    }
    cp_async_commit();
  };

  // the staged lane each lane adds: its own below kc, the first pad lane
  // above it where that is staged (emit_a), none otherwise
  int kcol[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = lane + 32 * j;
    kcol[j] = k < kc ? k : kcl > kc ? kc : -1;
  }
  float a[KJ] = {}, e[KJ] = {}, ci = 0.f;
  double tt = 0.0;
#pragma unroll
  for (int q = 0; q < FIN_DEPTH - 1; ++q) issue(q);
  for (int q = 0; q < n_chunk; ++q) {
    __syncwarp();   // every lane is done with the slot refilled here
    issue(q + FIN_DEPTH - 1);
    cp_async_wait<FIN_DEPTH - 1>();
    __syncwarp();   // the chunk's copies, made by all lanes, seen by all
    const float* d = ring + (q % FIN_DEPTH) * ft.unit;
    if (q == 0) {   // the row's seed, eta and c
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = lane + 32 * j;
        a[j] = a0 != nullptr && kcol[j] >= 0 ? d[ft.a0_off + k] : 0.f;
        e[j] = !emit_a && k < kc ? d[ft.eta_off + k] : 0.f;
      }
      if (c != nullptr) ci = d[ft.c_off];
    }
    const int ns = min(sc, n_seg - sc * q);
    for (int s = 0; s < ns; ++s) {
      const float* ar = d + ft.a_off + s * kcl;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (kcol[j] >= 0) a[j] += ar[kcol[j]];
    }
    if (compute_t && lane == 0)
      for (int s = 0; s < ns; ++s) tt += (double)d[ft.t_off + s];
  }
  if (lane == 0) t_out[br] = tt;
  float* o = out + br * KP;
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
      const float* km =
          kmask != nullptr ? kmask + (size_t)blockIdx.y * km_stride : nullptr;
      unsigned valid = 0u;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int k = lane + 32 * j;
        if (km != nullptr ? km[k] > 0.5f : k < k_true) valid |= 1u << j;
      }
      mc::michelot_warp_mask<KJ>(a, valid, lb);
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) o[lane + 32 * j] = a[j];
}

// Only t (no A partials): one row a thread, each streaming its n_seg
// partials through its own cp.async ring of FIN_T_DEPTH in shared memory
// (consecutive threads, consecutive rows: whole 128-byte lines a warp)
// and adding them in segment order in float64.
constexpr int FIN_T_NT = 64;      // rows (threads) of a t-only block
constexpr int FIN_T_DEPTH = 16;   // segments of a thread's ring

__global__ void __launch_bounds__(FIN_T_NT) rows_finish_t_kernel(
    const float* __restrict__ tpart, double* __restrict__ t_out, int I,
    int n_seg, int compute_t) {
  float* ring = reinterpret_cast<float*>(dyn_smem4);  // [slot][FIN_T_NT]
  const int tid = threadIdx.x, b = blockIdx.y;
  const int row = blockIdx.x * FIN_T_NT + tid;
  if (row >= I) return;
  double tt = 0.0;
  if (compute_t) {
    const float* src = tpart + (size_t)b * n_seg * I + row;
    auto issue = [&](int s) {
      if (s < n_seg)
        cp_async4(ring + (s % FIN_T_DEPTH) * FIN_T_NT + tid,
                  src + (size_t)s * I, 4);
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < FIN_T_DEPTH - 1; ++s) issue(s);
    for (int s = 0; s < n_seg; ++s) {
      // the slot refilled here was read a step before: that read stays
      // ahead of the copy
      asm volatile("" ::: "memory");
      issue(s + FIN_T_DEPTH - 1);
      cp_async_wait<FIN_T_DEPTH - 1>();
      tt += (double)ring[(s % FIN_T_DEPTH) * FIN_T_NT + tid];
    }
  }
  t_out[(size_t)b * I + row] = tt;
}

// launches the finish over B chains of I rows (Kp checked by the caller);
// `out` null: only t; returns the launch's cudaError_t
inline int launch_rows_finish(const void* eta, const void* apart,
                              const void* tpart, const void* a0,
                              const void* c, const void* kmask, void* out,
                              void* t_out, int B, int I, int Kp, int n_seg,
                              int k_true, float lb, int emit_a,
                              int project_eta, int compute_t, int km_stride,
                              cudaStream_t s) {
  if (out == nullptr) {
    const int slots = n_seg < FIN_T_DEPTH ? n_seg : FIN_T_DEPTH;
    rows_finish_t_kernel<<<dim3((I + FIN_T_NT - 1) / FIN_T_NT, B), FIN_T_NT,
                           4 * FIN_T_NT * slots, s>>>(
        (const float*)tpart, (double*)t_out, I, n_seg, compute_t);
    return (int)cudaGetLastError();
  }
  // the 16-byte copies of apart, eta and a0
  if (((uintptr_t)apart | (uintptr_t)eta | (uintptr_t)a0) & 15)
    return (int)cudaErrorMisalignedAddress;
  const FinishTile ft =
      finish_tile(k_true, Kp, n_seg, emit_a, compute_t, a0 != nullptr);
  if (ft.smem_bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + NW - 1) / NW, B);
  int err = 0;
#define MC_FINISH(KP)                                                     \
  if (ft.smem_bytes > 48 * 1024) err = allow_smem(rows_finish_kernel<KP>); \
  if (err == 0)                                                           \
  rows_finish_kernel<KP><<<grid, NT, ft.smem_bytes, s>>>                  \
  ((const float*)eta, (const float*)apart, (const float*)tpart,           \
   (const float*)a0, (const float*)c, (const float*)kmask, (float*)out,   \
   (double*)t_out, I, n_seg, k_true, lb, emit_a, project_eta, compute_t,  \
   km_stride, ft)
  switch (Kp) {
    case 32: MC_FINISH(32); break;
    case 64: MC_FINISH(64); break;
    case 96: MC_FINISH(96); break;
    default: MC_FINISH(128); break;
  }
#undef MC_FINISH
  return err != 0 ? err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// columns pass

// the KC lanes of the eta rows [r0, r0 + RI) below r_hi into eta_s
// [RI][KP + 4] by 16-byte asynchronous copies, zeros past r_hi
template <int KP>
__device__ __forceinline__ void cols_issue_eta(float* eta_s,
                                               const float* __restrict__ eta_b,
                                               int r0, int r_hi, int RI,
                                               int KC) {
  const int n4 = KC / 4;
  for (int e = threadIdx.x; e < RI * n4; e += NT) {
    const int r = e / n4, k4 = 4 * (e % n4), row = r0 + r;
    const bool ok = row < r_hi;
    cp_async16(eta_s + r * (KP + 4) + k4,
               eta_b + (size_t)(ok ? row : r0) * KP + k4, ok ? 16 : 0);
  }
  cp_async_commit();
}

// The tiles the admixture passes take for k_true clusters: kc computed
// lanes, rows a rows-pass block, columns (lanes) a columns-pass block,
// rows a columns-pass tile.  mc_fullstep_bi_tiles (csrc/fullstep_bi.cu)
// reports it, and ops/fullstep_bi.lane_tile, rows_block and cols_tile are
// held to it by the card's tests.
inline void pass_tiles(int k_true, int Kp, int* kc, int* row_block,
                       int* col_block, int* col_tile_rows) {
  const LaneTile r = lane_tile(k_true, Kp, ROW_CW_MAX);
  const LaneTile c = lane_tile(k_true, Kp, 32);
  *kc = c.kc;
  *row_block = NW * ROW_AR * r.cw;
  *col_block = NW * COL_CT * c.cw;
  *col_tile_rows = COL_DR * c.gl;
}

// the padded cluster counts of the kernels above (Kp <= 128); wide.cuh
// has the wide test, 128 < Kp <= 1024
inline bool kp_ok(int Kp) {
  return Kp == 32 || Kp == 64 || Kp == 96 || Kp == 128;
}

}  // namespace
