// The float64 tensor-core product (DMMA, `mma.sync` m16n8k16) and the lane
// chunks of the wide passes, shared by the mixture's wide passes
// (csrc/mixture_bi.cu) and the admixture's wide passes (csrc/wide.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

// cluster lanes a chunk of a wide pass, at most: the live lane tiles of 8
// (ceil(k / 8)) are cut into chunks of at most CHUNK_LANES / 8 tiles that
// differ by at most one tile (K = 200: 104 + 96 lanes, not 128 + 72)
constexpr int CHUNK_LANES = 128;

// c += a b on one 16 x 8 tile in float64 with a contraction of 16 slots
// (mma.sync m16n8k16; m16n8k8 and m16n8k4 timed the same within 7 %):
// with g = lane / 4 and t = lane % 4, a[i] is A[g + 8 (i % 2)][slot i / 2],
// b[p] is B[slot p][g] and c[j] is C[g + 8 (j / 2)][2 t + j % 2].  The four
// slots p of thread t are four of the 16 contracted indices, the caller's
// to choose, the same in a and b.
__device__ __forceinline__ void dmma16(double (&c)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// the warp's live lane tiles: j < NTW with wc + WN j < nt_live
template <int NTW, int WN>
__device__ __forceinline__ int live_tiles(int nt_live, int wc) {
  return max(0, min(NTW, (nt_live - wc + WN - 1) / WN));
}

// The live lane tiles (nt = ceil(kt / 8)) cut into chunks of at most
// LANES / 8 tiles that differ by at most one tile: their count, and the
// first tile and tile count of chunk c.  LANES: CHUNK_LANES, or the wider
// chunks of the admixture's wide rows pass (csrc/wide.cuh, WA_LANES).
template <int LANES = CHUNK_LANES>
__host__ __device__ __forceinline__ int wide_chunks(int kt) {
  return ((kt + 7) / 8 + LANES / 8 - 1) / (LANES / 8);
}
template <int LANES = CHUNK_LANES>
__device__ __forceinline__ void chunk_tiles(int c, int kt, int* t0,
                                            int* n) {
  const int nt = (kt + 7) / 8, n_ch = wide_chunks<LANES>(kt);
  const int q = nt / n_ch, r = nt % n_ch;
  *t0 = c * q + min(c, r);
  *n = q + (c < r ? 1 : 0);
}

template <int N>
struct Count {
  static constexpr int value = N;
};

// f(Count<nj>()) for a runtime nj in [0, N]
template <int N, typename F>
__device__ __forceinline__ void with_count(int nj, F&& f) {
  if constexpr (N == 0) {
    f(Count<0>());
  } else {
    if (nj == N)
      f(Count<N>());
    else
      with_count<N - 1>(nj, f);
  }
}

}  // namespace
