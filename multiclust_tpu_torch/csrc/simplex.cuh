// Warp-level helpers shared by the admixture kernels: sums over a warp or
// an aligned group of lanes, and the Michelot projection onto the
// lower-bounded simplex (michelot_project, simplex.c:109-143; the same
// passes as ops/simplex.project_rows and the TPU's `_michelot_tile`,
// multiclust_tpu/ops/kernels.py:154).
#pragma once

#include <cuda_runtime.h>

namespace mc {

constexpr unsigned FULL = 0xffffffffu;

// sum over an aligned group of G lanes (G a power of two <= 32); every
// lane of the warp must call it
template <int G = 32>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

// Michelot projection of one row held by one warp (lane owns k = lane +
// 32 j) onto {x >= lb on the valid lanes, sum = 1}; the other lanes end
// at 0.  `valid` is the true-lane set: static (k < k_true) or read from a
// runtime mask, as the TPU's `_michelot_tile` takes either.  The free
// lanes are counted a lane at a time and reduced once a pass (one
// __reduce_add_sync, not a ballot a slot): whole numbers, equal to a warp
// sum of them, so a pass needs one warp sum (of w) where the passes are
// latency; a pass pinned a lane exactly when the count fell.
template <int KJ>
__device__ void michelot_warp_mask(float (&w)[KJ], const bool (&valid)[KJ],
                                   float lb) {
  bool fr[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    fr[j] = valid[j];
    if (!fr[j]) w[j] = 0.f;
  }
  auto free_lanes = [&]() {
    int n = 0;
#pragma unroll
    for (int j = 0; j < KJ; ++j) n += fr[j] ? 1 : 0;
    return __reduce_add_sync(FULL, n);
  };
  int nf = free_lanes();
  while (true) {
    float cs = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) cs += w[j];
    cs = warp_sum(cs);
    const float off = (cs - 1.f) / fmaxf((float)nf, 1.f);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      if (fr[j]) {
        const float w2 = w[j] - off;
        if (w2 < lb) {
          w[j] = lb;
          fr[j] = false;
        } else {
          w[j] = w2;
        }
      }
    }
    const int left = free_lanes();
    const bool any_pinned = left < nf;
    nf = left;
    if (!any_pinned || nf == 0) break;
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    if (!valid[j]) w[j] = 0.f;
}

// the same with the static lane set k < k_true
template <int KJ>
__device__ void michelot_warp(float (&w)[KJ], int lane, int k_true,
                              float lb) {
  bool valid[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) valid[j] = lane + 32 * j < k_true;
  michelot_warp_mask<KJ>(w, valid, lb);
}

// Michelot projection of rows held by aligned groups of G lanes (lane g
// of a group owns slots g + G j); bit j of `fr` marks slot j free (valid)
// on entry, the others must hold 0.  Groups finish at different passes,
// so the loop runs until every group of the warp is done and a finished
// group's passes change nothing.  Every lane of the warp must call it.
template <int G, int MJ>
__device__ __forceinline__ void michelot_group(float (&w)[MJ], unsigned fr,
                                               float lb) {
  static_assert(MJ <= 32, "one bit of fr a slot");
  bool done = false;
  while (true) {
    float nf = 0.f, cs = 0.f;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      nf += (fr >> j & 1u) ? 1.f : 0.f;
      cs += w[j];
    }
    nf = group_sum<G>(nf);
    cs = group_sum<G>(cs);
    const float off = (cs - 1.f) / fmaxf(nf, 1.f);
    float pinned = 0.f, nf2 = 0.f;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      if (!done && (fr >> j & 1u)) {
        const float w2 = w[j] - off;
        if (w2 < lb) {
          w[j] = lb;
          fr &= ~(1u << j);
          pinned = 1.f;
        } else {
          w[j] = w2;
        }
      }
      nf2 += (fr >> j & 1u) ? 1.f : 0.f;
    }
    pinned = group_sum<G>(pinned);
    nf2 = group_sum<G>(nf2);
    done = done || pinned < 0.5f || nf2 < 0.5f;
    if (__all_sync(FULL, done)) break;
  }
}

}  // namespace mc
