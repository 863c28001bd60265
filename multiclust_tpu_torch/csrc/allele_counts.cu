// Exact counts of an admixture start's allele partition for Hopper
// (sm_90a): the counting of init/random.allele_partition_counts.
//
// Replaces no Pallas kernel.  The JAX package counts a start's labelled
// copies with XLA one-hot sums (multiclust_tpu/init/random.py:148-158);
// the port's plain version (allele_partition_counts_reference) with a
// scatter_add_ of ones into copies [I, K + 1] and a bincount over int64 bin
// indices into pc [K + 1, L, M + 1].  On the card the scatter piled every
// copy's atomic add of a row onto its K + 1 addresses, and the bin indices
// took four int64 passes over the window and two host reads a bincount.
//
// Over the window's copies (i, l, a), code c = codes[i, l, a] and label
// k = labels[i, l, a]:
//
//   copies[i, k] += 1,  pc[k, l, c] += 1   where 0 <= c < M, 0 <= k < K
//
// Missing copies (c < 0) are skipped, so the caller may hand over the raw
// draw of a copy's label.  The counts are integers (int32), so the result
// does not depend on the order of the adds.
//
// A biallelic panel's window is counted from its count planes instead
// (allele_counts_planes_kernel, mc_allele_counts_planes): no code tensor
// exists, and each copy's code is derived in registers from the allele-0
// and missing planes (int8 [I, L], read in place at the panel's row
// stride from the window's first locus) as codes_from_counts would give
// it: copy a of genotype (i, l) is slot 0 where a < x0, slot 1 where
// a < P - miss, and missing after.  The same counts for the same labels.
//
// Bound: bytes.  Each copy's label (int64, 8 B) and code (int8, 1 B; int16
// above 127 slots) is read once, 9 B a copy over 3.35 TB/s; from the
// planes, 8 B a copy and 2 B a genotype.  The outputs (I K + K L M ints)
// are small beside them.  No host read.
//
// Design.  A block of CT threads takes a tile of C loci (C P contiguous
// copies a row) and a range of rows.  Its threads read labels and codes
// (or the planes' bytes of a copy's genotype) along the contiguous L x P
// axis of each row (rows at the strides given, so a column slice of the
// panel's codes or of a wider draw is read in place) and count in shared
// memory, a shared atomic a copy into each:
// pc of the tile's loci over all the range's rows, and copies of a chunk
// of RC rows.  The 32 copies of a warp lie in one row at different loci
// or allele copies, so their pc adds rarely meet on one address; their
// copies adds meet on at most K addresses, which the shared memory
// serializes (32 ways at K = 1).  Each histogram goes to device memory
// once, with int32 atomics that skip zeros: copies after each chunk
// (another tile along L adds to the same rows), pc at the end (another
// row range adds to the same loci).  There are no device atomics a copy,
// and none on a handful of addresses.
//
// The tile is sized from K x M: C loci where K (C M + RC) ints fit
// COUNT_SMEM with C P >= 2 K copies a row, so that flushing a chunk's
// copies scans at most half a bin a copy.  Where no C does (wide K, many
// slots), the clusters are split into slabs of Kt, a block each, adjacent
// in the grid: the slabs of one tile run together, so the tile's bytes
// come from device memory once and from L2 for the other slabs.  Row
// ranges are as many as fill the card in one wave (the occupancy of the
// compiled kernel).  One algorithm at every K and M; only the tile's
// parameters change.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int CT = 256;                    // threads a block
constexpr int CQ = 4;                      // copies a thread a row, at most
constexpr int CP_MAX = CQ * CT;            // copies a row of a tile
constexpr int COUNT_SMEM = 48 * 1024;      // shared memory a block, bytes
constexpr int COUNT_INTS = COUNT_SMEM / 4;
constexpr int RC_MAX = 32;                 // rows of a copies chunk

struct CountTile {
  int kt, n_slab;  // clusters a slab, slabs
  int c, n_col;    // loci a tile, tiles along L
  int rc;          // rows of a copies chunk
  int rows, n_rr;  // rows a range, ranges
  int tpr, nq;     // threads a row, copies a thread a row
};

// the tile of a window of L loci of P copies, M slots, K clusters, but
// its row ranges; n_slab = 0 where none fits (P or M beyond the shared
// memory)
CountTile count_tile(int L, int P, int M, int K) {
  CountTile t = {};
  for (int n_slab = 1; n_slab <= K; ++n_slab) {
    const int kt = (K + n_slab - 1) / n_slab;
    const int rc = std::max(1, std::min(RC_MAX, COUNT_INTS / 8 / kt));
    const int c = std::min({CP_MAX / P, L, (COUNT_INTS - rc * kt) / (kt * M)});
    if (c < 1 || (c * P < 2 * kt && c < L && kt > 1)) continue;
    t.kt = kt;
    t.n_slab = (K + kt - 1) / kt;
    t.c = c;
    t.n_col = (L + c - 1) / c;
    t.rc = rc;
    const int cp = c * P;
    t.tpr = 32;
    while (t.tpr < cp && t.tpr < CT) t.tpr *= 2;
    t.nq = (cp + t.tpr - 1) / t.tpr;
    return t;
  }
  return t;
}

// ints of a block's shared memory: pc [kt, c, M], then copies [rc, kt]
__host__ __device__ __forceinline__ int count_smem_ints(const CountTile& t,
                                                        int M) {
  return t.kt * t.c * M + t.rc * t.kt;
}

// A source of the copies' codes, in two steps so that a row's loads are
// all sent out before any code is worked out: ``load`` reads what a copy's
// code comes from, ``code`` derives the code from it (the copy a of its
// genotype, the ploidy P).

// the window's codes [I, L, P]: the tile's copies of a row lie at l0 P + j
template <typename Code>
struct CodeSource {
  const Code* __restrict__ codes;
  long long stride;                        // elements between rows

  __device__ __forceinline__ int load(int row, int l0, int P, int j,
                                      int loc) const {
    return (int)__ldg(codes + (long long)row * stride + (long long)l0 * P +
                      j);
  }
  __device__ __forceinline__ int code(int v, int a, int P) const {
    return v;
  }
};

// the count planes of a biallelic panel: copy a of genotype (i, l) is
// allele 0 where a < x0, allele 1 where a < P - miss, and missing after
// (codes_from_counts' order, the planes adding up to the ploidy); both
// bytes of a genotype are loaded, packed, and serve its P copies
struct PlaneSource {
  const int8_t* __restrict__ x0;
  const int8_t* __restrict__ miss;
  long long stride;                        // bytes between rows

  __device__ __forceinline__ int load(int row, int l0, int P, int j,
                                      int loc) const {
    const long long g = (long long)row * stride + l0 + loc;
    return (int)(uint8_t)__ldg(x0 + g) | ((int)(uint8_t)__ldg(miss + g) << 8);
  }
  __device__ __forceinline__ int code(int v, int a, int P) const {
    return a < (v & 0xff) ? 0 : (a < P - (v >> 8) ? 1 : -1);
  }
};

// the counts of one block: a tile of loci, a slab of clusters, a range of
// rows (see the design above); ``src`` gives each copy's code
template <typename Source>
__device__ __forceinline__ void count_block(
    int* count_smem, const long long* __restrict__ labels, Source src,
    int* __restrict__ copies, int* __restrict__ pc, int I, int L, int P,
    int M, int K, long long lab_stride, const CountTile& t) {
  int b = blockIdx.x;
  const int slab = b % t.n_slab;
  b /= t.n_slab;
  const int l0 = (b % t.n_col) * t.c;
  const int r_lo = (b / t.n_col) * t.rows;
  const int r_hi = min(I, r_lo + t.rows);
  const int k0 = slab * t.kt;
  const int kt = min(t.kt, K - k0);        // this slab's clusters
  const int cp = min(t.c, L - l0) * P;     // this tile's copies a row
  const int cm = t.c * M;
  int* pcs = count_smem;
  int* cps = count_smem + t.kt * cm;
  for (int q = threadIdx.x; q < count_smem_ints(t, M); q += CT)
    count_smem[q] = 0;
  __syncthreads();

  const int rp = CT / t.tpr;               // rows a pass of the block
  const int row_sub = threadIdx.x / t.tpr;
  const int jt = threadIdx.x % t.tpr;
  int loc[CQ], cpy[CQ];                    // a copy's locus in the tile, copy
#pragma unroll
  for (int q = 0; q < CQ; ++q) {
    loc[q] = (jt + q * t.tpr) / P;
    cpy[q] = (jt + q * t.tpr) % P;
  }
  const long long* lab0 = labels + (long long)l0 * P;

  for (int r_c = r_lo; r_c < r_hi; r_c += t.rc) {
    const int nr = min(t.rc, r_hi - r_c);
    for (int rs = row_sub; rs < nr; rs += rp) {
      const long long* lr = lab0 + (long long)(r_c + rs) * lab_stride;
      long long lab[CQ];                   // -1 past the tile: skipped
      int v[CQ];
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int j = jt + q * t.tpr;
        const bool in = q < t.nq && j < cp;
        lab[q] = in ? __ldg(lr + j) : -1;
        v[q] = in ? src.load(r_c + rs, l0, P, j, loc[q]) : 0;
      }
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        if (q >= t.nq) break;              // the same in the block
        const long long k = lab[q] - k0;
        const int c = src.code(v[q], cpy[q], P);
        const bool ok = c >= 0 && c < M && k >= 0 && k < kt;
        if (ok) {
          atomicAdd(pcs + (int)k * cm + loc[q] * M + c, 1);
          atomicAdd(cps + rs * t.kt + (int)k, 1);
        }
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nr * t.kt; q += CT) {
      const int v = cps[q];
      if (v) {
        cps[q] = 0;
        atomicAdd(copies + (long long)(r_c + q / t.kt) * K + k0 + q % t.kt,
                  v);
      }
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < t.kt * cm; q += CT) {
    const int v = pcs[q];
    if (v) {
      const int k = q / cm, rem = q % cm;
      atomicAdd(pc + ((long long)(k0 + k) * L + l0 + rem / M) * M + rem % M,
                v);
    }
  }
}

template <typename Code>
__global__ void __launch_bounds__(CT) allele_counts_kernel(
    const long long* __restrict__ labels, const Code* __restrict__ codes,
    int* __restrict__ copies, int* __restrict__ pc, int I, int L, int P,
    int M, int K, long long lab_stride, long long code_stride,
    CountTile t) {
  extern __shared__ int count_smem[];
  count_block(count_smem, labels, CodeSource<Code>{codes, code_stride},
              copies, pc, I, L, P, M, K, lab_stride, t);
}

// the counts of a biallelic window read from its count planes (M = 2)
__global__ void __launch_bounds__(CT) allele_counts_planes_kernel(
    const long long* __restrict__ labels, const int8_t* __restrict__ x0,
    const int8_t* __restrict__ miss, int* __restrict__ copies,
    int* __restrict__ pc, int I, int L, int P, int K, long long lab_stride,
    long long plane_stride, CountTile t) {
  extern __shared__ int count_smem[];
  count_block(count_smem, labels, PlaneSource{x0, miss, plane_stride},
              copies, pc, I, L, P, 2, K, lab_stride, t);
}

// launch ``kernel`` over the tile of a window (its args then the tile)
template <typename Kernel, typename... Args>
int launch_counts(Kernel kernel, int I, int L, int P, int M, int K,
                  cudaStream_t s, Args... args) {
  CountTile t = count_tile(L, P, M, K);
  if (t.n_slab == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)count_smem_ints(t, M);
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             CT, smem);
  if (err != 0) return err;
  // row ranges: as many as fill the card in one wave, each at least a
  // chunk of rows
  const long long tiles = (long long)t.n_slab * t.n_col;
  const long long fill = (long long)sms * std::max(per_sm, 1) / tiles;
  const int n_rr = (int)std::max(
      1LL, std::min(fill, (long long)(I + t.rc - 1) / t.rc));
  t.rows = (I + n_rr - 1) / n_rr;
  t.n_rr = (I + t.rows - 1) / t.rows;
  const long long blocks = tiles * t.n_rr;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, CT, smem, s>>>(args..., t);
  return (int)cudaGetLastError();
}

}  // namespace

// copies [I, K] and pc [K, L, M] (int32, zeroed by the caller) of the
// window's labels (int64) and codes (int8 or int16: code_bytes 1 or 2),
// both [I, L, P] with a contiguous L x P axis, rows lab_stride and
// code_stride elements apart
extern "C" int mc_allele_counts(const void* labels, const void* codes,
                                void* copies, void* pc, int I, int L, int P,
                                int M, int K, long long lab_stride,
                                long long code_stride, int code_bytes,
                                void* stream) {
  if (I <= 0 || L <= 0 || P <= 0 || M <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* lab = (const long long*)labels;
  int* cp = (int*)copies;
  int* p = (int*)pc;
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes == 1)
    return launch_counts(allele_counts_kernel<int8_t>, I, L, P, M, K, s, lab,
                         (const int8_t*)codes, cp, p, I, L, P, M, K,
                         lab_stride, code_stride);
  if (code_bytes == 2)
    return launch_counts(allele_counts_kernel<int16_t>, I, L, P, M, K, s,
                         lab, (const int16_t*)codes, cp, p, I, L, P, M, K,
                         lab_stride, code_stride);
  return (int)cudaErrorInvalidValue;
}

// copies [I, K] and pc [K, L, 2] (int32, zeroed by the caller) of a
// biallelic window: labels (int64) [I, L, P] with a contiguous L x P
// axis, rows lab_stride elements apart, and the window's allele-0 and
// missing planes (int8) [I, L], rows plane_stride bytes apart
extern "C" int mc_allele_counts_planes(const void* labels, const void* x0,
                                       const void* miss, void* copies,
                                       void* pc, int I, int L, int P, int K,
                                       long long lab_stride,
                                       long long plane_stride, void* stream) {
  if (I <= 0 || L <= 0 || P <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_counts(allele_counts_planes_kernel, I, L, P, 2, K,
                       (cudaStream_t)stream, (const long long*)labels,
                       (const int8_t*)x0, (const int8_t*)miss, (int*)copies,
                       (int*)pc, I, L, P, K, lab_stride, plane_stride);
}
