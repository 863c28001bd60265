// Dynamic shared memory, shared by every kernel source of the port: the
// buffer, the opt-in past 48 KB and the asynchronous copies (cp.async)
// that stream tiles from device memory into it.
#pragma once

#include <cuda_runtime.h>

// dynamic shared memory of every kernel that includes this, 16-byte aligned
extern __shared__ float4 dyn_smem4[];

namespace {

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may ask

// lets a block of `kernel` ask for more than 48 KB of dynamic shared
// memory (per device, so it is set before every launch); returns the
// cudaError_t of the call
template <typename Kernel>
int allow_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

// 16-byte asynchronous copy to shared memory; the bytes past `src_bytes`
// are filled with zeros.  Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
// 4-byte asynchronous copy to shared memory, zeros past `src_bytes`
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits for this thread's copies of all but the N most recent groups
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

}  // namespace
