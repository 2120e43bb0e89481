// Shared definitions of the kmerlsh_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KL_H_MAX 30
#define KL_PLANES (KL_H_MAX + 1)
#define KL_BIG_KEY 0x7FFFFFFF

// Every C entry point returns the launch status: cudaGetLastError() after
// its launches, so that a launch the device refused reaches the caller.
#define KL_EXPORT extern "C" __attribute__((visibility("default")))

static inline unsigned kl_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Asynchronous copies from device memory into shared memory (cp.async):
// 4 bytes (cached in L1 and L2) or 16 (L2 only), then a wait for all of
// this thread's copies.
__device__ __forceinline__ void kl_cp_async4(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void kl_cp_async16(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void kl_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
