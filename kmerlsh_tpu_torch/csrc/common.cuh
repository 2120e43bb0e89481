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

// Exclusive prefix sum of v over the block (a multiple of 32 threads, at most
// 1024); *total gets the block's sum. Called once a launch, or with a
// __syncthreads() between calls.
__device__ __forceinline__ int kl_block_scan(int v, int* total) {
  __shared__ int ws[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    ws[lane] = t;
  }
  __syncthreads();
  *total = ws[nw - 1];
  return (w ? ws[w - 1] : 0) + x - v;
}
