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
