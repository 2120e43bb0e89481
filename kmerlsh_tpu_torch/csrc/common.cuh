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

// The words of a profile-major row staged in shared memory, for a row of W
// words (a multiple of 4): 16-byte aligned and an odd number of 16-byte
// pieces (W itself where W = 4 mod 8, else W + 4), so that the 16-byte
// reads of eight neighbouring rows cover the 32 banks.
__host__ __device__ __forceinline__ int kl_stage_ld(int W) {
  return (W & 7) ? W : W + 4;
}

// K2's launch (a) alone (csrc/permute_state.cu): the state into the
// profile-major scratch [M, W], each column's S values, size and slot in a
// row of W words, for the gathers that read whole rows of it by a sort
// order (K3's staging, finalize's columns), and into a chain session's row
// state. KL_MOVE_THREADS threads a block; W, C (columns a block) and smem
// are kernels.permute_plan's (rows_plan's for the row state), which
// kl_move_plan_ok checks.
#define KL_MOVE_THREADS 256

int kl_permute_to_scratch(const void* vin, long long ld_in, int S,
                          long long M, const void* sizes_in,
                          const void* slots_in, int W, int C, int smem,
                          void* scratch, cudaStream_t st);

static inline bool kl_move_plan_ok(int S, int W, int C, int smem) {
  return W >= S + 2 && W % 4 == 0 && C >= 32 && KL_MOVE_THREADS % C == 0 &&
         smem == 4 * C + 4 * C * kl_stage_ld(W);
}

// Rows ord[c] of the row-major scratch scr ([*, W] words, W a multiple of 4)
// into a shared tile of n rows of kl_stage_ld(W) words: ord[c] = order[c]
// is read once a row, the rows come in by 16-byte cp.async spread over the
// block's THREADS threads, and the block waits for them. K2's gather and
// finalize's gather stage their rows so.
template <int THREADS>
__device__ __forceinline__ void kl_stage_rows(
    const unsigned* __restrict__ scr, int W, const int* __restrict__ order,
    int n, int* ord, unsigned* tile) {
  const int t = threadIdx.x, ldt = kl_stage_ld(W), Q = W / 4;
  for (int c = t; c < n; c += THREADS) ord[c] = order[c];
  __syncthreads();
  // quad e of the run is (row e / Q, quad e % Q)
  const int dc = THREADS / Q, dq = THREADS % Q;
  int c = t / Q, q = t % Q;
  for (int e = t; e < n * Q; e += THREADS) {
    kl_cp_async16(tile + c * ldt + 4 * q,
                  scr + (long long)ord[c] * W + 4 * q);
    c += dc;
    q += dq;
    if (q >= Q) {
      q -= Q;
      ++c;
    }
  }
  kl_cp_async_wait_all();
  __syncthreads();
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
