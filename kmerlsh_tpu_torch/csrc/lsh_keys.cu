// K1: abundance transform, LSH projections and the fused int32 sort key.
//
// Replaces the reference's transform prologue (kmerlsh_tpu/ops/transform.py
// abundance_transform_t, fused into engine._head_program) and, per
// iteration, kmerlsh_tpu/ops/lsh.py signatures_t followed by
// kmerlsh_tpu/cluster/engine.py _combined_sort_key.
//
// Bound on the H100: device-memory bandwidth. Per column the projection
// reads S floats and does 31·S multiply-adds, far below the card's float32
// rate, so one pass over the [S, M] matrix is the cost. Design: one thread
// per column reads its S values once (neighbouring threads, neighbouring
// addresses) against planes staged in shared memory, keeps the 31 sums in
// registers, and writes the bucket key and the secondary projection. The
// alive min/max of the secondary projection, which the quantization needs,
// is reduced in the same pass (warp shuffles, one atomic per warp on an
// order-preserving int encoding), so the quantize pass reads only the two
// [M] vectors. Sums run s = 0, 1, … with separately rounded multiply and
// add (__fmul_rn/__fadd_rn, never contracted), the order of the plain
// PyTorch version, so the two agree bit for bit.

#include "common.cuh"

#include <limits.h>

__device__ __forceinline__ int kl_ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float kl_unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF);
}

__global__ void kl_transform_kernel(const uint16_t* __restrict__ counts,
                                    const float* __restrict__ v, int S,
                                    long long M, float keep_thr,
                                    float* __restrict__ values,
                                    int* __restrict__ sizes) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  int total = 0;
  for (int s = 0; s < S; ++s) {
    unsigned c = counts[(long long)s * M + m];
    total += (int)c;
    values[(long long)s * M + m] = __fsub_rn(log1pf((float)c), v[s]);
  }
  sizes[m] = ((float)total > keep_thr) ? 1 : 0;
}

__global__ void kl_minmax_init(int* minmax) {
  minmax[0] = kl_ordered(__int_as_float(0x7F800000));   // +inf
  minmax[1] = kl_ordered(__int_as_float(0xFF800000));   // -inf
}

__global__ void kl_project_kernel(const float* __restrict__ values,
                                  long long ld, int S, long long M,
                                  const float* __restrict__ planes,
                                  const int* __restrict__ sizes, int h,
                                  int* __restrict__ keys,
                                  float* __restrict__ proj,
                                  int* __restrict__ minmax) {
  extern __shared__ float sp[];   // [S][KL_PLANES]
  for (int i = threadIdx.x; i < S * KL_PLANES; i += blockDim.x) sp[i] = planes[i];
  __syncthreads();

  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = m < M;
  float acc[KL_PLANES];
#pragma unroll
  for (int j = 0; j < KL_PLANES; ++j) acc[j] = 0.f;
  if (active) {
    for (int s = 0; s < S; ++s) {
      float x = values[(long long)s * ld + m];
      const float* row = sp + s * KL_PLANES;
#pragma unroll
      for (int j = 0; j < KL_PLANES; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(row[j], x));
    }
  }
  int key = 0;
#pragma unroll
  for (int j = 0; j < KL_H_MAX; ++j)
    if (j < h && acc[j] >= 0.f) key |= 1 << (h - 1 - j);
  bool alive = active && sizes[m] > 0;
  float p = acc[KL_H_MAX];
  if (active) {
    keys[m] = alive ? key : KL_BIG_KEY;
    proj[m] = p;
  }
  int lo = alive ? kl_ordered(p) : INT_MAX;
  int hi = alive ? kl_ordered(p) : INT_MIN;
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_down_sync(0xFFFFFFFFu, lo, off));
    hi = max(hi, __shfl_down_sync(0xFFFFFFFFu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    if (lo != INT_MAX) atomicMin(minmax, lo);
    if (hi != INT_MIN) atomicMax(minmax + 1, hi);
  }
}

__global__ void kl_quantize_kernel(long long M, const int* __restrict__ minmax,
                                   int free_bits, const float* __restrict__ proj,
                                   int* __restrict__ keys) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  int k = keys[m];
  if (k == KL_BIG_KEY) return;
  float pmin = kl_unordered(minmax[0]);
  float pmax = kl_unordered(minmax[1]);
  float span = fmaxf(__fsub_rn(pmax, pmin), 1e-20f);
  int levels = 1 << free_bits;
  float scaled = __fmul_rn(__fdiv_rn(__fsub_rn(proj[m], pmin), span),
                           (float)levels);
  int q = (int)scaled;
  q = min(max(q, 0), levels - 1);
  keys[m] = (k << free_bits) | q;
}

KL_EXPORT int kl_transform(const void* counts, const void* v, int S,
                           long long M, float keep_thr, void* values,
                           void* sizes, void* stream) {
  const int threads = 256;
  kl_transform_kernel<<<kl_blocks(M, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint16_t*)counts, (const float*)v, S, M, keep_thr,
      (float*)values, (int*)sizes);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_lsh_keys(const void* values, long long ld, int S, long long M,
                          const void* planes, const void* sizes, int h,
                          int free_bits, void* keys, void* proj, void* minmax,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  size_t smem = (size_t)S * KL_PLANES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kl_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  kl_minmax_init<<<1, 1, 0, st>>>((int*)minmax);
  kl_project_kernel<<<kl_blocks(M, threads), threads, smem, st>>>(
      (const float*)values, ld, S, M, (const float*)planes,
      (const int*)sizes, h, (int*)keys, (float*)proj, (int*)minmax);
  kl_quantize_kernel<<<kl_blocks(M, threads), threads, 0, st>>>(
      M, (const int*)minmax, free_bits, (const float*)proj, (int*)keys);
  return (int)cudaGetLastError();
}
