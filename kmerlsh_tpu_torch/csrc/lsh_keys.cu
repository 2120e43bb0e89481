// K1: abundance transform, LSH projections and the fused int32 sort key.
//
// Replaces the reference's transform prologue (kmerlsh_tpu/ops/transform.py
// abundance_transform_t, fused into engine._head_program) and, per
// iteration, kmerlsh_tpu/ops/lsh.py signatures_t followed by
// kmerlsh_tpu/cluster/engine.py _combined_sort_key.
//
// K1a kl_transform_kernel: one thread per column, one pass over the uint16
// counts; bound by device-memory bandwidth.
//
// K1b lsh_keys. Per column the projection reads S floats and sums h + 1
// projections: the h sign planes in use and the secondary plane H_MAX. Each
// runs s = 0, 1, ... with a separately rounded multiply and add
// (__fmul_rn/__fadd_rn, never contracted), the order of the plain PyTorch
// version, so the two agree bit for bit. That costs two float32
// instructions a term: at 2^24 x 20 and h = 24 about 1.7e10, ~0.5 ms of the
// H100's issue rate, against ~0.46 ms to move the bytes once. Design:
//   - only the planes in use: kl_project is instantiated for T = 4, 8, ...,
//     28, 30 sign planes (the least T >= h) plus the secondary plane, the
//     accumulators in registers at compile-time indices;
//   - the planes in use are staged in shared memory, each sample's row
//     padded to whole float4s: one broadcast load brings 4 plane operands;
//   - four columns a thread, neighbouring threads on neighbouring columns
//     for each of the four: one plane operand serves four products;
//   - the values come by cp.async into a ring of 8 rows in shared memory,
//     each thread copying and reading back only its own columns (no
//     barrier), so 7 samples' loads are in flight while one sample's terms
//     are summed;
//   - the alive min/max of the secondary projection is reduced per warp
//     by shuffles on an order-preserving unsigned encoding; a warp skips
//     its atomic when it cannot lower the global word (so few are made),
//     and a memset starts both words: no initialising launch.
// Reading the planes from the constant bank instead (copied there on the
// stream, read at a warp-uniform index) was slower on the H100 at every
// loop shape tried: PERF.md, tools/kernel_variants.py.
// kl_quantize_kernel then reads the keys and projections once and ORs the
// quantized secondary projection into the keys. Launch arithmetic (T, shared
// bytes): kmerlsh_tpu_torch.kernels.lsh_plan, checked here.
// On rows (kl_lsh_keys_rows, kl_project<T, true>): a chain session carries
// its state between iterations as rows of W words, each column's values,
// size and slot (cluster/engine.py, csrc/chain_collapse.cu), so that no
// iteration transposes it. A thread's values then lie along its rows, so
// the ring holds stages of KL_ROW_PIECES 16-byte pieces of each of its
// four rows (both pieces of a 32-byte sector asked for at once), read back
// as float4s, four samples a read; the terms, their order and the keys
// are those of the column layout, bit for bit. Its bytes: the rows' value
// pieces, 16 ceil(S / 4) bytes a row (496 of 512 at S = 124), and
// the sizes as a column, about the column layout's; what goes is the
// transpose's write of a scratch every iteration and K3's read of it.

#include "common.cuh"

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

#define KL_PROJ_THREADS 128
#define KL_PROJ_COLS 4           // columns a thread
#define KL_PROJ_TILE (KL_PROJ_THREADS * KL_PROJ_COLS)   // columns a block
#define KL_PROJ_RING 8           // value rows a thread has in shared memory
#define KL_ROW_PIECES 2          // 16-byte pieces of each row a stage holds
#define KL_ROW_RING 3            // stages a thread has in shared memory
#define KL_SMEM_LIMIT 232448     // shared bytes one block may use on Hopper

// Order-preserving unsigned encoding of a float: a larger float, a larger
// word.
__device__ __forceinline__ unsigned kl_ordered(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float kl_unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? u & 0x7FFFFFFFu : ~u);
}

// Start the copy of value row s (when s < S) of this thread's columns into
// its ring slot s % KL_PROJ_RING, and commit it as one group (empty past S).
__device__ __forceinline__ void kl_issue_row(float* ring,
                                             const float* __restrict__ values,
                                             long long ld, int s, int S,
                                             long long m0, long long M) {
  if (s < S) {
    const float* row = values + (long long)s * ld;
    float* slot = ring + (s % KL_PROJ_RING) * KL_PROJ_TILE + threadIdx.x;
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c) {
      const long long m = m0 + (long long)c * KL_PROJ_THREADS;
      if (m < M) kl_cp_async4(slot + c * KL_PROJ_THREADS, row + m);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// On rows: the float4 of piece k (< KL_ROW_PIECES) of the block's row rb
// within a stage. Every other group of four rows swaps its two pieces, so
// that the 16-byte reads of a quarter warp's eight neighbouring rows cover
// the 32 banks.
__device__ __forceinline__ int kl_row_piece(int rb, int k) {
  return rb * KL_ROW_PIECES + (k ^ ((rb >> 2) & 1));
}

// Start the copy of stage g of this thread's rows (pieces g * KL_ROW_PIECES
// + k below Q, those that hold values, of rows [*, W]; each row's pieces
// one after the other, so each 32-byte sector is asked for at once) into
// its ring slot g % KL_ROW_RING, and commit it as one group (empty past Q).
__device__ __forceinline__ void kl_issue_pieces(float4* ring,
                                                const float* __restrict__ rows,
                                                long long W, int g, int Q,
                                                long long m0, long long M) {
  float4* stage = ring + (g % KL_ROW_RING) * (KL_PROJ_TILE * KL_ROW_PIECES);
#pragma unroll
  for (int c = 0; c < KL_PROJ_COLS; ++c) {
    const long long m = m0 + (long long)c * KL_PROJ_THREADS;
    const int rb = c * KL_PROJ_THREADS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < KL_ROW_PIECES; ++k) {
      const int q = g * KL_ROW_PIECES + k;
      if (m < M && q < Q)
        kl_cp_async16(stage + kl_row_piece(rb, k), rows + m * W + 4 * q);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One sample's terms of this thread's columns: x[c] the sample's value of
// column c, row its planes in use (NQ float4s); a separately rounded
// multiply and add a term.
template <int T>
__device__ __forceinline__ void kl_terms(float (&acc)[KL_PROJ_COLS][T + 1],
                                         const float (&x)[KL_PROJ_COLS],
                                         const float4* row) {
  constexpr int NP = T + 1, NQ = (NP + 3) / 4;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 p4 = row[q];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < NP) {
#pragma unroll
        for (int c = 0; c < KL_PROJ_COLS; ++c)
          acc[c][4 * q + k] =
              __fadd_rn(acc[c][4 * q + k], __fmul_rn(p[k], x[c]));
      }
    }
  }
}

// ROWS false: values [S, M] at a row stride of ld floats. ROWS true: rows
// [M, ld] (a chain session's row state, ld = W), the values in words 0 .. S
// - 1 of each. The same terms in the same order either way.
template <int T, bool ROWS>
__global__ void __launch_bounds__(KL_PROJ_THREADS) kl_project(
    const float* __restrict__ values, long long ld, int S, long long M,
    const float* __restrict__ planes, const int* __restrict__ sizes, int h,
    int* __restrict__ keys, float* __restrict__ proj,
    unsigned* __restrict__ minmax) {
  // accumulator j: sign plane j < T, then the secondary plane H_MAX
  constexpr int NP = T + 1, NQ = (NP + 3) / 4;
  // the planes in use [S][NQ] as float4s, then the ring: of value rows
  // [KL_PROJ_RING][KL_PROJ_TILE], or on rows of stages
  // [KL_ROW_RING][KL_PROJ_TILE][KL_ROW_PIECES] float4s
  extern __shared__ float4 sp[];
  float* ring = reinterpret_cast<float*>(sp + S * NQ);
  float4* ring4 = sp + S * NQ;
  const long long m0 = (long long)blockIdx.x * KL_PROJ_TILE + threadIdx.x;
  const int Q = (S + 3) >> 2;   // on rows: the pieces that hold values
  const int G = (Q + KL_ROW_PIECES - 1) / KL_ROW_PIECES;
  if constexpr (ROWS) {
    for (int g = 0; g < KL_ROW_RING - 1; ++g)
      kl_issue_pieces(ring4, values, ld, g, Q, m0, M);
  } else {
    for (int r = 0; r < KL_PROJ_RING - 1; ++r)
      kl_issue_row(ring, values, ld, r, S, m0, M);
  }
  float* spf = reinterpret_cast<float*>(sp);
  for (int i = threadIdx.x; i < S * 4 * NQ; i += KL_PROJ_THREADS) {
    const int s = i / (4 * NQ), j = i - s * 4 * NQ;
    spf[i] = j < NP ? planes[s * KL_PLANES + (j < T ? j : KL_H_MAX)] : 0.f;
  }
  __syncthreads();
  float acc[KL_PROJ_COLS][NP];
#pragma unroll
  for (int c = 0; c < KL_PROJ_COLS; ++c)
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[c][j] = 0.f;
  if constexpr (ROWS) {
    for (int g = 0; g < G; ++g) {
      kl_issue_pieces(ring4, values, ld, g + KL_ROW_RING - 1, Q, m0, M);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(KL_ROW_RING - 1)
                   : "memory");   // this thread's stage g has arrived
      const float4* stage =
          ring4 + (g % KL_ROW_RING) * (KL_PROJ_TILE * KL_ROW_PIECES);
#pragma unroll
      for (int k = 0; k < KL_ROW_PIECES; ++k) {
        const int q = g * KL_ROW_PIECES + k;
        if (q >= Q) break;
        float4 x4[KL_PROJ_COLS];
#pragma unroll
        for (int c = 0; c < KL_PROJ_COLS; ++c)
          x4[c] = stage[kl_row_piece(c * KL_PROJ_THREADS + threadIdx.x, k)];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = 4 * q + u;
          if (s >= S) break;
          float x[KL_PROJ_COLS];
#pragma unroll
          for (int c = 0; c < KL_PROJ_COLS; ++c)
            x[c] = u == 0 ? x4[c].x : u == 1 ? x4[c].y : u == 2 ? x4[c].z
                                                                : x4[c].w;
          kl_terms<T>(acc, x, sp + s * NQ);
        }
      }
    }
  } else {
    for (int s = 0; s < S; ++s) {
      kl_issue_row(ring, values, ld, s + KL_PROJ_RING - 1, S, m0, M);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(KL_PROJ_RING - 1)
                   : "memory");   // this thread's row s has arrived
      const float* slot =
          ring + (s % KL_PROJ_RING) * KL_PROJ_TILE + threadIdx.x;
      float x[KL_PROJ_COLS];
#pragma unroll
      for (int c = 0; c < KL_PROJ_COLS; ++c) x[c] = slot[c * KL_PROJ_THREADS];
      kl_terms<T>(acc, x, sp + s * NQ);
    }
  }

  unsigned lo = 0xFFFFFFFFu, hi = 0xFFFFFFFFu;   // least word, least ~word
#pragma unroll
  for (int c = 0; c < KL_PROJ_COLS; ++c) {
    const long long m = m0 + (long long)c * KL_PROJ_THREADS;
    if (m >= M) continue;
    int key = 0;
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < h && acc[c][j] >= 0.f) key |= 1 << (h - 1 - j);
    const float p = acc[c][T];
    const bool alive = sizes[m] > 0;
    keys[m] = alive ? key : KL_BIG_KEY;
    proj[m] = p;
    if (alive) {
      const unsigned u = kl_ordered(p);
      lo = min(lo, u);
      hi = min(hi, ~u);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
    hi = min(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
  }
  // the words only fall: a stale read can only let an atomic through
  if ((threadIdx.x & 31) == 0) {
    if (lo < __ldcg(minmax)) atomicMin(minmax, lo);
    if (hi < __ldcg(minmax + 1)) atomicMin(minmax + 1, hi);
  }
}

__global__ void kl_quantize_kernel(long long M,
                                   const unsigned* __restrict__ minmax,
                                   int free_bits, const float* __restrict__ proj,
                                   int* __restrict__ keys) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  int k = keys[m];
  if (k == KL_BIG_KEY) return;
  float pmin = kl_unordered(minmax[0]);
  float pmax = kl_unordered(~minmax[1]);
  float span = fmaxf(__fsub_rn(pmax, pmin), 1e-20f);
  int levels = 1 << free_bits;
  float scaled = __fmul_rn(__fdiv_rn(__fsub_rn(proj[m], pmin), span),
                           (float)levels);
  int q = (int)scaled;
  q = min(max(q, 0), levels - 1);
  keys[m] = (k << free_bits) | q;
}

template <int T, bool ROWS>
static cudaError_t kl_project_launch(const float* values, long long ld, int S,
                                     long long M, const float* planes,
                                     const int* sizes, int h, int smem,
                                     int* keys, float* proj, unsigned* minmax,
                                     cudaStream_t st) {
  static unsigned raised = 0;   // devices whose shared-memory limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(kl_project<T, ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               KL_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  kl_project<T, ROWS>
      <<<kl_blocks(M, KL_PROJ_TILE), KL_PROJ_THREADS, smem, st>>>(
          values, ld, S, M, planes, sizes, h, keys, proj, minmax);
  return cudaGetLastError();
}

// The shared bytes of a block: S rows of ceil((T + 1) / 4) float4s of
// planes, and the ring (kernels.lsh_plan).
static int kl_project_smem(int S, int T, bool rows) {
  return S * 16 * ((T + 4) / 4) +
         (rows ? KL_ROW_RING * KL_PROJ_TILE * KL_ROW_PIECES * 16
               : KL_PROJ_RING * KL_PROJ_TILE * (int)sizeof(float));
}

template <bool ROWS>
static int kl_lsh_keys_at(const void* values, long long ld, int S, long long M,
                          const void* planes, const void* sizes, int h, int T,
                          int smem, int free_bits, void* keys, void* proj,
                          void* minmax, cudaStream_t st) {
  if (h < 1 || h > T || smem > KL_SMEM_LIMIT ||
      smem != kl_project_smem(S, T, ROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(minmax, 0xFF, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
#define KL_PROJECT_CASE(N)                                                   \
  case N:                                                                    \
    err = kl_project_launch<N, ROWS>(                                        \
        (const float*)values, ld, S, M, (const float*)planes,                \
        (const int*)sizes, h, smem, (int*)keys, (float*)proj,                \
        (unsigned*)minmax, st);                                              \
    break;
  switch (T) {
    KL_PROJECT_CASE(4)
    KL_PROJECT_CASE(8)
    KL_PROJECT_CASE(12)
    KL_PROJECT_CASE(16)
    KL_PROJECT_CASE(20)
    KL_PROJECT_CASE(24)
    KL_PROJECT_CASE(28)
    KL_PROJECT_CASE(30)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KL_PROJECT_CASE
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  kl_quantize_kernel<<<kl_blocks(M, threads), threads, 0, st>>>(
      M, (const unsigned*)minmax, free_bits, (const float*)proj, (int*)keys);
  return (int)cudaGetLastError();
}

// T: the sign planes computed (4, 8, ..., 28 or 30, at least h); smem:
// kl_project_smem's.
KL_EXPORT int kl_lsh_keys(const void* values, long long ld, int S, long long M,
                          const void* planes, const void* sizes, int h, int T,
                          int smem, int free_bits, void* keys, void* proj,
                          void* minmax, void* stream) {
  return kl_lsh_keys_at<false>(values, ld, S, M, planes, sizes, h, T, smem,
                               free_bits, keys, proj, minmax,
                               (cudaStream_t)stream);
}

// The same on a chain session's row state: rows [M, W] (W a multiple of 4,
// at least S + 1), sizes [M] as a column.
KL_EXPORT int kl_lsh_keys_rows(const void* rows, int W, int S, long long M,
                               const void* planes, const void* sizes, int h,
                               int T, int smem, int free_bits, void* keys,
                               void* proj, void* minmax, void* stream) {
  if (W < S + 1 || W % 4 != 0) return (int)cudaErrorInvalidValue;
  return kl_lsh_keys_at<true>(rows, W, S, M, planes, sizes, h, T, smem,
                              free_bits, keys, proj, minmax,
                              (cudaStream_t)stream);
}
