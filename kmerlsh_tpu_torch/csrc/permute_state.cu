// K2: apply a sort order to the iteration state.
//
// Replaces the payload half of the reference's variadic sort
// (kmerlsh_tpu/cluster/engine.py:117 _sort_state and :451 compact_sort,
// where XLA carried the S value rows, sizes and slots through lax.sort as
// payloads). Here the int32 key sort is K9 sort_keys (csrc/sort_keys.cu),
// whose int32 order these kernels move the state by: out[:, i] =
// in[:, order[i]], sizes and slots alike, bit for bit.
//
// Bound on the H100: device-memory bandwidth. The state is sample-major
// [S, M], so a gather straight from it reads a whole 32-byte sector for
// every 4-byte value (about 8x the useful bytes) and, with one thread per
// (row, column), reads order[i] once per row. The design moves the state
// twice instead, each time in whole sectors:
//   (a) kl_permute_transpose: a tile of C columns goes through shared
//       memory into a profile-major scratch [M, W]: each scratch row holds
//       the column's S values, then its size and slot as 32-bit words,
//       padded to W = a multiple of 8 words (whole 32-byte sectors). The
//       tile comes in by cp.async along the rows of the input (which may be
//       a column slice of a wider matrix, row stride ld_in), so every load
//       of the block is in flight at once, and goes out along the scratch;
//   (b) kl_permute_gather: a block takes a run of C output columns, reads
//       each order[i] once, copies the W words of each source row into
//       shared memory with 16-byte cp.async, and writes the S value rows,
//       the sizes and the slots coalesced.
// At 2^24 x 20 that is ~6.3 GB of traffic against ~15 GB for the direct
// gather. Bank conflicts: the transpose tile's rows are W + 1 words (odd),
// so its column-wise writes hit distinct banks; the gather tile's rows are
// kl_stage_ld(W) words (16-byte aligned, an odd number of 16-byte pieces),
// so the 16-byte reads of eight neighbouring columns cover distinct banks.
// The scratch is allocated by the wrapper; the launch arithmetic (W, C,
// shared memory) is kmerlsh_tpu_torch.kernels.permute_plan, checked here.
//
// A chain session (cluster/engine.py) carries its state between iterations
// as such rows (kernels.rows_plan: W the least multiple of 4 words at or
// above S + 2, so at S = 18 rows of 20 words against the scratch's 24): (a)
// alone makes it once a session (kl_state_rows), (b) alone takes it back to
// [S, M] columns in the compaction's order (kl_rows_gather). Between them
// K1b and K3 read and write the rows themselves, and no iteration runs (a).

#include "common.cuh"

__global__ void __launch_bounds__(KL_MOVE_THREADS) kl_permute_transpose(
    const unsigned* __restrict__ vin, long long ld_in, int S, long long M,
    const unsigned* __restrict__ sizes, const unsigned* __restrict__ slots,
    int W, int C, unsigned* __restrict__ scr) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* tile = (unsigned*)smem;   // [C][W + 1]
  const int t = threadIdx.x, ldt = W + 1;
  const long long c0 = (long long)blockIdx.x * C;
  const int n = (int)min((long long)C, M - c0);
  const int c = t % C;   // C divides the block: a warp shares one row s
  if (c < n) {
    for (int s = t / C; s < W; s += KL_MOVE_THREADS / C) {
      unsigned* d = tile + c * ldt + s;
      if (s < S) kl_cp_async4(d, vin + s * ld_in + c0 + c);
      else if (s == S) kl_cp_async4(d, sizes + c0 + c);
      else if (s == S + 1) kl_cp_async4(d, slots + c0 + c);
      else *d = 0;
    }
  }
  kl_cp_async_wait_all();
  __syncthreads();
  // the tile's n rows are contiguous in the scratch: word j is (j / W, j % W)
  unsigned* dst = scr + c0 * W;
  const int dc = KL_MOVE_THREADS / W, ds = KL_MOVE_THREADS % W;
  int cc = t / W, s = t % W;
  for (int j = t; j < n * W; j += KL_MOVE_THREADS) {
    dst[j] = tile[cc * ldt + s];
    cc += dc;
    s += ds;
    if (s >= W) {
      s -= W;
      ++cc;
    }
  }
}

__global__ void __launch_bounds__(KL_MOVE_THREADS) kl_permute_gather(
    const unsigned* __restrict__ scr, int S, long long M,
    const int* __restrict__ order, int W, int C,
    unsigned* __restrict__ vout, unsigned* __restrict__ sizes_out,
    unsigned* __restrict__ slots_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ord = (int*)smem;                        // [C]
  unsigned* tile = (unsigned*)(smem + 4 * C);   // [C][kl_stage_ld(W)]
  const int t = threadIdx.x, ldt = kl_stage_ld(W);
  const long long i0 = (long long)blockIdx.x * C;
  const int n = (int)min((long long)C, M - i0);
  kl_stage_rows<KL_MOVE_THREADS>(scr, W, order + i0, n, ord, tile);
  const int c = t % C;
  if (c >= n) return;
  for (int q = t / C; 4 * q < S + 2; q += KL_MOVE_THREADS / C) {
    const uint4 x = *(const uint4*)(tile + c * ldt + 4 * q);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = 4 * q + k;
      if (s < S) vout[s * M + i0 + c] = w[k];
      else if (s == S) sizes_out[i0 + c] = w[k];
      else if (s == S + 1) slots_out[i0 + c] = w[k];
    }
  }
}

// Launch (a) alone: the state into the scratch [M, W], for the chain
// collapse (csrc/chain_collapse.cu), which stages whole rows of it by the
// sort order, finalize's column move (csrc/finalize.cu
// kl_finalize_columns) and a chain session's row state (kl_state_rows).
// W, C and smem are permute_plan's (rows_plan's for the row state), as for
// kl_permute_state.
int kl_permute_to_scratch(const void* vin, long long ld_in, int S,
                          long long M, const void* sizes_in,
                          const void* slots_in, int W, int C, int smem,
                          void* scratch, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kl_permute_transpose, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kl_permute_transpose<<<kl_blocks(M, C), KL_MOVE_THREADS, 4 * C * (W + 1),
                         st>>>(
      (const unsigned*)vin, ld_in, S, M, (const unsigned*)sizes_in,
      (const unsigned*)slots_in, W, C, (unsigned*)scratch);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_permute_state(const void* vin, long long ld_in, int S,
                               long long M, const void* order,
                               const void* sizes_in, const void* slots_in,
                               int W, int C, int smem, void* scratch,
                               void* vout, void* sizes_out, void* slots_out,
                               void* stream) {
  if (!kl_move_plan_ok(S, W, C, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      kl_permute_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int e = kl_permute_to_scratch(vin, ld_in, S, M, sizes_in, slots_in,
                                      W, C, smem, scratch, st);
  if (e != 0) return e;
  kl_permute_gather<<<kl_blocks(M, C), KL_MOVE_THREADS, smem, st>>>(
      (const unsigned*)scratch, S, M, (const int*)order, W, C,
      (unsigned*)vout, (unsigned*)sizes_out, (unsigned*)slots_out);
  return (int)cudaGetLastError();
}

// The row state of a chain session: launch (a) alone, the state [S, M]
// (rows may be strided) into rows [M, W]. W, C and smem are rows_plan's.
KL_EXPORT int kl_state_rows(const void* vin, long long ld_in, int S,
                            long long M, const void* sizes_in,
                            const void* slots_in, int W, int C, int smem,
                            void* rows, void* stream) {
  if (!kl_move_plan_ok(S, W, C, smem)) return (int)cudaErrorInvalidValue;
  return kl_permute_to_scratch(vin, ld_in, S, M, sizes_in, slots_in, W, C,
                               smem, rows, (cudaStream_t)stream);
}

// Launch (b) alone: the row state [*, W] gathered by an order into [S, M]
// columns (values, sizes, slots). W, C and smem are rows_plan's.
KL_EXPORT int kl_rows_gather(const void* rows, int S, long long M,
                             const void* order, int W, int C, int smem,
                             void* vout, void* sizes_out, void* slots_out,
                             void* stream) {
  if (!kl_move_plan_ok(S, W, C, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      kl_permute_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kl_permute_gather<<<kl_blocks(M, C), KL_MOVE_THREADS, smem, st>>>(
      (const unsigned*)rows, S, M, (const int*)order, W, C, (unsigned*)vout,
      (unsigned*)sizes_out, (unsigned*)slots_out);
  return (int)cudaGetLastError();
}
