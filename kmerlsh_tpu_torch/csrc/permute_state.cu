// K2: apply a sort order to the iteration state.
//
// Replaces the payload half of the reference's variadic sort
// (kmerlsh_tpu/cluster/engine.py _sort_state and compact_sort, where XLA
// carried the S value rows, sizes and slots through lax.sort as payloads).
// Here the int32 key sort is torch.sort(stable=True) and this kernel moves
// the state by the resulting order: out[:, i] = in[:, order[i]].
//
// Bound on the H100: device-memory latency and bandwidth of scattered reads.
// Writes are coalesced (neighbouring threads write neighbouring columns);
// each read of in[s, order[i]] touches its own 32-byte sector, so the reads
// move up to 8x the useful bytes. The design keeps it to one pass with many
// loads in flight: one thread per (row, column) element, the row taken from
// blockIdx.y, and the threads of row 0 also move the two int32 arrays. The
// input may be a column slice of a wider matrix (row stride ld_in), so the
// engine never copies to shrink capacity.

#include "common.cuh"

__global__ void kl_permute_kernel(const float* __restrict__ vin, long long ld_in,
                                  long long M,
                                  const long long* __restrict__ order,
                                  const int* __restrict__ sizes_in,
                                  const int* __restrict__ slots_in,
                                  float* __restrict__ vout,
                                  int* __restrict__ sizes_out,
                                  int* __restrict__ slots_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  long long s = blockIdx.y;
  long long src = order[i];
  vout[s * M + i] = vin[s * ld_in + src];
  if (s == 0) {
    sizes_out[i] = sizes_in[src];
    slots_out[i] = slots_in[src];
  }
}

KL_EXPORT int kl_permute_state(const void* vin, long long ld_in, int S,
                               long long M, const void* order,
                               const void* sizes_in, const void* slots_in,
                               void* vout, void* sizes_out, void* slots_out,
                               void* stream) {
  const int threads = 256;
  dim3 grid(kl_blocks(M, threads), (unsigned)(S > 0 ? S : 1));
  kl_permute_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vin, ld_in, M, (const long long*)order,
      (const int*)sizes_in, (const int*)slots_in, (float*)vout,
      (int*)sizes_out, (int*)slots_out);
  return (int)cudaGetLastError();
}
