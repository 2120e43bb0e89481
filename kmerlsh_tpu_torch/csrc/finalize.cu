// K5: root resolution and membership grouping, once per session.
//
// Replaces kmerlsh_tpu/cluster/engine.py _finalize_grouped (with _fwd_fill
// and its slot-map and segment scatters). The reference resolves roots by
// `jumps` rounds of pointer doubling over the whole parent array and groups
// rows with two stable sorts and log-step fills, because XLA has neither
// per-thread loops nor cheap atomics. Here:
//   1. a slot map: alive[slot] for each alive cluster column;
//   2. one thread per row follows its parent chain to the root (the forest
//      is shallow: one level per iteration at most); a row whose root is an
//      alive cluster adds itself to that cluster's count and takes the
//      minimum row id (its first member) with atomics;
//   3. each row's sort key is its cluster's first member (dead-rooted rows
//      get cap0 and sink); torch.sort(stable=True) of that key is the flat
//      member list: clusters by smallest member, members ascending;
//   4. the alive clusters' first members, sorted the same way, give the
//      cluster order; one thread per cluster gathers its length, size and
//      centroid column.
// The output equals the reference's buffer (flat members, lengths, sizes,
// centroids) wherever the reference's jump bound covers the forest.
//
// Bound on the H100: memory latency of the dependent parent loads in step 2
// and the two sorts; everything else is one pass over [cap0] or [S, fc].

#include "common.cuh"

__global__ void kl_fin_slot_map(long long fc, const int* __restrict__ sizes,
                                const int* __restrict__ slots,
                                int* __restrict__ alive_of_slot) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < fc && sizes[i] > 0) alive_of_slot[slots[i]] = 1;
}

__global__ void kl_fin_roots(long long cap0, const int* __restrict__ parent,
                             const int* __restrict__ alive_of_slot,
                             int* __restrict__ root_key,
                             int* __restrict__ first_of_root,
                             int* __restrict__ count) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap0) return;
  int x = (int)r;
  for (long long step = 0; step < cap0; ++step) {
    int px = parent[x];
    if (px == x) break;
    x = px;
  }
  if (alive_of_slot[x]) {
    root_key[r] = x;
    atomicMin(first_of_root + x, (int)r);
    atomicAdd(count + x, 1);
  } else {
    root_key[r] = (int)cap0;
  }
}

__global__ void kl_fin_keys(long long cap0, long long fc,
                            const int* __restrict__ root_key,
                            const int* __restrict__ first_of_root,
                            const int* __restrict__ sizes,
                            const int* __restrict__ slots,
                            int* __restrict__ member_key,
                            int* __restrict__ cluster_key) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < cap0) {
    int k = root_key[r];
    member_key[r] = k == (int)cap0 ? k : first_of_root[k];
  }
  if (r < fc)
    cluster_key[r] = sizes[r] > 0 ? first_of_root[slots[r]] : (int)cap0;
}

__global__ void kl_fin_gather(long long fc, int S,
                              const long long* __restrict__ order,
                              const int* __restrict__ sizes,
                              const int* __restrict__ slots,
                              const int* __restrict__ count,
                              const float* __restrict__ vals,
                              int* __restrict__ lens, int* __restrict__ csizes,
                              float* __restrict__ cents) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= fc) return;
  long long i = order[k];
  bool alive = sizes[i] > 0;
  lens[k] = alive ? count[slots[i]] : 0;
  csizes[k] = alive ? sizes[i] : 0;
  for (int s = 0; s < S; ++s)
    cents[(long long)s * fc + k] = alive ? vals[(long long)s * fc + i] : 0.f;
}

KL_EXPORT int kl_finalize_keys(long long cap0, long long fc, const void* sizes,
                               const void* slots, const void* parent,
                               void* alive_of_slot, void* root_key, void* first_of_root,
                               void* count, void* member_key,
                               void* cluster_key, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (fc > 0)
    kl_fin_slot_map<<<kl_blocks(fc, threads), threads, 0, st>>>(
        fc, (const int*)sizes, (const int*)slots, (int*)alive_of_slot);
  kl_fin_roots<<<kl_blocks(cap0, threads), threads, 0, st>>>(
      cap0, (const int*)parent, (const int*)alive_of_slot, (int*)root_key,
      (int*)first_of_root, (int*)count);
  long long n = cap0 > fc ? cap0 : fc;
  kl_fin_keys<<<kl_blocks(n, threads), threads, 0, st>>>(
      cap0, fc, (const int*)root_key, (const int*)first_of_root,
      (const int*)sizes, (const int*)slots, (int*)member_key,
      (int*)cluster_key);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_finalize_gather(long long fc, int S, const void* order,
                                 const void* sizes, const void* slots,
                                 const void* count, const void* vals,
                                 void* lens, void* csizes, void* cents,
                                 void* stream) {
  const int threads = 256;
  kl_fin_gather<<<kl_blocks(fc, threads), threads, 0, (cudaStream_t)stream>>>(
      fc, S, (const long long*)order, (const int*)sizes, (const int*)slots,
      (const int*)count, (const float*)vals, (int*)lens, (int*)csizes,
      (float*)cents);
  return (int)cudaGetLastError();
}
