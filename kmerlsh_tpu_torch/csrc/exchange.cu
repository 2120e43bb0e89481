// K8: the cross-shard exchange of one sharded iteration, on each rank.
//
// Replaces the device half of kmerlsh_tpu/parallel/dist.py
// _one_dist_iteration that moves state between the local and the global
// phase: the rotating window (_window_positions, dist.py:66, and the gather
// at :116-121), and the realignment, parent fold and write-back after the
// replicated global chain collapse (_realign_to, dist.py:85, and :134-157).
// The all_gather between them is torch.distributed's.
//
// K8a exchange_window. alive = size > 0 over the rank's c columns; the
// window's entry j takes the alive column of rank (j + rot*e) mod n_local
// (or j when n_local <= e), in position order, and copies its values, size
// and slot. Entries past n_local are padding: pos = c, size 0, slot -1,
// values of column c - 1 (as the reference gathers them).
//   1. kl_win_count: one block of 1024 threads per 1024 columns counts its
//      alive columns (__syncthreads_count);
//   2. kl_win_scan: one block turns the counts into exclusive offsets in
//      place, offs[nb] = n_local;
//   3. kl_win_gather: one warp per window entry binary-searches the offsets
//      for its 1024-column chunk, then walks the chunk 32 columns at a time
//      with __ballot_sync / __popc to the wanted alive column, and copies it.
// Bound on the H100: device-memory bandwidth of the one read of sizes (4c
// bytes); the window itself is e·(S + 3) words.
//
// K8b exchange_fold. The global phase leaves the gathered window sorted and
// collapsed, with head and last slot ids swapped. Valid slots are unique and
// each rank's slots lie in [base, base + c0_loc), so the realignment is a
// lookup:
//   1. kl_fold_index: for each global position q whose slot is this rank's,
//      inv[slot - base] = q;
//   2. kl_fold_apply: blocks [0, nb_local) fold the local phase's merges,
//      parent[slot - base] = mi where mi >= 0; the remaining blocks take one
//      window entry j of this rank's slice each: q = inv[slot - base], fold
//      the global merge m_mi[q] into parent and write the merged size and
//      values back over column pos[j]. Padding entries (pos == c) and slots
//      of other ranks are dropped, never redirected to an index in range.
// Bound: bandwidth of the reads of the local slots and merged_into (8c
// bytes); the window part moves e·(S + 4) words. inv needs no clearing: only
// entries written in step 1 are read in step 2.

#include "common.cuh"

#define KL_WIN_CHUNK 1024

__global__ void kl_win_count(const int* __restrict__ sizes, long long c,
                             int* __restrict__ counts) {
  long long i = (long long)blockIdx.x * KL_WIN_CHUNK + threadIdx.x;
  int alive = (i < c) && sizes[i] > 0;
  int n = __syncthreads_count(alive);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

__global__ void kl_win_scan(int* __restrict__ offs, int nb) {
  __shared__ int part[1024];
  const int T = blockDim.x, t = threadIdx.x;
  const int per = (nb + T - 1) / T;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += offs[i];
  part[t] = sum;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int i = 0; i < T; ++i) {
      int v = part[i];
      part[i] = run;
      run += v;
    }
    offs[nb] = run;
  }
  __syncthreads();
  int run = part[t];
  for (int i = lo; i < hi; ++i) {
    int v = offs[i];
    offs[i] = run;
    run += v;
  }
}

__global__ void kl_win_gather(const float* __restrict__ values, long long ld,
                              int S, long long c,
                              const int* __restrict__ sizes,
                              const int* __restrict__ slots,
                              const int* __restrict__ offs, int nb, int e,
                              int rot, int* __restrict__ pos,
                              float* __restrict__ w_vals,
                              int* __restrict__ w_sizes,
                              int* __restrict__ w_slots) {
  const int lane = threadIdx.x & 31;
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (j >= e) return;   // whole warps leave together: e is per warp
  const int n_local = offs[nb];
  const bool ok = j < n_local;
  long long p = c;
  if (ok) {
    long long rank = n_local > e
        ? ((long long)j + (long long)rot * e) % (long long)max(n_local, 1) : j;
    int lo = 0, hi = nb - 1;   // largest b with offs[b] <= rank
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (offs[mid] <= rank) lo = mid; else hi = mid - 1;
    }
    int want = (int)(rank - offs[lo]);
    const long long base = (long long)lo * KL_WIN_CHUNK;
    for (int k = 0; k < KL_WIN_CHUNK; k += 32) {
      long long i = base + k + lane;
      bool a = i < c && sizes[i] > 0;
      unsigned m = __ballot_sync(0xffffffffu, a);
      int cnt = __popc(m);
      if (want < cnt) {
        int before = __popc(m & ((1u << lane) - 1u));
        unsigned hit = __ballot_sync(0xffffffffu, a && before == want);
        p = base + k + (__ffs(hit) - 1);
        break;
      }
      want -= cnt;
    }
  }
  const long long pc = p < c ? p : c - 1;
  if (lane == 0) {
    pos[j] = (int)p;
    w_sizes[j] = ok ? sizes[pc] : 0;
    w_slots[j] = ok ? slots[pc] : -1;
  }
  for (int s = lane; s < S; s += 32)
    w_vals[(long long)s * e + j] = values[(long long)s * ld + pc];
}

KL_EXPORT int kl_exchange_window(const void* values, long long ld, int S,
                                 long long c, const void* sizes,
                                 const void* slots, int e, int rot,
                                 void* offs, void* pos, void* w_vals,
                                 void* w_sizes, void* w_slots,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nb = (int)((c + KL_WIN_CHUNK - 1) / KL_WIN_CHUNK);
  kl_win_count<<<nb, KL_WIN_CHUNK, 0, st>>>((const int*)sizes, c, (int*)offs);
  kl_win_scan<<<1, 1024, 0, st>>>((int*)offs, nb);
  const int threads = 256;   // 8 warps, one window entry each
  kl_win_gather<<<kl_blocks((long long)e * 32, threads), threads, 0, st>>>(
      (const float*)values, ld, S, c, (const int*)sizes, (const int*)slots,
      (const int*)offs, nb, e, rot, (int*)pos, (float*)w_vals, (int*)w_sizes, (int*)w_slots);
  return (int)cudaGetLastError();
}

__global__ void kl_fold_index(long long n, const int* __restrict__ m_scs,
                              long long base, long long c0_loc,
                              int* __restrict__ inv) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  long long li = (long long)m_scs[q] - base;
  if (m_scs[q] >= 0 && li >= 0 && li < c0_loc) inv[li] = (int)q;
}

__global__ void kl_fold_apply(
    unsigned nb_local, long long c, int S, const int* __restrict__ slots,
    const int* __restrict__ mi, const float* __restrict__ m_vals, long long n,
    const int* __restrict__ m_sizes, const int* __restrict__ m_mi,
    const int* __restrict__ w_slots, const int* __restrict__ pos, int e,
    const int* __restrict__ inv, long long base, long long c0_loc,
    float* __restrict__ values, long long ld, int* __restrict__ sizes,
    int* __restrict__ parent) {
  if (blockIdx.x < nb_local) {   // the local phase's merges
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c || mi[i] < 0) return;
    long long li = (long long)slots[i] - base;
    if (li >= 0 && li < c0_loc) parent[li] = mi[i];
    return;
  }
  long long j = (long long)(blockIdx.x - nb_local) * blockDim.x + threadIdx.x;
  if (j >= e) return;
  long long p = pos[j];
  if (p >= c) return;   // padding
  long long li = (long long)w_slots[j] - base;
  if (w_slots[j] < 0 || li < 0 || li >= c0_loc) return;
  int q = inv[li];
  if (m_mi[q] >= 0) parent[li] = m_mi[q];
  sizes[p] = m_sizes[q];
  for (int s = 0; s < S; ++s)
    values[(long long)s * ld + p] = m_vals[(long long)s * n + q];
}

KL_EXPORT int kl_exchange_fold(const void* m_vals, int S, long long n,
                               const void* m_sizes, const void* m_mi,
                               const void* m_scs, const void* w_slots,
                               const void* pos, int e, void* values,
                               long long ld, long long c, void* sizes,
                               const void* slots, const void* mi,
                               void* parent, long long base, long long c0_loc,
                               void* inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (n > 0)
    kl_fold_index<<<kl_blocks(n, threads), threads, 0, st>>>(
        n, (const int*)m_scs, base, c0_loc, (int*)inv);
  unsigned nb_local = kl_blocks(c, threads);
  unsigned nb = nb_local + kl_blocks(e, threads);
  if (nb > 0)
    kl_fold_apply<<<nb, threads, 0, st>>>(
        nb_local, c, S, (const int*)slots, (const int*)mi,
        (const float*)m_vals, n, (const int*)m_sizes, (const int*)m_mi,
        (const int*)w_slots, (const int*)pos, e, (const int*)inv, base,
        c0_loc, (float*)values, ld, (int*)sizes, (int*)parent);
  return (int)cudaGetLastError();
}
