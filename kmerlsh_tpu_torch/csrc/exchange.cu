// K8: the cross-shard exchange of one sharded iteration, on each rank.
//
// Replaces the device half of kmerlsh_tpu/parallel/dist.py
// _one_dist_iteration that moves state between the local and the global
// phase: the rotating window (_window_positions, dist.py:66, and the gather
// at :116-121), and the realignment, global parent fold and write-back
// after the replicated global chain collapse (_realign_to, dist.py:85, and
// :134-157). The local phase's parent fold (dist.py:112-113) runs in K3's
// epilogue (chain_collapse.cu, its parent shard offset by base). The
// all_gather between them is torch.distributed's.
//
// K8a exchange_window. alive = size > 0 over the rank's c columns; the
// window's entry j takes the alive column of rank (j + rot*e) mod n_local
// (or j when n_local <= e), in position order, and copies its values, size
// and slot. Entries past n_local are padding: pos = c, size 0, slot -1,
// values of column c - 1 (as the reference gathers them).
// Bound on the H100: device-memory bandwidth of the one read of sizes (4c
// bytes); the window itself is e·(S + 3) words. Two launches, no serial
// loop:
//   1. kl_win_masks: one block of 256 threads a chunk of cw mask words
//      (cw·32 columns; cw = 32 up to 2^23 columns, kernels.window_plan):
//      each thread reads 4 sizes as one 16-byte load (coalesced, read
//      once), 8 lanes OR their nibbles into a word, and the block writes
//      the chunk's alive count;
//   2. kl_win_gather: every block loads the nb chunk counts into shared
//      memory (coalesced, padded one word in 32 against bank conflicts) and
//      turns them into exclusive offsets by a block scan of warp shuffles
//      (n_local their total). One thread an entry, lanes over consecutive
//      entries: a binary search of the offsets in shared memory gives the
//      entry's chunk; the warp then reads each distinct chunk of its
//      entries once, 32 mask words a load, scans their popcounts by
//      shuffles, and each entry takes its word by a five-step search over
//      the lanes and its column by a select inside that word. The window's
//      ranks are consecutive, so a warp's 32 entries mostly share one or two
//      chunks. The copy keeps lanes over entries: each value row is read as
//      32 nearly consecutive columns and written as 128 contiguous bytes of
//      w_vals, so no staging tile is needed.
//
// K8b exchange_fold. The global phase leaves the gathered window sorted and
// collapsed, with head and last slot ids swapped. Valid slots are unique and
// each rank's slots lie in [base, base + c0_loc), so the realignment is a
// lookup. One launch of one thread-block cluster (KL_FOLD_CLUSTER blocks on
// neighbouring SMs):
//   1. for each global position q whose slot is this rank's,
//      inv[slot - base] = q;
//   2. a cluster barrier (release / acquire: the index's writes are seen by
//      every block of the cluster) in place of a second launch;
//   3. one thread a window entry j of this rank's slice, lanes over entries
//      (the columns pos[j] form a nearly contiguous run): q = inv[slot -
//      base], fold the global merge m_mi[q] into parent and write the merged
//      size and values back over column pos[j]. Padding entries (pos == c)
//      and slots of other ranks are dropped, never redirected to an index in
//      range.
// Bound: bandwidth of the n gathered slots, the window and its merged
// columns, e·(S + 4) + n words; it no longer reads the rank's c columns.
// inv needs no clearing: only entries written in step 1 are read in step 3.

#include <cooperative_groups.h>

#include "common.cuh"

#define KL_WIN_FULL 0xffffffffu
#define KL_WIN_MAX_CHUNKS 8192   // chunk offsets a gather block holds
#define KL_WIN_MASK_THREADS 256  // threads of a mask block: 4 columns each
#define KL_WIN_GATHER 256        // threads of a gather block
#define KL_FOLD_CLUSTER 8        // blocks of the fold's one cluster
#define KL_FOLD_THREADS 512

// the shared-memory slot of chunk offset i: one pad word every 32, so that
// threads scanning contiguous segments hit distinct banks
__device__ __forceinline__ int kl_pad(int i) { return i + (i >> 5); }

// bit position of the k-th (from 0) set bit of m; k < popc(m)
__device__ __forceinline__ int kl_select(unsigned m, int k) {
  int p = 0, n;
  n = __popc(m & 0xffffu);
  if (k >= n) { k -= n; p += 16; m >>= 16; }
  n = __popc(m & 0xffu);
  if (k >= n) { k -= n; p += 8; m >>= 8; }
  n = __popc(m & 0xfu);
  if (k >= n) { k -= n; p += 4; m >>= 4; }
  n = __popc(m & 0x3u);
  if (k >= n) { k -= n; p += 2; m >>= 2; }
  if (k >= (int)(m & 1u)) p += 1;
  return p;
}

__device__ __forceinline__ int kl_warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(KL_WIN_FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(KL_WIN_MASK_THREADS) kl_win_masks(
    const int* __restrict__ sizes, long long c, int cw, int vec,
    unsigned* __restrict__ masks, int* __restrict__ counts) {
  __shared__ int part[KL_WIN_MASK_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long w0 = (long long)blockIdx.x * cw;
  int n = 0;
  for (int g = 0; g < cw; g += 32) {   // 1024 columns, 4 a thread
    const long long i = ((w0 + g) << 5) + 4 * t;
    int4 v;
    if (vec && i + 3 < c) {
      v = __ldg(reinterpret_cast<const int4*>(sizes + i));
    } else {
      v.x = i < c ? sizes[i] : 0;
      v.y = i + 1 < c ? sizes[i + 1] : 0;
      v.z = i + 2 < c ? sizes[i + 2] : 0;
      v.w = i + 3 < c ? sizes[i + 3] : 0;
    }
    const unsigned nib = (v.x > 0) | (v.y > 0) << 1 | (v.z > 0) << 2 |
                         (v.w > 0) << 3;
    unsigned m = nib << (4 * (lane & 7));   // 8 lanes make one word
    m |= __shfl_xor_sync(KL_WIN_FULL, m, 1);
    m |= __shfl_xor_sync(KL_WIN_FULL, m, 2);
    m |= __shfl_xor_sync(KL_WIN_FULL, m, 4);
    if ((lane & 7) == 0) masks[w0 + g + (t >> 3)] = m;
    n += __popc(nib);
  }
  n = __reduce_add_sync(KL_WIN_FULL, n);
  if (lane == 0) part[warp] = n;
  __syncthreads();
  if (t == 0) {
    int tot = 0;
    for (int w = 0; w < KL_WIN_MASK_THREADS / 32; ++w) tot += part[w];
    counts[blockIdx.x] = tot;
  }
}

__global__ void __launch_bounds__(KL_WIN_GATHER) kl_win_gather(
    const float* __restrict__ values, long long ld, int S, long long c,
    const int* __restrict__ sizes, const int* __restrict__ slots,
    const unsigned* __restrict__ masks, const int* __restrict__ counts,
    int nb, int cw, int e, int rot, int* __restrict__ pos,
    float* __restrict__ w_vals, int* __restrict__ w_sizes,
    int* __restrict__ w_slots) {
  extern __shared__ int offs[];   // [kl_pad(nb) + 1]
  __shared__ int wsum[32];
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = T >> 5;

  // 1. the chunks' exclusive offsets: a coalesced load, then each thread
  //    scans a contiguous segment, the warps by shuffles
  for (int i = t; i < nb; i += T) offs[kl_pad(i)] = counts[i];
  __syncthreads();
  const int per = (nb + T - 1) / T;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += offs[kl_pad(i)];
  const int x = kl_warp_incl_scan(sum, lane);
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = kl_warp_incl_scan(lane < nw ? wsum[lane] : 0, lane);
    if (lane < nw) wsum[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp ? wsum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = offs[kl_pad(i)];
    offs[kl_pad(i)] = run;
    run += v;
  }
  const int n_local = wsum[nw - 1];
  __syncthreads();

  // 2. this thread's entry: its alive rank, the chunk that holds it (the
  //    largest b with offs[b] <= rank: never an empty chunk) and its rank
  //    inside the chunk
  const long long j = (long long)blockIdx.x * T + t;
  const bool ok = j < e && j < n_local;
  int b = 0, want = 0;
  if (ok) {
    const long long rank =
        n_local > e ? (j + (long long)rot * e) % (long long)n_local : j;
    int l = 0, h = nb - 1;
    while (l < h) {
      const int mid = (l + h + 1) >> 1;
      if (offs[kl_pad(mid)] <= rank) l = mid; else h = mid - 1;
    }
    b = l;
    want = (int)(rank - offs[kl_pad(l)]);
  }

  // 3. its column: the warp reads each distinct chunk of its entries once
  long long p = c;
  unsigned todo = __ballot_sync(KL_WIN_FULL, ok);
  while (todo) {
    const int bl = __shfl_sync(KL_WIN_FULL, b, __ffs(todo) - 1);
    const bool mine = ((todo >> lane) & 1) && b == bl;
    int rem = want;
    const unsigned* chunk = masks + (long long)bl * cw;
    for (int g = 0; g < cw; g += 32) {
      const unsigned m = chunk[g + lane];
      const int cnt = __popc(m);
      const int inc = kl_warp_incl_scan(cnt, lane);
      const int tot = __shfl_sync(KL_WIN_FULL, inc, 31);
      int w = 0;   // the first lane whose inclusive count exceeds rem
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(KL_WIN_FULL, inc, w + step - 1) <= rem) w += step;
      const unsigned word = __shfl_sync(KL_WIN_FULL, m, w);
      const int before = __shfl_sync(KL_WIN_FULL, inc - cnt, w);
      if (mine && rem >= 0 && rem < tot)
        p = (((long long)bl * cw + g + w) << 5) + kl_select(word, rem - before);
      rem -= tot;
      if (!__any_sync(KL_WIN_FULL, mine && rem >= 0)) break;
    }
    todo &= ~__ballot_sync(KL_WIN_FULL, mine);
  }

  // 4. the copy, lanes over entries
  if (j >= e) return;
  const long long pc = p < c ? p : c - 1;
  pos[j] = (int)p;
  w_sizes[j] = ok ? sizes[pc] : 0;
  w_slots[j] = ok ? slots[pc] : -1;
  const float* src = values + pc;
  float* dst = w_vals + j;
#pragma unroll 4
  for (int s = 0; s < S; ++s) dst[(long long)s * e] = __ldg(src + (long long)s * ld);
}

KL_EXPORT int kl_exchange_window(const void* values, long long ld, int S,
                                 long long c, const void* sizes,
                                 const void* slots, int e, int rot, int cw,
                                 void* scratch, void* pos, void* w_vals,
                                 void* w_sizes, void* w_slots, void* stream) {
  if (c < 1 || e < 1 || cw < 32 || (cw & (cw - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long words = (c + 31) / 32;
  const long long nb = (words + cw - 1) / cw;
  if (nb > KL_WIN_MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* masks = (unsigned*)scratch;   // [nb * cw], then counts [nb]
  int* counts = (int*)(masks + nb * cw);
  const int vec = ((unsigned long long)sizes & 15) == 0;   // int4 loads
  kl_win_masks<<<(unsigned)nb, KL_WIN_MASK_THREADS, 0, st>>>(
      (const int*)sizes, c, cw, vec, masks, counts);
  const int smem = 4 * ((int)nb + ((int)nb >> 5) + 1);
  kl_win_gather<<<kl_blocks(e, KL_WIN_GATHER), KL_WIN_GATHER, smem, st>>>(
      (const float*)values, ld, S, c, (const int*)sizes, (const int*)slots,
      masks, counts, (int)nb, cw, e, rot, (int*)pos, (float*)w_vals,
      (int*)w_sizes, (int*)w_slots);
  return (int)cudaGetLastError();
}

__global__ void __cluster_dims__(KL_FOLD_CLUSTER, 1, 1)
    __launch_bounds__(KL_FOLD_THREADS) kl_fold_kernel(
        const float* __restrict__ m_vals, int S, long long n,
        const int* __restrict__ m_sizes, const int* __restrict__ m_mi,
        const int* __restrict__ m_scs, const int* __restrict__ w_slots,
        const int* __restrict__ pos, int e, float* __restrict__ values,
        long long ld, long long c, int* __restrict__ sizes,
        int* __restrict__ parent, long long base, long long c0_loc,
        int* inv) {
  const long long T = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // 1. slot -> global position, for this rank's slots
  for (long long q = t0; q < n; q += T) {
    const int s = m_scs[q];
    const long long li = (long long)s - base;
    if (s >= 0 && li >= 0 && li < c0_loc) inv[li] = (int)q;
  }
  // 2. every block of the cluster sees the index
  __threadfence();
  cooperative_groups::this_cluster().sync();
  // 3. the global fold and the write-back, one thread a window entry
  for (long long j = t0; j < e; j += T) {
    const long long p = pos[j];
    const int ws = w_slots[j];
    const long long li = (long long)ws - base;
    if (p >= c || ws < 0 || li < 0 || li >= c0_loc) continue;
    const int q = __ldcg(inv + li);
    const int mi = m_mi[q];
    if (mi >= 0) parent[li] = mi;
    sizes[p] = m_sizes[q];
#pragma unroll 4
    for (int s = 0; s < S; ++s)
      values[(long long)s * ld + p] = m_vals[(long long)s * n + q];
  }
}

KL_EXPORT int kl_exchange_fold(const void* m_vals, int S, long long n,
                               const void* m_sizes, const void* m_mi,
                               const void* m_scs, const void* w_slots,
                               const void* pos, int e, void* values,
                               long long ld, long long c, void* sizes,
                               void* parent, long long base, long long c0_loc,
                               void* inv, void* stream) {
  if (e > 0)
    kl_fold_kernel<<<KL_FOLD_CLUSTER, KL_FOLD_THREADS, 0,
                     (cudaStream_t)stream>>>(
        (const float*)m_vals, S, n, (const int*)m_sizes, (const int*)m_mi,
        (const int*)m_scs, (const int*)w_slots, (const int*)pos, e,
        (float*)values, ld, c, (int*)sizes, (int*)parent, base, c0_loc,
        (int*)inv);
  return (int)cudaGetLastError();
}
