// K5: root resolution and membership grouping, once per session.
//
// Replaces kmerlsh_tpu/cluster/engine.py _finalize_grouped (with _fwd_fill
// and its slot-map and segment scatters). The reference resolves roots by
// `jumps` rounds of pointer doubling over the whole parent array and groups
// rows with two stable sorts and log-step fills. Here, over rows r < cap0,
// state columns i < fc and sorted positions p, with no atomics:
//   1. link = a copy of parent (cudaMemcpyAsync);
//   2. kl_fin_mark: link[slot] |= FLAG for each alive column: the flag marks
//      the alive roots;
//   3. kl_fin_roots: one thread per row chases link to its root; key[r] =
//      the root if it carries the flag, else cap0. Writing each resolved
//      root back over link[r] and link[parent], so that later chases stop
//      early, made the call 0.36 ms slower at 2^24 rows (PERF.md): a
//      session's forest is a few links deep, and the writes cost more than
//      the loads they save;
//   4. K9 sort_keys(key) (csrc/sort_keys.cu), in the wrapper: rows by root,
//      an int32 row id each. Within a root's segment the rows ascend, so its
//      first row is the cluster's smallest member and its length the member
//      count; dead-rooted rows come last;
//   5. kl_fin_heads: each alive segment's first position writes
//      link[root] = -(start + 1), its last position end[root] = its end;
//   6. kl_fin_clusters: each alive column whose slot is a root finds its
//      segment through link[slot] and takes its first member as its cluster
//      key, its length and its start; the others take cap0 and 0;
//   7. K9 sort_keys of the cluster keys, in the wrapper: the cluster order
//      (int32), clusters by smallest member;
//   8. the columns in cluster order, row-major, as the caller takes them:
//      K2's transpose launch (csrc/permute_state.cu) puts each column's S
//      values, size and length in a whole row of a scratch [fc, W]; then
//      kl_fin_gather: row k of the centroids [fc, S] is scratch row
//      order[k]'s values (zeros for a dead column), sizes[k] its size as
//      int64, lens[k] its length;
//   9. kl_fin_block_sums, kl_fin_scan, kl_fin_place: an exclusive scan of
//      the lengths in cluster order gives each cluster's offset in flat;
//      link[root] = offset - start;
//  10. kl_fin_scatter: flat[p + link[root]] = the row at p (int64) for
//      positions of alive segments, flat[p] for the dead-rooted tail.
// The outputs equal the plain version's (kernels.finalize_plain) bit for
// bit for state columns with distinct slots, as a session's are. Link
// values: a row id, a row id with FLAG (an alive root, from step 2), a
// segment start below 0 (after step 5), an offset difference (after step 9);
// each step reads link only where the step before left the meaning it needs.
// The centroids leave row-major and the ids int64 so that the host takes
// them as they are copied, with no transpose and no widening.
//
// Bound on the H100: the rows' sort and the dependent loads of the chases
// in step 3 (a warp waits for its deepest lane); every other step is one
// pass over [cap0] or [fc] with a gather of fc entries (step 8: of whole
// scratch rows, in 16-byte pieces).

#include "common.cuh"

#define KL_FIN_FLAG ((int)0x80000000)
#define KL_FIN_CHUNK 1024   // clusters of one block of the offset scan
#define KL_FIN_MOVE_THREADS 256   // threads of a kl_fin_gather block

__global__ void kl_fin_mark(long long fc, const int* __restrict__ sizes,
                            const int* __restrict__ slots,
                            int* __restrict__ link) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < fc && sizes[i] > 0) link[slots[i]] |= KL_FIN_FLAG;
}

__global__ void kl_fin_roots(long long cap0, const int* __restrict__ link,
                             int* __restrict__ key) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap0) return;
  int x = (int)r;
  int p = link[x];
  for (long long step = 0; (p & ~KL_FIN_FLAG) != x && step < cap0; ++step) {
    x = p & ~KL_FIN_FLAG;
    p = link[x];
  }
  // x is the root and p its entry, flagged if the root is alive
  key[r] = (p & KL_FIN_FLAG) ? x : (int)cap0;
}

__global__ void kl_fin_heads(long long cap0, const int* __restrict__ skey,
                             int* __restrict__ link, int* __restrict__ end) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap0) return;
  const int k = skey[p];
  if (k == (int)cap0) return;
  if (p == 0 || skey[p - 1] != k) link[k] = -(int)(p + 1);
  if (p == cap0 - 1 || skey[p + 1] != k) end[k] = (int)(p + 1);
}

__global__ void kl_fin_clusters(long long fc, int cap0,
                                const int* __restrict__ sizes,
                                const int* __restrict__ slots,
                                const int* __restrict__ link,
                                const int* __restrict__ end,
                                const int* __restrict__ rows,
                                int* __restrict__ ckey, int* __restrict__ clen,
                                int* __restrict__ cstart) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= fc) return;
  int key = cap0, len = 0, start = 0;
  if (sizes[i] > 0) {
    const int s = slots[i];
    const int v = link[s];
    // an alive root: its segment's start in [-cap0, -1]; a slot that is no
    // root keeps its flagged parent, below -cap0 (cap0 <= 2^30), and gets
    // no cluster, as in the plain version
    if (v < 0 && v >= -cap0) {
      start = -v - 1;
      len = end[s] - start;
      key = rows[start];
    }
  }
  ckey[i] = key;
  clen[i] = len;
  cstart[i] = start;
}

__global__ void __launch_bounds__(KL_FIN_CHUNK)
    kl_fin_block_sums(long long fc, const int* __restrict__ lens,
                      int* __restrict__ sums) {
  const long long k = (long long)blockIdx.x * KL_FIN_CHUNK + threadIdx.x;
  int total;
  kl_block_scan(k < fc ? lens[k] : 0, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: the block sums into exclusive offsets, in place.
__global__ void __launch_bounds__(KL_FIN_CHUNK)
    kl_fin_scan(int* __restrict__ sums, int nb) {
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += KL_FIN_CHUNK) {
    const int b = b0 + threadIdx.x;
    int total;
    const int before = kl_block_scan(b < nb ? sums[b] : 0, &total);
    if (b < nb) sums[b] = carry + before;
    carry += total;
    __syncthreads();
  }
}

// Step 8's gather: a block takes C consecutive cluster rows k, reads each
// order[k] once, copies the W words of each source row of the scratch into
// shared memory with 16-byte cp.async (rows of kl_stage_ld(W) words, as
// K2's gather tile), and writes its n rows of centroids, which are n * S contiguous
// words, coalesced: word j of the run is (row j / S, value j % S).
__global__ void __launch_bounds__(KL_FIN_MOVE_THREADS) kl_fin_gather(
    const unsigned* __restrict__ scr, int S, long long fc,
    const int* __restrict__ order, int W, int C,
    unsigned* __restrict__ cents, long long* __restrict__ csizes,
    int* __restrict__ lens) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ord = (int*)smem;                        // [C]
  unsigned* tile = (unsigned*)(smem + 4 * C);   // [C][kl_stage_ld(W)]
  const int t = threadIdx.x, ldt = kl_stage_ld(W);
  const long long k0 = (long long)blockIdx.x * C;
  const int n = (int)min((long long)C, fc - k0);
  kl_stage_rows<KL_FIN_MOVE_THREADS>(scr, W, order + k0, n, ord, tile);
  if (t < n) {   // C <= KL_FIN_MOVE_THREADS: a thread a row
    csizes[k0 + t] = (int)tile[t * ldt + S];
    lens[k0 + t] = (int)tile[t * ldt + S + 1];
  }
  unsigned* dst = cents + k0 * S;
  const int dc = KL_FIN_MOVE_THREADS / S, ds = KL_FIN_MOVE_THREADS % S;
  int c = t / S, s = t % S;
  for (int j = t; j < n * S; j += KL_FIN_MOVE_THREADS) {
    const unsigned* row = tile + c * ldt;
    dst[j] = row[S] == 0 ? 0u : row[s];   // a dead column's row is zeros
    c += dc;
    s += ds;
    if (s >= S) {
      s -= S;
      ++c;
    }
  }
}

__global__ void __launch_bounds__(KL_FIN_CHUNK)
    kl_fin_place(long long fc, const int* __restrict__ order,
                 const int* __restrict__ slots,
                 const int* __restrict__ cstart, const int* __restrict__ lens,
                 const int* __restrict__ sums, int* __restrict__ link) {
  const long long k = (long long)blockIdx.x * KL_FIN_CHUNK + threadIdx.x;
  const int len = k < fc ? lens[k] : 0;
  int total;
  const int off = sums[blockIdx.x] + kl_block_scan(len, &total);
  if (k < fc && len > 0) {
    const int i = order[k];
    link[slots[i]] = off - cstart[i];
  }
}

__global__ void kl_fin_scatter(long long cap0, const int* __restrict__ skey,
                               const int* __restrict__ rows,
                               const int* __restrict__ link,
                               long long* __restrict__ flat) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap0) return;
  const int k = skey[p];
  const long long d = k == (int)cap0 ? 0 : link[k];
  flat[p + d] = rows[p];
}

// Steps 1-3: link and the rows' sort key.
KL_EXPORT int kl_finalize_roots(long long cap0, long long fc,
                                const void* sizes, const void* slots,
                                const void* parent, void* link, void* key,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  cudaError_t err = cudaMemcpyAsync(link, parent, (size_t)cap0 * sizeof(int),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (fc > 0)
    kl_fin_mark<<<kl_blocks(fc, threads), threads, 0, st>>>(
        fc, (const int*)sizes, (const int*)slots, (int*)link);
  kl_fin_roots<<<kl_blocks(cap0, threads), threads, 0, st>>>(
      cap0, (const int*)link, (int*)key);
  return (int)cudaGetLastError();
}

// Steps 5-6, on the rows sorted by key (skey, rows).
KL_EXPORT int kl_finalize_segments(long long cap0, long long fc,
                                   const void* skey, const void* rows,
                                   const void* sizes, const void* slots,
                                   void* link, void* end, void* ckey,
                                   void* clen, void* cstart, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  kl_fin_heads<<<kl_blocks(cap0, threads), threads, 0, st>>>(
      cap0, (const int*)skey, (int*)link, (int*)end);
  if (fc > 0)
    kl_fin_clusters<<<kl_blocks(fc, threads), threads, 0, st>>>(
        fc, (int)cap0, (const int*)sizes, (const int*)slots,
        (const int*)link, (const int*)end, (const int*)rows,
        (int*)ckey, (int*)clen, (int*)cstart);
  return (int)cudaGetLastError();
}

// Step 8 for fc > 0 columns (values [S, fc], sizes, clen) and the cluster
// order: cents [fc, S], csizes (int64) and lens. W, C and smem are
// kernels.permute_plan(S, fc)'s; scratch holds fc * W ints.
KL_EXPORT int kl_finalize_columns(int S, long long fc, const void* values,
                                  const void* sizes, const void* clen,
                                  const void* order, int W, int C, int smem,
                                  void* scratch, void* cents, void* csizes,
                                  void* lens, void* stream) {
  if (W < S + 2 || W % 8 != 0 || C < 32 || C > KL_FIN_MOVE_THREADS ||
      KL_FIN_MOVE_THREADS % C != 0 || smem != 4 * C + 4 * C * (W + 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = kl_permute_to_scratch(values, fc, S, fc, sizes, clen, W, C, smem,
                                  scratch, st);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kl_fin_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kl_fin_gather<<<kl_blocks(fc, C), KL_FIN_MOVE_THREADS, smem, st>>>(
      (const unsigned*)scratch, S, fc, (const int*)order, W, C,
      (unsigned*)cents, (long long*)csizes, (int*)lens);
  return (int)cudaGetLastError();
}

// Steps 9-10, on the cluster order and the lengths in it; sums holds
// ceil(fc / KL_FIN_CHUNK) ints, flat cap0 int64.
KL_EXPORT int kl_finalize_place(long long cap0, long long fc,
                                const void* order, const void* slots,
                                const void* cstart, const void* lens,
                                const void* skey, const void* rows,
                                void* sums, void* link, void* flat,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (fc > 0) {
    const int nb = (int)((fc + KL_FIN_CHUNK - 1) / KL_FIN_CHUNK);
    kl_fin_block_sums<<<nb, KL_FIN_CHUNK, 0, st>>>(fc, (const int*)lens,
                                                   (int*)sums);
    kl_fin_scan<<<1, KL_FIN_CHUNK, 0, st>>>((int*)sums, nb);
    kl_fin_place<<<nb, KL_FIN_CHUNK, 0, st>>>(
        fc, (const int*)order, (const int*)slots, (const int*)cstart,
        (const int*)lens, (const int*)sums, (int*)link);
  }
  const int threads = 256;
  kl_fin_scatter<<<kl_blocks(cap0, threads), threads, 0, st>>>(
      cap0, (const int*)skey, (const int*)rows, (const int*)link,
      (long long*)flat);
  return (int)cudaGetLastError();
}
