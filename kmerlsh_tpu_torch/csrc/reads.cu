// K7: the device read scorer of mode E.
//
// Replaces kmerlsh_tpu/ops/reads.py _device_score_kernel: every window of
// every read of a part gives a k-mer (non-ACGT bases code as A), its
// canonical memcmp key min(bswap64(x), bswap64(revcomp(x))) is looked up
// in the sorted differential key set, and a read is selected iff
// len >= k+10, it has a window, and hits / (len - k + 1) > vote in float32
// (the reference's device rule, reads.py:209-211). The reference splits
// keys into (hi, lo) uint32 pairs because JAX runs without x64; here keys
// are native unsigned 64-bit integers.
//
// Bound on the H100: latency of the scattered loads of the binary search.
// A part is 2^16 reads of ~150 bp, ~7.9 M windows; each window makes
// ~log2(D) + 1 dependent probes into a key set of up to a few million
// keys (tens of MB, around the size of the 50 MB L2), so the top levels of
// the search stay in L2 and the last levels go to HBM. The design keeps
// many searches in flight: one block per read and one thread per window,
// striding over the read's windows, so that all of a part's windows are
// resident at once; a block reduction of the per-thread hit counts then
// gives the read's vote. With one block per read, the reference's pad-
// window mask and cumulative-sum differences are not needed: a block only
// visits its own read's windows.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ unsigned long long bswap64(unsigned long long v) {
  const unsigned lo = (unsigned)v, hi = (unsigned)(v >> 32);
  return ((unsigned long long)__byte_perm(lo, 0, 0x0123) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// reverse the 32 2-bit groups of v (kmer/codec.py reverse_bases64)
__device__ __forceinline__ unsigned long long reverse_bases64(
    unsigned long long v) {
  const unsigned long long m2 = 0x3333333333333333ULL;
  const unsigned long long m4 = 0x0F0F0F0F0F0F0F0FULL;
  v = ((v >> 2) & m2) | ((v & m2) << 2);
  v = ((v >> 4) & m4) | ((v & m4) << 4);
  return bswap64(v);
}

__global__ void __launch_bounds__(kThreads)
    kl_score_reads_kernel(const unsigned char* __restrict__ codes,
                          const int* __restrict__ win_start,
                          const int* __restrict__ n_win,
                          const int* __restrict__ lens,
                          const unsigned long long* __restrict__ keys,
                          long long D, int k, float vote,
                          unsigned char* __restrict__ out) {
  const int r = blockIdx.x;
  const int nw = n_win[r];
  const long long ws = win_start[r];
  int hits = 0;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const unsigned char* p = codes + ws + w;
    unsigned long long x = 0;
    for (int j = 0; j < k; ++j) x |= (unsigned long long)p[j] << (2 * j);
    const unsigned long long rc = reverse_bases64(~x) >> (64 - 2 * k);
    const unsigned long long kf = bswap64(x), kr = bswap64(rc);
    const unsigned long long q = kf < kr ? kf : kr;
    long long lo = 0, hi = D;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < q)
        lo = mid + 1;
      else
        hi = mid;
    }
    hits += lo < D && __ldg(keys + lo) == q;
  }
  for (int off = 16; off > 0; off >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  __shared__ int warp_hits[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_hits[i];
    const int len = lens[r];
    const bool sel =
        len >= k + 10 && nw > 0 &&
        __fdiv_rn((float)total, (float)(len - k + 1)) > vote;
    out[r] = sel ? 1 : 0;
  }
}

}  // namespace

KL_EXPORT int kl_score_reads(const void* codes, const void* win_start,
                             const void* n_win, const void* lens, int n,
                             const void* keys, long long D, int k, float vote,
                             void* out, void* stream) {
  kl_score_reads_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const int*)win_start, (const int*)n_win,
      (const int*)lens, (const unsigned long long*)keys, D, k, vote,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}
