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
// Bound on the H100: the latency of dependent loads. A part is 2^16 reads
// of ~150 bp, ~7.9 M windows, against a key set of up to a few million
// keys. A plain lower-bound search over all D keys makes ~log2(D) + 1
// dependent probes a window, each into its own 32-byte sector. Two
// kernels cut that chain:
//
//   * kl_key_directory_kernel, once per key set: a prefix directory of
//     2^bits + 1 int32 lower bounds over the top ``bits`` bits of the key
//     (dir[p] = the first key whose top bits are >= p), one thread per
//     entry searching the keys. Adjacent threads search adjacent prefixes,
//     so a warp's probes share their sectors. The wrapper takes bits =
//     ceil(log2 D) within [16, 22], about one key a bucket: at 2^22 keys
//     the 16 MB directory and the 32 MB of keys both fit the 50 MB L2.
//   * kl_score_reads_kernel: one warp per read. The warp copies the codes
//     of up to kChunk windows of its read once, coalesced, into shared
//     memory; each lane then builds kPerLane windows' k-mers from there,
//     issues the directory loads of all of them (two neighbouring entries,
//     one sector mostly), and runs their lower-bound searches inside their
//     buckets in lockstep, so that kPerLane independent key loads are in
//     flight a lane. A bucket holds D / 2^bits keys on average (skewed to
//     small prefixes by the canonical min), a sector or two of keys; a
//     crowded bucket costs more probes, never a wrong answer. The warp's
//     hit counts are reduced by one shuffle reduction.
//
// The search records whether the probe that last lowered ``hi`` found the
// query: that probe sits at the final lower bound, so no extra load tells a
// hit from a miss.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                   // reads a block, a warp each
constexpr int kPerLane = 5;                 // windows a lane has in flight
constexpr int kChunk = 32 * kPerLane;       // windows a warp pass covers
constexpr int kSpan = kChunk + 32;          // codes of a pass (k <= 31)
constexpr int kDirThreads = 256;

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

__global__ void __launch_bounds__(kDirThreads)
    kl_key_directory_kernel(const unsigned long long* __restrict__ keys,
                            int D, int bits, int* __restrict__ dir) {
  const long long p = (long long)blockIdx.x * kDirThreads + threadIdx.x;
  const long long n_dir = 1LL << bits;
  if (p > n_dir) return;
  int lo = 0;
  if (p == n_dir) {
    lo = D;
  } else {
    const unsigned long long least = (unsigned long long)p << (64 - bits);
    int hi = D;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (__ldg(keys + mid) < least)
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  dir[p] = lo;
}

__global__ void __launch_bounds__(kWarps * 32)
    kl_score_reads_kernel(const unsigned char* __restrict__ codes,
                          const int* __restrict__ win_start,
                          const int* __restrict__ n_win,
                          const int* __restrict__ lens, int n,
                          const unsigned long long* __restrict__ keys,
                          const int* __restrict__ dir, int shift, int k,
                          float vote, unsigned char* __restrict__ out) {
  __shared__ unsigned char span[kWarps][kSpan];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= n) return;           // whole warps leave; no block barrier below
  const int nw = n_win[r], len = lens[r];
  if (nw <= 0 || len < k + 10) {
    if (lane == 0) out[r] = 0;
    return;
  }
  const unsigned char* src = codes + win_start[r];
  unsigned char* buf = span[warp];
  int hits = 0;
  for (int base = 0; base < nw; base += kChunk) {
    const int cnt = min(kChunk, nw - base);
    __syncwarp();
    for (int t = lane; t < cnt + k - 1; t += 32) buf[t] = __ldg(src + base + t);
    __syncwarp();

    unsigned long long q[kPerLane];
    int lo[kPerLane], hi[kPerLane];
    bool eq[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int w = lane + 32 * j;
      lo[j] = hi[j] = 0;
      eq[j] = false;
      q[j] = 0;
      if (w < cnt) {
        unsigned long long x = 0;
        for (int i = 0; i < k; ++i)
          x |= (unsigned long long)buf[w + i] << (2 * i);
        const unsigned long long rc = reverse_bases64(~x) >> (64 - 2 * k);
        const unsigned long long kf = bswap64(x), kr = bswap64(rc);
        q[j] = kf < kr ? kf : kr;
        const int p = (int)(q[j] >> shift);
        lo[j] = __ldg(dir + p);
        hi[j] = __ldg(dir + p + 1);
      }
    }
    for (;;) {
      unsigned long long v[kPerLane];
      int mid[kPerLane];
      bool busy = false;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        mid[j] = (int)(((unsigned)lo[j] + (unsigned)hi[j]) >> 1);
        v[j] = lo[j] < hi[j] ? __ldg(keys + mid[j]) : 0ULL;
        busy |= lo[j] < hi[j];
      }
      if (!busy) break;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (lo[j] < hi[j]) {
          if (v[j] < q[j]) {
            lo[j] = mid[j] + 1;
          } else {
            hi[j] = mid[j];
            eq[j] = v[j] == q[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) hits += eq[j];
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0)
    out[r] = __fdiv_rn((float)hits, (float)(len - k + 1)) > vote ? 1 : 0;
}

}  // namespace

KL_EXPORT int kl_key_directory(const void* keys, int D, int bits, void* dir,
                               void* stream) {
  const long long n_dir = (1LL << bits) + 1;
  kl_key_directory_kernel<<<kl_blocks(n_dir, kDirThreads), kDirThreads, 0,
                            (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, D, bits, (int*)dir);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_score_reads(const void* codes, const void* win_start,
                             const void* n_win, const void* lens, int n,
                             const void* keys, const void* dir, int bits,
                             int k, float vote, void* out, void* stream) {
  kl_score_reads_kernel<<<kl_blocks(n, kWarps), kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const int*)win_start, (const int*)n_win,
      (const int*)lens, n, (const unsigned long long*)keys, (const int*)dir,
      64 - bits, k, vote, (unsigned char*)out);
  return (int)cudaGetLastError();
}
