// K10: pairing-merge rounds over the sorted state.
//
// Replaces the rounds loop of kmerlsh_tpu/cluster/engine.py:168
// pairing_merge (:220-270; segment.segment_starts, the alive ranks by
// cumsum, the nearest alive neighbours by cummax/cummin). The state is
// already in sorted order (lsh_keys, sort_keys, permute_state). In round r
// (ph = r mod 2), within each segment of equal key >> shift, the alive
// elements of rank 2j + ph and 2j + 1 + ph pair up; a pair whose cosine
// reaches the threshold merges into the left one: its values become the
// size-weighted mean, its size the sum. The right one dies: size 0,
// merged_into = the left's slot, and parent[slot - base] = the left's slot
// where a parent is given. Alive: size > 0 and key != BIG_KEY. Pairs never
// cross segments, so segments are independent of each other.
//
// Two launches a call (and a 4-byte memset of the list's count before):
//   (1) kl_pair_short runs every round of every segment of at most C
//       positions in shared memory. Block b owns the segments whose first
//       position lies in its window [b C, (b + 1) C). It reads the keys of
//       [b C - 1, b C + 2 C) and, meanwhile, copies the window's columns
//       (most of its range). From the keys it finds its first start and
//       where its last segment ends, if that one is short. Its range, from
//       its first start to the end of its last short segment, is at most
//       2 C - 1 positions; it copies the rest of the range's columns, its
//       sizes, sets its start/valid flags, and runs the R rounds there. A
//       block scan of each thread's run (start seen, alive count after it,
//       last alive position) gives each alive position its rank and the
//       alive position before it; a second scan packs the right-role
//       elements' pairs into a list, which the threads share evenly (a
//       thread walking its own items would leave its warp's lanes to take
//       their pairs in turns). It stops after two rounds without a merge
//       (the next round would pair as the one two before) and writes back
//       once: the sizes that changed and the columns that absorbed a merge
//       (a warp a value row). A dying element writes its merged_into and
//       parent entry when it dies. A block whose last segment is
//       longer than C appends that segment's start to a list (an atomic
//       count) and records its window's first start, from which launch
//       (2) finds where the segment ends. No carry, look-back or order
//       between blocks: a segment belongs to exactly one of them. The
//       copies are cp.async, 16 bytes where M is a multiple of 4 and the
//       values 16-byte aligned (every row then starts aligned), 4 bytes
//       otherwise: a range starts at any position and has any length up
//       to 2 C - 1, one copy a block, which needs no tensor map
//       (cuTensorMapEncodeTiled) as TMA would.
//   (2) kl_pair_long, one cooperative launch, takes the listed segments
//       (or, at C = 0, where S is too wide for 32 positions a window, the
//       whole array as one range). It exits at once when the list is
//       empty, so the host never waits on a device value. Otherwise it
//       finds each range's end (the next window's first start) and its
//       tiles of KL_LONG_TILE positions; a grid-wide sync. A range of one
//       tile runs every round in one block, in device memory, as the
//       earlier three-launch design did. The tiles of longer ranges get
//       their bases (a grid sync), and per round (a) each block reduces
//       its contiguous chunk of tiles to segmented aggregates, a grid
//       sync, (b) each block's carry from the chunks before it, and each
//       tile's ranks and right-role pairs, applied in device memory; a
//       grid sync between rounds. A tile found with no alive element skips later rounds'
//       staging. Its loads of sizes and values go past the L1 (other
//       blocks wrote them in this launch).
// Race-free without atomics on the state: within a round each position is
// in at most one pair, a left is read and written only by its right, only
// a right changes its own alive state, and a left's size stays positive,
// so a block that stages it before or after its right's write sees it
// alive.
//
// Bit equality with the plain version (kernels.pairing_rounds_plain): the
// dot product and both norms are summed over s = 0, 1, ... with separately
// rounded products and sums (__fmul_rn, __fadd_rn: no contraction into
// FMA), the square root and divisions are IEEE, and the merged mean is
// (v_l * float(s_l) + v_r * float(s_r)) / float(s_l + s_r) as the
// reference writes it (engine.py:263-270).
//
// Bound on the H100: device-memory bandwidth. The least the card moves is
// one read of each alive column, size and key and one write of each
// changed column (S 32-byte sectors: its values lie M apart), size,
// merged_into and parent entry (chip_smoke.pairing_floor_bytes). Launch
// (1) reads the keys about twice (its window and the next) and the
// columns once; launch (2) reads its columns once a pair formed, as the
// earlier three-launch design (tools/kernel_variants.py pairing times
// both) did everywhere.

#include <cooperative_groups.h>

#include "common.cuh"

#define KL_PAIR_THREADS 512       // threads of a short-segment block
#define KL_PAIR_PER_SM 2          // short-segment blocks a SM, where they fit
#define KL_PAIR_CAP_MAX 2048      // C, positions a window, at most
#define KL_PAIR_POS_BYTES(S) (4 * (S) + 11)
// values [S][2C + 4], sizes and keys [2C + 4], pairs [C + 2], flags [2C + 4]
#define KL_PAIR_SMEM(C, S) ((2 * (C) + 4) * KL_PAIR_POS_BYTES(S))
#define KL_PAIR_SMEM_MAX (232448 - 1024)   // a block's, less its static part
#define KL_PAIR_M_MAX (0x7FFFFFFF - 8192)  // positions, at most (int32)
#define KL_LONG_THREADS 256
#define KL_LONG_ITEMS 8
#define KL_LONG_TILE (KL_LONG_THREADS * KL_LONG_ITEMS)
#define KL_LONG_SMEM (4 * (3 * KL_LONG_TILE + 1))
#define KL_LONG_GRID_MAX 1024     // blocks of the cooperative launch, at most
#define KL_LONG_PER_SM 4          // and a SM, at most
#define KL_FULL 0xffffffffu
#define KL_NONE 0x7FFFFFFF

namespace cg = cooperative_groups;

// A run of positions, reduced: f, it holds a segment start; cnt, its alive
// count after its last start (over the whole run without one); last, its
// last alive position, -1 if none.
struct KlSeg {
  int f, cnt, last;
};

__device__ __forceinline__ KlSeg kl_seg_none() { return KlSeg{0, 0, -1}; }

// a, then b
__device__ __forceinline__ KlSeg kl_seg_cat(KlSeg a, KlSeg b) {
  return KlSeg{a.f | b.f, b.f ? b.cnt : a.cnt + b.cnt,
               b.last >= 0 ? b.last : a.last};
}

__device__ __forceinline__ KlSeg kl_seg_up(KlSeg x, int o) {
  return KlSeg{__shfl_up_sync(KL_FULL, x.f, o),
               __shfl_up_sync(KL_FULL, x.cnt, o),
               __shfl_up_sync(KL_FULL, x.last, o)};
}

// Exclusive scan of v over the block (a multiple of 32 threads, at most
// 1024); *total gets the whole block's. Calls are separated by a
// __syncthreads().
__device__ __forceinline__ KlSeg kl_seg_block_scan(KlSeg v, KlSeg* total) {
  __shared__ KlSeg ws[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  KlSeg x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const KlSeg y = kl_seg_up(x, o);
    if (lane >= o) x = kl_seg_cat(y, x);
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    KlSeg t = lane < nw ? ws[lane] : kl_seg_none();
    for (int o = 1; o < 32; o <<= 1) {
      const KlSeg y = kl_seg_up(t, o);
      if (lane >= o) t = kl_seg_cat(y, t);
    }
    ws[lane] = t;
  }
  __syncthreads();
  *total = ws[nw - 1];
  KlSeg before = kl_seg_up(x, 1);
  if (lane == 0) before = kl_seg_none();
  return kl_seg_cat(w ? ws[w - 1] : kl_seg_none(), before);
}

// Position p starts a segment; k[i] is its key, k[i - 1] the one before.
__device__ __forceinline__ bool kl_pair_start(const int* k, int i, int p,
                                              int shift) {
  return p == 0 || (k[i] >> shift) != (k[i - 1] >> shift);
}

// --- (1) short segments, every round in shared memory ------------------------

// Copy positions [from, to) of every value row into sv (rows W apart, the
// position at p - base): 16-byte cp.async where wide (M a multiple of 4
// and the values 16-byte aligned, base a multiple of 4; [from, to) is
// widened to whole 16-byte pieces), 4-byte ones otherwise.
__device__ __forceinline__ void kl_pair_copy(float* sv, int W,
                                             const float* v, int S, int M,
                                             int from, int to, int base,
                                             bool wide) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if (wide) {
    from &= ~3;
    to = (to + 3) & ~3;
    for (int s = threadIdx.x >> 5; s < S; s += nw)   // a warp a row
      for (int c = from + 4 * lane; c < to; c += 128)
        kl_cp_async16(sv + (long long)s * W + c - base,
                      v + (long long)s * M + c);
  } else {
    for (int s = threadIdx.x >> 5; s < S; s += nw)
      for (int c = from + lane; c < to; c += 32)
        kl_cp_async4(sv + (long long)s * W + c - base,
                     v + (long long)s * M + c);
  }
}

// scratch (ints): [0] the list's count; fs [nW], each window's first start
// or -1; the list's starts ls [nW] and ends le [nW] (-1: not known yet),
// its tiles lt [nW] and tile bases lb [nW + 1]; the chunks' aggregates
// [3 KL_LONG_GRID_MAX]; the tiles' aggregates [3 (M / KL_LONG_TILE + nW)].
__global__ void __launch_bounds__(KL_PAIR_THREADS, KL_PAIR_PER_SM)
    kl_pair_short(float* __restrict__ v, int S, int M,
                  int* __restrict__ sizes, const int* __restrict__ slots,
                  const int* __restrict__ keys, int* __restrict__ mi,
                  int* __restrict__ parent, long long pbase, int shift,
                  float thr, int rounds, int C, int* __restrict__ scratch) {
  const int nW = gridDim.x, t = threadIdx.x, T = blockDim.x;
  int* fs = scratch + 1;
  int* ls = fs + nW;
  int* le = ls + nW;
  if (C == 0) {   // every segment to (2): [0, M) as one range
    if (t == 0) {
      ls[0] = 0;
      le[0] = M;
      scratch[0] = 1;
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = 2 * C + 4;
  float* sv = (float*)smem;                           // [S][W]
  int* ssz = (int*)(sv + (long long)S * W);           // [W]
  int* skey = ssz + W;                                // [W]
  unsigned* spair = (unsigned*)(skey + W);            // [W / 2]
  unsigned char* sfl = (unsigned char*)(spair + W / 2);   // [W]
  __shared__ int s_first, s_last, s_end;
  const int w0 = blockIdx.x * C, w1 = min(w0 + C, M);
  const int kend = min(w0 + 2 * C, M);
  const bool wide = (M & 3) == 0 && ((unsigned long long)v & 15) == 0;
  // the keys of positions w0 - 1 .. kend - 1 at skey[0 ..]
  for (int i = t; i <= kend - w0; i += T) {
    const int p = w0 - 1 + i;
    skey[i] = p >= 0 ? keys[p] : 0;
  }
  // the window's columns on their way while the keys are read: most of
  // the range (w0 is a multiple of 32)
  kl_pair_copy(sv, W, v, S, M, w0, w1, w0, wide);
  if (t == 0) {
    s_first = KL_NONE;
    s_last = -1;
    s_end = KL_NONE;
  }
  __syncthreads();
  int lo = KL_NONE, hi = -1;
  for (int p = w0 + t; p < w1; p += T)
    if (kl_pair_start(skey, p - w0 + 1, p, shift)) {
      lo = min(lo, p);
      hi = max(hi, p);
    }
  lo = __reduce_min_sync(KL_FULL, lo);
  hi = __reduce_max_sync(KL_FULL, hi);
  if ((t & 31) == 0 && hi >= 0) {
    atomicMin(&s_first, lo);
    atomicMax(&s_last, hi);
  }
  __syncthreads();
  const int first = s_first, last = s_last;
  if (t == 0) fs[blockIdx.x] = last >= 0 ? first : -1;
  if (last < 0) {   // inside a segment that started before
    kl_cp_async_wait_all();
    return;
  }
  // the last segment is short where a start follows within C positions
  const int lim = min(last + C, M - 1);
  int e = KL_NONE;
  for (int p = last + 1 + t; p <= lim; p += T)
    if (kl_pair_start(skey, p - w0 + 1, p, shift)) e = min(e, p);
  e = __reduce_min_sync(KL_FULL, e);
  if ((t & 31) == 0 && e != KL_NONE) atomicMin(&s_end, e);
  __syncthreads();
  int r1 = s_end;
  if (r1 == KL_NONE) {
    if (last + C >= M) {
      r1 = M;
    } else {   // longer than C: to (2)
      if (t == 0) {
        const int j = atomicAdd(scratch, 1);
        ls[j] = last;
        le[j] = -1;
      }
      r1 = last;
    }
  }
  const int r0 = first;
  if (r1 <= r0) {
    kl_cp_async_wait_all();
    return;
  }
  // stage [r0, r1) at local index p - a0 (a0 a multiple of 4)
  const int a0 = w0;
  if (r1 > w1) kl_pair_copy(sv, W, v, S, M, w1, r1, a0, wide);
  const int lo_i = r0 - a0, hi_i = r1 - a0, n = r1 - r0;
  for (int i = lo_i + t; i < hi_i; i += T) {
    const int p = a0 + i;
    ssz[i] = sizes[p];
    sfl[i] = (kl_pair_start(skey, p - w0 + 1, p, shift) ? 1 : 0) |
             (skey[p - w0 + 1] != KL_BIG_KEY ? 2 : 0);
  }
  kl_cp_async_wait_all();
  __syncthreads();
  // flags: 1 a start, 2 a valid key, 4 the size changed, 8 the values did
  const int lane = t & 31, wp = t >> 5, nwp = T >> 5;
  const int K = (n + T - 1) / T;
  const int i0 = lo_i + t * K, i1 = min(i0 + K, hi_i);
  int quiet = 0, any = 0;
  for (int r = 0; r < rounds && quiet < 2; ++r) {
    const int ph = r & 1;
    KlSeg run = kl_seg_none();
    for (int i = i0; i < i1; ++i) {
      if (sfl[i] & 1) {
        run.f = 1;
        run.cnt = 0;
      }
      if ((sfl[i] & 2) && ssz[i] > 0) {
        ++run.cnt;
        run.last = i;
      }
    }
    KlSeg total;
    const KlSeg pre = kl_seg_block_scan(run, &total);
    int cnt = pre.cnt, nr = 0;
    for (int i = i0; i < i1; ++i) {
      if (sfl[i] & 1) cnt = 0;
      if ((sfl[i] & 2) && ssz[i] > 0) {
        if (cnt >= ph + 1 && ((cnt - ph) & 1)) ++nr;
        ++cnt;
      }
    }
    int npairs;
    int k = kl_block_scan(nr, &npairs);
    cnt = pre.cnt;
    int prev = pre.last;
    for (int i = i0; i < i1; ++i) {
      if (sfl[i] & 1) cnt = 0;
      if ((sfl[i] & 2) && ssz[i] > 0) {
        if (cnt >= ph + 1 && ((cnt - ph) & 1))
          spair[k++] = (unsigned)i | ((unsigned)prev << 16);
        ++cnt;
        prev = i;
      }
    }
    __syncthreads();
    int merged = 0;
    for (int u = t; u < npairs; u += T) {
      const int p = spair[u] & 0xffff, q = spair[u] >> 16;
      float dot = 0.f, nr2 = 0.f, nl = 0.f;
      for (int s = 0; s < S; ++s) {
        const float vr = sv[s * W + p], vl = sv[s * W + q];
        dot = __fadd_rn(dot, __fmul_rn(vr, vl));
        nr2 = __fadd_rn(nr2, __fmul_rn(vr, vr));
        nl = __fadd_rn(nl, __fmul_rn(vl, vl));
      }
      const float nn = __fsqrt_rn(__fmul_rn(nr2, nl));
      const float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
      if (!(sim >= thr)) continue;
      merged = 1;
      // the slots on their way while the means are computed
      const int lslot = slots[a0 + q], rslot = slots[a0 + p];
      const int sr = ssz[p], sl = ssz[q];
      const float fr = __int2float_rn(sr), fl = __int2float_rn(sl);
      const float ft = __int2float_rn(sl + sr);
      for (int s = 0; s < S; ++s) {
        float* vq = sv + s * W + q;
        *vq = __fdiv_rn(__fadd_rn(__fmul_rn(*vq, fl),
                                  __fmul_rn(sv[s * W + p], fr)),
                        ft);
      }
      ssz[q] = sl + sr;
      ssz[p] = 0;
      sfl[q] |= 12;
      sfl[p] |= 4;
      mi[a0 + p] = lslot;
      if (parent) parent[(long long)rslot - pbase] = lslot;
    }
    quiet = __syncthreads_or(merged) ? 0 : quiet + 1;
    any |= quiet == 0;
  }
  if (!any) return;
  for (int i = lo_i + t; i < hi_i; i += T)
    if (sfl[i] & 4) sizes[a0 + i] = ssz[i];
  for (int s = wp; s < S; s += nwp)   // a warp a value row
    for (int i = lo_i + lane; i < hi_i; i += 32)
      if (sfl[i] & 8) v[(long long)s * M + a0 + i] = sv[(long long)s * W + i];
}

// --- (2) long segments, one cooperative launch -------------------------------

// Stage tile [p0, p1)'s sizes (s_size[i], position p0 + i, past the L1)
// and keys (s_key[i + 1], the key before p0 at s_key[0]); past p1 size 0.
__device__ __forceinline__ void kl_long_stage(const int* sizes,
                                              const int* __restrict__ keys,
                                              int p0, int p1, int* s_size,
                                              int* s_key) {
  for (int i = threadIdx.x; i < KL_LONG_TILE; i += blockDim.x) {
    const int p = p0 + i;
    s_size[i] = p < p1 ? __ldcg(sizes + p) : 0;
    s_key[i + 1] = p < p1 ? keys[p] : KL_BIG_KEY;
  }
  if (threadIdx.x == 0) s_key[0] = p0 > 0 ? keys[p0 - 1] : 0;
  __syncthreads();
}

__device__ __forceinline__ bool kl_long_alive(const int* s_size,
                                              const int* s_key, int i) {
  return s_size[i] > 0 && s_key[i + 1] != KL_BIG_KEY;
}

// This thread's KL_LONG_ITEMS consecutive positions of the staged tile,
// reduced
__device__ __forceinline__ KlSeg kl_long_items(const int* s_size,
                                               const int* s_key, int p0,
                                               int p1, int shift) {
  KlSeg a = kl_seg_none();
  const int i0 = threadIdx.x * KL_LONG_ITEMS;
  for (int j = 0; j < KL_LONG_ITEMS; ++j) {
    const int i = i0 + j, p = p0 + i;
    if (p >= p1) break;
    if (kl_pair_start(s_key, i + 1, p, shift)) {
      a.f = 1;
      a.cnt = 0;
    }
    if (kl_long_alive(s_size, s_key, i)) {
      ++a.cnt;
      a.last = p;
    }
  }
  return a;
}

// The first start in windows w, w + 1, ... (fs), M if none: the end of a
// listed segment that starts in window w - 1.
__device__ int kl_long_end(const int* fs, int nW, int w, int M, int* s_one) {
  for (; w < nW; w += blockDim.x) {
    const int i = w + threadIdx.x;
    const int x = i < nW ? __ldcg(fs + i) : -1;
    if (threadIdx.x == 0) *s_one = KL_NONE;
    __syncthreads();
    if (x >= 0) atomicMin(s_one, i);
    __syncthreads();
    const int found = *s_one;
    __syncthreads();
    if (found != KL_NONE) return __ldcg(fs + found);
  }
  return M;
}

// Round ph's pairs of tile [p0, p1), its carry-in the aggregate of every
// position before it in its range: ranks, then each right-role element's
// pair in device memory.
__device__ __forceinline__ void kl_long_apply(
    float* v, int S, int M, int* sizes, const int* __restrict__ slots,
    const int* __restrict__ keys, int* mi, int* parent, long long pbase,
    int shift, float thr, int ph, int p0, int p1, KlSeg carry, int* s_size,
    int* s_key, int* s_left) {
  kl_long_stage(sizes, keys, p0, p1, s_size, s_key);
  KlSeg total;
  const KlSeg in = kl_seg_cat(
      carry,
      kl_seg_block_scan(kl_long_items(s_size, s_key, p0, p1, shift), &total));
  int cnt = in.cnt, last = in.last;
  const int i0 = threadIdx.x * KL_LONG_ITEMS;
  for (int j = 0; j < KL_LONG_ITEMS; ++j) {
    const int i = i0 + j, p = p0 + i;
    int left = -1;
    if (p < p1) {
      if (kl_pair_start(s_key, i + 1, p, shift)) cnt = 0;
      if (kl_long_alive(s_size, s_key, i)) {
        if (cnt >= ph + 1 && ((cnt - ph) & 1)) left = last;
        ++cnt;
        last = p;
      }
    }
    s_left[i] = left;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KL_LONG_TILE; i += blockDim.x) {
    const int q = s_left[i];
    if (q < 0) continue;
    const long long p = p0 + i;
    float dot = 0.f, nr = 0.f, nl = 0.f;
    for (int s = 0; s < S; ++s) {
      const float vr = __ldcg(v + (long long)s * M + p);
      const float vl = __ldcg(v + (long long)s * M + q);
      dot = __fadd_rn(dot, __fmul_rn(vr, vl));
      nr = __fadd_rn(nr, __fmul_rn(vr, vr));
      nl = __fadd_rn(nl, __fmul_rn(vl, vl));
    }
    const float nn = __fsqrt_rn(__fmul_rn(nr, nl));
    const float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
    if (!(sim >= thr)) continue;
    const int sr = s_size[i], sl = __ldcg(sizes + q);
    const float fr = __int2float_rn(sr), fl = __int2float_rn(sl);
    const float ft = __int2float_rn(sl + sr);
    for (int s = 0; s < S; ++s) {
      float* vq = v + (long long)s * M + q;
      const float vr = __ldcg(v + (long long)s * M + p);
      *vq = __fdiv_rn(__fadd_rn(__fmul_rn(__ldcg(vq), fl), __fmul_rn(vr, fr)),
                      ft);
    }
    sizes[q] = sl + sr;
    sizes[p] = 0;
    const int lslot = slots[q];
    mi[p] = lslot;
    if (parent) parent[(long long)slots[p] - pbase] = lslot;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(KL_LONG_THREADS, KL_LONG_PER_SM)
    kl_pair_long(float* v, int S, int M, int* sizes,
                 const int* __restrict__ slots, const int* __restrict__ keys,
                 int* mi, int* parent, long long pbase, int shift, float thr,
                 int rounds, int C, int nW, int* scratch) {
  const int n = __ldcg(scratch);
  if (n == 0) return;
  cg::grid_group grid = cg::this_grid();
  int* fs = scratch + 1;
  int* ls = fs + nW;
  int* le = ls + nW;
  int* lt = le + nW;
  int* lb = lt + nW;
  int* chunk = lb + nW + 1;
  int* agg = chunk + 3 * KL_LONG_GRID_MAX;
  extern __shared__ int sm2[];
  int* s_size = sm2;
  int* s_key = sm2 + KL_LONG_TILE;
  int* s_left = s_key + KL_LONG_TILE + 1;
  __shared__ int s_one;
  const int b = blockIdx.x, G = gridDim.x;
  // each range's end and tiles
  for (int j = b; j < n; j += G) {
    const int a = __ldcg(ls + j);
    int e = __ldcg(le + j);
    if (e < 0 && C > 0) e = kl_long_end(fs, nW, a / C + 1, M, &s_one);
    if (threadIdx.x == 0) {
      le[j] = e;
      lt[j] = (e - a + KL_LONG_TILE - 1) / KL_LONG_TILE;
    }
  }
  grid.sync();
  // a range of one tile: every round in one block, no grid sync
  for (int j = b; j < n; j += G) {
    if (__ldcg(lt + j) != 1) continue;
    for (int r = 0; r < rounds; ++r)
      kl_long_apply(v, S, M, sizes, slots, keys, mi, parent, pbase, shift,
                    thr, r & 1, __ldcg(ls + j), __ldcg(le + j), kl_seg_none(),
                    s_size, s_key, s_left);
  }
  if (b == 0) {   // the tile bases of the ranges of several tiles
    int run = 0;
    for (int j0 = 0; j0 < n; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      const int x = j < n ? __ldcg(lt + j) : 0;
      int tot;
      const int pre = kl_block_scan(x > 1 ? x : 0, &tot);
      if (j < n) lb[j] = run + pre;
      run += tot;
      __syncthreads();
    }
    if (threadIdx.x == 0) lb[n] = run;
  }
  grid.sync();
  // this block's chunk of tiles, and the range of its first
  const int T = __ldcg(lb + n), ch = (T + G - 1) / G;
  if (T == 0) return;
  const int t0 = min(b * ch, T), t1 = min(t0 + ch, T);
  int j0 = 0;
  for (int hi = n - 1; j0 < hi;) {
    const int mid = (j0 + hi + 1) >> 1;
    if (__ldcg(lb + mid) <= t0)
      j0 = mid;
    else
      hi = mid - 1;
  }
  for (int r = 0; r < rounds; ++r) {
    const int ph = r & 1;
    KlSeg mine = kl_seg_none();
    for (int t = t0, j = j0; t < t1; ++t) {
      while (__ldcg(lb + j + 1) <= t) ++j;
      const int p0 = __ldcg(ls + j) + (t - __ldcg(lb + j)) * KL_LONG_TILE;
      const int p1 = min(p0 + KL_LONG_TILE, __ldcg(le + j));
      KlSeg at;
      if (r > 0 && __ldcg(agg + 3 * t + 2) < 0) {   // no alive left
        at = KlSeg{__ldcg(agg + 3 * t), 0, -1};
      } else {
        kl_long_stage(sizes, keys, p0, p1, s_size, s_key);
        kl_seg_block_scan(kl_long_items(s_size, s_key, p0, p1, shift), &at);
        if (threadIdx.x == 0) {
          agg[3 * t] = at.f;
          agg[3 * t + 1] = at.cnt;
          agg[3 * t + 2] = at.last;
        }
        __syncthreads();
      }
      mine = kl_seg_cat(mine, at);
    }
    if (threadIdx.x == 0) {
      chunk[3 * b] = mine.f;
      chunk[3 * b + 1] = mine.cnt;
      chunk[3 * b + 2] = mine.last;
    }
    grid.sync();
    // the carry-in: the chunks before this block's, in order
    KlSeg carry;
    {
      const int per = (b + blockDim.x - 1) / blockDim.x;
      const int u0 = min((int)threadIdx.x * per, b), u1 = min(u0 + per, b);
      KlSeg c = kl_seg_none();
      for (int u = u0; u < u1; ++u)
        c = kl_seg_cat(c, KlSeg{__ldcg(chunk + 3 * u),
                                __ldcg(chunk + 3 * u + 1),
                                __ldcg(chunk + 3 * u + 2)});
      kl_seg_block_scan(c, &carry);
      __syncthreads();
    }
    for (int t = t0, j = j0; t < t1; ++t) {
      while (__ldcg(lb + j + 1) <= t) ++j;
      const int p0 = __ldcg(ls + j) + (t - __ldcg(lb + j)) * KL_LONG_TILE;
      const int p1 = min(p0 + KL_LONG_TILE, __ldcg(le + j));
      const KlSeg at{__ldcg(agg + 3 * t), __ldcg(agg + 3 * t + 1),
                     __ldcg(agg + 3 * t + 2)};
      if (at.last >= 0)
        kl_long_apply(v, S, M, sizes, slots, keys, mi, parent, pbase, shift,
                      thr, ph, p0, p1, carry, s_size, s_key, s_left);
      carry = kl_seg_cat(carry, at);
    }
    if (r + 1 < rounds) grid.sync();
  }
}

// --- the entry point ----------------------------------------------------------

// The cooperative launch's grid on the current device (blocks resident at
// once, at most KL_LONG_PER_SM a SM), and the short blocks' shared-memory
// limit raised, with the most shared memory of the SM's carveout (so that
// KL_PAIR_PER_SM blocks fit), once a device.
static int kl_pair_setup(int* grid) {
  static int grids[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grids[dev] == 0) {
    int sms, per;
    if ((err = cudaFuncSetAttribute(
             kl_pair_short, cudaFuncAttributeMaxDynamicSharedMemorySize,
             KL_PAIR_SMEM_MAX)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kl_pair_short, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kl_pair_long, KL_LONG_THREADS, KL_LONG_SMEM)) !=
            cudaSuccess)
      return (int)err;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    const int g = (per < KL_LONG_PER_SM ? per : KL_LONG_PER_SM) * sms;
    grids[dev] = g < KL_LONG_GRID_MAX ? g : KL_LONG_GRID_MAX;
  }
  *grid = grids[dev];
  return 0;
}

// The launch arithmetic is kmerlsh_tpu_torch.kernels.pairing_plan, checked
// here: C a multiple of 32 up to KL_PAIR_CAP_MAX (0: every segment to the
// cooperative launch), blocks the windows (1 at C = 0), smem
// KL_PAIR_SMEM(C, S), scratch_ints the layout above kl_pair_short.
KL_EXPORT int kl_pairing_rounds(void* values, int S, long long M, void* sizes,
                                const void* slots, const void* keys, void* mi,
                                void* parent, long long pbase, int shift,
                                float thr, int rounds, int C, int blocks,
                                int smem, void* scratch,
                                long long scratch_ints, void* stream) {
  const long long nW = blocks;
  const long long tiles = (M + KL_LONG_TILE - 1) / KL_LONG_TILE + nW;
  if (S < 0 || M < 1 || M > KL_PAIR_M_MAX || shift < 0 || shift > 30 ||
      rounds < 0 || C < 0 || C % 32 != 0 || C > KL_PAIR_CAP_MAX ||
      blocks != (C ? (M + C - 1) / C : 1) ||
      smem != (C ? KL_PAIR_SMEM(C, S) : 0) || smem > KL_PAIR_SMEM_MAX ||
      scratch == nullptr ||
      scratch_ints != 2 + 5 * nW + 3 * KL_LONG_GRID_MAX + 3 * tiles)
    return (int)cudaErrorInvalidValue;
  int grid;
  int err = kl_pair_setup(&grid);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  float* v = (float*)values;
  int m = (int)M, nw = blocks;
  int* sz = (int*)sizes;
  const int* sl = (const int*)slots;
  const int* k = (const int*)keys;
  int* merged = (int*)mi;
  int* par = (int*)parent;
  int* scr = (int*)scratch;
  kl_pair_short<<<blocks, KL_PAIR_THREADS, smem, st>>>(
      v, S, m, sz, sl, k, merged, par, pbase, shift, thr, rounds, C, scr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  void* args[] = {&v,     &S,   &m,      &sz,    &sl, &k, &merged, &par,
                  &pbase, &shift, &thr, &rounds, &C,  &nw, &scr};
  e = cudaLaunchCooperativeKernel((const void*)kl_pair_long, grid,
                                  KL_LONG_THREADS, args, KL_LONG_SMEM, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
