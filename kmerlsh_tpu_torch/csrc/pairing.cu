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
// where a parent is given. Alive: size > 0 and key != BIG_KEY.
//
// Three launches a round:
//   (a) kl_pair_tiles: one block a tile of KL_PAIR_TILE positions stages
//       the tile's sizes and keys in shared memory (coalesced) and reduces
//       them to the tile's segmented aggregate: whether it holds a segment
//       start, the alive count after its last start (or over the whole
//       tile), and its last alive position;
//   (b) kl_pair_carry: one block scans the tiles' aggregates into each
//       tile's carry-in (8,192 tiles at 2^24);
//   (c) kl_pair_apply: each block stages and scans its tile again with the
//       carry-in, so every alive position knows its rank in its segment and
//       the alive position before it; only right-role elements act (rank
//       >= ph + 1, rank - ph odd: the one before is then in the segment),
//       one thread each, neighbouring threads on neighbouring positions.
// Race-free without atomics: within a round each position is in at most one
// pair, a left is read and written only by its right, and only a right
// changes its own alive state; a left's size stays positive, so a block
// that stages it before or after its right's write sees it alive. Every
// block stages its sizes before it writes any.
//
// Bit equality with the plain version (kernels.pairing_rounds_plain): the
// dot product and both norms are summed over s = 0, 1, ... with separately
// rounded products and sums (__fmul_rn, __fadd_rn: no contraction into
// FMA), the square root and divisions are IEEE, and the merged mean is
// (v_l * float(s_l) + v_r * float(s_r)) / float(s_l + s_r) as the
// reference writes it (engine.py:263-270).
//
// Bound on the H100: device-memory bandwidth, the sizes a round and the
// two columns of each pair formed, and the left column of each merge
// written. This first design reads the sizes and keys twice a round and
// each pair's columns twice on a merge, with strided column reads
// (sample-major [S, M]); a look-back that folds (a)-(c) into one launch,
// rounds kept in shared memory while a segment fits a tile, and a
// profile-major read of the pairs are later work.

#include "common.cuh"

#define KL_PAIR_THREADS 256
#define KL_PAIR_ITEMS 8
#define KL_PAIR_TILE (KL_PAIR_THREADS * KL_PAIR_ITEMS)
#define KL_PAIR_SCAN 1024    // threads of the carry scan's one block
#define KL_FULL 0xffffffffu

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
// 1024); *total gets the whole block's. Once a launch.
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

// Stage the tile's sizes (s_size[i], position base + i) and keys (s_key[i +
// 1], the key before the tile at s_key[0]); past M, size 0.
__device__ __forceinline__ void kl_pair_stage(const int* __restrict__ sizes,
                                              const int* __restrict__ keys,
                                              long long M, long long base,
                                              int* s_size, int* s_key) {
  for (int i = threadIdx.x; i < KL_PAIR_TILE; i += blockDim.x) {
    const long long p = base + i;
    s_size[i] = p < M ? sizes[p] : 0;
    s_key[i + 1] = p < M ? keys[p] : KL_BIG_KEY;
  }
  if (threadIdx.x == 0) s_key[0] = base > 0 ? keys[base - 1] : 0;
  __syncthreads();
}

__device__ __forceinline__ bool kl_pair_start(const int* s_key, int i,
                                              long long p, int shift) {
  return p == 0 || (s_key[i + 1] >> shift) != (s_key[i] >> shift);
}

__device__ __forceinline__ bool kl_pair_alive(const int* s_size,
                                              const int* s_key, int i) {
  return s_size[i] > 0 && s_key[i + 1] != KL_BIG_KEY;
}

// This thread's KL_PAIR_ITEMS consecutive positions, reduced
__device__ __forceinline__ KlSeg kl_pair_items(const int* s_size,
                                               const int* s_key, long long M,
                                               long long base, int shift) {
  KlSeg a = kl_seg_none();
  const int i0 = threadIdx.x * KL_PAIR_ITEMS;
  for (int j = 0; j < KL_PAIR_ITEMS; ++j) {
    const int i = i0 + j;
    const long long p = base + i;
    if (p >= M) break;
    if (kl_pair_start(s_key, i, p, shift)) {
      a.f = 1;
      a.cnt = 0;
    }
    if (kl_pair_alive(s_size, s_key, i)) {
      ++a.cnt;
      a.last = (int)p;
    }
  }
  return a;
}

// (a) each tile's aggregate, three ints a tile
__global__ void __launch_bounds__(KL_PAIR_THREADS)
    kl_pair_tiles(const int* __restrict__ sizes, const int* __restrict__ keys,
                  long long M, int shift, int* __restrict__ agg) {
  extern __shared__ int sm[];
  int* s_size = sm;
  int* s_key = sm + KL_PAIR_TILE;
  const long long base = (long long)blockIdx.x * KL_PAIR_TILE;
  kl_pair_stage(sizes, keys, M, base, s_size, s_key);
  KlSeg total;
  kl_seg_block_scan(kl_pair_items(s_size, s_key, M, base, shift), &total);
  if (threadIdx.x == 0) {
    agg[3 * blockIdx.x] = total.f;
    agg[3 * blockIdx.x + 1] = total.cnt;
    agg[3 * blockIdx.x + 2] = total.last;
  }
}

// (b) the tiles' exclusive scan: carry[t] aggregates tiles 0 .. t - 1
__global__ void __launch_bounds__(KL_PAIR_SCAN)
    kl_pair_carry(const int* __restrict__ agg, int nt,
                  int* __restrict__ carry) {
  const int per = (nt + blockDim.x - 1) / blockDim.x;
  const int t0 = threadIdx.x * per, t1 = min(t0 + per, nt);
  KlSeg a = kl_seg_none();
  for (int t = t0; t < t1; ++t)
    a = kl_seg_cat(a, KlSeg{agg[3 * t], agg[3 * t + 1], agg[3 * t + 2]});
  KlSeg total;
  KlSeg c = kl_seg_block_scan(a, &total);
  for (int t = t0; t < t1; ++t) {
    carry[3 * t] = c.f;
    carry[3 * t + 1] = c.cnt;
    carry[3 * t + 2] = c.last;
    c = kl_seg_cat(c, KlSeg{agg[3 * t], agg[3 * t + 1], agg[3 * t + 2]});
  }
}

// (c) ranks with the carry-in, then each right-role element's pair
__global__ void __launch_bounds__(KL_PAIR_THREADS)
    kl_pair_apply(float* __restrict__ v, int S, long long M,
                  int* __restrict__ sizes, const int* __restrict__ slots,
                  const int* __restrict__ keys, int* __restrict__ mi,
                  int* __restrict__ parent, long long pbase, int shift,
                  float thr, int ph, const int* __restrict__ carry) {
  extern __shared__ int sm[];
  int* s_size = sm;
  int* s_key = sm + KL_PAIR_TILE;
  int* s_left = s_key + KL_PAIR_TILE + 1;   // the left of a right, else -1
  const long long base = (long long)blockIdx.x * KL_PAIR_TILE;
  kl_pair_stage(sizes, keys, M, base, s_size, s_key);
  KlSeg total;
  const KlSeg mine = kl_pair_items(s_size, s_key, M, base, shift);
  const int* c = carry + 3 * blockIdx.x;
  const KlSeg in =
      kl_seg_cat(KlSeg{c[0], c[1], c[2]}, kl_seg_block_scan(mine, &total));
  int cnt = in.cnt, last = in.last;
  const int i0 = threadIdx.x * KL_PAIR_ITEMS;
  for (int j = 0; j < KL_PAIR_ITEMS; ++j) {
    const int i = i0 + j;
    const long long p = base + i;
    int left = -1;
    if (p < M) {
      if (kl_pair_start(s_key, i, p, shift)) cnt = 0;
      if (kl_pair_alive(s_size, s_key, i)) {
        if (cnt >= ph + 1 && ((cnt - ph) & 1)) left = last;
        ++cnt;
        last = (int)p;
      }
    }
    s_left[i] = left;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KL_PAIR_TILE; i += blockDim.x) {
    const int q = s_left[i];
    if (q < 0) continue;
    const long long p = base + i;
    float dot = 0.f, nr = 0.f, nl = 0.f;
    for (int s = 0; s < S; ++s) {
      const float vr = v[(long long)s * M + p], vl = v[(long long)s * M + q];
      dot = __fadd_rn(dot, __fmul_rn(vr, vl));
      nr = __fadd_rn(nr, __fmul_rn(vr, vr));
      nl = __fadd_rn(nl, __fmul_rn(vl, vl));
    }
    const float nn = __fsqrt_rn(__fmul_rn(nr, nl));
    const float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
    if (!(sim >= thr)) continue;
    const int sr = s_size[i], sl = sizes[q];
    const float fr = __int2float_rn(sr), fl = __int2float_rn(sl);
    const float ft = __int2float_rn(sl + sr);
    for (int s = 0; s < S; ++s) {
      float* vq = v + (long long)s * M + q;
      const float vr = v[(long long)s * M + p];
      *vq = __fdiv_rn(__fadd_rn(__fmul_rn(*vq, fl), __fmul_rn(vr, fr)), ft);
    }
    sizes[q] = sl + sr;
    sizes[p] = 0;
    const int lslot = slots[q];
    mi[p] = lslot;
    if (parent) parent[(long long)slots[p] - pbase] = lslot;
  }
}

static inline int kl_pair_smem(int tile) { return 4 * (3 * tile + 1); }

KL_EXPORT int kl_pairing_rounds(void* values, int S, long long M, void* sizes,
                                const void* slots, const void* keys, void* mi,
                                void* parent, long long pbase, int shift,
                                float thr, int rounds, int tile, int blocks,
                                int smem, void* scratch, void* stream) {
  if (tile != KL_PAIR_TILE || S < 0 || M < 1 ||
      M > 0x7FFFFFFFLL - KL_PAIR_TILE || blocks != (int)kl_blocks(M, tile) ||
      smem != kl_pair_smem(tile) || smem > 48 * 1024 || shift < 0 ||
      shift > 30 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* agg = (int*)scratch;
  int* carry = agg + 3 * (long long)blocks;
  const int tiles_smem = 4 * (2 * tile + 1);
  for (int r = 0; r < rounds; ++r) {
    kl_pair_tiles<<<blocks, KL_PAIR_THREADS, tiles_smem, st>>>(
        (const int*)sizes, (const int*)keys, M, shift, agg);
    kl_pair_carry<<<1, KL_PAIR_SCAN, 0, st>>>(agg, blocks, carry);
    kl_pair_apply<<<blocks, KL_PAIR_THREADS, smem, st>>>(
        (float*)values, S, M, (int*)sizes, (const int*)slots,
        (const int*)keys, (int*)mi, (int*)parent, pbase, shift, thr, r & 1,
        carry);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
