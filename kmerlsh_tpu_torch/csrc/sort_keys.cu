// K9: a stable least-significant-digit radix sort of int32 keys, with the
// int32 permutation as its payload.
//
// Replaces the stable key sort of the reference's XLA programs:
// jax.lax.sort(..., num_keys=1, is_stable=True) in
// kmerlsh_tpu/cluster/engine.py:117 _sort_state (also the sharded
// iteration's, kmerlsh_tpu/parallel/dist.py:93), :451 compact_sort and the
// two sorts of :651 _finalize_grouped. kl_sort_keys takes M keys in
// [0, 2^bits) and writes skey, the keys in stable ascending order, and
// order, skey[i] = key[order[i]] with ties in input order. A stable sort's
// permutation is unique, so both equal torch.sort(stable=True)'s.
//
// `passes` passes of a `digit`-bit digit, lowest digit first
// (kernels.sort_plan: the fewest passes of at most KL_SORT_MAX_DIGIT bits,
// the digit as narrow as they allow; 31 bits take four passes of 8). A pass
// is three launches over tiles of KL_SORT_TILE keys, one block a tile:
//   (a) kl_sort_hist: the block counts the digits of its tile (shared-memory
//       atomics) and writes them digit-major, counts[digit][block];
//   (b) kl_sort_scan_rows: one block a digit turns its row of counts into
//       exclusive offsets in place and writes the row's total after the
//       rows;
//   (c) kl_sort_scatter: the block loads its tile, each warp 32 x
//       KL_SORT_KPT consecutive keys in rounds of 32, with their payloads
//       and thread t's digit offsets, all up front, and ranks each key
//       among the equal digits before it in the tile: inside a round by
//       ballots (one a digit bit: the lanes below it with its digit),
//       across rounds by the warp's digit counters in shared memory, across
//       warps by those counters summed in warp order. Keys and payloads go
//       through shared memory in digit order, then out to the digit's start
//       (an exclusive scan of the row totals) + counts[digit][block] + their
//       rank, so that consecutive threads write each digit's run of the
//       tile.
// Block order in the digit-major offsets and the rank in input order inside
// a tile make every pass stable. The first pass makes the payload from the
// index and reads none. The passes ping-pong between the outputs and a
// scratch pair the wrapper allocates, so that the last pass writes the
// outputs; all run on the caller's stream.
//
// Measured on the H100 (tools/kernel_variants.py sort; PERF.md): on 31-bit
// keys ballots beat __match_any_sync by 4-15% (on 1-bit flags it wins by
// 8%), at 2^24 keys 16 keys a thread beat 8, 12 and 24, and a scatter held
// to three blocks a SM runs slower. Two earlier designs were slower at
// 2^24 keys and were not kept: 11-bit digits in three passes over tiles of
// 8192 keys (one digit counter set a warp of 2048 digits; the scatter held
// two blocks a SM and waited on memory), and a one-sweep design (every
// pass's histogram up front, each tile's digit offsets by decoupled
// look-back inside the scatter), whose look-back cost the scatter about
// what the saved histograms and scans took.
//
// Bound on the H100: device-memory bandwidth. The sort must read the keys
// and write keys and order: 12 bytes a key. These passes move 4 bytes a key
// for each histogram, 12 in the first scatter (key in, key and index out)
// and 16 in each later one: 76 bytes a key at 31 bits in four passes (64
// with one histogram of every pass up front). The counts, 2^digit ints a
// tile, are read and written through the L2.

#include "common.cuh"

#define KL_SORT_THREADS 256
#define KL_SORT_KPT 16   // keys a thread
#define KL_SORT_TILE (KL_SORT_THREADS * KL_SORT_KPT)
#define KL_SORT_WARPS (KL_SORT_THREADS / 32)
#define KL_SORT_MAX_DIGIT 8
#define KL_SORT_SCAN 1024   // threads of a kl_sort_scan_rows block, at most

static_assert((1 << KL_SORT_MAX_DIGIT) <= KL_SORT_THREADS,
              "a thread for each digit");

// The lanes of the warp whose value dg (below 2^(digit + 1)) equals this
// lane's, by one ballot a bit (every lane calls).
__device__ __forceinline__ unsigned kl_same_digit(unsigned dg, int digit) {
  unsigned m = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b <= KL_SORT_MAX_DIGIT; ++b) {
    if (b > digit) break;
    const unsigned bit = (dg >> b) & 1u;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, bit);
    m &= bit ? bal : ~bal;
  }
  return m;
}

__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_hist(
    const unsigned* __restrict__ kin, int M, int shift, int digit,
    int nb, int* __restrict__ counts) {
  __shared__ int hist[1 << KL_SORT_MAX_DIGIT];
  const int R = 1 << digit, t = threadIdx.x;
  const unsigned mask = R - 1;
  if (t < R) hist[t] = 0;
  const int base = blockIdx.x * KL_SORT_TILE + t;
  unsigned dg[KL_SORT_KPT];   // R where the tile has no key
#pragma unroll
  for (int r = 0; r < KL_SORT_KPT; ++r) {
    const int i = base + r * KL_SORT_THREADS;
    dg[r] = i < M ? (kin[i] >> shift) & mask : (unsigned)R;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KL_SORT_KPT; ++r)
    if (dg[r] < (unsigned)R) atomicAdd(&hist[dg[r]], 1);
  __syncthreads();
  if (t < R) counts[t * nb + blockIdx.x] = hist[t];
}

// Block d of 2^digit: row d of counts ([2^digit][nb]) into exclusive
// offsets, in place; its total to counts[2^digit * nb + d].
__global__ void __launch_bounds__(KL_SORT_SCAN) kl_sort_scan_rows(
    int* __restrict__ counts, int nb) {
  int* row = counts + (long long)blockIdx.x * nb;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    int total;
    const int before = kl_block_scan(b < nb ? row[b] : 0, &total);
    if (b < nb) row[b] = carry + before;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0)
    counts[(long long)gridDim.x * nb + blockIdx.x] = carry;
}

__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_scatter(
    const unsigned* __restrict__ kin, const int* __restrict__ vin,
    int M, int shift, int digit, int nb,
    const int* __restrict__ counts, unsigned* __restrict__ kout,
    int* __restrict__ vout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 1 << digit, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned mask = R - 1;
  unsigned* sk = (unsigned*)smem;                    // [TILE] keys by digit
  int* sv = (int*)(sk + KL_SORT_TILE);               // [TILE] their payloads
  int* loc = sv + KL_SORT_TILE;                      // [R] a digit's start
  int* gml = loc + R;                                // [R] out there, - loc
  unsigned short* cnt = (unsigned short*)(gml + R);  // [WARPS][R]
  unsigned short* wc = cnt + w * R;
  for (int i = lane; i < R; i += 32) wc[i] = 0;
  // every load of the block up front: the tile's keys and payloads, and for
  // digit t this tile's offset and the digit's total
  const int base = blockIdx.x * KL_SORT_TILE;
  const int wbase = base + w * 32 * KL_SORT_KPT + lane;
  unsigned k[KL_SORT_KPT];
  int v[KL_SORT_KPT];
#pragma unroll
  for (int r = 0; r < KL_SORT_KPT; ++r) {
    const int i = wbase + 32 * r;
    k[r] = i < M ? kin[i] : 0u;
    v[r] = i >= M ? 0 : vin ? vin[i] : i;
  }
  int row = 0, tot = 0;
  if (t < R) {
    row = counts[t * nb + blockIdx.x];
    tot = counts[R * nb + t];
  }
  __syncwarp();
  // rk: the key's rank among the equal digits before it in the warp
  const unsigned lt = (1u << lane) - 1;
  int rk[KL_SORT_KPT];
#pragma unroll
  for (int r = 0; r < KL_SORT_KPT; ++r) {
    const bool ok = wbase + 32 * r < M;
    const unsigned dg = ok ? (k[r] >> shift) & mask : (unsigned)R;
    const unsigned m = kl_same_digit(dg, digit);
    const int pre = ok ? wc[dg] : 0;
    __syncwarp();
    if (ok && (m & lt) == 0) wc[dg] = (unsigned short)(pre + __popc(m));
    __syncwarp();
    rk[r] = pre + __popc(m & lt);
  }
  __syncthreads();
  // digit t: the warps' counts into exclusive offsets in warp order, the
  // tile's count c; then the digit's start in the tile and out there, by
  // exclusive scans over the digits
  int c = 0;
  if (t < R) {
#pragma unroll
    for (int u = 0; u < KL_SORT_WARPS; ++u) {
      const int x = cnt[u * R + t];
      cnt[u * R + t] = (unsigned short)c;
      c += x;
    }
  }
  int total;
  const int l = kl_block_scan(c, &total);
  __syncthreads();
  const int g = kl_block_scan(tot, &total);
  if (t < R) {
    loc[t] = l;
    gml[t] = g + row - l;
  }
  __syncthreads();
  // into shared memory in digit order, then out a digit's run at a time
#pragma unroll
  for (int r = 0; r < KL_SORT_KPT; ++r) {
    if (wbase + 32 * r < M) {
      const unsigned dg = (k[r] >> shift) & mask;
      const int p = rk[r] + loc[dg] + wc[dg];
      sk[p] = k[r];
      sv[p] = v[r];
    }
  }
  __syncthreads();
  const int n = min(KL_SORT_TILE, M - base);
  for (int j = t; j < n; j += KL_SORT_THREADS) {
    const unsigned key = sk[j];
    const int o = j + gml[(key >> shift) & mask];
    kout[o] = key;
    vout[o] = sv[j];
  }
}

// The launch arithmetic is kmerlsh_tpu_torch.kernels.sort_plan, checked
// here. counts holds (blocks + 1) << digit ints; alt_key and alt_order, M
// ints each, are needed where passes > 1. Positions are int32: M stays a
// tile below 2^31.
KL_EXPORT int kl_sort_keys(const void* key, long long M, int bits, int digit,
                           int passes, int tile, int blocks, int smem,
                           void* counts, void* skey, void* order,
                           void* alt_key, void* alt_order, void* stream) {
  if (M < 1 || M > 0x7FFFFFFFLL - KL_SORT_TILE || bits < 1 || bits > 31 ||
      digit < 1 || digit > KL_SORT_MAX_DIGIT || passes * digit < bits ||
      (passes - 1) * digit >= bits || tile != KL_SORT_TILE ||
      blocks != (M + tile - 1) / tile ||
      smem != 8 * KL_SORT_TILE + (8 + 2 * KL_SORT_WARPS) * (1 << digit) ||
      (passes > 1 && (alt_key == nullptr || alt_order == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      kl_sort_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int R = 1 << digit;
  const int scan = blocks < KL_SORT_SCAN ? (blocks + 31) / 32 * 32
                                         : KL_SORT_SCAN;
  const unsigned* kin = (const unsigned*)key;
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    unsigned* kout = (unsigned*)(to_out ? skey : alt_key);
    int* vout = (int*)(to_out ? order : alt_order);
    kl_sort_hist<<<blocks, KL_SORT_THREADS, 0, st>>>(
        kin, (int)M, p * digit, digit, blocks, (int*)counts);
    kl_sort_scan_rows<<<R, scan, 0, st>>>((int*)counts, blocks);
    kl_sort_scatter<<<blocks, KL_SORT_THREADS, smem, st>>>(
        kin, vin, (int)M, p * digit, digit, blocks, (const int*)counts,
        kout, vout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    kin = kout;
    vin = vout;
  }
  return (int)cudaSuccess;
}
