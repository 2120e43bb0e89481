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
// the digit as narrow as they allow; 31 bits take four passes of 8). Every
// pass ranks the keys of a tile of KL_SORT_TILE keys the same way
// (kl_tile_rank): warp w takes 32 x KPT consecutive keys in rounds of 32
// and ranks each key among the equal digits before it, inside a round by
// ballots (one a digit bit: the lanes below it with its digit), across
// rounds by the warp's digit counters in shared memory, across warps by
// those counters summed in warp order. Keys and payloads go through shared
// memory in digit order (kl_tile_stage), then out to the digit's place
// (kl_tile_write), so that consecutive threads write each digit's run of
// the tile. Tile order in the digits' offsets and the rank in input order
// inside a tile make every pass stable. The first pass makes the payload
// from the index and reads none; the passes ping-pong between the outputs
// and a scratch pair, so that the last pass writes the outputs. A route
// (kernels.sort_plan, by M and the passes) says where a tile's digit
// offsets come from:
//   (0) one launch (M <= KL_SORT_ONE_MAX): kl_sort_grid, a cooperative
//       launch of a block a tile; each pass a block ranks and stages its
//       tile and writes its digits' counts, a grid-wide sync, then each
//       block sums the counts of the tiles before its own and of all (the
//       digits' starts by a block scan) and writes out; a grid-wide sync
//       between passes.
//   (1) one sweep, 2 + passes launches: kl_sort_hist_all reads the keys
//       once, a block whole tiles, and counts every pass's digits (a
//       block's counts in shared memory written out as one row) and each
//       tile's counts of the first pass's digits, and zeroes the status
//       words.
//       kl_sort_starts sums the rows into each pass's digit starts, scans
//       the first pass's tile counts over the tiles and zeroes the tile
//       tickets. Then one launch a pass of kl_sort_onesweep, a block a
//       tile: the first pass's offsets come from the scanned counts; in a
//       later one a block takes the next tile from the pass's ticket (so
//       that every tile before it is taken by a block already running),
//       ranks and stages it, publishes each digit's count in the tile's
//       status words, and finds the digit's count in the tiles before it
//       by a decoupled look-back, each step reading KL_SORT_WINDOW
//       predecessors' words.
//   (2) three launches a pass (a sort of one pass above KL_SORT_ONE_MAX:
//       the earlier design, whose one-pass histogram, kl_sort_hist, ran
//       faster than kl_sort_hist_all on 1-bit flags): per pass kl_sort_hist
//       counts each tile's digits, kl_sort_scan_rows scans each digit's row
//       over the tiles, kl_sort_scatter takes its offsets from the rows and
//       the digits' starts by a block scan of the rows' totals.
// A status word is 64 bits: the count in the low 32 (any M below 2^31),
// above it a tag, 2 pass + 2 for a tile's own count, 2 pass + 3 for the
// count of the tile and every tile before it. The tags of one pass are
// above every earlier pass's, so one zeroing a sort serves every pass.
//
// Measured on the H100 (tools/kernel_variants.py sort; PERF.md): ballots
// beat __match_any_sync, and 16 keys a thread beat 8, 12 and 24; a
// look-back window of 4 beats 1, 8 and 16; digits of 9 bits (25 bits in
// three passes, blocks of 512 threads) lose to four passes of 7; a
// persistent scatter that copies its next tile in (cp.async) while it
// ranks this one, and one block that runs every pass over its tiles in
// order (the small-M route), were slower and were not kept. Look-back
// costs a later pass about what a histogram of one pass does, so
// the first pass, whose tile counts the histogram gives, needs none.
//
// Bound on the H100: device-memory bandwidth. The sort must read the keys
// and write keys and order: 12 bytes a key. The one-sweep route moves 4
// bytes a key for the histograms, 12 in the first scatter (key in, key and
// index out) and 16 in each later one: 64 bytes a key at 31 bits in four
// passes. The status words, 2^digit a tile, and the counts go through the
// L2.

#include <cooperative_groups.h>

#include "common.cuh"

#define KL_SORT_THREADS 256       // threads of a tile block
#define KL_SORT_KPT 16            // keys a thread of a tile block
#define KL_SORT_TILE (KL_SORT_THREADS * KL_SORT_KPT)
#define KL_SORT_MAX_DIGIT 8
#define KL_SORT_MAX_PASSES ((31 + KL_SORT_MAX_DIGIT - 1) / KL_SORT_MAX_DIGIT)
#define KL_SORT_WINDOW 4          // predecessor tiles a look-back step reads
#define KL_SORT_HIST_THREADS 256
#define KL_SORT_HIST_INTS 524288  // ints of the histogram rows, at most: a
                                  // block a tile where the bins allow
#define KL_SORT_ONE_MAX 262144    // keys the one-launch route takes, at most
#define KL_SORT_STARTS 1024       // threads of a kl_sort_starts block

// bytes of a tile block's dynamic shared memory: its tile's keys and
// payloads, two ints a digit (its start in the tile and out there) and a
// 16-bit counter a digit for each warp
#define KL_SORT_SMEM(tile, warps, digit) \
  (8 * (tile) + (8 + 2 * (warps)) * (1 << (digit)))

static_assert((1 << KL_SORT_MAX_DIGIT) <= KL_SORT_THREADS,
              "a thread for each digit");
static_assert((1 << KL_SORT_MAX_DIGIT) <= KL_SORT_STARTS,
              "a thread for each digit");
static_assert(KL_SORT_TILE % KL_SORT_HIST_THREADS == 0,
              "a histogram block takes whole tiles");

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

// A tile's keys and payloads (vin null: the key's index) into registers:
// warp w takes the keys base + w 32 KPT + 32 r + lane. L2: loads that skip
// the L1, for what other blocks of the launch wrote.
template <int KPT, bool L2 = false>
__device__ __forceinline__ void kl_tile_load(const unsigned* kin,
                                             const int* vin, int M, int base,
                                             unsigned (&k)[KPT],
                                             int (&v)[KPT]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wbase = base + w * 32 * KPT + lane;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int i = wbase + 32 * r;
    if (L2) {
      k[r] = i < M ? __ldcg(kin + i) : 0u;
      v[r] = i >= M ? 0 : vin ? __ldcg(vin + i) : i;
    } else {
      k[r] = i < M ? kin[i] : 0u;
      v[r] = i >= M ? 0 : vin ? vin[i] : i;
    }
  }
}

// rk: each of the n keys' rank among the equal digits before it in its
// warp; cnt ([warps][2^digit] counters) ends as each warp's exclusive
// offsets of each digit in warp order. Returns, to thread t < 2^digit, the
// tile's count of digit t (0 to the others).
template <int THREADS, int KPT>
__device__ __forceinline__ int kl_tile_rank(const unsigned (&k)[KPT], int n,
                                            int shift, int digit,
                                            unsigned short* cnt,
                                            int (&rk)[KPT]) {
  const int R = 1 << digit, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned mask = R - 1;
  unsigned short* wc = cnt + w * R;
  for (int i = lane; i < R; i += 32) wc[i] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1;
  const int wl = w * 32 * KPT + lane;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const bool ok = wl + 32 * r < n;
    const unsigned dg = ok ? (k[r] >> shift) & mask : (unsigned)R;
    const unsigned m = kl_same_digit(dg, digit);
    const int pre = ok ? wc[dg] : 0;
    __syncwarp();
    if (ok && (m & lt) == 0) wc[dg] = (unsigned short)(pre + __popc(m));
    __syncwarp();
    rk[r] = pre + __popc(m & lt);
  }
  __syncthreads();
  int c = 0;
  if (t < R) {
#pragma unroll
    for (int u = 0; u < THREADS / 32; ++u) {
      const int x = cnt[u * R + t];
      cnt[u * R + t] = (unsigned short)c;
      c += x;
    }
  }
  return c;
}

// The ranked keys and payloads into shared memory in digit order (loc: a
// digit's start in the tile).
template <int KPT>
__device__ __forceinline__ void kl_tile_stage(
    const unsigned (&k)[KPT], const int (&v)[KPT], const int (&rk)[KPT],
    int n, int shift, int digit, const int* loc, const unsigned short* cnt,
    unsigned* sk, int* sv) {
  const int R = 1 << digit, t = threadIdx.x, w = t >> 5;
  const unsigned mask = R - 1;
  const unsigned short* wc = cnt + w * R;
  const int wl = w * 32 * KPT + (t & 31);
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    if (wl + 32 * r < n) {
      const unsigned dg = (k[r] >> shift) & mask;
      const int p = rk[r] + loc[dg] + wc[dg];
      sk[p] = k[r];
      sv[p] = v[r];
    }
  }
}

// The staged tile out: staged key j to j + gml[its digit].
template <int THREADS>
__device__ __forceinline__ void kl_tile_write(const unsigned* sk,
                                              const int* sv, int n,
                                              int shift, unsigned mask,
                                              const int* gml, unsigned* kout,
                                              int* vout) {
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const unsigned key = sk[j];
    const int o = j + gml[(key >> shift) & mask];
    kout[o] = key;
    vout[o] = sv[j];
  }
}

// --- route 1: one sweep -----------------------------------------------------

// Blocks take whole tiles (tile, + gridDim.x, ...): every pass's digit
// counts of the block's keys as row blockIdx.x of partial ([gridDim.x]
// [passes << digit]), and each tile's own counts of the first pass's
// digits, digit-major, in counts ([2^digit][tiles]); the status words
// zeroed. One-bit digits are counted a warp at a time (a ballot), since
// every lane of a warp would add to one of two counters.
__global__ void __launch_bounds__(KL_SORT_HIST_THREADS) kl_sort_hist_all(
    const unsigned* __restrict__ kin, int M, int tiles, int digit,
    int passes, int* __restrict__ partial, int* __restrict__ counts,
    unsigned long long* __restrict__ status) {
  constexpr int U = KL_SORT_TILE / KL_SORT_HIST_THREADS;   // keys a tile
  __shared__ int hist[KL_SORT_MAX_PASSES << KL_SORT_MAX_DIGIT];
  __shared__ int first[1 << KL_SORT_MAX_DIGIT];   // this tile's, pass 0
  const int R = 1 << digit, nbins = passes << digit, t = threadIdx.x;
  const unsigned mask = R - 1;
  for (int i = t; i < nbins; i += KL_SORT_HIST_THREADS) hist[i] = 0;
  const long long n_status = (long long)tiles * R;
  for (long long i = (long long)blockIdx.x * KL_SORT_HIST_THREADS + t;
       i < n_status; i += (long long)gridDim.x * KL_SORT_HIST_THREADS)
    status[i] = 0ull;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    unsigned x[U];   // the loads first: they run on while first is zeroed
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tile * KL_SORT_TILE + u * KL_SORT_HIST_THREADS + t;
      x[u] = i < M ? kin[i] : 0u;
    }
    for (int i = t; i < R; i += KL_SORT_HIST_THREADS) first[i] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = tile * KL_SORT_TILE + u * KL_SORT_HIST_THREADS + t < M;
      if (digit == 1) {
        const unsigned all = __ballot_sync(0xFFFFFFFFu, ok);
        for (int p = 0; p < passes; ++p) {
          const int ones =
              __popc(__ballot_sync(0xFFFFFFFFu, ok && (x[u] >> p) & 1u));
          if ((t & 31) == 0 && all) {
            int* c = p ? hist + (p << 1) : first;
            atomicAdd(c, __popc(all) - ones);
            atomicAdd(c + 1, ones);
          }
        }
      } else if (ok) {
        atomicAdd(&first[x[u] & mask], 1);
        for (int p = 1; p < passes; ++p)
          atomicAdd(&hist[(p << digit) + ((x[u] >> (p * digit)) & mask)], 1);
      }
    }
    __syncthreads();
    for (int i = t; i < R; i += KL_SORT_HIST_THREADS) {
      counts[(long long)i * tiles + tile] = first[i];
      hist[i] += first[i];
    }
    __syncthreads();   // first read out before the next tile zeroes it
  }
  for (int i = t; i < nbins; i += KL_SORT_HIST_THREADS)
    partial[(long long)blockIdx.x * nbins + i] = hist[i];
}

// row[0..n) into exclusive offsets, in place, by the block; returns the
// row's total.
__device__ __forceinline__ int kl_scan_row(int* row, int n) {
  int carry = 0, total;
  for (int b0 = 0; b0 < n; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int before = kl_block_scan(b < n ? row[b] : 0, &total);
    if (b < n) row[b] = carry + before;
    carry += total;
    __syncthreads();
  }
  return carry;
}

// Block p < passes: pass p's digit starts, the exclusive scan of its
// digits' counts summed over the rows of partial (block 0 also zeroes the
// passes' tickets). Block passes + d: row d of counts into exclusive
// offsets over the tiles, in place.
__global__ void __launch_bounds__(KL_SORT_STARTS) kl_sort_starts(
    const int* __restrict__ partial, int rows, int digit, int passes,
    int* __restrict__ start, int* __restrict__ ticket,
    int* __restrict__ counts, int tiles) {
  __shared__ int part[KL_SORT_STARTS];
  const int R = 1 << digit, nbins = passes << digit, t = threadIdx.x;
  const int p = blockIdx.x;
  int total;
  if (p >= passes) {
    kl_scan_row(counts + (long long)(p - passes) * tiles, tiles);
    return;
  }
  const int col = t & (R - 1), groups = KL_SORT_STARTS >> digit;
  int s = 0;
  for (int g = t >> digit; g < rows; g += groups)
    s += partial[(long long)g * nbins + (p << digit) + col];
  part[t] = s;
  __syncthreads();
  int c = 0;
  if (t < R)
    for (int u = 0; u < groups; ++u) c += part[u * R + t];
  const int e = kl_block_scan(c, &total);
  if (t < R) start[(p << digit) + t] = e;
  if (p == 0 && t < passes) ticket[t] = 0;
}

// The count of digit t in the tiles before `tile`: the own counts of the
// nearest predecessors back to one whose word holds its inclusive count,
// KL_SORT_WINDOW words a step; a word not yet published is read again.
__device__ __forceinline__ unsigned kl_look_back(
    const unsigned long long* status, int tile, int R, int t, unsigned own) {
  const volatile unsigned long long* st = status;
  unsigned before = 0;
  int j = tile - 1;   // the nearest tile not yet summed
  for (;;) {
    unsigned long long w[KL_SORT_WINDOW];
#pragma unroll
    for (int q = 0; q < KL_SORT_WINDOW; ++q)
      w[q] = j - q >= 0 ? st[(long long)(j - q) * R + t] : 0ull;
    unsigned sum = 0;
    int used = 0;
    bool stop = false, done = false;
#pragma unroll
    for (int q = 0; q < KL_SORT_WINDOW; ++q) {
      const unsigned tag = (unsigned)(w[q] >> 32);
      if (!stop) {
        if (tag < own) {
          stop = true;   // not published in this pass yet
        } else {
          sum += (unsigned)w[q];
          ++used;
          if (tag > own) stop = done = true;   // inclusive: the chain ends
        }
      }
    }
    before += sum;
    if (done) return before;
    j -= used;
  }
}

// One pass over one tile a block. The first pass (LOOK false) takes tile
// blockIdx.x and its digits' offsets from the scanned rows of counts; a
// later one takes the next tile from the pass's ticket, publishes its
// digits' counts and finds their counts in the tiles before it by the
// look-back.
template <bool LOOK>
__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_onesweep(
    const unsigned* __restrict__ kin, const int* __restrict__ vin, int M,
    int tiles, int shift, int digit, int pass, const int* __restrict__ start,
    const int* __restrict__ counts, unsigned long long* status, int* ticket,
    unsigned* __restrict__ kout, int* __restrict__ vout) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile;
  const int R = 1 << digit, t = threadIdx.x;
  unsigned* sk = (unsigned*)smem;
  int* sv = (int*)(sk + KL_SORT_TILE);
  int* loc = sv + KL_SORT_TILE;
  int* gml = loc + R;
  unsigned short* cnt = (unsigned short*)(gml + R);
  int tile = blockIdx.x;
  if (LOOK) {
    if (t == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    tile = s_tile;
  }
  const int base = tile * KL_SORT_TILE, n = min(KL_SORT_TILE, M - base);
  const int head = !LOOK && t < R ? counts[(long long)t * tiles + tile] : 0;
  unsigned k[KL_SORT_KPT];
  int v[KL_SORT_KPT], rk[KL_SORT_KPT];
  kl_tile_load<KL_SORT_KPT>(kin, vin, M, base, k, v);
  const int c = kl_tile_rank<KL_SORT_THREADS, KL_SORT_KPT>(k, n, shift, digit,
                                                           cnt, rk);
  const unsigned own = 2 * pass + 2;
  volatile unsigned long long* mine =
      status + (long long)tile * R + (t < R ? t : 0);
  if (LOOK && t < R)
    *mine = ((unsigned long long)(tile ? own : own + 1) << 32) | (unsigned)c;
  int total;
  const int l = kl_block_scan(c, &total);
  if (t < R) loc[t] = l;
  __syncthreads();
  // staged before the look-back, which then waits on fewer predecessors
  kl_tile_stage<KL_SORT_KPT>(k, v, rk, n, shift, digit, loc, cnt, sk, sv);
  if (t < R) {
    unsigned before = head;
    if (LOOK && tile) {
      before = kl_look_back(status, tile, R, t, own);
      *mine = ((unsigned long long)(own + 1) << 32) | (before + c);
    }
    gml[t] = start[t] + (int)before - l;
  }
  __syncthreads();
  kl_tile_write<KL_SORT_THREADS>(sk, sv, n, shift, R - 1, gml, kout, vout);
}

// --- route 0: one cooperative launch ----------------------------------------

// Block b takes tile b in every pass; after it ranks and stages its tile,
// a grid-wide sync, then each digit's count in the tiles before it and the
// digits' starts from every tile's counts; a grid-wide sync between passes.
__global__ void __launch_bounds__(KL_SORT_THREADS, 2) kl_sort_grid(
    const unsigned* key, int M, int digit, int passes, int* counts,
    unsigned* skey, int* order, unsigned* alt_key, int* alt_order) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int R = 1 << digit, t = threadIdx.x, b = blockIdx.x;
  const int nb = gridDim.x, base = b * KL_SORT_TILE;
  const int n = min(KL_SORT_TILE, M - base);
  unsigned* sk = (unsigned*)smem;
  int* sv = (int*)(sk + KL_SORT_TILE);
  int* loc = sv + KL_SORT_TILE;
  int* gml = loc + R;
  unsigned short* cnt = (unsigned short*)(gml + R);
  const unsigned* kin = key;
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    unsigned* kout = to_out ? skey : alt_key;
    int* vout = to_out ? order : alt_order;
    unsigned k[KL_SORT_KPT];
    int v[KL_SORT_KPT], rk[KL_SORT_KPT];
    kl_tile_load<KL_SORT_KPT, true>(kin, vin, M, base, k, v);
    const int c = kl_tile_rank<KL_SORT_THREADS, KL_SORT_KPT>(
        k, n, p * digit, digit, cnt, rk);
    if (t < R) counts[b * R + t] = c;
    int total;
    const int l = kl_block_scan(c, &total);
    if (t < R) loc[t] = l;
    __syncthreads();
    kl_tile_stage<KL_SORT_KPT>(k, v, rk, n, p * digit, digit, loc, cnt, sk,
                               sv);
    grid.sync();
    int before = 0, all = 0;
    if (t < R) {
      for (int u = 0; u < nb; ++u) {
        const int x = __ldcg(counts + u * R + t);
        before += u < b ? x : 0;
        all += x;
      }
    }
    const int start = kl_block_scan(all, &total);
    if (t < R) gml[t] = start + before - l;
    __syncthreads();
    kl_tile_write<KL_SORT_THREADS>(sk, sv, n, p * digit, R - 1, gml, kout,
                                   vout);
    if (p + 1 < passes) grid.sync();
    kin = kout;
    vin = vout;
  }
}

// --- route 2: three launches a pass -----------------------------------------

// A pass's digit counts of tile blockIdx.x, digit-major: counts[digit]
// [tile].
__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_hist(
    const unsigned* __restrict__ kin, int M, int shift, int digit,
    int tiles, int* __restrict__ counts) {
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
  if (t < R) counts[(long long)t * tiles + blockIdx.x] = hist[t];
}

// Block d: row d of counts into exclusive offsets over the tiles, in
// place, its total to counts[2^digit tiles + d].
__global__ void __launch_bounds__(KL_SORT_STARTS) kl_sort_scan_rows(
    int* __restrict__ counts, int tiles) {
  const int total =
      kl_scan_row(counts + (long long)blockIdx.x * tiles, tiles);
  if (threadIdx.x == 0)
    counts[(long long)gridDim.x * tiles + blockIdx.x] = total;
}

// A pass over tile blockIdx.x: its digits' offsets from the scanned rows,
// their starts by a block scan of the digits' totals.
__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_scatter(
    const unsigned* __restrict__ kin, const int* __restrict__ vin, int M,
    int shift, int digit, int tiles, const int* __restrict__ counts,
    unsigned* __restrict__ kout, int* __restrict__ vout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 1 << digit, t = threadIdx.x, tile = blockIdx.x;
  unsigned* sk = (unsigned*)smem;
  int* sv = (int*)(sk + KL_SORT_TILE);
  int* loc = sv + KL_SORT_TILE;
  int* gml = loc + R;
  unsigned short* cnt = (unsigned short*)(gml + R);
  const int base = tile * KL_SORT_TILE, n = min(KL_SORT_TILE, M - base);
  const int head = t < R ? counts[(long long)t * tiles + tile] : 0;
  const int all = t < R ? counts[(long long)R * tiles + t] : 0;
  unsigned k[KL_SORT_KPT];
  int v[KL_SORT_KPT], rk[KL_SORT_KPT];
  kl_tile_load<KL_SORT_KPT>(kin, vin, M, base, k, v);
  const int c = kl_tile_rank<KL_SORT_THREADS, KL_SORT_KPT>(k, n, shift, digit,
                                                           cnt, rk);
  int total;
  const int l = kl_block_scan(c, &total);
  if (t < R) loc[t] = l;
  __syncthreads();
  kl_tile_stage<KL_SORT_KPT>(k, v, rk, n, shift, digit, loc, cnt, sk, sv);
  const int start = kl_block_scan(all, &total);
  if (t < R) gml[t] = start + head - l;
  __syncthreads();
  kl_tile_write<KL_SORT_THREADS>(sk, sv, n, shift, R - 1, gml, kout, vout);
}

// --- entry ------------------------------------------------------------------

static long long kl_align(long long bytes) { return (bytes + 255) / 256 * 256; }

// The dynamic shared memory of the tile kernels at their widest digit,
// allowed once a process (the port drives one card a process).
static cudaError_t kl_sort_attributes() {
  static const cudaError_t err = [] {
    const int smem = KL_SORT_SMEM(KL_SORT_TILE, KL_SORT_THREADS / 32,
                                  KL_SORT_MAX_DIGIT);
    cudaError_t e = cudaFuncSetAttribute(
        kl_sort_onesweep<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kl_sort_onesweep<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kl_sort_grid,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kl_sort_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    return e;
  }();
  return err;
}

// The launch arithmetic is kmerlsh_tpu_torch.kernels.sort_plan, checked
// here. Routes: 0 one cooperative launch, 1 one sweep, 2 three launches a
// pass. scratch (scratch_bytes, 256-byte aligned parts): on route 1 the
// status words (blocks << digit of 8 bytes); the tiles' counts (blocks <<
// digit ints: route 0's of each pass, route 1's of its first; on route 2
// a pass's and the digits' totals, (blocks + 1) << digit); on route 1 the
// histogram rows (hist_blocks x passes << digit ints), the starts (passes
// << digit ints) and the tickets (passes ints); where passes > 1 the key
// and order pair the passes ping-pong through (M ints each). Positions
// are int32: M stays a tile below 2^31.
KL_EXPORT int kl_sort_keys(const void* key, long long M, int bits, int route,
                           int digit, int passes, int tile, int blocks,
                           int hist_blocks, int smem, void* scratch,
                           long long scratch_bytes, void* skey, void* order,
                           void* stream) {
  const bool sweep = route == 1;
  const int R = 1 << digit;
  long long hist_want = KL_SORT_HIST_INTS / ((long long)passes << digit);
  if (hist_want > blocks) hist_want = blocks;
  if (route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  const long long pair = passes > 1 ? 2 * kl_align(4 * M) : 0;
  const long long status = sweep ? kl_align(8LL * blocks * R) : 0;
  const long long counts = kl_align(4LL * (blocks + (route == 2)) * R);
  const long long rows = sweep ? kl_align(4LL * hist_blocks * passes * R) : 0;
  const long long starts = sweep ? kl_align(4LL * passes * R) : 0;
  const long long tickets = sweep ? kl_align(4LL * passes) : 0;
  if (M < 1 || M > 0x7FFFFFFFLL - KL_SORT_TILE || bits < 1 || bits > 31 ||
      digit < 1 || digit > KL_SORT_MAX_DIGIT || passes * digit < bits ||
      (passes - 1) * digit >= bits || (route == 0 && M > KL_SORT_ONE_MAX) ||
      tile != KL_SORT_TILE || blocks != (M + tile - 1) / tile ||
      hist_blocks != (sweep ? hist_want : 0) ||
      smem != KL_SORT_SMEM(tile, KL_SORT_THREADS / 32, digit) ||
      scratch_bytes != status + counts + rows + starts + tickets + pair ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = kl_sort_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* s = (unsigned char*)scratch;
  unsigned long long* words = (unsigned long long*)s;
  int* heads = (int*)(s + status);
  int* part = (int*)(s + status + counts);
  int* start = (int*)(s + status + counts + rows);
  int* ticket = (int*)(s + status + counts + rows + starts);
  unsigned* alt_key = (unsigned*)(s + status + counts + rows + starts +
                                  tickets);
  int* alt_order = (int*)((unsigned char*)alt_key + pair / 2);
  const unsigned* kin = (const unsigned*)key;
  int m = (int)M;
  if (route == 2) {
    const int scan = blocks < KL_SORT_STARTS ? (blocks + 31) / 32 * 32
                                             : KL_SORT_STARTS;
    const int* vin = nullptr;
    for (int p = 0; p < passes; ++p) {
      const bool to_out = (passes - 1 - p) % 2 == 0;
      unsigned* kout = to_out ? (unsigned*)skey : alt_key;
      int* vout = to_out ? (int*)order : alt_order;
      kl_sort_hist<<<blocks, KL_SORT_THREADS, 0, st>>>(kin, m, p * digit,
                                                       digit, blocks, heads);
      kl_sort_scan_rows<<<R, scan, 0, st>>>(heads, blocks);
      kl_sort_scatter<<<blocks, KL_SORT_THREADS, smem, st>>>(
          kin, vin, m, p * digit, digit, blocks, heads, kout, vout);
      kin = kout;
      vin = vout;
    }
    return (int)cudaGetLastError();
  }
  if (!sweep) {
    unsigned* sk = (unsigned*)skey;
    int* so = (int*)order;
    void* args[] = {&kin, &m, &digit, &passes, &heads, &sk, &so, &alt_key,
                    &alt_order};
    err = cudaLaunchCooperativeKernel((const void*)kl_sort_grid, blocks,
                                      KL_SORT_THREADS, args, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  kl_sort_hist_all<<<hist_blocks, KL_SORT_HIST_THREADS, 0, st>>>(
      kin, m, blocks, digit, passes, part, heads, words);
  kl_sort_starts<<<passes + R, KL_SORT_STARTS, 0, st>>>(
      part, hist_blocks, digit, passes, start, ticket, heads, blocks);
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    unsigned* kout = to_out ? (unsigned*)skey : alt_key;
    int* vout = to_out ? (int*)order : alt_order;
    if (p == 0)
      kl_sort_onesweep<false><<<blocks, KL_SORT_THREADS, smem, st>>>(
          kin, vin, m, blocks, 0, digit, 0, start, heads, words, ticket,
          kout, vout);
    else
      kl_sort_onesweep<true><<<blocks, KL_SORT_THREADS, smem, st>>>(
          kin, vin, m, blocks, p * digit, digit, p, start + p * R, heads,
          words, ticket + p, kout, vout);
    kin = kout;
    vin = vout;
  }
  return (int)cudaGetLastError();
}
