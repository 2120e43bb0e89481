// K3 (with the K4 parent fold): chain collapse of the state in sort order,
// with K2's gather folded into its staging, on columns or on a chain
// session's row state.
//
// Replaces kmerlsh_tpu/cluster/engine.py:335 chain_collapse (with _seg_scan,
// _rev_fill and segment.segment_starts), the payload move of its sort
// (engine.py:117 _sort_state) and the per-program parent fold of
// _iterate_update (engine.py:478, the fold at :553). In sorted order: a
// position links to the previous one when both are alive, share a bucket
// (key >> free_bits), the position is not a multiple of 2^15 (the
// reference's stride cut) and their cosine reaches the threshold. Each chain
// collapses onto its LAST position: size = the chain's total, value = the
// size-weighted mean, slot = the head's slot; the last position's own slot
// moves to the head position. Every other member dies: merged_into = head
// slot, and parent[slot - base] = head slot. Each slot dies once, so writing
// parent here equals the reference's fold. base is 0 on one device; a rank
// of the sharded path passes its parent shard, which holds the slots [base,
// base + c0_loc), so that the local phase's fold
// (kmerlsh_tpu/parallel/dist.py:112-113) runs here too.
//
// Two entries share the kernel (kl_chain_kernel<ROWS>, the staging, the
// arithmetic, the look-back and the parent fold alike; only the source of
// the staged rows and the writes differ):
//   * kl_chain_collapse, the [S, M] contract (the sharded path, pairing
//     sessions' deep init, engine.chain_collapse): the state as the
//     iteration holds it (values [S, M], whose rows may be strided, sizes
//     and slots, in input order), K9's order and sorted keys in; the
//     collapsed state in sorted position order out as columns. Two
//     launches: (a) K2's transpose (csrc/permute_state.cu
//     kl_permute_to_scratch) of the state into the profile-major scratch
//     [M, W], each column's S values, size and slot in a row of W words;
//     (b) kl_chain_kernel<false>, whose blocks stage the scratch rows of
//     their positions by order[pos].
//   * kl_chain_collapse_rows, a chain session's iteration (cluster/engine.py
//     _drive_session): the session carries its state between iterations as
//     those rows (K2's transpose once a session, kl_state_rows; W the least
//     multiple of 4 words at or above S + 2), so one launch,
//     kl_chain_kernel<true>: the blocks stage their positions' rows of the
//     state by order[pos] as (b) does, and write the collapsed rows in
//     sorted position order, a block's P rows one contiguous run of P * W
//     words in 16-byte stores, and the sizes as a column (the host's alive
//     count; K1b reads them too). Why: at 2^24 x 124 the transpose reads
//     the 8.3 GB state and writes 8.6 GB of scratch every iteration, ~26%
//     of a job's kernel time (PERF.md), for nothing but this staging; on
//     rows the kernel moves the state once, read by its rows and written
//     by its rows. Its bytes: the M staged rows (whole 32-byte sectors,
//     4 W bytes or a little more), the M rows written (4 W bytes), the
//     order, keys and sizes (12 M), and a parent entry and a slot word a
//     dying slot.
//
// Bound on the H100: device-memory bandwidth (the state read once by (a),
// its scratch written by (a) and read once by (b), the values written once,
// and a few int32 arrays). The design of (b):
//   * One block per sub-range of P positions, P a power of two that divides
//     2^15 and follows S (kernels.chain_plan: the P + 2 staged rows stay in
//     48 KB, so several blocks share an SM), so the card fills at every
//     capacity; T threads a block, T >= P apart from it (the threads past
//     P stage, scan and write; the SM holds more warps than positions).
//   * The block stages the scratch rows of its P positions and one halo
//     position on each side, row by row in 16-byte cp.async pieces (a warp
//     takes 512 contiguous bytes of a row), into rows of kl_stage_ld(W)
//     words: 16-byte aligned with an odd number of 16-byte pieces, so the
//     16-byte reads of eight neighbouring rows (a quarter warp) cover all
//     32 banks, and 32 lanes reading one word of 32 neighbouring rows reach
//     8 distinct banks (only the sizes and slots are read so, a few times a
//     position).
//   * Links: thread i sums the cosine of positions i - 1 and i over s = 0,
//     1, ... (16-byte reads of both rows) with separately rounded
//     operations, as the plain version does, so the links agree bit for bit.
//   * Sums: a block-wide segmented scan per value row and for the sizes.
//     Inside a warp of positions the sizes go by shuffles and each value row
//     serially over the warp's 32 positions, a thread per (warp of
//     positions, row) over all T threads, neighbouring threads on
//     neighbouring words of a row (the head and last masks are the warps'
//     ballots; a fused multiply-add a value); across the warps one warp
//     scans their totals per row. The centroids are summed in another order
//     than the reference's log-step scan and scaled by the reciprocal of the
//     size: they agree to rounding, not bit for bit.
//   * Carries across blocks: a decoupled look-back, chosen over a cluster of
//     8 CTAs per 2^15 tile because a CTA of a cluster holds 4096 positions,
//     more than its shared memory takes for S above ~13, so it would read
//     the values twice. Each block publishes its aggregate (last head
//     position and slot, size sum, S value sums since that head) to a
//     status array, then, only if its first position links to the one
//     before (a chain enters from the left), walks back over its
//     predecessors' aggregates until one holds a head. No chain crosses a
//     2^15 boundary, so the walk never passes the tile's first sub-range;
//     a chain may run through whole sub-ranges with no head inside them, and
//     the walk goes on through those. Blocks take their sub-range from an
//     atomic counter, so every sub-range a block waits on belongs to a
//     block that is already running and publishes without waiting.
//     The block writes every position whose chain head lies inside it
//     (from its first head on) before warp 0's look-back ends; only the
//     open prefix (the positions before its first head) waits for the
//     carry. One warp writes the aggregate and fences once before it sets
//     the flag.
//   * Writes: the values in sorted order, a thread per (position, 4 rows),
//     neighbouring threads on neighbouring positions (each store of a warp
//     128 contiguous bytes); on rows a thread per 16-byte piece of the
//     block's contiguous run (each store of a warp 512 contiguous bytes),
//     the piece that holds the slot word of a head that is not last in
//     4-byte stores that leave that word out. The last member of a chain
//     writes the slot at the head position and the parent entry, wherever
//     the head lies. These
//     scattered 4-byte writes are what the kernel spends most beyond a
//     copy of its bytes: a parent line that the stream of values and int
//     columns evicts from L2 between two writes costs a read-modify-write
//     of its sector in device memory. So the scratch rows are read and the
//     values written with an L2 evict-first policy (createpolicy), the int
//     columns read and written in sorted order streamed (ld/st.global.cs,
//     evict-first too) and the parent entries written with evict-last:
//     where the parent array fits the 50 MB L2 beside the stream (a rank's
//     16 MB shard at 2^22), the fold then costs little more than the kernel
//     without it (tools/kernel_variants.py fold).

#include "common.cuh"

#define KL_CHAIN_STRIDE 32768   // chains are cut at multiples of 2^15
#define KL_CHAIN_MAX_P 512
#define KL_CHAIN_MAX_T 512
#define KL_FULL 0xffffffffu

// L2 eviction policies for a whole access (createpolicy)
__device__ __forceinline__ unsigned long long kl_evict_first() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ unsigned long long kl_evict_last() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// kl_cp_async16 with an L2 policy
__device__ __forceinline__ void kl_cp_async16_pol(void* dst, const void* src,
                                                  unsigned long long pol) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(d),
      "l"(src), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void kl_st_pol(float* p, float v,
                                          unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void kl_st4_pol(float* p, float4 v,
                                           unsigned long long pol) {
  asm volatile(
      "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void kl_st_pol(int* p, int v,
                                          unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;\n" ::"l"(p),
               "r"(v), "l"(pol)
               : "memory");
}

__device__ __forceinline__ bool kl_alive(int size, int key) {
  return size > 0 && key != KL_BIG_KEY;
}

// Lanes back that a segmented inclusive scan may add from: the distance to
// the latest head at or before this lane (heads: a bit per lane), or the
// lane itself when there is none. Step d adds the value d lanes back iff
// d <= this.
__device__ __forceinline__ int kl_seg_reach(unsigned heads, int lane) {
  const unsigned upto = heads & (KL_FULL >> (31 - lane));
  return upto ? lane - (31 - __clz(upto)) : lane;
}

// Shared memory of one block, in 4-byte words (kernels.chain_plan computes
// the same): the row tile [P + 2][kl_stage_ld(W)] (row r: position
// base - 1 + r),
// keys [P + 2], links [P + 1], the alive sizes as floats [P], the warp-local
// inclusive size sums [P], the warps' value totals [S][P / 32] (first the
// staged rows' sources, P + 2 ints), their size totals, latest heads, head
// masks and last masks [P / 32] each, the carry's value sums [S] and 8 ints.
static inline long long kl_chain_words(long long S, long long W,
                                       long long P) {
  const long long nw = P / 32;
  const long long scan = S * nw > P + 2 ? S * nw : P + 2;
  return (P + 2) * kl_stage_ld(W) + (P + 2) + (P + 1) + 2 * P + scan + 4 * nw +
         S + 8;
}

// ROWS false: the outputs in sorted position order as columns (values
// [S, M], sizes, slots, merged_into). ROWS true: out_v holds rows [M, W] in
// the layout the block staged (values, size, slot, pads), and out_slot is
// not written; sizes and merged_into as columns.
template <bool ROWS>
__global__ void __launch_bounds__(KL_CHAIN_MAX_T) kl_chain_kernel(
    const unsigned* __restrict__ scr, int W, const int* __restrict__ order,
    int S, long long M, int P, const int* __restrict__ skey,
    const int* __restrict__ smi, float thr, int free_bits,
    float* __restrict__ out_v, int* __restrict__ out_size,
    int* __restrict__ out_slot, int* __restrict__ out_mi,
    int* __restrict__ parent, long long pbase, int* __restrict__ status,
    int* agg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int nw = P >> 5, L = kl_stage_ld(W), Sq = S >> 2, Q = (S + 3) >> 2;
  const int scan = max(S * nw, P + 2);
  float* tile = (float*)smem;                      // [P + 2][L]
  int* itile = (int*)tile;
  int* ckey = (int*)(tile + (long long)(P + 2) * L) + 1;   // [-1, P]
  int* clink = ckey + P + 1;                       // [P + 1]
  float* cw = (float*)(clink + P + 1);             // [P]
  int* cwin = (int*)(cw + P);                      // [P]
  float* wv = (float*)(cwin + P);                  // [S][nw]
  int* src = (int*)wv;                             // [P + 2], staging only
  int* ww = (int*)(wv + scan);                     // [nw]
  int* whp = ww + nw;                              // [nw]
  unsigned* wh = (unsigned*)(whp + nw);            // [nw]
  unsigned* wl = wh + nw;                          // [nw]
  float* carry_v = (float*)(wl + nw);              // [S]
  int* misc = (int*)(carry_v + S);   // id, carry hp/slot/w, first head
  // the size and slot of position j in [-1, P]: words S, S + 1 of its row
  auto size_at = [&](int j) { return itile[(long long)(j + 1) * L + S]; };
  auto slot_at = [&](int j) { return itile[(long long)(j + 1) * L + S + 1]; };

  // the scratch rows and int columns stream through L2 once; the parent
  // entries stay
  const unsigned long long stream = kl_evict_first(), keep = kl_evict_last();
  const long long nsub = gridDim.x;
  if (t == 0) misc[0] = atomicAdd(status + nsub, 1);
  __syncthreads();
  const long long id = misc[0];
  const long long base = id * P;
  const int n = (int)min((long long)P, M - base);

  // 1. the source rows and keys of positions [-1, P] (outside [0, M): no
  //    row, the key BIG_KEY), then the rows in 16-byte pieces, neighbouring
  //    threads on neighbouring pieces; a row outside [0, M) is zeros (size
  //    0: the scans multiply its values by 0)
  for (int r = t; r < P + 2; r += T) {
    const long long p = base - 1 + r;
    const bool in = p >= 0 && p < M, own = r >= 1 && r <= P;
    src[r] = in ? (own ? __ldcs(order + p) : order[p]) : -1;
    ckey[r - 1] = in ? (own ? __ldcs(skey + p) : skey[p]) : KL_BIG_KEY;
  }
  __syncthreads();
  const int QW = W >> 2;
  for (int e = t; e < (P + 2) * QW; e += T) {
    const int r = e / QW, q = e - r * QW, from = src[r];
    float* d = tile + (long long)r * L + 4 * q;
    if (from >= 0)
      kl_cp_async16_pol(d, scr + (long long)from * W + 4 * q, stream);
    else
      *(float4*)d = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  kl_cp_async_wait_all();
  __syncthreads();

  // 2. links of positions 0 .. P (P: the next sub-range's first position)
  auto link_at = [&](int j) -> int {
    const long long p = base + j;
    if (p >= M || (p & (KL_CHAIN_STRIDE - 1)) == 0) return 0;
    const int k = ckey[j], kq = ckey[j - 1];
    if (!kl_alive(size_at(j), k) || !kl_alive(size_at(j - 1), kq) ||
        (k >> free_bits) != (kq >> free_bits))
      return 0;
    const float* ra = tile + (long long)(j + 1) * L;
    const float* rb = tile + (long long)j * L;
    float dot = 0.f, na = 0.f, nb = 0.f;
    for (int q = 0; q < Sq; ++q) {
      const float4 a4 = *(const float4*)(ra + 4 * q);
      const float4 b4 = *(const float4*)(rb + 4 * q);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dot = __fadd_rn(dot, __fmul_rn(a[u], b[u]));
        na = __fadd_rn(na, __fmul_rn(a[u], a[u]));
        nb = __fadd_rn(nb, __fmul_rn(b[u], b[u]));
      }
    }
    for (int s = 4 * Sq; s < S; ++s) {
      const float a = ra[s], b = rb[s];
      dot = __fadd_rn(dot, __fmul_rn(a, b));
      na = __fadd_rn(na, __fmul_rn(a, a));
      nb = __fadd_rn(nb, __fmul_rn(b, b));
    }
    const float nn = __fsqrt_rn(__fmul_rn(na, nb));
    const float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
    return sim >= thr;
  };
  if (t < P) clink[t] = link_at(t);
  if (t == (T > P ? P : 0)) clink[P] = link_at(P);
  __syncthreads();

  // 3. a thread a position in warps 0 .. nw - 1: its chain inside its warp
  //    (the sizes by shuffles), the warp's masks, totals and latest head
  const bool pos = warp < nw;   // warp-uniform
  const int i = t;
  int sz = 0, w = 0, hl = -1;
  bool alive = false, link = false, last = false;
  if (pos) {
    sz = size_at(i);
    alive = i < n && kl_alive(sz, ckey[i]);
    link = clink[i];
    const bool head = alive && !link;
    last = alive && !clink[i + 1];
    const unsigned heads = __ballot_sync(KL_FULL, head);
    const unsigned lasts = __ballot_sync(KL_FULL, last);
    const int reach = kl_seg_reach(heads, lane);
    const unsigned upto = heads & (KL_FULL >> (31 - lane));
    hl = upto ? 31 - __clz(upto) : -1;   // latest head lane <= lane
    w = alive ? sz : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(KL_FULL, w, d);
      if (d <= reach) w += u;
    }
    if (lane == 31) {
      ww[warp] = w;
      whp[warp] = hl >= 0 ? warp * 32 + hl : -1;
    }
    if (lane == 0) {
      wh[warp] = heads;
      wl[warp] = lasts;
    }
    cw[i] = alive ? (float)sz : 0.f;
    cwin[i] = w;
  }
  __syncthreads();

  //    the value rows: a thread per (warp of positions g, row s), serially
  //    over g's 32 positions with its masks (the warp-local sum of a last
  //    position replaces its value in the tile)
  for (int e = t; e < nw * S; e += T) {
    const int g = e / S, s = e - g * S;
    float* x = tile + (long long)(g * 32 + 1) * L + s;   // position g*32 + j
    const float* f = cw + g * 32;                        // at x[j * L]
    const unsigned heads = wh[g], lasts = wl[g];
    float c = 0.f;   // a dead position adds x * 0
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      c = __fmaf_rn(x[j * L], f[j], (heads >> j) & 1 ? 0.f : c);
      if ((lasts >> j) & 1) x[j * L] = c;
    }
    wv[(long long)s * nw + g] = c;
  }
  __syncthreads();

  // 4. across the warps: exclusive prefixes in place, and this block's
  //    aggregate (from an empty state): its value sums into carry_v, its
  //    last head, that head's slot and its size sum into misc[1..3], its
  //    first head into misc[4] (P where it has none)
  const unsigned wheads = __ballot_sync(KL_FULL, lane < nw && whp[lane] >= 0);
  const int wreach = kl_seg_reach(wheads, lane);
  for (int s = warp; s < S; s += T >> 5) {
    float a = lane < nw ? wv[(long long)s * nw + lane] : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(KL_FULL, a, d);
      if (d <= wreach) a = __fadd_rn(u, a);
    }
    const float ex = __shfl_up_sync(KL_FULL, a, 1);
    const float tot = __shfl_sync(KL_FULL, a, nw - 1);
    if (lane < nw) wv[(long long)s * nw + lane] = lane ? ex : 0.f;
    if (lane == 0) carry_v[s] = tot;
  }
  if (warp == 0) {
    int a = lane < nw ? ww[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(KL_FULL, a, d);
      if (d <= wreach) a += u;
    }
    const int ex = __shfl_up_sync(KL_FULL, a, 1);
    const int tot = __shfl_sync(KL_FULL, a, nw - 1);
    if (lane < nw) ww[lane] = lane ? ex : 0;
    if (lane == 0) {
      const int hp = wheads ? whp[31 - __clz(wheads)] : -1;
      misc[1] = hp >= 0 ? (int)(base + hp) : -1;
      misc[2] = hp >= 0 ? slot_at(hp) : 0;
      misc[3] = tot;
      const int g0 = __ffs(wheads) - 1;
      misc[4] = wheads ? g0 * 32 + __ffs(wh[g0]) - 1 : P;
    }
  }
  __syncthreads();

  // 5. warp 0 publishes the aggregate: payload, one fence, then the flag
  if (warp == 0) {
    int* my_agg = agg + id * (3 + S);
    for (int s = lane; s < S; s += 32) ((float*)my_agg)[3 + s] = carry_v[s];
    if (lane < 3) my_agg[lane] = misc[1 + lane];
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(status + id, 1);
  }

  // 6. the writes. The positions [lo, hi) of the block's first n, open or
  //    not ("open": before the block's first head, so the chain enters from
  //    the left and the carry completes it). A last position's value is its
  //    chain's sum (the warp-local sum, the warps' prefix where its warp
  //    holds no head before it, the carry where it is open) over the
  //    chain's size. Columns: every value, by all threads, a thread per
  //    (position, 4 rows) with neighbouring threads on neighbouring
  //    positions. Rows: the n rows are n * W contiguous words, a thread per
  //    16-byte piece with neighbouring threads on neighbouring pieces, the
  //    size and slot from the tile (emit_ints puts them there first); a
  //    head that is not last leaves its slot word to its chain's last
  //    member, which may lie in another block.
  const int h0 = misc[4];
  auto last_sum = [&](float4 x4, int j, int q, bool open) -> float4 {
    const int g = j >> 5, lj = j & 31;
    float x[4] = {x4.x, x4.y, x4.z, x4.w};
    const int nk = min(4, S - 4 * q);
    if (nk > 0 && (wl[g] >> lj) & 1) {
      const bool into = (wh[g] & (KL_FULL >> (31 - lj))) == 0;
      const int Wc = (into ? ww[g] : 0) + cwin[j] + (open ? misc[3] : 0);
      const float rw = __frcp_rn((float)max(Wc, 1));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < nk) {
          const int s = 4 * q + u;
          float y = x[u];
          if (into) y = __fadd_rn(wv[(long long)s * nw + g], y);
          if (open) y = __fadd_rn(carry_v[s], y);
          x[u] = __fmul_rn(y, rw);
        }
      }
    }
    return make_float4(x[0], x[1], x[2], x[3]);
  };
  auto emit_values = [&](int lo, int hi, bool open) {
    const int span = hi - lo;
    if constexpr (ROWS) {
      const int QW = W >> 2, qslot = (S + 1) >> 2;
      float* o = out_v + (base + lo) * W;
      for (int e = t; e < span * QW; e += T) {
        const int jj = e / QW, q = e - jj * QW, j = lo + jj;
        const float4 x4 = last_sum(
            *(const float4*)(tile + (long long)(j + 1) * L + 4 * q), j, q,
            open);
        const int g = j >> 5, lj = j & 31;
        if (q == qslot && ((wh[g] & ~wl[g]) >> lj) & 1) {
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * q + u != S + 1)
              kl_st_pol(o + (long long)jj * W + 4 * q + u, x[u], stream);
        } else {
          kl_st4_pol(o + (long long)jj * W + 4 * q, x4, stream);
        }
      }
    } else {
      for (int e = t; e < span * Q; e += T) {
        const int q = e / span, j = lo + (e - q * span);
        const float4 x4 = last_sum(
            *(const float4*)(tile + (long long)(j + 1) * L + 4 * q), j, q,
            open);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
        const int nk = min(4, S - 4 * q);
        float* o = out_v + (long long)(4 * q) * M + base + j;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nk) kl_st_pol(o + (long long)u * M, x[u], stream);
      }
    }
  };
  //    the int columns and the parent entries, by position i's thread (on
  //    rows also its size and slot in the tile, for emit_values)
  auto emit_ints = [&](int Wc, long long habs, int hslot) {
    const long long p = base + i;
    const int slot = slot_at(i);
    const int size = last ? Wc : (alive ? 0 : sz);
    __stcs(out_size + p, size);
    if (out_mi)
      __stcs(out_mi + p, (alive && !last) ? hslot
                                        : (smi ? smi[__ldcs(order + p)] : -1));
    if constexpr (ROWS) {
      itile[(long long)(i + 1) * L + S] = size;
      if (last) itile[(long long)(i + 1) * L + S + 1] = hslot;
    }
    if (last) {
      if constexpr (!ROWS) __stcs(out_slot + p, hslot);
      if (habs != p) {   // the last member's slot moves to the head and dies
        if constexpr (ROWS)
          ((int*)out_v)[habs * W + S + 1] = slot;
        else
          out_slot[habs] = slot;
        if (parent) kl_st_pol(parent + ((long long)slot - pbase), hslot, keep);
      }
    } else if (link) {
      if constexpr (!ROWS) __stcs(out_slot + p, slot);
      if (parent) kl_st_pol(parent + ((long long)slot - pbase), hslot, keep);
    } else if (!alive) {
      if constexpr (!ROWS) __stcs(out_slot + p, slot);
    }   // a head that is not last: written by its chain's last member
  };
  int hloc = hl >= 0 ? warp * 32 + hl : -1;
  if (pos && hloc < 0) {
    const unsigned before = wheads & ((1u << warp) - 1);
    if (before) hloc = whp[31 - __clz(before)];
  }
  const bool open = hloc < 0;   // i < h0
  const int w_in = hl >= 0 ? w : (pos ? ww[warp] : 0) + w;
  const bool mine = pos && i < n;
  if constexpr (ROWS) {   // the rows from the first head on take the ints
    if (mine && !open) emit_ints(w_in, base + hloc, slot_at(hloc));
    __syncthreads();
  }

  // 7. warp 0 looks back, for a chain entering from the left (then base is
  //    no multiple of 2^15 and position 0 of the block is open), while the
  //    other warps write the positions from the block's first head on; then
  //    it writes its share of them; after a barrier, the open prefix
  if (warp == 0) {
    int c_hp = -1, c_slot = 0, c_w = 0;
    for (int s = lane; s < S; s += 32) carry_v[s] = 0.f;
    if (clink[0]) {
      const long long first = (base & ~(long long)(KL_CHAIN_STRIDE - 1)) / P;
      for (long long j = id - 1;; --j) {
        // every predecessor publishes unconditionally: one that never does
        // is a fault, reported as a launch error instead of a hung card
        for (unsigned spins = 0; lane == 0 && ((volatile int*)status)[j] == 0;
             ++spins) {
          if (spins > (1u << 24)) __trap();
          __nanosleep(32);
        }
        __syncwarp();
        __threadfence();
        const volatile int* a = agg + j * (3 + S);
        const int jhp = a[0], jslot = a[1];
        c_w += a[2];
        const volatile float* av = (const volatile float*)(a + 3);
        for (int s = lane; s < S; s += 32)
          carry_v[s] = __fadd_rn(av[s], carry_v[s]);
        if (jhp >= 0) {
          c_hp = jhp;
          c_slot = jslot;
          break;
        }
        if (j == first) break;
      }
    }
    if (lane == 0) {
      misc[1] = c_hp;
      misc[2] = c_slot;
      misc[3] = c_w;
    }
  }
  if (h0 < n) emit_values(h0, n, false);
  if constexpr (!ROWS)
    if (mine && !open) emit_ints(w_in, base + hloc, slot_at(hloc));
  __syncthreads();
  if constexpr (ROWS) {
    if (mine && open) emit_ints(w_in + misc[3], misc[1], misc[2]);
    __syncthreads();
  }
  if (h0 > 0) emit_values(0, min(h0, n), true);
  if constexpr (!ROWS)
    if (mine && open) emit_ints(w_in + misc[3], misc[1], misc[2]);
}

static bool kl_chain_plan_ok(int S, int W, int P, int T, int smem) {
  return W >= S + 2 && W % 4 == 0 && P >= 32 && P <= KL_CHAIN_MAX_P &&
         (P & (P - 1)) == 0 && T >= P && T <= KL_CHAIN_MAX_T && T % 32 == 0 &&
         (long long)smem == 4 * kl_chain_words(S, W, P) && smem <= 227 * 1024;
}

template <bool ROWS>
static int kl_chain_launch(const void* rows, int W, int S, long long M,
                           const void* order, const void* skey,
                           const void* smi, float thr, int free_bits, int P,
                           int T, int smem, void* status, void* agg,
                           void* out_v, void* out_size, void* out_slot,
                           void* out_mi, void* parent, long long base,
                           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kl_chain_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  kl_chain_kernel<ROWS><<<kl_blocks(M, P), T, smem, st>>>(
      (const unsigned*)rows, W, (const int*)order, S, M, P,
      (const int*)skey, (const int*)smi, thr, free_bits, (float*)out_v,
      (int*)out_size, (int*)out_slot, (int*)out_mi, (int*)parent, base,
      (int*)status, (int*)agg);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_chain_collapse(const void* vin, long long ld_in, int S,
                                long long M, const void* order,
                                const void* sizes, const void* slots,
                                const void* skey, const void* smi, float thr,
                                int free_bits, int W, int C, int move_smem,
                                int P, int T, int smem, void* scratch,
                                void* status, void* agg, void* out_v,
                                void* out_size, void* out_slot, void* out_mi,
                                void* parent, long long base, void* stream) {
  if (!kl_move_plan_ok(S, W, C, move_smem) ||
      !kl_chain_plan_ok(S, W, P, T, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int e = kl_permute_to_scratch(vin, ld_in, S, M, sizes, slots, W, C,
                                      move_smem, scratch, st);
  if (e != 0) return e;
  return kl_chain_launch<false>(scratch, W, S, M, order, skey, smi, thr,
                                free_bits, P, T, smem, status, agg, out_v,
                                out_size, out_slot, out_mi, parent, base, st);
}

// A chain session's iteration on its row state: rows [M, W] in input order
// (kl_state_rows' layout) in, the collapsed rows [M, W] in sorted position
// order and their sizes as a column out; one launch.
KL_EXPORT int kl_chain_collapse_rows(const void* rows, int W, int S,
                                     long long M, const void* order,
                                     const void* skey, float thr,
                                     int free_bits, int P, int T, int smem,
                                     void* status, void* agg, void* out_rows,
                                     void* out_size, void* parent,
                                     long long base, void* stream) {
  if (!kl_chain_plan_ok(S, W, P, T, smem)) return (int)cudaErrorInvalidValue;
  return kl_chain_launch<true>(rows, W, S, M, order, skey, nullptr, thr,
                               free_bits, P, T, smem, status, agg, out_rows,
                               out_size, nullptr, nullptr, parent, base,
                               (cudaStream_t)stream);
}
