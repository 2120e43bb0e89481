// K3 (with the K4 parent fold): chain collapse over the sorted state.
//
// Replaces kmerlsh_tpu/cluster/engine.py:335 chain_collapse (with _seg_scan,
// _rev_fill and segment.segment_starts) and the per-program parent fold of
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
// Bound on the H100: device-memory bandwidth (the [S, M] values read once
// and written once, and a few int32 arrays). The design:
//   * One block per sub-range of P positions, P a power of two that divides
//     2^15 and follows S (kernels.chain_plan: the S x P value tile stays in
//     48 KB, so several blocks share an SM), so the card fills at every
//     capacity: 4096 blocks at 2^21 x 20.
//   * The block stages its S x P values, plus one halo column on each side,
//     in shared memory with cp.async (coalesced: neighbouring threads take
//     neighbouring positions) and writes each output value once from there.
//   * Links: thread i sums the cosine of positions i - 1 and i over s = 0,
//     1, ... with separately rounded operations, as the plain version does,
//     so the links agree bit for bit.
//   * Sums: a block-wide segmented scan per value row and for the sizes.
//     Inside a warp the sizes go by shuffles and the value rows one lane per
//     row over the warp's 32 positions (the head and last masks are the
//     warp's ballots, the same for every row; a fused multiply-add a value
//     instead of five shuffle steps); across the warps one warp scans their
//     totals. The centroids are summed in another order than the
//     reference's log-step scan and scaled by the reciprocal of the size:
//     they agree to rounding, not bit for bit.
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
//     A block writes every position whose chain head lies inside it before
//     it looks back; only the open prefix (the positions before its first
//     head) waits for the carry. One warp writes the aggregate and fences
//     once before it sets the flag.
//   * The last member of a chain writes the slot at the head position and
//     the parent entry, wherever the head lies. These scattered 4-byte
//     writes are what the kernel spends most beyond a copy of its bytes:
//     a parent line that the stream of values and int columns evicts from
//     L2 between two writes costs a read-modify-write of its sector in
//     device memory. So the values are read and written with an L2
//     evict-first policy (createpolicy), the int columns read and written
//     in sorted order streamed (ld/st.global.cs, evict-first too) and the
//     parent entries written with evict-last: where the parent array fits
//     the 50 MB L2 beside the stream (a rank's 16 MB shard at 2^22), the
//     fold then costs little more than the kernel without it
//     (tools/kernel_variants.py fold).

#include "common.cuh"

#define KL_CHAIN_STRIDE 32768   // chains are cut at multiples of 2^15
#define KL_CHAIN_MAX_P 512
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

// kl_cp_async4 with an L2 policy
__device__ __forceinline__ void kl_cp_async4_pol(void* dst, const void* src,
                                                 unsigned long long pol) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void kl_st_pol(float* p, float v,
                                          unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(pol)
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
// the same): the value tile [S][P + 3] (an odd row length: lanes reading
// one column of 32 rows hit 32 banks), sizes and keys [P + 2], slots [P],
// links [P + 1], the alive sizes as floats [P], the warps' value totals
// [S][P / 32], their size totals and latest heads [P / 32] each, the
// carry's value sums [S] and 4 ints.
static inline long long kl_chain_words(long long S, long long P) {
  return S * (P + 3) + 2 * (P + 2) + P + (P + 1) + P + S * (P / 32) +
         2 * (P / 32) + S + 4;
}

__global__ void __launch_bounds__(KL_CHAIN_MAX_P, 4) kl_chain_kernel(
    const float* __restrict__ sv, int S, long long M, int P,
    const int* __restrict__ ssize, const int* __restrict__ sslot,
    const int* __restrict__ skey, const int* __restrict__ smi, float thr,
    int free_bits, float* __restrict__ out_v, int* __restrict__ out_size,
    int* __restrict__ out_slot, int* __restrict__ out_mi,
    int* __restrict__ parent, long long pbase, int* __restrict__ status,
    int* agg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, nw = P >> 5;
  const int L = P + 3;
  float* tile = (float*)smem;                        // [S][L]: column j is
  int* csz = (int*)(tile + (long long)S * L) + 1;    // position base - 1 + j
  int* ckey = csz + P + 2;                           // [-1, P]
  int* cslot = ckey + P + 1;                         // [P]
  int* clink = cslot + P;                            // [P + 1]
  float* cw = (float*)(clink + P + 1);               // [P]
  float* wv = cw + P;                                // [S][nw]
  int* ww = (int*)(wv + (long long)S * nw);          // [nw]
  int* whp = ww + nw;                                // [nw]
  float* carry_v = (float*)(whp + nw);               // [S]
  int* misc = (int*)(carry_v + S);                   // id, carry hp/slot/w

  // the values and int columns stream through L2 once; the parent
  // entries stay
  const unsigned long long stream = kl_evict_first(), keep = kl_evict_last();
  const long long nsub = gridDim.x;
  if (i == 0) misc[0] = atomicAdd(status + nsub, 1);
  __syncthreads();
  const long long id = misc[0];
  const long long base = id * P;
  const int n = (int)min((long long)P, M - base);
  const bool has_left = base > 0, has_right = base + P < M;

  // 1. stage the values (cp.async) and the int columns of [-1, P]
  for (int s = 0; s < S; ++s) {
    const float* row = sv + (long long)s * M + base;
    float* trow = tile + (long long)s * L + 1;
    if (i < n) kl_cp_async4_pol(trow + i, row + i, stream);
    else trow[i] = 0.f;   // past M: the scan multiplies it by a size of 0
    if (i == 0 && has_left) kl_cp_async4_pol(trow - 1, row - 1, stream);
    if (i == P - 1 && has_right) kl_cp_async4_pol(trow + P, row + P, stream);
  }
  if (i < n) {
    csz[i] = __ldcs(ssize + base + i);
    ckey[i] = __ldcs(skey + base + i);
    cslot[i] = __ldcs(sslot + base + i);
  } else {
    csz[i] = 0;
    ckey[i] = KL_BIG_KEY;
    cslot[i] = 0;
  }
  if (i == 0) {
    csz[-1] = has_left ? ssize[base - 1] : 0;
    ckey[-1] = has_left ? skey[base - 1] : KL_BIG_KEY;
  }
  if (i == P - 1) {
    csz[P] = has_right ? ssize[base + P] : 0;
    ckey[P] = has_right ? skey[base + P] : KL_BIG_KEY;
  }
  kl_cp_async_wait_all();
  __syncthreads();

  // 2. links of positions 0 .. P (P: the next sub-range's first position)
  auto link_at = [&](int j) -> int {
    const long long p = base + j;
    if (p >= M || (p & (KL_CHAIN_STRIDE - 1)) == 0) return 0;
    const int k = ckey[j], kq = ckey[j - 1];
    if (!kl_alive(csz[j], k) || !kl_alive(csz[j - 1], kq) ||
        (k >> free_bits) != (kq >> free_bits))
      return 0;
    float dot = 0.f, na = 0.f, nb = 0.f;
    for (int s = 0; s < S; ++s) {
      const float a = tile[(long long)s * L + 1 + j];
      const float b = tile[(long long)s * L + j];
      dot = __fadd_rn(dot, __fmul_rn(a, b));
      na = __fadd_rn(na, __fmul_rn(a, a));
      nb = __fadd_rn(nb, __fmul_rn(b, b));
    }
    const float nn = __fsqrt_rn(__fmul_rn(na, nb));
    const float sim = __fdiv_rn(dot, nn > 0.f ? nn : 1.f);
    return sim >= thr;
  };
  clink[i] = link_at(i);
  if (i == 0) clink[P] = link_at(P);
  __syncthreads();

  const int sz = csz[i];
  const bool alive = i < n && kl_alive(sz, ckey[i]);
  const bool link = clink[i];
  const bool head = alive && !link;
  const bool last = alive && !clink[i + 1];
  const unsigned heads = __ballot_sync(KL_FULL, head);
  const unsigned lasts = __ballot_sync(KL_FULL, last);
  const int reach = kl_seg_reach(heads, lane);
  const unsigned upto = heads & (KL_FULL >> (31 - lane));
  const int hl = upto ? 31 - __clz(upto) : -1;   // latest head lane <= lane

  // 3. segmented scans inside each warp: the sizes by shuffles; the value
  //    rows one lane per row, serially over the warp's 32 positions with the
  //    warp's head and last masks (the warp-local sum of a last position
  //    replaces its value in the tile)
  int w = alive ? sz : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(KL_FULL, w, d);
    if (d <= reach) w += u;
  }
  if (lane == 31) {
    ww[warp] = w;
    whp[warp] = hl >= 0 ? warp * 32 + hl : -1;
  }
  cw[i] = alive ? (float)sz : 0.f;
  __syncwarp();
  for (int s = lane; s < S; s += 32) {
    float* x = tile + (long long)s * L + 1 + warp * 32;
    const float* f = cw + warp * 32;
    float c = 0.f;   // a dead position adds x * 0
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      c = __fmaf_rn(x[j], f[j], (heads >> j) & 1 ? 0.f : c);
      if ((lasts >> j) & 1) x[j] = c;
    }
    wv[(long long)s * nw + warp] = c;
  }
  __syncthreads();

  // 4. across the warps: exclusive prefixes in place, and this block's
  //    aggregate (from an empty state): its value sums into carry_v, its
  //    last head, that head's slot and its size sum into misc[1..3]
  const unsigned wheads = __ballot_sync(KL_FULL, lane < nw && whp[lane] >= 0);
  const int wreach = kl_seg_reach(wheads, lane);
  for (int s = warp; s < S; s += nw) {
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
      misc[2] = hp >= 0 ? cslot[hp] : 0;
      misc[3] = tot;
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

  // 6. this position's chain: its head and inclusive size sum inside the
  //    block; "open" when no head precedes it in the block (its chain
  //    enters from the left: the carry completes it)
  int hloc = hl >= 0 ? warp * 32 + hl : -1;
  if (hloc < 0) {
    const unsigned before = wheads & ((1u << warp) - 1);
    if (before) hloc = whp[31 - __clz(before)];
  }
  const bool open = hloc < 0;
  const int w_in = hl >= 0 ? w : ww[warp] + w;
  const long long p = base + i;
  // every value written once, coalesced along the rows, then the ints
  auto emit = [&](int W, long long habs, int hslot) {
    const float rw = __frcp_rn((float)max(W, 1));
    for (int s = 0; s < S; ++s) {
      float x = tile[(long long)s * L + 1 + i];
      if (last) {
        if (hl < 0) x = __fadd_rn(wv[(long long)s * nw + warp], x);
        if (open) x = __fadd_rn(carry_v[s], x);
        x = __fmul_rn(x, rw);
      }
      kl_st_pol(out_v + (long long)s * M + p, x, stream);
    }
    const int slot = cslot[i];
    __stcs(out_size + p, last ? W : (alive ? 0 : sz));
    if (out_mi)
      __stcs(out_mi + p, (alive && !last) ? hslot
                                        : (smi ? __ldcs(smi + p) : -1));
    if (last) {
      __stcs(out_slot + p, hslot);
      if (habs != p) {   // the last member's slot moves to the head and dies
        out_slot[habs] = slot;
        if (parent) kl_st_pol(parent + ((long long)slot - pbase), hslot, keep);
      }
    } else if (link) {
      __stcs(out_slot + p, slot);
      if (parent) kl_st_pol(parent + ((long long)slot - pbase), hslot, keep);
    } else if (!alive) {
      __stcs(out_slot + p, slot);
    }   // a head that is not last: written by its chain's last member
  };
  // 7. warp 0 looks back, for a chain entering from the left (then base is
  //    no multiple of 2^15 and position 0 of the block is open), while the
  //    other warps write the positions whose head lies in the block; then
  //    it writes its own
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
  if (!open && i < n) emit(w_in, base + hloc, cslot[hloc]);
  __syncthreads();
  if (open && i < n) emit(w_in + misc[3], misc[1], misc[2]);
}

KL_EXPORT int kl_chain_collapse(const void* sv, int S, long long M,
                                const void* ssize, const void* sslot,
                                const void* skey, const void* smi, float thr,
                                int free_bits, int P, int smem, void* status,
                                void* agg, void* out_v, void* out_size,
                                void* out_slot, void* out_mi, void* parent,
                                long long base, void* stream) {
  if (P < 32 || P > KL_CHAIN_MAX_P || (P & (P - 1)) != 0 ||
      (long long)smem != 4 * kl_chain_words(S, P) || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kl_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kl_chain_kernel<<<kl_blocks(M, P), P, smem, (cudaStream_t)stream>>>(
      (const float*)sv, S, M, P, (const int*)ssize, (const int*)sslot,
      (const int*)skey, (const int*)smi, thr, free_bits, (float*)out_v,
      (int*)out_size, (int*)out_slot, (int*)out_mi, (int*)parent, base,
      (int*)status, (int*)agg);
  return (int)cudaGetLastError();
}
