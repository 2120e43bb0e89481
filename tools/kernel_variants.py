"""Time text variants of the LSH-key and finalize kernels, or of the chain
collapse's parent fold, against the sources as committed, on one CUDA
card, in one process.

    python3 tools/kernel_variants.py
    python3 tools/kernel_variants.py fold
    python3 tools/kernel_variants.py wrs [PARENT_ROOT]
    python3 tools/kernel_variants.py sort [PARENT_ROOT]
    python3 tools/kernel_variants.py pairing [PARENT_ROOT]

Each variant is a list of substitutions in ``kmerlsh_tpu_torch/csrc``; the
sources of every variant are compiled with the flags of
``kmerlsh_tpu_torch.kernels.build`` into a library of their own under
``build/kernel_variants/``, and the kernel wrappers run against each
library in turn (two rounds, the variants alternating). The inputs are
chip_smoke.py phase 3's at 2^21 and 2^24 x 20: lsh_keys on the first
iteration's state at the data's h, finalize on the state and forest after
six iterations. Prints each call's time (chip_smoke.cuda_ms) and whether
its outputs equal the plain version's. The variants:

  committed    the sources as they are;
  constant     lsh_keys reads its plane operands from the 64 KB constant
               bank (the planes copied there on the stream, read at a
               warp-uniform index) instead of shared memory;
  fma          lsh_keys sums each term with one fused multiply-add (not
               the plain version's rounding: a bound on what the float
               instructions cost);
  no-float     lsh_keys streams its values and writes its outputs but sums
               nothing (its memory and bookkeeping alone);
  no-memory    lsh_keys sums as committed but takes its values from
               registers (its float instructions alone);
  fma-no-memory  both of the two above;
  unroll2      lsh_keys' loop over the samples unrolled by two;
  bulk         lsh_keys fetches each value row of a block with one bulk
               copy (cp.async.bulk, completing on an mbarrier) issued by
               one thread, instead of four 4-byte cp.async a thread;
  persistent   lsh_keys on as many blocks as the card holds at once, each
               taking tiles blockIdx.x, + gridDim.x, ... with its value
               rows' copies running on across tiles and its planes staged
               once;
  write-back   finalize's root chase writes each root back over the row's
               and its parent's link, so that later chases stop early.

``fold`` times chain_collapse with the parent fold of a sharded rank (rank
1 of four: its slots and parent shard offset by base) and without it, on
chip_smoke.py phase 3's first iteration at 2^20, 2^22 and 2^24 x 20, for
the variants of FOLD_VARIANTS (two rounds, alternating; sizes, slots,
merged_into and the parent shard checked equal to the plain version's):

  committed      the sources as they are: the values read (cp.async) and
                 written with an L2 evict-first policy, the int columns
                 read and written in sorted order (sizes, keys, slots,
                 merged_into) streamed (ld/st.global.cs), the parent
                 entries written with evict-last (createpolicy), so that
                 the stream does not evict the parent shard's lines
                 between the scattered writes;
  no-hints       every access with the default policy;
  no-int-streams the int columns with the default policy;
  parent-last    the parent entries' policy alone;
  values-first   the values' policy alone.

``wrs`` times the t-test kernel (wrs_verdicts) on testdata.wrs_rows at
2^20 x (10 + 10) and 2^20 x (50 + 50), two rounds alternating; each
variant is ttest.cu alone in a library of its own, and its outputs are
checked against the plain version (verdicts exact, tails within rtol 1e-5 /
atol 1e-6). The variants of the committed source (WRS_VARIANTS; one whose
text the source does not hold is left out):

  committed          the sources as they are;
  no-table           each step's partial numerator computed from the row's
                     pair and the step, not read from the table;
  lgamma-a-row       the lgamma terms computed in each row's tail;
  copy-4             4-byte copies where 16-byte ones would do;
  no-fraction        no step after the first tabulated one;
  no-copies          no copy after a warp's first tile (the sums read it
                     again);
  no-sort            the rows that need the fraction left in their order;
  bounds-12          at most 40 registers a thread (12 blocks a SM);
  fast-div           the approximate division and square root everywhere;
  no-logs            the tail's logarithms and exponential left out;
  groups-in-order    group B's columns summed after group A's;

and the committed source on plans of one and two tiles
a warp (smaller blocks, sorted in smaller groups), with the blocks a SM
holds of each library's kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
and, given PARENT_ROOT, a tree
whose ttest.cu is the one-thread-a-row kernel of the parent (called with
its own entry point's arguments), that kernel and PARENT_WRS_VARIANTS:

  parent             the parent's kernel as it is;
  parent-no-fraction its continued fraction run for no step (the loads,
                     sums, prologue and tail alone);
  parent-no-loads    its values made from the row and column index instead
                     of loaded (the arithmetic alone; other rows, so other
                     step counts);
  parent-one-pass    the sums of squares from one pass over the values
                     (Σv² − x̄Σv: not the plain version's rounding), so each
                     value is loaded once.

``sort`` times the key sort (sort_keys) at each size chip_smoke.py phase
3 sorts: the lsh_keys output at 2^14, 2^16, 2^20, 2^21, 2^22 and 2^24 x
20 (31 bits; and at 2^17 and 2^18) and, on the 2^24 state after six iterations, finalize's row
keys (25 bits), the dead flags (1 bit) and finalize's cluster keys (25
bits), beside torch.sort (int64 indices, the port's call before the
kernel), two rounds (the second in the reverse order), each output checked
equal to the plain version's; then the card time by kernel at 2^24 of
the committed kernel and, given PARENT_ROOT, of the parent's. Each
variant is sort_keys.cu alone in a library of its own, with the plan its
defines need (SORT_VARIANTS):

  committed          the source as it is, on the route its plan takes
                     and on each route (the one-launch route up to its
                     limit);
  window-1, window-8, window-16
                     a look-back step reads 1, 8 or 16 predecessors'
                     words instead of 4;
  keys-8, keys-12, keys-24
                     8, 12 or 24 keys a thread of a tile block instead of
                     16 (tiles of 2048, 3072 or 6144 keys);
  digit-9            tile blocks of 512 threads of 8 keys with digits of
                     up to 9 bits (25 bits in three passes, 31 in four);
  hist-2^18          histogram rows of at most 2^18 ints instead of 2^19
                     (256 blocks at 31 bits instead of 512);
  bounds-3, bounds-4 the one-sweep scatter held to 85 or 64 registers a
                     thread (three or four blocks a SM);
  overlap            the look-back passes on persistent blocks, each
                     copying its next tile in (cp.async) while it ranks
                     and writes out this one;
  launch-2^20        the one-launch route up to 2^20 keys (its plan's
                     route up to there);

and, given PARENT_ROOT, the parent's sort_keys.cu through its own entry
point (the earlier design: three launches a pass).

A variant that does not compile is reported and left out.

``pairing`` times the pairing rounds (pairing_rounds, K10) on chip_smoke.py
phase 3's first sorted state at 2^20, 2^22 and 2^24 x 20, 4 rounds at 0.95
and 0.5 with a parent forest, and on one segment across 2^22 columns (the
cooperative launch alone), two rounds in turns, each call with the state
restored outside its CUDA events (chip_smoke.cuda_ms_restored) and its
outputs checked equal to the plain version's; then the card time by
kernel at 2^24. Each variant is pairing.cu alone in a library of its own,
with the plan its defines need (PAIRING_VARIANTS):

  committed          the source as it is: two launches, C from two
                     512-thread blocks a SM, the cooperative launch on
                     four blocks a SM;
  four-a-sm          256 threads and C from four blocks a SM (more
                     segments to the cooperative launch);
  eight-a-sm         128 threads and C from eight blocks a SM;
  one-a-sm           1024 threads and C from one block a SM;
  unroll             each loop over the samples unrolled by 4;
  no-prefetch        the short-segment blocks copy their range's columns
                     only once they know it (not the window's with its
                     keys);
  long-2             the cooperative launch on two blocks a SM;
  no-merge-math      (inexact) a merge leaves the left's values as they
                     are: the cost of the means;
  clocks             thread 0 of each short-segment block sums each
                     phase's cycles (clock64), logged a block;
  cosines-only       (inexact) every round's cosines, no merge;
  no-apply           (inexact) every round's ranks and list of pairs, no
                     cosine;
  no-rounds          (inexact) no round: the staging alone;

with the blocks a SM each library's kernels get (the occupancy API),
and, given PARENT_ROOT, the parent's pairing.cu through its own entry point
(the earlier design: three launches a round).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits where there is no card)

torch = cs.torch
from kmerlsh_tpu_torch import kernels  # noqa: E402
from kmerlsh_tpu_torch.cluster import engine  # noqa: E402
from kmerlsh_tpu_torch.kernels import build  # noqa: E402
from kmerlsh_tpu_torch.ops import rng  # noqa: E402

WORK = build.BUILD_DIR.parent / "kernel_variants"
SUM = """            acc[c][4 * q + k] =
                __fadd_rn(acc[c][4 * q + k], __fmul_rn(p[k], x[c]));"""
FMA = [("lsh_keys.cu", SUM, """            acc[c][4 * q + k] =
                __fmaf_rn(p[k], x[c], acc[c][4 * q + k]);""")]
ISSUE = """    kl_issue_row(ring, values, ld, s + KL_PROJ_RING - 1, S, m0, M);
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(KL_PROJ_RING - 1)
                 : "memory");   // this thread's row s has arrived
"""
READ = """    const float* slot = ring + (s % KL_PROJ_RING) * KL_PROJ_TILE + threadIdx.x;
    float x[KL_PROJ_COLS];
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c) x[c] = slot[c * KL_PROJ_THREADS];
"""
LOOP = "  for (int s = 0; s < S; ++s) {\n    kl_issue_row"
NO_MEMORY = [("lsh_keys.cu", ISSUE + READ, """    float x[KL_PROJ_COLS];
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c)
      x[c] = __int_as_float(0x3f800000 + (s << 6) + c + (int)threadIdx.x);
""")]
BULK = [
    ("lsh_keys.cu", """__device__ __forceinline__ void kl_issue_row(""", """\
__device__ __forceinline__ unsigned kl_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

#define KL_SLOT_BYTES (KL_PROJ_TILE * 4 + 32)   // a row segment, 16-byte ends

// Thread 0: one bulk copy of the 16-byte chunks that hold value row s of the
// block's columns [c0, c1) into ring slot s % KL_PROJ_RING, completing on
// that slot's barrier.
__device__ __forceinline__ void kl_fetch_row(unsigned char* ring,
                                             unsigned long long* full,
                                             const float* values, long long ld,
                                             int s, long long c0,
                                             long long c1) {
  const unsigned long long lo =
      (unsigned long long)(values + s * ld + c0) & ~15ull;
  const unsigned long long hi =
      ((unsigned long long)(values + s * ld + c1) + 15ull) & ~15ull;
  const unsigned bytes = (unsigned)(hi - lo);
  const int k = s % KL_PROJ_RING;
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(
          kl_smem(full + k)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(kl_smem(ring + k * KL_SLOT_BYTES)),
      "l"(lo), "r"(bytes), "r"(kl_smem(full + k))
      : "memory");
}

__device__ __forceinline__ void kl_wait_row(unsigned long long* bar,
                                            unsigned parity) {
  for (long long n = 0;; ++n) {
    unsigned ok;
    asm volatile(
        "{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\\n selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(ok)
        : "r"(kl_smem(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (n > (1ll << 24)) __trap();
  }
}

__device__ __forceinline__ void kl_issue_row("""),
    ("lsh_keys.cu", """  float* ring = reinterpret_cast<float*>(sp + S * NQ);
  const long long m0 = (long long)blockIdx.x * KL_PROJ_TILE + threadIdx.x;
  for (int r = 0; r < KL_PROJ_RING - 1; ++r)
    kl_issue_row(ring, values, ld, r, S, m0, M);
""", """  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(sp + S * NQ);
  unsigned char* ring = reinterpret_cast<unsigned char*>(full + KL_PROJ_RING);
  const long long c0 = (long long)blockIdx.x * KL_PROJ_TILE;
  const long long c1 = min(c0 + KL_PROJ_TILE, M);
  const long long m0 = c0 + threadIdx.x;
  if (threadIdx.x == 0) {
    for (int k = 0; k < KL_PROJ_RING; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
                       kl_smem(full + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    for (int r = 0; r < KL_PROJ_RING - 1 && r < S; ++r)
      kl_fetch_row(ring, full, values, ld, r, c0, c1);
  }
"""),
    ("lsh_keys.cu", ISSUE + READ, """    if (s > 0) __syncthreads();   // every thread is done with slot s - 1
    if (threadIdx.x == 0 && s + KL_PROJ_RING - 1 < S)
      kl_fetch_row(ring, full, values, ld, s + KL_PROJ_RING - 1, c0, c1);
    const int k8 = s % KL_PROJ_RING;
    kl_wait_row(full + k8, (s / KL_PROJ_RING) & 1);
    const int a = (int)(((unsigned long long)(values + s * ld + c0) & 15ull) >> 2);
    const float* slot =
        reinterpret_cast<const float*>(ring + k8 * KL_SLOT_BYTES) + a +
        threadIdx.x;
    float x[KL_PROJ_COLS];
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c)
      x[c] = m0 + c * KL_PROJ_THREADS < c1 ? slot[c * KL_PROJ_THREADS] : 0.f;
"""),
    ("lsh_keys.cu", """  if (h < 1 || h > T || smem > KL_SMEM_LIMIT ||
      smem != S * 16 * ((T + 4) / 4) +
                  KL_PROJ_RING * KL_PROJ_TILE * (int)sizeof(float))""",
     """  smem = S * 16 * ((T + 4) / 4) + KL_PROJ_RING * (8 + KL_SLOT_BYTES);
  if (h < 1 || h > T || smem > KL_SMEM_LIMIT)"""),
]
def _span(src: str, start: str, end: str) -> str:
    """The text of csrc/src from start up to end."""
    text = (build.CSRC / src).read_text()
    a = text.index(start)
    return text[a:text.index(end, a)]


PERSISTENT = [
    ("lsh_keys.cu", _span("lsh_keys.cu", "// Start the copy of value row s",
                          "__global__ void kl_quantize_kernel"), """\
// Issue the next step of this block's stream of value rows (row is of tile
// it) for this thread's columns into ring slot issued % KL_PROJ_RING, and
// commit it as one group (empty past the stream's end).
__device__ __forceinline__ void kl_issue_step(
    float* ring, const float* __restrict__ values, long long ld, int S,
    long long M, long long ntiles, long long& it, int& is, long long& issued) {
  if (it < ntiles) {
    const float* row = values + (long long)is * ld;
    float* slot = ring + (int)(issued % KL_PROJ_RING) * KL_PROJ_TILE +
                  threadIdx.x;
    const long long m0 = it * KL_PROJ_TILE + threadIdx.x;
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c) {
      const long long m = m0 + (long long)c * KL_PROJ_THREADS;
      if (m < M) kl_cp_async4(slot + c * KL_PROJ_THREADS, row + m);
    }
    if (++is == S) {
      is = 0;
      it += gridDim.x;
    }
  }
  ++issued;
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

template <int T>
__global__ void __launch_bounds__(KL_PROJ_THREADS) kl_project(
    const float* __restrict__ values, long long ld, int S, long long M,
    const float* __restrict__ planes, const int* __restrict__ sizes, int h,
    int* __restrict__ keys, float* __restrict__ proj,
    unsigned* __restrict__ minmax) {
  constexpr int NP = T + 1, NQ = (NP + 3) / 4;
  extern __shared__ float4 sp[];
  float* ring = reinterpret_cast<float*>(sp + S * NQ);
  const long long ntiles = (M + KL_PROJ_TILE - 1) / KL_PROJ_TILE;
  long long it = blockIdx.x, issued = 0, used = 0;
  int is = 0;
  for (int r = 0; r < KL_PROJ_RING - 1; ++r)
    kl_issue_step(ring, values, ld, S, M, ntiles, it, is, issued);
  float* spf = reinterpret_cast<float*>(sp);
  for (int i = threadIdx.x; i < S * 4 * NQ; i += KL_PROJ_THREADS) {
    const int s = i / (4 * NQ), j = i - s * 4 * NQ;
    spf[i] = j < NP ? planes[s * KL_PLANES + (j < T ? j : KL_H_MAX)] : 0.f;
  }
  __syncthreads();
  unsigned lo = 0xFFFFFFFFu, hi = 0xFFFFFFFFu;   // least word, least ~word
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long m0 = tile * KL_PROJ_TILE + threadIdx.x;
    float acc[KL_PROJ_COLS][NP];
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c)
#pragma unroll
      for (int j = 0; j < NP; ++j) acc[c][j] = 0.f;
    for (int s = 0; s < S; ++s, ++used) {
      kl_issue_step(ring, values, ld, S, M, ntiles, it, is, issued);
      asm volatile("cp.async.wait_group %0;\\n" ::"n"(KL_PROJ_RING - 1)
                   : "memory");
      const float* slot =
          ring + (int)(used % KL_PROJ_RING) * KL_PROJ_TILE + threadIdx.x;
      float x[KL_PROJ_COLS];
#pragma unroll
      for (int c = 0; c < KL_PROJ_COLS; ++c) x[c] = slot[c * KL_PROJ_THREADS];
      const float4* row = sp + s * NQ;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 p4 = row[q];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * q + k < NP) {
#pragma unroll
            for (int c = 0; c < KL_PROJ_COLS; ++c)
              acc[c][4 * q + k] =
                  __fadd_rn(acc[c][4 * q + k], __fmul_rn(p[k], x[c]));
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KL_PROJ_COLS; ++c) {
      const long long m = m0 + (long long)c * KL_PROJ_THREADS;
      if (m >= M) continue;
      int key = 0;
#pragma unroll
      for (int j = 0; j < T; ++j)
        if (j < h && acc[c][j] >= 0.f) key |= 1 << (h - 1 - j);
      const float p = acc[c][T];
      const bool alive = sizes[m] > 0;
      keys[m] = alive ? key : KL_BIG_KEY;
      proj[m] = p;
      if (alive) {
        const unsigned u = kl_ordered(p);
        lo = min(lo, u);
        hi = min(hi, ~u);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
    hi = min(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    if (lo < __ldcg(minmax)) atomicMin(minmax, lo);
    if (hi < __ldcg(minmax + 1)) atomicMin(minmax + 1, hi);
  }
}

"""),
    ("lsh_keys.cu", """  kl_project<T><<<kl_blocks(M, KL_PROJ_TILE), KL_PROJ_THREADS, smem, st>>>(""",
     """  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kl_project<T>, KL_PROJ_THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long most = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  const long long tiles = kl_blocks(M, KL_PROJ_TILE);
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  kl_project<T><<<grid, KL_PROJ_THREADS, smem, st>>>("""),
]

VARIANTS = {
    "committed": [],
    "constant": [
        ("lsh_keys.cu", "#define KL_SMEM_LIMIT 232448",
         "#define KL_SMEM_LIMIT 232448\n__constant__ float kl_planes_c[16384];"),
        ("lsh_keys.cu", """      const float4 p4 = row[q];
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};""", """      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p[k] = kl_planes_c[s * KL_PLANES +
                           (4 * q + k < T ? 4 * q + k : KL_H_MAX)];"""),
        ("lsh_keys.cu", """  if (err != cudaSuccess) return (int)err;
#define KL_PROJECT_CASE""", """  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(kl_planes_c, planes,
                                  (size_t)S * KL_PLANES * sizeof(float), 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
#define KL_PROJECT_CASE"""),
    ],
    "fma": FMA,
    "no-float": [("lsh_keys.cu", """    const float4* row = sp + s * NQ;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {""", """    acc[0][0] = __fadd_rn(acc[0][0], x[0] + x[1] + x[2] + x[3]);
    const float4* row = sp + s * NQ;
#pragma unroll
    for (int q = 0; q < 0; ++q) {""")],
    "no-memory": NO_MEMORY,
    "fma-no-memory": FMA + NO_MEMORY,
    "unroll2": [("lsh_keys.cu", LOOP, "#pragma unroll 2\n" + LOOP)],
    "bulk": BULK,
    "persistent": PERSISTENT,
    "write-back": [
        ("finalize.cu", """__global__ void kl_fin_roots(long long cap0, const int* __restrict__ link,""",
         """__global__ void kl_fin_roots(long long cap0, int* __restrict__ link,"""),
        ("finalize.cu", """  int x = (int)r;
  int p = link[x];
  for (long long step = 0; (p & ~KL_FIN_FLAG) != x && step < cap0; ++step) {
    x = p & ~KL_FIN_FLAG;
    p = link[x];
  }""", """  int x = (int)r, hop = -1;
  int p = link[x];
  for (long long step = 0; (p & ~KL_FIN_FLAG) != x && step < cap0; ++step) {
    x = p & ~KL_FIN_FLAG;
    if (hop < 0) hop = x;
    p = link[x];
  }
  if (x != (int)r) {
    link[r] = x;
    if (hop != x) link[hop] = x;
  }"""),
        ("finalize.cu", "      cap0, (const int*)link, (int*)key);",
         "      cap0, (int*)link, (int*)key);"),
    ],
}
# lsh_keys not bit-exact by design
INEXACT = ("fma", "no-float", "no-memory", "fma-no-memory")

VALUES_PLAIN = [
    ("chain_collapse.cu",
     "kl_cp_async16_pol(d, scr + (long long)from * W + 4 * q, stream)",
     "kl_cp_async16(d, scr + (long long)from * W + 4 * q)"),
    ("chain_collapse.cu",
     "if (u < nk) kl_st_pol(o + (long long)u * M, x[u], stream);",
     "if (u < nk) o[(long long)u * M] = x[u];"),
]
PARENT_PLAIN = [
    ("chain_collapse.cu",
     "kl_st_pol(parent + ((long long)slot - pbase), hslot, keep);",
     "parent[(long long)slot - pbase] = hslot;"),
]
INTS_PLAIN = [
    ("chain_collapse.cu",
     "    src[r] = in ? (own ? __ldcs(order + p) : order[p]) : -1;\n"
     "    ckey[r - 1] = in ? (own ? __ldcs(skey + p) : skey[p]) : KL_BIG_KEY;",
     "    src[r] = in ? order[p] : -1;\n"
     "    ckey[r - 1] = in ? skey[p] : KL_BIG_KEY;"),
    ("chain_collapse.cu",
     "    __stcs(out_size + p, last ? Wc : (alive ? 0 : sz));\n"
     "    if (out_mi)\n      __stcs(out_mi + p, (alive && !last) ? hslot\n"
     "                                        : (smi ? smi[__ldcs(order + p)]"
     " : -1));",
     "    out_size[p] = last ? Wc : (alive ? 0 : sz);\n"
     "    if (out_mi) out_mi[p] = (alive && !last) ? hslot : "
     "(smi ? smi[order[p]] : -1);"),
    ("chain_collapse.cu", "__stcs(out_slot + p, hslot);", "out_slot[p] = hslot;"),
    ("chain_collapse.cu", "__stcs(out_slot + p, slot);", "out_slot[p] = slot;"),
]
FOLD_VARIANTS = {
    "committed": [],
    "no-hints": VALUES_PLAIN + PARENT_PLAIN + INTS_PLAIN,
    "no-int-streams": INTS_PLAIN,
    "parent-last": VALUES_PLAIN + INTS_PLAIN,
    "values-first": PARENT_PLAIN + INTS_PLAIN,
}


SUMS = """  float xs = 0.0f, ys = 0.0f;
  for (int j = 0; j < n1; ++j) xs = __fadd_rn(xs, v[j]);
  for (int j = 0; j < n2; ++j) ys = __fadd_rn(ys, v[n1 + j]);
  const float xm = __fdiv_rn(xs, (float)n1);
  const float ym = __fdiv_rn(ys, (float)n2);
  float ssx = 0.0f, ssy = 0.0f;
  for (int j = 0; j < n1; ++j) {
    const float e = __fsub_rn(v[j], xm);
    ssx = __fadd_rn(ssx, __fmul_rn(e, e));
  }
  for (int j = 0; j < n2; ++j) {
    const float e = __fsub_rn(v[n1 + j], ym);
    ssy = __fadd_rn(ssy, __fmul_rn(e, e));
  }
"""
PARENT_WRS_VARIANTS = {
    "parent": [],
    "parent-no-fraction": [
        ("ttest.cu", "for (int it = 1; it < kMaxIter; ++it) {",
         "for (int it = 1; it < 1; ++it) {")],
    "parent-no-loads": [
        ("ttest.cu", "const float* v = values + row * ld;",
         "const unsigned hv = (unsigned)row * 2654435761u;\n"
         "#define KL_V(j) __uint_as_float(\\\n"
         "    0x40800000u | ((hv ^ ((unsigned)(j) * 2246822519u)) >> 11))"),
        ("ttest.cu", "v[n1 + j]", "KL_V(n1 + j)"),
        ("ttest.cu", "v[j]", "KL_V(j)")],
    "parent-one-pass": [("ttest.cu", SUMS, """\
  float xs = 0.0f, ys = 0.0f, qx = 0.0f, qy = 0.0f;
  for (int j = 0; j < n1; ++j) {
    const float w = v[j];
    xs = __fadd_rn(xs, w);
    qx = __fadd_rn(qx, __fmul_rn(w, w));
  }
  for (int j = 0; j < n2; ++j) {
    const float w = v[n1 + j];
    ys = __fadd_rn(ys, w);
    qy = __fadd_rn(qy, __fmul_rn(w, w));
  }
  const float xm = __fdiv_rn(xs, (float)n1);
  const float ym = __fdiv_rn(ys, (float)n2);
  const float ssx = fmaxf(__fsub_rn(qx, __fmul_rn(xs, xm)), 0.0f);
  const float ssy = fmaxf(__fsub_rn(qy, __fmul_rn(ys, ym)), 0.0f);
""")],
}
# the parent's entry point: no launch plan
PARENT_WRS_SIGNATURE = (build._P, build._L, build._L, build._I, build._I,
                        build._P, build._F, build._F, build._I, build._P,
                        build._P, build._P, build._P)
PN_OF_ROW = """\
__device__ float kl_partial_numerator(int it, float a, float b, float x) {
  const int mi = (it - 1) / 2;
  const float m = (float)mi;
  const float a2m = __fadd_rn(a, __fmul_rn(2.0f, m));
  if ((it & 1) == 0) {
    if (mi == 0)
      return __fdiv_rn(__fmul_rn(-__fadd_rn(a, b), x), __fadd_rn(a, 1.0f));
    const float num = __fmul_rn(
        __fmul_rn(-__fadd_rn(a, m), __fadd_rn(__fadd_rn(a, b), m)), x);
    return __fdiv_rn(num, __fmul_rn(a2m, __fadd_rn(a2m, 1.0f)));
  }
  const float num = __fmul_rn(__fmul_rn(m, __fsub_rn(b, m)), x);
  return __fdiv_rn(num, __fmul_rn(__fsub_rn(a2m, 1.0f), a2m));
}

__global__ void"""
WRS_VARIANTS: dict[str, list] = {
    "committed": [],
    # each step's partial numerator from (aa, bb, it) as the parent did
    "no-table": [
        ("ttest.cu", "__global__ void", PN_OF_ROW),
        ("ttest.cu", """      const float2 cd = steps[it];
      const float pn = __fdiv_rn(__fmul_rn(cd.x, xx), cd.y);""",
         """      const int pair = rapid ? 0 : 1;
      const float pn = kl_partial_numerator(it, k.aa[pair], k.bb[pair], xx);""")],
    # the lgamma terms of each row's pair in its tail, as the parent did
    "lgamma-a-row": [
        ("ttest.cu", "  const float l1x = log1pf(-xx);",
         "  const float lbsa = __fsub_rn(lgammaf(bb), lgammaf(__fadd_rn(aa, "
         "bb)));\n  const float lbeta = __fadd_rn(lgammaf(aa), lbsa);\n"
         "  const float l1x = log1pf(-xx);"),
        ("ttest.cu", "k.lbeta_small_a[pair]))", "lbsa))"),
        ("ttest.cu", "k.lbeta[pair])),", "lbeta)),")],
    # 4-byte copies where 16-byte ones would do
    "copy-4": [("ttest.cu", "  auto issue = [&](long long row0, int j) {",
                "  vec = 4;\n  auto issue = [&](long long row0, int j) {")],
    # no step after the first tabulated one (not the plain version's tails)
    "no-fraction": [("ttest.cu",
                     "if (!(fabsf(__fsub_rn(delta, 1.0f)) >= kSmall)) break;",
                     "break;")],
    # a warp's first tile staged, no copy after it (other rows' values)
    "no-copies": [("ttest.cu",
                   "const bool more = i + 1 < tiles && next < N;",
                   "const bool more = false;")],
    # the rows left in their order: one bucket
    "no-sort": [("ttest.cu",
                 "rank[off] = key << 16 | atomicAdd(bucket + key, 1);",
                 "rank[off] = atomicAdd(bucket, 1);")],
    # at most 40 registers a thread: 12 blocks a SM
    "bounds-12": [("ttest.cu", "__launch_bounds__(32 * kWarps)",
                   "__launch_bounds__(32 * kWarps, 12)")],
    # every division and square root the approximate one (not the plain
    # version's rounding: what the IEEE sequences cost)
    "fast-div": [("ttest.cu", "__fdiv_rn(", "__fdividef("),
                 ("ttest.cu", "__fsqrt_rn(", "sqrtf(")],
    # the tail's logarithms and exponential left out
    "no-logs": [("ttest.cu", """  const float l1x = log1pf(-xx);
  const float factor =
      aa < kVerySmall""", """  const float l1x = -xx;
  const float factor = 1.0f;
  if (false) (void)(
      aa < kVerySmall"""),
                ("ttest.cu", """                      aa);
  float r = __fmul_rn(h, factor);""", """                      aa));
  float r = __fmul_rn(h, factor);""")],
    # group B's columns summed after group A's, not in turns with them
    "groups-in-order": [("ttest.cu", "    if (qb < qb_end) {",
                         "    if (qa >= qa_end && qb < qb_end) {")],
}
# the blocks a SM holds of the library's kl_wrs_kernel (a tool's entry
# point appended to every variant)
OCCUPANCY = """
KL_EXPORT int kl_wrs_occupancy(int threads, int smem) {
  int n = 0;
  cudaFuncSetAttribute(kl_wrs_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kl_wrs_kernel, threads,
                                                smem);
  return n;
}
"""


def build_variants(variants: dict = VARIANTS) -> dict[str, ctypes.CDLL]:
    """One library per variant; the sources no variant changes compile
    once."""
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    shutil.copy(build.CSRC / "common.cuh", WORK)
    base = {p.name: p.read_text() for p in build.CSRC.glob("*.cu")}
    nvcc = build._nvcc()
    jobs, objs = [], {}
    for name, subs in variants.items():
        texts = {}
        for src, old, new in subs:
            text = texts.get(src, base[src])
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {src}")
            texts[src] = text.replace(old, new)
        objs[name] = []
        for src, text in base.items():
            tag = name if src in texts else "committed"
            obj = WORK / f"{tag}_{src}.o"
            objs[name].append(str(obj))
            if tag == name:
                path = WORK / f"{tag}_{src}"
                path.write_text(texts.get(src, text))
                jobs.append((name, subprocess.Popen(
                    [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(obj),
                     str(path)], stderr=subprocess.PIPE, text=True)))
    failed = set()
    for name, job in jobs:
        _, err = job.communicate()
        if job.returncode:
            if name == "committed":
                raise RuntimeError(f"nvcc failed:\n{err[-4000:]}")
            cs.log(f"variant {name} left out: nvcc failed:\n{err[-2000:]}")
            failed.add(name)
    libs = {}
    for name in variants:
        if name in failed:
            continue
        lib = WORK / f"lib_{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        *objs[name]], check=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in build.SIGNATURES.items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def inputs(M: int, lib: ctypes.CDLL):
    S, dev = cs.S, cs.DEV
    build._lib = lib
    counts = torch.from_numpy(cs.make_counts(M, seed=1)).to(dev)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / M).float())
    h = engine._active_h_of(int((sz > 0).sum()))
    keys_in = (vt.clone(), sz.clone(), rng.draw_hyperplanes(0, 0, S).to(dev),
               h)
    sl = torch.arange(M, dtype=torch.int32, device=dev)
    parent = sl.clone()
    for it in range(6):
        vt, sz, sl = engine._one_iteration(
            vt, sz, sl, parent, rng.draw_hyperplanes(0, it, S).to(dev),
            0.95 - 0.01 * it, engine._active_h_of(int((sz > 0).sum())))[:3]
    vt, sz, sl = engine.compact_sort(vt, sz, sl)
    na = int((sz > 0).sum())
    return keys_in, (vt[:, :na].contiguous(), sz[:na], sl[:na], parent)


def timed(fn, args, want) -> str:
    got = fn(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    return f"{cs.cuda_ms(lambda: fn(*args)):.4f} ms (exact: {same})"


def fold_inputs(M: int):
    """Phase 3's state of the first iteration at M x 20 with its order and
    sorted keys, its slots offset to rank 1's, the parent shard, the base
    and h."""
    S, dev = cs.S, cs.DEV
    counts = torch.from_numpy(cs.make_counts(M, seed=1)).to(dev)
    cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
    vt, sz = kernels.abundance_transform(counts, (cov / M).float())
    del counts
    h = engine._active_h_of(int((sz > 0).sum()))
    key, _ = kernels.lsh_keys(vt, sz, rng.draw_hyperplanes(0, 0, S).to(dev), h)
    skey, order = (kernels.sort_keys(key, 31) if hasattr(kernels, "sort_keys")
                   else torch.sort(key, stable=True))   # a parent tree's
    sl = torch.arange(M, M + M, dtype=torch.int32, device=dev)
    parent = torch.arange(M, M + M, dtype=torch.int32, device=dev)
    return (vt, sz, sl, order, skey), parent, M, h


def main_fold() -> None:
    libs = build_variants(FOLD_VARIANTS)
    for M in (cs.SMALL, cs.OOC_BATCH, cs.FULL):
        build._lib = libs["committed"]
        state, parent0, base, h = fold_inputs(M)
        want_p = parent0.clone()
        vt, sz, sl, order, skey = state
        want = kernels.chain_collapse_plain(
            *kernels.permute_state_plain(vt, sz, sl, order), skey, 0.95, h,
            None, want_p, base)
        for rnd in range(2):
            for name, lib in libs.items():
                build._lib = lib
                par = parent0.clone()
                got = kernels.chain_collapse(*state, 0.95, h, None, par, base)
                same = all(torch.equal(a, b) for a, b in
                           zip((*got[1:], par), (*want[1:], want_p)))
                fold = cs.cuda_ms(lambda: kernels.chain_collapse(
                    *state, 0.95, h, None, par, base))
                bare = cs.cuda_ms(lambda: kernels.chain_collapse(
                    *state, 0.95, h))
                cs.log(f"variant {name} at {M}, round {rnd}: chain_collapse "
                       f"with the fold at base {base} {fold:.4f} ms, without "
                       f"{bare:.4f} ms (exact: {same})")
        del state, parent0, want, want_p
    build._lib = None


def build_wrs(csrc, variants: dict, tag: str) -> dict[str, ctypes.CDLL]:
    """One library a variant of csrc/ttest.cu, built alone; a variant whose
    text the source does not hold, or that does not compile, is left
    out."""
    base = (csrc / "ttest.cu").read_text()
    work = WORK / tag
    work.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "common.cuh", work)
    jobs = {}
    for name, subs in variants.items():
        text = base
        for _, old, new in subs:
            if old not in text:
                cs.log(f"variant {name} left out: {old[:60]!r} not in "
                       f"{csrc / 'ttest.cu'}")
                break
            text = text.replace(old, new)
        else:
            src = work / f"{name}.cu"
            src.write_text(text + OCCUPANCY)
            jobs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                 str(work / f"lib_{name}.so"), str(src)],
                stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, job in jobs.items():
        _, err = job.communicate()
        if job.returncode:
            cs.log(f"variant {name} left out: nvcc failed:\n{err[-2000:]}")
        else:
            libs[name] = ctypes.CDLL(str(work / f"lib_{name}.so"))
    return libs


def parent_wrs(lib: ctypes.CDLL):
    """wrs_verdicts through the parent's entry point in lib."""
    fn = lib.kl_wrs_verdicts
    fn.argtypes, fn.restype = PARENT_WRS_SIGNATURE, ctypes.c_int

    def call(v, sz, n1, n2, pval, size_thresh):
        N = v.shape[0]
        verdict = torch.empty(N, dtype=torch.int8, device=v.device)
        left = torch.empty(N, dtype=torch.float32, device=v.device)
        right = torch.empty(N, dtype=torch.float32, device=v.device)
        err = fn(v.data_ptr(), v.stride(0), N, n1, n2, sz.data_ptr(),
                 1.0 / n1 + 1.0 / n2, pval, size_thresh, verdict.data_ptr(),
                 left.data_ptr(), right.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kl_wrs_verdicts: CUDA error {err}")
        return verdict, left, right

    return call


def committed_wrs(lib: ctypes.CDLL, tiles: int | None = None):
    """kernels.wrs_verdicts on the library lib (with tiles, on plans of that
    many tiles a warp)."""
    fn = lib.kl_wrs_verdicts
    fn.argtypes = build.SIGNATURES["kl_wrs_verdicts"]
    fn.restype = ctypes.c_int
    plan_of = kernels.wrs_plan

    def one(N, *args):
        plan = plan_of(N, *args)
        if tiles:
            plan["smem"] += 15 * 32 * kernels.WRS_WARPS * (tiles
                                                            - plan["tiles"])
            plan["tiles"], plan["tile_rows"] = tiles, 32 * kernels.WRS_WARPS * tiles
            plan["blocks"] = -(-N // plan["tile_rows"])
        return plan

    def call(*args):
        build._lib = lib
        kernels.wrs_plan = one
        try:
            return kernels.wrs_verdicts(*args)
        finally:
            kernels.wrs_plan = plan_of

    return call


def main_wrs(parent: str | None) -> None:
    from pathlib import Path

    from kmerlsh_tpu_torch import testdata

    libs = build_wrs(build.CSRC, WRS_VARIANTS, "wrs")
    calls = {name: committed_wrs(lib) for name, lib in libs.items()}
    if "committed" in libs:
        for t in (1, 2):
            calls[f"committed, {t} tiles a warp"] = committed_wrs(
                libs["committed"], tiles=t)
    if parent:
        csrc = Path(parent).resolve() / "kmerlsh_tpu_torch" / "csrc"
        calls.update({name: parent_wrs(lib) for name, lib in build_wrs(
            csrc, PARENT_WRS_VARIANTS, "wrs_parent").items()})
    for n in (cs.S // 2, 50):
        if hasattr(kernels, "wrs_plan"):
            plan = kernels.wrs_plan(cs.SMALL, 2 * n, 2 * n, 0)
            cs.log(f"at {cs.SMALL} x ({n} + {n}): plan {plan}; blocks a SM "
                   + ", ".join(
                       f"{name} {lib.kl_wrs_occupancy(plan['threads'], plan['smem'])}"
                       for name, lib in libs.items()))
        values, sizes = testdata.wrs_rows(cs.SMALL, n, n, seed=3)
        args = (torch.from_numpy(values).to(cs.DEV),
                torch.from_numpy(sizes).to(cs.DEV), n, n, 0.01, 5)
        want = kernels.wrs_verdicts_plain(*args)
        for rnd in range(2):
            for name, fn in calls.items():
                got = fn(*args)
                exact = torch.equal(got[0], want[0]) and all(
                    torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                    for a, b in zip(got[1:], want[1:]))
                cs.log(f"variant {name} at {cs.SMALL} x ({n} + {n}), round "
                       f"{rnd}: wrs_verdicts {cs.cuda_ms(lambda: fn(*args)):.4f}"
                       f" ms (equal to the plain version: {exact})")
    build._lib = None


def _sort_define(name: str, value) -> tuple:
    """A substitution of sort_keys.cu's #define name (its committed text
    found in the source)."""
    import re

    text = (build.CSRC / "sort_keys.cu").read_text()
    line = re.search(rf"^#define {name} .*$", text, re.M).group(0)
    return ("sort_keys.cu", line, f"#define {name} {value}")


SWEEP_BOUNDS = "__launch_bounds__(KL_SORT_THREADS) kl_sort_onesweep"
# overlap: the look-back passes on persistent blocks (as many as the card
# holds at once), each taking its next tile's ticket and copying that
# tile's keys and payloads into shared memory (cp.async) while it ranks,
# looks back and writes out this one
OVERLAP_KERNEL = """// Start the copies of tile `tile` of kin (and vin) into in_k (in_v).
__device__ __forceinline__ void kl_tile_fetch(const unsigned* kin,
                                              const int* vin, int M, int tile,
                                              bool wide, unsigned* in_k,
                                              int* in_v) {
  const int base = tile * KL_SORT_TILE, n = min(KL_SORT_TILE, M - base);
  for (int i = 4 * threadIdx.x; i < n; i += 4 * KL_SORT_THREADS) {
    if (wide && i + 4 <= n) {
      kl_cp_async16(in_k + i, kin + base + i);
      if (vin) kl_cp_async16(in_v + i, vin + base + i);
    } else {
      for (int u = i; u < i + 4 && u < n; ++u) {
        kl_cp_async4(in_k + u, kin + base + u);
        if (vin) kl_cp_async4(in_v + u, vin + base + u);
      }
    }
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

__global__ void __launch_bounds__(KL_SORT_THREADS) kl_sort_overlap(
    const unsigned* __restrict__ kin, const int* __restrict__ vin, int M,
    int tiles, int shift, int digit, int pass, const int* __restrict__ start,
    unsigned long long* status, int* ticket, unsigned* __restrict__ kout,
    int* __restrict__ vout) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_next;
  const int R = 1 << digit, t = threadIdx.x, lane = t & 31, w = t >> 5;
  unsigned* in_k = (unsigned*)smem;
  int* in_v = (int*)(in_k + KL_SORT_TILE);
  unsigned* sk = (unsigned*)(in_v + KL_SORT_TILE);
  int* sv = (int*)(sk + KL_SORT_TILE);
  int* loc = sv + KL_SORT_TILE;
  int* gml = loc + R;
  unsigned short* cnt = (unsigned short*)(gml + R);
  const bool wide =
      (((unsigned long long)kin | (unsigned long long)vin) & 15) == 0;
  const unsigned own = 2 * pass + 2;
  if (t == 0) s_next = atomicAdd(ticket, 1);
  __syncthreads();
  int tile = s_next;
  if (tile >= tiles) return;
  kl_tile_fetch(kin, vin, M, tile, wide, in_k, in_v);
  for (;;) {
    __syncthreads();
    if (t == 0) s_next = atomicAdd(ticket, 1);
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
    __syncthreads();
    const int base = tile * KL_SORT_TILE, n = min(KL_SORT_TILE, M - base);
    const int next = s_next;
    unsigned k[KL_SORT_KPT];
    int v[KL_SORT_KPT], rk[KL_SORT_KPT];
    const int wl = w * 32 * KL_SORT_KPT + lane;
#pragma unroll
    for (int r = 0; r < KL_SORT_KPT; ++r) {
      const int i = wl + 32 * r;
      k[r] = i < n ? in_k[i] : 0u;
      v[r] = i >= n ? 0 : vin ? in_v[i] : base + i;
    }
    __syncthreads();
    if (next < tiles) kl_tile_fetch(kin, vin, M, next, wide, in_k, in_v);
    const int c = kl_tile_rank<KL_SORT_THREADS, KL_SORT_KPT>(k, n, shift,
                                                             digit, cnt, rk);
    volatile unsigned long long* mine =
        status + (long long)tile * R + (t < R ? t : 0);
    if (t < R)
      *mine = ((unsigned long long)(tile ? own : own + 1) << 32) |
              (unsigned)c;
    int total;
    const int l = kl_block_scan(c, &total);
    if (t < R) loc[t] = l;
    __syncthreads();
    kl_tile_stage<KL_SORT_KPT>(k, v, rk, n, shift, digit, loc, cnt, sk, sv);
    if (t < R) {
      unsigned before = 0;
      if (tile) {
        before = kl_look_back(status, tile, R, t, own);
        *mine = ((unsigned long long)(own + 1) << 32) | (before + c);
      }
      gml[t] = start[t] + (int)before - l;
    }
    __syncthreads();
    kl_tile_write<KL_SORT_THREADS>(sk, sv, n, shift, R - 1, gml, kout, vout);
    if (next >= tiles) break;
    tile = next;
  }
}

// The blocks of kl_sort_overlap the card holds at once, at most `tiles`
// (its shared memory allowed once).
static int kl_sort_resident(int tiles) {
  static int blocks = [] {
    const int most = 16 * KL_SORT_TILE + KL_SORT_SMEM(0, KL_SORT_THREADS / 32,
                                                      KL_SORT_MAX_DIGIT);
    cudaFuncSetAttribute(kl_sort_overlap,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kl_sort_overlap,
                                                  KL_SORT_THREADS, most);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks < tiles ? blocks : tiles;
}

// --- route 0: one cooperative launch"""
OVERLAP = [
    ("sort_keys.cu", "// --- route 0: one cooperative launch", OVERLAP_KERNEL),
    ("sort_keys.cu", """      kl_sort_onesweep<true><<<blocks, KL_SORT_THREADS, smem, st>>>(
          kin, vin, m, blocks, p * digit, digit, p, start + p * R, heads,
          words, ticket + p, kout, vout);""", """      kl_sort_overlap<<<kl_sort_resident(blocks), KL_SORT_THREADS,
                        smem + 8 * KL_SORT_TILE, st>>>(
          kin, vin, m, blocks, p * digit, digit, p, start + p * R, words,
          ticket + p, kout, vout);"""),
]
# variant → (its substitutions of sort_keys.cu, the kernels attributes its
# plan needs)
SORT_VARIANTS = {
    "committed": ([], {}),
    **{f"window-{w}": ([_sort_define("KL_SORT_WINDOW", w)], {})
       for w in (1, 8, 16)},
    **{f"keys-{n}": ([_sort_define("KL_SORT_KPT", n)],
                     {"SORT_KEYS_A_THREAD": n}) for n in (8, 12, 24)},
    "digit-9": ([_sort_define("KL_SORT_THREADS", 512),
                 _sort_define("KL_SORT_KPT", 8),
                 _sort_define("KL_SORT_MAX_DIGIT", 9)],
                {"SORT_THREADS": 512, "SORT_KEYS_A_THREAD": 8,
                 "SORT_DIGIT_BITS": 9}),
    "hist-2^18": ([_sort_define("KL_SORT_HIST_INTS", 1 << 18)],
                  {"SORT_HIST_INTS": 1 << 18}),
    "overlap": (OVERLAP, {}),
    **{f"bounds-{n}": ([("sort_keys.cu", SWEEP_BOUNDS,
                         SWEEP_BOUNDS.replace("THREADS)", f"THREADS, {n})"))],
                       {}) for n in (3, 4)},
    "launch-2^20": ([_sort_define("KL_SORT_ONE_MAX", 1 << 20)],
                    {"SORT_ONE_MAX": 1 << 20}),
}
# variants also timed on each route their plan allows
SORT_ROUTED = ("committed",)
# the parent's entry point (the earlier design: three launches a pass)
PARENT_SORT_SIGNATURE = (build._P, build._L, build._I, build._I, build._I,
                         build._I, build._I, build._I, build._P, build._P,
                         build._P, build._P, build._P, build._P)


def build_alone(csrc, source: str, subs: dict, tag: str) -> dict:
    """One library a variant of csrc/source, built alone; a variant whose
    text the source does not hold, or that does not compile, is left
    out."""
    base = (csrc / source).read_text()
    work = WORK / tag
    work.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "common.cuh", work)
    jobs = {}
    for name, pairs in subs.items():
        text = base
        for _, old, new in pairs:
            if old not in text:
                cs.log(f"variant {name} left out: {old[:60]!r} not in "
                       f"{csrc / source}")
                break
            text = text.replace(old, new)
        else:
            path = work / f"{name}.cu"
            path.write_text(text)
            jobs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                 str(work / f"lib_{name}.so"), str(path)],
                stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, job in jobs.items():
        _, err = job.communicate()
        if job.returncode:
            cs.log(f"variant {name} left out: nvcc failed:\n{err[-2000:]}")
        else:
            libs[name] = ctypes.CDLL(str(work / f"lib_{name}.so"))
    return libs


def committed_sort(lib: ctypes.CDLL, attrs: dict, route: str | None = None):
    """kernels.sort_keys on library lib, with the kernels attributes attrs
    set for the call (and the plan's route forced to route)."""
    fn = lib.kl_sort_keys
    fn.argtypes, fn.restype = build.SIGNATURES["kl_sort_keys"], ctypes.c_int
    plan_of = kernels.sort_plan

    def call(key, bits):
        saved = {a: getattr(kernels, a) for a in attrs}
        build._lib = lib
        for a, value in attrs.items():
            setattr(kernels, a, value)
        if route:
            kernels.sort_plan = lambda M, b, r=None: plan_of(M, b, route)
        try:
            return kernels.sort_keys(key, bits)
        finally:
            kernels.sort_plan = plan_of
            for a, value in saved.items():
                setattr(kernels, a, value)

    return call


def parent_sort(lib: ctypes.CDLL):
    """The parent's K9 (the earlier design: a histogram, a row scan and a
    scatter a pass over tiles of 4096 keys, at most 8-bit digits) through
    its entry point in lib, with its plan."""
    fn = lib.kl_sort_keys
    fn.argtypes, fn.restype = PARENT_SORT_SIGNATURE, ctypes.c_int

    def call(key, bits):
        M = key.numel()
        passes = -(-bits // 8)
        digit = -(-bits // passes)
        tile, R = 4096, 1 << digit
        blocks = -(-M // tile)
        skey, order = torch.empty_like(key), torch.empty_like(key)
        counts = torch.empty((blocks + 1) * R, dtype=torch.int32,
                             device=key.device)
        alt = torch.empty((2, M), dtype=torch.int32, device=key.device)
        err = fn(key.data_ptr(), M, bits, digit, passes, tile, blocks,
                 8 * tile + 24 * R, counts.data_ptr(), skey.data_ptr(),
                 order.data_ptr(), alt[0].data_ptr(), alt[1].data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kl_sort_keys: CUDA error {err}")
        return skey, order

    return call


def sort_inputs() -> list:
    """(what, keys, bits) at each size chip_smoke.py phase 3 sorts: the
    lsh_keys output at 2^14, 2^16, 2^20, 2^21, 2^22 and 2^24 x 20 (31
    bits), and at 2^17 and 2^18 (where the routes meet); at 2^24 after six iterations finalize's row keys (25 bits), the
    dead flags (1 bit) and finalize's cluster keys (25 bits)."""
    cases = []
    for M in (*cs.SORT_SMALL, 1 << 17, 1 << 18, cs.SMALL, cs.LATE,
              cs.OOC_BATCH, cs.FULL):
        counts = torch.from_numpy(cs.make_counts(M, seed=1)).to(cs.DEV)
        cov = torch.log(counts.to(torch.int32).clamp(min=1).double()).sum(1)
        vt, sz = kernels.abundance_transform(counts, (cov / M).float())
        del counts
        key, _ = kernels.lsh_keys(vt, sz, rng.draw_hyperplanes(0, 0, cs.S).to(
            cs.DEV), engine._active_h_of(int((sz > 0).sum())))
        cases.append((f"lsh_keys at {M}", key, 31))
        if M == cs.FULL:
            sl = torch.arange(M, dtype=torch.int32, device=cs.DEV)
            parent = sl.clone()
            for it in range(6):
                vt, sz, sl = engine._one_iteration(
                    vt, sz, sl, parent, rng.draw_hyperplanes(0, it, cs.S)
                    .to(cs.DEV), 0.95 - 0.01 * it,
                    engine._active_h_of(int((sz > 0).sum())))[:3]
            bits = M.bit_length()
            cases.append((f"finalize's row keys at {M}",
                          cs.root_keys(sz, sl, parent), bits))
            cases.append((f"dead flags at {M}", (sz == 0).to(torch.int32), 1))
            _, szc, slc = engine.compact_sort(vt, sz, sl)
            cases.append((f"finalize's cluster keys at {M}",
                          cs.cluster_keys(szc, slc, parent), bits))
        del vt, sz
    return cases


def log_split(what: str, fn, key, bits) -> None:
    """The card time of ten sorts by kernel (torch.profiler)."""
    from torch.autograd import DeviceType

    fn(key, bits)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as trace:
        for _ in range(10):
            fn(key, bits)
        torch.cuda.synchronize()
    by = {}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").split("(")[0]
            ms, n = by.get(name, (0.0, 0))
            by[name] = (ms + (e.time_range.end - e.time_range.start) * 1e-3,
                        n + 1)
    for name, (ms, n) in sorted(by.items()):
        cs.log(f"sort {what}, card time by kernel: {name}: {ms / 10:.4f} ms "
               f"a sort in {n / 10:g} launches")
    cs.log(f"sort {what}, card time: "
           f"{sum(ms for ms, _ in by.values()) / 10:.4f} ms a sort")


def main_sort(parent: str | None) -> None:
    from pathlib import Path

    libs = build_alone(build.CSRC, "sort_keys.cu",
                       {n: v[0] for n, v in SORT_VARIANTS.items()}, "sort")
    calls, limit = {}, {}
    for name, lib in libs.items():
        attrs = SORT_VARIANTS[name][1]
        calls[name] = committed_sort(lib, attrs)
        limit[name] = 2**31
        if name in SORT_ROUTED:
            for route in kernels.SORT_ROUTES:
                calls[f"{name}, {route}"] = committed_sort(lib, attrs, route)
                limit[f"{name}, {route}"] = (
                    attrs.get("SORT_ONE_MAX", kernels.SORT_ONE_MAX)
                    if route == kernels.SORT_ROUTES[0] else 2**31)
    if parent:
        csrc = Path(parent).resolve() / "kmerlsh_tpu_torch" / "csrc"
        for name, lib in build_alone(csrc, "sort_keys.cu", {"parent": []},
                                     "sort_parent").items():
            calls[name] = parent_sort(lib)
            limit[name] = 2**31
    build._lib = None   # the inputs on the kernels as committed
    cases = sort_inputs()
    names = list(calls)
    for what, key, bits in cases:
        want = kernels.sort_keys_plain(key, bits)
        for rnd in range(2):
            cs.log(f"sort {what}, round {rnd}: torch.sort "
                   f"{cs.cuda_ms(lambda: torch.sort(key, stable=True)):.4f}"
                   f" ms")
            for name in (names if rnd == 0 else names[::-1]):
                if key.numel() > limit[name]:
                    continue
                try:
                    cs.log(f"sort {what}, variant {name}, round {rnd}: "
                           + timed(calls[name], (key, bits), want))
                except (RuntimeError, ValueError) as e:
                    cs.log(f"sort {what}, variant {name}: {e}")
    for what, key, bits in cases:
        if key.numel() == cs.FULL:
            for name in ("committed", "parent"):
                if name in calls:
                    log_split(f"{what} ({bits} bits), {name}", calls[name],
                              key, bits)
    build._lib = None


PAIR_MEAN = """      for (int s = 0; s < S; ++s) {
        float* vq = sv + s * W + q;
        *vq = __fdiv_rn(__fadd_rn(__fmul_rn(*vq, fl),
                                  __fmul_rn(sv[s * W + p], fr)),
                        ft);
      }"""
QUIET = "quiet = __syncthreads_or(merged) ? 0 : quiet + 1;"
# "clocks": thread 0 of each short-segment block adds the cycles of each
# phase (clock64) into kl_pair_clk: keys and starts, staging, then each
# round's first scan, its list of pairs, its cosines and merges, and the
# write-back; [7] counts the blocks that wrote back
PAIR_CLK = """#define KL_CLK(k)                                                    \\
  if (t == 0) {                                                      \\
    const long long c = clock64();                                   \\
    atomicAdd(kl_pair_clk + (k), (unsigned long long)(c - kc));      \\
    kc = c;                                                          \\
  }
__device__ unsigned long long kl_pair_clk[8];
"""
PAIR_CLOCKS = [
    ("", "namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + PAIR_CLK),
    ("", "  const int nW = gridDim.x, t = threadIdx.x, T = blockDim.x;\n",
     "  const int nW = gridDim.x, t = threadIdx.x, T = blockDim.x;\n"
     "  long long kc = clock64();\n"),
    ("", "atomicMin(&s_end, e);\n  __syncthreads();\n",
     "atomicMin(&s_end, e);\n  __syncthreads();\n  KL_CLK(0)\n"),
    ("", "  kl_cp_async_wait_all();\n  __syncthreads();\n  // flags",
     "  kl_cp_async_wait_all();\n  __syncthreads();\n  KL_CLK(1)\n  // flags"),
    ("", "    const KlSeg pre = kl_seg_block_scan(run, &total);\n",
     "    const KlSeg pre = kl_seg_block_scan(run, &total);\n    KL_CLK(2)\n"),
    ("", "    __syncthreads();\n    int merged = 0;\n",
     "    __syncthreads();\n    KL_CLK(3)\n    int merged = 0;\n"),
    ("", "    quiet = __syncthreads_or(merged) ? 0 : quiet + 1;\n",
     "    quiet = __syncthreads_or(merged) ? 0 : quiet + 1;\n    KL_CLK(4)\n"),
    ("", "      if (sfl[i] & 8) v[(long long)s * M + a0 + i] = sv[(long long)s * W + i];\n}",
     "      if (sfl[i] & 8) v[(long long)s * M + a0 + i] = sv[(long long)s * W + i];\n"
     "  KL_CLK(5)\n  if (t == 0) atomicAdd(kl_pair_clk + 7, 1ull);\n}"),
    ("", "KL_EXPORT int kl_pairing_rounds(",
     "KL_EXPORT int kl_pair_clocks(unsigned long long* out) {\n"
     "  unsigned long long zero[8] = {0};\n"
     "  cudaMemcpyFromSymbol(out, kl_pair_clk, sizeof(zero));\n"
     "  return (int)cudaMemcpyToSymbol(kl_pair_clk, zero, sizeof(zero));\n}\n"
     "KL_EXPORT int kl_pairing_rounds("),
]
PAIR_PHASES = ("keys and starts", "staging", "rounds' first scans",
               "rounds' lists of pairs", "rounds' cosines and merges",
               "write-back")
PAIRING_VARIANTS = {
    "committed": ([], {}),
    "clocks": (PAIR_CLOCKS, {}),
    "four-a-sm": ([("", "#define KL_PAIR_THREADS 512",
                    "#define KL_PAIR_THREADS 256"),
                   ("", "#define KL_PAIR_PER_SM 2", "#define KL_PAIR_PER_SM 4")],
                  {"PAIR_PER_SM": 4}),
    "eight-a-sm": ([("", "#define KL_PAIR_THREADS 512",
                     "#define KL_PAIR_THREADS 128"),
                    ("", "#define KL_PAIR_PER_SM 2",
                     "#define KL_PAIR_PER_SM 8")], {"PAIR_PER_SM": 8}),
    "one-a-sm": ([("", "#define KL_PAIR_THREADS 512",
                   "#define KL_PAIR_THREADS 1024"),
                  ("", "#define KL_PAIR_PER_SM 2", "#define KL_PAIR_PER_SM 1")],
                 {"PAIR_PER_SM": 1}),
    "unroll": ([("", "for (int s = 0; s < S; ++s) {",
                 "_Pragma(\"unroll 4\") for (int s = 0; s < S; ++s) {")],
               {}),
    "no-prefetch": ([("", "  kl_pair_copy(sv, W, v, S, M, w0, w1, w0, wide);\n",
                      ""),
                     ("", """  const int a0 = w0;
  if (r1 > w1) kl_pair_copy(sv, W, v, S, M, w1, r1, a0, wide);""",
                      """  const int a0 = r0 & ~3;
  kl_pair_copy(sv, W, v, S, M, r0, r1, a0, wide);""")], {}),
    "long-2": ([("", "#define KL_LONG_PER_SM 4", "#define KL_LONG_PER_SM 2")],
               {}),
    "no-merge-math": ([("", PAIR_MEAN, "")], {}),
    "cosines-only": ([("", "if (!(sim >= thr)) continue;",
                       "if (sim != -7.f) continue;"),
                      ("", QUIET, "quiet = 0 * __syncthreads_or(merged);")],
                     {}),
    "no-apply": ([("", "for (int u = t; u < npairs; u += T) {",
                   "for (int u = t; u < 0; u += T) {"),
                  ("", QUIET, "quiet = 0 * __syncthreads_or(merged);")], {}),
    "no-rounds": ([("", "for (int r = 0; r < rounds && quiet < 2; ++r) {",
                    "for (int r = 0; r < 0; ++r) {")], {}),
}
# the parent's entry point (the earlier design: three launches a round)
PARENT_PAIRING_SIGNATURE = (build._P, build._I, build._L, build._P, build._P,
                            build._P, build._P, build._P, build._L, build._I,
                            build._F, build._I, build._I, build._I, build._I,
                            build._P, build._P)


PAIR_OCCUPANCY = """
KL_EXPORT int kl_pair_occupancy(int smem, int long_kernel) {
  int n = -1, grid;
  if (kl_pair_setup(&grid)) return -1;
  if (long_kernel)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kl_pair_long,
                                                  KL_LONG_THREADS, smem);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kl_pair_short,
                                                  KL_PAIR_THREADS, smem);
  return n;
}
"""


def committed_pairing(lib: ctypes.CDLL, attrs: dict):
    """kernels.pairing_rounds on library lib, with the kernels attributes
    attrs set for the call."""
    fn = lib.kl_pairing_rounds
    fn.argtypes = build.SIGNATURES["kl_pairing_rounds"]
    fn.restype = ctypes.c_int

    def call(*args):
        saved = {a: getattr(kernels, a) for a in attrs}
        build._lib = lib
        for a, value in attrs.items():
            setattr(kernels, a, value)
        try:
            return kernels.pairing_rounds(*args)
        finally:
            for a, value in saved.items():
                setattr(kernels, a, value)

    return call


def parent_pairing(lib: ctypes.CDLL):
    """The parent's K10 (the earlier design: tile aggregates, one block's
    carry scan and the apply, three launches a round, on tiles of 2048
    positions) through its entry point in lib, with its plan."""
    fn = lib.kl_pairing_rounds
    fn.argtypes, fn.restype = PARENT_PAIRING_SIGNATURE, ctypes.c_int

    def call(sv, ss, sl, skey, shift, thr, rounds, smi=None, parent=None,
             base=0):
        S, M = sv.shape
        mi = smi if smi is not None else torch.full(
            (M,), -1, dtype=torch.int32, device=sv.device)
        tile = 2048
        blocks = -(-M // tile)
        scratch = torch.empty(6 * blocks, dtype=torch.int32, device=sv.device)
        err = fn(sv.data_ptr(), S, M, ss.data_ptr(), sl.data_ptr(),
                 skey.data_ptr(), mi.data_ptr(),
                 None if parent is None else parent.data_ptr(), base, shift,
                 thr, rounds, tile, blocks, 4 * (3 * tile + 1),
                 scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kl_pairing_rounds: CUDA error {err}")
        return sv, ss, mi

    return call


def pairing_inputs() -> list:
    """(what, sorted state, shift, thresholds): phase 3's first sorted
    state at 2^20, 2^22 and 2^24 x 20 (chip_smoke.first_sorted_state), and
    one segment across 2^22 columns of one profile (noise 1e-3)."""
    cases = []
    for M in (cs.SMALL, cs.OOC_BATCH, cs.FULL):
        *state, h = cs.first_sorted_state(M)
        cases.append((f"phase 3's state at {M}", state, kernels.free_bits(h),
                      (0.95, cs.PAIR_LOW)))
    n = cs.OOC_BATCH
    g = torch.Generator(device=cs.DEV).manual_seed(3)
    sv = 1 + 1e-3 * torch.randn((cs.S, n), device=cs.DEV, generator=g)
    cases.append((f"one segment across {n}",
                  [sv, torch.ones(n, dtype=torch.int32, device=cs.DEV),
                   torch.arange(n, dtype=torch.int32, device=cs.DEV),
                   torch.full((n,), 3, dtype=torch.int32, device=cs.DEV)], 0,
                  (0.9,)))
    return cases


def main_pairing(parent: str | None) -> None:
    from pathlib import Path

    libs = build_alone(build.CSRC, "pairing.cu",
                       {n: v[0] + [("", "KL_EXPORT int kl_pairing_rounds(",
                                    PAIR_OCCUPANCY
                                    + "KL_EXPORT int kl_pairing_rounds(")]
                        for n, v in PAIRING_VARIANTS.items()},
                       "pairing")
    calls = {name: committed_pairing(lib, PAIRING_VARIANTS[name][1])
             for name, lib in libs.items()}
    for name, lib in libs.items():   # blocks a SM at S = 20
        saved = kernels.PAIR_PER_SM
        kernels.PAIR_PER_SM = PAIRING_VARIANTS[name][1].get(
            "PAIR_PER_SM", saved)
        smem = kernels.pairing_plan(cs.S, cs.FULL)["smem"]
        kernels.PAIR_PER_SM = saved
        cs.log(f"pairing variant {name}: short-segment blocks a SM at "
               f"{smem} bytes {lib.kl_pair_occupancy(smem, 0)}, "
               f"cooperative blocks a SM {lib.kl_pair_occupancy(24580, 1)}")
    if parent:
        csrc = Path(parent).resolve() / "kmerlsh_tpu_torch" / "csrc"
        for name, lib in build_alone(csrc, "pairing.cu", {"parent": []},
                                     "pairing_parent").items():
            calls[name] = parent_pairing(lib)
    build._lib = None   # the inputs on the kernels as committed
    names = list(calls)
    for what, (sv, ss, sl, skey), shift, thrs in pairing_inputs():
        M = sv.shape[1]
        ident = torch.arange(M, dtype=torch.int32, device=cs.DEV)
        state = [sv.clone(), ss.clone(), ident.clone()]

        def restore():
            state[0].copy_(sv)
            state[1].copy_(ss)
            state[2].copy_(ident)

        for thr in thrs:
            def run(fn):
                return list(fn(state[0], state[1], sl, skey, shift, thr,
                               cs.PAIR_ROUNDS, None, state[2])) + [state[2]]

            restore()
            want = [x.clone() for x in run(kernels.pairing_rounds_plain)]
            for rnd in range(2):
                for name in (names if rnd == 0 else names[::-1]):
                    restore()
                    try:
                        same = all(torch.equal(a, b) for a, b in
                                   zip(run(calls[name]), want))
                        ms = cs.cuda_ms_restored(lambda: run(calls[name]),
                                                 restore)
                        cs.log(f"pairing {what}, {thr}, variant {name}, "
                               f"round {rnd}: {ms:.4f} ms (exact: {same})")
                    except (RuntimeError, ValueError) as e:
                        cs.log(f"pairing {what}, variant {name}: {e}")
            if "clocks" in calls and not what.startswith("one seg"):
                out = (ctypes.c_ulonglong * 8)()
                libs["clocks"].kl_pair_clocks(out)
                restore()
                run(calls["clocks"])
                torch.cuda.synchronize()
                libs["clocks"].kl_pair_clocks(out)
                blocks = kernels.pairing_plan(sv.shape[0], M)["blocks"]
                cs.log(f"pairing {what}, {thr}, clocks a block of "
                       f"{blocks}: " + ", ".join(
                           f"{ph} {out[k] / blocks:.0f}"
                           for k, ph in enumerate(PAIR_PHASES))
                       + f"; {out[7]} blocks wrote back")
            if M == cs.FULL and thr == 0.95 or what.startswith("one seg"):
                for name in names:
                    restore()
                    by, launched = cs.traced_launches(
                        lambda: (restore(), run(calls[name])), 10)
                    for k, (ms, c) in sorted(by.items()):
                        if k.startswith("kl_pair"):
                            cs.log(f"pairing {what}, {thr}, {name}, card "
                                   f"time by kernel: {k} {ms / 10:.4f} ms "
                                   f"in {c / 10:g} launches a call")
        del state
    build._lib = None


def main() -> None:
    if sys.argv[1:2] == ["pairing"]:
        main_pairing(sys.argv[2] if len(sys.argv) > 2 else None)
        return
    if sys.argv[1:2] == ["sort"]:
        main_sort(sys.argv[2] if len(sys.argv) > 2 else None)
        return
    if sys.argv[1:] == ["fold"]:
        main_fold()
        return
    if sys.argv[1:2] == ["wrs"]:
        main_wrs(sys.argv[2] if len(sys.argv) > 2 else None)
        return
    libs = build_variants()
    for M in (cs.LATE, cs.FULL):
        keys_in, fin_in = inputs(M, libs["committed"])
        want_keys = kernels.lsh_keys_plain(*keys_in)
        want_fin = kernels.finalize_plain(*fin_in)
        for rnd in range(2):
            for name, lib in libs.items():
                build._lib = lib
                parts = []
                if not any(src == "finalize.cu" for src, _, _ in
                           VARIANTS[name]):
                    parts.append(f"lsh_keys (h = {keys_in[3]}) " + timed(
                        kernels.lsh_keys, keys_in, want_keys))
                if name == "committed" or name not in INEXACT and not any(
                        src == "lsh_keys.cu" for src, _, _ in VARIANTS[name]):
                    parts.append("finalize " + timed(kernels.finalize, fin_in,
                                                     want_fin))
                cs.log(f"variant {name} at {M}, round {rnd}: "
                       + "; ".join(parts))
    build._lib = None


if __name__ == "__main__":
    main()
