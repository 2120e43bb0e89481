// K6: the batched pooled two-sample t-test and the WRS verdicts of mode E.
//
// Replaces kmerlsh_tpu/ops/ttest.py t_cdf, studentttest2 and wrs_verdicts,
// whose t CDF is XLA's regularized_incomplete_beta: a Lentz-Thompson-
// Barnett continued fraction of at most 200 float32 steps with
// small = threshold = eps/2, the symmetry swap at x >= (a+1)/(a+b+2) and an
// lgamma prefactor. XLA runs the fraction until every element of the batch
// has converged; here each row stops at its own convergence, exactly as the
// plain version (kmerlsh_tpu_torch/ops/ttest.py) does.
//
// What bounds it on the H100 (PERF.md §6, tools/kernel_variants.py wrs):
// by its bytes (S values read once, 9 bytes written) a call at 2^20 rows of
// 10 + 10 could take 0.029 ms, but the kernel is bound by its instructions'
// latency: IEEE divisions (three a step of the fraction, five a row
// besides), the fraction's ~8 dependent steps a row and the tail's
// logarithms and exponential. The one-thread-a-row kernel this replaces
// read each row twice at a stride of S floats (at S = 100 four times its
// bound), called lgammaf three times a row, and ran each warp as long as
// its slowest row, 17.6 steps for rows needing 7.9. The design:
//   - each warp stages 32-row tiles in shared memory with cp.async,
//     neighbouring lanes on neighbouring 16-byte (where the rows and the
//     base are 16-byte aligned, else 4-byte) pieces of the tile's span,
//     with the rows' sizes; each lane reads its row back as float4s at a
//     stride of P = S rounded up to 4 mod 8 floats, free of bank conflicts,
//     for both sums. Above kChunk columns the row comes in chunks of
//     kChunk, once for each sum. The next tile's copy is issued once the
//     sums have read the stage: a second stage costs more in blocks a SM
//     than it hides;
//   - the per-launch constants come once a block: a = df/2 and b = 1/2 are
//     the same for every row, so after the swap (aa, bb) is one of two
//     pairs; for each, the lgamma terms and each step's partial-numerator
//     coefficient and denominator (a step is then pn = (coef * x) / den,
//     the plain version's rounding), and the state after the fraction's
//     first step, which no row's x enters;
//   - a row's steps follow its x, so the block sorts the rows that need
//     the fraction by a bucket of x (kBuckets a pair, one shared-memory
//     atomic a row, a scan, a scatter of row offsets) and each warp then
//     runs 32 rows of near x (tools/kernel_split.py wrs: 10.2 steps for a
//     warp's slowest row against 17.6 in row order). Lanes that take a
//     new row from a queue as theirs converges would run fewer steps, but
//     the queue's bookkeeping and each warp's final drain cost more than
//     they saved (PERF.md §6);
//   - the block's tails and verdicts are written from shared memory,
//     coalesced. A block takes `tiles` 32-row tiles a warp (kernels.wrs_plan).
//
// Rounding: no fast math and no contraction. Every add, multiply, divide
// and square root is an explicit round-to-nearest intrinsic in the order
// of the plain version, and lgammaf / logf / log1pf / expf are the same
// CUDA functions PyTorch's elementwise kernels call, so the kernel and the
// plain version on the card agree to the last bit or within a few ulps.

#include <limits.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kSmall = 5.9604644775390625e-08f;   // 2^-24 = eps / 2
constexpr float kVerySmall = 2.3509887016445750e-38f;  // 2 * FLT_MIN
constexpr int kMaxIter = 200;
constexpr int kWarps = 4;     // warps a block
constexpr int kMaxTiles = 4;  // 32-row tiles a warp takes of its block's rows
constexpr int kChunk = 124;   // staged columns a row, at most
constexpr int kBuckets = 32;  // sort keys of each pair (x's range cut evenly)
constexpr int kSmemLimit = 232448;

// a row's entry for the fraction: its offset in the block, then flags
constexpr int kRapid = 1 << 9, kTPos = 1 << 10, kZero = 1 << 11,
              kOne = 1 << 12, kNaN = 1 << 13;

// Per launch, a block's copy: pair 0 is (aa, bb) = (a, b), pair 1 (b, a).
struct Consts {
  float aa[2], bb[2], lbeta_small_a[2], lbeta[2];
  float h1, c1, d1;   // h, c and d after the fraction's first step
  int queued;         // the block's rows that need the fraction
  float pad[4];
};

// A block's shared memory: the step table and the constants, then each
// warp's stage of 32 rows at a stride of `chunk` floats and their sizes,
// the bucket counts, and for each of the block's rows its (x, entry) or its
// two tails, its bucket and rank, its place in the sorted order and its
// verdict.
constexpr int kTableBytes = 2 * kMaxIter * 8;

__host__ __device__ constexpr int wrs_smem(int chunk, int tiles) {
  return kTableBytes + (int)sizeof(Consts) + kWarps * 4 * 32 * (chunk + 1) +
         8 * kBuckets + 32 * kWarps * tiles * (8 + 4 + 2 + 1);
}

// Copy rows [row0, row0 + 32) ∩ [0, N), columns [c0, c0 + cols), into the
// stage, `vec` bytes a copy, neighbouring lanes on neighbouring pieces of
// the span; with the first chunk, the rows' sizes too; one commit group.
__device__ __forceinline__ void wrs_issue(float* stage, int* ssz, int chunk,
                                          const float* __restrict__ values,
                                          const int* __restrict__ sizes,
                                          long long ld, long long N,
                                          long long row0, int c0, int cols,
                                          int vec, int lane) {
  const int W = vec == 16 ? (cols + 3) >> 2 : cols;   // pieces a row
  const int step_r = 32 / W, step_j = 32 % W;
  int r = lane / W, j = lane % W;
  for (; r < 32 && row0 + r < N;) {
    const float* src = values + (row0 + r) * ld + c0;
    float* dst = stage + r * chunk;
    if (vec == 16)
      kl_cp_async16(dst + 4 * j, src + 4 * j);
    else
      kl_cp_async4(dst + j, src + j);
    r += step_r;
    j += step_j;
    if (j >= W) {
      j -= W;
      ++r;
    }
  }
  if (c0 == 0 && row0 + lane < N) kl_cp_async4(ssz + lane, sizes + row0 + lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wrs_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Add this lane's staged row, columns [c0, c0 + cols), into the sums: the
// pass of the means (sq false) or of the squared deviations from xm, ym.
// Group A's columns (below n1) and group B's go in turns, a float4 of each,
// so that the two sums' dependent adds interleave; each sum still takes its
// columns in order.
__device__ __forceinline__ void wrs_sums(const float* stage, int chunk,
                                         int c0, int cols, int n1, int lane,
                                         bool sq, float xm, float ym,
                                         float& sx, float& sy) {
  const float4* mine = reinterpret_cast<const float4*>(stage + lane * chunk);
  auto add4 = [sq](float& acc, float4 v4, float m, int lo, int hi) {
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < lo || i >= hi) continue;
      if (sq) {
        const float e = __fsub_rn(v[i], m);
        acc = __fadd_rn(acc, __fmul_rn(e, e));
      } else {
        acc = __fadd_rn(acc, v[i]);
      }
    }
  };
  const int end = c0 + cols;
  const int a_end = min(end, n1) - c0;    // group A: stage columns [0, a_end)
  const int b_beg = max(c0, n1) - c0;     // group B: [b_beg, cols)
  const int qa_end = (a_end + 3) >> 2;
  int qa = 0, qb = b_beg >> 2;
  const int qb_end = b_beg < cols ? (cols + 3) >> 2 : qb;
  while (qa < qa_end || qb < qb_end) {
    if (qa < qa_end) {
      add4(sx, mine[qa], xm, 0, a_end - 4 * qa);
      ++qa;
    }
    if (qb < qb_end) {
      add4(sy, mine[qb], ym, b_beg - 4 * qb, cols - 4 * qb);
      ++qb;
    }
  }
}

__device__ __forceinline__ void wrs_write(long long row, float left,
                                          float right, bool counted,
                                          float pval,
                                          signed char* __restrict__ verdict,
                                          float* __restrict__ left_out,
                                          float* __restrict__ right_out) {
  const signed char out = left <= pval ? 2 : (right <= pval ? 1 : 0);
  verdict[row] = counted ? out : 0;
  left_out[row] = left;
  right_out[row] = right;
}

// The tail of a row's fraction h: the prefactor, the swap undone, the
// special cases; returns I_x(a, b).
__device__ __forceinline__ float wrs_tail(const Consts& k, float h, float xx,
                                          bool rapid, bool zero, bool one,
                                          bool nan) {
  const int pair = rapid ? 0 : 1;
  const float aa = k.aa[pair], bb = k.bb[pair];
  const float l1x = log1pf(-xx);
  const float factor =
      aa < kVerySmall
          ? expf(__fsub_rn(__fmul_rn(l1x, bb), k.lbeta_small_a[pair]))
          : __fdiv_rn(expf(__fsub_rn(__fadd_rn(__fmul_rn(logf(xx), aa),
                                               __fmul_rn(l1x, bb)),
                                     k.lbeta[pair])),
                      aa);
  float r = __fmul_rn(h, factor);
  if (!rapid) r = __fsub_rn(1.0f, r);
  if (zero) r = 0.0f;
  if (one) r = 1.0f;
  if (nan) r = CUDART_NAN_F;
  return r;
}

// The table and constants of both pairs, by the block's threads.
__device__ void wrs_constants(float a, float b, float2* table, Consts& k,
                              int tid) {
  for (int i = tid; i < 2 * kMaxIter; i += 32 * kWarps) {
    const int pair = i / kMaxIter, it = i - pair * kMaxIter;
    const float aa = pair ? b : a, bb = pair ? a : b;
    float coef = 1.0f, den = 1.0f;   // step 1's (and the unused 0's)
    if (it >= 2) {
      const int mi = (it - 1) / 2;
      const float m = (float)mi;
      const float a2m = __fadd_rn(aa, __fmul_rn(2.0f, m));
      if ((it & 1) == 0) {
        if (mi == 0) {
          coef = -__fadd_rn(aa, bb);
          den = __fadd_rn(aa, 1.0f);
        } else {
          coef = __fmul_rn(-__fadd_rn(aa, m), __fadd_rn(__fadd_rn(aa, bb), m));
          den = __fmul_rn(a2m, __fadd_rn(a2m, 1.0f));
        }
      } else {
        coef = __fmul_rn(m, __fsub_rn(bb, m));
        den = __fmul_rn(__fsub_rn(a2m, 1.0f), a2m);
      }
    }
    table[i] = make_float2(coef, den);
  }
  if (tid < 2) {
    const float aa = tid ? b : a, bb = tid ? a : b;
    k.aa[tid] = aa;
    k.bb[tid] = bb;
    k.lbeta_small_a[tid] = __fsub_rn(lgammaf(bb), lgammaf(__fadd_rn(aa, bb)));
    k.lbeta[tid] = __fadd_rn(lgammaf(aa), k.lbeta_small_a[tid]);
  }
  if (tid == 2) {
    // step 1: the partial numerator is 1 whatever x, from h = c = small,
    // d = 0; delta is then 2^24, so no row converges there
    const float pn = 1.0f;
    float cn = __fadd_rn(1.0f, __fdiv_rn(pn, kSmall));
    if (fabsf(cn) < kSmall) cn = kSmall;
    float dn = __fadd_rn(1.0f, __fmul_rn(pn, 0.0f));
    if (fabsf(dn) < kSmall) dn = kSmall;
    dn = __fdiv_rn(1.0f, dn);
    k.h1 = __fmul_rn(kSmall, __fmul_rn(cn, dn));
    k.c1 = cn;
    k.d1 = dn;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    kl_wrs_kernel(const float* __restrict__ values, long long ld, int N,
                  int n1, int n2, const int* __restrict__ sizes, float inv_sum,
                  float pval, int size_thresh, int chunk, int vec, int tiles,
                  signed char* __restrict__ verdict,
                  float* __restrict__ left_out,
                  float* __restrict__ right_out) {
  extern __shared__ float4 kl_wrs_smem[];
  float2* table = reinterpret_cast<float2*>(kl_wrs_smem);
  Consts& k = *reinterpret_cast<Consts*>(table + 2 * kMaxIter);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = 32 * kWarps * tiles;   // the block's
  float* stage = reinterpret_cast<float*>(&k + 1) + warp * 32 * (chunk + 1);
  int* ssz = reinterpret_cast<int*>(stage + 32 * chunk);
  int* bucket = reinterpret_cast<int*>(&k + 1) + kWarps * 32 * (chunk + 1);
  float2* row = reinterpret_cast<float2*>(bucket + 2 * kBuckets);
  int* rank = reinterpret_cast<int*>(row + rows);
  short* order = reinterpret_cast<short*>(rank + rows);
  signed char* verd = reinterpret_cast<signed char*>(order + rows);

  const int S = n1 + n2, df = S - 2;
  const int chunks = (S + chunk - 1) / chunk;
  const float dff = (float)df;
  const float a = __fdiv_rn(dff, 2.0f), b = 0.5f;
  const bool a_zero = a == 0.0f || b == CUDART_INF_F;
  const bool b_zero = b == 0.0f || a == CUDART_INF_F;
  const float thr =
      __fdiv_rn(__fadd_rn(a, 1.0f), __fadd_rn(__fadd_rn(a, b), 2.0f));
  const float fdf = (float)max(df, 1);

  // this warp's 32-row tiles of the block's rows
  const long long base = (long long)blockIdx.x * rows;
  auto issue = [&](long long row0, int j) {
    const int c0 = j * chunk;
    wrs_issue(stage, ssz, chunk, values, sizes, ld, N, row0, c0,
              min(chunk, S - c0), vec, lane);
  };
  if (base + 32 * warp < N) issue(base + 32 * warp, 0);
  wrs_constants(a, b, table, k, tid);
  for (int i = tid; i < 2 * kBuckets; i += 32 * kWarps) bucket[i] = 0;
  for (int i = tid; i < rows; i += 32 * kWarps) rank[i] = -1;
  __syncthreads();

  // 1. each row's sums and statistic; a row that needs the fraction gets
  // its x, flags and a bucket of its x (with a rank in it), the others
  // their tails
  for (int i = 0; i < tiles; ++i) {
    const int off0 = 32 * (warp + kWarps * i);
    const long long row0 = base + off0;
    if (row0 >= N) break;
    float xs = 0.0f, ys = 0.0f, ssx = 0.0f, ssy = 0.0f, xm = 0.0f, ym = 0.0f;
    int sz = 0;
    const long long next = row0 + 32 * kWarps;
    const bool more = i + 1 < tiles && next < N;
    if (chunks == 1) {   // the whole row staged: both sums read it
      wrs_wait();
      sz = ssz[lane];
      wrs_sums(stage, chunk, 0, S, n1, lane, false, 0.0f, 0.0f, xs, ys);
      xm = __fdiv_rn(xs, (float)n1);
      ym = __fdiv_rn(ys, (float)n2);
      wrs_sums(stage, chunk, 0, S, n1, lane, true, xm, ym, ssx, ssy);
      __syncwarp();   // the stage is read: the next tile may come
      if (more) issue(next, 0);
    } else {             // chunk by chunk, once for each sum
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = 0; j < chunks; ++j) {
          const int c0 = j * chunk;
          wrs_wait();
          if (pass == 0 && j == 0) sz = ssz[lane];
          if (pass == 0)
            wrs_sums(stage, chunk, c0, min(chunk, S - c0), n1, lane, false,
                     0.0f, 0.0f, xs, ys);
          else
            wrs_sums(stage, chunk, c0, min(chunk, S - c0), n1, lane, true,
                     xm, ym, ssx, ssy);
          __syncwarp();
          if (j + 1 < chunks) issue(row0, j + 1);
          else if (pass == 0) issue(row0, 0);
          else if (more) issue(next, 0);
        }
        if (pass == 0) {
          xm = __fdiv_rn(xs, (float)n1);
          ym = __fdiv_rn(ys, (float)n2);
        }
      }
    }
    if (row0 + lane >= N) continue;
    const int off = off0 + lane;
    verd[off] = sz > size_thresh;   // counted; the verdict comes later
    const float s = __fsqrt_rn(
        __fdiv_rn(__fmul_rn(__fadd_rn(ssx, ssy), inv_sum), fdf));
    if (s > 0.0f && df > 0) {
      const float t = __fdiv_rn(__fsub_rn(xm, ym), s);
      const float x = __fdiv_rn(dff, __fadd_rn(dff, __fmul_rn(t, t)));
      const bool x_zero = x == 0.0f, x_one = x == 1.0f;
      const bool rapid = x < thr;
      const float xx = rapid ? x : __fsub_rn(1.0f, x);
      int e = off | (rapid ? kRapid : 0) | (t >= 0.0f ? kTPos : 0);
      if ((b_zero && !x_one) || (a_zero && x_zero)) e |= kZero;
      if ((a_zero && !x_zero) || (b_zero && x_one)) e |= kOne;
      if (a < 0.0f || b < 0.0f || x < 0.0f || x > 1.0f ||
          (a_zero && b_zero) || isnan(a) || isnan(b) || isnan(x))
        e |= kNaN;
      // the bucket only orders the rows: any rounding will do
      const float u = __fdividef(xx, rapid ? thr : 1.0f - thr);
      const int key = (rapid ? 0 : kBuckets) + min(kBuckets - 1,
                                                    max(0, (int)(u * kBuckets)));
      row[off] = make_float2(xx, __int_as_float(e));
      rank[off] = key << 16 | atomicAdd(bucket + key, 1);
    } else {
      row[off] = make_float2(xm >= ym ? 1.0f : 0.0f, xm <= ym ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  // 2. the rows that need the fraction sorted by bucket: each warp then
  // takes 32 rows of near x, which converge after near step counts
  if (warp == 0) {
    const int c0 = bucket[2 * lane], c1 = bucket[2 * lane + 1];
    int incl = c0 + c1;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    bucket[2 * lane] = incl - c0 - c1;
    bucket[2 * lane + 1] = incl - c1;
    if (lane == 31) k.queued = incl;
  }
  __syncthreads();
  for (int i = tid; i < rows; i += 32 * kWarps) {
    const int rk = rank[i];
    if (rk >= 0) order[bucket[rk >> 16] + (rk & 0xFFFF)] = (short)i;
  }
  __syncthreads();

  // 3. the continued fraction from its second step on, and the tails
  for (int q = tid; q < k.queued; q += 32 * kWarps) {
    const float2 en = row[order[q]];
    const float xx = en.x;
    const int e = __float_as_int(en.y);
    const bool rapid = e & kRapid;
    const float2* steps = table + (rapid ? 0 : kMaxIter);
    float h = k.h1, c = k.c1, d = k.d1;
    for (int it = 2; it < kMaxIter; ++it) {
      const float2 cd = steps[it];
      const float pn = __fdiv_rn(__fmul_rn(cd.x, xx), cd.y);
      float cn = __fadd_rn(1.0f, __fdiv_rn(pn, c));
      if (fabsf(cn) < kSmall) cn = kSmall;
      float dn = __fadd_rn(1.0f, __fmul_rn(pn, d));
      if (fabsf(dn) < kSmall) dn = kSmall;
      dn = __fdiv_rn(1.0f, dn);
      const float delta = __fmul_rn(cn, dn);
      h = __fmul_rn(h, delta);
      c = cn;
      d = dn;
      if (!(fabsf(__fsub_rn(delta, 1.0f)) >= kSmall)) break;
    }
    const float ib = wrs_tail(k, h, xx, rapid, e & kZero, e & kOne, e & kNaN);
    const float p = (e & kTPos) ? __fsub_rn(1.0f, __fmul_rn(0.5f, ib))
                                : __fmul_rn(0.5f, ib);
    row[e & 511] = make_float2(p, __fsub_rn(1.0f, p));
  }
  __syncthreads();

  // 4. the block's verdicts and tails, coalesced
  for (int i = tid; i < rows && base + i < N; i += 32 * kWarps) {
    const float2 lr = row[i];
    wrs_write(base + i, lr.x, lr.y, verd[i], pval, verdict, left_out,
              right_out);
  }
}

}  // namespace

KL_EXPORT int kl_wrs_verdicts(const void* values, long long ld, long long N,
                              int n1, int n2, const void* sizes, float inv_sum,
                              float pval, int size_thresh, int chunk, int vec,
                              int tiles, int blocks, int smem, void* verdict,
                              void* left, void* right, void* stream) {
  const int S = n1 + n2;
  const int P = S + (12 - S % 8) % 8;   // the least P >= S with P % 8 == 4
  const bool aligned = ld % 4 == 0 && (uintptr_t)values % 16 == 0;
  if (n1 < 1 || n2 < 1 || ld < S || N < 1 || N > INT_MAX || tiles < 1 ||
      tiles > kMaxTiles ||
      (long long)blocks * 32 * kWarps * tiles < N ||
      chunk != (P <= kChunk ? P : kChunk) || (vec != 4 && vec != 16) ||
      (vec == 16 && !aligned) || smem != wrs_smem(chunk, tiles) ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {   // the default limit; raising it costs a call
    const cudaError_t err = cudaFuncSetAttribute(
        kl_wrs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kl_wrs_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      (const float*)values, ld, (int)N, n1, n2, (const int*)sizes, inv_sum,
      pval, size_thresh, chunk, vec, tiles, (signed char*)verdict,
      (float*)left, (float*)right);
  return (int)cudaGetLastError();
}
