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
// Bound on the H100: compute. Each row runs up to 199 dependent steps of
// the fraction (two divisions each), over ~1.5 M cluster rows of a
// 2^24-row clustering; the 80 bytes a row reads are negligible beside
// that. The design is one thread per row with everything in registers:
// means, sums of squares, the statistic and the fraction, then the tail
// and the verdict. Rows converge after different step counts, so a warp
// runs as long as its slowest row; the fraction converges in a few dozen
// steps for the t distribution's parameters, so that costs little.
//
// Rounding: no fast math and no contraction. Every add, multiply, divide
// and square root is an explicit round-to-nearest intrinsic in the order
// of the plain version, and lgammaf / logf / log1pf / expf are the same
// CUDA functions PyTorch's elementwise kernels call, so the kernel and the
// plain version on the card agree to the last bit or within a few ulps.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kSmall = 5.9604644775390625e-08f;   // 2^-24 = eps / 2
constexpr float kVerySmall = 2.3509887016445750e-38f;  // 2 * FLT_MIN
constexpr int kMaxIter = 200;

__device__ float partial_numerator(int it, float a, float b, float x) {
  if (it == 1) return 1.0f;
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

__device__ float betainc(float a, float b, float x) {
  const bool a_zero = a == 0.0f || b == CUDART_INF_F;
  const bool b_zero = b == 0.0f || a == CUDART_INF_F;
  const bool x_zero = x == 0.0f, x_one = x == 1.0f;
  const bool res_zero = (b_zero && !x_one) || (a_zero && x_zero);
  const bool res_one = (a_zero && !x_zero) || (b_zero && x_one);
  const bool res_nan = a < 0.0f || b < 0.0f || x < 0.0f || x > 1.0f ||
                       (a_zero && b_zero) || isnan(a) || isnan(b) || isnan(x);
  const bool rapid =
      x < __fdiv_rn(__fadd_rn(a, 1.0f), __fadd_rn(__fadd_rn(a, b), 2.0f));
  const float aa = rapid ? a : b;
  const float bb = rapid ? b : a;
  const float xx = rapid ? x : __fsub_rn(1.0f, x);

  float h = kSmall, c = kSmall, d = 0.0f;
  for (int it = 1; it < kMaxIter; ++it) {
    const float pn = partial_numerator(it, aa, bb, xx);
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

  const float lbeta_small_a = __fsub_rn(lgammaf(bb), lgammaf(__fadd_rn(aa, bb)));
  const float lbeta = __fadd_rn(lgammaf(aa), lbeta_small_a);
  const float l1x = log1pf(-xx);
  const float factor =
      aa < kVerySmall
          ? expf(__fsub_rn(__fmul_rn(l1x, bb), lbeta_small_a))
          : __fdiv_rn(expf(__fsub_rn(__fadd_rn(__fmul_rn(logf(xx), aa),
                                               __fmul_rn(l1x, bb)),
                                     lbeta)),
                      aa);
  float r = __fmul_rn(h, factor);
  if (!rapid) r = __fsub_rn(1.0f, r);
  if (res_zero) r = 0.0f;
  if (res_one) r = 1.0f;
  if (res_nan) r = CUDART_NAN_F;
  return r;
}

__global__ void kl_wrs_kernel(const float* __restrict__ values, long long ld,
                              long long N, int n1, int n2,
                              const int* __restrict__ sizes, float inv_sum,
                              float pval, int size_thresh,
                              signed char* __restrict__ verdict,
                              float* __restrict__ left_out,
                              float* __restrict__ right_out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const float* v = values + row * ld;
  float xs = 0.0f, ys = 0.0f;
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
  const int df = n1 + n2 - 2;
  const float s = __fsqrt_rn(
      __fdiv_rn(__fmul_rn(__fadd_rn(ssx, ssy), inv_sum), (float)max(df, 1)));
  const bool ok = s > 0.0f && df > 0;
  float left, right;
  if (ok) {
    const float t = __fdiv_rn(__fsub_rn(xm, ym), s);
    const float dff = (float)df;
    const float x = __fdiv_rn(dff, __fadd_rn(dff, __fmul_rn(t, t)));
    const float ib = betainc(__fdiv_rn(dff, 2.0f), 0.5f, x);
    const float p = t >= 0.0f ? __fsub_rn(1.0f, __fmul_rn(0.5f, ib))
                              : __fmul_rn(0.5f, ib);
    left = p;
    right = __fsub_rn(1.0f, p);
  } else {
    left = xm >= ym ? 1.0f : 0.0f;
    right = xm <= ym ? 1.0f : 0.0f;
  }
  signed char out = left <= pval ? 2 : (right <= pval ? 1 : 0);
  verdict[row] = sizes[row] > size_thresh ? out : 0;
  left_out[row] = left;
  right_out[row] = right;
}

}  // namespace

KL_EXPORT int kl_wrs_verdicts(const void* values, long long ld, long long N,
                              int n1, int n2, const void* sizes, float inv_sum,
                              float pval, int size_thresh, void* verdict,
                              void* left, void* right, void* stream) {
  const int threads = 128;
  kl_wrs_kernel<<<kl_blocks(N, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)values, ld, N, n1, n2, (const int*)sizes, inv_sum, pval,
      size_thresh, (signed char*)verdict, (float*)left, (float*)right);
  return (int)cudaGetLastError();
}
