// draw_planes: every iteration's LSH hyperplanes of a session in one launch.
//
// Replaces the reference's in-graph draw, jax.random.normal(fold_in(
// PRNGKey(seed), it), (S, 31)) (kmerlsh_tpu/ops/lsh.py:27-30, called inside
// the device program at kmerlsh_tpu/cluster/engine.py:441 and :511), which
// the port had moved to the host. The output is f32 [iterations, S, 31];
// slice it equals kmerlsh_tpu_torch/ops/rng.py draw_hyperplanes(seed, it, S)
// bit for bit, and rng.draw_planes is the plain twin.
//
// One thread an output element:
//   - the iteration's key: Threefry-2x32 of the counter (0, it) under the
//     key (0, seed) (fold_in of PRNGKey(seed));
//   - its 32 bits: Threefry-2x32 of the counter (0, i) under that key, i the
//     element's flat index inside [S, 31], the two words XORed;
//   - the uniform: bits >> 9 as the mantissa of a float in [1, 2), then
//     max(lo, (mant - 1) * (1 - lo) + lo) with lo = nextafter(-1, 0);
//   - XLA's float32 erfinv, whose log1p and log are ops/xlamath.py's
//     emulation of XLA's CPU order; times float32 sqrt(2).
// Exactness: the plain twin rounds every float32 op on its own and
// emulates each fused multiply-add as a float64 product and sum rounded
// once to float32. NVCC_FLAGS leave -fmad on, so this file writes its
// arithmetic with rounding intrinsics (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn; __dmul_rn / __dadd_rn for the emulated fma), which
// the compiler never contracts. Constants are written as PyTorch makes
// them, a double rounded to float (KL_F). A Python float beside a float32
// tensor is compared and combined in float32, so the thresholds are floats.
// The twin's torch.sqrt is MKL's, 1 ulp below IEEE's on 142 of the values
// the draw takes: kl_twin_sqrt repeats it from a table of those values.
//
// Bound: 4 * 31 * S * iterations bytes written, 1.55 MB at 101 x 124 x 31
// (0.46 us at 3.35 TB/s); ~50 float64 operations an element (the emulated
// fmas) take ~0.6 us at the card's 34 TFLOP/s in float64, the ~200 integer
// and ~30 float32 ones less. So it is bound by its launch latency, and one
// launch a session is the design.
//
// kl_normal_of_bits maps given bits through the same device function, so a
// test can hold it to the twin on all 2^23 mantissas.

#include <float.h>

#include "common.cuh"

#define KL_F(v) ((float)(v))

__device__ __forceinline__ uint2 kl_threefry2x32(unsigned k0, unsigned k1,
                                                 unsigned x0, unsigned x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned a = x0 + ks[0], b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = __funnelshift_l(b, b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  return make_uint2(a, b);
}

// xlamath.fma: float32 a*b + c through a float64 product and sum
__device__ __forceinline__ float kl_fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

// xlamath.log, for a positive normal x
__device__ __forceinline__ float kl_xla_log(float x) {
  int ex;
  const float m = frexpf(x, &ex);
  const bool small = m < KL_F(0.707106781186547524);
  const float e = __fsub_rn((float)ex, small ? 1.0f : 0.0f);
  float t = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float t2 = __fmul_rn(t, t), t3 = __fmul_rn(t2, t);
  float y = kl_fma64(t, KL_F(7.0376836292e-2), KL_F(-1.1514610310e-1));
  float y1 = kl_fma64(t, KL_F(-1.2420140846e-1), KL_F(1.4249322787e-1));
  float y2 = kl_fma64(t, KL_F(2.0000714765e-1), KL_F(-2.4999993993e-1));
  y = kl_fma64(y, t, KL_F(1.1676998740e-1));
  y1 = kl_fma64(y1, t, KL_F(-1.6668057665e-1));
  y2 = kl_fma64(y2, t, KL_F(3.3333331174e-1));
  y = kl_fma64(y, t3, y1);
  y = kl_fma64(y, t3, y2);
  y = __fmul_rn(y, t3);
  y = kl_fma64(KL_F(-2.12194440e-4), e, y);
  t = __fsub_rn(t, __fmul_rn(t2, 0.5f));
  t = __fadd_rn(t, y);
  return __fadd_rn(t, __fmul_rn(KL_F(0.693359375), e));
}

// xlamath.log1p
__device__ __forceinline__ float kl_xla_log1p(float x) {
  const float num_c[7] = {
      KL_F(4.5270000862445199635215e-5), KL_F(4.9854102823193375972212e-1),
      KL_F(6.5787325942061044846969e0), KL_F(2.9911919328553073277375e1),
      KL_F(6.0949667980987787057556e1), KL_F(5.7112963590585538103336e1),
      KL_F(2.0039553499201281259648e1)};
  const float den_c[7] = {
      KL_F(1.0), KL_F(1.5062909083469192043167e1),
      KL_F(8.3047565967967209469434e1), KL_F(2.2176239823732856465394e2),
      KL_F(3.0909872225312059774938e2), KL_F(2.1642788614495947685003e2),
      KL_F(6.0118660497603843919306e1)};
  if (!(fabsf(x) < KL_F(0.41421356237309504880)))
    return kl_xla_log(__fadd_rn(1.0f, x));
  const float x2 = __fmul_rn(x, x);
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) num = kl_fma64(num, x, num_c[i]);
#pragma unroll
  for (int i = 0; i < 7; ++i) den = kl_fma64(den, x, den_c[i]);
  float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  r = kl_fma64(-0.5f, x2, r);
  return __fadd_rn(x, r);
}

// torch.sqrt of a float32 CPU tensor (MKL's vsSqrt, which PyTorch calls
// there) is not correctly rounded: of the 28,309 values w >= 5 that
// -log1p(-u^2) takes over the draw's 2^23 uniforms, it gives the float below
// IEEE's sqrt at these KL_SQRT_BELOW, float32 bits in ascending order
// (tests/test_torch_rng.py finds them again from torch.sqrt).
#define KL_SQRT_BELOW 142
__constant__ unsigned kl_sqrt_below[KL_SQRT_BELOW] = {
    0x40A00DA2u, 0x40A011FEu, 0x40A15174u, 0x40A19183u, 0x40A1C3BEu,
    0x40A1E25Bu, 0x40A20F36u, 0x40A21790u, 0x40A253E5u, 0x40A2695Bu,
    0x40A27C72u, 0x40A28FD0u, 0x40A2CF41u, 0x40A3BA2Bu, 0x40A3C009u,
    0x40A3CE63u, 0x40A3E680u, 0x40A40779u, 0x40A40B17u, 0x40A53C84u,
    0x40A5475Du, 0x40A5480Cu, 0x40A548BBu, 0x40A54AC8u, 0x40A54B77u,
    0x40A55CEEu, 0x40A585A5u, 0x40A58A78u, 0x40A5A0D1u, 0x40A603A7u,
    0x40A61476u, 0x40A628BAu, 0x40A6296Eu, 0x40A660F7u, 0x40A6889Au,
    0x40A68BCDu, 0x40A69887u, 0x40A6A949u, 0x40A6B3A5u, 0x40A6DB3Bu,
    0x40A809C1u, 0x40A8117Du, 0x40A9B7B1u, 0x40A9D841u, 0x40A9FDB3u,
    0x40AA0274u, 0x40AA27B1u, 0x40AA69F3u, 0x40AA717Au, 0x40AAC19Du,
    0x40ABE9FCu, 0x40AC2843u, 0x40AD24CDu, 0x40AD7C79u, 0x40AD9CC9u,
    0x40ADA91Bu, 0x40ADBEE7u, 0x40ADEB01u, 0x40ADF800u, 0x40AE3E7Fu,
    0x40AE48E8u, 0x40AE57DEu, 0x40AE6BBFu, 0x40AEA3C7u, 0x40AEB027u,
    0x40AFD365u, 0x40AFDB01u, 0x40B1645Bu, 0x40B1B279u, 0x40B1C6A7u,
    0x40B1E2DEu, 0x40B208FAu, 0x40B28674u, 0x40B3EB98u, 0x40B57DE7u,
    0x40B5A86Du, 0x40B5B46Au, 0x40B5E6D5u, 0x40B5F638u, 0x40B608AAu,
    0x40B63662u, 0x40B63F87u, 0x40B655A2u, 0x40B66EB8u, 0x40B683C8u,
    0x40B6AAFBu, 0x40B6C455u, 0x40B755FCu, 0x40B86142u, 0x40B993A0u,
    0x40B9E9A7u, 0x40B9ECE9u, 0x40BA6C2Au, 0x40BAAFCAu, 0x40BAC931u,
    0x40BB0F9Fu, 0x40BDC172u, 0x40BDE555u, 0x40BE57C0u, 0x40BE8F1Eu,
    0x40BECEA2u, 0x40C2483Cu, 0x40C59568u, 0x40C60D6Eu, 0x40C62AFFu,
    0x40C94F81u, 0x40C967C9u, 0x40CA3211u, 0x40CBFB6Au, 0x40CC2A87u,
    0x40CDDDB0u, 0x40CE4BCDu, 0x40CEC299u, 0x40CEEBF1u, 0x40CFFE39u,
    0x40D5A8BAu, 0x40D64671u, 0x40D65643u, 0x40DA57E3u, 0x40DA5F12u,
    0x40E019A8u, 0x40E93912u, 0x40E9A37Bu, 0x40E9DAAAu, 0x40F427FEu,
    0x40F940F5u, 0x4101CC37u, 0x4102575Bu, 0x410404DBu, 0x41040899u,
    0x41045806u, 0x4105C760u, 0x4105FE0Bu, 0x4106DBDBu, 0x4109CD5Bu,
    0x410A1942u, 0x410D3A96u, 0x410E4DD2u, 0x41114A71u, 0x411278FFu,
    0x4113FC28u, 0x4116B380u};

// the plain twin's torch.sqrt, for the w >= 5 that the draw takes
__device__ __forceinline__ float kl_twin_sqrt(float w) {
  const unsigned b = __float_as_uint(w);
  int lo = 0, hi = KL_SQRT_BELOW;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kl_sqrt_below[mid] < b)
      lo = mid + 1;
    else
      hi = mid;
  }
  const float s = __fsqrt_rn(w);
  return lo < KL_SQRT_BELOW && kl_sqrt_below[lo] == b
             ? __uint_as_float(__float_as_uint(s) - 1u)
             : s;
}

// rng.erfinv: XLA's float32 erfinv (Giles)
__device__ __forceinline__ float kl_xla_erfinv(float x) {
  const float small_c[9] = {
      KL_F(2.81022636e-08), KL_F(3.43273939e-07), KL_F(-3.5233877e-06),
      KL_F(-4.39150654e-06), KL_F(0.00021858087), KL_F(-0.00125372503),
      KL_F(-0.00417768164), KL_F(0.246640727), KL_F(1.50140941)};
  const float large_c[9] = {
      KL_F(-0.000200214257), KL_F(0.000100950558), KL_F(0.00134934322),
      KL_F(-0.00367342844), KL_F(0.00573950773), KL_F(-0.0076224613),
      KL_F(0.00943887047), KL_F(1.00167406), KL_F(2.83297682)};
  if (fabsf(x) == 1.0f) return __fmul_rn(x, FLT_MAX);
  float w = -kl_xla_log1p(-__fmul_rn(x, x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(kl_twin_sqrt(w), 3.0f);
  float p = small ? small_c[0] : large_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = kl_fma64(p, w, small ? small_c[i] : large_c[i]);
  return __fmul_rn(p, x);
}

// rng.normal_of_bits
__device__ __forceinline__ float kl_normal_of_bits_f(unsigned bits) {
  const float lo = __uint_as_float(0xBF7FFFFFu);   // nextafter(-1, 0)
  const float span = __fsub_rn(1.0f, lo);
  const float mant = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(__fsub_rn(mant, 1.0f), span),
                                      lo));
  return __fmul_rn(KL_F(1.4142135623730951), kl_xla_erfinv(u));
}

__global__ void kl_draw_planes_kernel(unsigned seed, long long per_it,
                                      long long n, float* __restrict__ out) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= n) return;
  const unsigned it = (unsigned)(g / per_it), i = (unsigned)(g % per_it);
  const uint2 key = kl_threefry2x32(0u, seed, 0u, it);
  const uint2 r = kl_threefry2x32(key.x, key.y, 0u, i);
  out[g] = kl_normal_of_bits_f(r.x ^ r.y);
}

__global__ void kl_normal_of_bits_kernel(const unsigned* __restrict__ bits,
                                         long long n,
                                         float* __restrict__ out) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g < n) out[g] = kl_normal_of_bits_f(bits[g]);
}

KL_EXPORT int kl_draw_planes(long long seed, int iterations, int S, void* out,
                             void* stream) {
  if (seed < 0 || seed > 0xFFFFFFFFll || iterations < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const long long per_it = (long long)S * KL_PLANES;
  const long long n = per_it * iterations;
  if (n == 0) return 0;
  const int threads = 256;
  kl_draw_planes_kernel<<<kl_blocks(n, threads), threads, 0,
                          (cudaStream_t)stream>>>((unsigned)seed, per_it, n,
                                                  (float*)out);
  return (int)cudaGetLastError();
}

KL_EXPORT int kl_normal_of_bits(const void* bits, long long n, void* out,
                                void* stream) {
  if (n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  const int threads = 256;
  kl_normal_of_bits_kernel<<<kl_blocks(n, threads), threads, 0,
                             (cudaStream_t)stream>>>((const unsigned*)bits, n,
                                                     (float*)out);
  return (int)cudaGetLastError();
}
