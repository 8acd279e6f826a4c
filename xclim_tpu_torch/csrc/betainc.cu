// Regularized incomplete beta function I_x(a, b) in float32, an element a
// thread, each element's continued fraction in registers.
//
// Replaces: no Pallas kernel. The reference evaluates the t and F
// distributions of its significance tests with jax.scipy.special.betainc
// (XLA's while loop), called from xclim_tpu/ensembles/_robustness.py; the
// port's twin is the eager torch loop of xclim_tpu_torch/ops/betainc.py,
// betainc_plain, which steps the whole call's fraction together (~31
// launches over every element and a host check a step) until every element
// has converged, and some never do (a delta of 1 - 2^-24 misses the
// tolerance), so it runs all 199 terms. This kernel was added because that
// loop held most of the ensemble t-test's device time and idle time (~6,200
// launches and 200 host syncs a call at 30 x 86016 p-values).
//
// What it computes, for each element i, with a = a[i * a_step] (b and x
// likewise; a step of 0 reads one value for every element), the twin's
// float32 steps in the twin's order:
//   special cases: NaN if any argument is NaN or negative, x > 1, or a and b
//     both "zero" (a == 0 or b == inf: a zero; b == 0 or a == inf: b zero);
//     else 1 if (a zero and x != 0) or (b zero and x == 1); else 0 if
//     (b zero and x != 1) or (a zero and x == 0). These take no terms.
//   the swap: unless x < (a + 1) / (a + b + 2), a <-> b and x -> 1 - x
//   Lentz's fraction from h = c = eps/2, d = 0; term it = 1, 2, ... with the
//     partial numerator of DLMF 8.17.23 (1; -(a+b) x / (a+1); then
//     -(a+m)(a+b+m) x / ((a+2m)(a+2m+1)) and m(b-m) x / ((a+2m-1)(a+2m))):
//     c = 1 + num / c, d = 1 + num * d, each clamped to eps/2 where its
//     magnitude is below it, d = 1 / d, delta = c d, h = h delta; the
//     element leaves after the first term where |delta - 1| < eps/2, or
//     after iterations - 1 terms
//   the prefactor exp(a log x + b log1p(-x) - lbeta(a, b)) / a through
//     lgammaf, or exp(b log1p(-x) - lgamma(b) + lgamma(a + b)) for a below
//     2 FLT_MIN; the result h * prefactor, or 1 minus it where swapped.
// The twin goes on stepping an element that has converged until the whole
// call has; each such step multiplies h by a delta of 1, or 1 - 2^-24, and
// rounds, so the twin's h drifts from the kernel's by up to 2^-23 of itself
// a step (~1.2e-5 over ~190 steps), and the kernel's lies nearer the
// float64 value.
//
// What bounds it on the card: the fraction's divisions, at most 199 terms an
// element, each term two correctly rounded divisions and a reciprocal. The
// bytes are 31 MB in and out at 30 x 86016 elements (~9 us at 3.35 TB/s).
// Design: nothing goes to memory inside the loop, a thread keeps h, c and d
// in registers, and each element exits at its own convergence (at the
// t-test's df 181, a median of 10 terms and at most ~45), so the launch
// costs what its slowest warps' terms cost. One launch a call, no host sync.
//
// Counting build (-DXTT_COUNT, build target betainc_count; the entry
// xtt_betainc_count, launched while the program traces): the same kernel
// with a last argument counts. One block in kSampleEvery (the sampled
// blocks: element i's block is i / kThreads) writes, once, its elements'
// continued-fraction terms (the term at which an element left the loop,
// iterations - 1 where it never converged, 0 where a special case settled
// it) and its elements to its own pair, counts[2 * (block / kSampleEvery)
// + {0, 1}]: summed over each warp by __reduce_add_sync, then over the
// block in shared memory; the caller sums the pairs. Counting the terms
// keeps the loop from being unrolled by two (~12 % of the launch), so only
// the sampled blocks run betainc_one<true>; with a pair a block, the
// buffer needs no zeroing (a fill kernel, ~2 % of the launch) and no
// atomic. No output bit changes; the shipped build
// compiles none of it. xtt_betainc_count_load loads the kernel (CUDA
// loads one on its first use), so that the first traced call does not
// wait for that.
//
// Rounding: every float32 step of the fraction and the prefactor is one IEEE
// operation written with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn /
// __frcp_rn, so nvcc contracts nothing into an FMA; lgammaf, logf, log1pf
// and expf are CUDA's accurate functions (no fast-math intrinsics), the ones
// torch's own CUDA ops call, so on the card the kernel and the twin run the
// same operations.

#include <cuda_runtime.h>
#include <math.h>

#ifdef XTT_COUNT
#define XTT_COUNTS_PARAM , unsigned long long* __restrict__ counts
#else
#define XTT_COUNTS_PARAM
#endif

namespace {

#ifdef XTT_COUNT
constexpr bool kCount = true;
#else
constexpr bool kCount = false;
#endif

constexpr int kThreads = 256;
// the counting build counts one block in kSampleEvery (ops/betainc.py
// SAMPLE_EVERY)
constexpr int kSampleEvery = 32;
constexpr float kHalfEps = 5.9604644775390625e-08f;    // 2^-24
constexpr float kVerySmall = 2.3509887016445750e-38f;  // 2 * FLT_MIN

__device__ __forceinline__ float clamp_small(float v) {
  return fabsf(v) < kHalfEps ? kHalfEps : v;
}

// Partial numerator `it` (>= 2) of the continued fraction, in the twin's
// order of operations.
__device__ __forceinline__ float numerator(int it, float a, float b,
                                           float x) {
  const int m = (it - 1) / 2;
  const float mf = (float)m;
  const float a2m = __fadd_rn(a, (float)(2 * m));
  if (it % 2 == 0) {
    if (m == 0)
      return __fdiv_rn(__fmul_rn(-__fadd_rn(a, b), x), __fadd_rn(a, 1.0f));
    const float p = __fmul_rn(
        __fmul_rn(-__fadd_rn(a, mf), __fadd_rn(__fadd_rn(a, b), mf)), x);
    return __fdiv_rn(p, __fmul_rn(a2m, __fadd_rn(a2m, 1.0f)));
  }
  const float p = __fmul_rn(__fmul_rn(mf, __fsub_rn(b, mf)), x);
  return __fdiv_rn(p, __fmul_rn(__fsub_rn(a2m, 1.0f), a2m));
}

// I_x(a, b); COUNT sets terms to the fraction's terms (0 if a special case
// settles it).
template <bool COUNT>
__device__ float betainc_one(float a, float b, float x, int iterations,
                             unsigned& terms) {
  const bool a_zero = a == 0.0f || b == INFINITY;
  const bool b_zero = b == 0.0f || a == INFINITY;
  if (isnan(a) || isnan(b) || isnan(x) || a < 0.0f || b < 0.0f ||
      x < 0.0f || x > 1.0f || (a_zero && b_zero))
    return NAN;
  if ((a_zero && x != 0.0f) || (b_zero && x == 1.0f)) return 1.0f;
  if ((b_zero && x != 1.0f) || (a_zero && x == 0.0f)) return 0.0f;

  const bool rapid =
      x < __fdiv_rn(__fadd_rn(a, 1.0f), __fadd_rn(__fadd_rn(a, b), 2.0f));
  if (!rapid) {
    const float t = a;
    a = b;
    b = t;
    x = __fsub_rn(1.0f, x);
  }

  float h = kHalfEps, c = kHalfEps, d = 0.0f;
  int it = 1;
  for (; it < iterations; ++it) {
    const float num = it == 1 ? 1.0f : numerator(it, a, b, x);
    c = clamp_small(__fadd_rn(1.0f, __fdiv_rn(num, c)));
    d = __frcp_rn(clamp_small(__fadd_rn(1.0f, __fmul_rn(num, d))));
    const float delta = __fmul_rn(c, d);
    h = __fmul_rn(h, delta);
    if (fabsf(__fsub_rn(delta, 1.0f)) < kHalfEps) break;
  }
  // the term it left at, or the last where it never converged
  if constexpr (COUNT) terms = it < iterations ? it : max(iterations - 1, 0);

  const float lbeta_small = __fsub_rn(lgammaf(b), lgammaf(__fadd_rn(a, b)));
  const float b_log1m = __fmul_rn(log1pf(-x), b);
  float factor;
  if (a < kVerySmall) {
    factor = expf(__fsub_rn(b_log1m, lbeta_small));
  } else {
    const float lbeta = __fadd_rn(lgammaf(a), lbeta_small);
    factor = __fdiv_rn(
        expf(__fsub_rn(__fadd_rn(__fmul_rn(logf(x), a), b_log1m), lbeta)), a);
  }
  const float result = __fmul_rn(h, factor);
  return rapid ? result : __fsub_rn(1.0f, result);
}

__global__ void __launch_bounds__(kThreads)
    betainc_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ x, float* __restrict__ out,
                   long long n, int a_step, int b_step, int x_step,
                   int iterations XTT_COUNTS_PARAM) {
  const long long stride = (long long)gridDim.x * kThreads;
  const bool sampled = kCount && blockIdx.x % kSampleEvery == 0;
  [[maybe_unused]] unsigned terms = 0, elements = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    unsigned t = 0;
    if (sampled) {
      out[i] = betainc_one<true>(a[i * a_step], b[i * b_step], x[i * x_step],
                                 iterations, t);
      terms += t;
      ++elements;
    } else {
      out[i] = betainc_one<false>(a[i * a_step], b[i * b_step],
                                  x[i * x_step], iterations, t);
    }
  }
#ifdef XTT_COUNT
  if (sampled) {
    __shared__ unsigned block[2];
    if (threadIdx.x < 2) block[threadIdx.x] = 0;
    terms = __reduce_add_sync(0xffffffffu, terms);
    elements = __reduce_add_sync(0xffffffffu, elements);
    __syncthreads();  // block[] zeroed
    if (threadIdx.x % 32 == 0 && elements) {
      atomicAdd(&block[0], terms);
      atomicAdd(&block[1], elements);
    }
    __syncthreads();
    if (threadIdx.x < 2)
      counts[2 * (blockIdx.x / kSampleEvery) + threadIdx.x] = block[threadIdx.x];
  }
#endif
}

cudaError_t run(const float* a, const float* b, const float* x, float* out,
                long long n, int a_step, int b_step, int x_step,
                int iterations, unsigned long long* counts,
                cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < (1LL << 30) ? blocks : (1LL << 30));
#ifdef XTT_COUNT
  betainc_kernel<<<grid, kThreads, 0, stream>>>(
      a, b, x, out, n, a_step, b_step, x_step, iterations, counts);
#else
  betainc_kernel<<<grid, kThreads, 0, stream>>>(
      a, b, x, out, n, a_step, b_step, x_step, iterations);
#endif
  return cudaGetLastError();
}

}  // namespace

#ifndef XTT_COUNT
// out[i] = I_x(a, b) for i < n; a step of 0 broadcasts that operand's one
// value, 1 reads it element by element. Returns a CUDA error code.
extern "C" int xtt_betainc(const float* a, const float* b, const float* x,
                           float* out, long long n, int a_step, int b_step,
                           int x_step, int iterations, void* stream) {
  return (int)run(a, b, x, out, n, a_step, b_step, x_step, iterations,
                  nullptr, (cudaStream_t)stream);
}
#else
// xtt_betainc of the counting build: counts holds a pair (the elements'
// terms, the elements) for each sampled block, ceil(grid / kSampleEvery)
// pairs of the grid of min(ceil(n / kThreads), 2^30) blocks.
extern "C" int xtt_betainc_count(const float* a, const float* b,
                                 const float* x, float* out, long long n,
                                 int a_step, int b_step, int x_step,
                                 int iterations, unsigned long long* counts,
                                 void* stream) {
  return (int)run(a, b, x, out, n, a_step, b_step, x_step, iterations,
                  counts, (cudaStream_t)stream);
}

extern "C" int xtt_betainc_count_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, (const void*)betainc_kernel);
}
#endif  // XTT_COUNT
