// Segment reduction over contiguous time segments: resample(freq).op.
//
// Replaces: xclim_tpu/ops/pallas/segred.py, segment_reduce_onepass (Pallas
// kernels _mxu_kernel for the "sum" stat set and _kernel for "minmax" and
// "m2", launched by pl.pallas_call in _call).
//
// What it computes: x is a (T, C) float32 time-first array (NaN = missing)
// cut into nseg contiguous segments [starts[s], starts[s] + counts[s]).
// For each segment s and cell c, over the valid (non-NaN) values:
//   count                 -> int32 number of valid values
//   sum, mean             -> sum; sum / count
//   min, max              -> smallest / largest valid value
//   var, std (ddof = 0)   -> sum((x - mean)^2) / count; its square root
// A segment with no valid value gives NaN (count gives 0). These are the
// reference's NaN rules (segred.py:218-232, skipna=True).
//
// What bounds it on the card: device memory. The input is read once from
// HBM (3.83 GB for 3650 days x 262144 cells) and the (nseg, C) result is
// small; the arithmetic is one add (two for var/std) per element.
//
// Design: one thread owns one cell of one segment, and neighbouring
// threads take neighbouring cells, so a warp reads each time row as one
// 128-byte line. A block covers 256 cells of one segment; the grid is
// (ceil(C / 256), nseg), in launches of at most 65535 segments. The
// thread walks its segment's rows four at a time (four independent loads
// in flight) and keeps the count and its
// statistic in registers. Sums are accumulated in double and rounded to
// float once, so a 365-row sum stays within an ulp of the exact value
// whatever the order. var/std take a second pass over the same rows for
// sum((x - mean)^2), which L2 serves for the short segments. None of the
// TPU kernel's devices are carried over: no bf16 split on a matrix unit,
// no 8-row aligned slices, no unrolled segment loop (bounds are device
// arrays, so any number of segments of any length is served).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

enum Op : int { kCount = 0, kSum = 1, kMean = 2, kMin = 3, kMax = 4,
                kVar = 5, kStd = 6 };

template <int OP>
__global__ void __launch_bounds__(kThreads)
segred_kernel(const float* __restrict__ x, const int* __restrict__ starts,
              const int* __restrict__ counts, void* __restrict__ out, int C,
              int seg0) {
  const int s = seg0 + blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int t0 = starts[s];
  const int n = counts[s];
  const float* p = x + (size_t)t0 * C + c;

  int cnt = 0;
  double sum = 0.0;
  float mn = INFINITY, mx = -INFINITY;
  int t = 0;
  for (; t + 4 <= n; t += 4) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p[(size_t)(t + k) * C];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!isnan(v[k])) {
        ++cnt;
        if (OP == kMin) mn = fminf(mn, v[k]);
        else if (OP == kMax) mx = fmaxf(mx, v[k]);
        else if (OP != kCount) sum += (double)v[k];
      }
    }
  }
  for (; t < n; ++t) {
    const float v = p[(size_t)t * C];
    if (!isnan(v)) {
      ++cnt;
      if (OP == kMin) mn = fminf(mn, v);
      else if (OP == kMax) mx = fmaxf(mx, v);
      else if (OP != kCount) sum += (double)v;
    }
  }

  const size_t o = (size_t)s * C + c;
  if (OP == kCount) {
    static_cast<int*>(out)[o] = cnt;
    return;
  }
  float* res = static_cast<float*>(out);
  if (cnt == 0) {
    res[o] = NAN;
    return;
  }
  if (OP == kSum) {
    res[o] = (float)sum;
  } else if (OP == kMean) {
    res[o] = __fdiv_rn((float)sum, (float)cnt);
  } else if (OP == kMin) {
    res[o] = mn;
  } else if (OP == kMax) {
    res[o] = mx;
  } else {
    const double mu = sum / (double)cnt;
    double m2 = 0.0;
    for (int u = 0; u < n; ++u) {
      const float v = p[(size_t)u * C];
      if (!isnan(v)) {
        const double d = (double)v - mu;
        m2 += d * d;
      }
    }
    const float var = (float)(m2 / (double)cnt);
    res[o] = OP == kVar ? var : sqrtf(var);
  }
}

template <int OP>
void launch(const float* x, const int* starts, const int* counts, void* out,
            int nseg, int C, cudaStream_t stream) {
  // grid.y is capped at 65535: longer segment lists go in several launches
  for (int seg0 = 0; seg0 < nseg; seg0 += kMaxGridY) {
    const int rows = nseg - seg0 < kMaxGridY ? nseg - seg0 : kMaxGridY;
    const dim3 grid((C + kThreads - 1) / kThreads, rows);
    segred_kernel<OP><<<grid, kThreads, 0, stream>>>(x, starts, counts, out, C,
                                                     seg0);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown op. op: 0 count, 1 sum, 2 mean,
// 3 min, 4 max, 5 var, 6 std. out is int32 for count, float32 otherwise,
// laid out (nseg, C).
extern "C" int xtt_segred(const float* x, const int* starts, const int* counts,
                          void* out, int nseg, int C, int op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case kCount: launch<kCount>(x, starts, counts, out, nseg, C, st); break;
    case kSum: launch<kSum>(x, starts, counts, out, nseg, C, st); break;
    case kMean: launch<kMean>(x, starts, counts, out, nseg, C, st); break;
    case kMin: launch<kMin>(x, starts, counts, out, nseg, C, st); break;
    case kMax: launch<kMax>(x, starts, counts, out, nseg, C, st); break;
    case kVar: launch<kVar>(x, starts, counts, out, nseg, C, st); break;
    case kStd: launch<kStd>(x, starts, counts, out, nseg, C, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
