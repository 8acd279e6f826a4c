// NaN-aware Hyndman-Fan quantiles over a short axis: the ensemble kernel.
//
// Replaces: xclim_tpu/ops/pallas/axisquantile.py, axis_quantile_small and
// axis_quantile_small_nd (Pallas kernels _kernel, a bitonic sort of a
// padded (Mp, 512) lane block launched by pl.pallas_call in _call, and
// _kernel3, Batcher's network on an (M, RB, L) block launched in _call3).
//
// What it computes: x is a contiguous float32 tensor viewed as (pre, M,
// post), M <= 64 samples on the reduce axis (NaN = missing). For each
// column (p, j) and each of nq nodes, the Hyndman-Fan quantile of the
// column's valid samples with the reference's float32 op sequence:
//   h = n*q + coff - 1, clipped to [0, n-1]; k0 = floor(h);
//   gamma = h - k0; k1 = min(k0 + 1, n - 1);
//   out = v0*(1-gamma) + v1*gamma    (v_k = k-th smallest valid sample)
// and NaN where the column has no valid sample. Output (nq, pre*post).
//
// What bounds it on the card: device memory. At the ensembles slice (30
// members x 365 days x 192 x 448 cells) the kernel reads 3.77 GB once and
// writes 0.38 GB: 1.24 ms at 3.35 TB/s. Batcher's network for 32 padded
// samples is 191 compare-exchanges (382 min/max) a column, plus ~70 selects
// a node, ~20 G operations in all: of the same order at the card's
// scalar rate, so the network must overlap the loads.
//
// Design: one thread per column. The TPU's two kernels exist only for lane
// tiling; here one kernel serves any axis position through the (pre, M,
// post) view, so no movedim copy is made. Neighbouring threads take
// neighbouring j, so each of the M loads of a warp reads one 128-byte line
// (when post == 1, the axis is the last one and the loads are strided:
// correct but slow). The M loads are unrolled and independent, all in
// flight at once. NaN becomes +inf before any min/max (fminf/fmaxf drop a
// NaN operand) and the valid samples are counted; the column is padded
// with +inf to Mp = 2..64 and sorted in registers by Batcher's odd-even
// merge network, unrolled at compile time from the template on Mp. The
// first n sorted entries are exactly the sorted valid samples (+inf pads
// sort after them, or equal a valid +inf), and only those ranks are read.
// v0 and v1 are picked by a binary tree of predicated selects on the bits
// of the rank, so no register array is indexed at run time and nothing
// goes to local memory. The node arithmetic uses __fmul_rn / __fadd_rn /
// __fsub_rn in the twin's order, so nvcc cannot contract a step into an
// FMA; qv and coff are rounded to float32 on the host exactly as the twin
// rounds them and read from a small device array (one uniform load per
// node). Offsets are 64-bit: 64 members of this grid pass 2^31 elements.
// The TPU kernel's finite sentinel (3e38), lane padding and one-hot
// weighted sums are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// One merge stage (merge size 2P, partner distance K) of Batcher's odd-even
// mergesort on N values, then the stages K/2 .. 1: the comparators of the
// reference's _batcher_pairs (xclim_tpu/ops/quantile.py:211-227), element a
// against a + K. The loop is unrolled, so each condition is decided at
// compile time and every register index is a constant.
template <int N, int P, int K>
__device__ __forceinline__ void merge_stage(float (&v)[N]) {
  constexpr int J0 = K % P;
#pragma unroll
  for (int a = 0; a < N - K; ++a) {
    if (a >= J0 && (a - J0) % (2 * K) < K && a / (2 * P) == (a + K) / (2 * P))
      compare_exchange(v[a], v[a + K]);
  }
  if constexpr (K > 1) merge_stage<N, P, K / 2>(v);
}

// Sorts v ascending when started at P = 1.
template <int N, int P>
__device__ __forceinline__ void batcher_sort(float (&v)[N]) {
  merge_stage<N, P, P>(v);
  if constexpr (2 * P < N) batcher_sort<N, 2 * P>(v);
}

// v[k] for a run-time k in [0, N), N a power of two: one level of selects
// per bit of k, so every register index is a constant.
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int k) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    float t[N / 2];
    const bool odd = (k & 1) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = odd ? v[2 * i + 1] : v[2 * i];
    return pick<N / 2>(t, k >> 1);
  }
}

template <int MP>
__global__ void __launch_bounds__(kThreads)
axisquantile_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const float* __restrict__ nodes, int M, int nq,
                    long long post, long long cols) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const long long p = col / post;
  const long long j = col - p * post;
  const float* src = x + (size_t)p * M * post + j;

  float v[MP];
  int n = 0;
#pragma unroll
  for (int m = 0; m < MP; ++m) {
    float xv = INFINITY;
    if (m < M) {
      xv = src[(size_t)m * post];
      if (isnan(xv)) {
        xv = INFINITY;
      } else {
        ++n;
      }
    }
    v[m] = xv;
  }

  batcher_sort<MP, 1>(v);

  const float nf = (float)n;  // exact: n <= 64
  const float nm1 = nf - 1.0f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    float res = NAN;
    if (n > 0) {
      float h = __fadd_rn(__fadd_rn(__fmul_rn(nf, nodes[q]), nodes[nq + q]),
                          -1.0f);
      h = fminf(fmaxf(h, 0.0f), nm1);
      const float fl = floorf(h);
      const int k0 = (int)fl;
      const float gam = __fsub_rn(h, fl);
      const int k1 = min(k0 + 1, n - 1);
      const float v0 = pick<MP>(v, k0);
      const float v1 = pick<MP>(v, k1);
      res = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, gam)), __fmul_rn(v1, gam));
    }
    out[(size_t)q * cols + col] = res;
  }
}

template <int MP>
cudaError_t launch(const float* x, float* out, const float* nodes, int M,
                   int nq, long long post, long long cols,
                   cudaStream_t stream) {
  const long long blocks = (cols + kThreads - 1) / kThreads;
  axisquantile_kernel<MP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, nodes, M, nq, post, cols);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for M outside 1..64 or a grid beyond 2^31 - 1
// blocks. x: contiguous (pre, M, post); out: (nq, pre*post); nodes: nq
// qvals then nq coffs, float32, on the device.
extern "C" int xtt_axisquantile(const float* x, float* out,
                                const float* nodes, int M, int nq,
                                long long pre, long long post, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long cols = pre * post;
  if (M < 1 || M > 64 || (cols + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (M <= 2) {
    err = launch<2>(x, out, nodes, M, nq, post, cols, st);
  } else if (M <= 4) {
    err = launch<4>(x, out, nodes, M, nq, post, cols, st);
  } else if (M <= 8) {
    err = launch<8>(x, out, nodes, M, nq, post, cols, st);
  } else if (M <= 16) {
    err = launch<16>(x, out, nodes, M, nq, post, cols, st);
  } else if (M <= 32) {
    err = launch<32>(x, out, nodes, M, nq, post, cols, st);
  } else {
    err = launch<64>(x, out, nodes, M, nq, post, cols, st);
  }
  return (int)err;
}
