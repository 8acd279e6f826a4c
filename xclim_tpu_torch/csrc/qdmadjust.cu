// QDM adjustment: per-doy empirical rank + adjustment-factor interpolation.
//
// Replaces: xclim_tpu/ops/pallas/qdmadjust.py, qdm_adjust_doy (Pallas
// kernel _kernel launched by pl.pallas_call in _call, with the host-side
// rank_weight_matrix fast path).
//
// What it computes: for each doy group g, cell c and year slot y of
// xd (n_doy, Y, C) float32 (NaN = missing, Y <= 64):
//   cnt  = #(x_j <= x_y, j valid)            upper-tie rank
//   tau  = cnt / max(n_valid, 1)
//   tc   = clip(tau, q[0], q[nq-1])
//   hi   = clip(#(q <= tc), 1, nq-1), lo = hi - 1
//   w    = clip((tc - q[lo]) / (q[hi]-q[lo] or 1), 0, 1)
//   af_v = af[lo] + w * (af[hi] - af[lo])    af (n_doy, nq, C)
//   out  = x + af_v  or  x * af_v            NaN in -> NaN out
// This is the reference's grouped_rank + interp_hat_nodes sequence
// (xclim_tpu/sdba/utils.py) for every lane; the TPU kernel's (Y, nq)
// hat-weight product for fully valid lanes is not carried over.
//
// What bounds it on the card: device memory. It reads xd and af once and
// writes out once (~1.75 GB at 365 doys x 30 years x 16384 cells); the
// O(Y^2) rank count and the O(nq) bracket count run from shared memory.
//
// Design: one block takes one doy and 32 neighbouring cells (a warp spans
// the 32 cells, so every global access is one 128-byte line per warp
// row). The block stages the (Y, 32) tile of xd and the nq nodes in shared
// memory; each thread then ranks its slots by a compare-count down its
// cell's column (bank = lane, conflict free). The adjustment factors at
// lo/hi are read straight from global memory (L1-cached, nq*32 floats per
// block).
//
// Rounding: every step is one IEEE float32 op written with __fdiv_rn /
// __fmul_rn / __fadd_rn, so nvcc cannot contract any step into an FMA and
// the result is the reference's op sequence.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kCells = 32;
constexpr int kRows = 8;
constexpr int kMaxY = 64;

__global__ void __launch_bounds__(kCells * kRows)
qdmadjust_kernel(const float* __restrict__ x, const float* __restrict__ af,
                 const float* __restrict__ q, float* __restrict__ out,
                 int Y, int C, int nq, int mult) {
  __shared__ float xs[kMaxY][kCells];
  extern __shared__ float qs[];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int g = blockIdx.y;
  const int c = blockIdx.x * kCells + tx;
  const bool live = c < C;

  for (int k = ty * kCells + tx; k < nq; k += kCells * kRows) qs[k] = q[k];
  for (int y = ty; y < Y; y += kRows)
    xs[y][tx] = live ? x[((size_t)g * Y + y) * C + c] : NAN;
  __syncthreads();
  if (!live) return;

  int nv = 0;
  for (int j = 0; j < Y; ++j) nv += !isnan(xs[j][tx]);
  const float nvf = (float)max(nv, 1);
  const float q0 = qs[0];
  const float ql = qs[nq - 1];
  const float* afg = af + (size_t)g * nq * C + c;

  for (int y = ty; y < Y; y += kRows) {
    const float xi = xs[y][tx];
    float res = NAN;
    if (!isnan(xi)) {
      int cnt = 0;
      for (int j = 0; j < Y; ++j) cnt += xs[j][tx] <= xi;  // NaN: false
      const float tau = __fdiv_rn((float)cnt, nvf);
      const float tc = fminf(fmaxf(tau, q0), ql);
      int bq = 0;
      for (int k = 0; k < nq; ++k) bq += qs[k] <= tc;
      const int hi = min(max(bq, 1), nq - 1);
      const int lo = hi - 1;
      const float x0 = qs[lo];
      const float denom = __fsub_rn(qs[hi], x0);
      float w = __fdiv_rn(__fsub_rn(tc, x0), denom == 0.0f ? 1.0f : denom);
      w = fminf(fmaxf(w, 0.0f), 1.0f);
      const float y0 = afg[(size_t)lo * C];
      const float y1 = afg[(size_t)hi * C];
      const float afv = __fadd_rn(y0, __fmul_rn(w, __fsub_rn(y1, y0)));
      res = mult ? __fmul_rn(xi, afv) : __fadd_rn(xi, afv);
    }
    out[((size_t)g * Y + y) * C + c] = res;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
// mult: 0 for kind "+", 1 for kind "*".
extern "C" int xtt_qdmadjust(const float* x, const float* af, const float* q,
                             float* out, int n_doy, int Y, int C, int nq,
                             int mult, void* stream) {
  const dim3 grid((C + kCells - 1) / kCells, n_doy);
  const dim3 block(kCells, kRows);
  const size_t smem = (size_t)nq * sizeof(float);
  qdmadjust_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, af, q, out, Y, C, nq, mult);
  return (int)cudaGetLastError();
}
