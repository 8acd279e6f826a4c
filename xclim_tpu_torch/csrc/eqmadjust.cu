// EQM adjustment: each value's bracket among its group's quantile nodes,
// the interpolated factor and its application, in one pass over the series.
//
// Replaces: no Pallas kernel. The reference computes EQM's adjust with
// plain jnp ops (xclim_tpu/sdba/utils.py, interp_on_quantiles, called by
// _eqm_adjust_body of xclim_tpu/sdba/adjustment.py); the port's twin is the
// torch sequence of xclim_tpu_torch/ops/eqmadjust.py, eqm_adjust_series_plain
// (the group gather, a compare-and-add pass over the gathered values for
// each node, four node gathers, the interpolation's elementwise passes and
// the scatter back to the time axis). This kernel was added because that
// sequence held ~55 % of a DQM call's device time at 65536 cells.
//
// What it computes: for each group g (a row of the adjust table), cell c and
// slot s with step r = rows[g, s] (-1: no step) and value x = x[r, c], with
// xq = hq[g, :, c] and yq = af[g, :, c] (nq nodes each):
//   cnt   = #(xq[k] <= x)                   NaN nodes and NaN x compare false
//   hi    = clip(cnt, 1, nq - 1), lo = hi - 1
//   denom = xq[hi] - xq[lo]
//   w     = denom != 0 ? (x - xq[lo]) / denom : 0
//   w     = clip(w, 0, 1)                   only with constant extrapolation
//   y     = yq[lo] + w * (yq[hi] - yq[lo])
//   out[r, c] = x + y  or  x * y            NaN where x is NaN
// The count is exact for any nodes, sorted or not, NaN or not: it compares
// every node.
//
// Where the values live: x and out are the (T, C) series; the kernel reads
// x[rows[g, s], c] and writes out[rows[g, s], c], so the group gather and
// the scatter back to the time axis cost no pass of their own. A table that
// holds every step once (sdba's adjust table) writes every output row once.
//
// What bounds it on the card: device memory. It reads x, hq and af once and
// writes out once (15.7 GB at 365 doys x 30 years x 65536 cells and 52
// nodes: 4.7 ms at 3.35 TB/s). The count is nq compares a value (37 G at
// that shape), which stays under the bytes only if each node is loaded once
// for many values.
//
// Design: a thread a cell, 64 neighbouring cells a block, so every global
// access of a warp is one 128-byte line; blockIdx.y is the group and
// blockIdx.z a span of up to kSpan of its slots (month and whole-series
// groups take more than one block along the slots; every span holds at
// least one slot, so every thread reaches the wait for its copies).
//  * The block's (nq, cells) tiles of hq and af are copied into shared
//    memory with cp.async as the block starts (coalesced rows); each thread
//    copies and reads only its own column (bank = lane), so it waits for its
//    own copies and no barrier is needed. Where the tiles do not fit
//    (SHARED false: many nodes), the nodes are read from global memory.
//  * The thread walks its slots kChunk at a time: the chunk's values sit in
//    registers (NaN padded) while the copies land, then every node is loaded
//    once and compared with all of them (independent counts), then each
//    value's bracket and weight are computed and its result stored.
//
// Rounding: every step is one IEEE float32 op written with __fsub_rn /
// __fdiv_rn / __fmul_rn / __fadd_rn, so nvcc cannot contract any step into
// an FMA and the result is the twin's op sequence bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kCells = 64;    // cells a block, a thread each
constexpr int kChunk = 32;    // slots a thread holds in registers at a time
constexpr int kSpan = 1024;   // slots a block walks

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool SHARED>
__global__ void __launch_bounds__(kCells)
eqmadjust_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                 const float* __restrict__ hq, const float* __restrict__ af,
                 float* __restrict__ out, int S, int C, int nq, int mult,
                 int clamp_w) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int g = blockIdx.y;
  const int c = blockIdx.x * kCells + t;
  if (c >= C) return;  // no barrier below: a thread waits for its own copies
  const int s_begin = blockIdx.z * kSpan;
  const int s_end = min(S, s_begin + kSpan);
  const size_t col = (size_t)g * nq * C + c;
  const float* xq = hq + col;  // node k at xq[k * C]
  const float* yq = af + col;
  float* xs = smem + t;        // node k at xs[k * kCells]
  float* ys = smem + (size_t)nq * kCells + t;
  if (SHARED) {
    for (int k = 0; k < nq; ++k) {
      cp_async4(&xs[k * kCells], xq + (size_t)k * C);
      cp_async4(&ys[k * kCells], yq + (size_t)k * C);
    }
    cp_async_commit();
  }
  const int* rg = rows + (size_t)g * S;

  for (int s0 = s_begin; s0 < s_end; s0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = s0 + j < s_end ? __ldg(&rg[s0 + j]) : -1;
      v[j] = r >= 0 ? x[(size_t)r * C + c] : NAN;
    }
    if (SHARED) cp_async_wait_all();  // a no-op once the copies landed

    // the count: each node loaded once for the chunk (NaN compares false)
    int cnt[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cnt[j] = 0;
    for (int k = 0; k < nq; ++k) {
      const float node = SHARED ? xs[k * kCells] : __ldg(xq + (size_t)k * C);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) cnt[j] += node <= v[j];
    }

#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = s0 + j < s_end ? __ldg(&rg[s0 + j]) : -1;
      if (r >= 0) {
        const float xi = v[j];
        float res = NAN;
        if (!isnan(xi)) {
          const int hi = min(max(cnt[j], 1), nq - 1);
          const int lo = hi - 1;
          float x0, x1, y0, y1;
          if (SHARED) {
            x0 = xs[lo * kCells];
            x1 = xs[hi * kCells];
            y0 = ys[lo * kCells];
            y1 = ys[hi * kCells];
          } else {
            x0 = __ldg(xq + (size_t)lo * C);
            x1 = __ldg(xq + (size_t)hi * C);
            y0 = __ldg(yq + (size_t)lo * C);
            y1 = __ldg(yq + (size_t)hi * C);
          }
          const float denom = __fsub_rn(x1, x0);
          // a NaN denom is != 0 and gives a NaN weight, as in the twin
          float w = denom != 0.0f ? __fdiv_rn(__fsub_rn(xi, x0), denom) : 0.0f;
          // torch.clamp keeps NaN: fminf/fmaxf would not
          if (clamp_w) w = w < 0.0f ? 0.0f : (w > 1.0f ? 1.0f : w);
          const float y = __fadd_rn(y0, __fmul_rn(w, __fsub_rn(y1, y0)));
          res = mult ? __fmul_rn(xi, y) : __fadd_rn(xi, y);
        }
        out[(size_t)r * C + c] = res;
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (or of the
// shared-memory opt-in), or cudaErrorInvalidValue for nq < 2. x, out: (T,
// C) float32; rows: (G, S) int32 time indices (-1: none); hq, af: (G, nq,
// C) float32. mult: 0 for kind "+", 1 for kind "*". clamp_w: 1 clamps the
// weight into [0, 1] (constant extrapolation). shared: 1 stages the
// block's (nq, 64) tiles of hq and af in shared memory (the wrapper asks
// for it only when 2 * nq * 64 floats fit in 227 KB), 0 reads the nodes
// from global memory.
extern "C" int xtt_eqmadjust(const float* x, const int* rows, const float* hq,
                             const float* af, float* out, int G, int S, int C,
                             int nq, int mult, int clamp_w, int shared,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nq < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kCells - 1) / kCells, G, (S + kSpan - 1) / kSpan);
  if (shared) {
    const size_t smem = (size_t)2 * nq * kCells * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          eqmadjust_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    eqmadjust_kernel<true><<<grid, kCells, smem, st>>>(
        x, rows, hq, af, out, S, C, nq, mult, clamp_w);
  } else {
    eqmadjust_kernel<false><<<grid, kCells, 0, st>>>(
        x, rows, hq, af, out, S, C, nq, mult, clamp_w);
  }
  return (int)cudaGetLastError();
}
