// Day-of-year quantiles of a daily series through its percentile table.
//
// Replaces: no Pallas kernel. The reference computes percentile_doy's
// quantiles with a gather and its sort quantile
// (xclim_tpu/core/percentiles.py, percentile_doy; _nan_quantile_xla of
// xclim_tpu/ops/quantile.py); the port's twin is
// xclim_tpu_torch/ops/doyquantile.py, doy_quantile_plain: the (n_doy, N,
// cells) gather of every sample, a NaN where the table has none, and
// torch.sort over the N samples. This kernel
// was added because that sequence held ~86 % of a tx90p call: at 30 years,
// window 5 and 8192 cells the gather, its where and the sort's keys and
// indices are 9 GB of temporaries, and the radix sort orders all 150
// samples of every (doy, cell) to read two of them.
//
// What it computes: for each doy d (a row of the table, N = Y * w sample
// positions: Y years, w days each, -1 where a sample is missing) and cell c,
// with the valid samples x[table[d, k], c] (a position -1 or a NaN value is
// missing) sorted ascending into v[0..n), for each quantile q:
//   h     = n*q + cq - 1        cq = float32(q*(1-alpha-beta) + alpha)
//   h     = min(max(h, 0), max(n - 1, 0)),  lo = floor(h),  gam = h - lo
//   hi    = min(lo + 1, max(n - 1, 0))
//   out[q, d, c] = v[lo]*(1 - gam) + v[hi]*gam,  NaN where n = 0
// every float32 step one rounding (__fmul_rn, __fadd_rn, __fsub_rn, so nvcc
// contracts nothing into an FMA): the twin's op sequence, value for value.
//
// Where the values live: the series x is (T, C) and is read in place
// through the table; a warp's 32 cells are one 128-byte line of a time step.
// Nothing but the (Q, n_doy, C) output is written to device memory; the
// kernel reads its own output of the doy before as the next pivot.
//
// What bounds it on the card: device memory, by the bytes the work needs.
// At tx90p's shape (10950 days, 8192 cells, 365 doys, N = 150) the series
// is 359 MB and the output 12 MB: 0.11 ms at 3.35 TB/s. What costs is the
// selection: the twin sorts all N samples of every (doy, cell) to read two.
//
// Design: a thread a cell (32 neighbouring cells a block), and a block
// takes a run of `span` consecutive doys. The thread keeps its cell's N
// samples in its own column of shared memory (slot i of thread t at i*32 +
// t: bank-conflict free whatever slot each thread reads, so no thread waits
// for another and there is no barrier), unsorted, NaN where missing. At the
// first doy of the run, and at a doy that is not a slide of the one before
// (slide[d] = 0, from the host), the column is loaded anew in table order.
// At a slide (the host checked that row d is row d-1 with each year's first
// sample gone and one new last sample) each year's entering sample
// overwrites its leaving one, which sits in slot y*w + ph (ph: the slides
// since the column was loaded, mod w): Y loads, no sort. Each quantile is
// then one pass over the column around a pivot p, the quantile's value at
// the doy before (its rank moves by a few at a slide): the pass counts the
// values below and equal to p and keeps the 8 largest below and the 8
// smallest above it in registers (min/max networks), which gives the order
// statistics of ranks up to 8 either side of p. Where a rank lies further,
// the pass is made again around the 8th value on that side (1.03 passes a
// doy and quantile on normal samples at tx90p's shape, the first doys of
// the runs included). At the first doy of a run the pivot is
// the value near the rank among the column's first 32 slots, sorted by a
// bitonic network. Every lane runs the same passes: no data-dependent
// loads, merges or divergent inner loops (a first design that kept the
// samples sorted and merged each slide's 60 values in spent ~110e3 cycles
// a warp and doy in per-value loops that diverged across the warp's lanes).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kCells = 32;   // cells a block, a thread each
constexpr int kBatch = 32;   // samples loaded (and sorted) together
constexpr int kSide = 8;     // values a pass keeps on each side of its pivot

// Ascending bitonic network over 32 registers (+inf placeholders last).
__device__ __forceinline__ void sort_batch(float (&v)[kBatch]) {
#pragma unroll
  for (int k = 2; k <= kBatch; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float lo = fminf(v[i], v[l]);
          const float hi = fmaxf(v[i], v[l]);
          const bool up = (i & k) == 0;
          v[i] = up ? lo : hi;
          v[l] = up ? hi : lo;
        }
      }
    }
  }
}

// Loads the values of cell column xc at the cnt table positions pos[0],
// pos[stride], ... into v: every position first, then every value (one
// memory latency each, not one a sample); NaN where the position is -1.
__device__ __forceinline__ void load_values(float (&v)[kBatch],
                                            const float* __restrict__ xc,
                                            const int* __restrict__ pos,
                                            int stride, int cnt, long long C) {
  int r[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) r[j] = j < cnt ? __ldg(pos + j * stride) : -1;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const float s = __ldg(xc + (size_t)max(r[j], 0) * C);
    v[j] = r[j] >= 0 ? s : NAN;
  }
}

// v[j] of eight registers, j dynamic (a select chain, no local memory).
__device__ __forceinline__ float pick(const float (&v)[kSide], int j) {
  float out = v[0];
#pragma unroll
  for (int k = 1; k < kSide; ++k) out = j == k ? v[k] : out;
  return out;
}

// One pass over the cell's column of N slots (NaN: missing) around the
// pivot p: lt and eq count the values below and equal to p, A holds the
// kSide smallest values above p (ascending, +inf after them) and B the
// kSide largest below it (descending, -inf after them). Eight slots are
// loaded at a time; every lane runs the same steps.
__device__ __forceinline__ void pass(const float* col, int N, float p, int& lt,
                                     int& eq, float (&A)[kSide],
                                     float (&B)[kSide]) {
  lt = 0;
  eq = 0;
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    A[k] = INFINITY;
    B[k] = -INFINITY;
  }
  for (int i0 = 0; i0 < N; i0 += 8) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = i0 + e < N ? col[(i0 + e) * kCells] : NAN;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = x[e];
      lt += v < p;
      eq += v == p;
      float t = v > p ? v : INFINITY;   // kept if among the kSide above
      float b = v < p ? v : -INFINITY;  // ... or among the kSide below
#pragma unroll
      for (int k = 0; k < kSide; ++k) {
        const float a = fminf(A[k], t);
        t = fmaxf(A[k], t);
        A[k] = a;
        const float c = fmaxf(B[k], b);
        b = fminf(B[k], b);
        B[k] = c;
      }
    }
  }
}

// The value of rank r (0-based, ascending, among the valid values) from a
// pass around p, and whether the pass reaches it.
__device__ __forceinline__ float rank_value(int r, float p, int lt, int eq,
                                            const float (&A)[kSide],
                                            const float (&B)[kSide],
                                            bool& ok) {
  if (r < lt) {
    ok = lt - 1 - r < kSide;
    return pick(B, lt - 1 - r);
  }
  if (r < lt + eq) {
    ok = true;
    return p;
  }
  ok = r - lt - eq < kSide;
  return pick(A, r - lt - eq);
}

struct Args {
  const float* x;               // (T, C) series
  const int* tab;               // (n_doy, N) time indices, -1: missing
  const unsigned char* slide;   // (n_doy,) 1: row d is row d-1 slid by a day
  const float* consts;          // (2, Q): float32 q, then cq
  float* out;                   // (Q, n_doy, C)
  long long C;
  int n_doy, N, w, Q, span;
};

__global__ void __launch_bounds__(kCells) doyquantile_kernel(const Args a) {
  extern __shared__ float smem[];
  const long long c = (long long)blockIdx.x * kCells + threadIdx.x;
  if (c >= a.C) return;  // no barrier below: a thread owns its column
  float* col = smem + threadIdx.x;  // the cell's samples, slot i at i*32
  const float* xc = a.x + c;
  const int d0 = blockIdx.y * a.span;
  const int d1 = min(a.n_doy, d0 + a.span);
  const int Y = a.N / a.w;
  int n = 0, ph = 0;
  float v[kBatch];
  for (int d = d0; d < d1; ++d) {
    const int* row = a.tab + (size_t)d * a.N;
    if (d == d0 || !a.slide[d]) {
      // the row's samples in table order: year y's day o in slot y*w + o
      n = 0;
      ph = 0;
      for (int k0 = 0; k0 < a.N; k0 += kBatch) {
        load_values(v, xc, row + k0, 1, min(kBatch, a.N - k0), a.C);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (k0 + j < a.N) {
            col[(k0 + j) * kCells] = v[j];
            n += !isnan(v[j]);
          }
        }
      }
    } else {
      // each year's first sample of row d-1 leaves the slot that its last
      // sample of row d takes: slot y*w + ph, ph the slides since the
      // column was built, mod w
      for (int y0 = 0; y0 < Y; y0 += kBatch) {
        const int cnt = min(kBatch, Y - y0);
        load_values(v, xc, row + y0 * a.w + a.w - 1, a.w, cnt, a.C);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j < cnt) {
            float* slot = col + ((y0 + j) * a.w + ph) * kCells;
            n += (int)!isnan(v[j]) - (int)!isnan(*slot);
            *slot = v[j];
          }
        }
      }
      ph = ph + 1 == a.w ? 0 : ph + 1;
    }
    const float nf = (float)n;
    const float upper = fmaxf(__fsub_rn(nf, 1.0f), 0.0f);
    for (int k = 0; k < a.Q; ++k) {
      float h = __fsub_rn(__fadd_rn(__fmul_rn(nf, __ldg(a.consts + k)),
                                    __ldg(a.consts + a.Q + k)),
                          1.0f);
      h = fminf(fmaxf(h, 0.0f), upper);
      const float lo = floorf(h);
      const float gam = __fsub_rn(h, lo);
      const float hi = fminf(__fadd_rn(lo, 1.0f), upper);
      float* o = a.out + ((size_t)k * a.n_doy + d) * a.C + c;
      if (n == 0) {
        *o = NAN;
        continue;
      }
      // the pivot: this quantile's value at the doy before, where this
      // thread wrote one; else a value of the first 32 slots near the rank
      float p = d > d0 ? o[-a.C] : NAN;
      if (isnan(p)) {
        int m = 0;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float s = j < a.N ? col[j * kCells] : NAN;
          m += !isnan(s);
          v[j] = isnan(s) ? INFINITY : s;
        }
        sort_batch(v);
        const int rs = m > 0 ? (int)((long long)lo * (m - 1) / max(n - 1, 1))
                             : 0;
        p = v[0];
#pragma unroll
        for (int j = 1; j < kBatch; ++j) p = j == rs ? v[j] : p;
        if (m == 0) p = 0.0f;
      }
      float A[kSide], B[kSide], v0, v1;
      for (;;) {
        int lt, eq;
        pass(col, a.N, p, lt, eq, A, B);
        bool ok0, ok1;
        v0 = rank_value((int)lo, p, lt, eq, A, B, ok0);
        v1 = rank_value((int)hi, p, lt, eq, A, B, ok1);
        if (ok0 && ok1) break;
        // move the pivot to the far end of the side that falls short
        const int r = ok0 ? (int)hi : (int)lo;
        p = r < lt ? B[kSide - 1] : A[kSide - 1];
      }
      *o = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, gam)), __fmul_rn(v1, gam));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (or of the
// shared-memory opt-in), or cudaErrorInvalidValue for a window that does
// not divide N. x: (T, C) float32; tab: (n_doy, N) int32 indices into T (-1:
// missing); slide: (n_doy,) bytes, 1 where row d is row d-1 moved on by one
// day in each of its N / w years (never at d = 0); consts: float32 q then
// float32 q*(1-alpha-beta)+alpha, Q each; out: (Q, n_doy, C) float32. span:
// doys a block walks.
extern "C" int xtt_doyquantile(const float* x, const int* tab,
                               const unsigned char* slide,
                               const float* consts, float* out, long long C,
                               int n_doy, int N, int w, int Q, int span,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (w < 1 || N % w != 0 || span < 1) return (int)cudaErrorInvalidValue;
  const Args a{x, tab, slide, consts, out, C, n_doy, N, w, Q, span};
  const dim3 grid((unsigned)((C + kCells - 1) / kCells),
                  (unsigned)((n_doy + span - 1) / span));
  const size_t smem = (size_t)N * kCells * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        doyquantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  doyquantile_kernel<<<grid, kCells, smem, st>>>(a);
  return (int)cudaGetLastError();
}
