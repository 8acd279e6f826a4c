// Spell statistics over contiguous time segments: one pass per grid cell.
//
// Replaces: xclim_tpu/ops/pallas/spells.py, fused_spell_stats (Pallas
// kernel _kernel, launched by pl.pallas_call in _call).
//
// What it computes: x is laid out (B, T, C): B batches (the bootstrap's
// replacement axis, or 1) of a time-first (T, C) series. A day is True
// where `x op thresh` holds for float32 input (op one of > >= < <=; NaN is
// False because every comparison with NaN is false), or where the byte is
// non-zero for a bool/uint8 condition. For each batch b, segment s (days
// [starts[s], starts[s] + counts[s])) and cell c, four float32 outputs:
//   cnt  number of True days
//   wrc  days inside runs of at least `window` True days
//   wre  number of such runs
//   lng  longest run
// Runs reset at each segment start (resample-before-run-length). A run that
// reaches `window` credits `window` days once, then one per further day.
// Counts are integers held in int registers and written once as float32,
// so they are exact.
//
// What bounds it on the card: the bytes of x, read once (1 byte a cell and
// day for a condition, 4 for float32), and, when few cells are in flight,
// the latency of those loads: each thread walks its cell's whole time
// axis, and the carry (run, cnt, wrc, wre, lng) makes each day depend on
// the one before. The arithmetic is a handful of integer ops a day.
//
// Design: one thread per (batch, cell), neighbouring threads on
// neighbouring cells, so a warp reads one time row of 32 cells as one
// contiguous 32- or 128-byte line. The five carries live in registers; the
// segment bounds are int32 device arrays read once per segment (the same
// cached copy segred uses), and the outputs are written once per segment.
// The time loop loads 8 rows before it uses any, so 8 loads are in flight
// per thread. Blocks are 64 threads wide: a 4096-cell call (missing_wmo, a
// plain WSDI) still gives 64 blocks, and the bootstrap's 29 x 4096 cells
// give 1856. Nothing of the TPU kernel's sequential grid, VMEM block or
// scalar-prefetched segment ids is carried over. Splitting the time axis
// across blocks (which needs a carry merge) is left for a later change.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

enum Op : int { kGt = 0, kGe = 1, kLt = 2, kLe = 3, kMask = 4 };

template <int OP>
__device__ __forceinline__ int holds(float v, float thresh) {
  if (OP == kGt) return v > thresh;
  if (OP == kGe) return v >= thresh;
  if (OP == kLt) return v < thresh;
  return v <= thresh;
}

template <int OP>
__device__ __forceinline__ int holds(uint8_t v, float) {
  return v != 0;
}

template <typename In, int OP>
__global__ void __launch_bounds__(kThreads)
spells_kernel(const In* __restrict__ x, float thresh, int window,
              const int* __restrict__ starts, const int* __restrict__ counts,
              float* __restrict__ cnt_out, float* __restrict__ wrc_out,
              float* __restrict__ wre_out, float* __restrict__ lng_out,
              long long BC, int T, int nseg, int C) {
  const long long id = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (id >= BC) return;
  const long long b = id / C;
  const int c = (int)(id - b * C);
  const In* xb = x + b * (long long)T * C + c;
  const size_t ob = (size_t)b * nseg * C + c;

  for (int s = 0; s < nseg; ++s) {
    const int n = counts[s];
    const In* p = xb + (size_t)starts[s] * C;
    int run = 0, cnt = 0, wrc = 0, wre = 0, lng = 0;
    int t = 0;
    for (; t + kUnroll <= n; t += kUnroll) {
      In v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) v[k] = p[(size_t)(t + k) * C];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int on = holds<OP>(v[k], thresh);
        run = on ? run + 1 : 0;
        cnt += on;
        wrc += run == window ? window : (run > window ? 1 : 0);
        wre += run == window;
        lng = max(lng, run);
      }
    }
    for (; t < n; ++t) {
      const int on = holds<OP>(p[(size_t)t * C], thresh);
      run = on ? run + 1 : 0;
      cnt += on;
      wrc += run == window ? window : (run > window ? 1 : 0);
      wre += run == window;
      lng = max(lng, run);
    }
    const size_t o = ob + (size_t)s * C;
    cnt_out[o] = (float)cnt;
    wrc_out[o] = (float)wrc;
    wre_out[o] = (float)wre;
    lng_out[o] = (float)lng;
  }
}

template <typename In, int OP>
void launch(const void* x, float thresh, int window, const int* starts,
            const int* counts, float* cnt, float* wrc, float* wre, float* lng,
            long long BC, int T, int nseg, int C, unsigned blocks,
            cudaStream_t stream) {
  spells_kernel<In, OP><<<blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), thresh, window, starts, counts, cnt, wrc, wre,
      lng, BC, T, nseg, C);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown op, a window below 1 or a grid that
// does not fit. x is (B, T, C) contiguous: float32 when op is 0-3 (> >= <
// <=, compared with thresh), one byte per value when op is 4 (a condition,
// non-zero is True). The four outputs are float32 (B, nseg, C).
extern "C" int xtt_spells(const void* x, int op, float thresh, int window,
                          const int* starts, const int* counts, float* cnt,
                          float* wrc, float* wre, float* lng, long long B,
                          int T, int nseg, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long BC = B * (long long)C;
  const long long blocks = (BC + kThreads - 1) / kThreads;
  if (window < 1 || blocks < 1 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  switch (op) {
    case kGt: launch<float, kGt>(x, thresh, window, starts, counts, cnt, wrc,
                                 wre, lng, BC, T, nseg, C, nb, st); break;
    case kGe: launch<float, kGe>(x, thresh, window, starts, counts, cnt, wrc,
                                 wre, lng, BC, T, nseg, C, nb, st); break;
    case kLt: launch<float, kLt>(x, thresh, window, starts, counts, cnt, wrc,
                                 wre, lng, BC, T, nseg, C, nb, st); break;
    case kLe: launch<float, kLe>(x, thresh, window, starts, counts, cnt, wrc,
                                 wre, lng, BC, T, nseg, C, nb, st); break;
    case kMask: launch<uint8_t, kMask>(x, thresh, window, starts, counts, cnt,
                                       wrc, wre, lng, BC, T, nseg, C, nb, st);
                break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
