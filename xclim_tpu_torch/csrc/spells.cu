// Spell statistics over contiguous time segments.
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
// day for a condition, 4 for float32), provided enough loads are in flight
// and each warp reads whole lines; next, the ~7 integer operations a cell
// and day of the carry.
//
// Design: one thread per (batch, segment, group of V neighbouring cells).
// Segments are independent (runs reset at each start), so the segment axis
// multiplies the parallelism with no carry merge: the bootstrap's 29 x 30
// YS periods x 4096 cells give 890,880 threads at V = 4. A condition is
// read V = 4 bytes a thread (one 32-bit load: a warp reads 128 contiguous
// bytes a day) where C is a multiple of 4, x is 4-byte aligned and the
// grid keeps kMinThreads threads; float32 input, a ragged C and small
// grids read one cell a thread (128 bytes a warp for float32). Every row is
// then aligned and no group is ragged. The per-cell carries (run, cnt,
// wrc, wre, lng) live in registers; the time loop issues U = 8 rows of
// loads before it uses any. The outputs are written once per segment, 4
// cells a float4 store when V = 4. Few long segments (a single one over
// the whole series: 1024 threads at 1024 cells) leave most SMs idle, so
// the caller may cut each segment into equal parts in time
// (xtt_spells_parts' nparts): spells_part_kernel writes each part's leading
// and trailing runs and its own counts, and spells_join_kernel joins the
// parts left to right, a run open at a part's end continuing into the
// next.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// 64 a block: a plain 4096-cell call (one thread per cell) still spreads
// over 64 SMs
constexpr int kThreads = 64;
// below this many threads a 4-cell group leaves SMs idle: 132 SMs x 16
// warps
constexpr long long kMinThreads = 132LL * 16 * 32;

enum Op : int { kGt = 0, kGe = 1, kLt = 2, kLe = 3, kMask = 4 };

template <int OP>
__device__ __forceinline__ int holds(float v, float thresh) {
  if (OP == kGt) return v > thresh;
  if (OP == kGe) return v >= thresh;
  if (OP == kLt) return v < thresh;
  return v <= thresh;
}

// V values of one row: a float, or V condition bytes (V = 1 or 4).
template <typename In, int V>
struct Row {
  In v[V];
};

template <int V>
__device__ __forceinline__ Row<uint8_t, V> load_row(const uint8_t* p) {
  Row<uint8_t, V> r;
  if constexpr (V == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int k = 0; k < 4; ++k) r.v[k] = (uint8_t)(w >> (8 * k));
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ Row<float, V> load_row(const float* p) {
  static_assert(V == 1, "float32 input is read one cell a thread");
  Row<float, V> r;
  r.v[0] = __ldg(p);
  return r;
}

template <int OP>
__device__ __forceinline__ int on_day(float v, float thresh) {
  return holds<OP>(v, thresh);
}

template <int OP>
__device__ __forceinline__ int on_day(uint8_t v, float) {
  return v != 0;
}

template <int V>
struct Carry {
  int run[V], cnt[V], wrc[V], wre[V], lng[V];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < V; ++k) run[k] = cnt[k] = wrc[k] = wre[k] = lng[k] = 0;
  }

  template <int OP, typename In>
  __device__ __forceinline__ void day(const Row<In, V>& r, float thresh,
                                      int window) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int on = on_day<OP>(r.v[k], thresh);
      run[k] = on ? run[k] + 1 : 0;
      cnt[k] += on;
      wrc[k] += run[k] == window ? window : (run[k] > window ? 1 : 0);
      wre[k] += run[k] == window;
      lng[k] = max(lng[k], run[k]);
    }
  }
};

template <int V>
__device__ __forceinline__ void store(float* __restrict__ out,
                                      const int (&val)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(
        (float)val[0], (float)val[1], (float)val[2], (float)val[3]);
  } else {
    out[0] = (float)val[0];
  }
}

template <typename In, int OP, int V>
__global__ void __launch_bounds__(kThreads)
spells_kernel(const In* __restrict__ x, float thresh, int window,
              const int* __restrict__ starts, const int* __restrict__ counts,
              float* __restrict__ cnt_out, float* __restrict__ wrc_out,
              float* __restrict__ wre_out, float* __restrict__ lng_out,
              long long nthreads, int T, int nseg, int C) {
  constexpr int U = 8;
  const long long id = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (id >= nthreads) return;
  const int ngroups = C / V;
  const long long bs = id / ngroups;  // batch * nseg + segment
  const int c = (int)(id - bs * ngroups) * V;
  const int s = (int)(bs % nseg);
  const long long b = bs / nseg;
  const int n = counts[s];
  const In* p = x + ((size_t)b * T + starts[s]) * C + c;

  Carry<V> k;
  k.zero();
  int t = 0;
  for (; t + U <= n; t += U) {
    Row<In, V> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = load_row<V>(p + (size_t)(t + u) * C);
#pragma unroll
    for (int u = 0; u < U; ++u) k.template day<OP>(r[u], thresh, window);
  }
  for (; t < n; ++t)
    k.template day<OP>(load_row<V>(p + (size_t)t * C), thresh, window);

  const size_t o = (size_t)bs * C + c;
  store<V>(cnt_out + o, k.cnt);
  store<V>(wrc_out + o, k.wrc);
  store<V>(wre_out + o, k.wre);
  store<V>(lng_out + o, k.lng);
}

// A run of L days adds L spell days and one spell when L >= window.
__device__ __forceinline__ int spell_days(int L, int window) {
  return L >= window ? L : 0;
}

// Time split of few, long segments: thread (b, s, part, c) walks part
// `part` of nparts equal parts of segment s and writes six int32 partials
// to scratch (field-major, (6, B * nseg * nparts, C)): the leading run
// (the part's length when every day is True), the trailing run, and the
// part's own cnt, wrc, wre and lng as if it stood alone.
template <typename In, int OP>
__global__ void __launch_bounds__(kThreads)
spells_part_kernel(const In* __restrict__ x, float thresh, int window,
                   const int* __restrict__ starts,
                   const int* __restrict__ counts, int* __restrict__ scratch,
                   long long nthreads, int T, int nseg, int nparts, int C) {
  constexpr int U = 8;
  const long long id = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (id >= nthreads) return;
  const long long bsp = id / C;  // (batch * nseg + segment) * nparts + part
  const int c = (int)(id - bsp * C);
  const int part = (int)(bsp % nparts);
  const long long bs = bsp / nparts;
  const int s = (int)(bs % nseg);
  const long long b = bs / nseg;
  const int n = counts[s];
  const int a = (int)((long long)part * n / nparts);
  const int e = (int)((long long)(part + 1) * n / nparts);
  const In* p = x + ((size_t)b * T + starts[s] + a) * C + c;

  Carry<1> k;
  k.zero();
  int lead = -1;  // set at the first False day
  int t = 0;
  for (; t + U <= e - a; t += U) {
    Row<In, 1> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = load_row<1>(p + (size_t)(t + u) * C);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (lead < 0 && !on_day<OP>(r[u].v[0], thresh)) lead = k.run[0];
      k.template day<OP>(r[u], thresh, window);
    }
  }
  for (; t < e - a; ++t) {
    const Row<In, 1> r = load_row<1>(p + (size_t)t * C);
    if (lead < 0 && !on_day<OP>(r.v[0], thresh)) lead = k.run[0];
    k.template day<OP>(r, thresh, window);
  }
  const size_t plane = (size_t)nthreads;
  int* o = scratch + (size_t)bsp * C + c;
  o[0] = lead < 0 ? e - a : lead;
  o[plane] = k.run[0];
  o[2 * plane] = k.cnt[0];
  o[3 * plane] = k.wrc[0];
  o[4 * plane] = k.wre[0];
  o[5 * plane] = k.lng[0];
}

// Joins the parts of each (b, s, c) left to right: a run open at a part's
// end continues into the next part's leading run; a part's own counts
// lose its leading and trailing runs, which count once joined.
__global__ void __launch_bounds__(kThreads)
spells_join_kernel(const int* __restrict__ scratch, int window,
                   const int* __restrict__ counts, float* __restrict__ cnt_out,
                   float* __restrict__ wrc_out, float* __restrict__ wre_out,
                   float* __restrict__ lng_out, long long nthreads, int nseg,
                   int nparts, int C) {
  const long long id = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (id >= nthreads) return;
  const long long bs = id / C;
  const int c = (int)(id - bs * C);
  const int n = counts[bs % nseg];
  const size_t plane = (size_t)nthreads * nparts;
  int open = 0, cnt = 0, wrc = 0, wre = 0, lng = 0;
  for (int part = 0; part < nparts; ++part) {
    const int* o = scratch + ((size_t)bs * nparts + part) * C + c;
    const int len = (int)((long long)(part + 1) * n / nparts) -
                    (int)((long long)part * n / nparts);
    const int lead = o[0], trail = o[plane];
    cnt += o[2 * plane];
    lng = max(lng, o[5 * plane]);
    if (lead == len) {  // every day True: the open run goes on
      open += len;
      continue;
    }
    const int joined = open + lead;
    wrc += spell_days(joined, window) + o[3 * plane] -
           spell_days(lead, window) - spell_days(trail, window);
    wre += (joined >= window) + o[4 * plane] - (lead >= window) -
           (trail >= window);
    lng = max(lng, joined);
    open = trail;
  }
  wrc += spell_days(open, window);
  wre += open >= window;
  lng = max(lng, open);
  const size_t out = (size_t)bs * C + c;
  cnt_out[out] = (float)cnt;
  wrc_out[out] = (float)wrc;
  wre_out[out] = (float)wre;
  lng_out[out] = (float)lng;
}

template <typename In, int OP>
int launch_split(const void* x, float thresh, int window, const int* starts,
                 const int* counts, float* cnt, float* wrc, float* wre,
                 float* lng, long long B, int T, int nseg, int C, int nparts,
                 int* scratch, cudaStream_t stream) {
  const long long rows = B * nseg * (long long)C;
  const long long parts = rows * nparts;
  const long long blocks = (parts + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > INT_MAX || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  spells_part_kernel<In, OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), thresh, window, starts, counts, scratch,
      parts, T, nseg, nparts, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  spells_join_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(scratch, window, counts, cnt, wrc, wre,
                                    lng, rows, nseg, nparts, C);
  return (int)cudaGetLastError();
}

template <typename In, int OP, int V>
int launch(const void* x, float thresh, int window, const int* starts,
           const int* counts, float* cnt, float* wrc, float* wre, float* lng,
           long long B, int T, int nseg, int C, cudaStream_t stream) {
  const long long nthreads = B * nseg * (long long)(C / V);
  const long long blocks = (nthreads + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  spells_kernel<In, OP, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), thresh, window, starts, counts, cnt, wrc, wre,
      lng, nthreads, T, nseg, C);
  return (int)cudaGetLastError();
}

// 4 cells a thread for a condition whose C and alignment allow it and
// whose grid keeps kMinThreads threads; else 1.
int pick_width(const void* x, int op, long long B, int nseg, int C) {
  if (op != kMask || C % 4 != 0 || (uintptr_t)x % 4 != 0) return 1;
  return B * nseg * (long long)(C / 4) >= kMinThreads ? 4 : 1;
}

}  // namespace

// Launches on `stream` with each segment cut into `nparts` parts in time
// (1: none; above 1 needs `scratch`, 6 * B * nseg * nparts * C int32, reads
// one cell a thread and launches a second kernel that joins the parts);
// returns the first cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for an unknown op, a window below 1, nparts below
// 1 or a grid that does not fit. The cells a thread reads follow from x,
// op and the shape (pick_width).
extern "C" int xtt_spells_parts(const void* x, int op, float thresh,
                                int window, const int* starts,
                                const int* counts, float* cnt, float* wrc,
                                float* wre, float* lng, long long B, int T,
                                int nseg, int C, int nparts, int* scratch,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (window < 1 || nparts < 1) return (int)cudaErrorInvalidValue;
  if (nparts > 1) {
    switch (op) {
#define XTT_SPLIT(In, OP)                                                  \
  launch_split<In, OP>(x, thresh, window, starts, counts, cnt, wrc, wre, \
                       lng, B, T, nseg, C, nparts, scratch, st)
      case kGt: return XTT_SPLIT(float, kGt);
      case kGe: return XTT_SPLIT(float, kGe);
      case kLt: return XTT_SPLIT(float, kLt);
      case kLe: return XTT_SPLIT(float, kLe);
      case kMask: return XTT_SPLIT(uint8_t, kMask);
      default: return (int)cudaErrorInvalidValue;
#undef XTT_SPLIT
    }
  }
#define XTT_LAUNCH(In, OP, V)                                          \
  launch<In, OP, V>(x, thresh, window, starts, counts, cnt, wrc, wre, \
                    lng, B, T, nseg, C, st)
  switch (op) {
    case kGt: return XTT_LAUNCH(float, kGt, 1);
    case kGe: return XTT_LAUNCH(float, kGe, 1);
    case kLt: return XTT_LAUNCH(float, kLt, 1);
    case kLe: return XTT_LAUNCH(float, kLe, 1);
    case kMask:
      if (pick_width(x, op, B, nseg, C) == 4)
        return XTT_LAUNCH(uint8_t, kMask, 4);
      return XTT_LAUNCH(uint8_t, kMask, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef XTT_LAUNCH
}

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown op, a window below 1 or a grid that
// does not fit. x is (B, T, C) contiguous: float32 when op is 0-3 (> >= <
// <=, compared with thresh), one byte per value when op is 4 (a condition,
// non-zero is True). The four outputs are float32 (B, nseg, C).
extern "C" int xtt_spells(const void* x, int op, float thresh, int window,
                          const int* starts, const int* counts, float* cnt,
                          float* wrc, float* wre, float* lng, long long B,
                          int T, int nseg, int C, void* stream) {
  return xtt_spells_parts(x, op, thresh, window, starts, counts, cnt, wrc,
                          wre, lng, B, T, nseg, C, 1, nullptr, stream);
}
