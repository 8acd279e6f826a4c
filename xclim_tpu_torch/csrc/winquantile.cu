// Windowed day-of-year quantiles: the sdba training kernel.
//
// Replaces: xclim_tpu/ops/pallas/winquantile.py, doy_window_quantiles
// (Pallas kernels _kernel / _kernel_dyadic and _select_nodes, launched by
// pl.pallas_call in _call), and, through xtt_winquantile_stages, the
// profiling variants of tools/prof_winquantile.py (_call, its
// pl.pallas_call at :255: DMA + presort / merge / select).
//
// What it computes: for each day of year g and cell c, the NaN-skipping
// Hyndman-Fan quantiles at nq nodes of every sample in the doy slices
// g-half .. g+half (wrapping around the year). Input (n_doy, Y, C) float32
// with NaN = missing, C contiguous; output (n_doy, nq, C). A window with no
// valid sample gives NaN.
//
// Design: a sliding sorted window, as the TPU kernel merged presorted
// runs. A block takes neighbouring cells and one chunk of the doy axis
// (the host splits n_doy into chunks so that the grid has a few thousand
// blocks); at the chunk's first doy each cell's whole window is sorted,
// then each step g -> g+1 takes slice g-half out and slice g+half+1 in.
// Which instance runs is set by the padded window P2 (window * Y rounded up
// to a power of two, at least 32):
//
// * P2 <= 1024, the warp instance (warp_kernel; sdba's w31 x 30 years):
//   one warp owns one cell's window for its whole doy chunk, 8 cells a
//   block, and meets the other warps only at one block barrier every few
//   doys, where the block writes the node values it staged (8 neighbouring
//   cells of a node as one 32-byte run). The window lives in the warp's
//   shared memory as P2 sorted ranks: its n valid values, then +inf (lane
//   l's run is ranks l*R .. l*R+R-1, R = P2/32, one float of padding every
//   32 so the runs' k-th entries fall in 32 banks). The chunk's first
//   window is sorted by the warp in shared memory; then each slide:
//     - loads the outgoing and incoming slices (a value a lane at Y <= 32,
//       prefetched one slide ahead) and sorts each in the warp (a 32-wide
//       register bitonic network on both at once; a shared-memory one past
//       32 years);
//     - reads each lane's run into registers, then finds where the lane
//       starts in the two sorted slices by binary searches over those
//       <= Y values (never over the window): the incoming values not above
//       the previous lane's last entry, and the outgoing values matched
//       before the run (those below its first entry, and, where equal
//       values straddle lanes, as many equal ones as the runs before hold:
//       a segmented warp scan, run only when such a tie is matched);
//     - walks the run once, writing each entry once: incoming values not
//       above it go first, then the entry itself unless it equals the next
//       outgoing value (removal by value: the outgoing slice is a
//       sub-multiset of the window, and only values are read, so which of
//       equal entries leaves does not matter). The +inf padding takes part
//       as entries, so every incoming value lands before it.
//   No presort pass and no scratch: each slice is sorted as it enters and
//   again as it leaves. Window 1 sorts each doy's slice as its window.
//   What bounds it: issue and latency, not bytes. A slide costs ~1000 warp
//   instructions (the walk ~17 an entry: two compares, the store and its
//   place, the cursor steps), so 23.9 M (cell, doy) slides a launch at
//   sdba's shape, (365, 30, 65536), take ~42 ms on an H100 against ~2.3 ms
//   of device-memory bytes; registers cap it at 4 blocks (32 warps) a SM.
// * 1024 < P2 <= 8192, the shared-memory instance (slide_kernel): the
//   previous design. presort_kernel sorts each doy slice once into a
//   scratch (n_doy, C, Y) array (a warp's register bitonic sort up to
//   1024 padded values, a block's shared-memory sort above); a block takes
//   8192 / P2 cells, sorts their windows in shared memory at the chunk
//   start, and each step merges the presorted slices:
//       * removed value j (sorted run rout) takes old position
//         lower_bound(old, rout[j]) + (j - lower_bound(rout, rout[j])): the
//         k-th duplicate among the removed values takes the k-th equal
//         entry, so the removed positions are distinct;
//       * a kept entry at old position i moves to i - (removed positions
//         before i) + upper_bound(rin, value). Thread t merges the run of
//         E old entries from t * E (E odd, so a warp's 32 lanes start in 32
//         banks): one binary search in each short run at its start, then
//         the two counts only advance;
//       * inserted value j moves to j + lower_bound(old, u) -
//         lower_bound(rout, u) (kept entries below u).
//     The window holds W entries, NaN as +inf: the first n_valid sorted
//     entries are exactly the sorted valid samples (a valid +inf equals
//     the padding), and only those ranks are read. select_nodes reads the
//     two order statistics of each node; with one chunk per doy every
//     window is sorted in full and nothing is presorted.
// * P2 > 8192 (w31 over more than 264 years, w91 over more than 90), the
//   global-scratch instance (slide_kernel, template GLOBAL, one cell a
//   block): the same code on the block's own region of a global scratch
//   array: the two window buffers, the slices and the removed positions
//   (the valid count stays in shared memory; the block barriers order the
//   global accesses as they order shared ones). Its grid is persistent, at
//   most kGlobalBlocks blocks walking over the cells, so the scratch
//   (xtt_winquantile_scratch floats) stays near 140 MB at w31 x 300 years
//   however many cells there are. A presort of more than kMaxP2 years
//   takes the same route. The only limit left is the valid count's: a
//   window holds at most kMaxWindow = 2^24 samples, which float32 counts
//   exactly.
// Inserted entries land before kept equal ones in every instance; any tie
// order gives the same quantiles. The valid count is the running sum of
// the slices' non-NaN entries.
//
// Stages (template STAGE, the profile of tools/prof_winquantile.py; the
// entry point xtt_winquantile_stages, and so stages 0 and 1, are compiled
// only with -DXTT_WINQUANTILE_STAGES, the build target winquantile_stages):
//   0 the per-doy loads of the window's slices and the running valid count
//     (and the presort, in the instances that have one); writes the count
//     per (doy, cell) as float32 (nq = 1);
//   1 + the chunk-start sort and the slides; writes the window's smallest
//     valid value (NaN without one);
//   2 + node selection: the shipped kernel (xtt_winquantile).
//
// Counting build (-DXTT_COUNT, build target winquantile_count; the
// entry xtt_winquantile_count, launched while the program traces): the
// same kernels with a last argument, counts, an array of int64 counters
// (Counter below) they add to; nothing they write to out changes. In the
// warp instance each warp keeps its counts in registers and adds them
// once at its end: every warp its slides (chunk starts are none) and the
// valid values that entered and left its windows; the warps of one block
// in kSampleEvery (the sampled blocks, which run warp_cells<..., true>)
// also their slides again, the clock64 cycles of their stages (the
// chunk-start sort; the slices' loads and sorts; the searches, tie scan
// and walk of merge_slices; node selection with its staging, barrier and
// write-out), the walk's entry steps, the steps at which at least one
// lane inserts before its entry or removes it, and the lanes that do
// (summed over those steps). Sampling keeps the build's time within
// ~1 % of the shipped one's: counting every warp's stages and walk costs
// ~7 % (a bit an entry and an insertion). The shared-memory and
// global-scratch instances count the values entering and leaving only.
// The shipped build compiles none of it: the kernels there take no
// counts.
//
// Rounding: the node arithmetic repeats the reference's float32 op
// sequence (h = n*q + coff - 1, clip, floor, gamma, v0*(1-gamma) +
// v1*gamma) with __fmul_rn / __fadd_rn, so nvcc cannot contract any step
// into an FMA. qv and coff are rounded to float32 on the host exactly as
// the reference rounds them.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>

#ifdef XTT_COUNT
#define XTT_COUNTS_PARAM , unsigned long long* __restrict__ counts
#define XTT_COUNTS_ARG , counts
#else
#define XTT_COUNTS_PARAM
#define XTT_COUNTS_ARG
#endif

namespace {

#ifdef XTT_COUNT
constexpr bool kCount = true;
#else
constexpr bool kCount = false;
#endif
// The counting build's counters, in the order of ops/winquantile.py's
// COUNTERS.
enum Counter {
  kSlides,
  kSampledSlides,
  kCyclesSort,
  kCyclesSlices,
  kCyclesWalk,
  kCyclesNodes,
  kWalkSteps,
  kBranchSteps,
  kBranchLanes,
  kInserted,
  kRemoved,
  kCounters
};

// blocks of the warp instance of which the counting build times the stages
// and counts the walk: one in kSampleEvery (ops/winquantile.py
// SAMPLE_EVERY)
constexpr int kSampleEvery = 32;

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxP2 = 8192;
constexpr int kRegP2 = 1024;
constexpr int kMaxWindow = 1 << 24;
// blocks of the presort pass: 16 a SM on 132 SMs
constexpr int kPresortBlocks = 132 * 16;
// blocks of a global-scratch launch: 8 resident a SM on 132 SMs
constexpr int kGlobalBlocks = 132 * 8;

// Row stride of a shared tile: padded by 32/CT floats so the CT cells of
// one sample index fall into distinct banks while a window is loaded.
__host__ __device__ constexpr int row_stride(int P2, int CT) {
  return P2 + 32 / CT;
}

__host__ __device__ constexpr int cells_per_block(int P2) {
  return P2 <= kRegP2 ? kThreads / kWarp : (P2 <= kMaxP2 ? kMaxP2 / P2 : 1);
}

// Floats of one slide block's windows, slices and removed positions.
__host__ __device__ constexpr size_t slide_floats(int P2, int CT, int Y) {
  return 2 * (size_t)CT * row_stride(P2, CT) + 3 * (size_t)CT * Y;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = kWarp;
  while (p < n) p <<= 1;
  return p;
}

// Copies the windows of doy g for cells c0 .. c0+CT-1 into s (row ct holds
// cell c0+ct; +inf for missing samples and padding) and counts the valid
// samples of each cell into nvalid[ct]. Ends with a block barrier.
__device__ __forceinline__ void load_windows(const float* __restrict__ x,
                                             float* s, int* nvalid, int g,
                                             int c0, int n_doy, int Y, int C,
                                             int window, int P2, int CT) {
  const int tid = threadIdx.x;
  const int stride = row_stride(P2, CT);
  const int half = window / 2;
  const int wy = window * Y;
  if (tid < CT) nvalid[tid] = 0;
  __syncthreads();
  // element e -> (sample r = e / CT, cell ct = e % CT); CT divides
  // kThreads, so a thread always loads for the same cell
  const int my_ct = tid % CT;
  const int c = c0 + my_ct;
  int count = 0;
  for (int e = tid; e < P2 * CT; e += kThreads) {
    const int r = e / CT;
    float v = INFINITY;
    if (r < wy && c < C) {
      const int o = r / Y;
      const int y = r - o * Y;
      int d = (g + o - half) % n_doy;
      if (d < 0) d += n_doy;
      const float xv = x[((size_t)d * Y + y) * C + c];
      if (!isnan(xv)) {
        v = xv;
        ++count;
      }
    }
    s[my_ct * stride + r] = v;
  }
  if (count) atomicAdd(&nvalid[my_ct], count);
  __syncthreads();
}

// One bitonic stage (merge size SIZE, partner distance K) on the warp's
// P2 = 32 * R values, element i = lane * R + r in register r; then the
// stages K/2 .. 1. Template recursion keeps every register index a
// compile-time constant.
template <int R, int SIZE, int K>
__device__ __forceinline__ void bitonic_stage(float (&v)[R], int lane) {
  if constexpr (K >= R) {
    // partner i ^ K is register r of lane ^ (K / R); i & SIZE does not
    // depend on r because r < R <= K < SIZE
    constexpr int J = K / R;
    const bool asc = ((lane * R) & SIZE) == 0;
    const bool keep_min = ((lane & J) == 0) == asc;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float o = __shfl_xor_sync(0xffffffffu, v[r], J);
      v[r] = keep_min ? fminf(v[r], o) : fmaxf(v[r], o);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & K) == 0) {
        const bool asc = ((lane * R + r) & SIZE) == 0;
        const float a = v[r];
        const float b = v[r | K];
        const float lo = fminf(a, b);
        const float hi = fmaxf(a, b);
        v[r] = asc ? lo : hi;
        v[r | K] = asc ? hi : lo;
      }
    }
  }
  if constexpr (K > 1) bitonic_stage<R, SIZE, K / 2>(v, lane);
}

// Bitonic merges of size SIZE .. 32 * R: sorts the warp's values ascending
// in element order when started at SIZE = 2.
template <int R, int SIZE>
__device__ __forceinline__ void bitonic_sort(float (&v)[R], int lane) {
  bitonic_stage<R, SIZE, SIZE / 2>(v, lane);
  if constexpr (SIZE < R * kWarp) bitonic_sort<R, SIZE * 2>(v, lane);
}

// Sorts the CT <= 8 rows of s ascending in place (natural order), warp w
// taking row w in registers: P2 = 32 * R. Ends with a block barrier.
template <int R>
__device__ __forceinline__ void sort_rows_reg(float* s, int stride, int CT) {
  const int warp = threadIdx.x / kWarp;
  if (warp < CT) {
    const int lane = threadIdx.x % kWarp;
    float* row = s + warp * stride;
    // lane l, register r holds logical element i = l * R + r; any
    // assignment works before a sort, and this one loads without conflicts
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = row[r * kWarp + lane];
    bitonic_sort<R, 2>(v, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) row[lane * R + r] = v[r];
  }
  __syncthreads();
}

// Block-wide bitonic sort of the CT rows of P2 values in shared memory.
// Ends with a block barrier.
__device__ __forceinline__ void sort_rows_smem(float* s, int stride, int P2,
                                               int CT) {
  const int half_p2 = P2 / 2;
  for (int size = 2; size <= P2; size <<= 1) {
    for (int k = size >> 1; k > 0; k >>= 1) {
      for (int p = threadIdx.x; p < CT * half_p2; p += kThreads) {
        const int ct = p / half_p2;
        const int pi = p - ct * half_p2;
        const int i = (pi / k) * 2 * k + (pi % k);
        float* row = s + ct * stride;
        const float a = row[i];
        const float b = row[i + k];
        const bool asc = (i & size) == 0;
        if ((a > b) == asc) {
          row[i] = b;
          row[i + k] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int R>
__device__ __forceinline__ void sort_rows(float* s, int stride, int P2,
                                          int CT) {
  if constexpr (R > 0) {
    sort_rows_reg<R>(s, stride, CT);
  } else {
    sort_rows_smem(s, stride, P2, CT);
  }
}

// Entries of the sorted a[0..n) below v / not above v.
__device__ __forceinline__ int lower_bound(const float* a, int n, float v) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (a[lo + h] < v) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const float* a, int n, float v) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (a[lo + h] <= v) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// Entries of the ascending int array a[0..n) below v.
__device__ __forceinline__ int lower_bound_int(const int* a, int n, int v) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (a[lo + h] < v) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// Writes the nq node quantiles of each cell from its sorted row (rank k
// at s[ct * stride + k]); 8 neighbouring cells of one node are one run.
__device__ __forceinline__ void select_nodes(const float* s, const int* nvalid,
                             float* __restrict__ out,
                             const float* __restrict__ qv,
                             const float* __restrict__ coff, int g, int c0,
                             int C, int nq, int stride, int CT) {
  for (int e = threadIdx.x; e < nq * CT; e += kThreads) {
    const int ct = e % CT;
    const int j = e / CT;
    const int c = c0 + ct;
    if (c >= C) continue;
    const int nv = nvalid[ct];
    float res = NAN;
    if (nv > 0) {
      const float n = (float)nv;
      const float nm1 = n - 1.0f;  // exact: nv < 2^24
      float h = __fadd_rn(__fadd_rn(__fmul_rn(n, qv[j]), coff[j]), -1.0f);
      h = fminf(fmaxf(h, 0.0f), nm1);
      const float fl = floorf(h);
      const int k0 = (int)fl;
      const float gam = __fsub_rn(h, fl);
      const int k1 = min(k0 + 1, nv - 1);
      const float* row = s + ct * stride;
      res = __fadd_rn(__fmul_rn(row[k0], __fsub_rn(1.0f, gam)),
                      __fmul_rn(row[k1], gam));
    }
    out[((size_t)g * nq + j) * C + c] = res;
  }
}

// Sample y of the presorted slices entering (x) and leaving (y) the
// window at the slide into doy gn; NaN when gn is outside the chunk.
__device__ __forceinline__ float2 slide_samples(const float* __restrict__ ps,
                                               int gn, int g1, int half,
                                               int n_doy, int C, int Y, int c,
                                               int y) {
  if (gn >= g1) return make_float2(NAN, NAN);
  int d_out = (gn - 1 - half) % n_doy;
  if (d_out < 0) d_out += n_doy;
  const int d_in = (gn + half) % n_doy;
  return make_float2(ps[((size_t)d_in * C + c) * Y + y],
                     ps[((size_t)d_out * C + c) * Y + y]);
}

// Presorts each doy slice: (n_doy, Y, C) -> (n_doy, C, Y), each cell's Y
// values ascending, valid samples first, NaN after. Grid (cell groups,
// doy strides): block (k, j) takes cell group k (GLOBAL: k, k + gridDim.x,
// ...) and doys j, j + gridDim.y, ...; P2 >= Y, CT = cells_per_block(P2).
// GLOBAL: the rows live in the block's region of scratch (P2 > kMaxP2).
template <int R, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
presort_kernel(const float* __restrict__ x, float* __restrict__ ps,
               float* scratch, int n_doy, int Y, int C, int P2_arg,
               int CT_arg) {
  extern __shared__ float smem[];
  // compile-time on the register path, so divisions by them are shifts
  const int P2 = R > 0 ? R * kWarp : P2_arg;
  const int CT = R > 0 ? cells_per_block(R * kWarp) : CT_arg;
  const int stride = row_stride(P2, CT);
  float* s = GLOBAL ? scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)
                                    * CT * stride
                    : smem;
  int* nvalid = reinterpret_cast<int*>(GLOBAL ? smem : smem + CT * stride);
  // cell group blockIdx.x, one pass; a GLOBAL grid (gridDim.x <= groups)
  // walks on over the groups
  int cg = blockIdx.x;
  do {
    const int c0 = cg * CT;
    for (int d = blockIdx.y; d < n_doy; d += gridDim.y) {
      load_windows(x, s, nvalid, d, c0, n_doy, Y, C, 1, P2, CT);
      sort_rows<R>(s, stride, P2, CT);
      for (int e = threadIdx.x; e < CT * Y; e += kThreads) {
        const int ct = e / Y;
        const int y = e - ct * Y;
        const int c = c0 + ct;
        if (c < C)
          ps[((size_t)d * C + c) * Y + y] =
              y < nvalid[ct] ? s[ct * stride + y] : NAN;
      }
      __syncthreads();
    }
  } while (GLOBAL && (cg += gridDim.x) < (C + CT - 1) / CT);
}

// The sliding window of the shared-memory and global-scratch instances
// (P2 > kRegP2). Grid (cell groups, chunks of the doy axis): block (k, j)
// takes cell group k (GLOBAL: k, k + gridDim.x, ...) over chunk j.
// Shared (or, GLOBAL, the block's region of scratch, slide_floats each):
// two window buffers of CT rows, the incoming and outgoing sorted slices
// and the removed positions (CT x Y each); the valid counts stay in shared
// memory. With one chunk per doy (nchunk == n_doy) every window is sorted
// in full and nothing slides.
template <int STAGE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
slide_kernel(const float* __restrict__ x, const float* __restrict__ ps,
             float* __restrict__ out, const float* __restrict__ qv,
             const float* __restrict__ coff, float* scratch, int n_doy,
             int Y, int C, int window, int nq, int nchunk, int P2_arg,
             int CT_arg XTT_COUNTS_PARAM) {
  extern __shared__ float smem[];
  const int P2 = P2_arg;
  const int CT = CT_arg;
  const int stride = row_stride(P2, CT);
  float* cur = GLOBAL ? scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)
                                      * slide_floats(P2, CT, Y)
                      : smem;
  float* nxt = cur + CT * stride;
  float* rin = nxt + CT * stride;
  float* rout = rin + CT * Y;
  int* rp = reinterpret_cast<int*>(rout + CT * Y);
  int* nvalid = GLOBAL ? reinterpret_cast<int*>(smem) : rp + CT * Y;

  const int g0 = (int)((long long)blockIdx.y * n_doy / nchunk);
  const int g1 = (int)((long long)(blockIdx.y + 1) * n_doy / nchunk);
  const int half = window / 2;
  const int W = window * Y;
  // the threads of cell ct: gs of them, t its own index among them
  const int gs = kThreads / CT;
  const int ct = threadIdx.x / gs;
  const int t = threadIdx.x - ct * gs;
  // kept entries of a slide: thread t merges the run [t*E, t*E + E) of the
  // old window; E odd, so the 32 lanes of a warp start in 32 banks
  const int E = ((W + gs - 1) / gs) | 1;
  // the counting build's valid values entering and leaving this thread's
  // windows
  [[maybe_unused]] unsigned entered = 0, left = 0;

  // cell group blockIdx.x, one pass; a GLOBAL grid walks on, as in
  // presort_kernel
  int cg = blockIdx.x;
  do {
    const int c0 = cg * CT;
    const int c = c0 + ct;
    const bool live = c < C;
    // sample y = t of the slices entering and leaving at the slide into doy
    // g0 + 1, and then one slide ahead, so the loads overlap the merge
    float2 pre = make_float2(NAN, NAN);
    if (window > 1 && live && t < Y)
      pre = slide_samples(ps, g0 + 1, g1, half, n_doy, C, Y, c, t);

    if (window > 1) {
      load_windows(x, cur, nvalid, g0, c0, n_doy, Y, C, window, P2, CT);
      if constexpr (STAGE >= 1) sort_rows_smem(cur, stride, P2, CT);
    }
    for (int g = g0; g < g1; ++g) {
      float* row = cur + ct * stride;
      float* my_in = rin + ct * Y;
      float* my_out = rout + ct * Y;
      int* my_rp = rp + ct * Y;
      if (window == 1) {
        // the window is the presorted slice g
        if (t == 0) nvalid[ct] = 0;
        __syncthreads();
        int cnt = 0;
        for (int y = t; y < Y; y += gs) {
          const float v = live ? ps[((size_t)g * C + c) * Y + y] : NAN;
          cnt += !isnan(v);
          row[y] = isnan(v) ? INFINITY : v;
        }
        if (cnt) atomicAdd(&nvalid[ct], cnt);
        __syncthreads();
      } else if (g > g0) {
        // slide: slice g-1-half leaves, slice g+half enters
        int d_out = (g - 1 - half) % n_doy;
        if (d_out < 0) d_out += n_doy;
        const int d_in = (g + half) % n_doy;
        int cnt = 0;
        for (int y = t; y < Y; y += gs) {
          float vi = pre.x, vo = pre.y;
          if (y != t) {
            vi = vo = NAN;
            if (live) {
              vi = ps[((size_t)d_in * C + c) * Y + y];
              vo = ps[((size_t)d_out * C + c) * Y + y];
            }
          }
          cnt += (int)!isnan(vi) - (int)!isnan(vo);
          if constexpr (kCount) {
            entered += !isnan(vi);
            left += !isnan(vo);
          }
          my_in[y] = isnan(vi) ? INFINITY : vi;
          my_out[y] = isnan(vo) ? INFINITY : vo;
        }
        // a warp's threads serve one cell (gs >= 32)
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (threadIdx.x % kWarp == 0 && cnt) atomicAdd(&nvalid[ct], cnt);
        if (live && t < Y)
          pre = slide_samples(ps, g + 1, g1, half, n_doy, C, Y, c, t);
        __syncthreads();
        if constexpr (STAGE >= 1) {
          for (int j = t; j < Y; j += gs) {
            const float v = my_out[j];
            my_rp[j] =
                lower_bound(row, W, v) + (j - lower_bound(my_out, Y, v));
          }
          __syncthreads();
          float* dst = nxt + ct * stride;
          const int i0 = t * E;
          const int i1 = min(W, i0 + E);
          if (i0 < i1) {
            // r: removed positions below i; k: inserted values <= row[i];
            // both only grow along the run. The next of each is held in a
            // register (NaN and -1 past the end compare false).
            int r = lower_bound_int(my_rp, Y, i0);
            int k = upper_bound(my_in, Y, row[i0]);
            float next_in = k < Y ? my_in[k] : NAN;
            int next_rp = r < Y ? my_rp[r] : -1;
            for (int i = i0; i < i1; ++i) {
              const float v = row[i];
              while (next_in <= v) {
                ++k;
                next_in = k < Y ? my_in[k] : NAN;
              }
              if (i == next_rp) {
                ++r;
                next_rp = r < Y ? my_rp[r] : -1;
                continue;
              }
              dst[i - r + k] = v;
            }
          }
          for (int j = t; j < Y; j += gs) {
            const float u = my_in[j];
            dst[j + lower_bound(row, W, u) - lower_bound(my_out, Y, u)] = u;
          }
          __syncthreads();
          float* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }
      if constexpr (STAGE == 2) {
        select_nodes(cur, nvalid, out, qv, coff, g, c0, C, nq, stride, CT);
      } else if (t == 0 && live) {
        const int nv = nvalid[ct];
        out[(size_t)g * C + c] =
            STAGE == 0 ? (float)nv : (nv > 0 ? cur[ct * stride] : NAN);
      }
      __syncthreads();
    }
  } while (GLOBAL && (cg += gridDim.x) < (C + CT - 1) / CT);
#ifdef XTT_COUNT
  entered = __reduce_add_sync(0xffffffffu, entered);
  left = __reduce_add_sync(0xffffffffu, left);
  if (threadIdx.x % kWarp == 0) {
    atomicAdd(&counts[kInserted], (unsigned long long)entered);
    atomicAdd(&counts[kRemoved], (unsigned long long)left);
  }
#endif
}

// ---- The warp instance (P2 <= kRegP2): one warp a cell ----

// Cells of a warp-instance block: one a warp. Four such blocks stay
// resident on a SM (64 registers a thread): the slides wait on shared
// memory and on each other's branches, so warps in flight set the pace.
constexpr int kWarpCells = kThreads / kWarp;
constexpr int kWarpBlocks = 4;
// Staged node values a block holds at most (both buffers), and the most
// doys it stages before a barrier; past kStageBytes a doy, each warp
// writes its own nodes.
constexpr int kStageBytes = 16 * 1024;
constexpr int kMaxStageDoys = 8;

// Place of sorted rank p in a warp's window: one float of padding after
// every 32, so the k-th entries of the 32 lanes' runs fall in 32 banks.
__device__ __forceinline__ int wpos(int p) { return p + (p >> 5); }

// Floats of one warp's window: P2 ranks, and (window > 1) PY more that a
// slide may shift the padding into.
__host__ __device__ constexpr int window_floats(int P2, int PY, int window) {
  return window > 1 ? (P2 + PY) + (P2 + PY) / 32 : P2 + P2 / 32;
}

// Floats of one warp's region: the window, then (window > 1) the sorted
// incoming and outgoing slices, PY values and two NaN sentinels each;
// rounded up to a multiple of 33, so that each warp's window starts where
// rank 32 t of the block's padded layout would (merge_slices).
__host__ __device__ constexpr int warp_floats(int P2, int PY, int window) {
  return (window_floats(P2, PY, window) + (window > 1 ? 2 * (PY + 2) : 0) +
          32) / 33 * 33;
}

// Row stride of a block's staged node values: nq rounded up to 4 mod 8,
// so the 8 cells of 4 neighbouring nodes fall in 32 banks.
__host__ __device__ constexpr int node_stride(int nq) {
  return nq + ((12 - nq % 8) % 8);
}

// Doys of node values a block stages before one barrier writes them (0:
// none, each warp writes its own nodes).
__host__ int stage_doys(int nq) {
  const int per_doy = 2 * kWarpCells * node_stride(nq) * (int)sizeof(float);
  return std::min(kMaxStageDoys, kStageBytes / per_doy);
}

// Entries of the sorted a[0..N) (N a power of two, NaN after the values)
// not above t (LT false) or below t (LT true): log2(N) + 1 dependent
// loads; unrolled where N is given as the template's (a slice up to 32
// years), else N = n.
template <bool LT, int N>
__device__ __forceinline__ int count_sorted(const float* a, int n, float t) {
  int k = 0;
#pragma unroll
  for (int step = (N > 0 ? N : n) >> 1; step > 0; step >>= 1) {
    const float e = a[k + step - 1];
    if (LT ? e < t : e <= t) k += step;
  }
  const float e = a[k];
  return k + (LT ? e < t : e <= t);
}

template <bool LT>
__device__ __forceinline__ int count_slice(const float* a, int PY, float t) {
  return PY == kWarp ? count_sorted<LT, kWarp>(a, PY, t)
                     : count_sorted<LT, 0>(a, PY, t);
}

// Sorts a[0..N) ascending, N a power of two >= 32 (element i at
// a[wpos(i)] if PADDED, else a[i]): the warp's bitonic network over shared
// memory.
template <bool PADDED>
__device__ void warp_sort_smem(float* a, int N, int lane) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int k = size >> 1; k > 0; k >>= 1) {
      for (int p = lane; p < N / 2; p += kWarp) {
        const int i = (p / k) * 2 * k + (p % k);
        float* lo_at = a + (PADDED ? wpos(i) : i);
        float* hi_at = a + (PADDED ? wpos(i + k) : i + k);
        const float lo = *lo_at;
        const float hi = *hi_at;
        if ((lo > hi) == ((i & size) == 0)) {
          *lo_at = hi;
          *hi_at = lo;
        }
      }
      __syncwarp();
    }
  }
}

// Sorts a lane's a and b across the warp, each ascending in lane order:
// the 32-wide bitonic network on both at once.
__device__ __forceinline__ void sort32_pair(float& a, float& b, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
    for (int k = size >> 1; k > 0; k >>= 1) {
      const float oa = __shfl_xor_sync(0xffffffffu, a, k);
      const float ob = __shfl_xor_sync(0xffffffffu, b, k);
      const bool keep_min = ((lane & k) == 0) == ((lane & size) == 0);
      a = keep_min ? fminf(a, oa) : fmaxf(a, oa);
      b = keep_min ? fminf(b, ob) : fmaxf(b, ob);
    }
  }
}

// Loads doy slice d of cell c (Y values, NaN = missing) into a[0..PY),
// NaN as +inf, and returns its valid count; a needs sorting.
__device__ __forceinline__ int load_slice(const float* __restrict__ x,
                                          float* a, int d, int c, int Y,
                                          int C, int PY, int lane) {
  int cnt = 0;
  for (int y = lane; y < PY; y += kWarp) {
    const float xv = y < Y ? x[((size_t)d * Y + y) * C + c] : NAN;
    cnt += !isnan(xv);
    a[y] = isnan(xv) ? INFINITY : xv;
  }
  return __reduce_add_sync(0xffffffffu, cnt);
}

// The slices entering (doy d_in) and leaving (d_out) cell c's window,
// sorted into uin and oin: their m and mo valid values first, then NaN up
// to [PY + 1]. At Y <= 32 the caller has loaded sample `lane` of each
// (in.x, in.y) and they are sorted in registers. STAGE 0 only counts.
template <int STAGE>
__device__ __forceinline__ void sorted_slices(const float* __restrict__ x,
                                              float* uin, float* oin,
                                              float2 in, int d_in, int d_out,
                                              int c, int Y, int C, int PY,
                                              int lane, int& m, int& mo) {
  if (PY == kWarp) {
    m = __popc(__ballot_sync(0xffffffffu, !isnan(in.x)));
    mo = __popc(__ballot_sync(0xffffffffu, !isnan(in.y)));
    if constexpr (STAGE >= 1) {
      float a = isnan(in.x) ? INFINITY : in.x;
      float b = isnan(in.y) ? INFINITY : in.y;
      sort32_pair(a, b, lane);
      uin[lane] = lane < m ? a : NAN;
      oin[lane] = lane < mo ? b : NAN;
      if (lane < 2) uin[kWarp + lane] = oin[kWarp + lane] = NAN;
    }
  } else if constexpr (STAGE >= 1) {
    m = load_slice(x, uin, d_in, c, Y, C, PY, lane);
    mo = load_slice(x, oin, d_out, c, Y, C, PY, lane);
    __syncwarp();
    warp_sort_smem<false>(uin, PY, lane);
    warp_sort_smem<false>(oin, PY, lane);
    for (int y = lane; y < PY + 2; y += kWarp) {
      if (y >= m) uin[y] = NAN;
      if (y >= mo) oin[y] = NAN;
    }
  } else {
    m = mo = 0;
    for (int y = lane; y < Y; y += kWarp) {
      m += !isnan(x[((size_t)d_in * Y + y) * C + c]);
      mo += !isnan(x[((size_t)d_out * Y + y) * C + c]);
    }
    m = __reduce_add_sync(0xffffffffu, m);
    mo = __reduce_add_sync(0xffffffffu, mo);
  }
}

// Sorts the window of doy g (slices g-half .. g+half) of cell c into win
// (rank p at wpos(p), +inf from its valid count on up to P2); returns the
// valid count. Sorted in shared memory: once a chunk, so the kernel keeps
// its registers for the slides. STAGE 0 only counts.
template <int R, int STAGE>
__device__ __forceinline__ int sorted_window(const float* __restrict__ x,
                                             float* win, int g, int c,
                                             int n_doy, int Y, int C,
                                             int window, int lane) {
  const int half = window / 2;
  const int W = window * Y;
  int cnt = 0;
  __syncwarp();  // the previous doy's nodes are read
  for (int i = lane; i < R * kWarp; i += kWarp) {
    float v = INFINITY;
    if (i < W) {
      const int o = i / Y;
      int d = (g + o - half) % n_doy;
      if (d < 0) d += n_doy;
      const float xv = x[((size_t)d * Y + (i - o * Y)) * C + c];
      if (!isnan(xv)) {
        v = xv;
        ++cnt;
      }
    }
    if constexpr (STAGE >= 1) win[wpos(i)] = v;
  }
  if constexpr (STAGE >= 1) {
    __syncwarp();
    warp_sort_smem<true>(win, R * kWarp, lane);
  }
  return __reduce_add_sync(0xffffffffu, cnt);
}

// One slide of a warp's sorted window (P2 = 32 * R ranks: the n valid
// values, then +inf): the mo sorted outgoing values oin leave, the m
// sorted incoming values uin enter. Lane l reads its run (ranks l*R .. l*R
// + R-1, which never crosses a padding float) into registers, finds its
// starts in uin and oin by binary searches over them, then writes each
// kept entry and each incoming value once at its new rank. The +inf
// padding takes part as entries: incoming values go before it, and it is
// never matched by an outgoing value before the valid +inf entries are.
// An odd window of more than one slice holds fewer than P2 samples, so
// some padding is always left: every incoming value goes before it.
// Returns n - mo + m.
//
// The window is rank wb + p at sm[wpos(wb + p)] of the block's shared
// memory sm (wb a multiple of 32), so that a rank's place costs two
// instructions; uin and oin are walked by pointer. DETAIL (a sampled block
// of the counting build) sets bit r of ev where the lane inserts before
// entry r or removes it.
template <int R, bool DETAIL>
__device__ __forceinline__ int merge_slices(float* sm, int wb, int n,
                                            const float* uin, int m,
                                            const float* oin, int mo, int PY,
                                            int lane, unsigned& ev) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int P2 = R * kWarp;
  const float* run = sm + wpos(wb + lane * R);
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = run[r];
  const float f = v[0];
  const float z = v[R - 1];
  // incoming values not above the run's last entry: the next lane's start
  const int cu = count_slice<false>(uin, PY, z);
  int k = __shfl_up_sync(kAll, cu, 1);
  if (lane == 0) k = 0;
  // outgoing values matched before the run (each outgoing value takes the
  // first equal window entry not yet taken): those below its first entry,
  // and of those equal to it as many as equal entries before the run hold
  int ko = 0;
  if (mo > 0) {
    const int lo = count_slice<true>(oin, PY, f);
    const float zp = __shfl_up_sync(kAll, z, 1);
    const bool tie = lane > 0 && f == zp;
    const bool taken = tie && oin[lo] == f;
    int e = 0;
    if (__any_sync(kAll, taken)) {
      // X_l, the entries equal to z that end the runs up to lane l:
      // tail_l + X_{l-1} where lane l is all equal and ties with l-1
      int tail = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) tail += v[r] == z;
      int a = tail;
      int carry = tie && f == z;
#pragma unroll
      for (int dl = 1; dl < kWarp; dl <<= 1) {
        const int a2 = __shfl_up_sync(kAll, a, dl);
        const int c2 = __shfl_up_sync(kAll, carry, dl);
        if (lane >= dl) {
          a += carry * a2;
          carry *= c2;
        }
      }
      const int before = __shfl_up_sync(kAll, a, 1);
      if (taken) e = min(before, count_slice<false>(oin, PY, f) - lo);
    }
    ko = lo + e;
  }
  __syncwarp();  // every run is in registers: the window may be rewritten
  int out = wb + lane * R - ko + k;
  const float* up = uin + k;
  const float* op = oin + ko;
  float nu = *up;
  float no = *op;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    while (nu <= v[r]) {
      sm[wpos(out++)] = nu;
      nu = *++up;
      if constexpr (DETAIL) ev |= 1u << r;
    }
    const bool keep = no != v[r];
    if (keep) sm[wpos(out)] = v[r];
    out += keep;
    if (!keep) no = *++op;
    if constexpr (DETAIL) ev |= (unsigned)!keep << r;
  }
  // the ranks P2 - mo + m .. P2 - 1 written by nothing: padding again
  for (int j = P2 - mo + m + lane; j < P2; j += kWarp)
    sm[wpos(wb + j)] = INFINITY;
  __syncwarp();
  return n - mo + m;
}

// The nq node quantiles of a sorted window of n valid values (rank k at
// win[wpos(k)]), node j written to dst[j * step].
__device__ __forceinline__ void warp_nodes(const float* win, int n,
                                           const float* __restrict__ qv,
                                           const float* __restrict__ coff,
                                           int nq, float* dst, size_t step,
                                           int lane) {
  for (int j = lane; j < nq; j += kWarp) {
    float res = NAN;
    if (n > 0) {
      const float nf = (float)n;
      const float nm1 = nf - 1.0f;  // exact: n < 2^24
      float h = __fadd_rn(__fadd_rn(__fmul_rn(nf, qv[j]), coff[j]), -1.0f);
      h = fminf(fmaxf(h, 0.0f), nm1);
      const float fl = floorf(h);
      const int k0 = (int)fl;
      const float gam = __fsub_rn(h, fl);
      const int k1 = min(k0 + 1, n - 1);
      res = __fadd_rn(__fmul_rn(win[wpos(k0)], __fsub_rn(1.0f, gam)),
                      __fmul_rn(win[wpos(k1)], gam));
    }
    dst[j * step] = res;
  }
}

// The warp instance. Grid (cell groups of kWarpCells, chunks of the doy
// axis); warp w of block (k, j) owns cell k * kWarpCells + w over chunk j.
// Shared: each warp's region (warp_floats), then two buffers of S doys x
// kWarpCells cells x node_stride(nq) staged node values (S = 0: none).
// The counting build adds to counts; DETAIL, its sampled blocks, also
// time the stages and count the walk.
template <int R, int STAGE, bool DETAIL>
__device__ __forceinline__ void warp_cells(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ qv, const float* __restrict__ coff, int n_doy,
    int Y, int C, int window, int nq, int nchunk, int S,
    unsigned long long* __restrict__ counts) {
  extern __shared__ float smem[];
  constexpr int P2 = R * kWarp;
  const int PY = pow2_at_least(Y);
  const int wf = warp_floats(P2, PY, window);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* win = smem + warp * wf;
  const int wb = warp * wf / 33 * 32;  // win == smem + wpos(wb)
  float* uin = win + window_floats(P2, PY, window);
  float* oin = uin + PY + 2;
  const int nqs = node_stride(nq);
  float* staged = smem + kWarpCells * wf;
  const int c0 = blockIdx.x * kWarpCells;
  const int c = c0 + warp;
  const bool live = c < C;
  const int g0 = (int)((long long)blockIdx.y * n_doy / nchunk);
  const int g1 = (int)((long long)(blockIdx.y + 1) * n_doy / nchunk);
  const int half = window / 2;
  const bool small = PY == kWarp;  // a slice is a value a lane

  // sample `lane` of the slices leaving and entering at the slide into
  // doy gn (NaN past the chunk), loaded one slide ahead
  auto ahead = [&](int gn) {
    float2 r = make_float2(NAN, NAN);
    if (small && live && lane < Y && gn < g1) {
      int d_out = (gn - 1 - half) % n_doy;
      if (d_out < 0) d_out += n_doy;
      const int d_in = (gn + half) % n_doy;
      r = make_float2(x[((size_t)d_in * Y + lane) * C + c],
                      x[((size_t)d_out * Y + lane) * C + c]);
    }
    return r;
  };
  // the counting build's counts (the slides and walk steps follow from the
  // chunk), and the clock at the end of the last stage: a lap adds the
  // cycles since then to the stage's count
  [[maybe_unused]] unsigned cyc[kCounters] = {}, ev = 0;
  [[maybe_unused]] long long stamp = DETAIL ? clock64() : 0;
  auto lap = [&](int k) {
    if constexpr (DETAIL) {
      const long long now = clock64();
      cyc[k] += (unsigned)(now - stamp);
      stamp = now;
    }
  };
  float2 pre = window > 1 ? ahead(g0 + 1) : make_float2(NAN, NAN);
  int n = live ? sorted_window<R, STAGE>(x, win, g0, c, n_doy, Y, C, window,
                                         lane)
               : 0;
  lap(kCyclesSort);
  for (int g = g0; g < g1; ++g) {
    if (g > g0 && live) {
      if (window == 1) {
        n = sorted_window<R, STAGE>(x, win, g, c, n_doy, Y, C, 1, lane);
        lap(kCyclesSort);
      } else {
        int d_out = (g - 1 - half) % n_doy;
        if (d_out < 0) d_out += n_doy;
        const int d_in = (g + half) % n_doy;
        const float2 cur = pre;
        pre = ahead(g + 1);
        int m, mo;
        sorted_slices<STAGE>(x, uin, oin, cur, d_in, d_out, c, Y, C, PY, lane,
                             m, mo);
        lap(kCyclesSlices);
        if constexpr (STAGE >= 1) {
          __syncwarp();
          n = merge_slices<R, DETAIL>(smem, wb, n, uin, m, oin, mo, PY, lane,
                                      ev);
        } else {
          n += m - mo;
        }
        if constexpr (kCount) {
          cyc[kInserted] += m;
          cyc[kRemoved] += mo;
        }
        if constexpr (DETAIL) {
          cyc[kBranchSteps] += __popc(__reduce_or_sync(0xffffffffu, ev));
          cyc[kBranchLanes] += __popc(ev);
          ev = 0;
        }
        lap(kCyclesWalk);
      }
    }
    if constexpr (STAGE == 2) {
      if (S == 0) {
        if (live)
          warp_nodes(win, n, qv, coff, nq, out + (size_t)g * nq * C + c,
                     (size_t)C, lane);
      } else {
        // stage doy g's nodes; the last doy of a batch (or of the chunk)
        // meets the block and writes the batch as 32-byte runs
        const int sl = (g - g0) % S;
        float* buf = staged + (((g - g0) / S) & 1) * S * kWarpCells * nqs;
        if (live)
          warp_nodes(win, n, qv, coff, nq, buf + (sl * kWarpCells + warp) * nqs,
                     1, lane);
        if (sl == S - 1 || g == g1 - 1) {
          __syncthreads();
          // thread t writes cell t % 8 of nodes t / 8, t / 8 + 32, ...
          const int ct = threadIdx.x % kWarpCells;
          if (c0 + ct < C) {
            const float* src = buf + ct * nqs;
            float* dst = out + (size_t)(g - sl) * nq * C + c0 + ct;
            for (int b = 0; b <= sl; ++b) {
              for (int j = threadIdx.x / kWarpCells; j < nq;
                   j += kThreads / kWarpCells)
                dst[(size_t)j * C] = src[j];
              src += kWarpCells * nqs;
              dst += (size_t)nq * C;
            }
          }
        }
      }
    } else if (lane == 0 && live) {
      out[(size_t)g * C + c] =
          STAGE == 0 ? (float)n : (n > 0 ? win[0] : NAN);
    }
    lap(kCyclesNodes);
  }
  if constexpr (kCount) {
    cyc[kSlides] = live && window > 1 ? g1 - g0 - 1 : 0;
    if constexpr (DETAIL) {
      cyc[kSampledSlides] = cyc[kSlides];
      cyc[kWalkSteps] = cyc[kSlides] * R;
      cyc[kBranchLanes] = __reduce_add_sync(0xffffffffu, cyc[kBranchLanes]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (cyc[k]) atomicAdd(&counts[k], (unsigned long long)cyc[k]);
    }
  }
}

template <int R, int STAGE>
__global__ void __launch_bounds__(kThreads, kWarpBlocks)
warp_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ qv, const float* __restrict__ coff,
            int n_doy, int Y, int C, int window, int nq, int nchunk,
            int S XTT_COUNTS_PARAM) {
#ifdef XTT_COUNT
  if (blockIdx.x % kSampleEvery == 0)
    warp_cells<R, STAGE, true>(x, out, qv, coff, n_doy, Y, C, window, nq,
                               nchunk, S, counts);
  else
    warp_cells<R, STAGE, false>(x, out, qv, coff, n_doy, Y, C, window, nq,
                                nchunk, S, counts);
#else
  warp_cells<R, STAGE, false>(x, out, qv, coff, n_doy, Y, C, window, nq,
                              nchunk, S, nullptr);
#endif
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// when asked).
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Presort grid: a few resident blocks per SM, each looping over its doys
// (one block per (cell group, doy) would spend its time being scheduled);
// GLOBAL, at most kGlobalBlocks blocks, each with its scratch region.
dim3 presort_grid(int groups, int n_doy, bool global) {
  const int gx = global ? std::min(groups, kGlobalBlocks) : groups;
  const int blocks = global ? kGlobalBlocks : kPresortBlocks;
  return dim3(gx, std::min(n_doy, std::max(1, blocks / std::max(gx, 1))));
}

// Slide grid: every (cell group, chunk); GLOBAL, at most kGlobalBlocks
// blocks (at least one a chunk), each walking over cell groups.
dim3 slide_grid(int groups, int nchunk, bool global) {
  return dim3(global ? std::min(groups, std::max(1, kGlobalBlocks / nchunk))
                     : groups,
              nchunk);
}

// Whether the presort runs: not in the warp instance (each slice is
// sorted as it enters), nor with one chunk per doy and window > 1 (every
// window sorted in full, no presorted slice read).
bool presorts(int n_doy, int Y, int window, int nchunk) {
  return pow2_at_least(window * Y) > kRegP2 &&
         !(window > 1 && nchunk == n_doy);
}

// Floats of global scratch a call needs (0 when every window and slice
// fits shared memory); the presort and the slide use it in turn.
size_t scratch_floats(int n_doy, int Y, int C, int window, int nchunk) {
  const int pw = pow2_at_least(window * Y);
  const int py = pow2_at_least(Y);
  size_t need = 0;
  if (py > kMaxP2 && presorts(n_doy, Y, window, nchunk)) {
    const dim3 g = presort_grid(C, n_doy, true);
    need = (size_t)g.x * g.y * row_stride(py, 1);
  }
  if (pw > kMaxP2) {
    const dim3 g = slide_grid(C, nchunk, true);
    need = std::max(need, (size_t)g.x * g.y * slide_floats(pw, 1, Y));
  }
  return need;
}

template <int R, bool GLOBAL>
cudaError_t launch_presort(const float* x, float* ps, float* scratch,
                           int n_doy, int Y, int C, int P2, cudaStream_t st) {
  const int CT = cells_per_block(P2);
  const size_t smem =
      (GLOBAL ? 0 : (size_t)CT * row_stride(P2, CT) * sizeof(float)) +
      CT * sizeof(int);
  cudaError_t err = set_smem(presort_kernel<R, GLOBAL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = presort_grid((C + CT - 1) / CT, n_doy, GLOBAL);
  presort_kernel<R, GLOBAL><<<grid, kThreads, smem, st>>>(x, ps, scratch,
                                                          n_doy, Y, C, P2, CT);
  return cudaGetLastError();
}

template <int STAGE, bool GLOBAL>
cudaError_t launch_slide(const float* x, const float* ps, float* out,
                         const float* qv, const float* coff, float* scratch,
                         int n_doy, int Y, int C, int window, int nq,
                         int nchunk, int P2, unsigned long long* counts,
                         cudaStream_t st) {
  const int CT = cells_per_block(P2);
  const size_t smem =
      (GLOBAL ? 0 : slide_floats(P2, CT, Y) * sizeof(float)) +
      CT * sizeof(int);
  cudaError_t err = set_smem(slide_kernel<STAGE, GLOBAL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = slide_grid((C + CT - 1) / CT, nchunk, GLOBAL);
  slide_kernel<STAGE, GLOBAL><<<grid, kThreads, smem, st>>>(
      x, ps, out, qv, coff, scratch, n_doy, Y, C, window, nq, nchunk, P2,
      CT XTT_COUNTS_ARG);
  return cudaGetLastError();
}

template <int R, int STAGE>
cudaError_t launch_warp(const float* x, float* out, const float* qv,
                        const float* coff, int n_doy, int Y, int C,
                        int window, int nq, int nchunk,
                        unsigned long long* counts, cudaStream_t st) {
  const int S = STAGE == 2 ? stage_doys(nq) : 0;
  const size_t smem =
      ((size_t)kWarpCells * warp_floats(R * kWarp, pow2_at_least(Y), window) +
       2 * (size_t)S * kWarpCells * node_stride(nq)) *
      sizeof(float);
  cudaError_t err = set_smem(warp_kernel<R, STAGE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kWarpCells - 1) / kWarpCells, nchunk);
  warp_kernel<R, STAGE><<<grid, kThreads, smem, st>>>(
      x, out, qv, coff, n_doy, Y, C, window, nq, nchunk, S XTT_COUNTS_ARG);
  return cudaGetLastError();
}

template <int STAGE>
cudaError_t run(const float* x, float* ps, float* scratch, float* out,
                const float* qv, const float* coff, int n_doy, int Y, int C,
                int window, int nq, int nchunk, long long scratch_n,
                unsigned long long* counts, cudaStream_t st) {
  if (window < 1 || window % 2 == 0 || Y < 0 || nchunk < 1 ||
      nchunk > n_doy || (long long)window * Y > kMaxWindow ||
      scratch_n < (long long)scratch_floats(n_doy, Y, C, window, nchunk))
    return cudaErrorInvalidValue;
  const int pw = pow2_at_least(window * Y);
#define XTT_WARP(R)                                                       \
  launch_warp<R, STAGE>(x, out, qv, coff, n_doy, Y, C, window, nq, nchunk, \
                        counts, st)
  switch (pw) {
    case 32: return XTT_WARP(1);
    case 64: return XTT_WARP(2);
    case 128: return XTT_WARP(4);
    case 256: return XTT_WARP(8);
    case 512: return XTT_WARP(16);
    case 1024: return XTT_WARP(32);
  }
#undef XTT_WARP
  const int py = presorts(n_doy, Y, window, nchunk) ? pow2_at_least(Y) : 0;
  cudaError_t err = cudaSuccess;
#define XTT_PRESORT(R, GLOBAL) \
  launch_presort<R, GLOBAL>(x, ps, scratch, n_doy, Y, C, py, st)
  switch (py) {
    case 0: break;
    case 32: err = XTT_PRESORT(1, false); break;
    case 64: err = XTT_PRESORT(2, false); break;
    case 128: err = XTT_PRESORT(4, false); break;
    case 256: err = XTT_PRESORT(8, false); break;
    case 512: err = XTT_PRESORT(16, false); break;
    case 1024: err = XTT_PRESORT(32, false); break;
    default:
      err = py <= kMaxP2 ? XTT_PRESORT(0, false) : XTT_PRESORT(0, true);
  }
#undef XTT_PRESORT
  if (err != cudaSuccess) return err;
  if (pw <= kMaxP2)
    return launch_slide<STAGE, false>(x, ps, out, qv, coff, scratch, n_doy, Y,
                                      C, window, nq, nchunk, pw, counts, st);
  return launch_slide<STAGE, true>(x, ps, out, qv, coff, scratch, n_doy, Y, C,
                                   window, nq, nchunk, pw, counts, st);
}

}  // namespace

// Floats of global scratch xtt_winquantile needs for this call: windows
// (or slices) past 8192 padded samples keep their sorted rows there.
extern "C" long long xtt_winquantile_scratch(int n_doy, int Y, int C,
                                             int window, int nchunk) {
  return (long long)scratch_floats(n_doy, Y, C, window, nchunk);
}

// Launches on `stream`; returns the first CUDA error of its launches (one
// in the warp instance; the presort and the slides in the others), or
// cudaErrorInvalidValue for an even window, window*Y above 2^24, a chunk
// count outside 1..n_doy, or scratch_n below xtt_winquantile_scratch. ps
// is scratch of n_doy*C*Y floats for the presorted slices (unused, and may
// be empty, in the warp instance, window*Y <= 1024, and when window > 1
// and nchunk == n_doy); scratch holds scratch_n floats; nchunk splits the
// doy axis across blocks.
#ifndef XTT_COUNT
extern "C" int xtt_winquantile(const float* x, float* ps, float* scratch,
                               float* out, const float* qv, const float* coff,
                               int n_doy, int Y, int C, int window, int nq,
                               int nchunk, long long scratch_n, void* stream) {
  return (int)run<2>(x, ps, scratch, out, qv, coff, n_doy, Y, C, window, nq,
                     nchunk, scratch_n, nullptr, (cudaStream_t)stream);
}
#else
// xtt_winquantile of the counting build: the same launches, each kernel
// adding its counts to counts[kCounters] (zeroed by the caller).
extern "C" int xtt_winquantile_count(const float* x, float* ps, float* scratch,
                                     float* out, const float* qv,
                                     const float* coff, int n_doy, int Y,
                                     int C, int window, int nq, int nchunk,
                                     long long scratch_n,
                                     unsigned long long* counts,
                                     void* stream) {
  return (int)run<2>(x, ps, scratch, out, qv, coff, n_doy, Y, C, window, nq,
                     nchunk, scratch_n, counts, (cudaStream_t)stream);
}

// Loads every kernel xtt_winquantile_count may launch now: CUDA loads a
// kernel on its first use, which would otherwise fall inside the first
// traced call (3-6 ms at sdba's shape).
extern "C" int xtt_winquantile_count_load() {
  const void* kernels[] = {
      (const void*)warp_kernel<1, 2>,     (const void*)warp_kernel<2, 2>,
      (const void*)warp_kernel<4, 2>,     (const void*)warp_kernel<8, 2>,
      (const void*)warp_kernel<16, 2>,    (const void*)warp_kernel<32, 2>,
      (const void*)presort_kernel<1, false>,
      (const void*)presort_kernel<2, false>,
      (const void*)presort_kernel<4, false>,
      (const void*)presort_kernel<8, false>,
      (const void*)presort_kernel<16, false>,
      (const void*)presort_kernel<32, false>,
      (const void*)presort_kernel<0, false>,
      (const void*)presort_kernel<0, true>,
      (const void*)slide_kernel<2, false>,
      (const void*)slide_kernel<2, true>};
  cudaFuncAttributes attr;
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
#endif  // XTT_COUNT

#ifdef XTT_WINQUANTILE_STAGES
// The same kernel stopped after `stage` (0: loads (and presort), writing
// the window's valid count; 1: + sort and slides, writing the window's
// smallest valid value; 2: + node selection, as xtt_winquantile). For
// stages 0 and 1, out is (n_doy, C).
extern "C" int xtt_winquantile_stages(const float* x, float* ps,
                                      float* scratch, float* out,
                                      const float* qv, const float* coff,
                                      int n_doy, int Y, int C, int window,
                                      int nq, int nchunk, long long scratch_n,
                                      int stage, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case 0: return (int)run<0>(x, ps, scratch, out, qv, coff, n_doy, Y, C,
                               window, nq, nchunk, scratch_n, nullptr, st);
    case 1: return (int)run<1>(x, ps, scratch, out, qv, coff, n_doy, Y, C,
                               window, nq, nchunk, scratch_n, nullptr, st);
    case 2: return (int)run<2>(x, ps, scratch, out, qv, coff, n_doy, Y, C,
                               window, nq, nchunk, scratch_n, nullptr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // XTT_WINQUANTILE_STAGES
