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
// What bounds it on the card: issuing the work that keeps each window
// sorted. Bytes are few (the slices read a few times, mostly from L2, and
// the nodes written once); sorting every (doy, cell) window from scratch
// (the previous design) cost ~28 K compare-exchanges a pair at 930
// samples, and every sample was sorted again in each of its 31 windows.
//
// Design: a sliding sorted window, as the TPU kernel merged presorted runs.
//  1. presort_kernel sorts each doy slice of Y values per cell once (NaN ->
//     +inf, a warp's register bitonic sort up to 1024 padded values, a
//     block's shared-memory sort above) into a scratch (n_doy, C, Y) array:
//     the sorted valid samples, then NaN.
//  2. slide_kernel: a block takes CT neighbouring cells and one chunk of the
//     doy axis (the host splits n_doy into chunks so that the grid has a
//     few thousand blocks; one chunk per doy sorts every window in full and
//     skips the presort). At the chunk's first doy it gathers and
//     bitonic-sorts each cell's whole window (register path for P2 <= 1024
//     with CT = 8, one warp a cell; shared-memory path up to P2 = 8192
//     with CT = 8192 / P2; past that, the global-scratch instance below).
//     Then each step g -> g+1 removes the presorted
//     slice g-half and merges in the presorted slice g+half+1, writing the
//     new window into the second of two shared buffers:
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
//     Inserted entries land before kept equal ones; only values are read,
//     so any tie order gives the same quantiles. The valid count is the
//     running sum of the slices' non-NaN entries.
//  3. select_nodes reads the two order statistics of each node from the
//     sorted window; the block writes 8 neighbouring cells of a node as one
//     32-byte run.
// Window 1 needs no slide: each doy's window is its presorted slice.
// The +inf padding is exact: the first n_valid sorted entries are exactly
// the sorted valid samples (a valid +inf equals the padding), and only
// those ranks are read.
//
// Windows past kMaxP2 padded samples (w31 over more than 264 years, w91
// over more than 90) do not fit a block's shared memory. Their instance
// (template GLOBAL, one cell a block) runs the same code on the block's
// own region of a global scratch array: the two window buffers, the slices
// and the removed positions (the valid count stays in shared memory; the
// block barriers order the global accesses as they order shared ones).
// Its grid is persistent, at most kGlobalBlocks blocks walking over the
// cells, so the scratch (xtt_winquantile_scratch floats) stays near 140 MB
// at w31 x 300 years however many cells there are. A presort of more than
// kMaxP2 years takes the same route. The only limit left is the valid
// count's: a window holds at most kMaxWindow = 2^24 samples, which float32
// counts exactly.
//
// Stages (template STAGE, the profile of tools/prof_winquantile.py; the
// entry point xtt_winquantile_stages, and so stages 0 and 1, are compiled
// only with -DXTT_WINQUANTILE_STAGES, the build target winquantile_stages):
//   0 presort + the per-doy loads of the window's slices and the running
//     valid count; writes the count per (doy, cell) as float32 (nq = 1);
//   1 + the chunk-start sort and the slides; writes the window's smallest
//     valid value (NaN without one);
//   2 + node selection: the shipped kernel (xtt_winquantile).
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

namespace {

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

__host__ int pow2_at_least(int n) {
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

// The sliding window. Grid (cell groups, chunks of the doy axis): block
// (k, j) takes cell group k (GLOBAL: k, k + gridDim.x, ...) over chunk j.
// Shared (or, GLOBAL, the block's region of scratch, slide_floats each):
// two window buffers of CT rows, the incoming and outgoing sorted slices
// and the removed positions (CT x Y each); the valid counts stay in shared
// memory. With one chunk per doy (nchunk == n_doy) every window is sorted
// in full and nothing slides.
template <int R, int STAGE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
slide_kernel(const float* __restrict__ x, const float* __restrict__ ps,
             float* __restrict__ out, const float* __restrict__ qv,
             const float* __restrict__ coff, float* scratch, int n_doy,
             int Y, int C, int window, int nq, int nchunk, int P2_arg,
             int CT_arg) {
  extern __shared__ float smem[];
  // compile-time on the register path, so divisions by them are shifts
  const int P2 = R > 0 ? R * kWarp : P2_arg;
  const int CT = R > 0 ? cells_per_block(R * kWarp) : CT_arg;
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
      if constexpr (STAGE >= 1) sort_rows<R>(cur, stride, P2, CT);
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

// Whether the presort runs: one chunk per doy with window > 1 sorts every
// window in full and reads no presorted slice.
bool presorts(int n_doy, int window, int nchunk) {
  return !(window > 1 && nchunk == n_doy);
}

// Floats of global scratch a call needs (0 when every window and slice
// fits shared memory); the presort and the slide use it in turn.
size_t scratch_floats(int n_doy, int Y, int C, int window, int nchunk) {
  const int pw = pow2_at_least(window * Y);
  const int py = pow2_at_least(Y);
  size_t need = 0;
  if (py > kMaxP2 && presorts(n_doy, window, nchunk)) {
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

template <int R, int STAGE, bool GLOBAL>
cudaError_t launch_slide(const float* x, const float* ps, float* out,
                         const float* qv, const float* coff, float* scratch,
                         int n_doy, int Y, int C, int window, int nq,
                         int nchunk, int P2, cudaStream_t st) {
  const int CT = cells_per_block(P2);
  const size_t smem =
      (GLOBAL ? 0 : slide_floats(P2, CT, Y) * sizeof(float)) +
      CT * sizeof(int);
  cudaError_t err = set_smem(slide_kernel<R, STAGE, GLOBAL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = slide_grid((C + CT - 1) / CT, nchunk, GLOBAL);
  slide_kernel<R, STAGE, GLOBAL><<<grid, kThreads, smem, st>>>(
      x, ps, out, qv, coff, scratch, n_doy, Y, C, window, nq, nchunk, P2, CT);
  return cudaGetLastError();
}

template <int STAGE>
cudaError_t run(const float* x, float* ps, float* scratch, float* out,
                const float* qv, const float* coff, int n_doy, int Y, int C,
                int window, int nq, int nchunk, long long scratch_n,
                cudaStream_t st) {
  if (window < 1 || window % 2 == 0 || Y < 0 || nchunk < 1 ||
      nchunk > n_doy || (long long)window * Y > kMaxWindow ||
      scratch_n < (long long)scratch_floats(n_doy, Y, C, window, nchunk))
    return cudaErrorInvalidValue;
  const int pw = pow2_at_least(window * Y);
  const int py = presorts(n_doy, window, nchunk) ? pow2_at_least(Y) : 0;
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
#define XTT_SLIDE(R, GLOBAL)                                              \
  launch_slide<R, STAGE, GLOBAL>(x, ps, out, qv, coff, scratch, n_doy, Y, \
                                 C, window, nq, nchunk, pw, st)
  switch (pw) {
    case 32: return XTT_SLIDE(1, false);
    case 64: return XTT_SLIDE(2, false);
    case 128: return XTT_SLIDE(4, false);
    case 256: return XTT_SLIDE(8, false);
    case 512: return XTT_SLIDE(16, false);
    case 1024: return XTT_SLIDE(32, false);
    default: return pw <= kMaxP2 ? XTT_SLIDE(0, false) : XTT_SLIDE(0, true);
  }
#undef XTT_SLIDE
}

}  // namespace

// Floats of global scratch xtt_winquantile needs for this call: windows
// (or slices) past 8192 padded samples keep their sorted rows there.
extern "C" long long xtt_winquantile_scratch(int n_doy, int Y, int C,
                                             int window, int nchunk) {
  return (long long)scratch_floats(n_doy, Y, C, window, nchunk);
}

// Launches on `stream`; returns the first CUDA error of the two launches
// (or cudaErrorInvalidValue for an even window, window*Y above 2^24, a
// chunk count outside 1..n_doy, or scratch_n below
// xtt_winquantile_scratch). ps is scratch of n_doy*C*Y floats for the
// presorted slices (unused, and may be empty, when window > 1 and nchunk
// == n_doy); scratch holds scratch_n floats; nchunk splits the doy axis
// across blocks.
extern "C" int xtt_winquantile(const float* x, float* ps, float* scratch,
                               float* out, const float* qv, const float* coff,
                               int n_doy, int Y, int C, int window, int nq,
                               int nchunk, long long scratch_n, void* stream) {
  return (int)run<2>(x, ps, scratch, out, qv, coff, n_doy, Y, C, window, nq,
                     nchunk, scratch_n, (cudaStream_t)stream);
}

#ifdef XTT_WINQUANTILE_STAGES
// The same kernel stopped after `stage` (0: presort and loads, writing the
// window's valid count; 1: + sort and slides, writing the window's
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
                               window, nq, nchunk, scratch_n, st);
    case 1: return (int)run<1>(x, ps, scratch, out, qv, coff, n_doy, Y, C,
                               window, nq, nchunk, scratch_n, st);
    case 2: return (int)run<2>(x, ps, scratch, out, qv, coff, n_doy, Y, C,
                               window, nq, nchunk, scratch_n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // XTT_WINQUANTILE_STAGES
