// Windowed day-of-year quantiles: the sdba training kernel.
//
// Replaces: xclim_tpu/ops/pallas/winquantile.py, doy_window_quantiles
// (Pallas kernels _kernel / _kernel_dyadic and _select_nodes, launched by
// pl.pallas_call in _call).
//
// What it computes: for each day of year g and cell c, the NaN-skipping
// Hyndman-Fan quantiles at nq nodes of every sample in the doy slices
// g-half .. g+half (wrapping around the year). Input (n_doy, Y, C) float32
// with NaN = missing, C contiguous; output (n_doy, nq, C). A window with no
// valid sample gives NaN.
//
// What bounds it on the card: the sort. Each (doy, cell) pair is an
// independent problem of window*Y samples (930 at window 31 and 30 years),
// and there are n_doy*C of them (6 M at 16384 cells): ~P2*log2(P2)^2/4
// compare-exchanges each (28 K at P2 = 1024). Device memory traffic is
// only window*Y reads per pair, mostly served from L2 because neighbouring
// doys share slices.
//
// Design: one block takes one doy and CT neighbouring cells (CT = 8 at the
// slice size), so each global read is a 32-byte run of CT cells. The block
// copies the CT windows into shared memory (NaN -> +inf, valid samples
// counted per cell) and sorts each one, padded with +inf to a power of two
// P2; then it reads the two order statistics of each node. The +inf padding
// is exact: the first n_valid sorted entries are exactly the sorted valid
// samples, and only those ranks are read. The windowed gather never exists
// in device memory (it would be 22 GB at 16384 cells x 30 years).
//   * P2 <= 1024 (window 31 up to 33 years): winquantile_reg_kernel. Warp w
//     sorts cell w's window in registers, R = P2/32 values a lane: bitonic
//     stages whose partners lie in one lane are register compare-exchanges,
//     the others __shfl_xor_sync; no block barrier inside the sort.
//   * larger windows (up to P2 = 8192): winquantile_smem_kernel, a bitonic
//     sort in shared memory with one block barrier per stage.
// The TPU kernel's lane blocking, DMA slab, dyadic run cache and 3e38 NaN
// sentinel are not carried over.
//
// Rounding: the node arithmetic repeats the reference's float32 op
// sequence (h = n*q + coff - 1, clip, floor, gamma, v0*(1-gamma) +
// v1*gamma) with __fmul_rn / __fadd_rn, so nvcc cannot contract any step
// into an FMA. qv and coff are rounded to float32 on the host exactly as
// the reference rounds them.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// Row stride of the shared tile: padded by 32/CT floats so the CT cells of
// one sample index fall into distinct banks while the window is loaded.
__host__ __device__ constexpr int row_stride(int P2, int CT) {
  return P2 + 32 / CT;
}

// Copies the windows of doy g for cells c0 .. c0+CT-1 into s (row ct holds
// cell c0+ct; +inf for missing samples and padding) and counts the valid
// samples of each cell into nvalid[ct]. Ends with a block barrier.
__device__ void load_windows(const float* __restrict__ x, float* s,
                             int* nvalid, int g, int c0, int n_doy, int Y,
                             int C, int window, int P2, int CT) {
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

// Writes the nq node quantiles of each cell from its sorted row. Rank k of
// row ct sits at s[ct * stride + pos(k)]: pos(k) = k for the shared-memory
// sort, (k % R) * 32 + k / R for the register sort (R > 0).
template <int R>
__device__ void select_nodes(const float* s, const int* nvalid,
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
      int p0 = k0;
      int p1 = k1;
      if constexpr (R > 0) {
        p0 = (k0 % R) * kWarp + k0 / R;
        p1 = (k1 % R) * kWarp + k1 / R;
      }
      res = __fadd_rn(__fmul_rn(row[p0], __fsub_rn(1.0f, gam)),
                      __fmul_rn(row[p1], gam));
    }
    out[((size_t)g * nq + j) * C + c] = res;
  }
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

// P2 <= 1024: one warp per cell, R values a lane, CT = 8 cells a block.
template <int R>
__global__ void __launch_bounds__(kThreads)
winquantile_reg_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const float* __restrict__ qv,
                       const float* __restrict__ coff, int n_doy, int Y,
                       int C, int window, int nq) {
  constexpr int P2 = R * kWarp;
  constexpr int CT = kThreads / kWarp;
  constexpr int stride = row_stride(P2, CT);
  __shared__ float s[CT * stride];
  __shared__ int nvalid[CT];

  const int g = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  load_windows(x, s, nvalid, g, c0, n_doy, Y, C, window, P2, CT);

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* row = s + warp * stride;
  // lane l, register r holds logical element i = l * R + r; it is loaded
  // from row position r * 32 + l (any assignment works before a sort, and
  // this one reads and writes the row without bank conflicts)
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = row[r * kWarp + lane];

  bitonic_sort<R, 2>(v, lane);

#pragma unroll
  for (int r = 0; r < R; ++r) row[r * kWarp + lane] = v[r];
  __syncthreads();
  select_nodes<R>(s, nvalid, out, qv, coff, g, c0, C, nq, stride, CT);
}

// Any P2 up to 8192: block-wide bitonic sort of the CT rows in shared memory.
__global__ void __launch_bounds__(kThreads)
winquantile_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ qv,
                        const float* __restrict__ coff, int n_doy, int Y,
                        int C, int window, int nq, int P2, int CT) {
  extern __shared__ float smem[];
  const int stride = row_stride(P2, CT);
  float* s = smem;
  int* nvalid = reinterpret_cast<int*>(smem + CT * stride);

  const int g = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  load_windows(x, s, nvalid, g, c0, n_doy, Y, C, window, P2, CT);

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
  select_nodes<0>(s, nvalid, out, qv, coff, g, c0, C, nq, stride, CT);
}

template <int R>
cudaError_t launch_reg(const float* x, float* out, const float* qv,
                       const float* coff, int n_doy, int Y, int C,
                       int window, int nq, cudaStream_t stream) {
  constexpr int CT = kThreads / kWarp;
  const dim3 grid((C + CT - 1) / CT, n_doy);
  winquantile_reg_kernel<R><<<grid, kThreads, 0, stream>>>(
      x, out, qv, coff, n_doy, Y, C, window, nq);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch. P2 is
// window*Y rounded up to a power of two (at most 8192) and CT =
// min(8, 8192 / P2) the cells a block takes; P2 <= 1024 runs the register
// sort (with CT = 8), larger windows the shared-memory sort.
extern "C" int xtt_winquantile(const float* x, float* out, const float* qv,
                               const float* coff, int n_doy, int Y, int C,
                               int window, int nq, int P2, int CT,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (P2 <= 32) {
    err = launch_reg<1>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else if (P2 <= 64) {
    err = launch_reg<2>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else if (P2 <= 128) {
    err = launch_reg<4>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else if (P2 <= 256) {
    err = launch_reg<8>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else if (P2 <= 512) {
    err = launch_reg<16>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else if (P2 <= 1024) {
    err = launch_reg<32>(x, out, qv, coff, n_doy, Y, C, window, nq, st);
  } else {
    const dim3 grid((C + CT - 1) / CT, n_doy);
    const size_t smem =
        (size_t)CT * row_stride(P2, CT) * sizeof(float) + CT * sizeof(int);
    winquantile_smem_kernel<<<grid, kThreads, smem, st>>>(
        x, out, qv, coff, n_doy, Y, C, window, nq, P2, CT);
    err = cudaGetLastError();
  }
  return (int)err;
}
