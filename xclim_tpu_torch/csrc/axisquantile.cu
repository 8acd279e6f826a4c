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
// scalar rate, so the network must overlap the loads: on an H100 the
// direct route at that shape, which loads and then sorts in each thread,
// takes over twice the time of its loads alone (PERF.md §6,
// tools/prof_axisquantile_split.py).
//
// Design: one thread per column of the (pre, M, post) view, so any axis
// position takes the kernel without a movedim copy; neighbouring threads
// take neighbouring j. Two routes load the column:
//  * staged: a persistent grid (as many blocks as fit on the SMs) walks
//    over tiles of kTile columns of one p. A ring of kStages (M, kTile)
//    tiles in shared memory is filled by 16-byte cp.async copies, kStages
//    - 1 tiles ahead, so the next tiles load while this one sorts; each
//    thread reads its column from the tile (bank = lane). One barrier a
//    tile: a slot is refilled only after every thread has passed the next
//    tile's barrier. Taken for post >= kTile (a multiple of 4) and a
//    16-byte aligned start.
//  * direct (the rest: post == 1, post % 4 != 0, post < kTile, an
//    unaligned start): a thread makes its M unrolled loads itself
//    (coalesced across the warp unless post == 1).
// Then, in registers: NaN becomes +inf before any min/max (fminf/fmaxf
// drop a NaN operand) and the valid samples are counted; the column is
// padded with +inf to Mp = 2..64 and sorted by Batcher's odd-even merge
// network, unrolled at compile time from the template on Mp. The first n
// sorted entries are exactly the sorted valid samples (+inf pads sort after
// them, or equal a valid +inf), and only those ranks are read. v0 and v1
// are picked by a binary tree of predicated selects on the bits of the
// rank, so no register array is indexed at run time and nothing goes to
// local memory. The node arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn
// in the twin's order, so nvcc cannot contract a step into an FMA; qv and
// coff are rounded to float32 on the host exactly as the twin rounds them
// and read from a small device array (one uniform load per node). Offsets
// are 64-bit: 64 members of this grid pass 2^31 elements. The TPU kernel's
// finite sentinel (3e38), lane padding and one-hot weighted sums are not
// carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // columns a staged tile holds
constexpr int kStages = 3;       // tiles in a staged block's ring
constexpr int kMaxDevices = 64;

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

// v[m] for m < M: NaN -> +inf, counted in n; +inf padding above M.
__device__ __forceinline__ float take(float xv, int m, int M, int& n) {
  if (m >= M) return INFINITY;
  if (isnan(xv)) return INFINITY;
  ++n;
  return xv;
}

// Sorts the column v (n valid samples) and writes its nq quantiles to
// out[q * cols + col].
template <int MP>
__device__ __forceinline__ void column_quantiles(
    float (&v)[MP], int n, const float* __restrict__ nodes, int nq,
    float* __restrict__ out, long long col, long long cols) {
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
__global__ void __launch_bounds__(kThreads)
axisquantile_direct(const float* __restrict__ x, float* __restrict__ out,
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
  for (int m = 0; m < MP; ++m)
    v[m] = take(m < M ? src[(size_t)m * post] : 0.0f, m, M, n);
  column_quantiles<MP>(v, n, nodes, nq, out, col, cols);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of tile `tile` ((p, j0): tiles_per_p tiles of kTile
// columns to each p) into ring slot `ring`; columns past post are zeros.
// Thread t copies the 16-byte chunk (t % kChunks) of rows t / kChunks,
// + kRowsAtOnce, ...
constexpr int kChunks = kTile / 4;  // 16-byte chunks a row
constexpr int kRowsAtOnce = kThreads / kChunks;

__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          float* ring, long long tile,
                                          long long tiles_per_p, int M,
                                          long long post) {
  const long long p = tile / tiles_per_p;
  const long long j = (tile - p * tiles_per_p) * kTile
                      + (threadIdx.x % kChunks) * 4;
  const bool in = j < post;
  const float* src = x + ((size_t)p * M + threadIdx.x / kChunks) * post + j;
  const size_t step = (size_t)kRowsAtOnce * post;
  float* dst = ring + (threadIdx.x / kChunks) * kTile
               + (threadIdx.x % kChunks) * 4;
  for (int m = threadIdx.x / kChunks; m < M; m += kRowsAtOnce) {
    cp_async16(dst, in ? src : x, in ? 16 : 0);
    src += step;
    dst += kRowsAtOnce * kTile;
  }
}

template <int MP>
__global__ void __launch_bounds__(kThreads)
axisquantile_staged(const float* __restrict__ x, float* __restrict__ out,
                    const float* __restrict__ nodes, int M, int nq,
                    long long post, long long cols, long long tiles_per_p,
                    long long ntiles) {
  extern __shared__ float ring[];  // kStages x (M, kTile)
  const int stride = M * kTile;
  const long long first = blockIdx.x;
  const long long step = gridDim.x;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long tile = first + s * step;
    if (tile < ntiles) load_tile(x, ring + s * stride, tile, tiles_per_p, M,
                                 post);
    cp_async_commit();
  }
  int slot = 0;
  for (long long tile = first; tile < ntiles; tile += step) {
    cp_async_wait<kStages - 2>();
    // this tile has landed for every thread, and every thread is done
    // reading the slot the next copies go to
    __syncthreads();
    const long long ahead = tile + (kStages - 1) * step;
    if (ahead < ntiles) {
      load_tile(x, ring + ((slot + kStages - 1) % kStages) * stride, ahead,
                tiles_per_p, M, post);
    }
    cp_async_commit();

    const long long p = tile / tiles_per_p;
    const long long j = (tile - p * tiles_per_p) * kTile + threadIdx.x;
    if (j < post) {
      const float* col_s = ring + slot * stride + threadIdx.x;
      const long long col = p * post + j;
      float v[MP];
      int n = 0;
#pragma unroll
      for (int m = 0; m < MP; ++m)
        v[m] = take(m < M ? col_s[m * kTile] : 0.0f, m, M, n);
      column_quantiles<MP>(v, n, nodes, nq, out, col, cols);
    }
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();
}

template <int MP>
cudaError_t launch(const float* x, float* out, const float* nodes, int M,
                   int nq, long long pre, long long post, bool staged,
                   cudaStream_t stream) {
  const long long cols = pre * post;
  if (!staged) {
    const long long blocks = (cols + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    axisquantile_direct<MP><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, out, nodes, M, nq, post, cols);
    return cudaGetLastError();
  }
  auto kernel = axisquantile_staged<MP>;
  const int smem = kStages * M * kTile * (int)sizeof(float);
  // resident blocks per SM x SMs, found once per device and M
  static int resident[kMaxDevices][65];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev][M] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStages * 64 * kTile * (int)sizeof(float));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev][M] = per_sm * sms;
  }
  const long long tiles_per_p = (post + kTile - 1) / kTile;
  const long long ntiles = pre * tiles_per_p;
  const long long grid = ntiles < resident[dev][M] ? ntiles
                                                   : resident[dev][M];
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      x, out, nodes, M, nq, post, cols, tiles_per_p, ntiles);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for M outside 1..64, a direct grid beyond 2^31 - 1
// blocks, or a staged launch whose rows are not whole 16-byte chunks or
// shorter than a tile (post % 4 != 0, post < 256, or x not 16-byte
// aligned). x: contiguous (pre, M, post);
// out: (nq, pre*post); nodes: nq qvals then nq coffs, float32, on the
// device; staged: 1 for the shared-memory ring route, 0 for direct loads.
extern "C" int xtt_axisquantile(const float* x, float* out,
                                const float* nodes, int M, int nq,
                                long long pre, long long post, int staged,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > 64 || pre < 1 || post < 1)
    return (int)cudaErrorInvalidValue;
  // the staged route's copies are 16-byte chunks of every row
  if (staged && (post % 4 != 0 || post < kTile || (uintptr_t)x % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const bool s = staged != 0;
  cudaError_t err;
  if (M <= 2) {
    err = launch<2>(x, out, nodes, M, nq, pre, post, s, st);
  } else if (M <= 4) {
    err = launch<4>(x, out, nodes, M, nq, pre, post, s, st);
  } else if (M <= 8) {
    err = launch<8>(x, out, nodes, M, nq, pre, post, s, st);
  } else if (M <= 16) {
    err = launch<16>(x, out, nodes, M, nq, pre, post, s, st);
  } else if (M <= 32) {
    err = launch<32>(x, out, nodes, M, nq, pre, post, s, st);
  } else {
    err = launch<64>(x, out, nodes, M, nq, pre, post, s, st);
  }
  return (int)err;
}
