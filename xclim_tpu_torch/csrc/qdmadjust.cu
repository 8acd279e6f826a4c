// QDM adjustment: per-doy empirical rank + adjustment-factor interpolation.
//
// Replaces: xclim_tpu/ops/pallas/qdmadjust.py, qdm_adjust_doy (Pallas
// kernel _kernel launched by pl.pallas_call in _call, with the host-side
// rank_weight_matrix fast path).
//
// What it computes: for each doy group g, cell c and year slot y, with
// x_y the slot's value (NaN = missing, Y <= 64 slots):
//   cnt  = #(x_j <= x_y, j valid)            upper-tie rank
//   tau  = cnt / max(n_valid, 1)             \
//   tc   = clip(tau, q[0], q[nq-1])           | brk[n_valid][cnt], from
//   hi   = clip(#(q <= tc), 1, nq-1)          | the wrapper
//   w    = clip((tc - q[hi-1]) / (q[hi]-q[hi-1] or 1), 0, 1)  /
//   af_v = af[hi-1] + w * (af[hi] - af[hi-1])    af (n_doy, nq, C)
//   out  = x + af_v  or  x * af_v            NaN in -> NaN out
// This is the reference's grouped_rank + interp_hat_nodes sequence
// (xclim_tpu/sdba/utils.py) for every lane; the TPU kernel's (Y, nq)
// hat-weight product for fully valid lanes is not carried over.
//
// Where the slots live: without a row table, x and out are the (n_doy, Y,
// C) doy slices and slot (g, y) is row g*Y + y. With a table rows (n_doy,
// Y) of int32 time indices (-1: no step), x and out are the (T, C) series:
// the kernel reads x[rows[g, y], c] and writes out[rows[g, y], c], so the
// group gather and the scatter back to the time axis cost no pass of their
// own. A table that holds every time step once (sdba's adjust table)
// writes every output row once. The doy slices compute their rows rather
// than read an identity table, whose load would sit before every x load
// of a block.
//
// What bounds it on the card: device memory. It reads x and af once and
// writes out once (~2.7 GB at 365 doys x 30 years x 16384 cells: 0.80 ms
// at 3.35 TB/s). The rank is Y^2 compares a (doy, cell), ~6 G at that
// shape, so it has to run from registers, not shared memory; and each
// slot's bracket has to be independent of the next slot's, so that the
// slots overlap.
//
// Design: one thread per (doy, cell), 128 neighbouring cells of one doy a
// block, so every global access of a warp is one 128-byte line; groups of
// more than 32 slots take four threads a cell (32 cells a block), each
// adjusting every fourth slot (one thread ranking up to 64 slots leaves
// few threads with long count chains on small grids).
//  * The block's (nq, cells) tile of af is copied into shared memory with
//    cp.async as the block starts (coalesced rows); the copy runs while
//    the thread loads its x column and ranks it. With a thread a cell,
//    each thread copies and reads only its own column of the tile (bank =
//    lane), so it waits for its own copies and no barrier is needed.
//    Where the tile does not fit (AF_SHARED false: many nodes), af[lo] and
//    af[hi] are read from global memory instead.
//  * The column's Y values sit in registers (YP = 8, 16, 32, 48 or 64, a
//    template parameter, NaN padded), and every slot's rank is an
//    unrolled compare-count over them, a count per slot in registers with
//    the samples in the outer loop (independent adds). Chunks of samples
//    past Y are skipped (Y is uniform, so the branches do not diverge).
//  * tau = cnt / n_valid takes at most (Y + 1)^2 values, so the bracket
//    hi and the weight w of every (n_valid, cnt) come from a table the
//    wrapper builds once per node set and Y (`brk`, int2: hi and the bits
//    of w; the same float32 ops, each rounded once, and the linear count
//    #(q <= tc)), read through the read-only cache. A bracket search per
//    slot (log2(nq) dependent shared loads, a data-dependent loop the
//    compiler does not overlap across slots) took more time than the
//    rank and the memory together.
//
// Rounding: every step is one IEEE float32 op written with __fmul_rn /
// __fadd_rn, so nvcc cannot contract any step into an FMA and the result
// is the reference's op sequence.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes zero and
// reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kChunk = 8;  // samples skipped together past Y

// Threads that share one cell's slots: wide groups (YP 48 and 64) split
// them over four threads, interleaved, so that no thread adjusts more than
// 16 slots.
template <int YP>
__host__ __device__ constexpr int threads_a_cell() {
  return YP > 32 ? 4 : 1;
}

template <int YP, bool AF_SHARED>
__global__ void __launch_bounds__(kThreads)
qdmadjust_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                 const float* __restrict__ af, const int2* __restrict__ brk,
                 float* __restrict__ out, int Y, int C, int nq, int mult) {
  constexpr int S = threads_a_cell<YP>();
  constexpr int CPB = kThreads / S;          // cells a block
  constexpr int SLOTS = YP / S;              // slots a thread adjusts
  extern __shared__ float smem[];
  int* rs = (int*)smem;                      // Y row indices
  float* afs = smem + Y;                     // (nq, CPB) factors

  const int t = threadIdx.x;
  const int ci = S == 1 ? t : t % CPB;       // the thread's cell ...
  const int sg = S == 1 ? 0 : t / CPB;       // ... and its slots sg + S*s
  const int g = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int c = c0 + ci;
  const bool live = c < C;
  const float* afg = af + (size_t)g * nq * C + (live ? c : 0);

  if (AF_SHARED) {
    // element e = k * CPB + j of the tile; with one thread a cell, thread
    // t copies its own column
    const float* afb = af + (size_t)g * nq * C + c0;
    for (int e = t; e < nq * CPB; e += kThreads) {
      const int k = e / CPB;
      const int j = e - k * CPB;
      const bool in = c0 + j < C;
      cp_async4(&afs[e], in ? afb + (size_t)k * C + j : af, in ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int y = t; y < Y; y += kThreads)
    rs[y] = rows != nullptr ? rows[(size_t)g * Y + y] : g * Y + y;
  __syncthreads();

  float v[YP];
  int nv = 0;
#pragma unroll
  for (int y = 0; y < YP; ++y) {
    float xv = NAN;
    if (y < Y && live) {
      const int r = rs[y];
      if (r >= 0) xv = x[(size_t)r * C + c];
    }
    v[y] = xv;
    nv += !isnan(xv);
  }
  // the thread's own slots (a second read of lines it has just loaded)
  float mine[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if constexpr (S == 1) {
      mine[s] = v[s];
    } else {
      const int y = sg + S * s;
      mine[s] = NAN;
      if (y < Y && live) {
        const int r = rs[y];
        if (r >= 0) mine[s] = x[(size_t)r * C + c];
      }
    }
  }

  // ranks: a count per slot in registers, the samples in the outer loop
  // so that every compare of a sample feeds another count (NaN compares
  // false: a NaN slot counts 0 and adds to no count). Chunks of samples
  // past Y are skipped: Y is the same for the whole grid, so the branch
  // does not diverge
  unsigned cnt[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) cnt[s] = 0;
#pragma unroll
  for (int j0 = 0; j0 < YP; j0 += kChunk) {
    if (j0 < Y) {
#pragma unroll
      for (int j = j0; j < j0 + kChunk && j < YP; ++j) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) cnt[s] += v[j] <= mine[s];
      }
    }
  }

  if (AF_SHARED) {
    cp_async_wait_all();
    if (S > 1) __syncthreads();  // the tile holds other threads' copies
  }
  if (!live) return;
  const int2* brk_nv = brk + nv * (Y + 1);

#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int y = sg + S * s;
    if (y < Y) {
      const int r = rs[y];
      if (r >= 0) {
        const float xi = mine[s];
        float res = NAN;
        if (!isnan(xi)) {
          const int2 b = __ldg(&brk_nv[cnt[s]]);
          const int hi = b.x;
          const int lo = hi - 1;
          const float w = __int_as_float(b.y);
          float y0, y1;
          if (AF_SHARED) {
            y0 = afs[lo * CPB + ci];
            y1 = afs[hi * CPB + ci];
          } else {
            y0 = afg[(size_t)lo * C];
            y1 = afg[(size_t)hi * C];
          }
          const float afv = __fadd_rn(y0, __fmul_rn(w, __fsub_rn(y1, y0)));
          res = mult ? __fmul_rn(xi, afv) : __fadd_rn(xi, afv);
        }
        out[(size_t)r * C + c] = res;
      }
    }
  }
}

template <int YP>
cudaError_t launch(const float* x, const int* rows, const float* af,
                   const int2* brk, float* out, int n_doy, int Y, int C,
                   int nq, int mult, int af_shared, cudaStream_t stream) {
  constexpr int CPB = kThreads / threads_a_cell<YP>();
  const dim3 grid((C + CPB - 1) / CPB, n_doy);
  size_t smem = (size_t)Y * sizeof(int);
  if (af_shared) {
    smem += (size_t)nq * CPB * sizeof(float);
    qdmadjust_kernel<YP, true><<<grid, kThreads, smem, stream>>>(
        x, rows, af, brk, out, Y, C, nq, mult);
  } else {
    qdmadjust_kernel<YP, false><<<grid, kThreads, smem, stream>>>(
        x, rows, af, brk, out, Y, C, nq, mult);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for Y outside 1..64. rows: (n_doy, Y) int32 time
// indices (-1: none) with x and out (T, C), or NULL with x and out (n_doy,
// Y, C). brk: (Y + 1, Y + 1) int2, entry [n_valid][cnt] = (hi, bits of w).
// mult: 0 for kind "+", 1 for kind "*". af_shared: 1 stages the (nq,
// cells) factor tile in shared memory (the wrapper asks for it only when
// nq * cells + Y words fit in 48 KB; cells = 128, or 32 above 32 slots), 0
// reads factors from global memory.
extern "C" int xtt_qdmadjust(const float* x, const int* rows, const float* af,
                             const int* brk, float* out, int n_doy, int Y,
                             int C, int nq, int mult, int af_shared,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int2* b = (const int2*)brk;
  if (Y < 1 || Y > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (Y <= 8) {
    err = launch<8>(x, rows, af, b, out, n_doy, Y, C, nq, mult, af_shared, st);
  } else if (Y <= 16) {
    err = launch<16>(x, rows, af, b, out, n_doy, Y, C, nq, mult, af_shared,
                     st);
  } else if (Y <= 32) {
    err = launch<32>(x, rows, af, b, out, n_doy, Y, C, nq, mult, af_shared,
                     st);
  } else if (Y <= 48) {
    err = launch<48>(x, rows, af, b, out, n_doy, Y, C, nq, mult, af_shared,
                     st);
  } else {
    err = launch<64>(x, rows, af, b, out, n_doy, Y, C, nq, mult, af_shared,
                     st);
  }
  return (int)err;
}
