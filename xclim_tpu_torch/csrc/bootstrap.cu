// Year-replaced quantiles of the Zhang-2005 bootstrap, from the candidate
// tables.
//
// Replaces: no Pallas kernel. The reference computes these quantiles with
// plain jnp ops (xclim_tpu/ops/bootstrap.py, merge_rank_replaced_year_quantile
// and topk_replaced_year_quantile); the port's twin is the torch sequence of
// xclim_tpu_torch/ops/bootstrap.py, merge_rank_replaced_year_quantile_plain,
// which ran as ~80 eager ops an in-base year and materialised (O, n_doy, C,
// w + 1) index, gather and where tensors for every replacement. This kernel
// was added because that sequence held ~96 % of the bootstrap's device time.
//
// What it computes: for one removed year b, one quantile q and each lane
// (doy, cell) with its candidate table (the K largest samples, descending,
// or the K smallest negated, with each sample's year), valid count nvalid
// and the removed year's w samples A_b, for each replacement o:
//   nmod = nvalid - #valid(A_b) + #valid(A_o)
//   h    = clip(nmod*q + (q*(1-a-b)+a) - 1, 0, max(nmod-1, 0))
//   k0 = floor(h), gam = h - k0, k1 = min(k0 + 1, max(nmod - 1, 0))
//   v_k  = the k-th order statistic of the year-replaced multiset, read as
//          the j-th largest (top table) or smallest (bottom table) of
//          (table minus year b) merged with A_o's samples (merge path)
//   out  = v0 + gam*(v1 - v0); NaN where nmod <= 0 or the merge runs dry
// bit for bit as the twin: every float32 step is one rounding (__fmul_rn,
// __fadd_rn, __fsub_rn, so nvcc contracts nothing into an FMA), the sorted
// added samples are the same multiset (an odd-even transposition network,
// NaN and +-inf mapped to -inf), and each order statistic is a value of
// that multiset.
//
// Where the samples live: A_b at ab + d*ab_sd + s*ab_ss + c*ab_sc and the
// replacements at ao + y*ao_so + d*ao_sd + s*ao_ss + c*ao_sc, y = o, or o + 1
// from o = skip on. The bootstrap hands the in-base sample tensor (n_doy,
// nyears, w, C) itself, with skip = b, so the other years are read in place
// (no copy of them) and a warp's 32 cells are one 128-byte line.
//
// What bounds it on the card: device memory. At the benchmark's shape (365
// doys, 30 years, w 5, 4096 cells, K 23) a launch reads the sample tensor
// (0.90 GB), one table with its year tags (0.28 GB) and writes (29, 365,
// 4096) float32 (0.17 GB): 1.35 GB, 0.40 ms at 3.35 TB/s. The arithmetic
// is ~100 instructions a (lane, replacement).
//
// Design: one thread a lane, 128 consecutive lanes a block (cells
// innermost). The thread compacts its table minus year b once, into its
// own column of shared memory (slot r of thread t at r*128 + t: every
// access is bank-conflict free whatever slot each thread reads), then loops
// over the replacements: the w added samples are loaded, mapped and sorted
// in registers (WP = w up to 8, else 16 with -inf padding, which sorts to
// the end), and each of the two order statistics is the max over the w + 1
// merge-path splits t of min(kept[j - t], added[t - 1]), w + 1 shared
// reads. Where the table (K > 96 slots: 48 KB a block) or the window (w >
// 16) outgrows that, the caller hands a scratch buffer and the second
// instance keeps the compacted table and the added samples there
// (slot-major, lanes innermost) and sorts with the same network in a loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const float* tab;    // (lanes, K) candidate values
  const int* tyear;    // (lanes, K) their years
  const int* nvalid;   // (lanes,)
  const float* ab;     // removed year's samples (strided)
  const float* ao;     // replacements' samples (strided)
  float* out;          // (O, lanes)
  float* scratch;      // (K + w, lanes), global instance only
  long long lanes;
  long long ab_sd, ab_ss, ab_sc;
  long long ao_so, ao_sd, ao_ss, ao_sc;
  int C, K, w, O, skip, b, top;
  float qf, cq;        // float32(q), float32(q*(1-alpha-beta)+alpha)
};

template <int WP>
__device__ __forceinline__ void sort_desc(float (&x)[WP]) {
#pragma unroll
  for (int r = 0; r < WP; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < WP; i += 2) {
      const float hi = fmaxf(x[i], x[i + 1]);
      const float lo = fminf(x[i], x[i + 1]);
      x[i] = hi;
      x[i + 1] = lo;
    }
  }
}

// kept[i] for a merge-path split: +inf before the table, -inf past its n
// entries
__device__ __forceinline__ float kept_at(const float* kept, size_t ks, int n,
                                         int i) {
  return i < 0 ? INFINITY : (i < n ? kept[(size_t)i * ks] : -INFINITY);
}

// the j-th largest (0-based) of kept (n entries, descending) and the sorted
// added samples in registers
template <int WP>
__device__ __forceinline__ float merged(const float* kept, size_t ks, int n,
                                        const float (&x)[WP], int w, int j) {
  float m = kept_at(kept, ks, n, j);
#pragma unroll
  for (int t = 1; t <= WP; ++t) {
    if (t <= w) m = fmaxf(m, fminf(kept_at(kept, ks, n, j - t), x[t - 1]));
  }
  return m;
}

// the same with the added samples in global scratch (stride st)
__device__ __forceinline__ float merged_global(const float* kept, size_t ks,
                                               int n, const float* add,
                                               size_t st, int w, int j) {
  float m = kept_at(kept, ks, n, j);
  for (int t = 1; t <= w; ++t)
    m = fmaxf(m, fminf(kept_at(kept, ks, n, j - t), add[(size_t)(t - 1) * st]));
  return m;
}

// the sample mapped for the sort: NaN and +-inf -> -inf, the bottom table's
// side negated
__device__ __forceinline__ float added_value(float y, int top) {
  return (isnan(y) || isinf(y)) ? -INFINITY : (top ? y : -y);
}

// WP > 0: shared-memory table, added samples in WP registers; WP == 0:
// table and added samples in global scratch
template <int WP>
__global__ void __launch_bounds__(kThreads) bootstrap_kernel(const Args a) {
  extern __shared__ float smem[];
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.lanes) return;
  const long long d = lane / a.C;
  const long long c = lane - d * a.C;

  float* kept;
  size_t ks;
  if constexpr (WP > 0) {
    kept = smem + threadIdx.x;
    ks = kThreads;
  } else {
    kept = a.scratch + lane;
    ks = (size_t)a.lanes;
  }

  // the lane's table without year b and without infinite entries, compacted
  // to the front (descending, as the table)
  const float* tv = a.tab + (size_t)lane * a.K;
  const int* ty = a.tyear + (size_t)lane * a.K;
  int n = 0;
  for (int r = 0; r < a.K; ++r) {
    const float v = a.top ? tv[r] : -tv[r];
    if (ty[r] != a.b && !isinf(v)) {
      kept[(size_t)n * ks] = v;
      ++n;
    }
  }

  const float* pb = a.ab + d * a.ab_sd + c * a.ab_sc;
  int vb = 0;
  for (int s = 0; s < a.w; ++s) vb += !isnan(pb[s * a.ab_ss]);
  const int nrest = a.nvalid[lane] - vb;
  const float* po = a.ao + d * a.ao_sd + c * a.ao_sc;

  for (int o = 0; o < a.O; ++o) {
    const float* p = po + (long long)(o + (o >= a.skip)) * a.ao_so;
    int vo = 0;
    float x[WP > 0 ? WP : 1];
    float* add = nullptr;
    const size_t st = (size_t)a.lanes;
    if constexpr (WP > 0) {
#pragma unroll
      for (int s = 0; s < WP; ++s) {
        float v = -INFINITY;
        if (s < a.w) {
          const float y = p[s * a.ao_ss];
          vo += !isnan(y);
          v = added_value(y, a.top);
        }
        x[s] = v;
      }
      sort_desc<WP>(x);
    } else {
      add = a.scratch + (size_t)a.K * st + lane;
      for (int s = 0; s < a.w; ++s) {
        const float y = p[s * a.ao_ss];
        vo += !isnan(y);
        add[(size_t)s * st] = added_value(y, a.top);
      }
      for (int r = 0; r < a.w; ++r) {
        for (int i = r & 1; i + 1 < a.w; i += 2) {
          const float u = add[(size_t)i * st];
          const float v = add[(size_t)(i + 1) * st];
          add[(size_t)i * st] = fmaxf(u, v);
          add[(size_t)(i + 1) * st] = fminf(u, v);
        }
      }
    }

    const int nmod = nrest + vo;
    const float nf = (float)nmod;
    float h = __fsub_rn(__fadd_rn(__fmul_rn(nf, a.qf), a.cq), 1.0f);
    h = fminf(fmaxf(h, 0.0f), fmaxf(__fsub_rn(nf, 1.0f), 0.0f));
    const int k0 = (int)floorf(h);
    const float gam = __fsub_rn(h, (float)k0);
    const int k1 = min(k0 + 1, max(nmod - 1, 0));
    const int j0 = max(a.top ? nmod - 1 - k0 : k0, 0);
    const int j1 = max(a.top ? nmod - 1 - k1 : k1, 0);

    float m0, m1;
    if constexpr (WP > 0) {
      m0 = merged<WP>(kept, ks, n, x, a.w, j0);
      m1 = merged<WP>(kept, ks, n, x, a.w, j1);
    } else {
      m0 = merged_global(kept, ks, n, add, st, a.w, j0);
      m1 = merged_global(kept, ks, n, add, st, a.w, j1);
    }
    float res = NAN;
    if (nmod > 0 && m0 > -INFINITY && m1 > -INFINITY) {
      const float v0 = a.top ? m0 : -m0;
      const float v1 = a.top ? m1 : -m1;
      res = __fadd_rn(v0, __fmul_rn(gam, __fsub_rn(v1, v0)));
    }
    a.out[(size_t)o * st + lane] = res;
  }
}

template <int WP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.lanes + kThreads - 1) / kThreads;
  const size_t smem = WP > 0 ? (size_t)a.K * kThreads * sizeof(float) : 0;
  bootstrap_kernel<WP><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, 0 without
// a launch where there is nothing to compute, or cudaErrorInvalidValue for
// arguments the instances do not take. tab, tyear: (lanes, K) contiguous,
// the top table (top = 1) or the bottom one (top = 0, negated by the
// kernel); nvalid (lanes,) int32; lane = d*C + c; out (O, lanes). The
// caller picks the instance (ops/bootstrap.py, table_in_shared): scratch
// NULL keeps the table in shared memory (K * 512 bytes a block, so a launch
// past 48 KB fails) and sorts up to 16 samples in registers; else scratch
// holds (K + w) * lanes floats.
extern "C" int xtt_bootstrap(const float* tab, const int* tyear,
                             const int* nvalid, const float* ab,
                             const float* ao, float* out, float* scratch,
                             long long lanes, int C, int K, int w, int O,
                             int skip, int b, int top, float qf, float cq,
                             long long ab_sd, long long ab_ss,
                             long long ab_sc, long long ao_so,
                             long long ao_sd, long long ao_ss,
                             long long ao_sc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes <= 0 || O <= 0) return 0;
  if (C < 1 || K < 1 || w < 1 ||
      (lanes + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{tab,   tyear, nvalid, ab,    ao,    out,   scratch,
               lanes, ab_sd, ab_ss,  ab_sc, ao_so, ao_sd, ao_ss,
               ao_sc, C,     K,      w,     O,     skip,  b,
               top,   qf,    cq};
  if (scratch != nullptr) return (int)launch<0>(a, st);
  switch (w) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    case 4: return (int)launch<4>(a, st);
    case 5: return (int)launch<5>(a, st);
    case 6: return (int)launch<6>(a, st);
    case 7: return (int)launch<7>(a, st);
    case 8: return (int)launch<8>(a, st);
    default:
      return w <= 16 ? (int)launch<16>(a, st) : (int)cudaErrorInvalidValue;
  }
}
