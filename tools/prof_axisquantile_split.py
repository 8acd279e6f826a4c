"""Load / network split of the axisquantile CUDA kernel on the card.

A scratch copy of the kernel, kept out of the package: this script writes
a CUDA source that includes ``xclim_tpu_torch/csrc/axisquantile.cu`` and
adds two variants of its direct route (one thread a column, each thread
loading its own column), builds it with nvcc into the git-ignored
``xclim_tpu_torch/_build/``, and times with CUDA events:

* ``load``: the column's loads and valid count, the count written to
  every node (no sort);
* ``network``: the sorting network and node selection on columns made in
  registers from their index (no loads; the output stores stay);
* ``direct`` and ``staged``: the shipped kernel by each load route.

``load`` and ``network`` against ``direct`` say whether the loads, the
network or their overlap hold a thread that loads and then sorts back.

    python tools/prof_axisquantile_split.py [--lat 192 --lon 448]

runs at the ensembles slice's shape (30 members x 365 days x 192 x 448
cells, reduced over the members, nodes 0.1 / 0.5 / 0.9) on random members
with 1 % missing, checks ``load`` against the valid count and the two
routes against each other (value-equal), and prints one JSON line of
milliseconds with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from xclim_tpu_torch.ops import _build  # noqa: E402
from xclim_tpu_torch.ops.quantile import _node_constants  # noqa: E402

SPLIT_SRC = r"""
#include "%(kernel)s"

namespace {

// A column of M samples made in registers from its index.
__device__ __forceinline__ float made(long long col, int m) {
  const unsigned h = (unsigned)col * 2654435761u + (unsigned)m * 40503u;
  return (float)(h >> 8);
}

// The direct route with the sort left out (LOAD) or the loads (!LOAD).
template <int MP, bool LOAD>
__global__ void __launch_bounds__(kThreads)
split_direct(const float* __restrict__ x, float* __restrict__ out,
             const float* __restrict__ nodes, int M, int nq,
             long long post, long long cols) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const long long p = col / post;
  const float* src = x + (size_t)p * M * post + (col - p * post);
  float v[MP];
  int n = 0;
#pragma unroll
  for (int m = 0; m < MP; ++m)
    v[m] = take(LOAD ? (m < M ? src[(size_t)m * post] : 0.0f) : made(col, m),
                m, M, n);
  if (LOAD) {
    for (int q = 0; q < nq; ++q) out[(size_t)q * cols + col] = (float)n;
    return;
  }
  column_quantiles<MP>(v, n, nodes, nq, out, col, cols);
}

}  // namespace

// M from 17 to 32 (the ensemble's 30 members); load: 1 loads, 0 sorts.
extern "C" int xtt_axisquantile_split(const float* x, float* out,
                                      const float* nodes, int M, int nq,
                                      long long pre, long long post,
                                      int load, void* stream) {
  if (M < 17 || M > 32) return (int)cudaErrorInvalidValue;
  const long long cols = pre * post;
  const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (load)
    split_direct<32, true><<<blocks, kThreads, 0, st>>>(x, out, nodes, M, nq,
                                                        post, cols);
  else
    split_direct<32, false><<<blocks, kThreads, 0, st>>>(x, out, nodes, M,
                                                         nq, post, cols);
  return (int)cudaGetLastError();
}
"""

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
         + [ctypes.c_int, ctypes.c_void_p])


def _split_function():
    """Builds (once per kernel source) and loads the split variants."""
    kernel = _build.source("axisquantile")
    src = SPLIT_SRC % {"kernel": kernel}
    digest = hashlib.sha256(src.encode() + kernel.read_bytes()).hexdigest()
    out_dir = kernel.parent.parent / "_build"
    so = out_dir / f"libaxisquantile_split-{digest[:16]}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], check=True)
    fn = ctypes.CDLL(str(so)).xtt_axisquantile_split
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def _ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def split_times(x: torch.Tensor, q) -> dict:
    """Milliseconds of the load and network variants and of the shipped
    kernel's two routes over axis 0 of the contiguous CUDA tensor ``x``
    (alpha = beta = 1); raises if a check fails."""
    qv, coff = _node_constants(np.asarray(q, np.float32), 1.0, 1.0)
    nodes = torch.as_tensor(np.concatenate([qv, coff]), device=x.device)
    M, post = x.shape[0], x[0].numel()
    out = torch.empty((len(qv), post), dtype=torch.float32, device=x.device)
    split = _split_function()
    shipped = _build.function("axisquantile", "xtt_axisquantile", "pppiiqqip")
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run(fn, flag):
        err = fn(x.data_ptr(), out.data_ptr(), nodes.data_ptr(), M, len(qv),
                 1, post, flag, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    run(split, 1)
    count = (~torch.isnan(x)).sum(dim=0).reshape(-1).float()
    if not all(torch.equal(row, count) for row in out):
        raise AssertionError("load variant: counts differ")
    run(shipped, 0)
    direct = out.clone()
    run(shipped, 1)
    if not torch.equal(torch.isnan(out), torch.isnan(direct)) or not \
            torch.equal(torch.nan_to_num(out), torch.nan_to_num(direct)):
        raise AssertionError("the two routes differ")
    return {"load": _ms(lambda: run(split, 1)),
            "network": _ms(lambda: run(split, 0)),
            "direct": _ms(lambda: run(shipped, 0)),
            "staged": _ms(lambda: run(shipped, 1))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=30)
    ap.add_argument("--days", type=int, default=365)
    ap.add_argument("--lat", type=int, default=192)
    ap.add_argument("--lon", type=int, default=448)
    ap.add_argument("--seed", type=int, default=1981)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_axisquantile_split: no CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    shape = (args.members, args.days, args.lat, args.lon)
    x = torch.randn(shape, generator=gen, device="cuda") * 5.0 + 285.0
    x = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.01,
                    torch.nan, x)
    print(json.dumps({"shape": list(shape),
                      "device": torch.cuda.get_device_name(0),
                      "ms": split_times(x, [0.1, 0.5, 0.9])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
