"""Segment reduction over contiguous time segments: the resample kernel.

``da.resample(freq).{sum,mean,count,min,max,std,var}`` reduces a time-first
(T, C) float32 array over contiguous segments of the time axis (the months
of ``MS``, the years of ``YS``). :func:`segment_reduce_onepass` computes it
with the NaN rules of the reference's ``segment_reduce`` (skipna=True):

* on a CUDA tensor it launches the hand-written kernel ``csrc/segred.cu``
  (one thread per cell and segment, one read of the input, double
  accumulators) and raises if the launch fails;
* on a CPU tensor it runs :func:`segment_reduce_onepass_plain`, the plain
  PyTorch twin: a loop over the segments' slices with the same double
  accumulation.

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.utils.profiling import span

__all__ = ["SUPPORTED_OPS", "segment_reduce_onepass",
           "segment_reduce_onepass_plain"]

#: kernel launches made by segment_reduce_onepass
launches = 0
#: calls segment_reduce_onepass served with the plain twin (CPU tensors)
twin_calls = 0

#: ops the kernel serves, mapped to the statistics it keeps (the
#: reference's stat sets, xclim_tpu/ops/pallas/segred.py:51-56)
SUPPORTED_OPS = {
    "sum": "sum", "mean": "sum", "count": "sum",
    "min": "minmax", "max": "minmax",
    "std": "m2", "var": "m2",
}

#: op codes of csrc/segred.cu
_OP_CODES = {"count": 0, "sum": 1, "mean": 2, "min": 3, "max": 4, "var": 5,
             "std": 6}


def _check(x2: torch.Tensor, starts, counts, op: str):
    """(starts, counts) as int64 host arrays, after checking every input."""
    if op not in SUPPORTED_OPS:
        raise ValueError(f"segred serves {sorted(SUPPORTED_OPS)}, not {op!r}")
    if x2.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x2.dtype}")
    if x2.ndim != 2:
        raise ValueError(f"x must be (T, C), got shape {tuple(x2.shape)}")
    s = np.asarray(starts, dtype=np.int64)
    n = np.asarray(counts, dtype=np.int64)
    if s.shape != n.shape or s.ndim != 1:
        raise ValueError("starts and counts must be 1-D of one length")
    if len(s) and (s.min() < 0 or n.min() < 0
                   or (s + n).max() > x2.shape[0]):
        raise ValueError(f"segments exceed the time axis of {x2.shape[0]}")
    return s, n


def segment_reduce_onepass(x2: torch.Tensor, starts, counts,
                           op: str) -> torch.Tensor:
    """``op`` over the contiguous segments ``[starts[s], starts[s] +
    counts[s])`` of a time-first (T, C) float32 tensor.

    ``starts``/``counts`` are host integer sequences (a SegmentSpec's).
    Returns the (nseg, C) result on x2's device: float32, or
    int32 for ``count``. A segment with no valid value gives NaN (0 for
    ``count``); var and std are population statistics (ddof=0).
    """
    global launches, twin_calls
    with span("op.segred"):
        starts, counts = _check(x2, starts, counts, op)
        if x2.device.type == "cpu":
            twin_calls += 1
            return segment_reduce_onepass_plain(x2, starts, counts, op)
        if x2.device.type != "cuda":
            raise ValueError(f"no segred kernel for device {x2.device}")

        x = x2.contiguous()
        C = x.shape[1]
        nseg = len(starts)
        st, ct = (_build.device_copy(a.astype(np.int32).tobytes(),
                                     torch.int32, x.device)
                  for a in (starts, counts))
        dtype = torch.int32 if op == "count" else torch.float32
        out = torch.empty((nseg, C), dtype=dtype, device=x.device)
        if out.numel() == 0:
            return out
        _build.launch("segred", "xtt_segred", "ppppiii", x.device,
                      x.data_ptr(), st.data_ptr(), ct.data_ptr(),
                      out.data_ptr(), nseg, C, _OP_CODES[op])
        launches += 1
        return out


def segment_reduce_onepass_plain(x2: torch.Tensor, starts, counts,
                                 op: str) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on x2's device: one slice per
    segment, NaN-masked, summed in float64 and rounded to float32 once."""
    starts, counts = _check(x2, starts, counts, op)
    C = x2.shape[1]
    outs = []
    for a, n in zip(starts.tolist(), counts.tolist()):
        seg = x2[a:a + n]
        valid = ~torch.isnan(seg)
        cnt = valid.sum(dim=0, dtype=torch.int32)
        if op == "count":
            outs.append(cnt)
            continue
        if op == "min":
            o = torch.where(valid, seg, torch.inf).amin(dim=0) if n else \
                torch.full((C,), torch.inf, device=x2.device)
        elif op == "max":
            o = torch.where(valid, seg, -torch.inf).amax(dim=0) if n else \
                torch.full((C,), -torch.inf, device=x2.device)
        else:
            s = torch.where(valid, seg, 0.0).double().sum(dim=0)
            if op == "sum":
                o = s.float()
            elif op == "mean":
                o = s.float() / cnt.float()
            else:
                mu = s / cnt.clamp(min=1).double()
                d = torch.where(valid, seg.double() - mu, 0.0)
                var = ((d * d).sum(dim=0) / cnt.clamp(min=1).double()).float()
                o = var if op == "var" else torch.sqrt(var)
        outs.append(torch.where(cnt > 0, o, torch.nan))
    if not outs:
        dtype = torch.int32 if op == "count" else torch.float32
        return torch.empty((0, C), dtype=dtype, device=x2.device)
    return torch.stack(outs)
