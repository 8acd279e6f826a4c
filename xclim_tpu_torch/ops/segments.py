"""Segment-reduction engine: ``resample(time=freq).op`` over a time axis.

Counterpart of the reference's ``xclim_tpu/ops/segments.py`` (xarray's
``resample`` / ``resample_map``, xclim:src/xclim/indices/helpers.py:898-976).
The host describes the grouping as a
:class:`~xclim_tpu_torch.core.calendar.SegmentSpec`; the device reduces.

Dispatch of :func:`segment_reduce`:

* a floating-point input with a contiguous spec (every ``resample`` spec)
  and an op of :data:`~xclim_tpu_torch.ops.segred.SUPPORTED_OPS`, NaN-skipping,
  goes to :func:`~xclim_tpu_torch.ops.segred.segment_reduce_onepass`: the
  ``segred`` CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor;
* everything else (median, prod, any, all, integer input, ``skipna=False``,
  non-contiguous specs such as doy groups) takes the plain torch path: one
  gather of the time axis into a (nseg, maxlen, ...) block, -1 padded, and
  a masked dense reduction.

The time axis may be any axis. All reductions skip NaN unless
``skipna=False`` (xarray's default). :func:`rolling_reduce` opens the
program span ``rolling.reduce``.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import SegmentSpec
from xclim_tpu_torch.ops import segred
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import span

__all__ = [
    "build_gather_table",
    "segment_reduce",
    "segment_argminmax",
    "segment_first_last",
    "rolling_reduce",
    "weighted_window_sum",
]


def build_gather_table(spec: SegmentSpec) -> np.ndarray:
    """(nseg, maxlen) int32 table of time indices per segment, -1 padded.

    Cached on the SegmentSpec object itself (host-side, cheap).
    """
    tbl = getattr(spec, "_gather_table", None)
    if tbl is not None:
        return tbl
    nseg = spec.nseg
    maxlen = int(spec.counts.max()) if nseg else 0
    tbl = np.full((nseg, maxlen), -1, dtype=np.int32)
    order = np.arange(len(spec.seg_id), dtype=np.int32)
    within = order - spec.starts[spec.seg_id]
    tbl[spec.seg_id, within] = order
    spec._gather_table = tbl
    return tbl


def _segments_contiguous(spec: SegmentSpec) -> bool:
    """Whether segments tile the time axis contiguously in order (true for
    every resample_segments spec)."""
    flag = getattr(spec, "_contiguous", None)
    if flag is None:
        starts = np.asarray(spec.starts, dtype=np.int64)
        counts = np.asarray(spec.counts, dtype=np.int64)
        flag = bool(
            len(starts)
            and starts[0] == 0
            and np.all(starts[1:] == starts[:-1] + counts[:-1])
            and starts[-1] + counts[-1] == len(spec.seg_id))
        spec._contiguous = flag
    return flag


def _gather_segments(x: torch.Tensor, table: np.ndarray, axis: int):
    """x (time on `axis`) gathered into (nseg, maxlen, ...) plus the (nseg,
    maxlen, 1, ...) mask of real (not padding) slots."""
    xf = x.movedim(axis, 0)
    t = torch.as_tensor(table, dtype=torch.int64, device=x.device)
    g = xf[t.clamp(min=0)]
    pad_ok = (t >= 0).reshape(t.shape + (1,) * (g.ndim - 2))
    return g, pad_ok


def _int_result(out: torch.Tensor) -> torch.Tensor:
    """Integer sums and products as int32, the reference's default integer
    type (torch widens them to int64)."""
    return out.to(torch.int32)


def segment_reduce(x: torch.Tensor, spec: SegmentSpec, op: str, axis: int = 0,
                   skipna: bool = True) -> torch.Tensor:
    """resample(time=freq).op(...) over the given axis.

    Parameters
    ----------
    x : tensor with time on `axis`
    spec : SegmentSpec from resample_segments
    op : one of sum/mean/max/min/count/any/all/std/var/median/prod
    skipna : NaN-skipping reduction (xarray default)

    Returns a tensor with the time axis replaced by the segment axis
    (length nseg), on x's device. ``count`` gives int32; std/var use
    ddof=0.
    """
    T = x.shape[axis]
    isfloat = x.is_floating_point()
    if (op in segred.SUPPORTED_OPS and isfloat and skipna
            and T == len(spec.seg_id) and _segments_contiguous(spec)):
        xf = x.movedim(axis, 0)
        # a view when time is the leading axis of a contiguous tensor
        x2 = xf.reshape(T, -1).to(torch.float32)
        out = segred.segment_reduce_onepass(x2, spec.starts, spec.counts, op)
        return out.reshape((spec.nseg,) + xf.shape[1:]).movedim(0, axis)

    table = build_gather_table(spec)
    g, pad_ok = _gather_segments(x, table, axis)
    if isfloat and skipna:
        valid = pad_ok & ~torch.isnan(g)
    else:
        valid = pad_ok.expand(g.shape)

    if op == "count":
        out = valid.sum(dim=1, dtype=torch.int32)
    elif op in ("sum", "mean"):
        s = torch.where(valid, g, 0).sum(dim=1)
        if not isfloat:
            s = _int_result(s)
        if op == "sum":
            out = s
        else:
            n = valid.sum(dim=1)
            out = s / n.clamp(min=1)
        if isfloat:
            out = torch.where(valid.any(dim=1), out, torch.nan)
    elif op == "prod":
        out = torch.where(valid, g, 1).prod(dim=1)
        if not isfloat:
            out = _int_result(out)
    elif op in ("max", "min"):
        if g.dtype == torch.bool:
            out = (g & valid).any(dim=1) if op == "max" else \
                (g | ~valid).all(dim=1)
        else:
            fill = -torch.inf if op == "max" else torch.inf
            if not isfloat:
                info = torch.iinfo(g.dtype)
                fill = info.min if op == "max" else info.max
            gm = torch.where(valid, g, fill)
            out = gm.amax(dim=1) if op == "max" else gm.amin(dim=1)
            if isfloat:
                out = torch.where(valid.any(dim=1), out, torch.nan)
    elif op == "any":
        out = torch.where(valid, g != 0, False).any(dim=1)
    elif op == "all":
        out = torch.where(valid, g != 0, True).all(dim=1)
    elif op in ("std", "var"):
        gf = g.to(torch.float32)
        n = valid.sum(dim=1)
        s = torch.where(valid, gf, 0.0).sum(dim=1)
        mu = s / n.clamp(min=1)
        d2 = torch.where(valid, (gf - mu.unsqueeze(1)) ** 2, 0.0).sum(dim=1)
        var = d2 / n.clamp(min=1)
        out = torch.where(n > 0, var if op == "var" else torch.sqrt(var),
                          torch.nan)
    elif op == "median":
        gm = torch.where(valid, g.to(torch.float32), torch.nan)
        out = nan_quantile(gm, [0.5], axis=1)[0]
    else:
        raise ValueError(f"Unknown segment op {op!r}")
    return out.movedim(0, axis)


def segment_argminmax(x: torch.Tensor, spec: SegmentSpec, op: str = "max",
                      axis: int = 0):
    """Absolute time index of the per-segment extreme (NaN-skipping).

    Returns (idx, has_valid): idx int32 (segments on `axis`), an index into
    the original time axis, -1 where a segment has no valid value. Ties go
    to the first occurrence.
    """
    table = build_gather_table(spec)
    g, pad_ok = _gather_segments(x, table, axis)
    valid = pad_ok & ~torch.isnan(g)
    fill = -torch.inf if op == "max" else torch.inf
    gm = torch.where(valid, g, fill)
    rel = gm.argmax(dim=1) if op == "max" else gm.argmin(dim=1)
    tbl = torch.as_tensor(table, dtype=torch.int64, device=x.device)
    tbl = tbl.reshape(tbl.shape + (1,) * (g.ndim - 2)).expand(g.shape)
    absidx = tbl.gather(1, rel.unsqueeze(1)).squeeze(1).to(torch.int32)
    has = valid.any(dim=1)
    absidx = torch.where(has, absidx, -1)
    return absidx.movedim(0, axis), has.movedim(0, axis)


def segment_first_last(x: torch.Tensor, spec: SegmentSpec,
                       which: str = "first", axis: int = 0) -> torch.Tensor:
    """First/last non-NaN value per segment (NaN where there is none)."""
    table = build_gather_table(spec)
    g, pad_ok = _gather_segments(x, table, axis)
    isfloat = g.is_floating_point()
    valid = pad_ok & ~torch.isnan(g) if isfloat else pad_ok.expand(g.shape)
    maxlen = g.shape[1]
    pos = torch.arange(maxlen, device=x.device).reshape(
        (1, maxlen) + (1,) * (g.ndim - 2))
    if which == "first":
        rel = torch.where(valid, pos, maxlen).amin(dim=1).clamp(max=maxlen - 1)
    else:
        rel = torch.where(valid, pos, -1).amax(dim=1).clamp(min=0)
    out = g.gather(1, rel.unsqueeze(1)).squeeze(1)
    if isfloat:
        out = torch.where(valid.any(dim=1), out, torch.nan)
    return out.movedim(0, axis)


@span("rolling.reduce")
def rolling_reduce(x: torch.Tensor, window: int, op: str, axis: int = 0,
                   min_periods: int | None = None,
                   center: bool = False) -> torch.Tensor:
    """Rolling-window reduction along `axis`, with the semantics of the
    reference's ``lax.reduce_window`` version (xarray rolling): the output
    is aligned to the window's end (or centre), each window is reduced on
    its own (no cumulative sum carries error along the axis), and positions
    with fewer than `min_periods` valid values are NaN.
    """
    if min_periods is None:
        min_periods = window
    xf = x.movedim(axis, -1)
    isfloat = xf.is_floating_point()
    valid = ~torch.isnan(xf) if isfloat else torch.ones_like(xf,
                                                             dtype=torch.bool)
    if center:
        lo = (window - 1) // 2
        pad = (lo, window - 1 - lo)
    else:
        pad = (window - 1, 0)

    def windows(arr, fill):
        """(..., T, window) view of arr padded with `fill` at the ends."""
        return torch.nn.functional.pad(arr, pad, value=fill).unfold(
            -1, window, 1)

    xv = xf.to(torch.float32)
    cnt = windows(valid.to(torch.float32), 0.0).sum(dim=-1)
    if op in ("sum", "mean"):
        s = windows(torch.where(valid, xv, 0.0), 0.0).sum(dim=-1)
        out = s if op == "sum" else s / cnt.clamp(min=1)
    elif op == "max":
        out = windows(torch.where(valid, xv, -torch.inf), -torch.inf).amax(
            dim=-1)
    elif op == "min":
        out = windows(torch.where(valid, xv, torch.inf), torch.inf).amin(
            dim=-1)
    elif op in ("std", "var"):
        s = windows(torch.where(valid, xv, 0.0), 0.0).sum(dim=-1)
        mu = s / cnt.clamp(min=1)
        s2 = windows(torch.where(valid, xv * xv, 0.0), 0.0).sum(dim=-1)
        var = (s2 / cnt.clamp(min=1) - mu * mu).clamp(min=0.0)
        out = var if op == "var" else torch.sqrt(var)
    else:
        raise ValueError(f"Unknown rolling op {op!r}")
    out = torch.where(cnt >= min_periods, out, torch.nan)
    return out.movedim(-1, axis)


def weighted_window_sum(x: torch.Tensor, axis: int, w: np.ndarray,
                        before: int, after: int) -> torch.Tensor:
    """sum_k x[t - before + k] * w[k] along `axis`, NaN-padded past the
    ends: the reference's gathered window and its sum over it, added from
    k = 0 up, one shifted pass per weight."""
    xm = torch.movedim(x, axis, -1)
    T = xm.shape[-1]
    xp = torch.nn.functional.pad(xm, (before, after), value=float("nan"))
    out = torch.zeros_like(xm)
    for k, wk in enumerate(np.asarray(w, dtype=np.float32)):
        out = out + xp[..., k:k + T] * float(wk)
    return torch.movedim(out, -1, axis)
