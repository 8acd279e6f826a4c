"""Run-length engine: spell statistics over the time axis, as plain torch.

Counterpart of the reference's ``xclim_tpu/ops/runlength.py`` (xclim's
run_length.py). No loop runs over time:

* run lengths of a bool series come from a running maximum of break
  positions (the run at t is t minus the last False day before it, or the
  day before a reset);
* the float ``cumsum_reset`` is a float64 cumulative sum minus its value at
  the last reset, rounded to float32 once. The reference scans sequentially
  in float32, so float run sums differ from it by the float32 rounding of
  each step (within ~n ulp for a run of n values); integer and bool inputs
  give exact results.

Dispatch: every spell statistic (``longest_run``, ``windowed_run_count``,
``windowed_run_events``, and ``rle_statistics`` with ``max`` or ``sum``)
with a segment spec that tiles the time axis and
``resample_before_rl=True`` goes to
:func:`~xclim_tpu_torch.ops.spells.spell_stats`: the ``spells`` CUDA kernel
on a CUDA tensor, its plain twin on a CPU tensor. The rest takes the plain
torch path below, which follows the reference's XLA route.

Tracing: the run statistics (``rle_statistics``, ``longest_run``,
``windowed_run_count``, ``windowed_run_events``, ``windowed_max_run_sum``,
``first_run``, ``last_run``) each open the program span
``runlength.runs``. One never opens inside another: an entry that needs
another's work calls its body (``__wrapped__``, or ``_boundary_run``), so
each device operation is counted to one such span.

Semantics (the reference's, verified against xclim):

* ``rle(index='first')`` puts each run's total length on its FIRST element,
  NaN on other run elements, 0 on False positions;
* resampling run statistics attributes a boundary-crossing run entirely to
  the period holding the marked element (resample after the rle);
* NaN inputs are False.

Convention: `axis` is the time axis; arrays may have any rank.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import SegmentSpec
from xclim_tpu_torch.ops import spells
from xclim_tpu_torch.ops.quantile import _nanmedian, _nanstd, nan_quantile
from xclim_tpu_torch.ops.segments import (
    _segments_contiguous,
    build_gather_table,
    segment_reduce,
)
from xclim_tpu_torch.utils.profiling import span

__all__ = [
    "cumsum_reset",
    "rle",
    "rle_statistics",
    "longest_run",
    "windowed_run_count",
    "windowed_run_events",
    "windowed_max_run_sum",
    "first_run",
    "last_run",
    "suspicious_run",
]

#: the program span of every run statistic
RUNS_SPAN = "runlength.runs"


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (T,) tensor shaped (T, 1, ...) against a time-first array."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def segment_boundaries(spec: SegmentSpec, index: str = "last",
                       device=None) -> torch.Tensor:
    """(T,) bool mask of positions where a scan must reset so runs don't
    cross resample periods (resample-before-run-length, xclim
    run_length.py:87-133). For backward scans (index='first') it marks the
    segment ends instead of the starts."""
    n = len(spec.seg_id)
    m = np.zeros(n, dtype=bool)
    if index == "last":
        m[spec.starts] = True
    else:
        m[np.concatenate([spec.starts[1:] - 1, [n - 1]])] = True
    return torch.as_tensor(m, device=device)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True at or before t along axis 0 (-1 if none)."""
    t = _bcast(torch.arange(mask.shape[0], device=mask.device), mask.ndim)
    return torch.cummax(torch.where(mask, t, -1), dim=0).values


def cumsum_reset(x, axis: int = 0, index: str = "last",
                 reset_on_zero: bool = True, reset_at=None) -> torch.Tensor:
    """Cumulative sum along `axis`, resetting at zeros (or at NaNs).

    ``100110111 -> 100120123`` (xclim run_length.py:143-172).
    ``index='first'`` runs it backward, so the largest value sits on the
    run's first element. NaNs count as 0 (and reset) when ``reset_on_zero``;
    otherwise only NaNs reset and values accumulate across zeros.
    ``reset_at`` is an optional (T,) bool mask of positions where the carry
    is dropped (segment boundaries). Returns float32.
    """
    xf = x.movedim(axis, 0)
    if index == "first":
        xf = torch.flip(xf, (0,))
    if xf.dtype == torch.bool:
        vals = xf.to(torch.float64)
        reset = ~xf
    elif reset_on_zero:
        vals = xf.to(torch.float32)
        if xf.is_floating_point():
            vals = torch.nan_to_num(vals)
        vals = vals.to(torch.float64)
        reset = vals == 0
    else:
        nan = torch.isnan(xf)
        vals = torch.where(nan, 0.0, xf.to(torch.float32)).to(torch.float64)
        reset = nan
    if reset_at is not None:
        ra = torch.as_tensor(reset_at, device=xf.device)
        if index == "first":
            ra = torch.flip(ra, (0,))
        reset = reset | _bcast(ra, xf.ndim)

    # out[t] = sum of vals over (last reset at or before t) .. t
    csum = torch.cumsum(vals, dim=0)
    before = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]], dim=0)
    last = _last_true(reset.expand(vals.shape)).clamp(min=0)
    out = (csum - before.gather(0, last)).to(torch.float32)
    if index == "first":
        out = torch.flip(out, (0,))
    return out.movedim(0, axis)


def _as_bool(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x
    if x.is_floating_point():
        return torch.nan_to_num(x) > 0
    return x > 0


def rle(x, axis: int = 0, index: str = "first",
        reset_spec: SegmentSpec | None = None) -> torch.Tensor:
    """Run lengths marked on the boundary element of each run (xclim :223).

    Returns float32: 0 where the input is falsy, NaN inside runs, the run
    length on the first (or last) element of each run. With ``reset_spec``
    runs are split at resample-period boundaries and the marker sits on the
    within-period boundary element.
    """
    b = _as_bool(x)
    dev = b.device
    reset_at = None if reset_spec is None else segment_boundaries(
        reset_spec, index, dev)
    cs = cumsum_reset(b, axis=axis, index=index, reset_at=reset_at)
    bf = b.movedim(axis, 0)
    csf = cs.movedim(axis, 0)
    if index == "first":
        # marker = first element of a run: previous is False (or period start)
        prev = torch.cat([torch.zeros_like(bf[:1]), bf[:-1]], dim=0)
        boundary = bf & ~prev
        if reset_spec is not None:
            starts = segment_boundaries(reset_spec, "last", dev)
            boundary = boundary | (bf & _bcast(starts, bf.ndim))
    else:
        nxt = torch.cat([bf[1:], torch.zeros_like(bf[:1])], dim=0)
        boundary = bf & ~nxt
        if reset_spec is not None:
            ends = segment_boundaries(reset_spec, "first", dev)
            boundary = boundary | (bf & _bcast(ends, bf.ndim))
    out = torch.where(boundary, csf, torch.where(bf, torch.nan, 0.0))
    return out.movedim(0, axis)


def _seg_or_full(d, spec, axis, op):
    if spec is None:
        if op == "sum":
            return torch.nansum(d, dim=axis)
        if op == "max":
            allnan = torch.isnan(d).all(dim=axis)
            m = torch.nan_to_num(d, nan=-torch.inf).amax(dim=axis)
            return torch.where(allnan, torch.nan, m)
        raise ValueError(op)
    return segment_reduce(d, spec, op, axis=axis)


_FULL_REDUCERS = {
    "max": lambda a, ax: torch.where(torch.isnan(a), -torch.inf, a).amax(ax),
    "min": lambda a, ax: torch.where(torch.isnan(a), torch.inf, a).amin(ax),
    "sum": lambda a, ax: torch.nansum(a, dim=ax),
    "mean": lambda a, ax: torch.nanmean(a, dim=ax),
    "std": lambda a, ax: _nanstd(a, ax),
    "median": lambda a, ax: _nanmedian(a, ax),
}


@span(RUNS_SPAN)
def rle_statistics(x, reducer: str, window: int, axis: int = 0,
                   spec: SegmentSpec | None = None, index: str = "first",
                   resample_before_rl: bool = True) -> torch.Tensor:
    """Statistic (max/min/mean/sum/std/median/qNN) of run lengths >= window
    (xclim :275). Returns 0 where no qualifying run exists.

    ``max`` and ``sum`` over periods are the spells engine's longest run
    (0 when shorter than the window) and days in runs of at least the
    window, where the call has its semantics (see :func:`_spell`).
    """
    if reducer in ("max", "sum"):
        out = _spell(x, window, axis, spec, resample_before_rl,
                     "lng" if reducer == "max" else "wrc")
        if out is not None:
            return out if reducer == "sum" else torch.where(
                out >= window, out, 0.0)
    d = rle(x, axis=axis, index=index,
            reset_spec=spec if resample_before_rl else None)
    dw = torch.where(d >= window, d, torch.nan)
    # quantile reducers ("q90" -> 0.9 of the run lengths, linear
    # interpolation as np.nanquantile; xclim run_length.py:316-321)
    qv = (float(reducer[1:]) / 100.0
          if reducer[:1] == "q" and reducer[1:].isdigit() else None)
    if spec is None:
        if qv is not None:
            stat = nan_quantile(dw, [qv], axis=axis)[0]
        else:
            stat = _FULL_REDUCERS[reducer](dw, axis)
        nohit = ~(torch.nan_to_num(d, nan=0.0) >= window).any(dim=axis)
        return torch.where(nohit, 0.0, stat)
    if qv is not None:
        # gather each segment's run lengths and take the NaN-aware quantile
        tb = torch.as_tensor(build_gather_table(spec), dtype=torch.int64,
                             device=dw.device)
        df = dw.movedim(axis, 0)
        g = df[tb.clamp(min=0)]  # (nseg, maxlen, ...)
        okpad = (tb >= 0).reshape(tb.shape + (1,) * (g.ndim - 2))
        g = torch.where(okpad, g, torch.nan)
        stat = nan_quantile(g, [qv], axis=1)[0].movedim(0, axis)
    else:
        stat = segment_reduce(dw, spec, reducer, axis=axis)
    hits = segment_reduce(torch.nan_to_num(d, nan=0.0) >= window, spec, "any",
                          axis=axis)
    return torch.where(hits, stat, 0.0)


def _spell(x, window, axis, spec, resample_before_rl, what):
    """The spells engine's statistic ``what`` when the call has its
    semantics (a spec that tiles the time axis, runs reset at its
    boundaries, window >= 1); None otherwise."""
    if (spec is None or not resample_before_rl or window < 1
            or x.shape[axis] != len(spec.seg_id)
            or not _segments_contiguous(spec)):
        return None
    out = spells.spell_stats(_as_bool(x), spec.starts, spec.counts, window,
                             axis=axis)
    return out[("cnt", "wrc", "wre", "lng").index(what)]


@span(RUNS_SPAN)
def longest_run(x, axis: int = 0, spec: SegmentSpec | None = None,
                index: str = "first",
                resample_before_rl: bool = True) -> torch.Tensor:
    """Length of the longest run of True values (xclim :338)."""
    out = _spell(x, 1, axis, spec, resample_before_rl, "lng")
    if out is not None:
        return out
    return rle_statistics.__wrapped__(x, "max", 1, axis=axis, spec=spec,
                                      index=index,
                                      resample_before_rl=resample_before_rl)


@span(RUNS_SPAN)
def windowed_run_count(x, window: int, axis: int = 0,
                       spec: SegmentSpec | None = None, index: str = "first",
                       resample_before_rl: bool = True) -> torch.Tensor:
    """Total days inside runs of at least `window` (xclim :437)."""
    if window == 1 and spec is None:
        return _as_bool(x).sum(dim=axis, dtype=torch.int32)
    out = _spell(x, window, axis, spec, resample_before_rl, "wrc")
    if out is not None:
        return out
    d = rle(x, axis=axis, index=index,
            reset_spec=spec if resample_before_rl else None)
    d = torch.where(torch.nan_to_num(d, nan=0.0) >= window, d, 0.0)
    return _seg_or_full(torch.nan_to_num(d, nan=0.0), spec, axis, "sum")


@span(RUNS_SPAN)
def windowed_run_events(x, window: int, axis: int = 0,
                        spec: SegmentSpec | None = None, index: str = "first",
                        resample_before_rl: bool = True) -> torch.Tensor:
    """Number of distinct runs of at least `window` (xclim :381)."""
    out = _spell(x, window, axis, spec, resample_before_rl, "wre")
    if out is not None:
        return out
    b = _as_bool(x)
    if window == 1:
        bf = b.movedim(axis, 0)
        prev = torch.cat([torch.zeros_like(bf[:1]), bf[:-1]], dim=0)
        starts = bf & ~prev
        if spec is not None and resample_before_rl:
            # a run crossing a period boundary restarts in the new period
            seg_starts = segment_boundaries(spec, "last", b.device)
            starts = starts | (bf & _bcast(seg_starts, bf.ndim))
        d = starts.to(torch.float32).movedim(0, axis)
    else:
        r = rle(b, axis=axis, index=index,
                reset_spec=spec if resample_before_rl else None)
        d = (torch.nan_to_num(r, nan=0.0) >= window).to(torch.float32)
    return _seg_or_full(d, spec, axis, "sum")


@span(RUNS_SPAN)
def windowed_max_run_sum(x, window: int, axis: int = 0,
                         spec: SegmentSpec | None = None, index: str = "first",
                         resample_before_rl: bool = True) -> torch.Tensor:
    """Maximum run sum among runs of at least `window` (xclim :491).

    The input is float (e.g. clipped exceedance); a run is consecutive
    nonzero values.
    """
    reset_spec = spec if resample_before_rl else None
    reset_at = None if reset_spec is None else segment_boundaries(
        reset_spec, index, x.device)
    rse = cumsum_reset(x, axis=axis, index=index, reset_at=reset_at)
    rl = rle(_as_bool(x), axis=axis, index=index, reset_spec=reset_spec)
    d = torch.where(torch.nan_to_num(rl, nan=0.0) >= window, rse, 0.0)
    out = _seg_or_full(d, spec, axis, "max")
    return torch.nan_to_num(out, nan=0.0) if spec is None else out


def _boundary_run(x, window, axis, spec, position, resample_before_rl=True):
    """Absolute time index (float; NaN when none) of the first/last item of
    the first/last run of at least `window` (xclim :594-741)."""
    b = _as_bool(x)
    reset_at = None if (spec is None or not resample_before_rl) else \
        segment_boundaries(spec, position, b.device)
    d = cumsum_reset(b, axis=axis, index=position, reset_at=reset_at)
    hf = (d >= window).movedim(axis, 0)  # (T, ...)
    T = hf.shape[0]
    if spec is None:
        pos = _bcast(torch.arange(T, dtype=torch.float32, device=b.device),
                     hf.ndim)
        if position == "first":
            idx = torch.where(hf, pos, torch.inf).amin(dim=0)
        else:
            idx = torch.where(hf, pos, -torch.inf).amax(dim=0)
        return torch.where(hf.any(dim=0), idx, torch.nan)
    tb = torch.as_tensor(build_gather_table(spec), dtype=torch.int64,
                         device=b.device)
    g = hf[tb.clamp(min=0)]  # (nseg, maxlen, ...)
    g = g & (tb >= 0).reshape(tb.shape + (1,) * (g.ndim - 2))
    abspos = tb.to(torch.float32).reshape(tb.shape + (1,) * (g.ndim - 2))
    if position == "first":
        idx = torch.where(g, abspos, torch.inf).amin(dim=1)
    else:
        idx = torch.where(g, abspos, -torch.inf).amax(dim=1)
    out = torch.where(g.any(dim=1), idx, torch.nan)
    return out.movedim(0, axis)


@span(RUNS_SPAN)
def first_run(x, window: int, axis: int = 0, spec: SegmentSpec | None = None,
              resample_before_rl: bool = True) -> torch.Tensor:
    """Index of the first item of the first run of at least `window`
    (xclim :643)."""
    return _boundary_run(x, window, axis, spec, "first", resample_before_rl)


@span(RUNS_SPAN)
def last_run(x, window: int, axis: int = 0, spec: SegmentSpec | None = None,
             resample_before_rl: bool = True) -> torch.Tensor:
    """Index of the last item of the last run of at least `window`
    (xclim :693)."""
    return _boundary_run(x, window, axis, spec, "last", resample_before_rl)


def suspicious_run(x, axis: int = 0, window: int = 10, op: str = ">",
                   thresh=None) -> torch.Tensor:
    """Bool mask flagging values inside runs of IDENTICAL consecutive values
    of length >= window (xclim run_length.py:1693-1714, used by dataflags).

    With ``thresh``, only runs whose (constant) value satisfies ``value op
    thresh`` are flagged. NaN follows numpy equality (NaN != NaN), so NaN
    stretches are runs of length 1 and are never flagged.
    """
    xf = x.movedim(axis, 0)
    prev = torch.cat([torch.full_like(xf[:1], torch.nan), xf[:-1]], dim=0)
    same = xf == prev
    # run length of consecutive "same": a run of k sames = k+1 equal values
    hit = cumsum_reset(same, axis=0, index="last") >= (window - 1)
    if thresh is not None:
        ops = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
               "<=": operator.le, "==": operator.eq, "!=": operator.ne}
        # the run's value is constant, so the filter at the hit position
        # holds for the whole run
        hit = hit & ops[op](xf, thresh)
    # the reference's backward scan back[t] = hit[t] | (back[t+1] & same[t]):
    # t is flagged when a hit lies at some u >= t with same[t..u-1] all True,
    # i.e. when the next hit comes no later than the next False of `same`
    T = xf.shape[0]
    t = _bcast(torch.arange(T, device=xf.device), xf.ndim)

    def next_true(m):
        rev = torch.flip(torch.where(m, t, T), (0,))
        return torch.flip(torch.cummin(rev, dim=0).values, (0,))

    nh = next_true(hit)
    back = (nh < T) & (nh <= next_true(~same))
    # also flag the first element of the run (predecessor of the first same)
    nxt = torch.cat([back[1:] & same[1:], torch.zeros_like(back[:1])], dim=0)
    return (back | nxt).movedim(0, axis)
