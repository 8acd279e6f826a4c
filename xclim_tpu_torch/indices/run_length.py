"""Public run-length API on ClimArrays (reference: xclim:src/xclim/indices/run_length.py).

Thin host-side layer over :mod:`xclim_tpu_torch.ops.runlength`: builds the
segment spec and the date masks from the time coordinate and wraps device
results with the right labels.

The reference carries two step-by-step scans over time (``runs_with_holes``
and ``keep_longest_run``, ``jax.lax.scan``). Here both are a fixed number of
tensor ops whatever the length of the series: a step's state follows from
the last position at or before it where the scan would set it and the last
where it would clear it, two running maxima (``torch.cummax``).

Tracing: the season parts and the date-constrained runs (GSL's route:
``_season_parts`` under ``season_start``/``season_end``/``season_length``,
``first_run_after_date`` and its kin, ``run_end_after_date``) open the
program span ``runlength.season`` and find their runs with the engine's
body (``_rl._boundary_run``), so that no ``runlength.runs`` span opens
inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import SegmentSpec, TimeIndex, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.ops import runlength as _rl
from xclim_tpu_torch.utils.profiling import span

__all__ = [
    "cumsum_reset",
    "rle",
    "rle_statistics",
    "statistics_run",
    "longest_run",
    "windowed_run_count",
    "windowed_run_events",
    "windowed_max_run_sum",
    "first_run",
    "last_run",
    "first_run_after_date",
    "first_run_before_date",
    "last_run_before_date",
    "run_end_after_date",
    "season_start",
    "season_end",
    "season_length",
    "season",
    "runs_with_holes",
    "keep_longest_run",
    "run_bounds",
    "suspicious_run",
    "find_events",
]

#: the program span of the season parts and the date-constrained runs
SEASON_SPAN = "runlength.season"


def _spec(da: ClimArray, freq: str | None) -> SegmentSpec | None:
    return None if freq is None else resample_segments(da.time, freq)


def _wrap_seg(da: ClimArray, data, spec: SegmentSpec | None, units: str = ""):
    if spec is None:
        out_dims = tuple(d for d in da.dims if d != "time")
        coords = {k: v for k, v in da.coords.items() if k != "time"}
        return ClimArray(data, out_dims, coords, {"units": units}, da.name)
    coords = dict(da.coords)
    coords["time"] = spec.labels
    return ClimArray(data, da.dims, coords, {"units": units}, da.name)


def _along(values, da: ClimArray, dtype=None) -> torch.Tensor:
    """A host (n,) array as a tensor on da's device, shaped to broadcast
    along da's time axis."""
    shape = [1] * da.ndim
    shape[da.time_axis] = len(values)
    return torch.as_tensor(np.asarray(values), dtype=dtype,
                           device=da.data.device).reshape(shape)


def _index_to_doy(da: ClimArray, idx, coord):
    """Map absolute time indices (float, NaN-able) to doy (or keep indexes)."""
    if not coord:
        return idx
    doys = torch.as_tensor(
        np.concatenate([da.time.doy.astype(np.float32), [np.nan]]),
        device=idx.device)
    nan = torch.isnan(idx)
    safe = torch.where(nan, len(da.time), idx).to(torch.int64)
    return torch.where(nan, torch.nan, doys[safe])


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True at or before each step along axis 0 (-1 where
    there is none)."""
    t = torch.arange(mask.shape[0], device=mask.device).reshape(
        (-1,) + (1,) * (mask.ndim - 1))
    return torch.cummax(torch.where(mask, t, -1), dim=0).values


def cumsum_reset(da: ClimArray, index: str = "last",
                 reset_on_zero: bool = True) -> ClimArray:
    out = _rl.cumsum_reset(da.data, axis=da.time_axis, index=index,
                           reset_on_zero=reset_on_zero)
    return da.copy(data=out)


def rle(da: ClimArray, index: str = "first") -> ClimArray:
    return da.copy(data=_rl.rle(da.data, axis=da.time_axis, index=index))


def rle_statistics(da: ClimArray, reducer: str, window: int, freq: str | None = None,
                   index: str = "first", resample_before_rl: bool = True) -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.rle_statistics(da.data, reducer, window, axis=da.time_axis, spec=spec,
                             index=index, resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


statistics_run = rle_statistics


def longest_run(da: ClimArray, freq: str | None = None, index: str = "first",
                resample_before_rl: bool = True) -> ClimArray:
    return rle_statistics(da, "max", 1, freq=freq, index=index,
                          resample_before_rl=resample_before_rl)


def windowed_run_count(da: ClimArray, window: int, freq: str | None = None,
                       resample_before_rl: bool = True,
                       index: str = "first") -> ClimArray:
    # `index` picks which end of the run carries the rle value: the totals
    # are identical either way (the reference parameterizes both to prove it)
    spec = _spec(da, freq)
    out = _rl.windowed_run_count(da.data, window, axis=da.time_axis, spec=spec,
                                 resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


def windowed_run_events(da: ClimArray, window: int, freq: str | None = None,
                        resample_before_rl: bool = True,
                        index: str = "first") -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.windowed_run_events(da.data, window, axis=da.time_axis, spec=spec,
                                  resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


def windowed_max_run_sum(da: ClimArray, window: int, freq: str | None = None,
                         resample_before_rl: bool = True,
                         index: str = "first") -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.windowed_max_run_sum(da.data, window, axis=da.time_axis, spec=spec,
                                   resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


def _rel_to_period(da: ClimArray, idx, spec):
    """Resampled raw indices are period-relative in the reference (each group
    is mapped separately, xclim run_length.py:87-133 + :643), while the
    engine returns absolute time indices: shift by the segment starts."""
    return idx - _along(spec.starts.astype(np.float32), da)


def first_run(da: ClimArray, window: int, freq: str | None = None, coord=False,
              resample_before_rl: bool = True) -> ClimArray:
    spec = _spec(da, freq)
    idx = _rl.first_run(da.data, window, axis=da.time_axis, spec=spec,
                        resample_before_rl=resample_before_rl)
    if spec is not None and not coord:
        idx = _rel_to_period(da, idx, spec)
    return _wrap_seg(da, _index_to_doy(da, idx, coord), spec)


def last_run(da: ClimArray, window: int, freq: str | None = None, coord=False,
             resample_before_rl: bool = True) -> ClimArray:
    spec = _spec(da, freq)
    idx = _rl.last_run(da.data, window, axis=da.time_axis, spec=spec,
                       resample_before_rl=resample_before_rl)
    if spec is not None and not coord:
        idx = _rel_to_period(da, idx, spec)
    return _wrap_seg(da, _index_to_doy(da, idx, coord), spec)


# ---------------------------------------------------------------------------
# date-constrained runs (xclim run_length.py:1148-1333)
# ---------------------------------------------------------------------------


def _mid_date_index(time: TimeIndex, spec: SegmentSpec, date: str):
    """Per-segment absolute index of the first step matching 'MM-DD'.

    Returns (mid_idx (nseg,), has_date (nseg,)) as numpy arrays.
    """
    mm, dd = (int(x) for x in date.split("-"))
    match = (time.month == mm) & (time.day == dd)
    pos = np.where(match, np.arange(len(time)), len(time) + 1)
    mid = np.minimum.reduceat(pos, spec.starts)
    has = mid <= len(time)
    return np.where(has, mid, 0), has


def _mask_after(da: ClimArray, spec: SegmentSpec, mid_idx, has, offset: int = 0,
                strict: bool = False):
    """(T,) bool: step index >= (mid_idx of its segment) + offset (per segment)."""
    n = len(da.time)
    thresh = np.where(has, mid_idx + offset, n + 1)
    step_thresh = thresh[spec.seg_id]
    pos = np.arange(n)
    return (pos > step_thresh) if strict else (pos >= step_thresh)


@span(SEASON_SPAN)
def _apply_date_masked_run(da, freq, window, date, which, mask_builder, coord):
    spec = _spec(da, freq)
    if spec is None:
        raise ValueError("Date-constrained run functions need a freq.")
    mid_idx, has = _mid_date_index(da.time, spec, date)
    mask = mask_builder(spec, mid_idx, has)
    x = _rl._as_bool(da.data) & _along(mask, da)
    idx = _rl._boundary_run(x, window, da.time_axis, spec, which)
    # segments without the date give NaN
    idx = torch.where(_along(has, da), idx, torch.nan)
    return _wrap_seg(da, _index_to_doy(da, idx, coord), spec)


def first_run_after_date(da: ClimArray, window: int, date: str = "07-01",
                         freq: str = "YS", coord="dayofyear") -> ClimArray:
    """First run of `window` Trues starting at/after `date` in each period
    (xclim :1205)."""
    return _apply_date_masked_run(
        da, freq, window, date, "first",
        lambda spec, mid, has: _mask_after(da, spec, mid, has), coord)


def last_run_before_date(da: ClimArray, window: int, date: str = "07-01",
                         freq: str = "YS", coord="dayofyear") -> ClimArray:
    """Last run ending at/before `date` in each period (xclim :1248)."""
    return _apply_date_masked_run(
        da, freq, window, date, "last",
        lambda spec, mid, has: ~_mask_after(da, spec, mid, has, strict=True), coord)


def first_run_before_date(da: ClimArray, window: int, date: str | None = "07-01",
                          freq: str = "YS", coord="dayofyear") -> ClimArray:
    """First run beginning before `date` (mask after date+window-1; xclim :1288)."""
    if date is None:
        return first_run(da, window, freq=freq, coord=coord)
    return _apply_date_masked_run(
        da, freq, window, date, "first",
        lambda spec, mid, has: ~_mask_after(da, spec, mid, has, offset=window - 1), coord)


def _last_step(da: ClimArray, spec: SegmentSpec | None):
    """Absolute index of each period's last step (of the series without a
    spec), float32, shaped against a resampled result."""
    if spec is None:
        return torch.tensor(float(len(da.time) - 1), device=da.data.device)
    last = spec.starts.astype(np.float32) + spec.counts.astype(np.float32) - 1
    return _along(last, da)


@span(SEASON_SPAN)
def run_end_after_date(da: ClimArray, window: int, date: str = "07-01",
                       freq: str = "YS", coord="dayofyear") -> ClimArray:
    """Index of first item after the end of a run that began before `date` and
    is still going at `date`-ish (xclim :1148)."""
    spec = _spec(da, freq)
    mid_idx, has = _mid_date_index(da.time, spec, date)
    ax = da.time_axis
    after = _mask_after(da, spec, mid_idx, has)
    b = _rl._as_bool(da.data)
    end_x = ~b & _along(after, da)
    beg_x = b & _along(~after, da)
    end = _rl._boundary_run(end_x, window, ax, spec, "first")
    beg = _rl._boundary_run(beg_x, window, ax, spec, "first")
    # where no end is found but a beginning exists: the period's last step
    end = torch.where(torch.isnan(end) & ~torch.isnan(beg), _last_step(da, spec),
                      end)
    end = torch.where(torch.isnan(beg), torch.nan, end)
    end = torch.where(_along(has, da), end, torch.nan)
    return _wrap_seg(da, _index_to_doy(da, end, coord), spec)


# ---------------------------------------------------------------------------
# seasons (xclim run_length.py:891-1146)
# ---------------------------------------------------------------------------


@span(SEASON_SPAN)
def _season_parts(da: ClimArray, window: int, mid_date: str | None, freq: str):
    if freq is None:
        # whole-axis season (the reference's default, xclim :998): no
        # resampling, outputs collapse the time dim
        return _season_parts_whole(da, window, mid_date)
    spec = _spec(da, freq)
    ax = da.time_axis
    n = len(da.time)
    b = _rl._as_bool(da.data)
    if mid_date is not None:
        mid_idx, has = _mid_date_index(da.time, spec, mid_date)
        # start: the first run of `window` Trues beginning before mid_date
        before = ~_mask_after(da, spec, mid_idx, has, offset=window - 1)
        beg_x = b & _along(before, da)
    else:
        beg_x = b
    beg = _rl._boundary_run(beg_x, window, ax, spec, "first")

    # end: the first run of `window` Falses after the start (and mid_date)
    pos = _along(np.arange(n, dtype=np.float32), da)
    seg_id = torch.as_tensor(spec.seg_id, dtype=torch.int64, device=b.device)
    beg_per_step = torch.index_select(torch.nan_to_num(beg, nan=torch.inf), ax,
                                      seg_id)
    not_da = ~b & (pos >= beg_per_step)
    if mid_date is not None:
        not_da = not_da & _along(_mask_after(da, spec, mid_idx, has), da)
    end = _rl._boundary_run(not_da, window, ax, spec, "first")

    if mid_date is not None:
        hasv = _along(has, da)
        beg = torch.where(hasv, beg, torch.nan)
        end = torch.where(hasv, end, torch.nan)
    return spec, beg, end


def _season_parts_whole(da: ClimArray, window: int, mid_date: str | None = None):
    """Season bounds over the whole axis (freq=None): outputs have no time
    dim, matching the reference's unresampled rl.season. The start run must
    begin before `mid_date`, the closing non-run at/after it (xclim :891)."""
    ax = da.time_axis
    n = len(da.time)
    b = _rl._as_bool(da.data)
    pos = _along(np.arange(n, dtype=np.float32), da)

    has_date = True
    if mid_date is not None:
        mm, dd = (int(x) for x in mid_date.split("-"))
        match = np.where((da.time.month == mm) & (da.time.day == dd))[0]
        if len(match) > 1:
            raise ValueError(f"More than 1 instance of date {mid_date} "
                             "in the time axis; pass a freq.")
        has_date = len(match) == 1
        mid = int(match[0]) if has_date else n + 1
        beg_x = b & (pos < mid + window - 1)
    else:
        beg_x = b
    beg = _rl._boundary_run(beg_x, window, ax, None, "first")  # (space,) abs idx
    beg_per_step = torch.nan_to_num(beg, nan=torch.inf).unsqueeze(ax)
    not_da = ~b & (pos >= beg_per_step)
    if mid_date is not None:
        not_da = not_da & (pos >= mid)
    end = _rl._boundary_run(not_da, window, ax, None, "first")
    if not has_date:
        beg = torch.full_like(beg, torch.nan)
        end = torch.full_like(end, torch.nan)
    return None, beg, end


def season_start(da: ClimArray, window: int, mid_date: str | None = None,
                 freq: str | None = None, coord=False) -> ClimArray:
    """First day of the first `window`-day run (before mid_date), xclim :891."""
    spec, beg, _ = _season_parts(da, window, mid_date, freq)
    return _wrap_seg(da, _index_to_doy(da, beg, coord), spec)


def season_end(da: ClimArray, window: int, mid_date: str | None = None,
               freq: str | None = None, coord=False) -> ClimArray:
    """First day of the first `window`-day non-run after the season start
    (xclim :931). NaN if no start; last index if started but never ended."""
    spec, beg, end = _season_parts(da, window, mid_date, freq)
    end = torch.where(torch.isnan(end) & ~torch.isnan(beg), _last_step(da, spec),
                      end)
    end = torch.where(torch.isnan(beg), torch.nan, end)
    return _wrap_seg(da, _index_to_doy(da, end, coord), spec)


def season_length(da: ClimArray, window: int, mid_date: str | None = None,
                  freq: str | None = None) -> ClimArray:
    """end - start; if started but never ended: distance to last step + 1;
    0 if no season (xclim :1031)."""
    spec, beg, end = _season_parts(da, window, mid_date, freq)
    bound = _last_step(da, spec) + 1
    length = torch.where(torch.isnan(end), bound - beg, end - beg)
    length = torch.where(torch.isnan(beg), 0.0, length)
    return _wrap_seg(da, length, spec)


def season(da: ClimArray, window: int, mid_date: str | None = None,
           freq: str | None = None, coord=False) -> dict:
    """start/end/length of the season as a dict of ClimArrays (xclim :998)."""
    return {
        "start": season_start(da, window, mid_date, freq, coord),
        "end": season_end(da, window, mid_date, freq, coord),
        "length": season_length(da, window, mid_date, freq),
    }


# ---------------------------------------------------------------------------
# holes / longest / suspicious
# ---------------------------------------------------------------------------


def runs_with_holes(da_start: ClimArray, window_start: int, da_stop: ClimArray,
                    window_stop: int) -> ClimArray:
    """1 inside an event that starts with `window_start` Trues in da_start and
    ends with `window_stop` Trues in da_stop (xclim :844).

    The reference scans: a stop position clears the state, else a start
    position sets it, else it carries over (a stop wins a tie). So a step is
    inside an event iff the last start position at or before it comes after
    the last stop position at or before it.
    """
    ax = da_start.time_axis
    start_runs = _rl.cumsum_reset(da_start.data, axis=ax, index="first")
    stop_runs = _rl.cumsum_reset(da_stop.data, axis=ax, index="first")
    last_start = _last_index((start_runs >= window_start).movedim(ax, 0))
    last_stop = _last_index((stop_runs >= window_stop).movedim(ax, 0))
    out = (last_start > last_stop).movedim(0, ax)
    return da_start.copy(data=out.to(torch.float32))


def keep_longest_run(da: ClimArray, freq: str | None = None) -> ClimArray:
    """Boolean mask keeping only the longest run (per period), xclim :805.

    The first run of each period whose length is the period's longest is
    marked on its first step; a step is kept iff the last mark at or before
    it comes after the last False step at or before it (the reference's
    scan carries the mark along the run, across period boundaries too).
    """
    spec = _spec(da, freq)
    ax = da.time_axis
    b = _rl._as_bool(da.data)
    d = _rl.rle(b, axis=ax, index="first", reset_spec=spec)
    mx = _rl.rle_statistics(b, "max", 1, axis=ax, spec=spec)
    if spec is not None:
        mxs = torch.index_select(mx, ax, torch.as_tensor(
            spec.seg_id, dtype=torch.int64, device=b.device))
    else:
        mxs = mx.unsqueeze(ax)
    cand = torch.nan_to_num(d, nan=0.0) == torch.where(mxs > 0, mxs, -1)
    # ties: the reference's argmax keeps only the FIRST longest run
    # (xclim :805-833): drop a candidate with a candidate before it in the
    # same period (exclusive prefix count of candidates)
    cf = cand.movedim(ax, 0)
    pre = torch.cumsum(cf, dim=0) - cf.to(torch.int64)
    if spec is not None:
        off = pre[torch.as_tensor(spec.starts, dtype=torch.int64,
                                  device=b.device)]
        pre = pre - off[torch.as_tensor(spec.seg_id, dtype=torch.int64,
                                        device=b.device)]
    mark = cf & (pre == 0)
    out = _last_index(mark) > _last_index(~b.movedim(ax, 0))
    return da.copy(data=out.movedim(0, ax))


_OP_WORDS = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
             "ne": "!="}


def suspicious_run(da: ClimArray, window: int = 10, op: str = ">",
                   thresh=None) -> ClimArray:
    """Flag runs of >= window identical values, optionally filtered to runs
    whose value satisfies ``value op thresh`` (xclim run_length.py:1717)."""
    out = _rl.suspicious_run(da.data, axis=da.time_axis, window=window,
                             op=_OP_WORDS.get(op, op), thresh=thresh)
    return da.copy(data=out)


def find_events(condition: ClimArray, window: int,
                condition_stop: ClimArray | None = None, window_stop: int = 1,
                data: ClimArray | None = None, freq: str | None = None,
                max_events: int | None = None) -> dict:
    """Extract individual events along an 'event' dimension
    (xclim run_length.py:1846).

    An event starts with `window` consecutive True in `condition` and stops
    with `window_stop` consecutive True in `condition_stop` (default: the
    negation of `condition`). Ragged events are padded to a fixed capacity
    (``max_events``, default T//(window+window_stop)+1), as the reference
    does; events past the capacity are dropped.

    Each step of an event adds into its cell's slot ``cell * E + event``
    (``index_add_``, ``scatter_reduce(..., "amin")``); steps outside an event
    or past the capacity go to one extra slot, which is dropped.

    Returns a dict with 'event_length', 'event_effective_length',
    'event_start' (doy) and, if `data` given, 'event_sum'.
    """
    if condition_stop is None:
        condition_stop = ~condition
    mask = runs_with_holes(condition, window, condition_stop, window_stop)
    ax = mask.time_axis
    spec = _spec(mask, freq)
    dev = mask.data.device
    mf = (mask.data > 0).movedim(ax, 0)  # (T, ...)
    T = mf.shape[0]
    prev = torch.cat([torch.zeros_like(mf[:1]), mf[:-1]], dim=0)
    starts = mf & ~prev
    if spec is not None:
        # split events at period boundaries
        seg_first = segment_boundaries_arr(spec, dev)
        starts = starts | (mf & seg_first.reshape((T,) + (1,) * (mf.ndim - 1)))
    E = max_events or (T // (window + window_stop) + 1)
    cshape = tuple(mf.shape[1:])
    C = int(np.prod(cshape)) if cshape else 1
    # per-cell event index at each step (0-based; valid only inside events)
    eid = torch.cumsum(starts.reshape(T, C), dim=0) - 1
    m2 = mf.reshape(T, C)
    cell = torch.arange(C, device=dev).reshape(1, C)
    ids = torch.where(m2 & (eid < E), cell * E + eid.clamp(0, E - 1),
                      C * E).reshape(-1)

    def seg_sum(vals):
        out = torch.zeros(C * E + 1, dtype=vals.dtype, device=dev)
        return out.index_add_(0, ids, vals.reshape(-1))[:-1].reshape(C, E)

    condf = _rl._as_bool(condition.data).movedim(ax, 0).reshape(T, C)
    length = seg_sum(torch.ones((T, C), dtype=torch.float32, device=dev))
    eff = seg_sum(condf.to(torch.float32))
    pos = torch.arange(T, dtype=torch.float32, device=dev).reshape(T, 1)
    first = torch.where(starts.reshape(T, C), pos, torch.inf)
    start_idx = torch.full((C * E + 1,), torch.inf, device=dev).scatter_reduce(
        0, ids, first.reshape(-1), "amin", include_self=False)[:-1].reshape(C, E)
    valid = length > 0

    def unflat(x):
        return torch.where(valid, x, torch.nan).reshape(cshape + (E,))

    out_dims = tuple(d for d in mask.dims if d != "time") + ("event",)
    coords = {k: v for k, v in mask.coords.items() if k != "time"}
    coords["event"] = np.arange(1, E + 1)

    def wrap(xdata, name, units="d"):
        return ClimArray(xdata, out_dims, dict(coords), {"units": units}, name)

    doys = torch.as_tensor(
        np.concatenate([mask.time.doy.astype(np.float32), [np.nan]]), device=dev)
    sidx = unflat(start_idx)
    nan = torch.isnan(sidx)
    start_doy = torch.where(nan, torch.nan,
                            doys[torch.where(nan, T, sidx).to(torch.int64)])
    out = {
        "event_length": wrap(unflat(length), "event_length"),
        "event_effective_length": wrap(unflat(eff), "event_effective_length"),
        "event_start": wrap(start_doy, "event_start", units=""),
    }
    if data is not None:
        dataf = torch.nan_to_num(data.data).movedim(ax, 0).reshape(T, C)
        out["event_sum"] = wrap(unflat(seg_sum(dataf)), "event_sum",
                                units=data.attrs.get("units", ""))
    return out


def run_bounds(mask: ClimArray, coord: bool | str = True,
               max_events: int | None = None) -> ClimArray:
    """Start and end positions of boolean runs, on new ('bounds', 'events')
    dims (xclim run_length.py:745).

    The reference sizes the events dim from the data; here it is the fixed
    capacity ``max_events`` (default T//2+1, the worst case), NaN padded, as
    in the JAX package.

    coord=False → indices; coord=True → time encoded as seconds since epoch;
    coord='dayofyear' → day-of-year values.
    """
    ax = mask.time_axis
    mf = _rl._as_bool(mask.data).movedim(ax, 0)
    T = mf.shape[0]
    E = max_events or (T // 2 + 1)
    prev = torch.cat([torch.zeros_like(mf[:1]), mf[:-1]], dim=0)
    nxt = torch.cat([mf[1:], torch.zeros_like(mf[:1])], dim=0)
    starts = mf & ~prev
    # the reference's end is the first False index after the run
    ends = mf & ~nxt
    pos = torch.arange(T, dtype=torch.float32, device=mf.device).reshape(
        (T,) + (1,) * (mf.ndim - 1))

    def first_e(flags, off=0.0):
        # sorting brings the flagged positions forward in order
        key = torch.where(flags, pos + off, torch.inf)
        srt = torch.sort(key, dim=0).values[:E]
        return torch.where(torch.isinf(srt), torch.nan, srt)

    out = torch.stack([first_e(starts), first_e(ends, off=1.0)], dim=0)
    if coord:
        if coord == "dayofyear":
            vals = mask.time.doy.astype(np.float64)
        else:
            vals = mask.time.encode().astype(np.float64)
        # float32, as the reference's values are
        vt = torch.as_tensor(np.concatenate([vals, [np.nan]]),
                             dtype=torch.float32, device=out.device)
        nan = torch.isnan(out)
        safe = torch.where(nan, T, out.clamp(0, T - 1)).to(torch.int64)
        out = torch.where(nan, torch.nan, vt[safe])
    out_dims = ("bounds", "events") + tuple(d for d in mask.dims if d != "time")
    coords = {k: v for k, v in mask.coords.items() if k != "time"}
    coords["events"] = np.arange(E)
    return ClimArray(out, out_dims, coords, {}, "run_bounds")


def segment_boundaries_arr(spec, device=None) -> torch.Tensor:
    """(T,) bool: True on the first step of each segment."""
    return _rl.segment_boundaries(spec, "last", device)
