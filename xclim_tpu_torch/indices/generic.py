"""Generic index building blocks (reference: xclim:src/xclim/indices/generic.py).

Parameterizable compute functions used by the index library. All operate on
ClimArrays; thresholds are quantified strings converted host-side so the
device sees plain scalars.

Counts of a scalar threshold (``threshold_count``) and every run statistic
over resample periods reach the ``spells`` kernel on a CUDA tensor; the
other per-period reductions reach ``segred``. Float sums are accumulated in
float64 and rounded once, where the reference adds float32 partials: sums
of n values differ from it by a few float32 ulps (ROADMAP, "Known rounding
gaps"); counts, run lengths and days of year are exact.
"""

from __future__ import annotations

import operator
from typing import Sequence

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.units import (
    convert_units_to,
    declare_relative_units,
    pint2cfattrs,
    str2pint,
    to_agg_units,
    units2pint,
)
from xclim_tpu_torch.indices import run_length as rl
from xclim_tpu_torch.ops import runlength as _rl
from xclim_tpu_torch.ops import spells
from xclim_tpu_torch.ops.segments import _segments_contiguous, rolling_reduce

__all__ = [
    "aggregate_between_dates",
    "binary_ops",
    "bivariate_count_occurrences",
    "bivariate_spell_length_statistics",
    "compare",
    "count_level_crossings",
    "count_occurrences",
    "cumulative_difference",
    "default_freq",
    "detrend",
    "diurnal_temperature_range",
    "domain_count",
    "doymax",
    "doymin",
    "extreme_temperature_range",
    "first_day_threshold_reached",
    "first_occurrence",
    "get_daily_events",
    "get_op",
    "get_zones",
    "interday_diurnal_temperature_range",
    "last_occurrence",
    "season",
    "select_resample_op",
    "select_rolling_resample_op",
    "spell_length",
    "spell_length_statistics",
    "spell_mask",
    "statistics",
    "temperature_sum",
    "threshold_count",
    "thresholded_events",
    "thresholded_statistics",
]

binary_ops = {">": "gt", "<": "lt", ">=": "ge", "<=": "le", "==": "eq", "!=": "ne"}


def get_op(op: str, constrain: Sequence[str] | None = None):
    """Comparison-operator lookup with constraint validation (xclim generic.py:255)."""
    if op == "gteq":
        op = "ge"
    if op == "lteq":
        op = "le"
    if op in binary_ops:
        binop = binary_ops[op]
    elif op in binary_ops.values():
        binop = op
    else:
        raise ValueError(f"Operation `{op}` not recognized.")
    if constrain:
        allowed = set()
        for c in constrain:
            allowed.add(c)
            allowed.add(binary_ops.get(c, c))
        if op not in allowed and binop not in allowed:
            raise ValueError(f"Operation `{op}` not permitted for indice.")
    return getattr(operator, binop)


def compare(left: ClimArray, op: str, right, constrain=None) -> ClimArray:
    """Boolean mask ``left op right`` (xclim generic.py:301)."""
    return get_op(op, constrain)(left, right)


def _thresh(threshold, like: ClimArray, context: str = "infer"):
    """Quantified string/number → scalar in `like`'s units."""
    if isinstance(threshold, ClimArray):
        return convert_units_to(threshold, like, context=context)
    if isinstance(threshold, (int, float)):
        return float(threshold)
    return convert_units_to(str2pint(threshold), like, context=context)


def default_freq(**indexer) -> str:
    """Default annual resampling frequency anchored to the time indexer
    (xclim generic.py:224): season='DJF' → 'YS-DEC', month=[6,7] → 'YS-JUN'."""
    months = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP",
              "OCT", "NOV", "DEC"]
    if not indexer:
        return "YS-JAN"
    group, value = next(iter(indexer.items()))
    if group == "season":
        if isinstance(value, (list, tuple)):
            value = value[0]
        month = {"DJF": 12, "MAM": 3, "JJA": 6, "SON": 9}[value]
    elif group == "month":
        month = int(np.atleast_1d(value)[0])
    else:
        return "YS-JAN"
    return f"YS-{months[month - 1]}"


def doymax(da: ClimArray, freq: str = "YS") -> ClimArray:
    """Day of year of the maximum (xclim generic.py:177)."""
    out = da.resample(freq).argmax_doy()
    return to_agg_units(out, da, "doymax")


def doymin(da: ClimArray, freq: str = "YS") -> ClimArray:
    """Day of year of the minimum (xclim generic.py:177)."""
    out = da.resample(freq).argmin_doy()
    return to_agg_units(out, da, "doymin")


def select_resample_op(da: ClimArray, op: str, freq: str = "YS", out_units=None,
                       **indexer) -> ClimArray:
    """resample(freq).op over the (optionally time-subset) array
    (xclim generic.py:83)."""
    da = da.select_time(**indexer)
    if op in ("doymin", "doymax"):
        out = da.resample(freq).argmax_doy() if op == "doymax" else da.resample(freq).argmin_doy()
    else:
        out = getattr(da.resample(freq), op.replace("integral", "sum"))()
    if out_units is not None:
        out.attrs["units"] = out_units
        return out
    if op in ("std", "var"):
        out.attrs["units"] = da.attrs.get("units", "")
    return to_agg_units(out, da, op)


def select_rolling_resample_op(da: ClimArray, op: str, window: int,
                               window_center: bool = True, window_op: str = "mean",
                               freq: str = "YS", out_units=None, **indexer) -> ClimArray:
    """Rolling stat then resample-reduce (xclim generic.py:128)."""
    rolled = da.copy(data=rolling_reduce(da.data, window, window_op, axis=da.time_axis,
                                         center=window_center))
    rolled.attrs = dict(da.attrs)
    return select_resample_op(rolled, op, freq=freq, out_units=out_units, **indexer)




def threshold_count(da: ClimArray, op: str, threshold, freq: str,
                    constrain=None) -> ClimArray:
    """Count steps where ``da op threshold`` per period (xclim generic.py:329).

    A scalar threshold on a float32 series goes to the spells engine, which
    reads the series once and counts the days where the comparison holds
    (the ``spells`` kernel on a CUDA tensor, its plain twin on a CPU
    tensor). An array threshold (e.g. doy percentiles) or another dtype
    compares first and sums the 0/1 mask per period (``segred``). A NaN
    input compares False and is not counted; all-NaN periods are left to
    the missing-value masks.
    """
    if constrain is None:
        constrain = (">", "<", ">=", "<=")
    thresh = _thresh(threshold, da)
    get_op(op, constrain)  # validate op before any dispatch
    out = _spell_threshold_count(da, op, thresh, freq)
    if out is not None:
        return out
    c = compare(da, op, thresh, constrain)
    return c.astype(torch.float32).resample(freq).sum()


_SPELL_OPS = {">": ">", ">=": ">=", "<": "<", "<=": "<=", "gt": ">",
              "ge": ">=", "lt": "<", "le": "<=", "gteq": ">=", "lteq": "<="}


def _spell_threshold_count(da: ClimArray, op: str, thresh, freq: str):
    """The count of days where ``da op thresh`` through the spells engine
    (``fused_spell_stats(..., window=1, op=op, thresh=thresh)`` in the
    reference, xclim_tpu/indices/generic.py:190-233), when the call has its
    semantics: a scalar threshold, a float32 series and periods that tile
    the time axis; None otherwise."""
    if (not isinstance(thresh, (int, float, np.floating, np.integer))
            or op not in _SPELL_OPS or da.data.dtype != torch.float32):
        return None
    spec = resample_segments(da.time, freq)
    if not _segments_contiguous(spec):
        return None
    cnt = spells.spell_stats(da.data, spec.starts, spec.counts, 1,
                             op=_SPELL_OPS[op], thresh=float(thresh),
                             axis=da.time_axis)[0]
    coords = dict(da.coords)
    coords["time"] = spec.labels
    return ClimArray(cnt, da.dims, coords, {}, da.name)


def domain_count(da: ClimArray, low, high, freq: str) -> ClimArray:
    """Count steps in ]low, high] per period (xclim generic.py:364)."""
    lo = _thresh(low, da)
    hi = _thresh(high, da)
    c = (compare(da, ">", lo) & compare(da, "<=", hi)).astype(torch.float32)
    return c.resample(freq).sum()


def get_daily_events(da: ClimArray, threshold, op: str, constrain=None) -> ClimArray:
    """1 where condition holds, NaN where input NaN, 0 otherwise
    (xclim generic.py:395)."""
    thresh = _thresh(threshold, da)
    events = compare(da, op, thresh, constrain).astype(torch.float32)
    events = events.where(~da.isnull())
    events.attrs["units"] = "1"
    return events


# ---------------------------------------------------------------------------
# spells
# ---------------------------------------------------------------------------


def spell_mask(data, window: int, win_reducer: str, op: str, thresh, min_gap: int = 1,
               weights=None, var_reducer: str = "all") -> ClimArray:
    """Boolean mask of steps inside a spell (xclim generic.py:434).

    A step is in a spell if it belongs to any `window`-length period whose
    `win_reducer` statistic satisfies ``op thresh``.
    """
    if not isinstance(data, ClimArray):
        # multivariate: the per-step/per-window conditions combine BEFORE
        # the run logic (the reference reduces the 'variable' dim on the
        # window-level mask, xclim generic.py:480-517); intersecting the
        # expanded spell masks would wrongly accept overlapping-but-
        # different windows
        if np.isscalar(thresh) or isinstance(thresh, ClimArray) or len(data) != len(thresh):
            raise ValueError("threshold must be a sequence of the same length as data.")
        conds = [_spell_window_condition(d, window, win_reducer, op, t, weights)
                 for d, t in zip(data, thresh)]
        comb = conds[0]
        for c in conds[1:]:
            comb = (comb & c) if var_reducer == "all" else (comb | c)
        return _expand_spell_condition(comb, data[0], window, win_reducer, op,
                                       min_gap)
    cond = _spell_window_condition(data, window, win_reducer, op, thresh,
                                   weights)
    return _expand_spell_condition(cond, data, window, win_reducer, op,
                                   min_gap)


def _spell_fastpath(window, win_reducer, op) -> bool:
    return window > 1 and (
        (win_reducer == "min" and op in (">", ">=", "ge", "gt"))
        or (win_reducer == "max" and op in ("<", "<=", "le", "lt")))


def _spell_window_condition(data, window, win_reducer, op, thresh, weights):
    """The per-step (window==1/fast path) or per-window-end (general path)
    boolean condition for one variable, before run expansion."""
    if weights is not None:
        if win_reducer != "mean":
            raise ValueError("Argument 'weights' is only supported if "
                             "'win_reducer' is 'mean'. Got: " + win_reducer)
        if len(weights) != window:
            raise ValueError(
                f"Weights have a different length ({len(weights)}) than "
                f"the window ({window}).")
    ax = data.time_axis
    if window == 1 or _spell_fastpath(window, win_reducer, op):
        return compare(data, op, thresh).data.to(torch.bool)
    if weights is not None:
        w = torch.as_tensor(np.asarray(weights, dtype=np.float32),
                            device=data.data.device)
        xm = data.data.movedim(ax, -1)
        T = xm.shape[-1]
        xp = torch.nn.functional.pad(xm, (window - 1, 0), value=torch.nan)
        idx = (torch.arange(T, device=xm.device)[:, None]
               + torch.arange(window, device=xm.device)[None, :])
        spell_value = (xp[..., idx] * w).sum(-1).movedim(-1, ax)
    else:
        spell_value = rolling_reduce(data.data, window, win_reducer, axis=ax)
    sv_ca = ClimArray(spell_value, data.dims, dict(data.coords), {},
                      data.name)
    mb = compare(sv_ca, op, thresh).data.to(torch.bool)
    return torch.where(torch.isnan(spell_value), False, mb)


def _expand_spell_condition(cond, template, window, win_reducer, op,
                            min_gap: int = 1):
    """Turn the (possibly variable-combined) window condition into the
    is-in-spell step mask."""
    ax = template.time_axis
    if window == 1:
        out = template.copy(data=cond)
    elif _spell_fastpath(window, win_reducer, op):
        # a day can only be in a spell if it satisfies the condition
        # itself; keep days of runs >= window (xclim generic.py:501-517)
        run_len_first = _rl.cumsum_reset(cond, axis=ax, index="first")
        run_len_last = _rl.cumsum_reset(cond, axis=ax, index="last")
        total = run_len_first + run_len_last - 1
        out = template.copy(data=cond & (total >= window))
    else:
        # windows end at t; day d is in spell if any end in [d, d+window-1]
        rev = torch.flip(cond, (ax,))
        anyfwd = rolling_reduce(rev.to(torch.float32), window, "sum",
                                axis=ax, min_periods=1) >= 1
        out = template.copy(data=torch.flip(anyfwd, (ax,)))
    out.attrs = {}
    if min_gap > 1:
        merged = rl.runs_with_holes(out, 1, ~out, min_gap)
        out = out.copy(data=merged.data.to(torch.bool))
    return out


def _spell_length_statistics(data, thresh, window, win_reducer, op, spell_reducer,
                             freq, min_gap=1, resample_before_rl=True, **indexer):
    if isinstance(spell_reducer, str):
        spell_reducer = [spell_reducer]
    is_in_spell = spell_mask(data, window, win_reducer, op, thresh, min_gap=min_gap)
    is_in_spell = is_in_spell.select_time(**indexer)
    ref = data if isinstance(data, ClimArray) else data[0]
    outs = []
    for sr in spell_reducer:
        if sr == "count":
            # the number of spells is the number of runs
            out = rl.windowed_run_events(is_in_spell, 1, freq=freq,
                                         resample_before_rl=resample_before_rl)
            out.attrs["units"] = ""
            outs.append(out)
        else:
            out = rl.rle_statistics(is_in_spell, sr, 1, freq=freq,
                                    resample_before_rl=resample_before_rl)
            outs.append(to_agg_units(out, ref, "count"))
    if len(outs) == 1:
        return outs[0]
    return tuple(outs)


@declare_relative_units(threshold="<data>")
def spell_length_statistics(data: ClimArray, threshold, window: int, win_reducer: str,
                            op: str, spell_reducer, freq: str, min_gap: int = 1,
                            resample_before_rl: bool = True, **indexer):
    """Statistics of spell lengths (xclim generic.py:589)."""
    thresh = _thresh(threshold, data)
    return _spell_length_statistics(data, thresh, window, win_reducer, op,
                                    spell_reducer, freq, min_gap=min_gap,
                                    resample_before_rl=resample_before_rl, **indexer)


@declare_relative_units(threshold1="<data1>", threshold2="<data2>")
def bivariate_spell_length_statistics(data1: ClimArray, threshold1, data2: ClimArray,
                                      threshold2, window: int, win_reducer: str, op: str,
                                      spell_reducer, freq: str, min_gap: int = 1,
                                      resample_before_rl: bool = True, **indexer):
    """Bivariate spell statistics: both conditions must hold
    (xclim generic.py:690)."""
    t1 = _thresh(threshold1, data1)
    t2 = _thresh(threshold2, data2)
    return _spell_length_statistics([data1, data2], [t1, t2], window, win_reducer, op,
                                    spell_reducer, freq, min_gap=min_gap,
                                    resample_before_rl=resample_before_rl, **indexer)


def spell_length(data: ClimArray, threshold, reducer: str, op: str, freq: str) -> ClimArray:
    """Statistic of lengths of runs satisfying a condition (clix-meta generic;
    xclim generic.py:1205)."""
    thresh = _thresh(threshold, data)
    cond = compare(data, op, thresh)
    out = rl.rle_statistics(cond, reducer, 1, freq=freq)
    return to_agg_units(out, data, "count")


# ---------------------------------------------------------------------------
# seasons (generic, stat-returning version; xclim generic.py:770)
# ---------------------------------------------------------------------------


@declare_relative_units(thresh="<data>")
def season(data: ClimArray, thresh, window: int, op: str, stat: str, freq: str,
           mid_date: str | None = None, constrain=None) -> ClimArray:
    """Season start/end/length from a threshold condition (xclim generic.py:770)."""
    thresh = _thresh(thresh, data)
    cond = compare(data, op, thresh, constrain)
    if stat == "start":
        out = rl.season_start(cond, window, mid_date, freq, coord="dayofyear")
    elif stat == "end":
        out = rl.season_end(cond, window, mid_date, freq, coord="dayofyear")
    else:
        out = rl.season_length(cond, window, mid_date, freq)
    if stat in ("start", "end"):
        return to_agg_units(out, data, "doymax")
    return to_agg_units(out, data, "count")


def season_length_from_boundaries(season_start: ClimArray, season_end: ClimArray) -> ClimArray:
    """length = end - start, 0 when either is missing (xclim generic.py:856)."""
    length = season_end - season_start
    out = length.where(~(season_start.isnull() | season_end.isnull()), 0.0)
    out.attrs["units"] = "d"
    return out


# ---------------------------------------------------------------------------
# occurrences / crossings
# ---------------------------------------------------------------------------


def count_level_crossings(low_data: ClimArray, high_data: ClimArray, threshold,
                          freq: str, op_low: str = "<", op_high: str = ">=") -> ClimArray:
    """Count days where low < thresh <= high (xclim generic.py:914)."""
    thresh = _thresh(threshold, low_data)
    high = convert_units_to(high_data, low_data)
    cond = compare(low_data, op_low, thresh) & compare(high, op_high, thresh)
    out = cond.astype(torch.float32).resample(freq).sum()
    return to_agg_units(out, low_data, "count")


def count_occurrences(data: ClimArray, threshold, freq: str, op: str,
                      constrain=None) -> ClimArray:
    """Count condition occurrences per period (xclim generic.py:961)."""
    out = threshold_count(data, op, threshold, freq, constrain)
    return to_agg_units(out, data, "count")


def bivariate_count_occurrences(data_var1: ClimArray, data_var2: ClimArray,
                                threshold_var1, threshold_var2, freq: str,
                                op_var1: str, op_var2: str,
                                var_reducer: str = "all") -> ClimArray:
    """Count joint condition occurrences (xclim generic.py:1003)."""
    t1 = _thresh(threshold_var1, data_var1)
    t2 = _thresh(threshold_var2, data_var2)
    c1 = compare(data_var1, op_var1, t1)
    c2 = compare(data_var2, op_var2, t2)
    c = (c1 & c2) if var_reducer == "all" else (c1 | c2)
    out = c.astype(torch.float32).resample(freq).sum()
    return to_agg_units(out, data_var1, "count")


def diurnal_temperature_range(low_data: ClimArray, high_data: ClimArray, reducer: str,
                              freq: str) -> ClimArray:
    """Stat of (high - low) per period (xclim generic.py:1076)."""
    high = convert_units_to(high_data, low_data)
    dtr = high - low_data
    out = getattr(dtr.resample(freq), reducer)()
    out.attrs.update(pint2cfattrs(units2pint(low_data), is_difference=True))
    return out


def first_occurrence(data: ClimArray, threshold, freq: str, op: str,
                     constrain=None) -> ClimArray:
    """Doy of first condition occurrence per period (xclim generic.py:1109)."""
    cond = compare(data, op, _thresh(threshold, data), constrain)
    out = rl.first_run(cond, 1, freq=freq, coord="dayofyear")
    return to_agg_units(out, data, "doymax")


def last_occurrence(data: ClimArray, threshold, freq: str, op: str,
                    constrain=None) -> ClimArray:
    """Doy of last condition occurrence per period (xclim generic.py:1157)."""
    cond = compare(data, op, _thresh(threshold, data), constrain)
    out = rl.last_run(cond, 1, freq=freq, coord="dayofyear")
    return to_agg_units(out, data, "doymax")


def statistics(data: ClimArray, reducer: str, freq: str) -> ClimArray:
    """Plain resample statistic (xclim generic.py:1255)."""
    out = getattr(data.resample(freq), reducer)()
    out.attrs["units"] = data.attrs.get("units", "")
    return out


def thresholded_statistics(data: ClimArray, op: str, threshold, reducer: str, freq: str,
                           constrain=None) -> ClimArray:
    """Resample statistic over condition-holding steps only
    (xclim generic.py:1279)."""
    cond = compare(data, op, _thresh(threshold, data), constrain)
    out = getattr(data.where(cond).resample(freq), reducer)()
    out.attrs["units"] = data.attrs.get("units", "")
    return out


def temperature_sum(data: ClimArray, op: str, threshold, freq: str) -> ClimArray:
    """Sum of (data - thresh) over steps where op holds, signed (xclim :1324)."""
    thresh = _thresh(threshold, data)
    cond = compare(data, op, thresh, (">", "<"))
    direction = -1 if op in ("<", "lt") else 1
    out = (data - thresh).where(cond, 0.0).resample(freq).sum() * direction
    out.attrs["units"] = data.attrs.get("units", "")
    return to_agg_units(out, data, "integral")


def interday_diurnal_temperature_range(low_data: ClimArray, high_data: ClimArray,
                                       freq: str) -> ClimArray:
    """Mean absolute day-to-day variation of DTR (xclim generic.py:1360)."""
    high = convert_units_to(high_data, low_data)
    vdtr = abs((high - low_data).diff_time())
    out = vdtr.resample(freq).mean()
    out.attrs.update(pint2cfattrs(units2pint(low_data), is_difference=True))
    return out


def extreme_temperature_range(low_data: ClimArray, high_data: ClimArray,
                              freq: str) -> ClimArray:
    """max(high) - min(low) per period (xclim generic.py:1388)."""
    high = convert_units_to(high_data, low_data)
    out = high.resample(freq).max() - low_data.resample(freq).min()
    out.attrs.update(pint2cfattrs(units2pint(low_data), is_difference=True))
    return out


# ---------------------------------------------------------------------------
# date-windowed aggregation
# ---------------------------------------------------------------------------


_MAX_DOM = {1: 31, 2: 29, 3: 31, 4: 30, 5: 31, 6: 30, 7: 31, 8: 31, 9: 30,
            10: 31, 11: 30, 12: 31}


def _md_key_checked(s: str) -> int:
    """'MM-DD' → month*100+day, raising on malformed dates
    (the reference's datetime parse raises on e.g. '02-31')."""
    mm, dd = s.split("-")
    m, d = int(mm), int(dd)
    if not (1 <= m <= 12) or not (1 <= d <= _MAX_DOM[m]):
        raise ValueError(f"Invalid day-of-year date string {s!r}.")
    return m * 100 + d


def aggregate_between_dates(data: ClimArray, start, end, op: str = "sum",
                            freq: str = "YS") -> ClimArray:
    """Aggregate between two bounds, DayOfYearStr or per-period doy
    ClimArrays (xclim generic.py:1417).

    Reference semantics (pinned by xclim:tests/test_generic.py:127-316):
    each bound is located WITHIN its resampling segment as the first step
    matching the bound's day-of-year (or month-day for strings), so windows
    may wrap a non-January anchor; the end bound is EXCLUSIVE (the
    reference masks ``days <= end_d - 1``, generic.py:1499). Segments where
    a bound is NaN, never occurs, or starts after it ends yield NaN; a
    valid empty window sums to 0 (xarray ``sum(skipna=True)``).
    """
    spec = resample_segments(data.time, freq)
    time = data.time
    n = len(time)
    ax = data.time_axis
    dev = data.data.device
    seg_np = np.asarray(spec.seg_id)
    segt = torch.as_tensor(seg_np, dtype=torch.int64, device=dev)
    first_step = np.zeros(spec.nseg, dtype=np.int64)
    first_step[seg_np[::-1]] = np.arange(n)[::-1]
    # days since segment start, per step (daily data; the reference
    # subtracts timestamps, generic.py:1496)
    d_np = (np.arange(n) - first_step[seg_np]).astype(np.float32)
    doy_np = time.doy.astype(np.float32)
    md_np = (time.month * 100 + time.day).astype(np.float32)

    def bshape(arr1d):
        sh = [1] * data.ndim
        sh[ax] = n
        return torch.as_tensor(arr1d, device=dev).reshape(sh)

    dj = bshape(d_np)

    def seg_reduce_min(vals):
        """Segmented min over the time axis: (n, ...) -> (nseg, ...)."""
        v0 = vals.movedim(ax, 0)
        idx = segt.reshape((n,) + (1,) * (v0.ndim - 1)).expand(v0.shape)
        out = torch.full((spec.nseg,) + tuple(v0.shape[1:]), torch.inf,
                         dtype=v0.dtype, device=dev)
        return out.scatter_reduce(0, idx, v0, "amin")

    def locate(bound):
        """Days-since-segment-start of the bound, (nseg, ...) with +inf
        where the bound never occurs and NaN where the bound is NaN."""
        if isinstance(bound, str):
            k = _md_key_checked(bound)
            cand = torch.where(bshape(md_np) == float(k), dj, torch.inf)
            return seg_reduce_min(cand)
        b = bound.data if isinstance(bound, ClimArray) else torch.as_tensor(
            bound, device=dev)
        if b.ndim == 1:
            sh = [1] * data.ndim
            sh[ax] = spec.nseg
            b = b.reshape(sh)
        B = torch.index_select(b, ax, segt)  # per-step bound value
        cand = torch.where(bshape(doy_np) == B, dj, torch.inf)
        loc = seg_reduce_min(cand)
        # propagate NaN bounds (min with inf loses them)
        return torch.where(torch.isnan(b.movedim(ax, 0)), torch.nan, loc)

    S = locate(start)  # (nseg, ...)
    E = locate(end)
    bad = (torch.isnan(S) | torch.isnan(E) | torch.isinf(S) | torch.isinf(E)
           | (S > E))
    Ss = S.index_select(0, segt).movedim(0, ax)
    Es = E.index_select(0, segt).movedim(0, ax)
    mask = (dj >= Ss) & (dj < Es)

    if op in ("sum", "integral"):
        # xarray sum(skipna=True): excluded/NaN steps contribute 0, an
        # empty-but-valid window sums to 0
        filled = torch.where(mask & ~torch.isnan(data.data), data.data, 0.0)
        out = data.copy(data=filled).resample(freq).sum()
    else:
        masked = data.copy(data=torch.where(mask, data.data, torch.nan))
        out = getattr(masked.resample(freq), op)()
    oshape = list(out.shape)
    del oshape[ax]
    badb = torch.broadcast_to(bad, [spec.nseg] + oshape).movedim(0, ax)
    out = out.copy(data=torch.where(badb, torch.nan, out.data))
    out.attrs["units"] = data.attrs.get("units", "")
    if op == "integral":
        return to_agg_units(out, data, "integral")
    return out


def cumulative_difference(data: ClimArray, threshold, op: str,
                          freq: str | None = None) -> ClimArray:
    """Degree-day style cumulative difference (xclim generic.py:1515)."""
    thresh = _thresh(threshold, data)
    # the reference's DIFFERENCE_OPERATORS accept the -or-equal variants
    # too (identical arithmetic: the boundary contributes zero)
    if op in ("<", "lt", "<=", "le"):
        diff = (thresh - data).clip(0)
    elif op in (">", "gt", ">=", "ge"):
        diff = (data - thresh).clip(0)
    else:
        raise ValueError(f"Operation `{op}` not supported.")
    if freq is not None:
        diff = diff.resample(freq).sum()
    diff.attrs["units"] = data.attrs.get("units", "")
    return to_agg_units(diff, data, "integral")


@declare_relative_units(threshold="<data>")
def first_day_threshold_reached(data: ClimArray, threshold, op: str, after_date: str,
                                window: int = 1, freq: str = "YS",
                                constrain=None) -> ClimArray:
    """First doy (after after_date) where condition holds `window` days
    (xclim generic.py:1556)."""
    cond = compare(data, op, _thresh(threshold, data), constrain)
    out = rl.first_run_after_date(cond, window=window, date=after_date, freq=freq,
                                  coord="dayofyear")
    return to_agg_units(out, data, "doymax")


# ---------------------------------------------------------------------------
# zones & detrend
# ---------------------------------------------------------------------------


def get_zones(da: ClimArray, zone_min=None, zone_max=None, zone_step=None,
              bins=None, exclude_boundary_zones: bool = True,
              close_last_zone_right_boundary: bool = True) -> ClimArray:
    """Bin data into integer zones (xclim generic.py:1642)."""
    if bins is None:
        if zone_min is None or zone_max is None or zone_step is None:
            raise ValueError("Provide either bins or zone_min/zone_max/zone_step.")
        lo = _thresh(zone_min, da)
        hi = _thresh(zone_max, da)
        # the step is a difference: convert by scale only (no degC/degF offset)
        sq = str2pint(zone_step) if isinstance(zone_step, str) else None
        if sq is not None:
            step = sq.magnitude * sq.units.scale / units2pint(da).scale
        else:
            step = float(zone_step)
        nzone = int(round((hi - lo) / step))
        edges = np.linspace(lo, hi, nzone + 1)
    else:
        edges = np.asarray([_thresh(b, da) for b in bins], dtype=np.float64)
    x = da.data
    e = torch.as_tensor(edges.astype(np.float32), device=x.device)
    idx = torch.searchsorted(e.to(x.dtype), x.contiguous(), right=True) - 1
    if close_last_zone_right_boundary:
        idx = torch.where(x == e[-1], len(edges) - 2, idx)
    out = idx.to(torch.float32)
    if exclude_boundary_zones:
        out = torch.where((x < e[0]) | (x > e[-1])
                          | ((x == e[-1]) & (not close_last_zone_right_boundary)),
                          torch.nan, out)
    out = torch.where(torch.isnan(x), torch.nan, out)
    res = da.copy(data=out)
    res.attrs = {"units": ""}
    return res


def detrend(da: ClimArray, deg: int = 1) -> ClimArray:
    """Subtract a least-squares polynomial fit along time (xclim generic.py:1711).

    The decimal-year axis is centered and scaled to ~[-1, 1] before building
    the Vandermonde so the float32 normal equations stay well-conditioned
    (an uncentered t≈2000 axis has cond(VtV) ~1e10 and produces garbage
    residuals in float32)."""
    t_np = da.time.decimal_year.astype(np.float64)
    t_np = t_np - t_np.mean()
    scale = np.abs(t_np).max()
    if scale > 0:
        t_np = t_np / scale
    x = da.data.movedim(da.time_axis, 0)
    t = torch.as_tensor(t_np.astype(np.float32), device=x.device)
    T = x.shape[0]
    flat = x.reshape(T, -1)
    V = torch.stack([t ** k for k in range(deg + 1)], dim=1)  # (T, deg+1)
    valid = ~torch.isnan(flat)
    f0 = torch.where(valid, flat, 0.0)
    # normal equations with NaN masking per column
    VtV = torch.einsum("ti,tj,tc->cij", V, V, valid.to(torch.float32))
    Vty = torch.einsum("ti,tc->ci", V, f0)
    eye = torch.eye(deg + 1, device=x.device)
    coef = torch.linalg.solve(VtV + 1e-8 * eye[None], Vty[..., None])[..., 0]
    trend = torch.einsum("ti,ci->tc", V, coef)
    out = (flat - trend).reshape(x.shape)
    return da.copy(data=out.movedim(0, da.time_axis))


def thresholded_events(data: ClimArray, thresh, op: str, window: int,
                       thresh_stop=None, op_stop: str | None = None,
                       window_stop: int = 1, freq: str | None = None):
    """Find all events defined by a start and a stop threshold condition
    (xclim generic.py:1740).

    An event starts after `window` consecutive steps satisfying
    ``data op thresh`` and ends after `window_stop` consecutive steps
    satisfying the stop condition (default: negation of the start condition).
    Returns a ClimDataset with event_length / event_effective_length /
    event_sum / event_start on a fixed-capacity 'event' dimension (NaN
    padded, as the JAX package's static form of the reference's ragged
    events).
    """
    thresh = convert_units_to(thresh, data)
    da_start = compare(data, op, thresh)
    if thresh_stop is None and op_stop is None:
        da_stop = ~da_start
    else:
        thresh_stop = convert_units_to(
            thresh_stop if thresh_stop is not None else thresh, data)
        if op_stop is None:
            inv = {"gt": "le", ">": "<=", "ge": "lt", ">=": "<",
                   "lt": "ge", "<": ">=", "le": "gt", "<=": ">",
                   "eq": "ne", "==": "!=", "ne": "eq", "!=": "=="}
            op_stop = inv[op]
        da_stop = compare(data, op_stop, thresh_stop)
    out = rl.find_events(da_start, window, da_stop, window_stop,
                         data=data, freq=freq)
    return ClimDataset(out)
