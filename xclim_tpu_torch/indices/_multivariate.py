"""Multivariate indices, with the percentile-based ones and their Zhang-2005
bootstrap (reference: xclim:src/xclim/indices/_multivariate.py).

The heat-wave indices evaluate both thresholds into one bool condition and
take its run statistics over resample periods: the ``spells`` kernel on a
CUDA tensor. ``liquid_precip_ratio`` without ``prsn`` and
``precip_accumulation`` / ``precip_average`` with a ``phase`` split the
precipitation by ``indices/converters.py``'s binary phase approximation.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.core.bootstrapping import percentile_bootstrap
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import resample_doy
from xclim_tpu_torch.core.units import (
    convert_units_to,
    declare_units,
    pint2cfattrs,
    rate2amount,
    str2pint,
    to_agg_units,
    units2pint,
)
from xclim_tpu_torch.indices import run_length as rl
from xclim_tpu_torch.indices.generic import compare, select_resample_op, threshold_count
from xclim_tpu_torch.ops.segments import rolling_reduce

__all__ = [
    "blowing_snow",
    "cold_and_dry_days",
    "cold_and_wet_days",
    "cold_spell_duration_index",
    "daily_temperature_range",
    "daily_temperature_range_variability",
    "days_over_precip_thresh",
    "extreme_temperature_range",
    "fraction_over_precip_thresh",
    "heat_wave_frequency",
    "heat_wave_max_length",
    "heat_wave_total_length",
    "high_precip_low_temp",
    "liquid_precip_ratio",
    "multiday_temperature_swing",
    "precip_accumulation",
    "precip_average",
    "rain_on_frozen_ground_days",
    "tg10p",
    "tg90p",
    "tn10p",
    "tn90p",
    "tx10p",
    "tx90p",
    "tx_tn_days_above",
    "warm_and_dry_days",
    "warm_and_wet_days",
    "warm_spell_duration_index",
    "water_cycle_intensity",
    "winter_rain_ratio",
]


def _per_thresh(per: ClimArray, da: ClimArray, context=None) -> ClimArray:
    per = convert_units_to(per, da, context=context)
    return resample_doy(per, da)


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def cold_spell_duration_index(tasmin: ClimArray, tasmin_per: ClimArray, window: int = 6,
                              freq: str = "YS", resample_before_rl: bool = True,
                              bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days in ≥window-day runs below the doy 10th percentile
    (xclim:_multivariate.py:69)."""
    thresh = _per_thresh(tasmin_per, tasmin)
    below = compare(tasmin, op, thresh, constrain=("<", "<="))
    out = rl.windowed_run_count(below, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmin, "count", deffreq="D")


def _combo_days(tas, pr, tas_per, pr_per, freq, tas_op, pr_op):
    tthr = _per_thresh(tas_per, tas)
    tcond = compare(tas, tas_op, tthr)
    pthr = _per_thresh(pr_per, pr, context="hydro")
    pcond = compare(pr, pr_op, pthr)
    both = (tcond & pcond).astype(torch.float32)
    resampled = both.resample(freq).sum()
    return to_agg_units(resampled, tas, "count", deffreq="D")


@declare_units(tas="[temperature]", pr="[precipitation]", tas_per="[temperature]",
               pr_per="[precipitation]")
def cold_and_dry_days(tas, pr, tas_per, pr_per, freq: str = "YS") -> ClimArray:
    """tas < 25th pctl & pr < 25th pctl (xclim:_multivariate.py:162)."""
    return _combo_days(tas, pr, tas_per, pr_per, freq, "<", "<")


@declare_units(tas="[temperature]", pr="[precipitation]", tas_per="[temperature]",
               pr_per="[precipitation]")
def warm_and_dry_days(tas, pr, tas_per, pr_per, freq: str = "YS") -> ClimArray:
    """tas > 75th pctl & pr < 25th pctl (xclim:_multivariate.py:228)."""
    return _combo_days(tas, pr, tas_per, pr_per, freq, ">", "<")


@declare_units(tas="[temperature]", pr="[precipitation]", tas_per="[temperature]",
               pr_per="[precipitation]")
def warm_and_wet_days(tas, pr, tas_per, pr_per, freq: str = "YS") -> ClimArray:
    """tas > 75th pctl & pr > 75th pctl (xclim:_multivariate.py:294)."""
    return _combo_days(tas, pr, tas_per, pr_per, freq, ">", ">")


@declare_units(tas="[temperature]", pr="[precipitation]", tas_per="[temperature]",
               pr_per="[precipitation]")
def cold_and_wet_days(tas, pr, tas_per, pr_per, freq: str = "YS") -> ClimArray:
    """tas < 25th pctl & pr > 75th pctl (xclim:_multivariate.py:360)."""
    return _combo_days(tas, pr, tas_per, pr_per, freq, "<", ">")


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def multiday_temperature_swing(tasmin: ClimArray, tasmax: ClimArray,
                               thresh_tasmin: str = "0 degC",
                               thresh_tasmax: str = "0 degC", window: int = 1,
                               op: str = "mean", op_tasmin: str = "<=",
                               op_tasmax: str = ">", freq: str = "YS",
                               resample_before_rl: bool = True) -> ClimArray:
    """Freeze-thaw cycle spell statistics (xclim:_multivariate.py:426)."""
    thaw = compare(tasmax, op_tasmax, convert_units_to(str2pint(thresh_tasmax), tasmax),
                   (">", ">="))
    freeze = compare(tasmin, op_tasmin, convert_units_to(str2pint(thresh_tasmin), tasmin),
                     ("<", "<="))
    ft = freeze & thaw
    if op == "count":
        out = rl.windowed_run_events(ft, window, freq=freq,
                                     resample_before_rl=resample_before_rl)
    else:
        out = rl.rle_statistics(ft, op, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmin, "count", deffreq="D")


@declare_units(tasmin="[temperature]", tasmax="[temperature]")
def daily_temperature_range(tasmin: ClimArray, tasmax: ClimArray, freq: str = "YS",
                            op: str = "mean") -> ClimArray:
    """Stat of (tasmax - tasmin) (xclim:_multivariate.py:514)."""
    tasmax = convert_units_to(tasmax, tasmin)
    dtr = tasmax - tasmin
    dtr.attrs.update(pint2cfattrs(units2pint(tasmax), is_difference=True))
    return select_resample_op(dtr, op=op, freq=freq,
                              out_units=dtr.attrs["units"]).assign_attrs(
        units_metadata="temperature: difference")


@declare_units(tasmin="[temperature]", tasmax="[temperature]")
def daily_temperature_range_variability(tasmin: ClimArray, tasmax: ClimArray,
                                        freq: str = "YS") -> ClimArray:
    """Mean absolute day-to-day DTR variation (xclim:_multivariate.py:561)."""
    tasmax = convert_units_to(tasmax, tasmin)
    vdtr = abs((tasmax - tasmin).diff_time())
    vdtr.attrs.update(pint2cfattrs(units2pint(tasmax), is_difference=True))
    return select_resample_op(vdtr, op="mean", freq=freq,
                              out_units=vdtr.attrs["units"]).assign_attrs(
        units_metadata="temperature: difference")


@declare_units(tasmin="[temperature]", tasmax="[temperature]")
def extreme_temperature_range(tasmin: ClimArray, tasmax: ClimArray,
                              freq: str = "YS") -> ClimArray:
    """max(tasmax) - min(tasmin) (xclim:_multivariate.py:601)."""
    tasmax = convert_units_to(tasmax, tasmin)
    out = tasmax.resample(freq).max() - tasmin.resample(freq).min()
    out.attrs.update(pint2cfattrs(units2pint(tasmax), is_difference=True))
    return out


def _heat_wave_cond(tasmin, tasmax, thresh_tasmin, thresh_tasmax, op):
    tmax = convert_units_to(str2pint(thresh_tasmax), tasmax)
    tmin = convert_units_to(str2pint(thresh_tasmin), tasmin)
    constrain = (">", ">=")
    return compare(tasmin, op, tmin, constrain) & compare(tasmax, op, tmax, constrain)


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def heat_wave_frequency(tasmin: ClimArray, tasmax: ClimArray,
                        thresh_tasmin: str = "22.0 degC",
                        thresh_tasmax: str = "30 degC", window: int = 3,
                        freq: str = "YS", op: str = ">",
                        resample_before_rl: bool = True) -> ClimArray:
    """Number of heat waves (xclim:_multivariate.py:646)."""
    cond = _heat_wave_cond(tasmin, tasmax, thresh_tasmin, thresh_tasmax, op)
    out = rl.windowed_run_events(cond, window, freq=freq,
                                 resample_before_rl=resample_before_rl)
    out.attrs["units"] = ""
    return out


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def heat_wave_max_length(tasmin: ClimArray, tasmax: ClimArray,
                         thresh_tasmin: str = "22.0 degC",
                         thresh_tasmax: str = "30 degC", window: int = 3,
                         freq: str = "YS", op: str = ">",
                         resample_before_rl: bool = True) -> ClimArray:
    """Longest heat wave (xclim:_multivariate.py:724)."""
    cond = _heat_wave_cond(tasmin, tasmax, thresh_tasmin, thresh_tasmax, op)
    out = rl.rle_statistics(cond, "max", window, freq=freq,
                            resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def heat_wave_total_length(tasmin: ClimArray, tasmax: ClimArray,
                           thresh_tasmin: str = "22.0 degC",
                           thresh_tasmax: str = "30 degC", window: int = 3,
                           freq: str = "YS", op: str = ">",
                           resample_before_rl: bool = True) -> ClimArray:
    """Total days inside heat waves (xclim:_multivariate.py:803)."""
    cond = _heat_wave_cond(tasmin, tasmax, thresh_tasmin, thresh_tasmax, op)
    out = rl.windowed_run_count(cond, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmin, "count", deffreq="D")


@declare_units(pr="[precipitation]", prsn="[precipitation]", tas="[temperature]",
               thresh="[temperature]")
def liquid_precip_ratio(pr: ClimArray, prsn: ClimArray | None = None,
                        tas: ClimArray | None = None, thresh: str = "0 degC",
                        freq: str = "QS-DEC") -> ClimArray:
    """Ratio of rain to total precipitation (xclim:_multivariate.py:871)."""
    if prsn is None and tas is not None:
        from xclim_tpu_torch.indices.converters import snowfall_approximation

        prsn = snowfall_approximation(pr, tas=tas, thresh=thresh, method="binary")
    elif prsn is None:
        raise KeyError("prsn or tas must be supplied.")
    tot = pr.resample(freq).sum()
    rain = tot - prsn.resample(freq).sum()
    ratio = rain / tot
    ratio.attrs["units"] = ""
    return ratio


@declare_units(pr="[precipitation]", tas="[temperature]", thresh="[temperature]")
def precip_accumulation(pr: ClimArray, tas: ClimArray | None = None,
                        phase: str | None = None, thresh: str = "0 degC",
                        freq: str = "YS") -> ClimArray:
    """Accumulated (liquid/solid/total) precipitation (xclim:_multivariate.py:930)."""
    if phase in ("liquid", "solid"):
        from xclim_tpu_torch.indices.converters import rain_approximation, snowfall_approximation

        fn = rain_approximation if phase == "liquid" else snowfall_approximation
        pr = fn(pr, tas=tas, thresh=thresh, method="binary")
    pram = rate2amount(pr)
    u = pram.attrs["units"]
    out = pram.resample(freq).sum()
    out.attrs["units"] = u
    return out


@declare_units(pr="[precipitation]", tas="[temperature]", thresh="[temperature]")
def precip_average(pr: ClimArray, tas: ClimArray | None = None,
                   phase: str | None = None, thresh: str = "0 degC",
                   freq: str = "YS") -> ClimArray:
    """Mean daily (liquid/solid/total) precipitation amount
    (xclim:_multivariate.py:994)."""
    if phase in ("liquid", "solid"):
        from xclim_tpu_torch.indices.converters import rain_approximation, snowfall_approximation

        fn = rain_approximation if phase == "liquid" else snowfall_approximation
        pr = fn(pr, tas=tas, thresh=thresh, method="binary")
    pram = rate2amount(pr)
    u = pram.attrs["units"]
    out = pram.resample(freq).mean()
    out.attrs["units"] = u
    return out


@declare_units(pr="[precipitation]", tas="[temperature]", thresh="[precipitation]")
def rain_on_frozen_ground_days(pr: ClimArray, tas: ClimArray, thresh: str = "1 mm/d",
                               window: int = 7, freq: str = "YS") -> ClimArray:
    """Rain days following `window` frozen days (xclim:_multivariate.py:1059)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    frz = convert_units_to(str2pint("0 degC"), tas)
    above = tas > frz  # (T, ...)
    ax = tas.time_axis
    # rolling sum of "frozen" over the window ending yesterday == window
    frozen_prev = rolling_reduce((~above).data.to(torch.float32), window,
                                 "sum", axis=ax)
    frozen_prev_shift = torch.roll(frozen_prev, 1, dims=ax)
    frozen_prev_shift.narrow(ax, 0, 1).fill_(torch.nan)
    tcond = (frozen_prev_shift == window) & above.data
    pcond = (pr > t).data
    both = ClimArray((tcond & pcond).to(torch.float32), tas.dims,
                     dict(tas.coords))
    out = both.resample(freq).sum()
    return to_agg_units(out, tas, "count", deffreq="D")


@declare_units(pr="[precipitation]", tas="[temperature]", pr_thresh="[precipitation]",
               tas_thresh="[temperature]")
def high_precip_low_temp(pr: ClimArray, tas: ClimArray, pr_thresh: str = "0.4 mm/d",
                         tas_thresh: str = "-0.2 degC", freq: str = "YS") -> ClimArray:
    """Days with heavy precip and low temperature (xclim:_multivariate.py:1128)."""
    pt = convert_units_to(str2pint(pr_thresh), pr, context="hydro")
    tt = convert_units_to(str2pint(tas_thresh), tas)
    cond = ((pr >= pt) & (tas < tt)).astype(torch.float32)
    out = cond.resample(freq).sum()
    return to_agg_units(out, pr, "count", deffreq="D")


@declare_units(pr="[precipitation]", pr_per="[precipitation]", thresh="[precipitation]")
@percentile_bootstrap
def days_over_precip_thresh(pr: ClimArray, pr_per: ClimArray, thresh: str = "1 mm/day",
                            freq: str = "YS", bootstrap: bool = False,
                            op: str = ">") -> ClimArray:
    """Days with precip above a percentile threshold (xclim:_multivariate.py:1176)."""
    per = convert_units_to(pr_per, pr, context="hydro")
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    tp = per.where(per > t, t)
    if "dayofyear" in tp.dims:
        tp = resample_doy(tp, pr)
    out = threshold_count(pr, op, tp, freq, constrain=(">", ">="))
    return to_agg_units(out, pr, "count", deffreq="D")


@declare_units(pr="[precipitation]", pr_per="[precipitation]", thresh="[precipitation]")
@percentile_bootstrap
def fraction_over_precip_thresh(pr: ClimArray, pr_per: ClimArray,
                                thresh: str = "1 mm/day", freq: str = "YS",
                                bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Fraction of total precip from days above the percentile
    (xclim:_multivariate.py:1238)."""
    per = convert_units_to(pr_per, pr, context="hydro")
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    tp = per.where(per > t, t)
    if "dayofyear" in tp.dims:
        tp = resample_doy(tp, pr)
    constrain = (">", ">=")
    total = pr.where(compare(pr, op, t, constrain), 0).resample(freq).sum()
    over = pr.where(compare(pr, op, tp, constrain), 0).resample(freq).sum()
    out = over / total
    out.attrs["units"] = ""
    return out


def _t_percentile_days(da, per, freq, op, constrain):
    thresh = _per_thresh(per, da)
    out = threshold_count(da, op, thresh, freq, constrain=constrain)
    return to_agg_units(out, da, "count", deffreq="D")


@declare_units(tas="[temperature]", tas_per="[temperature]")
@percentile_bootstrap
def tg90p(tas: ClimArray, tas_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tas over the 90th doy percentile (xclim:_multivariate.py:1300)."""
    return _t_percentile_days(tas, tas_per, freq, op, (">", ">="))


@declare_units(tas="[temperature]", tas_per="[temperature]")
@percentile_bootstrap
def tg10p(tas: ClimArray, tas_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tas under the 10th doy percentile (xclim:_multivariate.py:1359)."""
    return _t_percentile_days(tas, tas_per, freq, op, ("<", "<="))


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def tn90p(tasmin: ClimArray, tasmin_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tasmin over the 90th doy percentile (xclim:_multivariate.py:1418)."""
    return _t_percentile_days(tasmin, tasmin_per, freq, op, (">", ">="))


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def tn10p(tasmin: ClimArray, tasmin_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tasmin under the 10th doy percentile (xclim:_multivariate.py:1477)."""
    return _t_percentile_days(tasmin, tasmin_per, freq, op, ("<", "<="))


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def tx90p(tasmax: ClimArray, tasmax_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tasmax over the 90th doy percentile (xclim:_multivariate.py:1536)."""
    return _t_percentile_days(tasmax, tasmax_per, freq, op, (">", ">="))


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def tx10p(tasmax: ClimArray, tasmax_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tasmax under the 10th doy percentile (xclim:_multivariate.py:1595)."""
    return _t_percentile_days(tasmax, tasmax_per, freq, op, ("<", "<="))


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def tx_tn_days_above(tasmin: ClimArray, tasmax: ClimArray,
                     thresh_tasmin: str = "22 degC", thresh_tasmax: str = "30 degC",
                     freq: str = "YS", op: str = ">") -> ClimArray:
    """Days with both tx and tn above thresholds (xclim:_multivariate.py:1658)."""
    cond = _heat_wave_cond(tasmin, tasmax, thresh_tasmin, thresh_tasmax, op)
    out = cond.astype(torch.float32).resample(freq).sum()
    return to_agg_units(out, tasmin, "count", deffreq="D")


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def warm_spell_duration_index(tasmax: ClimArray, tasmax_per: ClimArray, window: int = 6,
                              freq: str = "YS", resample_before_rl: bool = True,
                              bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days in ≥window-day runs over the doy 90th percentile
    (xclim:_multivariate.py:1719)."""
    thresh = _per_thresh(tasmax_per, tasmax)
    above = compare(tasmax, op, thresh, constrain=(">", ">="))
    out = rl.windowed_run_count(above, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(pr="[precipitation]", prsn="[precipitation]", tas="[temperature]")
def winter_rain_ratio(pr: ClimArray, prsn: ClimArray | None = None,
                      tas: ClimArray | None = None, freq: str = "QS-DEC") -> ClimArray:
    """Liquid precip ratio restricted to winter quarters
    (xclim:_multivariate.py:1797)."""
    ratio = liquid_precip_ratio(pr, prsn, tas, freq=freq)
    winter = ratio.time.month == 12
    return ratio.sel_time(mask=winter)


@declare_units(snd="[length]", sfcWind="[speed]", snd_thresh="[length]",
               sfcWind_thresh="[speed]")
def blowing_snow(snd: ClimArray, sfcWind: ClimArray, snd_thresh: str = "5 cm",
                 sfcWind_thresh: str = "15 km/h", window: int = 3,
                 freq: str = "YS-JUL", **indexer) -> ClimArray:
    """Days with fresh snow over last `window` days and high wind
    (xclim:_multivariate.py:1833)."""
    st = convert_units_to(str2pint(snd_thresh), snd)
    wt = convert_units_to(str2pint(sfcWind_thresh), sfcWind)
    ax = snd.time_axis
    d = torch.diff(snd.data, dim=ax)
    pad = torch.full_like(d.narrow(ax, 0, 1), torch.nan)
    snow = rolling_reduce(torch.cat([pad, d], dim=ax), window, "sum", axis=ax)
    snowc = ClimArray(snow, snd.dims, dict(snd.coords)).select_time(**indexer)
    wind = sfcWind.select_time(**indexer)
    cond = ((snowc >= st) & (wind >= wt)).astype(torch.float32)
    out = cond.resample(freq).sum()
    return to_agg_units(out, snd, "count", deffreq="D")


@declare_units(pr="[precipitation]", evspsbl="[precipitation]")
def water_cycle_intensity(pr: ClimArray, evspsbl: ClimArray, freq: str = "YS") -> ClimArray:
    """Sum of precipitation and evapotranspiration amounts
    (xclim:_multivariate.py:1888)."""
    pr = convert_units_to(pr, evspsbl)
    wci = pr + evspsbl
    wci.attrs["units"] = evspsbl.attrs["units"]
    wci.coords["time"] = pr.time
    wam = rate2amount(wci)
    u = wam.attrs["units"]
    out = wam.resample(freq).sum()
    out.attrs["units"] = u
    return out
