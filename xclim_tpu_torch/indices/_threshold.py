"""Threshold indices (reference: xclim:src/xclim/indices/_threshold.py).

Every function composes the generic building blocks. On a CUDA tensor the
day counts of a scalar threshold and the spell statistics over resample
periods run the ``spells`` kernel, the other per-period sums and means
(degree days, amounts) run ``segred``; CPU tensors take the kernels' plain
twins. Counts, run lengths and days of year equal the reference's; float
sums are accumulated in float64 and rounded once, where the reference adds
float32 partials, so they differ from it by a few float32 ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import (
    doy_from_string,
    get_calendar,
    resample_segments,
)
from xclim_tpu_torch.core.dataarray import ClimArray, where
from xclim_tpu_torch.core.missing import at_least_n_valid
from xclim_tpu_torch.core.units import (
    convert_units_to,
    declare_units,
    parse_units,
    rate2amount,
    str2pint,
    to_agg_units,
    units,
    units2pint,
)
from xclim_tpu_torch.indices import run_length as rl
from xclim_tpu_torch.indices.generic import (
    bivariate_count_occurrences,
    compare,
    count_occurrences,
    cumulative_difference,
    domain_count,
    first_day_threshold_reached,
    season,
    spell_length_statistics,
    threshold_count,
)
from xclim_tpu_torch.ops import runlength as _rlops

__all__ = [
    "calm_days",
    "cold_spell_days",
    "days_with_snow",
    "cold_spell_frequency",
    "cold_spell_max_length",
    "cold_spell_total_length",
    "cooling_degree_days",
    "cooling_degree_days_approximation",
    "daily_pr_intensity",
    "degree_days_exceedance_date",
    "dry_days",
    "dry_spell_frequency",
    "dry_spell_max_length",
    "dry_spell_total_length",
    "first_day_temperature_above",
    "first_day_temperature_below",
    "first_snowfall",
    "frost_free_season_end",
    "frost_free_season_length",
    "frost_free_season_start",
    "frost_free_spell_max_length",
    "frost_season_length",
    "growing_degree_days",
    "growing_season_end",
    "growing_season_length",
    "growing_season_start",
    "heat_wave_index",
    "heating_degree_days",
    "heating_degree_days_approximation",
    "holiday_snow_days",
    "holiday_snow_and_snowfall_days",
    "hot_spell_frequency",
    "hot_spell_max_length",
    "hot_spell_max_magnitude",
    "hot_spell_total_length",
    "last_snowfall",
    "last_spring_frost",
    "maximum_consecutive_dry_days",
    "maximum_consecutive_frost_days",
    "maximum_consecutive_frost_free_days",
    "maximum_consecutive_tx_days",
    "maximum_consecutive_wet_days",
    "rprctot",
    "sea_ice_area",
    "sea_ice_extent",
    "snd_days_above",
    "snd_season_end",
    "snd_season_length",
    "snd_season_start",
    "snd_storm_days",
    "snowfall_frequency",
    "snowfall_intensity",
    "snw_days_above",
    "snw_season_end",
    "snw_season_length",
    "snw_season_start",
    "snw_storm_days",
    "tg_days_above",
    "tg_days_below",
    "tn_days_above",
    "tn_days_below",
    "tx_days_above",
    "tx_days_below",
    "warm_day_frequency",
    "warm_night_frequency",
    "wet_spell_frequency",
    "wet_spell_max_length",
    "wet_spell_total_length",
    "wetdays",
    "wetdays_prop",
    "windy_days",
]


def _doy_attrs(da):
    # day-of-year outputs carry units "1" (xclim:tests/test_indices.py
    # TestLastSpringFrost / TestFirstDayBelow assert this exact value)
    return {"units": "1", "is_dayofyear": np.int32(1),
            "calendar": get_calendar(da)}


# ---------------------------------------------------------------------------
# wind
# ---------------------------------------------------------------------------


@declare_units(sfcWind="[speed]", thresh="[speed]")
def calm_days(sfcWind: ClimArray, thresh: str = "2 m s-1", freq: str = "MS") -> ClimArray:
    """Days with wind < thresh (xclim:_threshold.py:122)."""
    out = threshold_count(sfcWind, "<", thresh, freq)
    return to_agg_units(out, sfcWind, "count", deffreq="D")


@declare_units(sfcWind="[speed]", thresh="[speed]")
def windy_days(sfcWind: ClimArray, thresh: str = "10.8 m s-1", freq: str = "MS") -> ClimArray:
    """Days with wind >= thresh (xclim:_threshold.py:3135)."""
    out = threshold_count(sfcWind, ">=", thresh, freq)
    return to_agg_units(out, sfcWind, "count", deffreq="D")


# ---------------------------------------------------------------------------
# cold spells
# ---------------------------------------------------------------------------


@declare_units(tas="[temperature]", thresh="[temperature]")
def cold_spell_days(tas: ClimArray, thresh: str = "-10 degC", window: int = 5,
                    freq: str = "YS-JUL", op: str = "<",
                    resample_before_rl: bool = True) -> ClimArray:
    """Days inside ≥window-day cold spells (xclim:_threshold.py:158)."""
    t = convert_units_to(str2pint(thresh), tas)
    over = compare(tas, op, t, constrain=("<", "<="))
    out = rl.windowed_run_count(over, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tas, "count", deffreq="D")


@declare_units(tas="[temperature]", thresh="[temperature]")
def cold_spell_frequency(tas: ClimArray, thresh: str = "-10 degC", window: int = 5,
                         freq: str = "YS-JUL", op: str = "<",
                         resample_before_rl: bool = True) -> ClimArray:
    """Number of cold spell events (xclim:_threshold.py:218)."""
    t = convert_units_to(str2pint(thresh), tas)
    over = compare(tas, op, t, constrain=("<", "<="))
    out = rl.windowed_run_events(over, window, freq=freq,
                                 resample_before_rl=resample_before_rl)
    out.attrs["units"] = ""
    return out


@declare_units(tas="[temperature]", thresh="[temperature]")
def cold_spell_max_length(tas: ClimArray, thresh: str = "-10 degC", window: int = 1,
                          freq: str = "YS-JUL", op: str = "<",
                          resample_before_rl: bool = True) -> ClimArray:
    """Longest cold spell, 0 when shorter than window (xclim:_threshold.py:267)."""
    t = convert_units_to(str2pint(thresh), tas)
    cond = compare(tas, op, t, constrain=("<", "<="))
    max_l = rl.longest_run(cond, freq=freq, resample_before_rl=resample_before_rl)
    max_window = max_l.where(max_l >= window, 0)
    return to_agg_units(max_window, tas, "count", deffreq="D")


@declare_units(tas="[temperature]", thresh="[temperature]")
def cold_spell_total_length(tas: ClimArray, thresh: str = "-10 degC", window: int = 3,
                            freq: str = "YS-JUL", op: str = "<",
                            resample_before_rl: bool = True) -> ClimArray:
    """Total days in cold spells (xclim:_threshold.py:317)."""
    t = convert_units_to(str2pint(thresh), tas)
    cond = compare(tas, op, t, constrain=("<", "<="))
    out = rl.windowed_run_count(cond, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tas, "count", deffreq="D")


# ---------------------------------------------------------------------------
# snow seasons & storms
# ---------------------------------------------------------------------------


def _snow_season(var: ClimArray, thresh, window, freq, stat) -> ClimArray:
    valid = at_least_n_valid(var.where(var > 0), n=1, freq=freq)
    out = season(var, thresh, window=window, op=">=", stat=stat, freq=freq)
    return out.where(~valid)


@declare_units(snd="[length]", thresh="[length]")
def snd_season_end(snd: ClimArray, thresh: str = "2 cm", window: int = 14,
                   freq: str = "YS-JUL") -> ClimArray:
    """End of the continuous snow-depth season (xclim:_threshold.py:366)."""
    return _snow_season(snd, thresh, window, freq, "end")


@declare_units(snw="[mass]/[area]", thresh="[mass]/[area]")
def snw_season_end(snw: ClimArray, thresh: str = "4 kg m-2", window: int = 14,
                   freq: str = "YS-JUL") -> ClimArray:
    """End of the continuous snow-amount season (xclim:_threshold.py:406)."""
    return _snow_season(snw, thresh, window, freq, "end")


@declare_units(snd="[length]", thresh="[length]")
def snd_season_start(snd: ClimArray, thresh: str = "2 cm", window: int = 14,
                     freq: str = "YS-JUL") -> ClimArray:
    """Start of the continuous snow-depth season (xclim:_threshold.py:445)."""
    return _snow_season(snd, thresh, window, freq, "start")


@declare_units(snw="[mass]/[area]", thresh="[mass]/[area]")
def snw_season_start(snw: ClimArray, thresh: str = "4 kg m-2", window: int = 14,
                     freq: str = "YS-JUL") -> ClimArray:
    """Start of the continuous snow-amount season (xclim:_threshold.py:484)."""
    return _snow_season(snw, thresh, window, freq, "start")


@declare_units(snd="[length]", thresh="[length]")
def snd_season_length(snd: ClimArray, thresh: str = "2 cm", window: int = 14,
                      freq: str = "YS-JUL") -> ClimArray:
    """Length of the continuous snow-depth season (xclim:_threshold.py:522)."""
    return _snow_season(snd, thresh, window, freq, "length")


@declare_units(snw="[mass]/[area]", thresh="[mass]/[area]")
def snw_season_length(snw: ClimArray, thresh: str = "4 kg m-2", window: int = 14,
                      freq: str = "YS-JUL") -> ClimArray:
    """Length of the continuous snow-amount season (xclim:_threshold.py:561)."""
    return _snow_season(snw, thresh, window, freq, "length")


@declare_units(snd="[length]", thresh="[length]")
def snd_storm_days(snd: ClimArray, thresh: str = "25 cm", freq: str = "YS-JUL") -> ClimArray:
    """Days with snow-depth accumulation ≥ thresh (xclim:_threshold.py:600)."""
    acc = snd.diff_time()
    acc.attrs["units"] = snd.attrs.get("units", "")
    out = threshold_count(acc, ">=", convert_units_to(str2pint(thresh), snd), freq)
    return to_agg_units(out, snd, "count", deffreq="D")


@declare_units(snw="[mass]/[area]", thresh="[mass]/[area]")
def snw_storm_days(snw: ClimArray, thresh: str = "10 kg m-2", freq: str = "YS-JUL") -> ClimArray:
    """Days with snow-amount accumulation ≥ thresh (xclim:_threshold.py:640)."""
    acc = snw.diff_time()
    acc.attrs["units"] = snw.attrs.get("units", "")
    out = threshold_count(acc, ">=", convert_units_to(str2pint(thresh), snw), freq)
    return to_agg_units(out, snw, "count", deffreq="D")


# ---------------------------------------------------------------------------
# precipitation
# ---------------------------------------------------------------------------


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def daily_pr_intensity(pr: ClimArray, thresh: str = "1 mm/day", freq: str = "YS",
                       op: str = ">=") -> ClimArray:
    """Mean precipitation amount over wet days (xclim:_threshold.py:680)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    pram = rate2amount(pr)
    comparison = compare(pr, op, t, constrain=(">", ">="))
    pram_wd = where(comparison, pram, 0)
    s = pram_wd.resample(freq).sum()
    wd = wetdays(pr, thresh=thresh, freq=freq)
    out = s / wd
    out.attrs["units"] = (units2pint(pram.attrs["units"]) / units2pint(wd.attrs["units"])).to_cf()
    return out


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def dry_days(pr: ClimArray, thresh: str = "0.2 mm/d", freq: str = "YS",
             op: str = "<") -> ClimArray:
    """Days with precipitation below threshold (xclim:_threshold.py:756)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    count = threshold_count(pr, op, t, freq, constrain=("<", "<="))
    return to_agg_units(count, pr, "count", deffreq="D")


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def maximum_consecutive_wet_days(pr: ClimArray, thresh: str = "1 mm/day",
                                 op: str = ">=", freq: str = "YS",
                                 resample_before_rl: bool = True) -> ClimArray:
    """Longest wet spell (xclim:_threshold.py:799 — threshold conversion
    under ``with units.context("hydro")``, :830)."""
    with units.context("hydro"):
        return spell_length_statistics(pr, thresh, 1, win_reducer="min",
                                       op=op, spell_reducer="max", freq=freq,
                                       resample_before_rl=resample_before_rl)


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def maximum_consecutive_dry_days(pr: ClimArray, thresh: str = "1 mm/day",
                                 op: str = "<", freq: str = "YS",
                                 resample_before_rl: bool = True) -> ClimArray:
    """Longest dry spell (xclim:_threshold.py:2896 — threshold conversion
    under ``with units.context("hydro")``, :2927)."""
    with units.context("hydro"):
        return spell_length_statistics(pr, thresh, 1, win_reducer="max",
                                       op=op, spell_reducer="max", freq=freq,
                                       resample_before_rl=resample_before_rl)


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def wetdays(pr: ClimArray, thresh: str = "1.0 mm/day", freq: str = "YS",
            op: str = ">=") -> ClimArray:
    """Wet days count (xclim:_threshold.py:2749)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    wd = threshold_count(pr, op, t, freq, constrain=(">", ">="))
    return to_agg_units(wd, pr, "count", deffreq="D")


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def wetdays_prop(pr: ClimArray, thresh: str = "1.0 mm/day", freq: str = "YS",
                 op: str = ">=") -> ClimArray:
    """Fraction of wet days (xclim:_threshold.py:2792)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    wd = compare(pr, op, t, constrain=(">", ">="))
    fwd = wd.astype(torch.float32).resample(freq).mean()
    fwd.attrs["units"] = "1"
    return fwd


@declare_units(pr="[precipitation]", prc="[precipitation]", thresh="[precipitation]")
def rprctot(pr: ClimArray, prc: ClimArray, thresh: str = "1.0 mm/day", freq: str = "YS",
            op: str = ">=") -> ClimArray:
    """Convective-over-total precipitation ratio on wet days
    (xclim:_threshold.py:3170)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    prc = convert_units_to(prc, pr)
    wd = compare(pr, op, t)
    pr_tot = rate2amount(pr).where(wd).resample(freq).sum()
    prc_tot = rate2amount(prc).where(wd).resample(freq).sum()
    ratio = prc_tot / pr_tot
    ratio.attrs["units"] = ""
    return ratio


def _dry_wet_spell(pr, thresh, window, win_reducer, cmp_op, spell_reducer, freq,
                   resample_before_rl, **indexer):
    pram = rate2amount(convert_units_to(pr, "mm/d", context="hydro"), out_units="mm")
    return spell_length_statistics(pram, thresh, window=window, win_reducer=win_reducer,
                                   op=cmp_op, spell_reducer=spell_reducer, freq=freq,
                                   resample_before_rl=resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def dry_spell_frequency(pr: ClimArray, thresh: str = "1.0 mm", window: int = 3,
                        freq: str = "YS", resample_before_rl: bool = True,
                        op: str = "sum", **indexer) -> ClimArray:
    """Number of dry spells (xclim:_threshold.py:3314)."""
    return _dry_wet_spell(pr, thresh, window, op, "<", "count", freq,
                          resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def dry_spell_total_length(pr: ClimArray, thresh: str = "1.0 mm", window: int = 3,
                           op: str = "sum", freq: str = "YS",
                           resample_before_rl: bool = True, **indexer) -> ClimArray:
    """Total days in dry spells (xclim:_threshold.py:3385)."""
    return _dry_wet_spell(pr, thresh, window, op, "<", "sum", freq,
                          resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def dry_spell_max_length(pr: ClimArray, thresh: str = "1.0 mm", window: int = 1,
                         op: str = "sum", freq: str = "YS",
                         resample_before_rl: bool = True, **indexer) -> ClimArray:
    """Longest dry spell (xclim:_threshold.py:3457)."""
    return _dry_wet_spell(pr, thresh, window, op, "<", "max", freq,
                          resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def wet_spell_frequency(pr: ClimArray, thresh: str = "1.0 mm", window: int = 3,
                        freq: str = "YS", resample_before_rl: bool = True,
                        op: str = "sum", **indexer) -> ClimArray:
    """Number of wet spells (xclim:_threshold.py:3525)."""
    return _dry_wet_spell(pr, thresh, window, op, ">=", "count", freq,
                          resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def wet_spell_total_length(pr: ClimArray, thresh: str = "1.0 mm", window: int = 3,
                           op: str = "sum", freq: str = "YS",
                           resample_before_rl: bool = True, **indexer) -> ClimArray:
    """Total days in wet spells (xclim:_threshold.py:3596)."""
    return _dry_wet_spell(pr, thresh, window, op, ">=", "sum", freq,
                          resample_before_rl, **indexer)


@declare_units(pr="[precipitation]", thresh="[length]")
def wet_spell_max_length(pr: ClimArray, thresh: str = "1.0 mm", window: int = 1,
                         op: str = "sum", freq: str = "YS",
                         resample_before_rl: bool = True, **indexer) -> ClimArray:
    """Longest wet spell (xclim:_threshold.py:3667)."""
    return _dry_wet_spell(pr, thresh, window, op, ">=", "max", freq,
                          resample_before_rl, **indexer)


# ---------------------------------------------------------------------------
# degree days
# ---------------------------------------------------------------------------


@declare_units(tas="[temperature]", thresh="[temperature]")
def cooling_degree_days(tas: ClimArray, thresh: str = "18 degC", freq: str = "YS") -> ClimArray:
    """Sum of degrees above threshold (xclim:_threshold.py:905)."""
    return cumulative_difference(tas, threshold=thresh, op=">", freq=freq)


@declare_units(tasmax="[temperature]", tasmin="[temperature]", tas="[temperature]",
               thresh="[temperature]")
def cooling_degree_days_approximation(tasmax: ClimArray, tasmin: ClimArray,
                                      tas: ClimArray, thresh: str = "18 degC",
                                      freq: str = "YS") -> ClimArray:
    """UK Met Office CDD approximation from tx/tn/tg (xclim:_threshold.py:844)."""
    t = convert_units_to(str2pint(thresh), tas)
    tasmax = convert_units_to(tasmax, tas)
    tasmin = convert_units_to(tasmin, tas)
    cdd = where(tasmax < t, 0,
                where(tasmin < t,
                      where(tas <= t, (tasmax - t) / 4,
                            (tasmax - t) / 2 - (t - tasmin) / 4),
                      tas - t))
    out = cdd.resample(freq).sum()
    out.attrs["units"] = tas.attrs.get("units", "")
    return to_agg_units(out, tas, "integral", deffreq="D")


@declare_units(tasmax="[temperature]", tasmin="[temperature]", tas="[temperature]",
               thresh="[temperature]")
def heating_degree_days_approximation(tasmax: ClimArray, tasmin: ClimArray,
                                      tas: ClimArray, thresh: str = "17.0 degC",
                                      freq: str = "YS") -> ClimArray:
    """UK Met Office HDD approximation (xclim:_threshold.py:2070)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    tasmax = convert_units_to(tasmax, tas)
    tasmin = convert_units_to(tasmin, tas)
    hdd = where(tasmax <= t, t - tas,
                where(tas <= t, (t - tasmin) / 2 - (tasmax - t) / 4,
                      where(tasmin <= t, (t - tasmin) / 4, 0)))
    out = hdd.resample(freq).sum()
    out.attrs["units"] = tas.attrs.get("units", "")
    return to_agg_units(out, tas, "integral", deffreq="D")


@declare_units(tas="[temperature]", thresh="[temperature]")
def growing_degree_days(tas: ClimArray, thresh: str = "4.0 degC", freq: str = "YS") -> ClimArray:
    """Sum of degree-days above threshold (xclim:_threshold.py:941)."""
    return cumulative_difference(tas, threshold=thresh, op=">", freq=freq)


@declare_units(tas="[temperature]", thresh="[temperature]")
def heating_degree_days(tas: ClimArray, thresh: str = "17.0 degC", freq: str = "YS") -> ClimArray:
    """Sum of degrees below threshold (xclim:_threshold.py:2127)."""
    return cumulative_difference(tas, threshold=thresh, op="<", freq=freq)


@declare_units(tas="[temperature]", thresh="[temperature]", sum_thresh="K days")
def degree_days_exceedance_date(tas: ClimArray, thresh: str = "0 degC",
                                sum_thresh: str = "25 K days", op: str = ">",
                                after_date: str | None = None,
                                never_reached=None, freq: str = "YS") -> ClimArray:
    """Doy when cumulative degree-days exceed sum_thresh (xclim:_threshold.py:3215)."""
    t = convert_units_to(str2pint(thresh), "K")
    task = convert_units_to(tas, "K")
    st = convert_units_to(str2pint(sum_thresh), "K d")
    if op in ("<", "lt", "<=", "le"):
        c = (t - task).clip(0)
    else:
        c = (task - t).clip(0)
    spec = resample_segments(tas.time, freq)
    ax = tas.time_axis
    data = c.data
    if after_date is not None:
        mid_idx, has = rl._mid_date_index(tas.time, spec, after_date)
        mask = rl._mask_after(tas, spec, mid_idx, has)
        data = torch.where(rl._along(mask, tas), data, 0.0)
    csum = _rlops.cumsum_reset(
        data, axis=ax, index="last", reset_on_zero=False,
        reset_at=_rlops.segment_boundaries(spec, "last", data.device))
    idx = _rlops.first_run(csum > st, 1, axis=ax, spec=spec)
    doy = rl._index_to_doy(tas, idx, "dayofyear")
    if never_reached is not None:
        if isinstance(never_reached, str):
            nr = float(doy_from_string(never_reached, tas.time.calendar))
        else:
            nr = float(never_reached)
        doy = torch.where(torch.isnan(doy), nr, doy)
    out = rl._wrap_seg(tas, doy, spec)
    out.attrs.update(_doy_attrs(tas))
    return out


# ---------------------------------------------------------------------------
# growing / frost seasons
# ---------------------------------------------------------------------------


@declare_units(tas="[temperature]", thresh="[temperature]")
def growing_season_start(tas: ClimArray, thresh: str = "5.0 degC",
                         mid_date: str | None = "07-01", window: int = 5,
                         freq: str = "YS", op: str = ">=") -> ClimArray:
    """Doy when temperature stays above thresh `window` days (xclim:_threshold.py:975)."""
    return season(tas, thresh=thresh, mid_date=mid_date, window=window, freq=freq,
                  op=op, constrain=(">", ">="), stat="start")


@declare_units(tas="[temperature]", thresh="[temperature]")
def growing_season_end(tas: ClimArray, thresh: str = "5.0 degC",
                       mid_date: str | None = "07-01", window: int = 5,
                       freq: str = "YS", op: str = ">=") -> ClimArray:
    """Doy when temperature stays below thresh after mid-date (xclim:_threshold.py:1029)."""
    return season(tas, thresh=thresh, mid_date=mid_date, window=window, freq=freq,
                  op=op, constrain=(">", ">="), stat="end")


@declare_units(tas="[temperature]", thresh="[temperature]")
def growing_season_length(tas: ClimArray, thresh: str = "5.0 degC", window: int = 6,
                          mid_date: str | None = "07-01", freq: str = "YS",
                          op: str = ">=") -> ClimArray:
    """Days between season start and end (xclim:_threshold.py:1096)."""
    return season(tas, thresh=thresh, mid_date=mid_date, window=window, freq=freq,
                  op=op, constrain=(">", ">="), stat="length")


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_season_length(tasmin: ClimArray, window: int = 5,
                        mid_date: str | None = "01-01", thresh: str = "0 degC",
                        freq: str = "YS-JUL", op: str = "<") -> ClimArray:
    """Length of the frost season (xclim:_threshold.py:1184)."""
    return season(tasmin, thresh=thresh, window=window, op=op, stat="length",
                  freq=freq, mid_date=mid_date, constrain=("<", "<="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_free_season_start(tasmin: ClimArray, thresh: str = "0.0 degC",
                            window: int = 5, mid_date: str | None = "07-01",
                            op: str = ">=", freq: str = "YS") -> ClimArray:
    """Doy of frost-free season start (xclim:_threshold.py:1266)."""
    return season(tasmin, thresh=thresh, window=window, op=op, stat="start",
                  freq=freq, mid_date=mid_date, constrain=(">", ">="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_free_season_end(tasmin: ClimArray, thresh: str = "0.0 degC",
                          window: int = 5, mid_date: str | None = "07-01",
                          op: str = ">=", freq: str = "YS") -> ClimArray:
    """Doy of frost-free season end (xclim:_threshold.py:1327)."""
    return season(tasmin, thresh=thresh, window=window, op=op, stat="end",
                  freq=freq, mid_date=mid_date, constrain=(">", ">="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_free_season_length(tasmin: ClimArray, thresh: str = "0.0 degC",
                             window: int = 5, mid_date: str | None = "07-01",
                             op: str = ">=", freq: str = "YS") -> ClimArray:
    """Length of the frost-free season (xclim:_threshold.py:1395)."""
    return season(tasmin, thresh=thresh, window=window, op=op, stat="length",
                  freq=freq, mid_date=mid_date, constrain=(">", ">="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_free_spell_max_length(tasmin: ClimArray, thresh: str = "0.0 degC",
                                window: int = 1, freq: str = "YS", op: str = ">=",
                                resample_before_rl: bool = True) -> ClimArray:
    """Longest frost-free spell (xclim:_threshold.py:1476)."""
    t = convert_units_to(str2pint(thresh), tasmin)
    cond = compare(tasmin, op, t, constrain=(">", ">="))
    max_l = rl.longest_run(cond, freq=freq, resample_before_rl=resample_before_rl)
    out = max_l.where(max_l >= window, 0)
    return to_agg_units(out, tasmin, "count", deffreq="D")


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def last_spring_frost(tasmin: ClimArray, thresh: str = "0 degC", op: str = "<",
                      before_date: str = "07-01", window: int = 1,
                      freq: str = "YS") -> ClimArray:
    """Doy of last frost before a date (xclim:_threshold.py:1526)."""
    t = convert_units_to(str2pint(thresh), tasmin)
    cond = compare(tasmin, op, t, constrain=("<", "<="))
    out = rl.last_run_before_date(cond, window=window, date=before_date, freq=freq,
                                  coord="dayofyear")
    out.attrs.update(_doy_attrs(tasmin))
    return out


@declare_units(tas="[temperature]", thresh="[temperature]")
def first_day_temperature_below(tas: ClimArray, thresh: str = "0 degC", op: str = "<",
                                after_date: str = "07-01", window: int = 1,
                                freq: str = "YS") -> ClimArray:
    """First doy with temperature below thresh for `window` days
    (xclim:_threshold.py:1585)."""
    return first_day_threshold_reached(tas, threshold=thresh, op=op,
                                       after_date=after_date, window=window,
                                       freq=freq, constrain=("<", "<="))


@declare_units(tas="[temperature]", thresh="[temperature]")
def first_day_temperature_above(tas: ClimArray, thresh: str = "0 degC", op: str = ">",
                                after_date: str = "01-01", window: int = 1,
                                freq: str = "YS") -> ClimArray:
    """First doy with temperature above thresh for `window` days
    (xclim:_threshold.py:1637)."""
    return first_day_threshold_reached(tas, threshold=thresh, op=op,
                                       after_date=after_date, window=window,
                                       freq=freq, constrain=(">", ">="))


# ---------------------------------------------------------------------------
# snowfall events
# ---------------------------------------------------------------------------


@declare_units(prsn="[precipitation]", thresh="[precipitation]")
def first_snowfall(prsn: ClimArray, thresh: str = "1 mm/day", freq: str = "YS-JUL") -> ClimArray:
    """Doy of first snowfall ≥ thresh (xclim:_threshold.py:1701)."""
    t = convert_units_to(str2pint(thresh), prsn, context="hydro")
    cond = prsn >= t
    out = rl.first_run(cond, 1, freq=freq, coord="dayofyear")
    out.attrs.update(_doy_attrs(prsn))
    return out


@declare_units(prsn="[precipitation]", thresh="[precipitation]")
def last_snowfall(prsn: ClimArray, thresh: str = "1 mm/day", freq: str = "YS-JUL") -> ClimArray:
    """Doy of last snowfall ≥ thresh (xclim:_threshold.py:1757)."""
    t = convert_units_to(str2pint(thresh), prsn, context="hydro")
    cond = prsn >= t
    out = rl.last_run(cond, 1, freq=freq, coord="dayofyear")
    out.attrs.update(_doy_attrs(prsn))
    return out


@declare_units(prsn="[precipitation]", low="[precipitation]", high="[precipitation]")
def days_with_snow(prsn: ClimArray, low: str = "0 kg m-2 s-1",
                   high: str = "1E6 kg m-2 s-1", freq: str = "YS-JUL") -> ClimArray:
    """Days with snowfall in ]low, high] (xclim:_threshold.py:1817)."""
    lo = convert_units_to(str2pint(low), prsn, context="hydro")
    hi = convert_units_to(str2pint(high), prsn, context="hydro")
    out = domain_count(prsn, lo, hi, freq)
    return to_agg_units(out, prsn, "count", deffreq="D")


@declare_units(prsn="[precipitation]", thresh="[precipitation]")
def snowfall_frequency(prsn: ClimArray, thresh: str = "1 mm/day",
                       freq: str = "YS-JUL") -> ClimArray:
    """Percentage of days with snowfall ≥ thresh (xclim:_threshold.py:1864)."""
    snow_days = days_with_snow(prsn, low=thresh, high="1E6 kg m-2 s-1", freq=freq)
    total_days = prsn.resample(freq).count()
    out = snow_days / total_days * 100
    out.attrs = dict(snow_days.attrs)
    out.attrs["units"] = "%"
    return out


@declare_units(prsn="[precipitation]", thresh="[precipitation]")
def snowfall_intensity(prsn: ClimArray, thresh: str = "1 mm/day",
                       freq: str = "YS-JUL") -> ClimArray:
    """Mean snowfall lwe rate on snowfall days (xclim:_threshold.py:1920)."""
    t = convert_units_to(str2pint(thresh), "mm/d")
    lwe_prsn = convert_units_to(prsn, "mm/d", context="hydro")
    cond = lwe_prsn >= t
    mean = lwe_prsn.where(cond).resample(freq).mean()
    out = mean.fillna(0)
    out.attrs["units"] = lwe_prsn.attrs["units"]
    return out


# ---------------------------------------------------------------------------
# heat spells
# ---------------------------------------------------------------------------


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def heat_wave_index(tasmax: ClimArray, thresh: str = "25.0 degC", window: int = 5,
                    freq: str = "YS", op: str = ">",
                    resample_before_rl: bool = True) -> ClimArray:
    """Days inside heat waves (xclim:_threshold.py:1972)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    over = compare(tasmax, op, t, constrain=(">", ">="))
    out = rl.windowed_run_count(over, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def hot_spell_max_magnitude(tasmax: ClimArray, thresh: str = "25.0 degC",
                            window: int = 3, freq: str = "YS",
                            resample_before_rl: bool = True) -> ClimArray:
    """Max cumulative exceedance of any hot spell (xclim:_threshold.py:2019)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    over_values = (tasmax - t).clip(0)
    out = rl.windowed_max_run_sum(over_values, window, freq=freq,
                                  resample_before_rl=resample_before_rl)
    out.attrs["units"] = tasmax.attrs.get("units", "")
    return to_agg_units(out, tasmax, op="integral", deffreq="D")


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def hot_spell_max_length(tasmax: ClimArray, thresh: str = "30 degC", window: int = 1,
                         freq: str = "YS", op: str = ">",
                         resample_before_rl: bool = True) -> ClimArray:
    """Longest hot spell (xclim:_threshold.py:2169)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    cond = compare(tasmax, op, t, constrain=(">", ">="))
    max_l = rl.longest_run(cond, freq=freq, resample_before_rl=resample_before_rl)
    out = max_l.where(max_l >= window, 0)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def hot_spell_total_length(tasmax: ClimArray, thresh: str = "30 degC", window: int = 3,
                           freq: str = "YS", op: str = ">",
                           resample_before_rl: bool = True) -> ClimArray:
    """Total days in hot spells (xclim:_threshold.py:2232)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    cond = compare(tasmax, op, t, constrain=(">", ">="))
    out = rl.windowed_run_count(cond, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def hot_spell_frequency(tasmax: ClimArray, thresh: str = "30 degC", window: int = 3,
                        freq: str = "YS", op: str = ">",
                        resample_before_rl: bool = True) -> ClimArray:
    """Number of hot spells (xclim:_threshold.py:2291)."""
    t = convert_units_to(str2pint(thresh), tasmax)
    cond = compare(tasmax, op, t, constrain=(">", ">="))
    out = rl.windowed_run_events(cond, window, freq=freq,
                                 resample_before_rl=resample_before_rl)
    out.attrs["units"] = ""
    return out


# ---------------------------------------------------------------------------
# snow & temperature day counts
# ---------------------------------------------------------------------------


@declare_units(snd="[length]", thresh="[length]")
def snd_days_above(snd: ClimArray, thresh: str = "2 cm", freq: str = "YS-JUL",
                   op: str = ">=") -> ClimArray:
    """Days with snow depth above threshold (xclim:_threshold.py:2354)."""
    valid = at_least_n_valid(snd, n=1, freq=freq)
    t = convert_units_to(str2pint(thresh), snd)
    out = threshold_count(snd, op, t, freq)
    return to_agg_units(out, snd, "count", deffreq="D").where(~valid)


@declare_units(snw="[mass]/[area]", thresh="[mass]/[area]")
def snw_days_above(snw: ClimArray, thresh: str = "4 kg m-2", freq: str = "YS-JUL",
                   op: str = ">=") -> ClimArray:
    """Days with snow amount above threshold (xclim:_threshold.py:2388)."""
    valid = at_least_n_valid(snw, n=1, freq=freq)
    t = convert_units_to(str2pint(thresh), snw)
    out = threshold_count(snw, op, t, freq)
    return to_agg_units(out, snw, "count", deffreq="D").where(~valid)


def _t_days(var, thresh, freq, op, constrain):
    t = convert_units_to(str2pint(thresh), var)
    f = threshold_count(var, op, t, freq, constrain=constrain)
    return to_agg_units(f, var, "count", deffreq="D")


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def tn_days_above(tasmin: ClimArray, thresh: str = "20.0 degC", freq: str = "YS",
                  op: str = ">") -> ClimArray:
    """Days with tasmin above threshold (xclim:_threshold.py:2422)."""
    return _t_days(tasmin, thresh, freq, op, (">", ">="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def tn_days_below(tasmin: ClimArray, thresh: str = "-10.0 degC", freq: str = "YS",
                  op: str = "<") -> ClimArray:
    """Days with tasmin below threshold (xclim:_threshold.py:2464)."""
    return _t_days(tasmin, thresh, freq, op, ("<", "<="))


@declare_units(tas="[temperature]", thresh="[temperature]")
def tg_days_above(tas: ClimArray, thresh: str = "10.0 degC", freq: str = "YS",
                  op: str = ">") -> ClimArray:
    """Days with tas above threshold (xclim:_threshold.py:2506)."""
    return _t_days(tas, thresh, freq, op, (">", ">="))


@declare_units(tas="[temperature]", thresh="[temperature]")
def tg_days_below(tas: ClimArray, thresh: str = "10.0 degC", freq: str = "YS",
                  op: str = "<") -> ClimArray:
    """Days with tas below threshold (xclim:_threshold.py:2548)."""
    return _t_days(tas, thresh, freq, op, ("<", "<="))


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def tx_days_above(tasmax: ClimArray, thresh: str = "25.0 degC", freq: str = "YS",
                  op: str = ">") -> ClimArray:
    """Days with tasmax above threshold (xclim:_threshold.py:2590)."""
    return _t_days(tasmax, thresh, freq, op, (">", ">="))


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def tx_days_below(tasmax: ClimArray, thresh: str = "25.0 degC", freq: str = "YS",
                  op: str = "<") -> ClimArray:
    """Days with tasmax below threshold (xclim:_threshold.py:2632)."""
    return _t_days(tasmax, thresh, freq, op, ("<", "<="))


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def warm_day_frequency(tasmax: ClimArray, thresh: str = "30 degC", freq: str = "YS",
                       op: str = ">") -> ClimArray:
    """Days with tasmax above threshold (xclim:_threshold.py:2674)."""
    return _t_days(tasmax, thresh, freq, op, (">", ">="))


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def warm_night_frequency(tasmin: ClimArray, thresh: str = "22 degC", freq: str = "YS",
                         op: str = ">") -> ClimArray:
    """Days with tasmin above threshold (xclim:_threshold.py:2716)."""
    return _t_days(tasmin, thresh, freq, op, (">", ">="))


# ---------------------------------------------------------------------------
# consecutive extremes
# ---------------------------------------------------------------------------


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def maximum_consecutive_frost_days(tasmin: ClimArray, thresh: str = "0.0 degC",
                                   freq: str = "YS-JUL",
                                   resample_before_rl: bool = True) -> ClimArray:
    """Longest run of frost days (xclim:_threshold.py:2837)."""
    return cold_spell_max_length(tasmin, thresh=thresh, window=1, freq=freq, op="<",
                                 resample_before_rl=resample_before_rl)


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def maximum_consecutive_frost_free_days(tasmin: ClimArray, thresh: str = "0 degC",
                                        freq: str = "YS",
                                        resample_before_rl: bool = True) -> ClimArray:
    """Longest run of frost-free days (xclim:_threshold.py:2942)."""
    return frost_free_spell_max_length(tasmin, thresh=thresh, window=1, freq=freq,
                                       op=">=", resample_before_rl=resample_before_rl)


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def maximum_consecutive_tx_days(tasmax: ClimArray, thresh: str = "25 degC",
                                freq: str = "YS",
                                resample_before_rl: bool = True) -> ClimArray:
    """Longest run of days with tasmax above threshold (xclim:_threshold.py:3003)."""
    return hot_spell_max_length(tasmax, thresh=thresh, window=1, freq=freq, op=">",
                                resample_before_rl=resample_before_rl)


# ---------------------------------------------------------------------------
# sea ice
# ---------------------------------------------------------------------------


@declare_units(siconc="[]", areacello="[area]", thresh="[]")
def sea_ice_area(siconc: ClimArray, areacello: ClimArray, thresh: str = "15 pct") -> ClimArray:
    """Total sea-ice area: Σ conc×cell_area over cells ≥ thresh
    (xclim:_threshold.py:3058)."""
    t = convert_units_to(str2pint(thresh), siconc)
    factor = convert_units_to(str2pint("100 pct"), siconc)
    conc = siconc.where(siconc >= t, 0)
    cell_dims = areacello.dims
    prod = conc * areacello
    sia = prod.sum(dim=list(cell_dims)) / factor
    # normalize to the CF spelling ("km^2" -> "km2"), as the reference's
    # pint2cfunits does (xclim:_threshold.py:3092)
    sia.attrs["units"] = parse_units(areacello.attrs.get("units", "m2")).to_cf()
    return sia


@declare_units(siconc="[]", areacello="[area]", thresh="[]")
def sea_ice_extent(siconc: ClimArray, areacello: ClimArray, thresh: str = "15 pct") -> ClimArray:
    """Total area of cells with conc ≥ thresh (xclim:_threshold.py:3097)."""
    t = convert_units_to(str2pint(thresh), siconc)
    mask = (siconc >= t).astype(torch.float32)
    prod = mask * areacello
    sie = prod.sum(dim=list(areacello.dims))
    sie.attrs["units"] = parse_units(areacello.attrs.get("units", "m2")).to_cf()
    return sie


# ---------------------------------------------------------------------------
# holidays
# ---------------------------------------------------------------------------


@declare_units(snd="[length]", snd_thresh="[length]")
def holiday_snow_days(snd: ClimArray, snd_thresh: str = "20 mm", op: str = ">=",
                      date_start: str = "12-25", date_end: str | None = None,
                      freq: str = "YS") -> ClimArray:
    """Christmas-style days with snow on the ground (xclim:_threshold.py:3743)."""
    snd_c = snd.select_time(date_bounds=(date_start, date_end or date_start))
    out = count_occurrences(snd_c, snd_thresh, freq, op, constrain=(">=", ">"))
    return to_agg_units(out, snd, "count", deffreq="D")


@declare_units(snd="[length]", prsn="[precipitation]", snd_thresh="[length]",
               prsn_thresh="[length]")
def holiday_snow_and_snowfall_days(snd: ClimArray, prsn: ClimArray,
                                   snd_thresh: str = "20 mm",
                                   prsn_thresh: str = "1 mm", snd_op: str = ">=",
                                   prsn_op: str = ">=", date_start: str = "12-25",
                                   date_end: str | None = None,
                                   freq: str = "YS-JUL") -> ClimArray:
    """Days with snow cover AND measurable snowfall on holidays
    (xclim:_threshold.py:3799)."""
    bounds = (date_start, date_end or date_start)
    snd_c = snd.select_time(date_bounds=bounds)
    prsn_mm = rate2amount(convert_units_to(prsn, "mm day-1", context="hydro"),
                          out_units="mm")
    prsn_c = prsn_mm.select_time(date_bounds=bounds)
    out = bivariate_count_occurrences(snd_c, prsn_c, snd_thresh, prsn_thresh, freq,
                                      snd_op, prsn_op, var_reducer="all")
    return to_agg_units(out, snd, "count", deffreq="D")
