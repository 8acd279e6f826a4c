"""Agroclimatic indices (reference: xclim:src/xclim/indices/_agro.py).

Per-day terms are torch ops on the input's device; period sums take the
segment engine, runs the run-length helpers. Latitude coefficients are
host tables (``helpers``) cast to float32 where the reference casts them.
The dynamic chill-portion model is a recurrence over hours: a Python loop
over time with the carry kept on the device (``_chill_intermediate``).
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import parse_offset, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import (
    amount2lwethickness,
    convert_units_to,
    declare_units,
    rate2amount,
    str2pint,
    to_agg_units,
)
from xclim_tpu_torch.indices import run_length as rl
from xclim_tpu_torch.indices._threshold import (
    first_day_temperature_above,
    first_day_temperature_below,
)
from xclim_tpu_torch.indices.generic import aggregate_between_dates, get_zones
from xclim_tpu_torch.indices.stats import standardized_index
from xclim_tpu_torch.ops.segments import rolling_reduce, weighted_window_sum

__all__ = [
    "biologically_effective_degree_days",
    "chill_portions",
    "chill_units",
    "cool_night_index",
    "corn_heat_units",
    "dryness_index",
    "effective_growing_degree_days",
    "hardiness_zones",
    "huglin_index",
    "latitude_temperature_index",
    "qian_weighted_mean_average",
    "rain_season",
    "standardized_precipitation_evapotranspiration_index",
    "standardized_precipitation_index",
]


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", thresh_tasmax="[temperature]")
def corn_heat_units(tasmin: ClimArray, tasmax: ClimArray,
                    thresh_tasmin: str = "4.44 degC",
                    thresh_tasmax: str = "10 degC") -> ClimArray:
    """Corn heat units from daily min/max temperature (xclim:_agro.py:69)."""
    tn = convert_units_to(tasmin, "degC")
    tx = convert_units_to(tasmax, "degC")
    tn_t = convert_units_to(str2pint(thresh_tasmin), "degC")
    tx_t = convert_units_to(str2pint(thresh_tasmax), "degC")
    ymin = torch.where(tn.data > tn_t, 1.8 * (tn.data - tn_t), 0.0)
    ymax = torch.where(tx.data > tx_t,
                     3.33 * (tx.data - tx_t) - 0.084 * (tx.data - tx_t) ** 2, 0.0)
    out = tn.copy(data=(ymin + ymax) / 2)
    out.attrs = {"units": ""}
    out.name = "chu"
    return out


def _lat_of(da: ClimArray, lat):
    if lat is not None:
        return lat
    return da.coords.get("lat", 45.0)


def _k_shape(k, da: ClimArray):
    """Broadcast a latitude-shaped host coefficient onto da's dims, as a
    float32 tensor on da's device.

    Accepts scalar, (lat,) vectors and (lat, lon) grids."""
    k = np.asarray(k, dtype=np.float32)
    kt = torch.as_tensor(k, device=da.data.device)
    if k.ndim == 0 or "lat" not in da.dims:
        return kt.reshape((1,) * da.ndim) if k.ndim == 0 else kt
    shape = [1] * da.ndim
    shape[da.dims.index("lat")] = k.shape[0]
    if k.ndim >= 2 and "lon" in da.dims:
        shape[da.dims.index("lon")] = k.shape[1]
    return kt.reshape(shape)


@declare_units(tas="[temperature]", tasmax="[temperature]", thresh="[temperature]")
def huglin_index(tas: ClimArray, tasmax: ClimArray, lat=None, thresh: str = "10 degC",
                 method: str = "huglin", cap_value: float = np.nan,
                 start_date: str = "04-01", end_date: str = "10-01",
                 freq: str = "YS") -> ClimArray:
    """Huglin heliothermal index for viticulture (xclim:_agro.py:151)."""
    from xclim_tpu_torch.indices.helpers import huglin_day_length_latitude_coefficient

    t = convert_units_to(tas, "degC")
    tx = convert_units_to(tasmax, "degC")
    th = convert_units_to(str2pint(thresh), "degC")
    latv = _lat_of(tas, lat)
    k = huglin_day_length_latitude_coefficient(latv, method=method,
                                               cap_value=cap_value)
    hi = (((t.data + tx.data) / 2) - th).clamp(min=0) * _k_shape(k, t)
    hic = t.copy(data=hi)
    hic.attrs = {"units": ""}
    mask = _date_mask(t, start_date, end_date)
    hic = hic.copy(data=torch.where(mask, hic.data, 0.0))
    res = hic.resample(freq).sum()
    res.attrs = {"units": ""}
    res.name = "hi"
    return res


def _date_mask(da: ClimArray, start_date, end_date, include_end=False):
    from xclim_tpu_torch.core.calendar import select_time_mask

    m = select_time_mask(da.time, date_bounds=(start_date, end_date),
                         include_bounds=(True, include_end))
    ax = da.time_axis
    shape = [1] * da.ndim
    shape[ax] = len(m)
    return torch.as_tensor(m, device=da.data.device).reshape(shape)


@declare_units(tasmin="[temperature]", tasmax="[temperature]",
               thresh_tasmin="[temperature]", low_dtr="[temperature]",
               high_dtr="[temperature]", max_daily_degree_days="[temperature]")
def biologically_effective_degree_days(tasmin: ClimArray, tasmax: ClimArray,
                                       lat=None, thresh_tasmin: str = "10 degC",
                                       method: str = "gladstones",
                                       cap_value: float = np.nan,
                                       low_dtr: str = "10 degC",
                                       high_dtr: str = "13 degC",
                                       max_daily_degree_days: str = "9 degC",
                                       start_date: str = "04-01",
                                       end_date: str = "11-01",
                                       freq: str = "YS") -> ClimArray:
    """Gladstones biologically effective degree days (xclim:_agro.py:275)."""
    from xclim_tpu_torch.indices.helpers import (
        gladstones_day_length_latitude_coefficient,
        huglin_day_length_latitude_coefficient,
    )

    tn = convert_units_to(tasmin, "degC")
    tx = convert_units_to(tasmax, "degC")
    th = convert_units_to(str2pint(thresh_tasmin), "degC")
    maxdd = convert_units_to(str2pint(max_daily_degree_days), "degC")
    latv = _lat_of(tasmin, lat)
    if method == "icclim":
        tr_adj = 0.0
        k = 1.0
    else:
        lo = convert_units_to(str2pint(low_dtr), "degC")
        hi = convert_units_to(str2pint(high_dtr), "degC")
        dtr = tx.data - tn.data
        tr_adj = 0.25 * torch.where(dtr > hi, dtr - hi,
                                    torch.where(dtr < lo, dtr - lo, 0.0))
        if method in ("huglin", "interpolated"):
            k = _k_shape(huglin_day_length_latitude_coefficient(
                latv, method=method, cap_value=cap_value), tn)
        elif method == "gladstones":
            kk = gladstones_day_length_latitude_coefficient(
                tn.time, latv, device=tn.data.device)
            kd = kk.data
            if tn.ndim > kk.ndim:
                kd = kd.reshape(kd.shape + (1,) * (tn.ndim - kk.ndim))
            elif tn.ndim < kk.ndim:
                kd = kd[..., 0]
            k = kd
        else:
            raise NotImplementedError(method)
    bedd = torch.clamp(
        torch.clamp(((tn.data + tx.data) / 2) - th, min=0) * k + tr_adj,
        0, maxdd)
    beddc = tn.copy(data=torch.where(_date_mask(tn, start_date, end_date),
                                     bedd, 0.0))
    out = beddc.resample(freq).sum()
    out.attrs = {"units": "K d"}
    out.name = "bedd"
    return out


@declare_units(tasmin="[temperature]")
def cool_night_index(tasmin: ClimArray, lat=None, freq: str = "YS") -> ClimArray:
    """Mean September (north) / March (south) minimum temperature
    (xclim:_agro.py:447)."""
    if parse_offset(freq) != (1, "Y", True, "JAN"):
        raise ValueError(f"Freq not allowed: {freq}. Must be YS/YS-JAN.")
    tn = convert_units_to(tasmin, "degC")
    latv = _lat_of(tasmin, lat)
    if isinstance(latv, str):
        month = 9 if latv.lower() == "north" else 3
        sel = tn.select_time(month=month)
    else:
        latn = np.asarray(getattr(latv, "values", latv))
        if np.ndim(latn) == 0:
            month = 9 if latn >= 0 else 3
            sel = tn.select_time(month=int(month))
        else:
            # per-latitude month selection
            sel9 = tn.select_time(month=9)
            sel3 = tn.select_time(month=3)
            lm = _k_shape((latn >= 0).astype(np.float32), tn)
            sel = tn.copy(data=torch.where(lm > 0, sel9.data, sel3.data))
    out = sel.resample(freq).mean()
    out.attrs = {"units": "degC"}
    out.name = "cni"
    return out


@declare_units(pr="[precipitation]", evspsblpot="[precipitation]", wo="[length]")
def dryness_index(pr: ClimArray, evspsblpot: ClimArray, lat=None,
                  wo: str = "200 mm", freq: str = "YS") -> ClimArray:
    """Estranged Riou soil dryness index for viticulture (xclim:_agro.py:532).

    Northern-hemisphere convention (Apr-Sep season); southern-hemisphere grids
    should be shifted by the caller.
    """
    if parse_offset(freq) != (1, "Y", True, "JAN"):
        raise ValueError(f"Freq not allowed: {freq}. Must be YS/YS-JAN.")
    pet_m = amount2lwethickness(rate2amount(evspsblpot), out_units="mm").resample("MS").sum()
    pr_m = amount2lwethickness(rate2amount(pr), out_units="mm").resample("MS").sum()
    wov = convert_units_to(str2pint(wo), "mm")
    adj_north = np.array([0, 0, 0, 0.1, 0.3, 0.5, 0.5, 0.5, 0.5, 0, 0, 0])
    months = pet_m.time.month
    k = torch.as_tensor(adj_north[months - 1].astype(np.float32),
                        device=pet_m.data.device)
    ax = pet_m.time_axis
    shape = [1] * pet_m.ndim
    shape[ax] = len(months)
    k = k.reshape(shape)
    dim = torch.as_tensor(np.asarray(
        [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])[months - 1]
        .astype(np.float32), device=pet_m.data.device).reshape(shape)
    pr_masked = (k > 0) * pr_m.data
    t_v = pet_m.data * k
    e_s = (pet_m.data / dim) * (1 - k) * torch.minimum(pr_masked / 5, dim)
    monthly = pet_m.copy(data=pr_masked - t_v - e_s)
    di = monthly.resample("YS").sum() + wov
    di.attrs = {"units": "mm"}
    di.name = "dryness_index"
    return di


@declare_units(tas="[temperature]")
def latitude_temperature_index(tas: ClimArray, lat=None, lat_factor: float = 75,
                               freq: str = "YS") -> ClimArray:
    """Latitude-temperature index for viticulture (xclim:_agro.py)."""
    t = convert_units_to(tas, "degC")
    tm = t.resample("MS").mean()
    tm.attrs["units"] = "degC"
    mtwm = tm.resample(freq).max()
    latv = np.abs(np.asarray(getattr(_lat_of(tas, lat), "values", _lat_of(tas, lat)),
                             dtype=np.float64))
    coeff = np.where(latv <= lat_factor, lat_factor - latv, 0.0)
    out = mtwm.copy(data=mtwm.data * _k_shape(coeff, mtwm))
    out.attrs = {"units": ""}
    out.name = "lti"
    return out


@declare_units(pr="[precipitation]", thresh_wet_start="[length]",
               thresh_dry_start="[length]", thresh_dry_end="[length]")
def rain_season(pr: ClimArray, thresh_wet_start: str = "25.0 mm",
                window_wet_start: int = 3, window_not_dry_start: int = 30,
                thresh_dry_start: str = "1.0 mm", window_dry_start: int = 7,
                method_dry_start: str = "per_day", date_min_start: str = "05-01",
                date_max_start: str = "12-31", thresh_dry_end: str = "0.0 mm",
                window_dry_end: int = 20, method_dry_end: str = "per_day",
                date_min_end: str = "09-01", date_max_end: str = "12-31",
                freq: str = "YS"):
    """Rain season start/end/length (xclim:_agro.py:796, Sivakumar/CBCL).

    Returns (start, end, length) as doy/day ClimArrays per period.
    """
    pram = rate2amount(pr, out_units="mm")
    wet_t = convert_units_to(str2pint(thresh_wet_start), "mm")
    dry_s_t = convert_units_to(str2pint(thresh_dry_start), "mm")
    dry_e_t = convert_units_to(str2pint(thresh_dry_end), "mm")
    ax = pram.time_axis
    spec = resample_segments(pram.time, freq)

    # start condition: wet accumulation over window_wet_start
    wet_acc = rolling_reduce(pram.data, window_wet_start, "sum", axis=ax)
    da_start = pram.copy(data=torch.nan_to_num(wet_acc, nan=0.0) >= wet_t)
    if method_dry_start == "per_day":
        da_stop = pram.copy(data=pram.data <= dry_s_t)
        window_dry = window_dry_start
    else:  # total
        acc = rolling_reduce(pram.data, window_dry_start, "sum", axis=ax)
        stop = torch.nan_to_num(acc, nan=torch.inf) <= dry_s_t
        stop = torch.roll(stop, -(window_dry_start - 1), dims=ax)
        da_stop = pram.copy(data=stop)
        window_dry = 1
    events = rl.runs_with_holes(da_start, 1, da_stop, window_dry)
    run_pos = rl.rle(events)
    qualifying = run_pos.copy(
        data=torch.nan_to_num(run_pos.data, nan=0.0)
        >= (window_not_dry_start + window_wet_start))
    start = rl.first_run_after_date(qualifying, window=1, date=date_min_start,
                                    freq=freq, coord=False)
    # bound by date_max_start: starts after it → NaN
    start = _clip_after(start, pram, spec, date_max_start)

    # end: first dry run after start and after date_min_end
    if method_dry_end == "per_day":
        dry_end = pram.copy(data=pram.data <= dry_e_t)
        end_pos = rl.rle(dry_end)
        end_cond = end_pos.copy(data=torch.nan_to_num(end_pos.data, nan=0.0)
                                >= window_dry_end)
    else:
        acc = rolling_reduce(pram.data, window_dry_end, "sum", axis=ax)
        end_cond = pram.copy(data=torch.nan_to_num(acc, nan=torch.inf) <= dry_e_t)
    # only after the season start
    dev = pram.data.device
    pos = torch.arange(len(pram.time), dtype=torch.float32, device=dev)
    shape = [1] * pram.ndim
    shape[ax] = len(pram.time)
    posj = pos.reshape(shape)
    start_step = torch.index_select(
        torch.nan_to_num(start.data, nan=torch.inf), start.time_axis,
        torch.as_tensor(np.asarray(spec.seg_id), device=dev))
    end_masked = end_cond.copy(data=end_cond.data & (posj > start_step))
    end = rl.first_run_after_date(end_masked, window=1, date=date_min_end,
                                  freq=freq, coord=False)
    end = _clip_after(end, pram, spec, date_max_end)

    seg_len = torch.as_tensor(spec.counts.astype(np.float32), device=dev)
    seg_start = torch.as_tensor(spec.starts.astype(np.float32), device=dev)
    sh = [1] * start.ndim
    sh[start.time_axis] = spec.nseg
    length_data = torch.where(torch.isnan(end.data),
                              torch.where(torch.isnan(start.data), torch.nan,
                                          seg_len.reshape(sh)
                                          + seg_start.reshape(sh)
                                          - start.data),
                              end.data - start.data)

    start_doy = rl._index_to_doy(pram, start.data, "dayofyear")
    end_doy = rl._index_to_doy(pram, end.data, "dayofyear")
    s = start.copy(data=start_doy)
    s.attrs = {"units": "", "is_dayofyear": np.int32(1)}
    s.name = "rain_season_start"
    e = end.copy(data=end_doy)
    e.attrs = {"units": "", "is_dayofyear": np.int32(1)}
    e.name = "rain_season_end"
    ln = start.copy(data=length_data)
    ln.attrs = {"units": "days"}
    ln.name = "rain_season_length"
    return s, e, ln


def _clip_after(idx_arr: ClimArray, da: ClimArray, spec, date_max: str) -> ClimArray:
    """NaN out per-period indices falling after date_max."""
    from xclim_tpu_torch.indices.run_length import _mid_date_index

    mid, has = _mid_date_index(da.time, spec, date_max)
    lim = np.where(has, mid, len(da.time)).astype(np.float32)
    sh = [1] * idx_arr.ndim
    sh[idx_arr.time_axis] = spec.nseg
    limj = torch.as_tensor(lim, device=idx_arr.data.device).reshape(sh)
    return idx_arr.copy(data=torch.where(idx_arr.data <= limj, idx_arr.data,
                                         torch.nan))


@declare_units(pr="[precipitation]")
def standardized_precipitation_index(pr: ClimArray, freq: str | None = "MS",
                                     window: int = 1, dist: str = "gamma",
                                     method: str = "ML", fitkwargs=None,
                                     cal_start=None, cal_end=None, params=None,
                                     **indexer) -> ClimArray:
    """SPI (xclim:_agro.py:987): zero-inflated grouped fit + N(0,1) transform."""
    spi = standardized_index(pr, params=params, freq=freq, window=window,
                             dist=dist, method=method, zero_inflated=True,
                             cal_start=cal_start, cal_end=cal_end, **indexer)
    spi.name = "spi"
    return spi


@declare_units(wb="[precipitation]")
def standardized_precipitation_evapotranspiration_index(
        wb: ClimArray, freq: str | None = "MS", window: int = 1,
        dist: str = "fisk", method: str = "ML", fitkwargs=None, cal_start=None,
        cal_end=None, params=None, **indexer) -> ClimArray:
    """SPEI (xclim:_agro.py:1148) over the climatic water budget (pr − PET)."""
    spei = standardized_index(wb, params=params, freq=freq, window=window,
                              dist=dist, method=method, zero_inflated=False,
                              cal_start=cal_start, cal_end=cal_end, **indexer)
    spei.name = "spei"
    return spei


@declare_units(tas="[temperature]")
def qian_weighted_mean_average(tas: ClimArray, dim: str = "time") -> ClimArray:
    """Binomial 5-day weighted mean (Qian et al. 2010; xclim:_agro.py:1436)."""
    w = np.asarray([0.0625, 0.25, 0.375, 0.25, 0.0625], dtype=np.float32)
    out = tas.copy(data=weighted_window_sum(tas.data, tas.time_axis, w, 2, 2))
    out.attrs = dict(tas.attrs)
    return out


@declare_units(tasmax="[temperature]", tasmin="[temperature]", thresh="[temperature]")
def effective_growing_degree_days(tasmax: ClimArray, tasmin: ClimArray,
                                  thresh: str = "5 degC", method: str = "bootsma",
                                  after_date: str = "07-01", dim: str = "time",
                                  freq: str = "YS") -> ClimArray:
    """Effective GDD between spring start and fall frost (xclim:_agro.py:1292)."""
    tx = convert_units_to(tasmax, "degC")
    tn = convert_units_to(tasmin, "degC")
    th = convert_units_to(str2pint(thresh), "degC")
    tas = tx.copy(data=(tx.data + tn.data) / 2)
    tas.attrs = {"units": "degC"}
    thresh_str = f"{th} degC"
    if method.lower() == "bootsma":
        fda = first_day_temperature_above(tas, thresh=thresh_str, window=1, freq=freq)
        start = fda + 10
    elif method.lower() == "qian":
        tw = qian_weighted_mean_average(tas, dim=dim)
        start = first_day_temperature_above(tw, thresh=thresh_str, window=5, freq=freq)
    else:
        raise NotImplementedError(method)
    end = first_day_temperature_below(tn, thresh="0 degC", after_date=after_date,
                                      window=1, freq=freq) - 1
    deg_days = tas.copy(data=(tas.data - th).clamp(min=0))
    deg_days.attrs = {"units": "degC"}
    egdd = aggregate_between_dates(deg_days, start=start, end=end, freq=freq)
    return to_agg_units(egdd, tas, "integral", deffreq="D")


@declare_units(tasmin="[temperature]")
def hardiness_zones(tasmin: ClimArray, window: int = 30, method: str = "usda",
                    freq: str = "YS-JUL") -> ClimArray:
    """USDA/ANBG plant hardiness zones (xclim:_agro.py:1388)."""
    from xclim_tpu_torch.indices._simple import tn_min

    if method.lower() == "usda":
        zone_min, zone_max, zone_step = "-60 degF", "70 degF", "5 degF"
    elif method.lower() == "anbg":
        zone_min, zone_max, zone_step = "-15 degC", "20 degC", "5 degC"
    else:
        raise NotImplementedError(method)
    tnm = tn_min(tasmin, freq=freq)
    rolled = tnm.copy(data=rolling_reduce(tnm.data, window, "mean",
                                          axis=tnm.time_axis))
    rolled.attrs = dict(tnm.attrs)
    zones = get_zones(rolled, zone_min=zone_min, zone_max=zone_max,
                      zone_step=zone_step)
    zones.attrs["units"] = ""
    return zones


def _chill_intermediate(x):
    """The dynamic model's intermediate product E after each hour, and the
    hour's portion factor xi, for hourly x [K] with time first
    (xclim:_agro.py:1436-1535): a portion E * xi is banked where E >= 1.
    The per-hour terms are computed for all hours at once; the recurrence
    is a Python loop over time whose carry stays on the device (no host
    sync inside)."""
    E0, E1 = 4153.5, 12888.8
    A0, A1 = 139500.0, 2.567e18
    SLP, TETMLT = 1.6, 277.0
    AA = A0 / A1
    EE = E1 - E0
    ftmprt = SLP * TETMLT * (x - TETMLT) / x
    sr = torch.exp(ftmprt)
    xi = sr / (1 + sr)
    xs = AA * torch.exp(EE / x)
    ak1 = A1 * torch.exp(-E1 / x)
    decay = torch.exp(-ak1)
    inter = torch.empty_like(x)
    prev_E = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    prev_xi = torch.zeros_like(prev_E)
    for t in range(x.shape[0]):
        curr_S = torch.where(prev_E < 1, prev_E, prev_E - prev_E * prev_xi)
        prev_E = xs[t] - (xs[t] - curr_S) * decay[t]
        inter[t] = prev_E
        prev_xi = xi[t]
    return inter, xi


def _chill_portion_scan(tas_K, axis):
    """Dynamic-model chill portions banked each hour."""
    inter, xi = _chill_intermediate(torch.movedim(tas_K, axis, 0))
    delta = torch.where(inter >= 1, inter * xi, 0.0)
    return torch.movedim(delta, 0, axis)


@declare_units(tas="[temperature]")
def chill_portions(tas: ClimArray, freq: str = "YS", **indexer) -> ClimArray:
    """Dynamic-model chill portions from hourly temperature
    (xclim:_agro.py:1483)."""
    tk = convert_units_to(tas, "K")
    delta = _chill_portion_scan(tk.data, tk.time_axis)
    d = tk.copy(data=delta).select_time(**indexer)
    out = d.resample(freq).sum()
    out.attrs = {"units": ""}
    out.name = "cp"
    return out


@declare_units(tas="[temperature]")
def chill_units(tas: ClimArray, positive_only: bool = False,
                freq: str = "YS") -> ClimArray:
    """Utah-model chill units from hourly temperature (xclim:_agro.py:1538)."""
    t = convert_units_to(tas, "degC").data
    cu = torch.where((t <= 1.4) | ((t > 12.4) & (t <= 15.9)), 0.0,
                     torch.where((t > 1.4) & (t <= 2.4), 0.5,
                                 torch.where((t > 2.4) & (t <= 9.1), 1.0,
                                             torch.where((t > 9.1) & (t <= 12.4), 0.5,
                                                         torch.where((t > 15.9) & (t <= 17.9),
                                                                     -0.5, -1.0)))))
    cua = tas.copy(data=cu)
    if positive_only:
        # the Utah positive-only variant drops DAYS whose total is negative
        # (xclim:_agro.py:1589-1591), not individual negative hours
        daily = cua.resample("D").sum()
        daily = daily.copy(data=torch.where(daily.data > 0, daily.data,
                                            torch.nan))
        out = daily.resample(freq).sum()
        out.attrs = {"units": ""}
        out.name = "cu"
        return out
    out = cua.resample(freq).sum()
    out.attrs = {"units": ""}
    out.name = "cu"
    return out
