"""Hydrological indices (reference: xclim:src/xclim/indices/_hydrology.py).

Period sums, means and extremes take the segment engine; per-period
quantiles take ``ops.quantile.nan_quantile`` (the ``axisquantile`` kernel
on a CUDA float32 tensor when a period holds at most 64 samples, the sort
formulation past that, e.g. a year of days).
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.missing import at_least_n_valid
from xclim_tpu_torch.core.units import (
    convert_units_to,
    declare_units,
    rate2amount,
    str2pint,
    to_agg_units,
)
from xclim_tpu_torch.indices import generic
from xclim_tpu_torch.indices.generic import threshold_count
from xclim_tpu_torch.indices.stats import standardized_index
from xclim_tpu_torch.ops.quantile import _nanmedian
from xclim_tpu_torch.ops.segments import (
    rolling_reduce,
    segment_argminmax,
    weighted_window_sum,
)

__all__ = [
    "antecedent_precipitation_index",
    "aridity_index",
    "base_flow_index",
    "base_flow_index_seasonal_ratio",
    "flow_index",
    "high_flow_frequency",
    "lag_snowpack_flow_peaks",
    "low_flow_frequency",
    "melt_and_precip_max",
    "rb_flashiness_index",
    "runoff_ratio",
    "sen_slope",
    "sen_slope_ratio",
    "snd_max",
    "snd_max_doy",
    "snow_melt_we_max",
    "snw_max",
    "snw_max_doy",
    "standardized_groundwater_index",
    "standardized_streamflow_index",
]


@declare_units(q="[discharge]")
def base_flow_index_seasonal_ratio(q: ClimArray, freq: str = "QS-DEC",
                                   numerator: str = "DJF",
                                   denominator: str = "JJA"):
    """Seasonal base flow index and its winter/summer ratio
    (xclim:_hydrology.py:997).

    Returns (bfi, ratio): bfi on ('year', 'season') built from the quarterly
    base flow index, and the per-year numerator/denominator season ratio.
    """
    bfi_q = base_flow_index(q, freq=freq)   # one value per quarter
    labels = bfi_q.time
    seas = labels.season                     # 'DJF'/'MAM'/'JJA'/'SON' per quarter
    # quarter starting in Dec belongs to the following year (QS-DEC anchor)
    year = labels.year + (labels.month == 12).astype(np.int64)
    seasons = np.array(["DJF", "MAM", "JJA", "SON"])
    years = np.unique(year)
    tbl = np.full((len(years), 4), -1, dtype=np.int64)
    for i, (y, s) in enumerate(zip(year, seas)):
        tbl[np.searchsorted(years, y), list(seasons).index(s)] = i
    data = torch.movedim(bfi_q.data, bfi_q.dims.index("time"), 0)
    tt = torch.as_tensor(tbl, device=data.device)
    g = torch.where((tt >= 0).reshape(tbl.shape + (1,) * (data.ndim - 1)),
                    data[tt.clamp(min=0)], torch.nan)
    space_dims = tuple(d for d in q.dims if d != "time")
    coords = {k: v for k, v in q.coords.items() if k in space_dims}
    bfi = ClimArray(g, ("year", "season") + space_dims,
                    {"year": years, "season": seasons, **coords},
                    {"units": ""}, "bfi")
    den = g[:, list(seasons).index(denominator)]
    num = g[:, list(seasons).index(numerator)]
    rd = num / torch.where(den > 0, den, torch.nan)
    ratio = ClimArray(rd, ("year",) + space_dims, {"year": years, **coords},
                      {"units": "", "numerator": numerator,
                       "denominator": denominator}, "bfi_ratio")
    return bfi, ratio


@declare_units(q="[discharge]")
def base_flow_index(q: ClimArray, freq: str = "YS") -> ClimArray:
    """Min 7-day mean flow / period mean flow (xclim:_hydrology.py:50)."""
    m7 = q.copy(data=rolling_reduce(q.data, 7, "mean", axis=q.time_axis, center=True))
    m7m = m7.resample(freq).min()
    mq = q.resample(freq).mean()
    out = m7m / mq
    out.attrs["units"] = ""
    return out


@declare_units(q="[discharge]")
def rb_flashiness_index(q: ClimArray, freq: str = "YS") -> ClimArray:
    """Richards-Baker flashiness index (xclim:_hydrology.py:94)."""
    d = _diff_nan_first(q.data, q.time_axis).abs()
    dsum = q.copy(data=d).resample(freq).sum()
    qsum = q.resample(freq).sum()
    out = dsum / qsum
    out.attrs["units"] = ""
    return out


@declare_units(q="[discharge]")
def standardized_streamflow_index(q: ClimArray, freq: str | None = "MS",
                                  window: int = 1, dist: str = "genextreme",
                                  method: str = "ML", fitkwargs=None,
                                  cal_start=None, cal_end=None, params=None,
                                  **indexer) -> ClimArray:
    """SSI (xclim:_hydrology.py:136)."""
    ssi = standardized_index(q, params=params, freq=freq, window=window, dist=dist,
                             method="PWM" if dist == "genextreme" else method,
                             zero_inflated=False, cal_start=cal_start,
                             cal_end=cal_end, **indexer)
    ssi.name = "ssi"
    return ssi


@declare_units(gwl="[length]")
def standardized_groundwater_index(gwl: ClimArray, freq: str | None = "MS",
                                   window: int = 1, dist: str = "gamma",
                                   method: str = "ML", fitkwargs=None,
                                   cal_start=None, cal_end=None, params=None,
                                   **indexer) -> ClimArray:
    """SGI (xclim:_hydrology.py:447)."""
    sgi = standardized_index(gwl, params=params, freq=freq, window=window,
                             dist=dist, method=method, zero_inflated=False,
                             cal_start=cal_start, cal_end=cal_end, **indexer)
    sgi.name = "sgi"
    return sgi


@declare_units(snd="[length]")
def snd_max(snd: ClimArray, freq: str = "YS-JUL") -> ClimArray:
    """Maximum snow depth (xclim:_hydrology.py:267)."""
    return generic.select_resample_op(snd, op="max", freq=freq)


@declare_units(snd="[length]")
def snd_max_doy(snd: ClimArray, freq: str = "YS-JUL") -> ClimArray:
    """Doy of maximum snow depth (xclim:_hydrology.py:292)."""
    valid = at_least_n_valid(snd.where(snd > 0), n=1, freq=freq)
    out = generic.doymax(snd.where(snd > 0, 0), freq=freq)
    return out.where(~valid)


@declare_units(snw="[snowamount]")
def snw_max(snw: ClimArray, freq: str = "YS-JUL") -> ClimArray:
    """Maximum snow amount (xclim:_hydrology.py:318)."""
    return generic.select_resample_op(snw, op="max", freq=freq)


@declare_units(snw="[snowamount]")
def snw_max_doy(snw: ClimArray, freq: str = "YS-JUL") -> ClimArray:
    """Doy of maximum snow amount (xclim:_hydrology.py:343)."""
    valid = at_least_n_valid(snw.where(snw > 0), n=1, freq=freq)
    out = generic.doymax(snw.where(snw > 0, 0), freq=freq)
    return out.where(~valid)


@declare_units(snw="[snowamount]")
def snow_melt_we_max(snw: ClimArray, window: int = 3, freq: str = "YS-JUL") -> ClimArray:
    """Max water-equivalent snow melt over a window (xclim:_hydrology.py:371)."""
    ax = snw.time_axis
    d = -_diff_nan_first(snw.data, ax)
    agg = rolling_reduce(d, window, "sum", axis=ax)
    out = snw.copy(data=agg).resample(freq).max()
    out.attrs["units"] = snw.attrs.get("units", "")
    return out


@declare_units(snw="[snowamount]", pr="[precipitation]")
def melt_and_precip_max(snw: ClimArray, pr: ClimArray, window: int = 3,
                        freq: str = "YS-JUL") -> ClimArray:
    """Max combined snow melt and precipitation (xclim:_hydrology.py:412)."""
    ax = snw.time_axis
    d = -_diff_nan_first(snw.data, ax)
    total = rate2amount(pr).data + d
    agg = rolling_reduce(total, window, "sum", axis=ax)
    out = snw.copy(data=agg).resample(freq).max()
    out.attrs["units"] = snw.attrs.get("units", "")
    return out


@declare_units(q="[discharge]")
def flow_index(q: ClimArray, p: float = 0.95) -> ClimArray:
    """Qp / Qmedian flow index (xclim:_hydrology.py:577)."""
    qp = q.quantile(p, dim="time")
    qm = q.median(dim="time")
    out = qp / qm
    out.attrs["units"] = "1"
    return out


@declare_units(q="[discharge]")
def high_flow_frequency(q: ClimArray, threshold_factor: float = 9,
                        freq: str = "YS-OCT") -> ClimArray:
    """Days with flow > factor × median (xclim:_hydrology.py:607)."""
    med = q.median(dim="time")
    thresh = med * threshold_factor
    thresh.attrs["units"] = q.attrs.get("units", "")
    out = threshold_count(q, ">", thresh, freq=freq)
    return to_agg_units(out, q, "count", deffreq="D")


@declare_units(q="[discharge]")
def low_flow_frequency(q: ClimArray, threshold_factor: float = 0.2,
                       freq: str = "YS-OCT") -> ClimArray:
    """Days with flow < factor × mean (xclim:_hydrology.py:640)."""
    mean = q.mean(dim="time")
    thresh = mean * threshold_factor
    thresh.attrs["units"] = q.attrs.get("units", "")
    out = threshold_count(q, "<", thresh, freq=freq)
    return to_agg_units(out, q, "count", deffreq="D")


@declare_units(snw="[snowamount]", q="[discharge]")
def lag_snowpack_flow_peaks(snw: ClimArray, q: ClimArray, freq: str = "YS-OCT",
                            p: float = 0.9) -> ClimArray:
    """Days between annual max snowpack and the mean date of high-flow days
    (xclim:_hydrology.py:826).

    High-flow days are those where q exceeds its per-period `p` quantile; the
    lag is (mean high-flow date) − (date of max snw), negative when high flows
    precede peak snow cover.  One static gather per period; the per-period
    quantile + conditional date mean run as a single fused device program.
    """
    from xclim_tpu_torch.core.calendar import resample_segments
    from xclim_tpu_torch.ops.quantile import nan_quantile
    from xclim_tpu_torch.ops.segments import _gather_segments, build_gather_table

    spec = resample_segments(snw.time, freq)
    ax = snw.time_axis
    # seconds since series start, per time step
    rel = (snw.time.encode() - snw.time.encode()[0]).astype(np.float64)

    idx, has = segment_argminmax(snw.data, spec, "max", axis=ax)
    # seconds since the start in float32, rounded once on the host as the
    # reference rounds them (at 30 years one ulp is 64 s)
    relj = torch.as_tensor(np.concatenate([rel, [np.nan]]).astype(np.float32),
                           device=snw.data.device)
    dt_snw = torch.where(has, relj[torch.where(idx >= 0, idx, len(rel)).long()],
                         torch.nan)

    table = build_gather_table(spec)
    g, pad_ok = _gather_segments(q.data, table, q.time_axis)  # (nseg, maxlen, ...)
    g = torch.where(pad_ok, g, torch.nan)
    thr = nan_quantile(torch.movedim(g, 1, 0), [p], axis=0)[0]  # (nseg, ...)
    tt = torch.as_tensor(table, dtype=torch.int64, device=g.device)
    rel_tbl = torch.where(tt >= 0, relj[tt.clamp(min=0)], torch.nan)
    rel_g = rel_tbl.reshape(rel_tbl.shape + (1,) * (g.ndim - 2))
    high = g >= thr[:, None]
    dt_q = torch.nanmean(torch.where(high, rel_g, torch.nan), dim=1)  # (nseg, ...)

    lag = (dt_q - torch.movedim(dt_snw, ax, 0)) / 86400.0
    lag = torch.movedim(lag, 0, ax)
    out_coords = dict(snw.coords)
    out_coords["time"] = spec.labels
    out = ClimArray(lag, snw.dims, out_coords, {"units": "d"}, "lag")
    return out


@declare_units(pr="[precipitation]")
def antecedent_precipitation_index(pr: ClimArray, window: int = 7,
                                   p_exp: float = 0.935) -> ClimArray:
    """Weighted precipitation accumulation (xclim:_hydrology.py:673)."""
    pram = convert_units_to(rate2amount(pr), "mm", context="hydro")
    w = np.array([p_exp ** (idx - 1) for idx in range(1, window + 1)][::-1],
                 dtype=np.float32)
    ax = pram.time_axis
    out = weighted_window_sum(pram.data, ax, w, window - 1, 0)
    res = pram.copy(data=out)
    res.attrs = {"units": "mm"}
    return res


def _diff_nan_first(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x[t] - x[t-1] along `axis`, NaN at the first step (the reference's
    diff padded at the front)."""
    d = torch.diff(x, dim=axis)
    first = torch.full_like(x.narrow(axis, 0, 1), torch.nan)
    return torch.cat([first, d], dim=axis)


@declare_units(q="[discharge]", pr="[precipitation]", area="[area]")
def runoff_ratio(q: ClimArray, pr: ClimArray, area, freq: str = "YS") -> ClimArray:
    """Runoff / precipitation ratio (xclim:_hydrology.py)."""
    qs = convert_units_to(q, "m3/h")
    a = convert_units_to(str2pint(area), "m2") if isinstance(area, str) else \
        convert_units_to(area, "m2").data
    prh = convert_units_to(pr, "mm/h", context="hydro")
    runoff = qs.copy(data=qs.data / a * 1000.0)  # m/h → mm/h
    rmean = runoff.resample(freq).mean()
    pmean = prh.resample(freq).mean()
    out = rmean / pmean
    out.attrs["units"] = ""
    return out


@declare_units(pr="[precipitation]", evspsblpot="[precipitation]")
def aridity_index(pr: ClimArray, evspsblpot: ClimArray, freq: str = "YS") -> ClimArray:
    """P / PET aridity index (xclim:_hydrology.py)."""
    pet = convert_units_to(evspsblpot, pr, context="hydro")
    prm = pr.resample(freq).mean()
    petm = pet.resample(freq).mean()
    out = prm / petm
    out.attrs["units"] = ""
    return out


@declare_units(q="[discharge]")
def sen_slope(q: ClimArray, freq: str = "YS"):
    """Sen's slope + Mann-Kendall p-value over resampled means
    (xclim:_hydrology.py:894). Runs on device: pairwise slopes + rank stats."""
    qr = q.resample(freq).mean()
    ax = qr.time_axis
    x = torch.movedim(qr.data, ax, -1)  # (..., n)
    n = x.shape[-1]
    i, j = np.triu_indices(n, k=1)
    ii = torch.as_tensor(i, device=x.device)
    jj = torch.as_tensor(j, device=x.device)
    slopes = (x[..., jj] - x[..., ii]) / torch.as_tensor(
        (j - i).astype(np.float32), device=x.device)
    slope = _nanmedian(slopes, axis=-1)
    # Mann-Kendall S statistic and normal-approximation p-value; the square
    # roots in float32, as the reference takes them
    s = torch.sign(x[..., jj] - x[..., ii]).sum(dim=-1)
    var_s = n * (n - 1) * (2 * n + 5) / 18.0
    sd = float(np.sqrt(np.float32(var_s)))
    z = torch.where(s > 0, (s - 1) / sd,
                    torch.where(s < 0, (s + 1) / sd, 0.0))
    p = torch.special.erfc(z.abs() / float(np.sqrt(np.float32(2.0))))
    out_dims = tuple(d for d in qr.dims if d != "time")
    coords = {c: v for c, v in qr.coords.items() if c != "time"}
    sl = ClimArray(slope, out_dims, coords, {"units": ""}, "sen_slope")
    pv = ClimArray(p, out_dims, dict(coords), {"units": ""}, "p_value")
    return sl, pv


@declare_units(q="[discharge]", qsim="[discharge]")
def sen_slope_ratio(q: ClimArray, qsim: ClimArray, freq: str = "YS"):
    """Sen slope + Mann-Kendall test of observed and simulated streamflow,
    and the ratio of their slopes (xclim:_hydrology.py:949).

    Returns (sen_slope, p_value, sen_slope_sim, p_value_sim, ratio).
    """
    s_obs, p_obs = sen_slope(q, freq=freq)
    s_sim, p_sim = sen_slope(qsim, freq=freq)
    ratio = s_sim / s_obs.where(s_obs.data.abs() > 0)
    ratio.attrs["units"] = ""
    ratio.name = "sen_slope_ratio"
    return s_obs, p_obs, s_sim, p_sim, ratio
