"""Canadian Forest Fire Weather Index System
(reference: xclim:src/xclim/indices/fire/_cffwis.py; Van Wagner 1987).

The day-to-day recurrence is a Python loop over time whose carry (DC, DMC,
FFMC, and with a season the overwintering state) stays on the device; no
step reads a value back to the host. Every term that does not read the
carry (the equilibrium moistures, drying rates, rain inputs, potential
evapotranspiration, and the season's start-up/shut-down/winter booleans)
is computed once over the whole series before the loop, with the same
expression as the one-step function, so the loop only evaluates what
depends on yesterday's codes, and only for the codes a caller returns:
``drought_code`` and ``duff_moisture_code`` update their one code and
compute no derived index (:func:`_run_codes`). The fire-season latch needs
no loop at all
(:func:`_latch`). Day-length tables are host numpy, gathered by latitude
band.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, declare_units, str2pint
from xclim_tpu_torch.ops.segments import rolling_reduce

__all__ = [
    "DAY_LENGTHS",
    "DAY_LENGTH_FACTORS",
    "build_up_index",
    "cffwis_indices",
    "daily_severity_rating",
    "drought_code",
    "duff_moisture_code",
    "fire_season",
    "fire_weather_ufunc",
    "fire_weather_index",
    "initial_spread_index",
    "overwintering_drought_code",
]

default_params = {
    "temp_start_thresh": 12.0,   # degC
    "temp_end_thresh": 5.0,      # degC
    "snow_thresh": 0.01,         # m
    "temp_condition_days": 3,
    "snow_condition_days": 3,
    "carry_over_fraction": 0.75,
    "wetting_efficiency_fraction": 0.75,
    "dc_start": 15.0,
    "dmc_start": 6.0,
    "ffmc_start": 85.0,
    "prec_thresh": 1.0,          # mm/d
    "dc_dry_factor": 5.0,
    "dmc_dry_factor": 2.0,
}

# Monthly effective day-length tables per latitude band (GFWED values,
# xclim:_cffwis.py:189-207)
DAY_LENGTHS = np.array([
    [11.5, 10.5, 9.2, 7.9, 6.8, 6.2, 6.5, 7.4, 8.7, 10, 11.2, 11.8],
    [10.1, 9.6, 9.1, 8.5, 8.1, 7.8, 7.9, 8.3, 8.9, 9.4, 9.9, 10.2],
    12 * [9.0],
    [7.9, 8.4, 8.9, 9.5, 9.9, 10.2, 10.1, 9.7, 9.1, 8.6, 8.1, 7.8],
    [6.5, 7.5, 9, 12.8, 13.9, 13.9, 12.4, 10.9, 9.4, 8, 7, 6],
])

DAY_LENGTH_FACTORS = np.array([
    [6.4, 5.0, 2.4, 0.4, -1.6, -1.6, -1.6, -1.6, -1.6, 0.9, 3.8, 5.8],
    12 * [1.39],
    [-1.6, -1.6, -1.6, 0.9, 3.8, 5.8, 6.4, 5.0, 2.4, 0.4, -1.6, -1.6],
])

_CFFWIS = namedtuple("CFFWIS", ["dc", "dmc", "ffmc", "isi", "bui", "fwi",
                                "dsr"])


def _day_length_series(months: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """(T, *lat_shape) effective day lengths from the banded table; lat may
    be scalar, 1-D or an N-D grid."""
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    flat = lat.reshape(-1)
    band = np.select(
        [flat < -30, flat < -15, flat < 15, flat < 30], [0, 1, 2, 3], default=4)
    out = DAY_LENGTHS[band][:, months - 1].T  # (T, L)
    return out.reshape((len(months),) + lat.shape)


def _day_length_factor_series(months: np.ndarray, lat: np.ndarray) -> np.ndarray:
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    flat = lat.reshape(-1)
    band = np.select([flat < -15, flat < 15], [0, 1], default=2)
    out = DAY_LENGTH_FACTORS[band][:, months - 1].T
    return out.reshape((len(months),) + lat.shape)


# ---------------------------------------------------------------------------
# one-step code updates (Van Wagner 1987 equations, branchless), each split
# into the terms that do not read the carry and the update that does
# ---------------------------------------------------------------------------


def _ffmc_terms(t, p, w, h):
    """FFMC terms of the day's weather alone (Eqs. 1-10): the rain inputs
    and the equilibrium moistures and drying factors."""
    rf = p - 0.5
    ed = (0.942 * h ** 0.679 + 11.0 * torch.exp((h - 100.0) / 10.0)
          + 0.18 * (21.1 - t) * (1.0 - torch.exp(-0.115 * h)))
    ew = (0.618 * h ** 0.753 + 10.0 * torch.exp((h - 100.0) / 10.0)
          + 0.18 * (21.1 - t) * (1.0 - torch.exp(-0.115 * h)))
    kl_dry = 0.424 * (1.0 - (h / 100.0) ** 1.7) + 0.0694 * torch.sqrt(w) * (1.0 - (h / 100.0) ** 8)
    kw_dry = kl_dry * 0.581 * torch.exp(0.0365 * t)
    kl_wet = 0.424 * (1.0 - ((100.0 - h) / 100.0) ** 1.7) \
        + 0.0694 * torch.sqrt(w) * (1.0 - ((100.0 - h) / 100.0) ** 8)
    kw_wet = kl_wet * 0.581 * torch.exp(0.0365 * t)
    return (42.5 * rf, 1.0 - torch.exp(-6.93 / rf),
            torch.sqrt(torch.clamp(rf, min=0)), p > 0.5,
            ed, ew, 10.0 ** kw_dry, 10.0 ** kw_wet)


def _ffmc_update(terms, ffmc0, out=None):
    rain_a, rain_b, rain_c, wet, ed, ew, dry_rate, wet_rate = terms
    mo = 147.2 * (101.0 - ffmc0) / (59.5 + ffmc0)
    mo_wet_lo = mo + rain_a * torch.exp(-100.0 / (251.0 - mo)) * rain_b
    mo_wet_hi = mo_wet_lo + 0.0015 * (mo - 150.0) ** 2 * rain_c
    mo_wet = torch.where(mo > 150.0, mo_wet_hi, mo_wet_lo)
    mo = torch.where(wet, torch.clamp(mo_wet, max=250.0), mo)
    m_dry = ed + (mo - ed) / dry_rate
    m_wet = ew - (ew - mo) / wet_rate
    m = torch.where(mo < ed, torch.where(mo < ew, m_wet, mo),
                    torch.where(mo == ed, mo, m_dry))
    ffmc = 59.5 * (250.0 - m) / (147.2 + m)
    return torch.clamp(ffmc, 0.0, 101.0, out=out)


def _ffmc_step(t, p, w, h, ffmc0):
    """Fine fuel moisture code update (Eqs. 1-10)."""
    return _ffmc_update(_ffmc_terms(t, p, w, h), ffmc0)


def _dmc_terms(t, p, h, dl):
    """DMC terms of the day's weather alone: the drying rate rk, the
    effective rain rw (and 1000 rw) and the wet-day test."""
    rk = torch.where(t < -1.1, 0.0, 1.894 * (t + 1.1) * (100.0 - h) * dl * 1e-4)
    rw = 0.92 * p - 1.27
    return rk, rw, 1000 * rw, p > 1.5


def _dmc_update(terms, dmc0, out=None):
    rk, rw, rw1000, wet = terms
    wmi = 20.0 + 280.0 / torch.exp(0.023 * dmc0)
    b = torch.where(dmc0 <= 33.0, 100.0 / (0.5 + 0.3 * dmc0),
                    torch.where(dmc0 <= 65.0, 14.0 - 1.3 * torch.log(dmc0),
                                6.2 * torch.log(dmc0) - 17.2))
    wmr = wmi + rw1000 / (48.77 + b * rw)
    pr_wet = 43.43 * (5.6348 - torch.log(torch.clamp(wmr - 20.0, min=1e-8)))
    pr = torch.where(wet, pr_wet, dmc0)
    pr = torch.clamp(pr, min=0.0)
    return torch.clamp(pr + rk, min=0.0, out=out)


def _dmc_step(t, p, h, dl, dmc0):
    """Duff moisture code update (Eqs. 11-17, CFS variant of Eq. 12/15)."""
    return _dmc_update(_dmc_terms(t, p, h, dl), dmc0)


def _dc_terms(t, p, fl):
    """DC terms of the day's weather alone: the potential
    evapotranspiration pe, 3.937 rw and the wet-day test."""
    tc = torch.clamp(t, min=-2.8)
    pe = torch.clamp((0.36 * (tc + 2.8) + fl) / 2, min=0.0)
    rw = 0.83 * p - 1.27
    return pe, 3.937 * rw, p > 2.8


def _dc_update(terms, dc0, out=None):
    pe, rw3937, wet = terms
    smi = 800.0 * torch.exp(-dc0 / 400.0)
    dr = dc0 - 400.0 * torch.log(1.0 + rw3937 / smi)
    dc_wet = torch.where(dr > 0.0, dr + pe, pe)
    return torch.where(wet, dc_wet, dc0 + pe, out=out)


def _dc_step(t, p, fl, dc0):
    """Drought code update (Eqs. 18-22)."""
    return _dc_update(_dc_terms(t, p, fl), dc0)


def initial_spread_index(ws, ffmc):
    """ISI from wind & FFMC (Eqs. 25-26; xclim:_cffwis.py:436)."""
    mo = 147.2 * (101.0 - ffmc) / (59.5 + ffmc)
    ff = 19.1152 * torch.exp(mo * -0.1386) * (1.0 + mo ** 5.31 / 49300000.0)
    return ff * torch.exp(0.05039 * ws)


def build_up_index(dmc, dc):
    """BUI from DMC & DC (Eq. 27; xclim:_cffwis.py:466)."""
    both_zero = (dmc == 0) & (dc == 0)
    denom = torch.where(both_zero, torch.nan, dmc + 0.4 * dc)
    bui = torch.where(both_zero, 0.0,
                      torch.where(dmc <= 0.4 * dc, 0.8 * dc * dmc / denom,
                                  dmc - (1.0 - 0.8 * dc / denom)
                                  * (0.92 + (0.0114 * dmc) ** 1.7)))
    return torch.clamp(bui, min=0.0)


def fire_weather_index(isi, bui):
    """FWI from ISI & BUI (Eqs. 28-30; xclim:_cffwis.py:497)."""
    fwi = torch.where(bui <= 80.0, 0.1 * isi * (0.626 * bui ** 0.809 + 2.0),
                      0.1 * isi * (1000.0 / (25.0 + 108.64 / torch.exp(0.023 * bui))))
    big = torch.exp(2.72 * (0.434 * torch.log(torch.clamp(fwi, min=1e-8))) ** 0.647)
    return torch.where(fwi > 1, big, fwi)


def daily_severity_rating(fwi):
    """DSR (xclim:_cffwis.py:522)."""
    return 0.0272 * fwi ** 1.77


def _overwintered_dc(DCf, wpr, a, b, minDC):
    """Season-starting DC from last season's DC and winter precip
    (xclim:_cffwis.py:530)."""
    Qf = 800 * torch.exp(-DCf / 400)
    Qs = a * Qf + b * 3.94 * wpr
    DCs = 400 * torch.log(800 / Qs)
    return torch.clamp(DCs, min=minDC)


# ---------------------------------------------------------------------------
# fire season (xclim:_cffwis.py:570): rolling conditions, then a latch
# ---------------------------------------------------------------------------


def _latch(start_up, shut_down):
    """The season mask ``mask_t = (mask_{t-1} | su_t) & ~sd_t`` from
    ``mask_{-1} = False``, time on axis 0, without a loop: each day takes
    the value set on the last day up to it where ``su | sd`` holds (False
    where ``sd`` does), and False before the first such day. That day is a
    running maximum of ``2 t + value`` over the days where either is set."""
    T = start_up.shape[0]
    day = torch.arange(T, dtype=torch.int32, device=start_up.device)
    day = day.reshape((T,) + (1,) * (start_up.ndim - 1))
    code = torch.where(start_up | shut_down,
                       2 * day + (start_up & ~shut_down).to(torch.int32), -1)
    last = torch.cummax(code, dim=0).values
    return (last >= 0) & (last % 2 == 1)


def _season_masks(tas, snd, method, p):
    """Fire-season mask (T, ...) from rolling conditions, time on axis 0."""
    tcd = p["temp_condition_days"]
    scd = p["snow_condition_days"]
    if method == "WF93":
        # last tcd days EXCLUDING today: shifted by one, day 0 NaN
        def yesterday(x):
            return torch.cat([torch.full_like(x[:1], torch.nan), x[:-1]])

        tmin = yesterday(rolling_reduce(tas, tcd, "min", axis=0))
        tmax = yesterday(rolling_reduce(tas, tcd, "max", axis=0))
        start_up = tmin > p["temp_start_thresh"]
        shut_down = tmax < p["temp_end_thresh"]
    elif method == "LA08":
        smax = rolling_reduce(snd, scd, "max", axis=0)
        tmax = rolling_reduce(tas, tcd, "max", axis=0)
        start_up = smax <= p["snow_thresh"]
        shut_down = (snd > p["snow_thresh"]) | (tmax < p["temp_end_thresh"])
    elif method == "GFWED":
        msnow = rolling_reduce(snd, scd, "mean", axis=0)
        mtemp = rolling_reduce(tas, tcd, "mean", axis=0)
        start_up = (mtemp > p["temp_start_thresh"]) & (msnow < p["snow_thresh"])
        shut_down = (msnow >= p["snow_thresh"]) | (mtemp < p["temp_end_thresh"])
    else:
        raise ValueError("method must be one of WF93, LA08, GFWED")
    return _latch(start_up, shut_down)


def fire_season_mask(tas, snd=None, method: str = "WF93", **params):
    """Boolean fire-season mask, time on axis 0 (xclim:_cffwis.py:570)."""
    p = {**default_params, **params}
    return _season_masks(tas, snd, method, p)


# ---------------------------------------------------------------------------
# the recurrence (xclim:_cffwis.py:655-880)
# ---------------------------------------------------------------------------


def _array(x, like):
    """x given as a tensor, a numpy array or a ClimArray of either package,
    as a tensor: a tensor keeps its device, host values go to like's."""
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x), device=like.device)


def _state(x, like):
    """A carried state (initial codes, winter precipitation) as a tensor of
    like's dtype (see :func:`_array`)."""
    return _array(x, like).to(like.dtype)


def _on_time(x, like):
    """A (T, ...) day-length series broadcast against time-first data: its
    trailing dims line up with axis 1 on (a view, no copy)."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim)).expand(like.shape)


def _initial_state(shape, like, p, always_on, dc0, dmc0, ffmc0, winter_pr0,
                   overwintering, dry_start):
    """The carry before day 0: the codes ({"DC", "DMC", "FFMC"}) and the
    overwintering state (DC and DMC to start from, winter precipitation)."""
    nanarr = torch.full(shape, torch.nan, dtype=like.dtype, device=like.device)
    dc0 = nanarr if dc0 is None else _state(dc0, like)
    dmc0 = nanarr if dmc0 is None else _state(dmc0, like)
    ffmc0 = nanarr if ffmc0 is None else _state(ffmc0, like)
    wpr = torch.zeros_like(nanarr) if winter_pr0 is None else _state(winter_pr0, like)
    if always_on:
        return {"DC": torch.where(torch.isnan(dc0), p["dc_start"], dc0),
                "DMC": torch.where(torch.isnan(dmc0), p["dmc_start"], dmc0),
                "FFMC": torch.where(torch.isnan(ffmc0), p["ffmc_start"], ffmc0)}, \
            (nanarr, nanarr, wpr)
    # with a season, codes start off (NaN) until the first start-up
    ow_dc = dc0 if (overwintering or dry_start) else nanarr
    if dry_start and not overwintering:
        ow_dc = torch.where(torch.isnan(ow_dc), p["dc_start"], ow_dc)
    ow_dmc = torch.where(torch.isnan(dmc0), p["dmc_start"], dmc0) \
        if dry_start else nanarr
    return {"DC": nanarr if overwintering else dc0, "DMC": dmc0,
            "FFMC": ffmc0}, (ow_dc, ow_dmc, wpr)


def _season_flags(season_mask, pr, initial_start_up, p):
    """The mask's transitions for all days at once (yesterday's mask is the
    carry of the reference's scan): start-up, shut-down, winter, and the
    winter's wet and dry days."""
    sm = season_mask.to(torch.int32)
    prev0 = torch.zeros_like(sm[:1]) if initial_start_up else sm[:1]
    delta = sm - torch.cat([prev0, sm[:-1]])
    winter = (delta == 0) & (sm == 0)
    wet = pr > p["prec_thresh"]
    return delta == 1, delta == -1, winter, winter & wet, winter & ~wet


def _season_day(i, codes, ow, flags, pr, p, overwintering, dry_start):
    """Day i's season transitions of the codes present in ``codes``, before
    their updates: the codes start at a start-up (the DC from last season's
    DC and the winter's precipitation with overwintering, the DC and DMC
    from the count of dry winter days with a dry start) and stop (NaN) at a
    shut-down."""
    codes = dict(codes)
    ow_dc, ow_dmc, wpr = ow
    su, sd, winter, winter_wet, winter_dry = (f[i] for f in flags)
    if "DC" in codes:
        dc = codes["DC"]
        if overwintering:
            ow_dc = torch.where(sd, dc, ow_dc)
            wpr = torch.where(sd, pr[i], torch.where(winter, wpr + pr[i], wpr))
            started_dc = torch.where(
                torch.isnan(ow_dc), p["dc_start"],
                _overwintered_dc(ow_dc, wpr, p["carry_over_fraction"],
                                 p["wetting_efficiency_fraction"], p["dc_start"]))
            dc = torch.where(su, started_dc, dc)
            ow_dc = torch.where(su, torch.nan, ow_dc)
            wpr = torch.where(su, 0.0, wpr)
        elif dry_start:
            ow_dc = torch.where(sd, p["dc_start"], ow_dc)
            ow_dc = torch.where(winter_wet, p["dc_start"], ow_dc)
            ow_dc = torch.where(winter_dry, ow_dc + p["dc_dry_factor"], ow_dc)
            dc = torch.where(su, ow_dc, dc)
            ow_dc = torch.where(su, torch.nan, ow_dc)
        else:
            dc = torch.where(su, p["dc_start"], dc)
        codes["DC"] = torch.where(sd, torch.nan, dc)
    if "DMC" in codes:
        dmc = codes["DMC"]
        if dry_start:
            ow_dmc = torch.where(sd, p["dmc_start"], ow_dmc)
            ow_dmc = torch.where(winter_wet, p["dmc_start"], ow_dmc)
            ow_dmc = torch.where(winter_dry, ow_dmc + p["dmc_dry_factor"], ow_dmc)
            dmc = torch.where(su, ow_dmc, dmc)
            ow_dmc = torch.where(su, torch.nan, ow_dmc)
        else:
            dmc = torch.where(su, p["dmc_start"], dmc)
        codes["DMC"] = torch.where(sd, torch.nan, dmc)
    if "FFMC" in codes:
        ffmc = torch.where(su, p["ffmc_start"], codes["FFMC"])
        codes["FFMC"] = torch.where(sd, torch.nan, ffmc)
    return codes, (ow_dc, ow_dmc, wpr)


_UPDATES = {"DC": _dc_update, "DMC": _dmc_update, "FFMC": _ffmc_update}


def _code_terms(which, tas, pr, hurs, sfcWind, dl, flf):
    """The carry-free terms of the codes in ``which`` for the whole
    series."""
    make = {"DC": lambda: _dc_terms(tas, pr, _on_time(flf, tas)),
            "DMC": lambda: _dmc_terms(tas, pr, hurs, _on_time(dl, tas)),
            "FFMC": lambda: _ffmc_terms(tas, pr, sfcWind, hurs)}
    return {k: make[k]() for k in which}


def _run_codes(which, tas, pr, hurs, sfcWind, dl, flf, season_mask=None,
               dc0=None, dmc0=None, ffmc0=None, winter_pr0=None,
               overwintering: bool = False, dry_start: str | None = None,
               initial_start_up: bool = True, **params):
    """The recurrence of the codes named in ``which`` (of "DC", "DMC",
    "FFMC") over time axis 0, and no other: a code that is not asked for
    is neither updated nor started. The inputs a code does not read (hurs
    and sfcWind for DC, sfcWind and flf for DMC) may be None. Returns a dict
    of the codes, ``winter_pr`` and ``season_mask``."""
    p = {**default_params, **params}
    always_on = season_mask is None
    if always_on:
        season_mask = torch.ones_like(tas, dtype=torch.bool)
    codes, ow = _initial_state(tas.shape[1:], tas, p, always_on, dc0, dmc0,
                               ffmc0, winter_pr0, overwintering, dry_start)
    codes = {k: codes[k] for k in which}
    terms = _code_terms(which, tas, pr, hurs, sfcWind, dl, flf)
    out = {k: torch.empty_like(tas) for k in which}
    flags = None if always_on else _season_flags(season_mask, pr,
                                                 initial_start_up, p)
    for i in range(tas.shape[0]):
        if not always_on:
            codes, ow = _season_day(i, codes, ow, flags, pr, p,
                                    overwintering, dry_start)
        codes = {k: _UPDATES[k]([x[i] for x in terms[k]], codes[k],
                                out=out[k][i]) for k in which}
    return dict(out, winter_pr=ow[2], season_mask=season_mask)


def fire_weather_calc(tas, pr, hurs, sfcWind, dl, flf, season_mask=None,
                      dc0=None, dmc0=None, ffmc0=None, winter_pr0=None,
                      overwintering: bool = False, dry_start: str | None = None,
                      initial_start_up: bool = True, **params):
    """Run the full CFFWIS over time axis 0.

    tas [degC], pr [mm/day], hurs [%], sfcWind [km/h], dl/flf day-length
    (factor) series (T, ...-broadcastable). Returns a dict with DC, DMC,
    FFMC, ISI, BUI, FWI, DSR, winter_pr, season_mask.
    """
    out = _run_codes(("DC", "DMC", "FFMC"), tas, pr, hurs, sfcWind, dl, flf,
                     season_mask=season_mask, dc0=dc0, dmc0=dmc0, ffmc0=ffmc0,
                     winter_pr0=winter_pr0, overwintering=overwintering,
                     dry_start=dry_start, initial_start_up=initial_start_up,
                     **params)
    out["ISI"] = initial_spread_index(sfcWind, out["FFMC"])
    out["BUI"] = build_up_index(out["DMC"], out["DC"])
    out["FWI"] = fire_weather_index(out["ISI"], out["BUI"])
    out["DSR"] = daily_severity_rating(out["FWI"])
    return out


# ---------------------------------------------------------------------------
# public ClimArray API (xclim:_cffwis.py:883-1608)
# ---------------------------------------------------------------------------


def _lat_values(lat, t):
    """The latitudes as host float64: ``lat``, else t's ``lat`` coordinate,
    else 45 degrees."""
    lat = t.coords.get("lat", 45.0) if lat is None else getattr(lat, "values", lat)
    if isinstance(lat, torch.Tensor):
        lat = lat.cpu().numpy()
    return np.atleast_1d(np.asarray(lat, dtype=np.float64))


def _day_lengths(t, lat):
    """dl and flf of t's months at ``lat`` on t's device: (T,) for one
    latitude, else (T, *lat.shape)."""
    months = t.time.month
    latv = _lat_values(lat, t)
    dl, flf = (torch.as_tensor(f(months, latv).astype(np.float32),
                               device=t.data.device)
               for f in (_day_length_series, _day_length_factor_series))
    if latv.size == 1:
        dl, flf = dl[:, 0], flf[:, 0]
    return dl, flf


def _to_time_first(da: ClimArray):
    ax = da.time_axis
    return torch.movedim(da.data, ax, 0), ax


def _season(td, snd, season_method, params):
    """The season mask of a season_method (None without one), time first."""
    if season_method is None:
        return None
    sndd = None if snd is None else _to_time_first(convert_units_to(snd, "m"))[0]
    return _season_masks(td, sndd, season_method, {**default_params, **params})


def _code(t, out, ax, name):
    res = t.copy(data=torch.movedim(out, 0, ax))
    res.attrs = {"units": ""}
    res.name = name
    return res


def _cffwis_inputs(tas, pr, sfcWind, hurs, lat, snd, season_mask,
                   season_method, params):
    """cffwis_indices' inputs for fire_weather_calc: tas in degC and its
    time axis, (tas, pr, hurs, sfcWind, dl, flf) time first in the units
    of the equations, and the season mask (None for always on)."""
    t = convert_units_to(tas, "degC")
    td, ax = _to_time_first(t)
    pd_ = _to_time_first(convert_units_to(pr, "mm/d", context="hydro"))[0]
    hd = _to_time_first(convert_units_to(hurs, "%"))[0]
    wd = _to_time_first(convert_units_to(sfcWind, "km/h"))[0]
    dl, flf = _day_lengths(t, lat)
    if season_mask is not None:
        sm = torch.movedim(_array(season_mask, td), ax, 0)
    else:
        sm = _season(td, snd, season_method, params)
    return t, ax, (td, pd_, hd, wd, dl, flf), sm


@declare_units(tas="[temperature]", pr="[precipitation]", sfcWind="[speed]",
               hurs="[]")
def cffwis_indices(tas: ClimArray, pr: ClimArray, sfcWind: ClimArray,
                   hurs: ClimArray, lat=None, snd: ClimArray | None = None,
                   ffmc0=None, dmc0=None, dc0=None, season_mask=None,
                   season_method: str | None = None,
                   overwintering: bool = False, dry_start: str | None = None,
                   initial_start_up: bool = True, **params):
    """DC, DMC, FFMC, ISI, BUI, FWI, DSR (xclim:_cffwis.py:1278)."""
    t, ax, args, sm = _cffwis_inputs(tas, pr, sfcWind, hurs, lat, snd,
                                     season_mask, season_method, params)
    out = fire_weather_calc(*args, season_mask=sm,
                            dc0=dc0, dmc0=dmc0, ffmc0=ffmc0,
                            overwintering=overwintering, dry_start=dry_start,
                            initial_start_up=initial_start_up, **params)
    return _CFFWIS(*(_code(t, out[k], ax, k.lower()) for k in
                     ("DC", "DMC", "FFMC", "ISI", "BUI", "FWI", "DSR")))


@declare_units(tas="[temperature]", pr="[precipitation]")
def drought_code(tas: ClimArray, pr: ClimArray, lat=None, snd=None, dc0=None,
                 season_mask=None, season_method=None, overwintering=False,
                 dry_start=None, initial_start_up=True, **params) -> ClimArray:
    """Drought code only (xclim:_cffwis.py:1416)."""
    t = convert_units_to(tas, "degC")
    td, ax = _to_time_first(t)
    pd_ = _to_time_first(convert_units_to(pr, "mm/d", context="hydro"))[0]
    _, flf = _day_lengths(t, lat)
    sm = _season(td, snd, season_method, params)
    out = _run_codes(("DC",), td, pd_, None, None, None, flf, season_mask=sm,
                     dc0=dc0, overwintering=overwintering, dry_start=dry_start,
                     initial_start_up=initial_start_up, **params)
    return _code(t, out["DC"], ax, "dc")


@declare_units(tas="[temperature]", pr="[precipitation]", hurs="[]")
def duff_moisture_code(tas: ClimArray, pr: ClimArray, hurs: ClimArray, lat=None,
                       snd=None, dmc0=None, season_mask=None, season_method=None,
                       dry_start=None, initial_start_up=True, **params) -> ClimArray:
    """Duff moisture code only (xclim:_cffwis.py:1513)."""
    t = convert_units_to(tas, "degC")
    td, ax = _to_time_first(t)
    pd_ = _to_time_first(convert_units_to(pr, "mm/d", context="hydro"))[0]
    hd = _to_time_first(convert_units_to(hurs, "%"))[0]
    dl, _ = _day_lengths(t, lat)
    sm = _season(td, snd, season_method, params)
    out = _run_codes(("DMC",), td, pd_, hd, None, dl, None, season_mask=sm,
                     dmc0=dmc0, dry_start=dry_start,
                     initial_start_up=initial_start_up, **params)
    return _code(t, out["DMC"], ax, "dmc")


@declare_units(tas="[temperature]", snd="[length]")
def fire_season(tas: ClimArray, snd: ClimArray | None = None,
                method: str = "WF93", freq: str | None = None,
                temp_start_thresh: str = "12 degC",
                temp_end_thresh: str = "5 degC",
                temp_condition_days: int = 3, snow_condition_days: int = 3,
                snow_thresh: str = "0.01 m") -> ClimArray:
    """Fire season mask (xclim:_cffwis.py:1608)."""
    t = convert_units_to(tas, "degC")
    td, ax = _to_time_first(t)
    p = dict(default_params)
    p.update(temp_start_thresh=convert_units_to(str2pint(temp_start_thresh), "degC"),
             temp_end_thresh=convert_units_to(str2pint(temp_end_thresh), "degC"),
             temp_condition_days=temp_condition_days,
             snow_condition_days=snow_condition_days,
             snow_thresh=convert_units_to(str2pint(snow_thresh), "m"))
    res = t.copy(data=torch.movedim(_season(td, snd, method, p), 0, ax))
    res.attrs = {"units": ""}
    res.name = "fire_season"
    return res


@declare_units(last_dc="[]", winter_pr="[length]")
def overwintering_drought_code(last_dc: ClimArray, winter_pr: ClimArray,
                               carry_over_fraction=0.75,
                               wetting_efficiency_fraction=0.75,
                               min_dc: float = 15.0) -> ClimArray:
    """Overwintered season-starting DC (xclim:_cffwis.py:1170)."""
    wpr = convert_units_to(winter_pr, "mm")
    out = last_dc.copy(data=_overwintered_dc(last_dc.data, wpr.data,
                                             carry_over_fraction,
                                             wetting_efficiency_fraction, min_dc))
    out.attrs = {"units": ""}
    out.name = "dc0"
    return out


def fire_weather_ufunc(*, tas: ClimArray, pr: ClimArray,
                       hurs: ClimArray | None = None,
                       sfcWind: ClimArray | None = None, lat=None, snd=None,
                       dc0=None, dmc0=None, ffmc0=None, winter_pr=None,
                       season_mask=None, season_method=None,
                       overwintering=False, dry_start=None,
                       initial_start_up=True, indexes=None, **params):
    """Dict-returning entry point mirroring the reference's fire_weather_ufunc
    (xclim:_cffwis.py:883); ``winter_pr`` and ``indexes`` are accepted and
    not read, as in the JAX package."""
    outs = cffwis_indices(tas, pr, sfcWind, hurs, lat=lat, snd=snd, dc0=dc0,
                          dmc0=dmc0, ffmc0=ffmc0, season_mask=season_mask,
                          season_method=season_method,
                          overwintering=overwintering, dry_start=dry_start,
                          initial_start_up=initial_start_up, **params)
    return {"DC": outs.dc, "DMC": outs.dmc, "FFMC": outs.ffmc, "ISI": outs.isi,
            "BUI": outs.bui, "FWI": outs.fwi, "DSR": outs.dsr}
