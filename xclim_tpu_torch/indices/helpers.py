"""Solar geometry & meteorological helpers
(reference: xclim:src/xclim/indices/helpers.py).

The solar geometry (Spencer 1971 Fourier series for declination and
eccentricity, FAO-56 closed forms for the daily extraterrestrial
radiation) is computed in float64 numpy on the host from the time
coordinate, and becomes a float32 tensor where the reference makes it a
float32 array. The solar functions take no data argument: their result
goes to ``device``, else to :func:`xclim_tpu_torch.default_device`.
``make_hourly_temperature``, ``resample_map`` and the Jones coefficient's
seasonal sums are device work on their input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import days_in_year
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, declare_units, str2pint

__all__ = [
    "distance_from_sun",
    "jones_day_length_latitude_coefficient",
    "time_correction_for_solar_angle",
    "cosine_of_solar_zenith_angle",
    "day_angle",
    "day_lengths",
    "eccentricity_correction_factor",
    "extraterrestrial_solar_radiation",
    "make_hourly_temperature",
    "resample_map",
    "solar_declination",
    "wind_speed_height_conversion",
]


def _day_angle(time) -> np.ndarray:
    """Fractional year angle in radians (0..2π) per step."""
    frac = (time.doy - 1).astype(np.float64) / days_in_year(time.year, time.calendar)
    return 2 * np.pi * frac


def day_angle(time) -> np.ndarray:
    return _day_angle(time)


def solar_declination(time, method: str = "spencer") -> np.ndarray:
    """Solar declination [rad] (xclim:indices/helpers.py:119).

    'spencer': Spencer (1971) Fourier series; 'simple': sinusoidal.
    """
    da = _day_angle(time)
    if method == "simple":
        return np.deg2rad(23.44) * np.cos(2 * np.pi / 365.25 * (time.doy - 172))
    return (0.006918 - 0.399912 * np.cos(da) + 0.070257 * np.sin(da)
            - 0.006758 * np.cos(2 * da) + 0.000907 * np.sin(2 * da)
            - 0.002697 * np.cos(3 * da) + 0.00148 * np.sin(3 * da))


def eccentricity_correction_factor(time, method: str = "spencer") -> np.ndarray:
    """Squared ratio of mean to actual sun-earth distance
    (xclim:indices/helpers.py)."""
    da = _day_angle(time)
    if method == "simple":
        return 1 + 0.033 * np.cos(da)
    return (1.00011 + 0.034221 * np.cos(da) + 0.00128 * np.sin(da)
            + 0.000719 * np.cos(2 * da) + 0.000077 * np.sin(2 * da))


def _lat_flat(lat):
    """Normalize a latitude input (scalar / 1-D / N-D array / ClimArray) to
    (flat_values, space_dims, space_coords, space_shape, was_scalar)."""
    if isinstance(lat, ClimArray):
        v = np.asarray(lat.values, dtype=np.float64)
        return v.reshape(-1), lat.dims, dict(lat.coords), v.shape, False
    v = np.asarray(getattr(lat, "values", lat), dtype=np.float64)
    if v.ndim <= 1:
        v1 = np.atleast_1d(v)
        return v1, ("lat",), {"lat": v1}, v1.shape, v.ndim == 0
    dims = ("lat", "lon") if v.ndim == 2 else \
        tuple(f"dim_{i}" for i in range(v.ndim))
    return v.reshape(-1), dims, {}, v.shape, False


def _wrap_solar(data_tl, time, lat, units, name, device=None):
    """(T, L) host result → float32 ClimArray ('time', *lat_dims) on
    ``device``; a scalar lat is squeezed."""
    _, dims, coords, shape, scalar = _lat_flat(lat)
    out_data = data_tl.reshape((data_tl.shape[0],) + shape)
    cc = {"time": time, **coords}
    arr = ClimArray(out_data.astype(np.float32), ("time",) + dims, cc,
                    {"units": units}, name, device=device)
    if scalar:
        arr = arr.isel(**{dims[0]: 0})
    return arr


def cosine_of_solar_zenith_angle(time, lat, lon=None, stat: str = "average",
                                 sunlit: bool = False,
                                 device=None) -> ClimArray:
    """Statistic of cos(zenith) (xclim:indices/helpers.py:241).

    stat='average': daily average (sunlit=True restricts to daylight hours),
    via the analytic integral of cos Z over the hour angle. stat='instant':
    instantaneous value at the timestamp, with the equation-of-time
    correction and the longitude offset of the local hour angle.
    """
    latv = _lat_flat(lat)[0]
    phi = np.deg2rad(latv)
    decl = solar_declination(time)
    d = decl[:, None]
    lonv = np.deg2rad(np.asarray(getattr(lon, "values",
                                         lon if lon is not None else 0.0),
                                 dtype=np.float64)).reshape(-1)
    if stat == "instant":
        tc = (0.004297 + 0.107029 * np.cos(_day_angle(time))
              - 1.837877 * np.sin(_day_angle(time))
              - 0.837378 * np.cos(2 * _day_angle(time))
              - 2.340475 * np.sin(2 * _day_angle(time)))
        tc = np.deg2rad(tc)
        h_utc = (time.seconds_of_day / 86400.0) * 2 * np.pi + np.pi
        h = h_utc[:, None] + lonv[None, :] + tc[:, None]
        czda = (np.sin(d) * np.sin(phi)[None, :]
                + np.cos(d) * np.cos(phi)[None, :] * np.cos(h))
        return _wrap_solar(czda, time, lat, "", "csza", device)
    if stat not in ("average", "integral"):
        raise NotImplementedError(
            "stat must be one of 'average', 'integral' or 'instant'.")
    # interval bounds in local hour angle (xclim:indices/helpers.py:310-325):
    # daily (or <3 steps) data integrates the whole day centred on noon;
    # subdaily timestamps mark the START of each interval
    freq = time.infer_freq() if len(time) >= 3 else "D"
    if len(time) < 3 or (freq or "D").endswith("D"):
        h_s = np.full((len(time), 1), -np.pi)
        h_e = np.full((len(time), 1), np.pi - 1e-9)
    else:
        secs = time.seconds_of_day.astype(np.float64)
        h_s_utc = (secs / 86400.0) * 2 * np.pi + np.pi
        h_s = h_s_utc[:, None] + lonv[None, :]
        # interval length to the next timestamp (wrap across midnight,
        # backfill the last step)
        step = np.concatenate([np.diff(secs) % 86400.0, [0.0]])
        step[step == 0] = step[step != 0][0] if (step != 0).any() else 86400.0
        h_e = h_s + 2 * np.pi * step[:, None] / 86400.0
    if sunlit:
        tantan = -np.tan(phi)[None, :] * np.tan(d)
        h_ss = np.where(np.abs(tantan) <= 1, np.arccos(np.clip(tantan, -1, 1)),
                        np.nan)
    else:
        h_ss = np.full_like(d * np.ones((1, len(phi))), np.pi - 1e-9)
    czda = _sunlit_integral_cosz(d, np.deg2rad(latv)[None, :], h_ss,
                                 _wrap_rad(h_s), _wrap_rad(h_e),
                                 stat == "average")
    return _wrap_solar(czda, time, lat, "", "csza", device)


def _wrap_rad(x):
    """Wrap angles into (-π, π]."""
    return ((np.asarray(x, dtype=np.float64) + np.pi) % (2 * np.pi)) - np.pi


def _sunlit_integral_cosz(decl, lat, h_ss, h_s, h_e, average):
    """Integral (or average) of cos(zenith) over the sunlit part of the
    interval [h_s, h_e] — the branch-free form of the reference's numba
    kernel (xclim:indices/helpers.py:355-398, after PyWBGT), including the
    interval-crossing-midnight cases."""
    decl, lat, h_ss, h_s, h_e = np.broadcast_arrays(decl, lat, h_ss, h_s,
                                                    h_e)
    sin = np.sin
    polar_day = np.isnan(h_ss) & (decl * lat > 0)
    polar_night = np.isnan(h_ss) & (decl * lat < 0)
    cross = h_e < h_s
    # guard NaN comparisons by substituting the whole-day sunset
    ss = np.where(np.isnan(h_ss), np.pi, h_ss)
    sr = -ss
    dark = ((h_s > ss) & (h_e < sr)) | ((h_s < sr) & (h_e < sr)) | \
        ((h_s > ss) & (h_e > ss))
    # midnight-crossing sub-cases
    c1 = cross & (h_e >= sr) & (h_s >= ss)          # night start, sunrise end
    c2 = cross & (h_s >= sr) & (sr >= h_e)          # sunlit start, night end
    c3 = cross & (ss >= h_s) & (h_s > h_e) & (h_e >= sr)  # two sunlit parts
    h1 = np.maximum(sr, h_s)
    h2 = np.minimum(ss, h_e)
    num = np.select(
        [polar_day, c1, c2, c3],
        [sin(h_e) - sin(h_s),
         sin(h_e) - sin(sr),
         sin(ss) - sin(h_s),
         sin(ss) - sin(h_s) + sin(h_e) - sin(sr)],
        default=sin(h2) - sin(h1))
    den = np.select(
        [polar_day & cross, polar_day, c1, c2, c3],
        [h_e + 2 * np.pi - h_s,
         h_e - h_s,
         h_e - sr,
         ss - h_s,
         ss - h_s + h_e - sr],
        default=h2 - h1)
    out = sin(decl) * sin(lat) * den + np.cos(decl) * np.cos(lat) * num
    if average:
        out = np.where(den != 0, out / np.where(den == 0, 1.0, den), 0.0)
    zero = polar_night | (~polar_day & dark)
    return np.where(zero, 0.0, out)


@declare_units(solar_constant="[radiation]")
def extraterrestrial_solar_radiation(time, lat, solar_constant: str = "1361 W m-2",
                                     method: str = "spencer",
                                     chunks=None, device=None) -> ClimArray:
    """Daily mean top-of-atmosphere radiation [W m-2] (FAO-56 closed form;
    xclim:indices/helpers.py:400)."""
    gsc = convert_units_to(str2pint(solar_constant), "W m-2")
    latv = _lat_flat(lat)[0]
    phi = np.deg2rad(latv)
    decl = solar_declination(time, method)[:, None]
    dr = eccentricity_correction_factor(time, method)[:, None]
    ws = np.arccos(np.clip(-np.tan(phi)[None, :] * np.tan(decl), -1.0, 1.0))
    ra = (gsc / np.pi) * dr * (ws * np.sin(phi)[None, :] * np.sin(decl)
                               + np.cos(phi)[None, :] * np.cos(decl) * np.sin(ws))
    return _wrap_solar(ra, time, lat, "W m-2", "ra", device)


def _day_lengths_host(time, latv, method: str = "spencer") -> np.ndarray:
    """(T, L) float64 day lengths in hours."""
    phi = np.deg2rad(latv)
    decl = solar_declination(time, method)[:, None]
    ws = np.arccos(np.clip(-np.tan(phi)[None, :] * np.tan(decl), -1.0, 1.0))
    return 24 / np.pi * ws


def day_lengths(time, lat, method: str = "spencer", device=None) -> ClimArray:
    """Daylength in hours (xclim:indices/helpers.py:450)."""
    dl = _day_lengths_host(time, _lat_flat(lat)[0], method)
    return _wrap_solar(dl, time, lat, "h", "day_length", device)


@declare_units(da="[speed]")
def wind_speed_height_conversion(da: ClimArray, h_source: str, h_target: str,
                                 method: str = "log") -> ClimArray:
    """Wind speed between measurement heights by the neutral log profile
    (xclim:indices/helpers.py:809)."""
    h_s = convert_units_to(str2pint(h_source), "m")
    h_t = convert_units_to(str2pint(h_target), "m")
    factor = float(np.log(67.8 * h_t - 5.42) / np.log(67.8 * h_s - 5.42))
    out = da.copy(data=da.data * factor)
    out.attrs = dict(da.attrs)
    return out


def make_hourly_temperature(tasmin: ClimArray, tasmax: ClimArray) -> ClimArray:
    """Disaggregate daily tasmin/tasmax to hourly via a sine (day) and
    linear (night) diurnal profile (xclim:indices/helpers.py:1059)."""
    from xclim_tpu_torch.core.calendar import date_range

    tasmax = convert_units_to(tasmax, tasmin)
    tmin = tasmin.data
    tmax = tasmax.data
    T = tasmin.shape[tasmin.time_axis]
    # sunrise at 6h, sunset at 18h: the reference's fixed 12 h day; hours
    # 0-23 per day
    hours = torch.arange(24.0, device=tmin.device)
    # daytime: sine between sunrise (6) and peak (15)
    day_frac = torch.sin(torch.pi * (hours - 6) / 12.0)
    tmin_e = tmin[..., None]
    tmax_e = tmax[..., None]
    tnext_min = torch.cat([tmin[1:], tmin[-1:]], dim=0)[..., None]
    daytime = tmin_e + (tmax_e - tmin_e) * day_frac
    # nighttime: linear decay from the 18h value to next day's tmin
    # sin(pi) in float32, as the reference evaluates it
    t18 = tmin_e + (tmax_e - tmin_e) * float(np.sin(np.float32(np.pi)))
    frac_night = ((hours - 18) % 24) / 12.0
    night = t18 + (tnext_min - t18) * frac_night
    out = torch.where((hours >= 6) & (hours < 18), daytime, night)
    data = out.reshape((-1,) + tmin.shape[1:]) if tasmin.ndim == 1 else \
        torch.movedim(out, -1, 1).reshape((T * 24,) + tmin.shape[1:])
    t0 = tasmin.time
    new_time = date_range(t0.isoformat(0), periods=T * 24, freq="h",
                          calendar=t0.calendar)
    coords = dict(tasmin.coords)
    coords["time"] = new_time
    return ClimArray(data, tasmin.dims, coords, dict(tasmin.attrs), "tas")


def huglin_day_length_latitude_coefficient(lat, method: str = "huglin",
                                           cap_value: float = np.nan):
    """Huglin day-length latitude coefficient k (xclim:indices/helpers.py:528).

    'huglin': stepwise table (1.0 below 40°, +0.01 per 2° band to 1.06 at 50°);
    'interpolated': linear ramp over 40-50°. Above 50°: cap_value.
    """
    lat_abs = np.abs(np.asarray(getattr(lat, "values", lat), dtype=np.float64))
    if method == "huglin":
        k = np.where(lat_abs <= 40, 1.0, cap_value)
        for add, lo, hi in [(0.02, 40, 42), (0.03, 42, 44), (0.04, 44, 46),
                            (0.05, 46, 48), (0.06, 48, 50)]:
            k = np.where((lat_abs > lo) & (lat_abs <= hi), 1 + add, k)
    elif method == "interpolated":
        k = np.where(lat_abs <= 50, 1 + np.clip((lat_abs - 40) / 10, 0, None) * 0.06,
                     cap_value)
    else:
        raise NotImplementedError(method)
    return k


def gladstones_day_length_latitude_coefficient(time, lat,
                                               neutral_latitude: float = 40.0,
                                               device=None):
    """Gladstones k: day length relative to the 40° reference latitude
    (xclim:indices/helpers.py:623). The reference divides its float32
    day lengths; so does this."""
    latv = _lat_flat(lat)[0]
    dl = _day_lengths_host(time, latv).astype(np.float32)
    pivot_n = _day_lengths_host(
        time, np.array([abs(neutral_latitude)])).astype(np.float32)
    pivot_s = _day_lengths_host(
        time, np.array([-abs(neutral_latitude)])).astype(np.float32)
    k = np.where(latv[None, :] >= 0, dl / pivot_n, dl / pivot_s)
    return _wrap_solar(k, time, lat, "", "k", device)


def distance_from_sun(time, device=None) -> ClimArray:
    """Sun-Earth distance in astronomical units
    (xclim:indices/helpers.py:65; U.S. Naval Observatory almanac)."""
    from xclim_tpu_torch.core.calendar import date_to_ordinal

    days_since = (time.ordinal - date_to_ordinal(2000, 1, 1, time.calendar)
                  + (time.seconds_of_day - 43200.0) / 86400.0)
    g = ((357.528 + 0.9856003 * days_since) % 360) * np.pi / 180
    d = 1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2.0 * g)
    return ClimArray(d.astype(np.float32), ("time",), {"time": time},
                     {"units": "au"}, "sun_earth_distance", device=device)


def time_correction_for_solar_angle(time, device=None) -> ClimArray:
    """Equation-of-time correction of the solar hour angle, in radians
    (xclim:indices/helpers.py:166)."""
    da = _day_angle(time)
    tc_deg = (0.004297 + 0.107029 * np.cos(da) - 1.837877 * np.sin(da)
              - 0.837378 * np.cos(2 * da) - 2.340475 * np.sin(2 * da))
    tc = np.deg2rad(tc_deg)
    tc = (tc + np.pi) % (2 * np.pi) - np.pi
    return ClimArray(tc.astype(np.float32), ("time",), {"time": time},
                     {"units": "rad"}, "time_correction", device=device)


def jones_day_length_latitude_coefficient(time, lat,
                                          method: str = "jones",
                                          floor: bool = False,
                                          start_date: str = "04-01",
                                          end_date: str = "11-01",
                                          freq: str = "YS", device=None):
    """Seasonal day-length latitude coefficient of Hall & Jones (2010)
    (xclim:indices/helpers.py:688).

    k_jones = 2.8311e-4 · Σ(day lengths over the season) + 0.30834;
    'gladstones' applies the affine transformation 1.1135·k − 0.1352.
    """
    from xclim_tpu_torch.core.calendar import (
        parse_offset,
        resample_segments,
        select_time_mask,
    )
    from xclim_tpu_torch.ops.segments import segment_reduce

    if parse_offset(freq) not in [(1, "Y", True, "JAN"), (1, "Y", True, "JUL")]:
        raise NotImplementedError(
            f"Freq {freq!r} not supported: must be annual (YS/YS-JAN/YS-JUL).")
    dl = day_lengths(time, lat, device=device)
    mask = select_time_mask(time, date_bounds=(start_date, end_date),
                            include_bounds=(True, False))
    # exclude the end date itself like the reference's include_bounds=(T, F)
    shape = [1] * dl.ndim
    shape[0] = len(time)
    m = torch.as_tensor(mask, device=dl.data.device).reshape(shape)
    dlm = torch.where(m, dl.data, 0.0)
    spec = resample_segments(time, freq)
    total = segment_reduce(dlm, spec, "sum", axis=0)  # (nyears, *lat)
    k = 2.8311e-4 * total + 0.30834
    if method == "gladstones":
        k = 1.1135 * k - 0.1352
    elif method != "jones":
        raise NotImplementedError(method)
    if floor:
        k = torch.clamp(k, min=1.0)
    out_dims = ("time",) + dl.dims[1:]
    coords = {k2: v for k2, v in dl.coords.items() if k2 != "time"}
    coords["time"] = spec.labels
    return ClimArray(k, out_dims, coords, {"units": ""}, "k")


def resample_map(obj, dim: str, freq: str, func, map_kwargs: dict | None = None):
    """Apply `func` to each resampling period and re-concatenate
    (xclim:indices/helpers.py:898).

    Periods are static segments, so this is a host loop over period slices
    for arbitrary per-period callables. The standard reductions take the
    segment engine through ``resample(freq).op`` instead.
    """
    from xclim_tpu_torch.core.calendar import resample_segments
    from xclim_tpu_torch.core.dataarray import concat

    if dim != "time":
        raise NotImplementedError("resample_map only supports dim='time'.")
    map_kwargs = map_kwargs or {}
    spec = resample_segments(obj.time, freq)
    outs = []
    for k in range(spec.nseg):
        s = int(spec.starts[k])
        e = s + int(spec.counts[k])
        sub = obj.isel(time=slice(s, e))
        outs.append(func(sub, **map_kwargs))
    first = outs[0]
    if getattr(first, "time", None) is None:
        # per-period scalars → new time axis of period labels
        data = torch.stack([o.data for o in outs], dim=0)
        coords = {k2: v for k2, v in first.coords.items()}
        coords["time"] = spec.labels
        return ClimArray(data, ("time",) + first.dims, coords,
                         dict(first.attrs), first.name)
    return concat(outs, dim="time")
