"""Physical conversion indices (reference: xclim:src/xclim/indices/converters.py).

Elementwise physics as plain torch ops on the input's device, in float32
in the reference's order of operations. Published formula constants
(Magnus-form saturation vapor pressure coefficients, the UTCI polynomial,
Dai (2008) precipitation-phase curves) are kept as host data tables.
Thornthwaite's and Droogers-Allen's monthly means go through the segment
engine (the ``segred`` kernel on a CUDA tensor).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import (
    amount2rate,
    convert_units_to,
    declare_units,
    flux2rate,
    rate2flux,
    str2pint,
    units2pint,
)

__all__ = [
    "fao_allen98",
    "tas",
    "clausius_clapeyron_scaled_precipitation",
    "clearness_index",
    "dewpoint_from_specific_humidity",
    "heat_index",
    "humidex",
    "longwave_upwelling_radiation_from_net_downwelling",
    "mean_radiant_temperature",
    "potential_evapotranspiration",
    "prsn_to_prsnd",
    "prsnd_to_prsn",
    "rain_approximation",
    "relative_humidity",
    "saturation_vapor_pressure",
    "sfcwind_to_uas_vas",
    "shortwave_downwelling_radiation_from_clearness_index",
    "shortwave_upwelling_radiation_from_net_downwelling",
    "snd_to_snw",
    "snowfall_approximation",
    "snw_to_snd",
    "specific_humidity",
    "specific_humidity_from_dewpoint",
    "tas_from_tasmin_tasmax",
    "uas_vas_to_sfcwind",
    "universal_thermal_climate_index",
    "vapor_pressure",
    "vapor_pressure_deficit",
    "water_budget",
    "wind_chill_index",
    "wind_power_potential",
    "wind_profile",
]

# Magnus-form saturation vapor pressure coefficients e_sat = A·exp(B(T-T0)/(T+C))
# (published constants; xclim:converters.py:390-395)
ESAT_COEFFS = {
    "tetens30": {"water": (610.78, 17.269388, -35.86), "ice": (610.78, 21.8745584, -7.66)},
    "wmo08": {"water": (611.2, 17.62, -30.04), "ice": (611.2, 22.46, -0.54)},
    "buck81": {"water": (611.21, 17.502, -32.19), "ice": (611.15, 22.542, 0.32)},
    "aerk96": {"water": (610.94, 17.625, -30.12), "ice": (611.21, 22.587, 0.7)},
}

T0 = 273.16


@declare_units(tas="[temperature]", tdps="[temperature]", hurs="[]")
def humidex(tas: ClimArray, tdps: ClimArray | None = None,
            hurs: ClimArray | None = None) -> ClimArray:
    """Humidex heat-discomfort index (xclim:converters.py:76)."""
    if tdps is None and hurs is None:
        raise ValueError("At least one of `tdps` or `hurs` must be given.")
    if tdps is not None:
        tdps_K = convert_units_to(tdps, "K")
        e = 6.112 * torch.exp(5417.7530 * (1 / 273.16 - 1.0 / tdps_K.data))
    else:
        tas_C = convert_units_to(tas, "degC")
        hurs_pct = convert_units_to(hurs, "%")
        e = hurs_pct.data / 100 * 6.112 * 10 ** (7.5 * tas_C.data / (tas_C.data + 237.7))
    h = 5 / 9 * (e - 10)  # delta degC
    u = units2pint(tas)
    scale = 1.0 / u.scale  # delta degC → delta in tas units (K/degC scale 1)
    out = tas.copy(data=tas.data + h * scale)
    out.attrs["units"] = tas.attrs.get("units", "")
    return out


@declare_units(tas="[temperature]", hurs="[]")
def heat_index(tas: ClimArray, hurs: ClimArray) -> ClimArray:
    """NOAA heat index (Rothfusz regression; xclim:converters.py:176).

    Only defined above 20°C — cooler days yield NaN."""
    t = convert_units_to(tas, "degC")
    td = torch.where(t.data > 20.0, t.data, torch.nan)
    r = convert_units_to(hurs, "%").data
    out = (-8.78469475556 + 1.61139411 * td + 2.33854883889 * r
           - 0.14611605 * td * r - 0.012308094 * td * td
           - 0.0164248277778 * r * r + 0.002211732 * td * td * r
           + 0.00072546 * td * r * r - 0.000003582 * td * td * r * r)
    res = t.copy(data=out)
    res.attrs["units"] = "degC"
    return convert_units_to(res, tas.attrs.get("units", "degC"))


@declare_units(tasmin="[temperature]", tasmax="[temperature]")
def tas_from_tasmin_tasmax(tasmin: ClimArray, tasmax: ClimArray) -> ClimArray:
    """Daily mean from min/max average (xclim:converters.py:243)."""
    tasmax = convert_units_to(tasmax, tasmin)
    out = (tasmax + tasmin) / 2
    out.attrs = dict(tasmin.attrs)
    out.attrs["cell_methods"] = "time: mean within days"
    out.name = "tas"
    return out


@declare_units(uas="[speed]", vas="[speed]", calm_wind_thresh="[speed]")
def uas_vas_to_sfcwind(uas: ClimArray, vas: ClimArray,
                       calm_wind_thresh: str = "0.5 m/s"):
    """Wind components → speed & direction (xclim:converters.py:273)."""
    uas = convert_units_to(uas, "m/s")
    vas = convert_units_to(vas, "m/s")
    thresh = convert_units_to(str2pint(calm_wind_thresh), "m/s")
    wind = uas.copy(data=torch.hypot(uas.data, vas.data))
    wind.attrs = {"units": "m s-1"}
    wind.name = "sfcWind"
    wfd_math = torch.rad2deg(torch.atan2(vas.data, uas.data))
    wfd = (270 - wfd_math) % 360.0
    wfd = torch.where(torch.round(wfd) == 0, 360.0, wfd)
    wfd = torch.where(wind.data < thresh, 0.0, wfd)
    wfda = uas.copy(data=wfd)
    wfda.attrs = {"units": "degree"}
    wfda.name = "sfcWindfromdir"
    SFCWIND = namedtuple("SFCWIND", ["wind", "wind_from_dir"])
    return SFCWIND(wind, wfda)


@declare_units(sfcWind="[speed]", sfcWindfromdir="[]")
def sfcwind_to_uas_vas(sfcWind: ClimArray, sfcWindfromdir: ClimArray):
    """Wind speed & direction → components (xclim:converters.py:337)."""
    sfcWind = convert_units_to(sfcWind, "m/s")
    math_dir = (-sfcWindfromdir.data + 270) % 360.0
    uas = sfcWind.copy(data=sfcWind.data * torch.cos(torch.deg2rad(math_dir)))
    vas = sfcWind.copy(data=sfcWind.data * torch.sin(torch.deg2rad(math_dir)))
    uas.attrs = {"units": "m s-1"}
    vas.attrs = {"units": "m s-1"}
    uas.name, vas.name = "uas", "vas"
    UASVAS = namedtuple("UAS_VAS", ["uas", "vas"])
    return UASVAS(uas, vas)


def _esat_water(tasK, method):
    if method == "ecmwf":
        method = "buck81"
    if method == "sonntag90":
        return 100 * torch.exp(-6096.9385 / tasK + 16.635794 - 2.711193e-2 * tasK
                             + 1.673952e-5 * tasK ** 2 + 2.433502 * torch.log(tasK))
    if method == "goffgratch46":
        Tb, eb = 373.16, 101325.0
        return eb * 10 ** (-7.90298 * (Tb / tasK - 1) + 5.02808 * torch.log10(Tb / tasK)
                           - 1.3817e-7 * (10 ** (11.344 * (1 - tasK / Tb)) - 1)
                           + 8.1328e-3 * (10 ** (-3.49149 * (Tb / tasK - 1)) - 1))
    if method == "its90":
        return torch.exp(-2836.5744 / tasK ** 2 - 6028.076559 / tasK + 19.54263612
                       - 2.737830188e-2 * tasK + 1.6261698e-5 * tasK ** 2
                       + 7.0229056e-10 * tasK ** 3 - 1.8680009e-13 * tasK ** 4
                       + 2.7150305 * torch.log(tasK))
    A, B, C = ESAT_COEFFS[method]["water"]
    return A * torch.exp(B * (tasK - T0) / (tasK + C))


def _esat_ice(tasK, method):
    if method == "ecmwf":
        method = "aerk96"
    if method == "sonntag90":
        return 100 * torch.exp(-6024.5282 / tasK + 24.7219 + 1.0613868e-2 * tasK
                             - 1.3198825e-5 * tasK ** 2 - 0.49382577 * torch.log(tasK))
    if method == "goffgratch46":
        Tp, ep = 273.16, 611.73
        return ep * 10 ** (-9.09718 * (Tp / tasK - 1) - 3.56654 * torch.log10(Tp / tasK)
                           + 0.876793 * (1 - tasK / Tp))
    if method == "its90":
        return torch.exp(-5866.6426 / tasK + 22.32870244 + 1.39387003e-2 * tasK
                       - 3.4262402e-5 * tasK ** 2 + 2.7040955e-8 * tasK ** 3
                       + 6.7063522e-1 * torch.log(tasK))
    A, B, C = ESAT_COEFFS[method]["ice"]
    return A * torch.exp(B * (tasK - T0) / (tasK + C))


@declare_units(tas="[temperature]", ice_thresh="[temperature]",
               water_thresh="[temperature]")
def saturation_vapor_pressure(tas: ClimArray, ice_thresh: str | None = None,
                              method: str = "sonntag90",
                              interp_power: float | None = None,
                              water_thresh: str = "0 degC") -> ClimArray:
    """Saturation vapor pressure [Pa] by 7+ published formulas
    (xclim:converters.py:492)."""
    method = {"TE30": "tetens30", "GG46": "goffgratch46", "SO90": "sonntag90"}.get(
        method, method).casefold()
    tasK = convert_units_to(tas, "K").data
    if ice_thresh is None and interp_power is None:
        e_sat = _esat_water(tasK, method)
    elif interp_power is None:
        thresh = convert_units_to(str2pint(ice_thresh), "K")
        e_sat = torch.where(tasK > thresh, _esat_water(tasK, method),
                          _esat_ice(tasK, method))
    else:
        T_w = convert_units_to(str2pint(water_thresh), "K")
        T_i = convert_units_to(str2pint(ice_thresh), "K")
        ew = _esat_water(tasK, method)
        ei = _esat_ice(tasK, method)
        alpha = ((tasK - T_i) / (T_w - T_i)) ** interp_power
        e_sat = torch.where(tasK < T_i, ei,
                          torch.where(tasK > T_w, ew, alpha * ew + (1 - alpha) * ei))
    out = tas.copy(data=e_sat)
    out.attrs = {"units": "Pa"}
    out.name = "e_sat"
    return out


@declare_units(huss="[]", ps="[pressure]")
def vapor_pressure(huss: ClimArray, ps: ClimArray) -> ClimArray:
    """Vapor pressure from specific humidity & pressure (xclim:converters.py:607)."""
    eps = 0.62198
    e = ps.data * huss.data / (eps + (1 - eps) * huss.data)
    out = ps.copy(data=e)
    out.attrs = {"units": ps.attrs.get("units", "Pa")}
    return out


@declare_units(tas="[temperature]", hurs="[]")
def vapor_pressure_deficit(tas: ClimArray, hurs: ClimArray,
                           ice_thresh=None, method="sonntag90",
                           interp_power=None, water_thresh="0 degC") -> ClimArray:
    """VPD = (1 - RH)·e_sat (xclim:converters.py:642)."""
    svp = saturation_vapor_pressure(tas, ice_thresh=ice_thresh, method=method,
                                    interp_power=interp_power,
                                    water_thresh=water_thresh)
    h = convert_units_to(hurs, "%").data
    out = svp.copy(data=(1 - h / 100) * svp.data)
    out.name = "vpd"
    return out


@declare_units(tas="[temperature]", tdps="[temperature]", huss="[]", ps="[pressure]")
def relative_humidity(tas: ClimArray, tdps: ClimArray | None = None,
                      huss: ClimArray | None = None, ps: ClimArray | None = None,
                      ice_thresh=None, method: str = "sonntag90",
                      interp_power=None, water_thresh="0 degC",
                      invalid_values: str = "clip") -> ClimArray:
    """Relative humidity from dewpoint or specific humidity
    (xclim:converters.py:702)."""
    if method in ("bohren98", "BA90"):
        if tdps is None:
            raise ValueError("Method bohren98 requires dewpoint.")
        td = convert_units_to(tdps, "K").data
        t = convert_units_to(tas, "K").data
        L, Rw = 2.501e6, 461.5
        hurs = 100 * torch.exp(-L * (t - td) / (Rw * t * td))
    elif tdps is not None:
        e_dt = saturation_vapor_pressure(tdps, ice_thresh, method, interp_power,
                                         water_thresh).data
        e_t = saturation_vapor_pressure(tas, ice_thresh, method, interp_power,
                                        water_thresh).data
        hurs = 100 * e_dt / e_t
    elif huss is not None and ps is not None:
        psx = convert_units_to(ps, "Pa")
        h = convert_units_to(huss, "")
        pw = vapor_pressure(h, psx).data
        pws = saturation_vapor_pressure(tas, ice_thresh, method, interp_power,
                                        water_thresh).data
        hurs = 100 * pw / pws
    else:
        raise ValueError("`huss` and `ps` must be provided if `tdps` is not given.")
    if invalid_values == "clip":
        hurs = torch.clamp(hurs, 0, 100)
    elif invalid_values == "mask":
        hurs = torch.where((hurs <= 100) & (hurs >= 0), hurs, torch.nan)
    out = tas.copy(data=hurs)
    out.attrs = {"units": "%"}
    out.name = "hurs"
    return out


@declare_units(tas="[temperature]", hurs="[]", ps="[pressure]")
def specific_humidity(tas: ClimArray, hurs: ClimArray, ps: ClimArray,
                      ice_thresh=None, method: str = "sonntag90",
                      interp_power=None, water_thresh="0 degC",
                      invalid_values: str | None = None) -> ClimArray:
    """Specific humidity from RH, temperature and pressure
    (xclim:converters.py:847)."""
    psx = convert_units_to(ps, "Pa").data
    h = convert_units_to(hurs, "").data
    e_sat = saturation_vapor_pressure(tas, ice_thresh, method, interp_power,
                                      water_thresh).data
    w_sat = 0.62198 * e_sat / (psx - e_sat)
    w = w_sat * h
    q = w / (1 + w)
    if invalid_values is not None:
        q_sat = w_sat / (1 + w_sat)
        if invalid_values == "clip":
            q = torch.minimum(torch.clamp(q, min=0), q_sat)
        elif invalid_values == "mask":
            q = torch.where((q <= q_sat) & (q >= 0), q, torch.nan)
    out = tas.copy(data=q)
    out.attrs = {"units": "1"}
    out.name = "huss"
    return out


@declare_units(tdps="[temperature]", ps="[pressure]")
def specific_humidity_from_dewpoint(tdps: ClimArray, ps: ClimArray,
                                    ice_thresh=None, method: str = "wmo08",
                                    interp_power=None,
                                    water_thresh="0 degC") -> ClimArray:
    """Specific humidity from dewpoint & pressure (xclim:converters.py:952)."""
    eps = 0.62198
    e = saturation_vapor_pressure(tdps, ice_thresh, method, interp_power,
                                  water_thresh).data
    psx = convert_units_to(ps, "Pa").data
    q = eps * e / (psx - e * (1 - eps))
    out = tdps.copy(data=q)
    out.attrs = {"units": "1"}
    out.name = "huss"
    return out


@declare_units(huss="[]", ps="[pressure]")
def dewpoint_from_specific_humidity(huss: ClimArray, ps: ClimArray,
                                    method: str = "wmo08",
                                    variant: str = "water") -> ClimArray:
    """Dewpoint by inverting the Magnus formula (xclim:converters.py:1025)."""
    h = huss.copy(data=torch.where(huss.data > 0, huss.data, torch.nan))
    e = vapor_pressure(h, ps).data
    A, B, C = ESAT_COEFFS[method.casefold()][variant]
    f = torch.log(e / A) / B
    tdps = (-T0 - C * f) / (f - 1)
    out = huss.copy(data=tdps)
    out.attrs = {"units": "K", "units_metadata": "temperature: on_scale"}
    out.name = "tdps"
    return out


# -- precipitation phase ----------------------------------------------------

_DAI_COEFS = {
    # (a, b, c, d) of f = a·(tanh(b(t - c)) - d)/100 (Dai 2008)
    ("snow", "dai_annual", True): (-48.2292, 0.7205, 1.1662, 1.0223),
    ("snow", "dai_annual", False): (-47.1472, 0.4049, 1.9280, 1.0203),
    ("rain", "dai_annual", True): (-47.8337, -0.6866, 1.4913, 1.0420),
    ("rain", "dai_annual", False): (-47.3041, -0.4263, 2.5687, 1.0784),
}

#: per-season (a, b, c, d) rows x [DJF, MAM, JJA, SON] columns (Dai 2008;
#: xclim:converters.py:1206-1236 snow, :1330-1352 rain)
_DAI_SEASONAL = {
    ("snow", True): np.array([
        [-48.2372, -48.2493, -46.4000, -48.3251],
        [0.7449, 0.6634, 0.7013, 0.7798],
        [1.0919, 1.3388, 0.8362, 1.1502],
        [1.0209, 1.0270, 1.0217, 1.0180]]),
    ("snow", False): np.array([
        [-47.1823, -47.0035, -47.1472, -46.8494],
        [0.4003, 0.4090, 0.4049, 0.4162],
        [2.1735, 1.7372, 1.9280, 2.0474],
        [1.0255, 1.0226, 1.0203, 1.0155]]),
    ("rain", True): np.array([
        [-47.5770, -47.9077, -46.8303, -48.0315],
        [-0.6856, -0.6603, -0.6595, -0.7663],
        [1.3942, 1.6927, 1.1582, 1.4640],
        [1.0438, 1.0358, 1.1056, 1.0412]]),
    ("rain", False): np.array([
        [-47.0262, -47.2828, -47.3041, -47.2107],
        [-0.4360, -0.4299, -0.4263, -0.4280],
        [2.8572, 2.3397, 2.5687, 2.7118],
        [1.0731, 1.0800, 1.0784, 1.0911]]),
}


def _season_index(time) -> np.ndarray:
    """Per-timestep meteorological season index: DJF=0 MAM=1 JJA=2 SON=3."""
    m = np.asarray(time.month)
    return np.where((m == 12) | (m <= 2), 0,
                    np.where(m <= 5, 1, np.where(m <= 8, 2, 3))).astype(np.int32)


def _dai_fraction(kind: str, tas_da: ClimArray, method: str, clip_temp,
                  landmask) -> torch.Tensor:
    """Snow/rain phase fraction by the Dai (2008) tanh fits
    (xclim:converters.py:1199-1245 snow / :1321-1372 rain).

    ``landmask`` may be a bool (one coefficient set everywhere) or a
    ClimArray land mask without a time dim (land/ocean sets blended per
    point, the reference's xr.where recursion)."""
    if not isinstance(landmask, bool):
        fl = _dai_fraction(kind, tas_da, method, clip_temp, True)
        fo = _dai_fraction(kind, tas_da, method, clip_temp, False)
        md = landmask.data if isinstance(landmask, ClimArray) else \
            torch.as_tensor(np.asarray(landmask), device=fl.device)
        # the mask has no time dim: align its dims to the tail of the data
        md = md.reshape((1,) * (fl.ndim - md.ndim) + md.shape)
        return torch.where(md.to(torch.bool), fl, fo)
    tdeg = convert_units_to(tas_da, "degC").data
    if method == "dai_annual":
        a, b, c, d = _DAI_COEFS[(kind, "dai_annual", landmask)]
    elif method == "dai_seasonal":
        tab = _DAI_SEASONAL[(kind, landmask)]  # (4 coeffs, 4 seasons)
        sidx = _season_index(tas_da.time)
        bshape = [1] * tas_da.ndim
        bshape[tas_da.time_axis] = len(sidx)
        a, b, c, d = (torch.as_tensor(tab[i][sidx].astype(np.float32),
                                      device=tdeg.device).reshape(bshape)
                      for i in range(4))
    else:
        raise ValueError(f"Unknown method {method} for {kind} approximation.")

    def frac_fn(tt):
        x = b * (tt - c)
        if not isinstance(x, torch.Tensor):
            # a clip temperature with the annual fit: tanh in float32
            x = torch.tensor(x, dtype=torch.float32, device=tdeg.device)
        return a * (torch.tanh(x) - d) / 100

    frac = frac_fn(tdeg)
    if clip_temp is not None:
        clip = convert_units_to(str2pint(clip_temp), "degC")
        # rescale so the fraction saturates at ±clip (xclim team addition);
        # the hot/cold ends swap between the snow and rain fits
        lo, hi = (clip, -clip) if kind == "snow" else (-clip, clip)
        fmin = frac_fn(lo)
        fmax = frac_fn(hi)
        frac = (frac - fmin) / (fmax - fmin)
    return torch.clamp(frac, 0, 1)


@declare_units(pr="[precipitation]", tas="[temperature]", thresh="[temperature]")
def snowfall_approximation(pr: ClimArray, tas: ClimArray, thresh: str = "0 degC",
                           method: str = "binary", clip_temp=None,
                           landmask=True) -> ClimArray:
    """Approximate snowfall flux from total precipitation and temperature
    (xclim:converters.py:1088).

    Methods: binary / brown / auer / dai_annual / dai_seasonal. For the
    ``dai_*`` methods ``landmask`` may be a ClimArray land mask (land/ocean
    coefficient sets blended per point); unlike the reference's recursion
    (xclim:converters.py:1242-1246, which drops ``clip_temp``), the blend
    here keeps the clip rescaling in both branches."""
    if method == "binary":
        thresh_v = convert_units_to(str2pint(thresh), tas)
        prsn = pr.where(tas <= thresh_v, 0.0)
    elif method == "brown":
        # linear transition over [thresh, thresh+2°C] (Brown et al. 2003)
        t0 = convert_units_to(str2pint(thresh), "degC")
        tdeg = convert_units_to(tas, "degC").data
        frac = torch.clamp(1.0 - (tdeg - t0) / 2.0, 0.0, 1.0)
        prsn = pr.copy(data=pr.data * frac)
    elif method == "auer":
        # Auer (1974) empirical SNOW-percent polynomial over [0, 6] degC above
        # the threshold (100% at the threshold, ~0% at +6; CLASS coefficients,
        # xclim:converters.py:1160-1180)
        dt = convert_units_to(tas, "K").data - convert_units_to(str2pint(thresh), "K")
        coeffs = np.array([100, 4.6664, -15.038, -1.5089, 2.0399, -0.366,
                           0.0202], dtype=np.float32)
        # Horner's rule from the highest power, as jnp.polyval evaluates it
        snow_pct = torch.zeros_like(dt)
        for c in coeffs[::-1]:
            snow_pct = snow_pct * dt + float(c)
        snow_frac = torch.clamp(snow_pct, 0.0, 100.0) / 100.0
        snow_frac = torch.where(dt < 0, 1.0, torch.where(dt >= 6, 0.0, snow_frac))
        prsn = pr.copy(data=pr.data * snow_frac)
    elif method in ("dai_annual", "dai_seasonal"):
        frac = _dai_fraction("snow", tas, method, clip_temp, landmask)
        prsn = pr.copy(data=pr.data * frac)
    else:
        raise ValueError(f"Method {method!r} not supported.")
    prsn.attrs = dict(pr.attrs)
    prsn.attrs["standard_name"] = "snowfall_flux"
    prsn.name = "prsn"
    return prsn


@declare_units(pr="[precipitation]", tas="[temperature]", thresh="[temperature]")
def rain_approximation(pr: ClimArray, tas: ClimArray, thresh: str = "0 degC",
                       method: str = "binary", clip_temp=None,
                       landmask=True) -> ClimArray:
    """Liquid precipitation = pr − snowfall approximation (binary/brown/auer)
    or the direct Dai (2008) rain-fraction fits (dai_annual/dai_seasonal;
    xclim:converters.py:1255)."""
    if method in ("dai_annual", "dai_seasonal"):
        frac = _dai_fraction("rain", tas, method, clip_temp, landmask)
        prlp = pr.copy(data=pr.data * frac)
    else:
        prsn = snowfall_approximation(pr, tas, thresh=thresh, method=method)
        prlp = pr.copy(data=pr.data - prsn.data)
    prlp.attrs = dict(pr.attrs)
    prlp.attrs["standard_name"] = "rainfall_flux"
    prlp.name = "prlp"
    return prlp


# -- snow conversions -------------------------------------------------------


@declare_units(snd="[length]", snr="[mass]/[volume]", const="[mass]/[volume]")
def snd_to_snw(snd: ClimArray, snr=None, const: str = "312 kg m-3",
               out_units: str | None = None) -> ClimArray:
    """Snow depth → amount via density (xclim:converters.py:1377)."""
    density = snr if snr is not None else str2pint(const)
    out = rate2flux(snd, density=density, out_units=out_units)
    out.attrs["standard_name"] = "surface_snow_amount"
    out.name = "snw"
    return out


@declare_units(snw="[mass]/[area]", snr="[mass]/[volume]", const="[mass]/[volume]")
def snw_to_snd(snw: ClimArray, snr=None, const: str = "312 kg m-3",
               out_units: str | None = None) -> ClimArray:
    """Snow amount → depth via density (xclim:converters.py:1420)."""
    density = snr if snr is not None else str2pint(const)
    out = flux2rate(snw, density=density, out_units=out_units)
    out.attrs["standard_name"] = "surface_snow_thickness"
    out.name = "snd"
    return out


@declare_units(prsn="[precipitation]", snr="[mass]/[volume]", const="[mass]/[volume]")
def prsn_to_prsnd(prsn: ClimArray, snr=None, const: str = "100 kg m-3",
                  out_units: str | None = None) -> ClimArray:
    """Snowfall flux → snowfall rate (xclim:converters.py:1461)."""
    density = snr if snr is not None else str2pint(const)
    out = flux2rate(prsn, density=density, out_units=out_units)
    out.name = "prsnd"
    return out


@declare_units(prsnd="[speed]", snr="[mass]/[volume]", const="[mass]/[volume]")
def prsnd_to_prsn(prsnd: ClimArray, snr=None, const: str = "100 kg m-3",
                  out_units: str | None = None) -> ClimArray:
    """Snowfall rate → snowfall flux (xclim:converters.py:1502)."""
    density = snr if snr is not None else str2pint(const)
    out = rate2flux(prsnd, density=density, out_units=out_units)
    out.attrs["standard_name"] = "snowfall_flux"
    out.name = "prsn"
    return out


# -- radiation --------------------------------------------------------------


@declare_units(rls="[radiation]", rlds="[radiation]")
def longwave_upwelling_radiation_from_net_downwelling(rls: ClimArray,
                                                      rlds: ClimArray) -> ClimArray:
    """rlus = rlds − rls (xclim:converters.py:1543)."""
    rls = convert_units_to(rls, rlds)
    out = rlds - rls
    out.attrs["units"] = rlds.attrs.get("units", "")
    out.name = "rlus"
    return out


@declare_units(rss="[radiation]", rsds="[radiation]")
def shortwave_upwelling_radiation_from_net_downwelling(rss: ClimArray,
                                                       rsds: ClimArray) -> ClimArray:
    """rsus = rsds − rss (xclim:converters.py:1566)."""
    rss = convert_units_to(rss, rsds)
    out = rsds - rss
    out.attrs["units"] = rsds.attrs.get("units", "")
    out.name = "rsus"
    return out


@declare_units(rsds="[radiation]")
def clearness_index(rsds: ClimArray) -> ClimArray:
    """rsds / extraterrestrial radiation (xclim:converters.py:1589)."""
    from xclim_tpu_torch.indices.helpers import extraterrestrial_solar_radiation

    lat = rsds.coords.get("lat", 45.0)
    rtop = extraterrestrial_solar_radiation(rsds.time, lat,
                                            device=rsds.data.device)
    rtop = convert_units_to(rtop, rsds)
    rt = rtop.data
    if rsds.ndim > rtop.ndim:
        rt = rt.reshape(rt.shape + (1,) * (rsds.ndim - rtop.ndim))
    ci = torch.where(rsds.data != 0, rsds.data / rt, 0.0)
    out = rsds.copy(data=ci)
    out.attrs = {"units": ""}
    out.name = "ci"
    return out


@declare_units(ci="[]")
def shortwave_downwelling_radiation_from_clearness_index(ci: ClimArray) -> ClimArray:
    """rsds = clearness index × extraterrestrial radiation
    (xclim:converters.py:1627)."""
    from xclim_tpu_torch.indices.helpers import extraterrestrial_solar_radiation

    lat = ci.coords.get("lat", 45.0)
    rtop = extraterrestrial_solar_radiation(ci.time, lat,
                                            device=ci.data.device)
    rt = rtop.data
    if ci.ndim > rtop.ndim:
        rt = rt.reshape(rt.shape + (1,) * (ci.ndim - rtop.ndim))
    out = ci.copy(data=ci.data * rt)
    out.attrs = {"units": rtop.attrs["units"]}
    out.name = "rsds"
    return out


# -- comfort & misc ---------------------------------------------------------


@declare_units(tas="[temperature]", sfcWind="[speed]")
def wind_chill_index(tas: ClimArray, sfcWind: ClimArray, method: str = "CAN",
                     mask_invalid: bool = True) -> ClimArray:
    """Wind chill (Environment Canada / US NWS; xclim:converters.py:1663)."""
    t = convert_units_to(tas, "degC").data
    v = convert_units_to(sfcWind, "km/h").data
    V = v ** 0.16
    W = 13.12 + 0.6215 * t - 11.37 * V + 0.3965 * t * V
    if method.upper() == "CAN":
        W = torch.where(v < 5, t + v * (-1.59 + 0.1345 * t) / 5, W)
    elif method.upper() != "US":
        raise ValueError(f"method must be CAN or US, got {method}")
    if mask_invalid:
        if method.upper() == "CAN":
            W = torch.where(t <= 0, W, torch.nan)
        else:
            W = torch.where((v > 4.828032) & (t <= 10), W, torch.nan)
    out = tas.copy(data=W)
    out.attrs = {"units": "degC"}
    out.name = "wind_chill"
    return out


@declare_units(delta_tas="[temperature]", pr_baseline="[precipitation]")
def clausius_clapeyron_scaled_precipitation(delta_tas: ClimArray,
                                            pr_baseline: ClimArray,
                                            cc_scale_factor: float = 1.07) -> ClimArray:
    """Scale precipitation by CC-rate per degree of warming
    (xclim:converters.py:1751)."""
    dt = convert_units_to(delta_tas, "delta_degC")
    out = pr_baseline.copy(data=pr_baseline.data * cc_scale_factor ** dt.data)
    out.attrs["units"] = pr_baseline.attrs.get("units", "")
    return out


@declare_units(tasmin="[temperature]", tasmax="[temperature]", tas="[temperature]",
               hurs="[]", rsds="[radiation]", rsus="[radiation]", rlds="[radiation]",
               rlus="[radiation]", sfcWind="[speed]", pr="[precipitation]")
def potential_evapotranspiration(tasmin: ClimArray | None = None,
                                 tasmax: ClimArray | None = None,
                                 tas: ClimArray | None = None, lat=None,
                                 hurs: ClimArray | None = None,
                                 rsds: ClimArray | None = None,
                                 rsus: ClimArray | None = None,
                                 rlds: ClimArray | None = None,
                                 rlus: ClimArray | None = None,
                                 sfcWind: ClimArray | None = None,
                                 pr: ClimArray | None = None,
                                 method: str = "BR65", peta: float = 0.00516409319477,
                                 petb: float = 0.0874972822289) -> ClimArray:
    """Potential evapotranspiration by 6 methods: Baier-Robertson 65,
    Hargreaves 85, Droogers-Allen 02, McGuinness-Bordne 05, Thornthwaite 48,
    FAO-PM 98 (xclim:converters.py:1890-2152).

    TW48 and DA02 are monthly formulations: the output time axis is the
    input's ``MS`` resampling (mm/month internally, converted to a flux by
    the actual month durations — the reference's amount2rate tail,
    xclim:converters.py:2149-2152).

    ``lat`` may be a scalar, an array aligned with the input grid, or an
    array introducing NEW dims (1-D series × lat vector): in the last case
    the output broadcasts to ``('time', *input spatial dims, *lat dims)``,
    matching the reference's xarray alignment semantics."""
    from xclim_tpu_torch.core.calendar import date_range, resample_segments
    from xclim_tpu_torch.core.units import amount2rate
    from xclim_tpu_torch.indices.helpers import (
        _lat_flat,
        extraterrestrial_solar_radiation,
        day_lengths,
        wind_speed_height_conversion,
    )
    from xclim_tpu_torch.ops.segments import segment_reduce

    anyvar = tas if tas is not None else tasmin
    if lat is None:
        lat = anyvar.coords.get("lat", 45.0)

    # broadcast layout: lat dims not already carried by the inputs become
    # trailing output dims (the reference broadcasts via xarray alignment)
    _, lat_dims, lat_coords, lat_shape, lat_scalar = _lat_flat(lat)
    new_lat_dims = () if lat_scalar or set(lat_dims) <= set(anyvar.dims) \
        else tuple(lat_dims)
    n_new = len(new_lat_dims)

    def _b(d):
        """Input data → broadcast shape (trailing singleton lat axes)."""
        return d.reshape(d.shape + (1,) * n_new) if n_new else d

    def _solar(sol, ndim=None):
        """Solar-geometry ClimArray → data aligned to the output layout."""
        nd = (anyvar.ndim if ndim is None else ndim) + n_new
        d = sol.data
        if n_new:
            # (T, *lat_shape) → (T, *input-spatial 1s, *lat_shape)
            d = d.reshape(d.shape[:1] + (1,) * (nd - d.ndim) + d.shape[1:])
        elif nd > d.ndim:
            d = d.reshape(d.shape + (1,) * (nd - d.ndim))
        return d

    def _ra(units, time=None, solar_constant="1361 W m-2", ndim=None):
        ra = extraterrestrial_solar_radiation(
            time if time is not None else anyvar.time, lat,
            solar_constant=solar_constant, device=anyvar.data.device)
        ra = convert_units_to(ra, units)
        return _solar(ra, ndim=ndim)

    out_time = anyvar.time
    monthly = False

    if method in ("baierrobertson65", "BR65"):
        tn = _b(convert_units_to(tasmin, "degF").data)
        tx = _b(convert_units_to(tasmax, "degF").data)
        re = _ra("cal cm-2 day-1")
        pet = 0.094 * (-87.03 + 0.928 * tx + 0.933 * (tx - tn) + 0.0486 * re)
        pet = torch.clamp(pet, min=0)
    elif method in ("hargreaves85", "HG85"):
        tn = _b(convert_units_to(tasmin, "degC").data)
        tx = _b(convert_units_to(tasmax, "degC").data)
        tg = (tn + tx) / 2 if tas is None else \
            _b(convert_units_to(tas, "degC").data)
        ra = _ra("MJ m-2 d-1") * 0.408
        pet = 0.0023 * ra * (tg + 17.8) * torch.sqrt(torch.clamp(tx - tn, min=0))
        pet = torch.clamp(pet, min=0)
    elif method in ("droogersallen02", "DA02"):
        # monthly Hargreaves variant with a precipitation correction
        # (xclim:converters.py:2029-2059); all terms resampled to MS
        monthly = True
        taxis = anyvar.time_axis
        mspec = resample_segments(anyvar.time, "MS")
        out_time = mspec.labels
        tn = _b(convert_units_to(tasmin, "degC").data)
        tx = _b(convert_units_to(tasmax, "degC").data)
        tg = (tn + tx) / 2 if tas is None else \
            _b(convert_units_to(tas, "degC").data)
        prm = _b(convert_units_to(pr, "mm/month", context="hydro").data)
        tn_m = segment_reduce(tn, mspec, "mean", axis=taxis)
        tx_m = segment_reduce(tx, mspec, "mean", axis=taxis)
        tg_m = segment_reduce(tg, mspec, "mean", axis=taxis)
        pr_m = segment_reduce(prm, mspec, "mean", axis=taxis)
        # monthly accumulated radiation over the full calendar months
        t0 = anyvar.time
        time_d = date_range(f"{t0.year[0]:04d}-{t0.month[0]:02d}-01",
                            end=_month_end_iso(t0),
                            freq="D", calendar=t0.calendar)
        dspec = resample_segments(time_d, "MS")
        ra_d = _ra("MJ m-2 d-1", time=time_d)
        ra_m = segment_reduce(ra_d, dspec, "sum", axis=0) * 0.408
        tr = torch.clamp(tx_m - tn_m, min=0.0)
        ab = tr - 0.0123 * pr_m
        abp = ab ** 0.76
        pet = 0.0013 * ra_m * (tg_m + 17.0) * abp
        pet = torch.where(torch.isnan(abp), 0.0, pet)
        pet = torch.clamp(pet, min=0)  # mm/month
    elif method in ("mcguinnessbordne05", "MB05"):
        if tas is None:
            tg = (_b(convert_units_to(tasmin, "degC").data)
                  + _b(convert_units_to(tasmax, "degC").data)) / 2
        else:
            tg = _b(convert_units_to(tas, "degC").data)
        tasK = tg + 273.15
        ext_d = _ra("W m-2", solar_constant="1367 W m-2")
        latentH = 4185.5 * (751.78 - 0.5655 * tasK)
        radDIVlat = ext_d / latentH  # kg m-2 s-1 equivalent
        pet = (radDIVlat * peta * tg + radDIVlat * petb) * 86400  # mm/day-ish
    elif method in ("thornthwaite48", "TW48"):
        # monthly day-length-weighted heat-index formulation
        # (xclim:converters.py:2082-2115)
        monthly = True
        taxis = anyvar.time_axis
        if tas is None:
            tg = (_b(convert_units_to(tasmin, "degC").data)
                  + _b(convert_units_to(tasmax, "degC").data)) / 2
        else:
            tg = _b(convert_units_to(tas, "degC").data)
        tg = torch.clamp(tg, min=0)
        mspec = resample_segments(anyvar.time, "MS")
        out_time = mspec.labels
        tas_m = segment_reduce(tg, mspec, "mean", axis=taxis)
        # mean monthly day length in half-days, over full calendar months
        t0 = anyvar.time
        time_d = date_range(f"{t0.year[0]:04d}-{t0.month[0]:02d}-01",
                            end=_month_end_iso(t0),
                            freq="D", calendar=t0.calendar)
        dspec = resample_segments(time_d, "MS")
        dl = _solar(day_lengths(time_d, lat, device=anyvar.data.device)) / 12.0
        dl_m = segment_reduce(dl, dspec, "mean", axis=0)
        # annual heat index I = sum of monthly (t/5)^1.514, spread back onto
        # each month of its year via the static year map
        yspec = resample_segments(out_time, "YS")
        id_m = (tas_m / 5.0) ** 1.514
        id_y = segment_reduce(id_m, yspec, "sum", axis=taxis)
        id_ym = torch.index_select(
            id_y, taxis, torch.as_tensor(np.asarray(yspec.seg_id),
                                         device=id_y.device))
        a = (6.75e-7 * id_ym ** 3 - 7.71e-5 * id_ym ** 2
             + 0.01791 * id_ym + 0.49239)
        frac = (10.0 * tas_m / id_ym) ** a
        pet = 16.0 * dl_m * frac  # 1.6 cm/month × 10 → mm/month
    elif method in ("allen98", "FAO_PM98"):
        tx = convert_units_to(tasmax, "degC")
        tn = convert_units_to(tasmin, "degC")
        h = _b(convert_units_to(hurs, "1").data)
        if sfcWind is None:
            raise ValueError("Wind speed is required for the FAO-PM98 method.")
        wa2 = wind_speed_height_conversion(sfcWind, "10 m", "2 m")
        wa2 = _b(convert_units_to(wa2, "m s-1").data)
        tg = _b((tx.data + tn.data) / 2)
        es = _b(0.5 * (saturation_vapor_pressure(tx).data
                       + saturation_vapor_pressure(tn).data) / 1000.0)  # kPa
        ea = es * h
        delta = 4098 * es / (tg + 237.3) ** 2  # kPa/degC
        rn = convert_units_to(rsds, "W m-2").data - convert_units_to(rsus, "W m-2").data \
            - (convert_units_to(rlus, "W m-2").data - convert_units_to(rlds, "W m-2").data)
        rn_mj = _b(rn) * 0.0864  # W m-2 → MJ m-2 day-1
        gamma = 0.665e-3 * 101.325
        tasK = tg + 273.15
        a1 = 0.408 * delta * rn_mj
        a2 = gamma * 900 / tasK * wa2 * (es - ea)
        a3 = delta + gamma * (1 + 0.34 * wa2)
        pet = (a1 + a2) / a3  # mm/day
    else:
        raise NotImplementedError(f"method {method!r} not implemented")

    out_dims = anyvar.dims + new_lat_dims
    out_coords = dict(anyvar.coords)
    out_coords["time"] = out_time
    for k, v in lat_coords.items():
        out_coords.setdefault(k, v)
    out = ClimArray(pet, out_dims, out_coords, {}, anyvar.name)
    if monthly:
        # mm/month amounts → flux by the actual month durations
        out.attrs = {"units": "mm"}
        out = amount2rate(out, out_units="kg m-2 s-1")
    else:
        out.attrs = {"units": "mm/d"}
        out = convert_units_to(out, "kg m-2 s-1", context="hydro")
    out.name = "evspsblpot"
    out.attrs["standard_name"] = "water_potential_evapotranspiration_flux"
    return out


def _month_end_iso(time) -> str:
    """ISO date of the last day of `time`'s final month (for reconstructing
    the daily axis behind a monthly series; xclim:converters.py:1798)."""
    from xclim_tpu_torch.core.calendar import days_in_month

    y = int(time.year[-1])
    m = int(time.month[-1])
    d = int(days_in_month(y, m, time.calendar))
    return f"{y:04d}-{m:02d}-{d:02d}"


def _utci_poly(ta, va, dtm, pa):
    """Evaluate the 210-term UTCI polynomial (Brode et al. 2012)."""
    from xclim_tpu_torch.indices._utci_coeffs import UTCI_COEFFS

    # precompute powers
    tap = [1.0, ta]
    vap = [1.0, va]
    dtp = [1.0, dtm]
    pap = [1.0, pa]
    for _ in range(5):
        tap.append(tap[-1] * ta)
        vap.append(vap[-1] * va)
        dtp.append(dtp[-1] * dtm)
        pap.append(pap[-1] * pa)
    out = 0.0
    for i, j, k, l, c in UTCI_COEFFS:
        out = out + c * tap[i] * vap[j] * dtp[k] * pap[l]
    return out


@declare_units(tas="[temperature]", hurs="[]", sfcWind="[speed]",
               mrt="[temperature]")
def universal_thermal_climate_index(tas: ClimArray, hurs: ClimArray,
                                    sfcWind: ClimArray,
                                    mrt: ClimArray | None = None,
                                    rsds: ClimArray | None = None,
                                    rsus: ClimArray | None = None,
                                    rlds: ClimArray | None = None,
                                    rlus: ClimArray | None = None,
                                    stat: str = "sunlit",
                                    mask_invalid: bool = True,
                                    wind_cap_min: bool = False) -> ClimArray:
    """UTCI thermal comfort index (xclim:converters.py:2389).

    `wind_cap_min=True` caps wind speeds below the 0.5 m/s validity limit at
    0.5 instead of masking them as invalid (the reference's behavior)."""
    ta = convert_units_to(tas, "degC").data
    raw_w = convert_units_to(sfcWind, "m/s").data
    va = torch.clamp(raw_w, min=0.5) if wind_cap_min else raw_w
    if mrt is None:
        mrt = mean_radiant_temperature(rsds, rsus, rlds, rlus, stat=stat)
    dtm = convert_units_to(mrt, "degC").data - ta
    e_sat = saturation_vapor_pressure(tas, method="its90").data
    h = convert_units_to(hurs, "%").data
    pa = h / 100 * e_sat / 1000.0  # kPa
    utci = _utci_poly(ta, va, dtm, pa)
    if mask_invalid:
        # validity ranges per Brode et al. 2012 (xclim:converters.py:2480)
        valid = ((ta > -50) & (ta < 50) & (dtm > -30) & (dtm < 30)
                 & (va >= 0.5) & (va < 17.0))
        utci = torch.where(valid, utci, torch.nan)
    out = tas.copy(data=utci)
    out.attrs = {"units": "degC"}
    out.name = "utci"
    return convert_units_to(out, "K")


@declare_units(rsds="[radiation]", rsus="[radiation]", rlds="[radiation]",
               rlus="[radiation]")
def mean_radiant_temperature(rsds: ClimArray, rsus: ClimArray, rlds: ClimArray,
                             rlus: ClimArray, stat: str = "sunlit") -> ClimArray:
    """Mean radiant temperature from radiative fluxes (Di Napoli et al. 2020;
    xclim:converters.py:2538).

    stat='sunlit' uses the sunlit-average cosine of the solar zenith angle;
    stat='instant' the instantaneous value at each timestamp (with the
    equation-of-time correction and the 'lon' coordinate's hour-angle
    offset)."""
    from xclim_tpu_torch.indices.helpers import (
        cosine_of_solar_zenith_angle,
        distance_from_sun,
    )

    lat = rsds.coords.get("lat", np.asarray(45.0))
    lon = rsds.coords.get("lon", np.asarray(0.0))
    if stat == "sunlit":
        csza = cosine_of_solar_zenith_angle(rsds.time, lat, stat="average",
                                            sunlit=True,
                                            device=rsds.data.device)
    elif stat == "instant":
        csza = cosine_of_solar_zenith_angle(rsds.time, lat, lon=lon,
                                            stat="instant",
                                            device=rsds.data.device)
    else:
        raise NotImplementedError(
            "Argument 'stat' must be one of 'instant' or 'sunlit'.")
    cz = csza.data
    if rsds.ndim > csza.ndim:
        cz = cz.reshape(cz.shape + (1,) * (rsds.ndim - csza.ndim))
    elif rsds.ndim < csza.ndim:
        cz = cz[..., 0]
    rsds_d = convert_units_to(rsds, "W m-2").data
    rsus_d = convert_units_to(rsus, "W m-2").data
    rlds_d = convert_units_to(rlds, "W m-2").data
    rlus_d = convert_units_to(rlus, "W m-2").data
    # direct-beam fraction of global radiation (xclim:converters.py:2492)
    dsun = distance_from_sun(rsds.time, device=rsds.data.device).data
    dsun = dsun.reshape(dsun.shape + (1,) * (rsds_d.ndim - 1))
    s_star = rsds_d / torch.clamp(1367.0 * cz * dsun ** -2, min=1e-12)
    s_star = torch.clamp(s_star, max=0.85)
    fdir = torch.exp(3.0 - 1.34 * s_star
                   - 1.65 / torch.where(s_star == 0, torch.nan, s_star))
    fdir = torch.clamp(fdir, max=0.9)
    fdir = torch.where((fdir <= 0) | (cz <= float(np.cos(np.deg2rad(89.5))))
                     | (rsds_d <= 0), 0.0, fdir)
    rsds_direct = fdir * rsds_d
    rsds_diffuse = rsds_d - rsds_direct
    gamma = torch.asin(torch.clamp(cz, -1.0, 1.0))
    fp = 0.308 * torch.cos(gamma * 0.988 - gamma ** 2 / 50000.0)
    i_star = torch.where(cz > 0.001, rsds_direct / torch.clamp(cz, min=0.001), 0.0)
    mrt = ((1.0 / 5.67e-8)
           * (0.5 * rlds_d + 0.5 * rlus_d
              + (0.7 / 0.97) * (0.5 * rsds_diffuse + 0.5 * rsus_d
                                + fp * i_star))) ** 0.25
    out = rsds.copy(data=mrt)
    out.attrs = {"units": "K"}
    out.name = "mrt"
    return out


@declare_units(pr="[precipitation]", tasmin="[temperature]", tasmax="[temperature]",
               tas="[temperature]", evspsblpot="[precipitation]")
def water_budget(pr: ClimArray, evspsblpot: ClimArray | None = None,
                 tasmin: ClimArray | None = None, tasmax: ClimArray | None = None,
                 tas: ClimArray | None = None, lat=None, hurs=None, rsds=None,
                 rsus=None, rlds=None, rlus=None, sfcWind=None,
                 method: str = "BR65") -> ClimArray:
    """Precipitation minus potential evapotranspiration
    (xclim:converters.py:2652)."""
    prx = convert_units_to(pr, "kg m-2 s-1", context="hydro")
    if evspsblpot is None:
        pet = potential_evapotranspiration(tasmin=tasmin, tasmax=tasmax, tas=tas,
                                           lat=lat, hurs=hurs, rsds=rsds, rsus=rsus,
                                           rlds=rlds, rlus=rlus, sfcWind=sfcWind,
                                           pr=pr, method=method)
    else:
        pet = convert_units_to(evspsblpot, "kg m-2 s-1", context="hydro")
    prd = prx.data
    if pet.ndim > prd.ndim:
        # PET gained lat dims by broadcasting (array lat × 1-D series):
        # align pr with trailing singletons and keep PET's layout
        prd = prd.reshape(prd.shape + (1,) * (pet.ndim - prd.ndim))
        out = pet.copy(data=prd - pet.data)
    else:
        out = prx.copy(data=prd - pet.data)
    out.attrs = dict(prx.attrs)
    out.attrs["units"] = "kg m-2 s-1"
    out.name = "water_budget"
    return out


@declare_units(wind_speed="[speed]", h="[length]", h_r="[length]")
def wind_profile(wind_speed: ClimArray, h: str, h_r: str,
                 method: str = "power_law", **kwds) -> ClimArray:
    """Wind speed at another height by the power law (xclim:converters.py:2743)."""
    alpha = kwds.get("alpha", 1 / 7)
    hv = convert_units_to(str2pint(h), "m")
    hr = convert_units_to(str2pint(h_r), "m")
    if method != "power_law":
        raise NotImplementedError(method)
    out = wind_speed.copy(data=wind_speed.data * (hv / hr) ** alpha)
    out.attrs = dict(wind_speed.attrs)
    return out


@declare_units(wind_speed="[speed]", air_density="[mass]/[volume]")
def wind_power_potential(wind_speed: ClimArray, air_density=None,
                         cut_in: str = "3.5 m/s", rated: str = "13 m/s",
                         cut_out: str = "25 m/s") -> ClimArray:
    """Fraction of rated turbine power from wind speed (xclim:converters.py:2804)."""
    v = convert_units_to(wind_speed, "m/s").data
    ci = convert_units_to(str2pint(cut_in), "m/s")
    ra = convert_units_to(str2pint(rated), "m/s")
    co = convert_units_to(str2pint(cut_out), "m/s")
    if air_density is not None:
        rho = convert_units_to(air_density, "kg m-3").data
        v = v * (rho / 1.225) ** (1 / 3)
    f = torch.where(v < ci, 0.0,
                  torch.where(v < ra, (v ** 3 - ci ** 3) / (ra ** 3 - ci ** 3),
                            torch.where(v < co, 1.0, 0.0)))
    out = wind_speed.copy(data=f)
    out.attrs = {"units": ""}
    out.name = "wind_power_potential"
    return out


def tas(*args, **kwargs):
    """Deprecated alias of :func:`tas_from_tasmin_tasmax`
    (xclim:converters.py:226)."""
    return tas_from_tasmin_tasmax(*args, **kwargs)


def fao_allen98(net_radiation, tas, wind, es, ea, delta_svp, gamma,
                G="0 MJ m-2 day-1"):
    """FAO-56 Penman-Monteith reference evapotranspiration [mm/day]
    (xclim:converters.py:1825).

    All inputs are raw quantities: net_radiation/G [MJ m-2 day-1], tas [degC],
    wind at 2 m [m s-1], es/ea [kPa], delta_svp [kPa/degC], gamma [kPa/degC].
    Host arrays go to the first tensor input's device; with none, to
    :func:`xclim_tpu_torch.default_device`.
    """
    import xclim_tpu_torch
    from xclim_tpu_torch.core.units import convert_units_to as _cv
    from xclim_tpu_torch.core.units import str2pint as _sp

    g_v = _cv(_sp(G), "MJ m-2 day-1") if isinstance(G, str) else G

    like = next((x.data if isinstance(x, ClimArray) else x
                 for x in (net_radiation, tas, wind, es, ea, delta_svp, gamma)
                 if isinstance(x, (ClimArray, torch.Tensor))), None)
    dev = xclim_tpu_torch.default_device() if like is None else like.device

    def _d(x):
        """ClimArray → its tensor; a tensor or a Python number as is; host
        arrays → float32 tensors on the inputs' device."""
        if isinstance(x, ClimArray):
            return x.data
        if isinstance(x, (torch.Tensor, int, float)):
            return x
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    rn = _d(net_radiation)
    t = _d(tas)
    w = _d(wind)
    num = (0.408 * _d(delta_svp) * (rn - g_v)
           + _d(gamma) * 900.0 / (t + 273.0) * w * (_d(es) - _d(ea)))
    den = _d(delta_svp) + _d(gamma) * (1.0 + 0.34 * w)
    pet = num / den
    if isinstance(net_radiation, ClimArray):
        out = net_radiation.copy(data=pet)
        out.attrs = {"units": "mm/d"}
        out.name = "fao_allen98"
        return out
    return pet
