"""The port's generic building blocks (``indices/generic.py``) and the rest of
``indices/_multivariate.py`` against the JAX package's, on the same numpy
inputs (6 x 5 cells, four noleap years, NaN holes), through the default CPU
route of each package.

Counts, run lengths, event lengths and days of year must be equal. Float
sums and means are accumulated in float64 and rounded once by the port,
while the reference adds float32 partials: they are held within ``SUM_ULP``
float32 ulps. ``detrend`` solves float32 normal equations in both packages
with different summation orders over ~283 K values (one float32 ulp of
283 K is 3e-5 K): the residuals agree within ``DETREND_ATOL`` K.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.indices._multivariate as jmultivariate
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import generic as jgeneric
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indices import _multivariate as multivariate
from xclim_tpu_torch.indices import generic

NY, NX = 6, 5
YEARS = 4
N = 365 * YEARS
#: float32 ulps between the port's float sums/means and the reference's
SUM_ULP = 4
DETREND_ATOL = 4e-4


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _field(var, seed):
    rng = np.random.default_rng(seed)
    season = np.cos(2 * np.pi * (np.arange(N) % 365 - 200) / 365.0)[:, None, None]
    noise = rng.normal(0.0, 1.0, (N, NY, NX))
    for t in range(1, N):
        noise[t] = 0.6 * noise[t - 1] + 0.8 * noise[t]
    if var in ("tas", "tasmax", "tasmin"):
        mu = {"tas": 283.0, "tasmax": 289.0, "tasmin": 277.0}[var]
        x, units = mu + 14.0 * season + 4.0 * noise, "K"
    elif var in ("pr", "prsn", "evspsbl"):
        wet = rng.random((N, NY, NX)) < 0.6
        x = np.where(wet, rng.gamma(0.8, 5.0, (N, NY, NX)) / 86400.0, 0.0)
        if var == "prsn":
            x = np.where(season > 0.2, x, 0.0)
        units = "kg m-2 s-1"
    elif var == "snd":
        x = np.clip(0.3 * season + 0.05 * noise, 0.0, None)
        x[rng.random(x.shape) < 0.03] += 0.3
        units = "m"
    elif var == "sfcWind":
        x, units = np.abs(15.0 + 5.0 * noise), "km h-1"
    else:
        raise KeyError(var)
    x = x.astype(np.float32)
    x[rng.random(x.shape) < 0.01] = np.nan
    x[40:45, 1, 1] = np.nan
    x[:, 5, 4] = np.nan
    return x, units


_STD = {"pr": "precipitation_flux", "prsn": "snowfall_flux",
        "evspsbl": "water_evapotranspiration_flux",
        "snd": "surface_snow_thickness", "sfcWind": "wind_speed"}


def pair(var, seed=0, data=None, units=None):
    if data is None:
        data, units = _field(var, seed)
    attrs = {"units": units}
    if var in _STD:
        attrs["standard_name"] = _STD[var]
    dims = ("time", "lat", "lon")
    n = len(data)
    a = ClimArray(torch.as_tensor(data), dims,
                  {"time": date_range("2000-01-01", periods=n,
                                      calendar="noleap")}, attrs, var)
    b = JClimArray(jnp.asarray(data), dims,
                   {"time": jdate_range("2000-01-01", periods=n,
                                        calendar="noleap")}, attrs, var)
    return a, b


def same(got, exp, ulp=0, atol=None):
    if isinstance(exp, tuple):
        assert isinstance(got, tuple) and len(got) == len(exp)
        for g, e in zip(got, exp):
            same(g, e, ulp, atol)
        return
    if isinstance(exp, dict) or hasattr(exp, "data_vars"):
        assert list(got.keys()) == list(exp.keys())
        for k in exp.keys():
            same(got[k], exp[k], ulp, atol)
        return
    assert got.dims == exp.dims and got.name == exp.name
    g, e = got.values, np.asarray(exp.data)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    ok = ~np.isnan(e)
    if atol is not None:
        np.testing.assert_allclose(g[ok], e[ok], rtol=0, atol=atol)
    elif ulp:
        np.testing.assert_array_max_ulp(g[ok].astype(np.float32),
                                        e[ok].astype(np.float32), maxulp=ulp)
    else:
        np.testing.assert_array_equal(g[ok].astype(np.float64),
                                      e[ok].astype(np.float64))
    if "time" in got.dims:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())
    assert got.attrs == exp.attrs


def both(fn, variables, kw=None, ulp=0, atol=None, seed=20):
    """fn on both packages; `variables` names the inputs, passed in order,
    or maps parameter names to them."""
    names = variables if isinstance(variables, dict) else dict(
        enumerate(variables))
    args, jargs, akw, jkw = [], [], {}, {}
    for i, (key, var) in enumerate(names.items()):
        a, b = pair(var, seed=seed + i)
        if isinstance(key, int):
            args.append(a)
            jargs.append(b)
        else:
            akw[key], jkw[key] = a, b
    kw = kw or {}
    got = getattr(generic if hasattr(jgeneric, fn) else multivariate, fn)(
        *args, **akw, **kw)
    exp = getattr(jgeneric if hasattr(jgeneric, fn) else jmultivariate, fn)(
        *jargs, **jkw, **kw)
    same(got, exp, ulp, atol)
    return got


def test_all_names_match_the_reference():
    assert sorted(generic.__all__) == sorted(jgeneric.__all__)
    assert sorted(multivariate.__all__) == sorted(jmultivariate.__all__)


# (function, input variables, keyword arguments, float32 ulps allowed)
GENERIC = [
    ("domain_count", ["tas"], {"low": "275 K", "high": "290 K", "freq": "MS"}, 0),
    ("get_daily_events", ["tas"], {"threshold": "285 K", "op": ">"}, 0),
    ("spell_length_statistics", ["tas"],
     {"threshold": "290 K", "window": 1, "win_reducer": "min", "op": ">",
      "spell_reducer": "max", "freq": "YS"}, 0),
    ("spell_length_statistics", ["tas"],
     {"threshold": "290 K", "window": 3, "win_reducer": "min", "op": ">",
      "spell_reducer": ["count", "sum", "max", "mean"], "freq": "MS"}, SUM_ULP),
    ("spell_length_statistics", ["tas"],
     {"threshold": "288 K", "window": 4, "win_reducer": "mean", "op": ">=",
      "spell_reducer": ["count", "max"], "freq": "YS", "min_gap": 3}, 0),
    ("spell_length_statistics", ["tas"],
     {"threshold": "278 K", "window": 3, "win_reducer": "max", "op": "<",
      "spell_reducer": "sum", "freq": "YS", "month": [1, 2, 3, 12]}, 0),
    ("spell_length_statistics", ["pr"],
     {"threshold": "1e-5 kg m-2 s-1", "window": 3, "win_reducer": "sum",
      "op": "<", "spell_reducer": "count", "freq": "YS",
      "resample_before_rl": False}, 0),
    ("bivariate_spell_length_statistics", {"data1": "tasmin", "data2": "tasmax"},
     {"threshold1": "283 K", "threshold2": "295 K", "window": 3,
      "win_reducer": "mean", "op": ">=", "spell_reducer": ["count", "max", "sum"],
      "freq": "YS"}, 0),
    ("spell_length", ["tas"], {"threshold": "290 K", "reducer": "max",
                               "op": ">", "freq": "MS"}, 0),
    ("season", ["tas"], {"thresh": "5 degC", "window": 5, "op": ">",
                         "stat": "start", "freq": "YS", "mid_date": "07-01"}, 0),
    ("season", ["tas"], {"thresh": "5 degC", "window": 5, "op": ">",
                         "stat": "end", "freq": "YS", "mid_date": "07-01"}, 0),
    ("season", ["tas"], {"thresh": "5 degC", "window": 5, "op": ">",
                         "stat": "length", "freq": "YS"}, 0),
    ("count_level_crossings", ["tasmin", "tasmax"],
     {"threshold": "0 degC", "freq": "MS"}, 0),
    ("count_occurrences", ["tas"], {"threshold": "10 degC", "freq": "YS",
                                    "op": ">="}, 0),
    ("bivariate_count_occurrences", ["tasmin", "tasmax"],
     {"threshold_var1": "5 degC", "threshold_var2": "20 degC", "freq": "YS",
      "op_var1": ">", "op_var2": "<", "var_reducer": "any"}, 0),
    ("diurnal_temperature_range", ["tasmin", "tasmax"],
     {"reducer": "max", "freq": "MS"}, 0),
    ("first_occurrence", ["tas"], {"threshold": "20 degC", "freq": "YS",
                                   "op": ">"}, 0),
    ("last_occurrence", ["tas"], {"threshold": "20 degC", "freq": "YS",
                                  "op": ">"}, 0),
    ("statistics", ["tas"], {"reducer": "mean", "freq": "MS"}, SUM_ULP),
    ("thresholded_statistics", ["tas"], {"op": ">", "threshold": "12 degC",
                                         "reducer": "sum", "freq": "YS"}, SUM_ULP),
    ("temperature_sum", ["tas"], {"op": "<", "threshold": "5 degC",
                                  "freq": "YS"}, SUM_ULP),
    ("interday_diurnal_temperature_range", ["tasmin", "tasmax"],
     {"freq": "MS"}, SUM_ULP),
    ("extreme_temperature_range", ["tasmin", "tasmax"], {"freq": "YS"}, 0),
    ("aggregate_between_dates", ["tas"], {"start": "03-01", "end": "09-15",
                                          "op": "sum", "freq": "YS"}, SUM_ULP),
    ("aggregate_between_dates", ["tas"], {"start": "11-01", "end": "02-15",
                                          "op": "max", "freq": "YS-JUL"}, 0),
    ("cumulative_difference", ["tas"], {"threshold": "4 degC", "op": ">",
                                        "freq": "MS"}, SUM_ULP),
    ("cumulative_difference", ["tas"], {"threshold": "17 degC", "op": "<="}, 0),
    ("first_day_threshold_reached", ["tas"],
     {"threshold": "15 degC", "op": ">", "after_date": "03-01", "window": 3}, 0),
    ("get_zones", ["tas"], {"zone_min": "-10 degC", "zone_max": "30 degC",
                            "zone_step": "5 K"}, 0),
    ("get_zones", ["tas"], {"bins": ["270 K", "280 K", "290 K", "300 K"],
                            "exclude_boundary_zones": False}, 0),
    ("thresholded_events", ["tas"], {"thresh": "20 degC", "op": ">",
                                     "window": 3, "freq": "YS"}, SUM_ULP),
    ("thresholded_events", ["tas"], {"thresh": "20 degC", "op": ">=",
                                     "window": 2, "thresh_stop": "15 degC",
                                     "window_stop": 3}, SUM_ULP),
]


@pytest.mark.parametrize("fn,variables,kw,ulp", GENERIC,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(GENERIC)])
def test_generic_matches_reference(fn, variables, kw, ulp):
    both(fn, variables, kw, ulp)


def test_spell_mask_variants():
    a, b = pair("tas", seed=3)
    a2, b2 = pair("tasmax", seed=4)
    cases = [
        (a, b, dict(window=1, win_reducer="min", op=">", thresh=288.0)),
        (a, b, dict(window=4, win_reducer="min", op=">", thresh=288.0)),
        (a, b, dict(window=4, win_reducer="mean", op=">", thresh=288.0,
                    min_gap=3)),
        (a, b, dict(window=3, win_reducer="mean", op=">", thresh=288.0,
                    weights=[0.2, 0.3, 0.5])),
        ([a, a2], [b, b2], dict(window=3, win_reducer="mean", op=">",
                                thresh=[285.0, 292.0])),
        ([a, a2], [b, b2], dict(window=3, win_reducer="mean", op=">",
                                thresh=[285.0, 292.0], var_reducer="any")),
    ]
    for x, jx, kw in cases:
        same(generic.spell_mask(x, **kw), jgeneric.spell_mask(jx, **kw))


def test_season_length_from_boundaries():
    a, b = pair("tas", seed=5)
    kw = {"thresh": "5 degC", "window": 5, "op": ">", "freq": "YS",
          "mid_date": "07-01"}
    s, e = (generic.season(a, stat=k, **kw) for k in ("start", "end"))
    js, je = (jgeneric.season(b, stat=k, **kw) for k in ("start", "end"))
    same(generic.season_length_from_boundaries(s, e),
         jgeneric.season_length_from_boundaries(js, je))


def test_aggregate_between_array_bounds():
    a, b = pair("tas", seed=6)
    kw = {"thresh": "5 degC", "window": 5, "op": ">", "freq": "YS",
          "mid_date": "07-01"}
    s, e = (generic.season(a, stat=k, **kw) for k in ("start", "end"))
    js, je = (jgeneric.season(b, stat=k, **kw) for k in ("start", "end"))
    same(generic.aggregate_between_dates(a, s, e, op="integral"),
         jgeneric.aggregate_between_dates(b, js, je, op="integral"),
         ulp=SUM_ULP)
    with pytest.raises(ValueError, match="Invalid day-of-year"):
        generic.aggregate_between_dates(a, "02-31", "03-01")


def test_detrend():
    a, b = pair("tas", seed=7)
    for deg in (1, 2):
        same(generic.detrend(a, deg=deg), jgeneric.detrend(b, deg=deg),
             atol=DETREND_ATOL)


def test_threshold_units_convert_like_the_reference():
    a, b = pair("tas", seed=8)
    same(generic.threshold_count(a, ">", "77 degF", "MS"),
         jgeneric.threshold_count(b, ">", "77 degF", "MS"))
    p, jp = pair("pr", seed=9)
    same(generic.count_occurrences(p, "1 mm/day", "YS", ">="),
         jgeneric.count_occurrences(jp, "1 mm/day", "YS", ">="))


# the rest of indices/_multivariate.py: (function, inputs, kwargs, ulps)
MULTIVARIATE = [
    ("multiday_temperature_swing", ["tasmin", "tasmax"],
     {"thresh_tasmin": "5 degC", "thresh_tasmax": "12 degC", "op": "count",
      "window": 2}, 0),
    ("multiday_temperature_swing", ["tasmin", "tasmax"],
     {"thresh_tasmin": "5 degC", "thresh_tasmax": "12 degC", "op": "mean"},
     SUM_ULP),
    ("multiday_temperature_swing", ["tasmin", "tasmax"],
     {"thresh_tasmin": "5 degC", "thresh_tasmax": "12 degC", "op": "max",
      "freq": "MS"}, 0),
    ("daily_temperature_range", ["tasmin", "tasmax"], {"op": "max"}, 0),
    ("daily_temperature_range", ["tasmin", "tasmax"], {"freq": "MS"}, SUM_ULP),
    ("daily_temperature_range_variability", ["tasmin", "tasmax"], {}, SUM_ULP),
    ("extreme_temperature_range", ["tasmin", "tasmax"], {"freq": "MS"}, 0),
    ("heat_wave_frequency", ["tasmin", "tasmax"],
     {"thresh_tasmin": "16 degC", "thresh_tasmax": "25 degC"}, 0),
    ("heat_wave_frequency", ["tasmin", "tasmax"],
     {"thresh_tasmin": "16 degC", "thresh_tasmax": "25 degC", "freq": "MS",
      "resample_before_rl": False}, 0),
    ("heat_wave_max_length", ["tasmin", "tasmax"],
     {"thresh_tasmin": "16 degC", "thresh_tasmax": "25 degC", "window": 2}, 0),
    ("heat_wave_total_length", ["tasmin", "tasmax"],
     {"thresh_tasmin": "16 degC", "thresh_tasmax": "25 degC", "op": ">="}, 0),
    ("liquid_precip_ratio", ["pr", "prsn"], {"freq": "YS"}, 2 * SUM_ULP),
    ("precip_accumulation", ["pr"], {"freq": "MS"}, SUM_ULP),
    ("precip_average", ["pr"], {}, SUM_ULP),
    ("rain_on_frozen_ground_days", ["pr", "tas"], {"window": 3}, 0),
    ("high_precip_low_temp", ["pr", "tas"], {"tas_thresh": "3 degC"}, 0),
    ("tx_tn_days_above", ["tasmin", "tasmax"],
     {"thresh_tasmin": "16 degC", "thresh_tasmax": "25 degC"}, 0),
    ("winter_rain_ratio", ["pr", "prsn"], {}, 2 * SUM_ULP),
    ("blowing_snow", ["snd", "sfcWind"], {"snd_thresh": "10 cm",
                                          "sfcWind_thresh": "18 km/h"}, 0),
    ("water_cycle_intensity", ["pr", "evspsbl"], {}, SUM_ULP),
]


@pytest.mark.parametrize("fn,variables,kw,ulp", MULTIVARIATE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MULTIVARIATE)])
def test_multivariate_matches_reference(fn, variables, kw, ulp):
    both(fn, variables, kw, ulp)


def _percentiles(var, per, seed):
    from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
    from xclim_tpu_torch.core.percentiles import from_reference_percentiles

    _, b = pair(var, seed=seed)
    jper = jpercentile_doy(b, window=5, per=per)
    return (from_reference_percentiles(np.asarray(jper.data), jper.dims,
                                       jper.coords, jper.attrs, device="cpu"),
            jper)


@pytest.mark.parametrize("fn", ["cold_and_dry_days", "warm_and_dry_days",
                                "warm_and_wet_days", "cold_and_wet_days"])
def test_combo_days(fn):
    t, jt = pair("tas", seed=30)
    p, jp = pair("pr", seed=31)
    tper, jtper = _percentiles("tas", 25 if fn.startswith("cold") else 75, 30)
    pper, jpper = _percentiles("pr", 75 if "wet" in fn else 25, 31)
    same(getattr(multivariate, fn)(t, p, tper, pper),
         getattr(jmultivariate, fn)(jt, jp, jtper, jpper))


@pytest.mark.parametrize("fn", ["days_over_precip_thresh",
                                "fraction_over_precip_thresh"])
def test_precip_over_percentile(fn):
    p, jp = pair("pr", seed=32)
    per, jper = _percentiles("pr", 75, 32)
    same(getattr(multivariate, fn)(p, per, thresh="0.5 mm/day"),
         getattr(jmultivariate, fn)(jp, jper, thresh="0.5 mm/day"),
         ulp=0 if fn.startswith("days") else 2 * SUM_ULP)


#: (tot - snow) / tot cancels where little rain falls: the error of either
#: sum is relative to tot, so the ratio is held absolutely, at twice the
#: sums' ulps of 1
RATIO_ATOL = 2 * SUM_ULP * float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("fn,kw,ulp,atol", [
    ("liquid_precip_ratio", {"freq": "QS-DEC"}, 0, RATIO_ATOL),
    ("liquid_precip_ratio", {"thresh": "5 degC", "freq": "YS"}, 0,
     RATIO_ATOL),
    ("precip_accumulation", {"phase": "liquid"}, SUM_ULP, None),
    ("precip_accumulation", {"phase": "solid", "thresh": "2 degC"}, SUM_ULP,
     None),
    ("precip_average", {"phase": "liquid", "freq": "MS"}, SUM_ULP, None),
    ("precip_average", {"phase": "solid"}, SUM_ULP, None),
])
def test_converter_branches(fn, kw, ulp, atol):
    """liquid_precip_ratio without prsn, and the phase of
    precip_accumulation / precip_average: the binary phase split of
    indices/converters.py, then the period sums."""
    both(fn, {"pr": "pr", "tas": "tas"}, kw, ulp, atol=atol, seed=33)
