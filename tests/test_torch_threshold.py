"""The port's threshold indices (``indices/_threshold.py``) against the JAX
package's, on the same numpy inputs: every name of the reference module's
``__all__``, on 6 x 5 cells over four noleap years with NaN holes, plus a
``standard`` and a ``360_day`` case, through the default CPU route of each
package (the reference's XLA route; the port's kernel twins).

Counts, run lengths and days of year must be equal. Float sums (degree
days, amounts, intensities) are accumulated in float64 and rounded once by
the port, while the reference adds float32 partials, so they are held
within ``SUM_ULP`` float32 ulps instead, and a ratio of two such sums
within ``RATIO_ULP`` (ROADMAP, "Known rounding gaps").
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.indices._threshold as jthreshold
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import generic as jgeneric
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indices import _threshold as threshold
from xclim_tpu_torch.indices import generic
from xclim_tpu_torch.ops import segred, spells

NY, NX = 6, 5
YEARS = 4
#: float32 ulps between the port's float sums and the reference's, and
#: between ratios of two sums (each side's error adds)
SUM_ULP = 4
RATIO_ULP = 8


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _days(cal):
    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * YEARS
    return n + (1 if cal == "standard" else 0)


def _field(var, cal, seed):
    """(time, 6, 5) float32 of one variable: a seasonal cycle with AR(1)
    noise, 1 % scattered NaN, a 5-day gap in cell (1, 1) and an all-NaN
    cell (5, 4)."""
    n = _days(cal)
    rng = np.random.default_rng(seed)
    doy = np.arange(n) % {"360_day": 360}.get(cal, 365)
    season = np.cos(2 * np.pi * (doy - 200) / 365.0)[:, None, None]
    noise = rng.normal(0.0, 1.0, (n, NY, NX))
    for t in range(1, n):
        noise[t] = 0.6 * noise[t - 1] + 0.8 * noise[t]
    if var in ("tas", "tasmax", "tasmin"):
        mu = {"tas": 283.0, "tasmax": 289.0, "tasmin": 277.0}[var]
        x = mu + 14.0 * season + 4.0 * noise
        units = "K"
    elif var in ("pr", "prc", "prsn"):
        # kg m-2 s-1: 40 % dry days, wet days of ~1-30 mm/d
        wet = rng.random((n, NY, NX)) < 0.6
        amount = rng.gamma(0.8, 5.0, (n, NY, NX)) / 86400.0
        x = np.where(wet, amount, 0.0)
        if var == "prc":
            x = x * rng.random((n, NY, NX))
        if var == "prsn":
            x = np.where(season > 0.2, x, 0.0)
        units = "kg m-2 s-1"
    elif var in ("snd", "snw"):
        # a winter snow pack: positive when the cycle is cold, with storms
        depth = np.clip(0.3 * season + 0.05 * noise, 0.0, None)
        depth[rng.random(depth.shape) < 0.03] += 0.3
        x = depth if var == "snd" else depth * 200.0
        units = "m" if var == "snd" else "kg m-2"
    elif var == "sfcWind":
        x = np.abs(5.0 + 3.0 * noise)
        units = "m s-1"
    elif var == "siconc":
        x = np.clip(50.0 + 60.0 * season + 20.0 * noise, 0.0, 100.0)
        units = "%"
    else:
        raise KeyError(var)
    x = x.astype(np.float32)
    x[rng.random(x.shape) < 0.01] = np.nan
    x[40:45, 1, 1] = np.nan
    x[:, 5, 4] = np.nan
    return x, units


_STD = {"tas": ("air_temperature", "time: mean"),
        "tasmax": ("air_temperature", "time: maximum"),
        "tasmin": ("air_temperature", "time: minimum"),
        "pr": ("precipitation_flux", None),
        "prc": ("convective_precipitation_flux", None),
        "prsn": ("snowfall_flux", None),
        "snd": ("surface_snow_thickness", None),
        "snw": ("surface_snow_amount", None),
        "sfcWind": ("wind_speed", None),
        "siconc": ("sea_ice_area_fraction", None)}


def pair(var, cal="noleap", seed=0):
    """One seeded numpy field as a port and a reference ClimArray."""
    x, units = _field(var, cal, seed)
    sn, cm = _STD[var]
    attrs = {"units": units, "standard_name": sn}
    if cm:
        attrs["cell_methods"] = cm
    dims = ("time", "lat", "lon")
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": date_range("2000-01-01", periods=len(x),
                                      calendar=cal)}, attrs, var)
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jdate_range("2000-01-01", periods=len(x),
                                        calendar=cal)}, attrs, var)
    return a, b


def _area():
    x = np.linspace(1.0, 2.0, NY * NX).reshape(NY, NX).astype(np.float32)
    attrs = {"units": "km2", "standard_name": "cell_area"}
    return (ClimArray(torch.as_tensor(x), ("lat", "lon"), {}, attrs, "areacello"),
            JClimArray(jnp.asarray(x), ("lat", "lon"), {}, attrs, "areacello"))


def same(got, exp, ulp=0):
    """Equal values, NaN pattern, dims, name, attrs and time labels; float
    values within `ulp` float32 ulps when `ulp` is set."""
    assert got.dims == exp.dims and got.name == exp.name
    g, e = got.values, np.asarray(exp.data)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    ok = ~np.isnan(e)
    if ulp:
        np.testing.assert_array_max_ulp(g[ok].astype(np.float32),
                                        e[ok].astype(np.float32), maxulp=ulp)
    else:
        np.testing.assert_array_equal(g[ok].astype(np.float64),
                                      e[ok].astype(np.float64))
    if "time" in got.dims:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())
    assert got.attrs == exp.attrs


# name -> (input variables, keyword arguments, float32 ulps allowed: 0 for
# counts, run lengths and days of year)
CASES = {
    "calm_days": (["sfcWind"], {"thresh": "3 m s-1"}, 0),
    "windy_days": (["sfcWind"], {"thresh": "7 m s-1"}, 0),
    "cold_spell_days": (["tas"], {"thresh": "-3 degC", "window": 3}, 0),
    "cold_spell_frequency": (["tas"], {"thresh": "-3 degC", "window": 3}, 0),
    "cold_spell_max_length": (["tas"], {"thresh": "-3 degC", "window": 2}, 0),
    "cold_spell_total_length": (["tas"], {"thresh": "-3 degC"}, 0),
    "snd_season_end": (["snd"], {"window": 7}, 0),
    "snw_season_end": (["snw"], {"window": 7}, 0),
    "snd_season_start": (["snd"], {"window": 7}, 0),
    "snw_season_start": (["snw"], {"window": 7}, 0),
    "snd_season_length": (["snd"], {"window": 7}, 0),
    "snw_season_length": (["snw"], {"window": 7}, 0),
    "snd_storm_days": (["snd"], {"thresh": "20 cm"}, 0),
    "snw_storm_days": (["snw"], {"thresh": "40 kg m-2"}, 0),
    "daily_pr_intensity": (["pr"], {}, SUM_ULP),
    "dry_days": (["pr"], {}, 0),
    "maximum_consecutive_wet_days": (["pr"], {}, 0),
    "maximum_consecutive_dry_days": (["pr"], {"freq": "MS"}, 0),
    "wetdays": (["pr"], {"thresh": "2 mm/day"}, 0),
    "days_with_snow": (["prsn"], {"low": "1 mm/day"}, 0),
    "wetdays_prop": (["pr"], {"freq": "MS"}, SUM_ULP),
    "rprctot": (["pr", "prc"], {}, RATIO_ULP),
    "dry_spell_frequency": (["pr"], {"window": 2}, 0),
    "dry_spell_total_length": (["pr"], {"window": 2, "op": "max"}, 0),
    "dry_spell_max_length": (["pr"], {}, 0),
    "wet_spell_frequency": (["pr"], {"window": 2, "thresh": "3 mm"}, 0),
    "wet_spell_total_length": (["pr"], {"thresh": "5 mm"}, 0),
    "wet_spell_max_length": (["pr"], {"op": "max", "month": [4, 5, 6]}, 0),
    "cooling_degree_days": (["tas"], {"freq": "MS"}, SUM_ULP),
    "cooling_degree_days_approximation": (["tasmax", "tasmin", "tas"], {}, SUM_ULP),
    "heating_degree_days_approximation": (["tasmax", "tasmin", "tas"], {}, SUM_ULP),
    "growing_degree_days": (["tas"], {}, SUM_ULP),
    "heating_degree_days": (["tas"], {"freq": "QS-DEC"}, SUM_ULP),
    "degree_days_exceedance_date": (["tas"], {"sum_thresh": "200 K days",
                                              "after_date": "03-01"}, 0),
    "growing_season_start": (["tas"], {}, 0),
    "growing_season_end": (["tas"], {}, 0),
    "growing_season_length": (["tas"], {}, 0),
    "frost_season_length": (["tasmin"], {}, 0),
    "frost_free_season_start": (["tasmin"], {}, 0),
    "frost_free_season_end": (["tasmin"], {}, 0),
    "frost_free_season_length": (["tasmin"], {}, 0),
    "frost_free_spell_max_length": (["tasmin"], {"window": 3}, 0),
    "last_spring_frost": (["tasmin"], {}, 0),
    "first_day_temperature_below": (["tas"], {"window": 2}, 0),
    "first_day_temperature_above": (["tas"], {"thresh": "10 degC"}, 0),
    "first_snowfall": (["prsn"], {}, 0),
    "last_snowfall": (["prsn"], {}, 0),
    "snowfall_frequency": (["prsn"], {}, SUM_ULP),
    "snowfall_intensity": (["prsn"], {}, SUM_ULP),
    "heat_wave_index": (["tasmax"], {"thresh": "22 degC", "window": 3}, 0),
    "hot_spell_max_magnitude": (["tasmax"], {"thresh": "22 degC"}, SUM_ULP),
    "hot_spell_max_length": (["tasmax"], {"thresh": "25 degC"}, 0),
    "hot_spell_total_length": (["tasmax"], {"thresh": "25 degC"}, 0),
    "hot_spell_frequency": (["tasmax"], {"thresh": "25 degC"}, 0),
    "snd_days_above": (["snd"], {}, 0),
    "snw_days_above": (["snw"], {}, 0),
    "tn_days_above": (["tasmin"], {"thresh": "10 degC"}, 0),
    "tn_days_below": (["tasmin"], {}, 0),
    "tg_days_above": (["tas"], {}, 0),
    "tg_days_below": (["tas"], {"freq": "MS"}, 0),
    "tx_days_above": (["tasmax"], {}, 0),
    "tx_days_below": (["tasmax"], {"thresh": "77 degF"}, 0),
    "warm_day_frequency": (["tasmax"], {"thresh": "25 degC"}, 0),
    "warm_night_frequency": (["tasmin"], {"thresh": "12 degC"}, 0),
    "maximum_consecutive_frost_days": (["tasmin"], {}, 0),
    "maximum_consecutive_frost_free_days": (["tasmin"], {}, 0),
    "maximum_consecutive_tx_days": (["tasmax"], {}, 0),
    "sea_ice_area": (["siconc", "areacello"], {}, SUM_ULP),
    "sea_ice_extent": (["siconc", "areacello"], {}, SUM_ULP),
    "holiday_snow_days": (["snd"], {"date_end": "12-31"}, 0),
    "holiday_snow_and_snowfall_days": (["snd", "prsn"],
                                       {"date_start": "11-20",
                                        "date_end": "12-31"}, 0),
}


def _run(name, cal="noleap", **extra):
    variables, kw, ulp = CASES[name]
    kw = dict(kw, **extra)
    args, jargs = [], []
    for i, var in enumerate(variables):
        a, b = _area() if var == "areacello" else pair(var, cal, seed=10 + i)
        args.append(a)
        jargs.append(b)
    got = getattr(threshold, name)(*args, **kw)
    exp = getattr(jthreshold, name)(*jargs, **kw)
    same(got, exp, ulp=ulp)
    return got


def test_all_names_match_the_reference():
    assert threshold.__all__ == jthreshold.__all__
    assert set(CASES) == set(jthreshold.__all__)


@pytest.mark.parametrize("name", jthreshold.__all__)
def test_threshold_index_matches_reference(name):
    _run(name)


@pytest.mark.parametrize("cal", ["standard", "360_day"])
@pytest.mark.parametrize("name", ["tx_days_above", "growing_season_length",
                                  "frost_free_season_start",
                                  "degree_days_exceedance_date",
                                  "hot_spell_frequency", "growing_degree_days"])
def test_other_calendars(name, cal):
    _run(name, cal=cal)


@pytest.mark.parametrize("name,kw", [
    ("hot_spell_frequency", {"resample_before_rl": False}),
    ("cold_spell_days", {"resample_before_rl": False, "thresh": "-3 degC"}),
    ("maximum_consecutive_wet_days", {"resample_before_rl": False}),
    ("dry_spell_frequency", {"resample_before_rl": False}),
    ("tx_days_above", {"freq": "MS", "op": ">="}),
    ("tn_days_below", {"thresh": "275.5 K", "op": "<="}),
    ("degree_days_exceedance_date", {"never_reached": "12-31"}),
    ("degree_days_exceedance_date", {"op": "<", "thresh": "10 degC",
                                     "sum_thresh": "40 K days",
                                     "freq": "YS-JUL"}),
    ("growing_season_length", {"mid_date": None}),
    ("frost_free_season_end", {"window": 3, "freq": "YS-JUL",
                               "mid_date": "01-01"}),
    ("dry_days", {"thresh": "0.02 kg m-2 h-1"}),
], ids=lambda v: v if isinstance(v, str) else "-".join(
    f"{k}={v[k]}" for k in sorted(v)))
def test_options(name, kw):
    _run(name, **kw)


def test_doy_outputs_carry_doy_attrs():
    out = _run("last_spring_frost")
    assert out.attrs["units"] == "1" and out.attrs["is_dayofyear"] == 1
    assert out.attrs["calendar"] == "noleap"


def test_threshold_count_routes_agree():
    """The spells route (a scalar threshold on a float32 series) and the
    compare-and-sum route give the same counts, equal to the reference's."""
    a, b = pair("tasmax", seed=3)
    for op in (">", ">=", "<", "<="):
        before = spells.twin_calls, segred.twin_calls
        got = generic.threshold_count(a, op, "288.15 K", "MS")
        assert (spells.twin_calls - before[0], segred.twin_calls - before[1]) \
            == (1, 0)
        plain = generic.compare(a, op, 288.15).astype(torch.float32) \
            .resample("MS").sum()
        exp = jgeneric.threshold_count(b, op, "288.15 K", "MS")
        same(got, exp)
        same(plain, exp)
