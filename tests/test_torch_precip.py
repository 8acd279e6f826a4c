"""The port's precipitation, wind, synoptic and conversion indicators
(``indicators/atmos/_precip.py``, ``_wind.py``, ``_synoptic.py``,
``indicators/convert``) and the fused 10-indicator chain of
``bench.py:542-600`` against the JAX package's on the same numpy inputs:
seeded daily fields (3 noleap years x 3 latitudes x 4 longitudes, 1 %
NaN, half the precipitation days dry; 8 x 8 cells for the chain) and the
oracle inputs of the reference's ``tests/test_precip_suite.py`` and
``test_preciptemp_suite.py`` (their grid builders and series fixtures),
through the reference's XLA route.

Bounds: values within ``RTOL`` (1e-6) relative, counts, lengths and days
of year equal, with the same NaN pattern (the missing-value masks), dims
and attributes (the history line but for its timestamp and package name).
The port sums periods in float64 and rounds once, the reference adds
float32 partials: sums and ratios of sums hold to 1e-6. The converters'
stated bounds (``tests/test_torch_converters.py``) carry over to the
conversion indicators that use them (e_sat: ``ESAT_RTOL``; the UTCI
polynomial: ``UTCI_ATOL``); the standardized indices' to SPI and SPEI
(``tests/test_torch_agro.py``, ``tests/test_torch_hydro_anuclim.py``).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_precip_suite as ref_precip
import xclim_tpu.indicators.atmos as jatmos
import xclim_tpu.indicators.convert as jconvert
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.indicator import registry as jregistry
from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch import climjit_chain
from xclim_tpu_torch.core.indicator import registry
from xclim_tpu_torch.core.percentiles import from_reference_percentiles
from xclim_tpu_torch.indicators import atmos, convert

from test_torch_agro import SPEI_ATOL
from test_torch_converters import ESAT_RTOL, UTCI_ATOL, close, to_port
from test_torch_hydro_anuclim import NORM_ATOL

RTOL = 1e-6
YEARS = 3
NT = 365 * YEARS
LAT = np.array([10.0, 45.0, -38.0])


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _field(name, units, mu, sd, seed, seas=0.0, positive=False, dry=None,
           attrs=None, n=NT, freq="D", shape=(3, 4)):
    rng = np.random.default_rng(seed)
    season = np.cos(2 * np.pi * (np.arange(n) % 365 - 200) / 365.0)
    x = (mu + seas * season.reshape((-1,) + (1,) * len(shape))
         + rng.normal(0, sd, (n,) + shape)).astype(np.float32)
    if positive:
        x = np.abs(x)
    if dry is not None:
        x[rng.random(x.shape) < dry] = 0.0
    x[rng.random(x.shape) < 0.01] = np.nan
    t = jdate_range("2000-01-01", periods=n, freq=freq, calendar="noleap")
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": LAT[:shape[0]] if shape[0] == 3
                    else np.linspace(-60, 60, shape[0]),
                    "lon": np.arange(float(shape[1]))},
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


def _t(cm):
    return {"standard_name": "air_temperature", "cell_methods": cm}


def _flux(sn):
    return {"standard_name": sn}


SPECS = {
    "tas": ("K", 283, 4, dict(seas=12, attrs=_t("time: mean"))),
    "tasmax": ("K", 289, 4, dict(seas=12, attrs=_t("time: maximum"))),
    "tasmin": ("K", 277, 4, dict(seas=12, attrs=_t("time: minimum"))),
    "pr": ("kg m-2 s-1", 3e-5, 3e-5, dict(
        positive=True, dry=0.5, attrs=_flux("precipitation_flux"))),
    "prsn": ("kg m-2 s-1", 1e-5, 1e-5, dict(
        positive=True, dry=0.7, attrs=_flux("snowfall_flux"))),
    "prc": ("kg m-2 s-1", 1e-5, 1e-5, dict(
        positive=True, dry=0.6,
        attrs=_flux("convective_precipitation_flux"))),
    "evspsbl": ("kg m-2 s-1", 1e-5, 5e-6, dict(
        positive=True, attrs=_flux("water_evapotranspiration_flux"))),
    "evspsblpot": ("kg m-2 s-1", 2e-5, 1e-5, dict(
        positive=True,
        attrs=_flux("water_potential_evapotranspiration_flux"))),
    "wb": ("kg m-2 s-1", 0.0, 3e-5, {}),
    "sfcWind": ("m s-1", 5, 3, dict(positive=True,
                                    attrs={"standard_name": "wind_speed"})),
    "sfcWindmax": ("m s-1", 9, 4, dict(positive=True,
                                       attrs={"standard_name": "wind_speed"})),
    "sfcWindfromdir": ("degree", 180, 90, dict(
        positive=True, attrs={"standard_name": "wind_from_direction"})),
    "uas": ("m s-1", 0, 4, dict(attrs={"standard_name": "eastward_wind"})),
    "vas": ("m s-1", 0, 4, dict(attrs={"standard_name": "northward_wind"})),
    "hurs": ("%", 70, 15, dict(attrs={"standard_name": "relative_humidity"})),
    "huss": ("1", 0.008, 0.002, dict(
        positive=True, attrs={"standard_name": "specific_humidity"})),
    "tdps": ("K", 278, 5, dict(attrs={"standard_name": "dew_point_temperature"})),
    "ps": ("Pa", 101000, 800, dict(
        attrs={"standard_name": "surface_air_pressure"})),
    "rsds": ("W m-2", 200, 80, dict(positive=True, attrs=_flux(
        "surface_downwelling_shortwave_flux_in_air"))),
    "rsus": ("W m-2", 40, 10, dict(positive=True, attrs=_flux(
        "surface_upwelling_shortwave_flux_in_air"))),
    "rlds": ("W m-2", 300, 30, dict(positive=True, attrs=_flux(
        "surface_downwelling_longwave_flux_in_air"))),
    "rlus": ("W m-2", 380, 30, dict(positive=True, attrs=_flux(
        "surface_upwelling_longwave_flux_in_air"))),
    "snd": ("m", 0.3, 0.1, dict(positive=True, attrs=_flux(
        "surface_snow_thickness"))),
    "snw": ("kg m-2", 90, 30, dict(positive=True, attrs=_flux(
        "surface_snow_amount"))),
}


@pytest.fixture(scope="module")
def fields():
    out = {k: _field(k, u, mu, sd, i, **kw)
           for i, (k, (u, mu, sd, kw)) in enumerate(SPECS.items())}
    jpr = out["pr"][0]
    jper = jpercentile_doy(jpr, window=5, per=75)
    out["pr_per"] = (jper, from_reference_percentiles(
        np.asarray(jper.data), jper.dims, jper.coords, jper.attrs,
        device="cpu"))
    out["pr_h"] = _field("pr", "kg m-2 s-1", 3e-6, 3e-6, 99, positive=True,
                         dry=0.6, n=24 * 90, freq="h",
                         attrs=_flux("precipitation_flux"))
    lat = np.linspace(20, 70, 16)
    u = (20 * np.exp(-((lat[None, :] - 45) / 10) ** 2)
         + np.random.default_rng(7).normal(0, 1, (NT, 16))).astype(np.float32)
    t = jdate_range("2000-01-01", periods=NT, calendar="noleap")
    jua = JClimArray(jnp.asarray(u), ("time", "lat"),
                     {"time": t, "lat": lat},
                     {"units": "m s-1", "standard_name": "eastward_wind"},
                     "ua")
    out["ua"] = (jua, to_port(jua))
    return out


#: indicator -> (call on an indicator module and the inputs, rtol, atol)
PRECIP = {
    "precip_accumulation": (lambda m, a: m.precip_accumulation(a["pr"])),
    "liquid_precip_accumulation": (lambda m, a: m.liquid_precip_accumulation(
        a["pr"], tas=a["tas"])),
    "solid_precip_accumulation": (lambda m, a: m.solid_precip_accumulation(
        a["pr"], tas=a["tas"], thresh="5 degC")),
    "precip_average": (lambda m, a: m.precip_average(a["pr"], freq="MS")),
    "liquid_precip_average": (lambda m, a: m.liquid_precip_average(
        a["pr"], tas=a["tas"])),
    "solid_precip_average": (lambda m, a: m.solid_precip_average(
        a["pr"], tas=a["tas"])),
    "wetdays": (lambda m, a: m.wetdays(a["pr"], thresh="2 mm/day")),
    "wetdays_prop": (lambda m, a: m.wetdays_prop(a["pr"])),
    "dry_days": (lambda m, a: m.dry_days(a["pr"], freq="MS")),
    "max_1day_precipitation_amount": (
        lambda m, a: m.max_1day_precipitation_amount(a["pr"])),
    "max_n_day_precipitation_amount": (
        lambda m, a: m.max_n_day_precipitation_amount(a["pr"], window=5)),
    "max_pr_intensity": (lambda m, a: m.max_pr_intensity(a["pr_h"],
                                                         window=3,
                                                         freq="MS")),
    "daily_pr_intensity": (lambda m, a: m.daily_pr_intensity(a["pr"])),
    "cdd": (lambda m, a: m.cdd(a["pr"])),
    "cwd": (lambda m, a: m.cwd(a["pr"], freq="MS")),
    "maximum_consecutive_dry_days": (
        lambda m, a: m.maximum_consecutive_dry_days(a["pr"], thresh="3 mm/d")),
    "maximum_consecutive_wet_days": (
        lambda m, a: m.maximum_consecutive_wet_days(a["pr"])),
    "rain_on_frozen_ground_days": (
        lambda m, a: m.rain_on_frozen_ground_days(a["pr"], a["tas"])),
    "high_precip_low_temp": (lambda m, a: m.high_precip_low_temp(
        a["pr"], a["tasmin"], tas_thresh="5 degC")),
    "days_over_precip_thresh": (lambda m, a: m.days_over_precip_thresh(
        a["pr"], a["pr_per"])),
    "fraction_over_precip_thresh": (lambda m, a: m.fraction_over_precip_thresh(
        a["pr"], a["pr_per"])),
    "days_over_precip_doy_thresh": (lambda m, a: m.days_over_precip_doy_thresh(
        a["pr"], a["pr_per"])),
    "fraction_over_precip_doy_thresh": (
        lambda m, a: m.fraction_over_precip_doy_thresh(a["pr"], a["pr_per"])),
    "dry_spell_frequency": (lambda m, a: m.dry_spell_frequency(a["pr"])),
    "dry_spell_total_length": (lambda m, a: m.dry_spell_total_length(
        a["pr"], op="max")),
    "dry_spell_max_length": (lambda m, a: m.dry_spell_max_length(a["pr"])),
    "wet_spell_frequency": (lambda m, a: m.wet_spell_frequency(a["pr"])),
    "wet_spell_total_length": (lambda m, a: m.wet_spell_total_length(
        a["pr"])),
    "wet_spell_max_length": (lambda m, a: m.wet_spell_max_length(
        a["pr"], window=2)),
    "wet_prcptot": (lambda m, a: m.wet_prcptot(a["pr"])),
    "wet_precip_accumulation": (lambda m, a: m.wet_precip_accumulation(
        a["pr"], thresh="3 mm/d")),
    "days_with_snow": (lambda m, a: m.days_with_snow(a["prsn"])),
    "first_snowfall": (lambda m, a: m.first_snowfall(a["prsn"],
                                                     thresh="0.5 mm/day")),
    "last_snowfall": (lambda m, a: m.last_snowfall(a["prsn"],
                                                   thresh="0.5 mm/day")),
    "snowfall_frequency": (lambda m, a: m.snowfall_frequency(a["prsn"])),
    "snowfall_intensity": (lambda m, a: m.snowfall_intensity(a["prsn"])),
    "liquid_precip_ratio_prsn": (lambda m, a: m.liquid_precip_ratio(
        a["pr"], prsn=a["prsn"])),
    "liquid_precip_ratio_tas": (lambda m, a: m.liquid_precip_ratio(
        a["pr"], tas=a["tas"], freq="YS")),
    "rprctot": (lambda m, a: m.rprctot(a["pr"], a["prc"])),
    "water_cycle_intensity": (lambda m, a: m.water_cycle_intensity(
        a["pr"], a["evspsbl"])),
    "aridity_index": (lambda m, a: m.aridity_index(a["pr"], a["evspsblpot"])),
    "antecedent_precipitation_index": (
        lambda m, a: m.antecedent_precipitation_index(a["pr"])),
    "api": (lambda m, a: m.api(a["pr"], window=5)),
    "dryness_index": (lambda m, a: m.dryness_index(a["pr"],
                                                   a["evspsblpot"])),
    "rain_season": (lambda m, a: m.rain_season(
        a["pr"], thresh_wet_start="15 mm", window_not_dry_start=10)),
    # the indicator layer with a normal fit; the gamma fits' bounds are in
    # tests/test_torch_agro.py and tests/test_torch_stats.py
    "spi": (lambda m, a: m.spi(a["pr"], freq="MS", window=3, dist="norm"),
            0.0, NORM_ATOL),
    "standardized_precipitation_index": (
        lambda m, a: m.standardized_precipitation_index(
            a["pr"], freq="MS", window=2, dist="norm"), 0.0, NORM_ATOL),
    "spei": (lambda m, a: m.spei(a["wb"], freq="MS", window=3), 0.0,
             SPEI_ATOL),
    "standardized_precipitation_evapotranspiration_index": (
        lambda m, a: m.standardized_precipitation_evapotranspiration_index(
            a["wb"], freq="MS", window=2), 0.0, SPEI_ATOL),
    # wind
    "calm_days": (lambda m, a: m.calm_days(a["sfcWind"], thresh="3 m/s")),
    "windy_days": (lambda m, a: m.windy_days(a["sfcWind"], thresh="7 m/s")),
    "sfcWind_max": (lambda m, a: m.sfcWind_max(a["sfcWind"])),
    "sfcWind_mean": (lambda m, a: m.sfcWind_mean(a["sfcWind"], freq="MS")),
    "sfcWind_min": (lambda m, a: m.sfcWind_min(a["sfcWind"])),
    "sfcWindmax_max": (lambda m, a: m.sfcWindmax_max(a["sfcWindmax"])),
    "sfcWindmax_mean": (lambda m, a: m.sfcWindmax_mean(a["sfcWindmax"])),
    "sfcWindmax_min": (lambda m, a: m.sfcWindmax_min(a["sfcWindmax"],
                                                     freq="QS-DEC")),
    # synoptic
    "jetstream_metric_woollings": (
        lambda m, a: m.jetstream_metric_woollings(a["ua"]), RTOL, 1e-6),
}


def _run(table, name, jmod, tmod, fields):
    spec = table[name]
    fn, rtol, atol = (spec[0], spec[1], spec[2]) if isinstance(spec, tuple) \
        else (spec, RTOL, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fn(jmod, {k: v[0] for k, v in fields.items()})
        got = fn(tmod, {k: v[1] for k, v in fields.items()})
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(PRECIP))
def test_atmos_indicators_against_reference(fields, name):
    _run(PRECIP, name, jatmos, atmos, fields)


CONVERT = {
    # degC values near 0 from K ones: one ulp of ~290 K is 3e-5
    "humidex": (lambda m, a: m.humidex(a["tas"], tdps=a["tdps"]), RTOL, 1e-4),
    "heat_index": (lambda m, a: m.heat_index(a["tas"], a["hurs"])),
    "tg": lambda m, a: m.tg(a["tasmin"], a["tasmax"]),
    "mean_temperature_from_max_and_min": lambda m, a:
        m.mean_temperature_from_max_and_min(a["tasmin"], a["tasmax"]),
    "uas_vas_to_sfcwind": (lambda m, a: m.uas_vas_to_sfcwind(a["uas"],
                                                             a["vas"]),
                           RTOL, 1e-4),
    "sfcwind_to_uas_vas": (lambda m, a: m.sfcwind_to_uas_vas(
        a["sfcWind"], a["sfcWindfromdir"]), RTOL, 1e-6),
    "saturation_vapor_pressure": (lambda m, a: m.saturation_vapor_pressure(
        a["tas"]), ESAT_RTOL, 0.0),
    "relative_humidity": (lambda m, a: m.relative_humidity(
        a["tas"], huss=a["huss"], ps=a["ps"]), ESAT_RTOL, 0.0),
    "relative_humidity_from_dewpoint": (
        lambda m, a: m.relative_humidity_from_dewpoint(a["tas"],
                                                       tdps=a["tdps"]),
        ESAT_RTOL, 0.0),
    "specific_humidity": (lambda m, a: m.specific_humidity(
        a["tas"], a["hurs"], a["ps"]), ESAT_RTOL, 0.0),
    "specific_humidity_from_dewpoint": (
        lambda m, a: m.specific_humidity_from_dewpoint(a["tdps"], a["ps"])),
    "snowfall_approximation": (lambda m, a: m.snowfall_approximation(
        a["pr"], a["tas"], method="brown")),
    "rain_approximation": (lambda m, a: m.rain_approximation(a["pr"],
                                                             a["tas"])),
    "snd_to_snw": lambda m, a: m.snd_to_snw(a["snd"]),
    "snw_to_snd": lambda m, a: m.snw_to_snd(a["snw"]),
    "wind_chill_index": (lambda m, a: m.wind_chill_index(a["tas"],
                                                         a["sfcWind"]),
                         RTOL, 1e-5),
    "potential_evapotranspiration": (
        lambda m, a: m.potential_evapotranspiration(
            tasmin=a["tasmin"], tasmax=a["tasmax"], method="HG85"),
        RTOL, 1e-11),
    "water_budget": (lambda m, a: m.water_budget(
        a["pr"], evspsblpot=a["evspsblpot"])),
    "water_budget_from_tas": (lambda m, a: m.water_budget_from_tas(
        a["pr"], tasmin=a["tasmin"], tasmax=a["tasmax"], method="BR65"),
        RTOL, 1e-11),
    "universal_thermal_climate_index": (
        lambda m, a: m.universal_thermal_climate_index(
            a["tas"], a["hurs"], a["sfcWind"], rsds=a["rsds"],
            rsus=a["rsus"], rlds=a["rlds"], rlus=a["rlus"]), 0.0, UTCI_ATOL),
    "mean_radiant_temperature": lambda m, a: m.mean_radiant_temperature(
        a["rsds"], a["rsus"], a["rlds"], a["rlus"]),
    "wind_profile": lambda m, a: m.wind_profile(a["sfcWind"], h="100 m",
                                                h_r="10 m"),
    "wind_power_potential": (lambda m, a: m.wind_power_potential(
        a["sfcWindmax"]), RTOL, 1e-6),
    "vapor_pressure": lambda m, a: m.vapor_pressure(a["huss"], a["ps"]),
    "vapor_pressure_deficit": (lambda m, a: m.vapor_pressure_deficit(
        a["tas"], a["hurs"]), ESAT_RTOL, 1e-3),
    "tdps_from_huss": lambda m, a: m.tdps_from_huss(a["huss"], a["ps"]),
    "longwave_upwelling_radiation_from_net_downwelling": lambda m, a:
        m.longwave_upwelling_radiation_from_net_downwelling(
            a["rlds"], a["rlus"]),
    "shortwave_upwelling_radiation_from_net_downwelling": lambda m, a:
        m.shortwave_upwelling_radiation_from_net_downwelling(
            a["rsus"], a["rsds"]),
    "clearness_index": lambda m, a: m.clearness_index(a["rsds"]),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_convert_indicators_against_reference(fields, name):
    _run(CONVERT, name, jconvert, convert, fields)


# -- the reference's oracle inputs -------------------------------------------


@pytest.mark.parametrize("phase", [None, "liquid", "solid"])
def test_precip_suite_grid(phase):
    """tests/test_precip_suite.py's grid (its builder) with a NaN hole."""
    pr, _ = ref_precip.with_nan(ref_precip.pr_grid3d(seed=3))
    tas = ref_precip.pr_grid3d(seed=4)
    tas = tas.copy(data=tas.data * 0 + 270.0 + 10 * jnp.sin(
        jnp.arange(tas.shape[0], dtype=jnp.float32) / 20.0)[:, None, None])
    tas.attrs = {"units": "K", "standard_name": "air_temperature",
                 "cell_methods": "time: mean"}
    tas.name = "tas"
    kw = {} if phase is None else {"tas": tas, "phase": phase}
    pkw = {} if phase is None else {"tas": to_port(tas), "phase": phase}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jatmos.precip_accumulation(pr, **kw)
        got = atmos.precip_accumulation(to_port(pr), **pkw)
    close(got, want)
    for name in ("cdd", "cwd", "daily_pr_intensity", "wetdays"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            close(getattr(atmos, name)(to_port(pr)),
                  getattr(jatmos, name)(pr))


def test_preciptemp_oracle_series(pr_series, tasmin_series,
                                  evspsblpot_series):
    """tests/test_preciptemp_suite.py's series: high_precip_low_temp and
    the aridity index on the reference's fixtures."""
    pr = pr_series(np.array([0, 1, 2, 0.5, 2, 5, 10]) / 86400 * 3,
                   start="2001-01-01")
    tn = tasmin_series(np.array([0, -1, -3, 5, 10, -1, -5]) + 273.15,
                       start="2001-01-01")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        close(atmos.high_precip_low_temp(to_port(pr), to_port(tn)),
              jatmos.high_precip_low_temp(pr, tn))
        p2 = pr_series(np.full(365, 2 / 86400), start="2001-01-01")
        pet = evspsblpot_series(np.full(365, 4 / 86400), start="2001-01-01")
        got = atmos.aridity_index(to_port(p2), to_port(pet))
        close(got, jatmos.aridity_index(p2, pet))
    np.testing.assert_allclose(got.values[0], 0.5, rtol=1e-5)


# -- the fused chain ---------------------------------------------------------

#: bench.py:565-578, the registry steps of the fused chain
CHAIN = [("TG_MEAN", "tas", {"freq": "MS"}),
         ("TX_DAYS_ABOVE", "tasmax", {"thresh": "25 degC", "freq": "YS"}),
         ("FROST_DAYS", "tasmin", {"freq": "YS"}),
         ("ICE_DAYS", "tasmax", {"freq": "YS"}),
         ("GROWING_DEGREE_DAYS", "tas", {"thresh": "4 degC", "freq": "YS"}),
         ("HEATING_DEGREE_DAYS", "tas", {"thresh": "17 degC", "freq": "YS"}),
         ("COOLING_DEGREE_DAYS", "tas", {"thresh": "18 degC", "freq": "YS"}),
         ("HEAT_WAVE_INDEX", "tasmax", {"freq": "YS"}),
         ("CDD", "pr", {"freq": "YS"}),
         ("PRCPTOT", "pr", {"freq": "YS"})]


def _chain_inputs(side=8, years=3):
    """tas N(285, 6), tasmax N(291, 6), tasmin N(279, 6) K and pr =
    |N(3e-5, 2e-5)| kg m-2 s-1, as bench.py's cfg_fused_chain builds them."""
    n = 365 * years
    t = jdate_range("2000-01-01", periods=n, freq="D", calendar="noleap")
    out = {}
    for seed, (name, mu, sd, units) in enumerate(
            (("tas", 285.0, 6.0, "K"), ("tasmax", 291.0, 6.0, "K"),
             ("tasmin", 279.0, 6.0, "K"),
             ("pr", 3e-5, 2e-5, "kg m-2 s-1"))):
        x = np.random.default_rng(20 + seed).normal(
            mu, sd, (n, side, side)).astype(np.float32)
        if name == "pr":
            x = np.abs(x)
        j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"), {"time": t},
                       {"units": units}, name)
        out[name] = (j, to_port(j))
    return out


def _chain(reg, chain_fn, arrays):
    names = list(arrays)

    def make_step(ind, var, kw):
        def step(*data):
            d = {}
            for k, x in zip(names, data):
                a = arrays[k].copy(data=x)
                a.attrs = dict(arrays[k].attrs)
                a.name = k
                d[k] = a
            return reg[ind](d[var], **kw)
        return step

    return chain_fn([make_step(*s) for s in CHAIN])


def test_chain_registry_keys_resolve_as_in_the_reference():
    for key, _, _ in CHAIN:
        assert registry[key].identifier == jregistry[key].identifier
        assert registry[key]._registry_id == jregistry[key]._registry_id
        assert type(registry[key]).__name__ == type(jregistry[key]).__name__


def test_fused_chain_against_reference():
    from xclim_tpu import climjit_chain as jclimjit_chain

    arrays = _chain_inputs()
    jarr = {k: v[0] for k, v in arrays.items()}
    tarr = {k: v[1] for k, v in arrays.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _chain(jregistry, jclimjit_chain, jarr)(
            *[a.data for a in jarr.values()])
        fused = _chain(registry, climjit_chain, tarr)
        got = fused(*[a.data for a in tarr.values()])
    assert fused.partition == [(0, len(CHAIN))]
    assert len(got) == len(want) == len(CHAIN)
    for g, w in zip(got, want):
        close(g, w)


def test_climjit_chain_partition():
    steps = [lambda x: x + 1, lambda x: (x * 2, x * 3), lambda x: x - 1]
    fused = climjit_chain(steps)
    assert fused.partition == [(0, 3)]
    assert fused(torch.tensor(1.0)) == (2.0, 2.0, 3.0, 0.0)
    assert climjit_chain([]).partition == [(0, 0)]
