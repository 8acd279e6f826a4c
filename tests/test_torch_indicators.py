"""The port's indicator path against the JAX package's on the same numpy
inputs: the ``indices/_simple.py`` functions, and the public atmos
indicators with their missing-value masks, CF attributes, time indexers and
French metadata. Data agree within 1e-6 with the same NaN pattern; attrs are
equal, the history line after its timestamp and package name are removed.
"""

import re
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.indicators.atmos as jatmos
from xclim_tpu import indices as jindices
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.dataarray import ClimDataset as JClimDataset
from xclim_tpu.core.options import set_options as jset_options
from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
from xclim_tpu_torch import indices
from xclim_tpu_torch.core import indicator as indicator_mod
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.options import set_options
from xclim_tpu_torch.core.percentiles import from_reference_percentiles
from xclim_tpu_torch.indicators import atmos

NY, NX = 3, 3
CALENDARS = ["noleap", "360_day", "standard"]
FREQS = ["MS", "YS", "QS-DEC"]
VARS = {"tas": ("air_temperature", "time: mean"),
        "tasmax": ("air_temperature", "time: maximum"),
        "tasmin": ("air_temperature", "time: minimum")}


def _pair(name, cal="noleap", seed=0, years=2, units="K", mu=285.0, sd=8.0,
          holes=True):
    """One seeded numpy series as a port and a reference ClimArray: 1 %
    scattered NaN holes and a 4-day gap in lane (1, 1), an all-NaN lane
    (2, 2) and a fully valid lane (0, 0)."""
    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * years
    if cal == "standard":
        n += 1
    rng = np.random.default_rng(seed)
    x = rng.normal(mu, sd, (n, NY, NX)).astype(np.float32)
    if holes:
        x[rng.random(x.shape) < 0.01] = np.nan
        x[40:44, 1, 1] = np.nan
        x[:, 2, 2] = np.nan
        x[:, 0, 0] = np.abs(x[:, 0, 0])
    sn, cm = VARS.get(name, (None, None))
    attrs = {"units": units}
    if sn:
        attrs.update(standard_name=sn, cell_methods=cm)
    dims = ("time", "lat", "lon")
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": date_range("2000-01-01", periods=n, calendar=cal)},
                  attrs, name)
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jdate_range("2000-01-01", periods=n,
                                        calendar=cal)}, attrs, name)
    return a, b


_HISTORY_STAMP = re.compile(r"\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")
_HISTORY_PKG = re.compile(r" - xclim_tpu(_torch)? version: \S+")


def _history(h):
    return _HISTORY_PKG.sub("", _HISTORY_STAMP.sub("", h))


def _same(got, exp, rtol=1e-6):
    assert got.dims == exp.dims and got.name == exp.name
    g, e = got.values, np.asarray(exp.data)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    # monthly and annual means of ~285 K: the reference sums in float32,
    # the port in float64 rounded once (1e-6, SURVEY §6)
    np.testing.assert_allclose(g, e.astype(g.dtype), rtol=rtol,
                               equal_nan=True)
    if "time" in got.dims:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())
    ga, ea = dict(got.attrs), dict(exp.attrs)
    assert ("history" in ga) == ("history" in ea)
    if "history" in ea:
        assert _history(ga.pop("history")) == _history(ea.pop("history"))
    assert ga == ea


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


# (function, variable, units, mu, sd, extra kwargs)
SIMPLE = [
    ("tg_max", "tas", "K", 285, 8, {}), ("tg_mean", "tas", "K", 285, 8, {}),
    ("tg_min", "tas", "K", 285, 8, {}), ("tn_max", "tasmin", "K", 280, 8, {}),
    ("tn_mean", "tasmin", "K", 280, 8, {}),
    ("tn_min", "tasmin", "K", 280, 8, {}),
    ("tx_max", "tasmax", "K", 290, 8, {}),
    ("tx_mean", "tasmax", "K", 290, 8, {}),
    ("tx_min", "tasmax", "K", 290, 8, {}),
    ("hot_days", "tasmax", "degC", 22, 6, {"thresh": "25 degC"}),
    ("frost_days", "tasmin", "degC", 2, 6, {}),
    ("frost_days", "tasmin", "K", 275, 6, {"thresh": "270 K", "month": [1, 2]}),
    ("ice_days", "tasmax", "K", 275, 6, {}),
    ("max_1day_precipitation_amount", "pr", "mm/d", 3, 2, {}),
    ("max_n_day_precipitation_amount", "pr", "mm/d", 3, 2, {"window": 5}),
    ("max_pr_intensity", "pr", "mm/h", 0.5, 0.2, {"window": 3}),
    ("snow_depth", "snd", "m", 0.5, 0.2, {}),
    ("sfcWind_max", "sfcWind", "m s-1", 5, 2, {}),
    ("sfcWind_mean", "sfcWind", "m s-1", 5, 2, {}),
    ("sfcWind_min", "sfcWind", "m s-1", 5, 2, {}),
    ("sfcWindmax_max", "sfcWindmax", "m s-1", 9, 3, {}),
    ("sfcWindmax_mean", "sfcWindmax", "m s-1", 9, 3, {}),
    ("sfcWindmax_min", "sfcWindmax", "m s-1", 9, 3, {}),
]


@pytest.mark.parametrize("freq", ["MS", "YS"])
@pytest.mark.parametrize("fn,var,units,mu,sd,kw", SIMPLE,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(SIMPLE)])
def test_simple_index_matches_reference(fn, var, units, mu, sd, kw, freq):
    a, b = _pair(var, seed=len(fn), units=units, mu=mu, sd=sd)
    got = getattr(indices, fn)(a, freq=freq, **kw)
    exp = getattr(jindices, fn)(b, freq=freq, **kw)
    _same(got, exp)


INDICATORS = [("tg_mean", "tas", 285), ("tg_max", "tas", 285),
              ("tg_min", "tas", 285), ("tx_mean", "tasmax", 290),
              ("tx_max", "tasmax", 290), ("tx_min", "tasmax", 290),
              ("tn_mean", "tasmin", 280), ("tn_max", "tasmin", 280),
              ("tn_min", "tasmin", 280), ("frost_days", "tasmin", 275),
              ("hot_days", "tasmax", 296), ("ice_days", "tasmax", 275)]


@pytest.mark.parametrize("cal", CALENDARS)
@pytest.mark.parametrize("name,var,mu", INDICATORS,
                         ids=[i[0] for i in INDICATORS])
def test_atmos_indicator_matches_reference(name, var, mu, cal):
    freq = FREQS[len(name) % 3]
    a, b = _pair(var, cal=cal, seed=len(name), mu=mu)
    got = getattr(atmos, name)(a, freq=freq)
    exp = getattr(jatmos, name)(b, freq=freq)
    assert got.data.dtype == torch.float32
    _same(got, exp)


@pytest.mark.parametrize("cal", CALENDARS)
@pytest.mark.parametrize("freq", FREQS)
def test_tg_mean_every_freq_and_calendar(freq, cal):
    a, b = _pair("tas", cal=cal, seed=3)
    _same(atmos.tg_mean(a, freq=freq), jatmos.tg_mean(b, freq=freq))


@pytest.mark.parametrize("name,var,mu,kw", [
    ("tg_mean", "tas", 285, {"freq": "YS", "month": [6, 7, 8]}),
    ("tg_mean", "tas", 285, {"freq": "YS", "season": "JJA"}),
    ("tx_max", "tasmax", 290, {"freq": "YS-DEC", "season": "DJF"}),
    ("tn_min", "tasmin", 280, {"freq": "MS", "doy_bounds": (32, 120)}),
    ("frost_days", "tasmin", 275, {"freq": "YS", "month": [1, 2]}),
    ("frost_days", "tasmin", 275, {"freq": "MS", "thresh": "273 K"}),
    ("hot_days", "tasmax", 296, {"freq": "QS-DEC", "thresh": "30 degC"}),
], ids=["tg_mean-month", "tg_mean-season", "tx_max-DJF", "tn_min-doy",
        "frost_days-month", "frost_days-thresh", "hot_days-thresh"])
def test_indexers_and_thresholds(name, var, mu, kw):
    a, b = _pair(var, cal="standard", seed=5, mu=mu)
    _same(getattr(atmos, name)(a, **kw), getattr(jatmos, name)(b, **kw))


@pytest.mark.parametrize("name,var,mu", [("tg_mean", "tas", 285),
                                         ("frost_days", "tasmin", 275),
                                         ("tx_max", "tasmax", 290)])
def test_french_metadata(name, var, mu):
    a, b = _pair(var, seed=7, mu=mu)
    with set_options(metadata_locales=["fr"]):
        got = getattr(atmos, name)(a, freq="MS")
    with jset_options(metadata_locales=["fr"]):
        exp = getattr(jatmos, name)(b, freq="MS")
    assert "long_name_fr" in got.attrs
    _same(got, exp)


@pytest.mark.parametrize("method,opts", [("pct", {"tolerance": 0.05}),
                                         ("wmo", {}), ("skip", None)])
def test_missing_option(method, opts):
    a, b = _pair("tas", seed=9)
    kw = {"check_missing": method}
    if opts is not None:
        kw["missing_options"] = {method: opts}
    with set_options(**kw):
        got = atmos.tg_mean(a, freq="MS")
    with jset_options(**kw):
        exp = jatmos.tg_mean(b, freq="MS")
    _same(got, exp)


def test_dataset_input():
    a, b = _pair("tas", seed=11)
    got = atmos.tg_mean(ds=ClimDataset({"tas": a}), freq="YS")
    exp = jatmos.tg_mean(ds=JClimDataset({"tas": b}), freq="YS")
    _same(got, exp)


def test_non_daily_input_is_refused_like_the_reference():
    a, b = _pair("tas", seed=13)
    a2, b2 = a.isel(time=slice(0, None, 2)), b.isel(time=slice(0, None, 2))
    with pytest.raises(Exception) as got:
        _quiet(atmos.tg_mean, a2, freq="MS")
    with pytest.raises(Exception) as exp:
        _quiet(jatmos.tg_mean, b2, freq="MS")
    assert type(got.value).__name__ == type(exp.value).__name__
    assert str(got.value) == str(exp.value)


def test_registry_and_test_indicators():
    keys = {k for k, v in indicator_mod.registry.items() if v.module is None}
    assert {i[0].upper() for i in INDICATORS} <= keys
    assert atmos.tg_mean._registry_id == "atmos.TG_MEAN"
    ind = indicator_mod.Daily(
        identifier="tg_mean_test", module="test", realm="atmos", units="K",
        cell_methods="time: mean over days",
        description="{freq} mean of daily mean temperature.",
        compute=indices.tg_mean)
    assert indicator_mod.registry["test.TG_MEAN_TEST"] is ind
    assert "TG_MEAN_TEST" not in indicator_mod.registry
    a, _ = _pair("tas", seed=15)
    out = ind(a, freq="YS")
    assert out.name == "tg_mean_test"
    assert out.attrs["description"] == "Annual mean of daily mean temperature."


# (indicator, variable, mean, percentile, extra kwargs)
PERCENTILE_INDICATORS = [
    ("tg90p", "tas", 285, 90, {}), ("tg10p", "tas", 285, 10, {}),
    ("tx90p", "tasmax", 290, 90, {}), ("tx10p", "tasmax", 290, 10, {}),
    ("tn90p", "tasmin", 280, 90, {}), ("tn10p", "tasmin", 280, 10, {}),
    ("warm_spell_duration_index", "tasmax", 290, 90, {"window": 2}),
    ("cold_spell_duration_index", "tasmin", 280, 10, {"window": 2})]


@pytest.mark.parametrize("bootstrap", [False, True])
@pytest.mark.parametrize("cal", ["noleap", "standard"])
@pytest.mark.parametrize("name,var,mu,per,kw", PERCENTILE_INDICATORS,
                         ids=[i[0] for i in PERCENTILE_INDICATORS])
def test_percentile_indicator_matches_reference(name, var, mu, per, kw, cal,
                                                bootstrap):
    # the same percentiles for both packages: the reference's, computed
    # over the first three of four years and carried into the port
    a, b = _pair(var, cal=cal, seed=len(name), years=4, mu=mu)
    jper = jpercentile_doy(b.sel_time(mask=b.time.year < 2003), window=5,
                           per=per)
    per_arr = from_reference_percentiles(np.asarray(jper.data), jper.dims,
                                         jper.coords, jper.attrs,
                                         device="cpu")
    got = getattr(atmos, name)(a, per_arr, freq="YS", bootstrap=bootstrap,
                               **kw)
    exp = getattr(jatmos, name)(b, jper, freq="YS", bootstrap=bootstrap,
                                **kw)
    assert got.data.dtype == torch.float32
    assert "2000-01-01 to 2002-12-31" in got.attrs["description"] \
        or "window" in kw
    _same(got, exp)


# ---------------------------------------------------------------------------
# the threshold, spell, season and degree-day temperature indicators
# ---------------------------------------------------------------------------

import xclim_tpu.indicators.atmos._temperature as jtemperature  # noqa: E402
from xclim_tpu_torch.indicators.atmos import _temperature as temperature  # noqa: E402

#: the fire season, held against the reference in tests/test_torch_fire.py
#: on inputs it takes (a seasonal cycle, snow depth)
FIRE = {"fire_season"}
#: the agroclimatic indicators, held against the reference in
#: tests/test_torch_agro.py on inputs they take (a lat coordinate, hourly
#: temperature, 30-year windows)
AGRO = {"huglin_index", "biologically_effective_degree_days",
        "latitude_temperature_index", "cool_night_index", "corn_heat_units",
        "effective_growing_degree_days", "cp", "cu", "usda_hardiness_zones",
        "australian_hardiness_zones"}
MU = {"tas": 283, "tasmax": 289, "tasmin": 277, "pr": 3}
#: indicators whose output is a float sum or mean: held at rtol 5e-7, a
#: few float32 ulps (the port sums in float64 and rounds once, the
#: reference adds float32 partials; test_torch_threshold.py); the others
#: (counts, run lengths, days of year, extremes) are exact
SUM_INDICATORS = {"cooling_degree_days", "heating_degree_days",
                  "growing_degree_days", "freezing_degree_days",
                  "thawing_degree_days", "cooling_degree_days_approximation",
                  "heating_degree_days_approximation", "hot_spell_max_magnitude",
                  "daily_temperature_range", "daily_temperature_range_variability",
                  "freezethaw_spell_mean_length"}
THRESHOLD_INDICATORS = sorted(
    n for n in temperature.__all__
    if not any(v.endswith("_per") for v in getattr(atmos, n)._variables)
    and n not in {i[0] for i in INDICATORS} and n not in AGRO | FIRE)


def test_temperature_module_names_and_declarations():
    assert temperature.__all__ == jtemperature.__all__
    for name in temperature.__all__:
        got, exp = getattr(atmos, name), getattr(jatmos, name)
        assert got.identifier == exp.identifier
        assert got._registry_id == exp._registry_id
        assert got.cf_attrs == exp.cf_attrs
        assert got._variables == exp._variables
        assert {k: (p.default, p.injected) for k, p in got.parameters.items()} \
            == {k: (p.default, p.injected) for k, p in exp.parameters.items()}
    keys = {k for k, v in indicator_mod.registry.items() if v.module is None}
    assert {"TX_DAYS_ABOVE", "HEAT_WAVE_FREQUENCY", "CONSECUTIVE_FROST_DAYS",
            "DTR", "HEAT_SPELL_FREQUENCY"} <= keys
    assert atmos.consecutive_frost_days is atmos.maximum_consecutive_frost_days
    assert atmos.daily_freezethaw_cycles is atmos.dlyfrzthw


@pytest.mark.parametrize("name", THRESHOLD_INDICATORS)
def test_threshold_indicator_matches_reference(name):
    ind = getattr(atmos, name)
    args, jargs = {}, {}
    for i, var in enumerate(ind._variables):
        a, b = _pair(var, seed=len(name) + i, years=3, mu=MU[var],
                     units="mm/d" if var == "pr" else "K")
        args[var], jargs[var] = a, b
    got = _quiet(ind, **args)
    exp = _quiet(getattr(jatmos, name), **jargs)
    outs = got if isinstance(got, tuple) else (got,)
    exps = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(outs, exps):
        if name in SUM_INDICATORS:
            _same(g, e, rtol=5e-7)
        else:
            _same(g, e, rtol=0)


@pytest.mark.parametrize("cal", ["standard", "360_day"])
@pytest.mark.parametrize("name,kw", [
    ("tx_days_above", {"thresh": "77 degF", "freq": "MS"}),
    ("heat_wave_frequency", {"thresh_tasmin": "283 K",
                             "thresh_tasmax": "295 K", "window": 2}),
    ("growing_season_length", {}),
    ("frost_free_season_start", {"thresh": "2 degC"}),
], ids=["tx_days_above", "heat_wave_frequency", "growing_season_length",
        "frost_free_season_start"])
def test_threshold_indicators_other_calendars(name, kw, cal):
    ind = getattr(atmos, name)
    args, jargs = {}, {}
    for i, var in enumerate(ind._variables):
        args[var], jargs[var] = _pair(var, cal=cal, seed=40 + i, mu=MU[var])
    _same(_quiet(ind, **args, **kw), _quiet(getattr(jatmos, name), **jargs, **kw),
          rtol=0)
