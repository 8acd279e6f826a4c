"""The port's ``indices/helpers.py`` and ``indices/converters.py`` against
the JAX package's, on the same numpy inputs: seeded fields (2 noleap
years x 3 latitudes x 4 longitudes, 1 % NaN) and the oracle inputs of the
reference's own converter tests (``tests/test_converter_matrix.py``,
``test_converter_methods.py``, ``test_converters.py``,
``test_solar_helpers.py``), read from those files' helpers and
parametrize marks.

Bounds. The solar geometry is the same float64 numpy on both sides, cast
to float32 at the same point: equal. Elementwise physics holds to
``RTOL`` (1e-6) relative, except where a stated float32 effect moves it:

- ``ESAT_RTOL`` (1e-5): Sonntag, Goff-Gratch and ITS-90 sum terms of
  magnitude ~20 that cancel to the exponent (or the log10 power) of
  e_sat; one float32 ulp of those terms (1.9e-6) is a relative error of
  e_sat, and XLA:CPU evaluates exp, log and pow by other polynomials than
  torch does. Relative humidity, specific humidity and VPD inherit it.
- ``FRAC_ATOL`` (2e-6 of the precipitation scale): the Dai and Auer
  phase fractions cancel near 0 (tanh(b (t - c)) - d with d ~ 1.02; the
  Auer polynomial near its root), so the fraction is held absolutely.
- ``UTCI_ATOL``: the 210-term UTCI polynomial adds terms whose partial
  sums reach ~1e2 degC; XLA:CPU may contract ``c*a*b + s`` into FMAs
  (ROADMAP Queue 3 saw the same in the quantile), so each term may round
  by half an ulp of the partial sum differently (~4e-6 degC each): held
  within 2.5e-3 K.
- Outputs that cancel to ~0 (PET, the US wind chill near its threshold,
  uas/vas direction near 0/360) are held with an absolute term of 1e-6 of
  their scale; FAO-PM98's PET takes e_sat by Sonntag, so ESAT_RTOL of its
  scale.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_converter_matrix as ref_matrix
import test_converter_methods as ref_methods
import test_converters as ref_conv
import test_solar_helpers as ref_solar
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import converters as jconv
from xclim_tpu.indices import helpers as jhelpers
from xclim_tpu_torch.core.calendar import TimeIndex
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indices import converters as conv
from xclim_tpu_torch.indices import helpers

RTOL = 1e-6
ESAT_RTOL = 1e-5
FRAC_ATOL = 2e-6
UTCI_ATOL = 2.5e-3
NT = 730
LAT = np.array([10.0, 45.0, -70.0])
LON = np.array([0.0, 90.0, 180.0, 270.0])


def to_port(j):
    """A reference ClimArray as the port's, on the CPU (same numpy data,
    the same time coordinate)."""
    coords = {}
    for k, v in j.coords.items():
        if hasattr(v, "calendar") and hasattr(v, "year"):
            coords[k] = TimeIndex(v.year, v.month, v.day, v.hour, v.minute,
                                  v.second, v.calendar)
        else:
            coords[k] = np.asarray(v)
    return ClimArray(torch.as_tensor(np.array(j.data)), j.dims, coords,
                     dict(j.attrs), j.name)


_HISTORY_STAMP = re.compile(r"\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")
_HISTORY_PKG = re.compile(r" - xclim_tpu(_torch)? version: \S+")


def _attrs(a):
    """attrs with the history line's timestamp and package name removed."""
    a = dict(a)
    if "history" in a:
        a["history"] = _HISTORY_PKG.sub("", _HISTORY_STAMP.sub("", a["history"]))
    return a


def close(got, exp, rtol=RTOL, atol=0.0):
    """Values within atol + rtol |exp|, NaN where the reference's are, and
    the same dims, name, attrs (history but for its timestamp and package
    name) and time coordinate."""
    if isinstance(exp, tuple):
        assert isinstance(got, tuple) and len(got) == len(exp)
        for g, e in zip(got, exp):
            close(g, e, rtol, atol)
        return
    assert got.dims == exp.dims and got.name == exp.name
    assert _attrs(got.attrs) == _attrs(exp.attrs)
    g, e = got.values.astype(np.float64), np.asarray(exp.data, np.float64)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    np.testing.assert_allclose(g, e, rtol=rtol, atol=atol, equal_nan=True)
    if "time" in exp.coords:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())


def _field(name, units, mu, sd, seed, positive=False, attrs=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(mu, sd, (NT, len(LAT), len(LON))).astype(np.float32)
    if positive:
        x = np.abs(x)
    x[rng.random(x.shape) < 0.01] = np.nan
    t = jdate_range("2000-01-01", periods=NT, calendar="noleap")
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": LAT, "lon": LON},
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


FIELDS = {
    "tas": ("K", 285.0, 10.0, False, None),
    "tdps": ("K", 278.0, 5.0, False, None),
    "tasmax": ("K", 291.0, 10.0, False, None),
    "tasmin": ("K", 279.0, 10.0, False, None),
    "hurs": ("%", 70.0, 15.0, False, None),
    "huss": ("1", 0.008, 0.002, True, None),
    "ps": ("Pa", 101000.0, 800.0, False, None),
    "pr": ("kg m-2 s-1", 3e-5, 2e-5, True,
           {"standard_name": "precipitation_flux"}),
    "sfcWind": ("m s-1", 5.0, 3.0, True, None),
    "uas": ("m s-1", 0.0, 4.0, False, None),
    "vas": ("m s-1", 0.0, 4.0, False, None),
    "rsds": ("W m-2", 200.0, 80.0, True, None),
    "rsus": ("W m-2", 40.0, 10.0, True, None),
    "rlds": ("W m-2", 300.0, 30.0, True, None),
    "rlus": ("W m-2", 380.0, 30.0, True, None),
    "snd": ("m", 0.3, 0.1, True, {"standard_name": "surface_snow_thickness"}),
    "snw": ("kg m-2", 90.0, 30.0, True,
            {"standard_name": "surface_snow_amount"}),
}


@pytest.fixture(scope="module")
def fields():
    """name -> (reference ClimArray, port ClimArray)."""
    return {k: _field(k, *v[:3], seed=i, positive=v[3], attrs=v[4])
            for i, (k, v) in enumerate(FIELDS.items())}


def _u(x, units):
    """x with its units set (arithmetic on a ClimArray drops its attrs)."""
    x.attrs = {"units": units}
    return x


def _pr_scale(f):
    return FRAC_ATOL * float(np.nanmax(np.asarray(f["pr"][0].data)))


#: case -> (call on a converters module and a dict of inputs, rtol, atol
#: as a function of the fields or a number)
CASES = {
    "humidex_tdps": (lambda m, a: m.humidex(a["tas"], tdps=a["tdps"]),
                     RTOL, 0.0),
    "humidex_hurs": (lambda m, a: m.humidex(a["tas"], hurs=a["hurs"]),
                     RTOL, 0.0),
    "heat_index": (lambda m, a: m.heat_index(a["tas"], a["hurs"]), RTOL, 0.0),
    "tas_from_tasmin_tasmax": (lambda m, a: m.tas_from_tasmin_tasmax(
        a["tasmin"], a["tasmax"]), 0.0, 0.0),
    "tas_alias": (lambda m, a: m.tas(a["tasmin"], a["tasmax"]), 0.0, 0.0),
    "uas_vas_to_sfcwind": (lambda m, a: m.uas_vas_to_sfcwind(
        a["uas"], a["vas"]), RTOL, 1e-4),
    "sfcwind_to_uas_vas": (lambda m, a: m.sfcwind_to_uas_vas(
        a["sfcWind"], _u(a["uas"] * 0 + 45.0, "degree")), RTOL, 1e-6),
    "esat_ice_interp": (lambda m, a: m.saturation_vapor_pressure(
        a["tas"], ice_thresh="-10 degC", interp_power=1.5), ESAT_RTOL, 0.0),
    "vapor_pressure": (lambda m, a: m.vapor_pressure(a["huss"], a["ps"]),
                       RTOL, 0.0),
    "vapor_pressure_deficit": (lambda m, a: m.vapor_pressure_deficit(
        a["tas"], a["hurs"]), ESAT_RTOL, 1e-3),
    "rh_dewpoint": (lambda m, a: m.relative_humidity(a["tas"],
                                                     tdps=a["tdps"]),
                    ESAT_RTOL, 0.0),
    "rh_bohren98": (lambda m, a: m.relative_humidity(
        a["tas"], tdps=a["tdps"], method="bohren98"), RTOL, 0.0),
    "rh_huss_mask": (lambda m, a: m.relative_humidity(
        a["tas"], huss=a["huss"], ps=a["ps"], invalid_values="mask"),
        ESAT_RTOL, 0.0),
    "specific_humidity_clip": (lambda m, a: m.specific_humidity(
        a["tas"], a["hurs"], a["ps"], invalid_values="clip"), ESAT_RTOL, 0.0),
    "specific_humidity_from_dewpoint": (
        lambda m, a: m.specific_humidity_from_dewpoint(a["tdps"], a["ps"]),
        RTOL, 0.0),
    "dewpoint_from_specific_humidity": (
        lambda m, a: m.dewpoint_from_specific_humidity(a["huss"], a["ps"]),
        RTOL, 0.0),
    "clearness_index": (lambda m, a: m.clearness_index(a["rsds"]), RTOL, 0.0),
    "rsds_from_clearness_index": (
        lambda m, a: m.shortwave_downwelling_radiation_from_clearness_index(
            _u(a["rsds"] * 0 + 0.5, "1")), RTOL, 0.0),
    "rlus_from_net": (
        lambda m, a: m.longwave_upwelling_radiation_from_net_downwelling(
            _u(a["rlds"] - a["rlus"], "W m-2"), a["rlds"]), 0.0, 0.0),
    "rsus_from_net": (
        lambda m, a: m.shortwave_upwelling_radiation_from_net_downwelling(
            _u(a["rsds"] - a["rsus"], "W m-2"), a["rsds"]), 0.0, 0.0),
    "wind_chill_can": (lambda m, a: m.wind_chill_index(a["tas"],
                                                       a["sfcWind"]),
                       RTOL, 1e-5),
    "wind_chill_us": (lambda m, a: m.wind_chill_index(
        a["tas"], a["sfcWind"], method="US", mask_invalid=False), RTOL, 1e-5),
    "clausius_clapeyron": (
        lambda m, a: m.clausius_clapeyron_scaled_precipitation(
            _u((a["tas"] - a["tasmin"]) * 0.1, "K"), a["pr"]), RTOL, 0.0),
    "snd_to_snw": (lambda m, a: m.snd_to_snw(a["snd"]), RTOL, 0.0),
    "snw_to_snd": (lambda m, a: m.snw_to_snd(a["snw"]), RTOL, 0.0),
    "prsn_to_prsnd": (lambda m, a: m.prsn_to_prsnd(a["pr"]), RTOL, 0.0),
    "prsnd_to_prsn": (lambda m, a: m.prsnd_to_prsn(
        m.prsn_to_prsnd(a["pr"])), RTOL, 0.0),
    "mean_radiant_temperature": (lambda m, a: m.mean_radiant_temperature(
        a["rsds"], a["rsus"], a["rlds"], a["rlus"]), RTOL, 0.0),
    "utci": (lambda m, a: m.universal_thermal_climate_index(
        a["tas"], a["hurs"], a["sfcWind"], rsds=a["rsds"], rsus=a["rsus"],
        rlds=a["rlds"], rlus=a["rlus"]), 0.0, UTCI_ATOL),
    "utci_wind_cap": (lambda m, a: m.universal_thermal_climate_index(
        a["tas"], a["hurs"], a["sfcWind"], mrt=_u(a["tas"] + 5.0, "K"),
        wind_cap_min=True, mask_invalid=False), 0.0, UTCI_ATOL),
    "water_budget_direct": (lambda m, a: m.water_budget(
        a["pr"], evspsblpot=_u(a["pr"] * 0.5, "kg m-2 s-1")), RTOL, 0.0),
    "water_budget_hg85": (lambda m, a: m.water_budget(
        a["pr"], tasmin=a["tasmin"], tasmax=a["tasmax"], method="HG85"),
        RTOL, 1e-11),
    "wind_profile": (lambda m, a: m.wind_profile(a["sfcWind"], "100 m",
                                                 "10 m"), RTOL, 0.0),
    "wind_power_potential": (lambda m, a: m.wind_power_potential(
        _u(a["sfcWind"] * 3.0, "m s-1")), RTOL, 1e-6),
    "wind_power_potential_rho": (lambda m, a: m.wind_power_potential(
        _u(a["sfcWind"] * 3.0, "m s-1"),
        air_density=_u(a["sfcWind"] * 0 + 1.2, "kg m-3")), RTOL, 1e-6),
}
for _method in ("sonntag90", "goffgratch46", "its90", "tetens30", "wmo08",
                "buck81", "aerk96", "ecmwf"):
    CASES[f"esat_{_method}"] = (
        lambda m, a, _me=_method: m.saturation_vapor_pressure(
            a["tas"], method=_me, ice_thresh="0 degC"), ESAT_RTOL, 0.0)
for _kind in ("snowfall", "rain"):
    for _method in ("binary", "brown", "auer", "dai_annual", "dai_seasonal"):
        CASES[f"{_kind}_{_method}"] = (
            lambda m, a, _k=_kind, _me=_method: getattr(
                m, f"{_k}_approximation")(a["pr"], a["tas"], method=_me),
            0.0, _pr_scale)
CASES["snowfall_dai_clip"] = (lambda m, a: m.snowfall_approximation(
    a["pr"], a["tas"], method="dai_annual", clip_temp="3 degC"), 0.0,
    _pr_scale)
CASES["rain_dai_ocean"] = (lambda m, a: m.rain_approximation(
    a["pr"], a["tas"], method="dai_seasonal", landmask=False), 0.0, _pr_scale)
for _method in ("BR65", "HG85", "DA02", "MB05", "TW48", "FAO_PM98"):
    CASES[f"pet_{_method}"] = (
        lambda m, a, _me=_method: m.potential_evapotranspiration(
            tasmin=a["tasmin"], tasmax=a["tasmax"], tas=a["tas"],
            hurs=a["hurs"], rsds=a["rsds"], rsus=a["rsus"], rlds=a["rlds"],
            rlus=a["rlus"], sfcWind=a["sfcWind"], pr=a["pr"], method=_me),
        RTOL, 1e-11)
# FAO-PM98 takes e_sat by Sonntag: ESAT_RTOL of its ~3e-5 kg m-2 s-1 scale
CASES["pet_FAO_PM98"] = CASES["pet_FAO_PM98"][:2] + (3e-10,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_converters_against_reference(fields, case):
    fn, rtol, atol = CASES[case]
    if callable(atol):
        atol = atol(fields)
    want = fn(jconv, {k: v[0] for k, v in fields.items()})
    got = fn(conv, {k: v[1] for k, v in fields.items()})
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close(got, want, rtol=rtol, atol=atol)


def test_landmask_blend_and_fao_allen98(fields):
    """A per-point land mask blends the land and ocean Dai fits; the raw
    FAO-56 formula takes ClimArrays, tensors or numbers."""
    jpr, tpr = fields["pr"]
    jtas, ttas = fields["tas"]
    mask = np.array([[True, False, True, False]] * 3)
    jm = JClimArray(jnp.asarray(mask), ("lat", "lon"), {}, {})
    tm = ClimArray(torch.as_tensor(mask), ("lat", "lon"), {}, {})
    close(conv.snowfall_approximation(tpr, ttas, method="dai_annual",
                                      landmask=tm),
          jconv.snowfall_approximation(jpr, jtas, method="dai_annual",
                                       landmask=jm),
          rtol=0.0, atol=_pr_scale(fields))
    args = [fields[k] for k in ("rsds", "tas", "sfcWind", "hurs", "hurs")]
    want = jconv.fao_allen98(*[a[0] for a in args], 0.1, 0.066)
    got = conv.fao_allen98(*[a[1] for a in args], 0.1, 0.066)
    close(got, want, rtol=RTOL)


# -- the reference's oracle inputs --------------------------------------------


def _marks(fn):
    """argnames -> list of argvalues of a reference test's parametrize
    marks (read, not edited)."""
    out = {}
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            out[mark.args[0]] = list(mark.args[1])
    return out


_SVP = _marks(ref_matrix.TestSaturationVaporPressureMatrix.test_values)


@pytest.mark.parametrize("temp_units", _SVP["temp_units"])
@pytest.mark.parametrize("ice_thresh,power,exp0", _SVP["ice_thresh,power,exp0"])
@pytest.mark.parametrize("method", _SVP["method"])
def test_saturation_vapor_pressure_oracle_matrix(method, ice_thresh, power,
                                                 exp0, temp_units):
    from xclim_tpu.core.units import convert_units_to as jconvert

    tas = ref_matrix._s(np.array([-30, -20, -10, -1, 10, 20, 25, 30, 40, 60])
                        + ref_matrix.K2C, "K")
    tas = jconvert(tas, temp_units)
    kw = dict(method=method, ice_thresh=ice_thresh, interp_power=power)
    want = jconv.saturation_vapor_pressure(tas, **kw)
    got = conv.saturation_vapor_pressure(to_port(tas), **kw)
    close(got, want, rtol=ESAT_RTOL)
    oracle = exp0 + [1228, 2339, 3169, 4247, 7385, 19947]
    vals = got.values
    if method == "tetens30":  # the reference's own exclusion
        vals, oracle = vals[1:], oracle[1:]
    np.testing.assert_allclose(vals, oracle, atol=0.5, rtol=0.005)


_RH = _marks(ref_matrix.TestRelativeHumidityMatrix.test_from_dewpoint)
_RHQ = _marks(ref_matrix.TestRelativeHumidityMatrix.test_from_specific_humidity)
_HUSS = _marks(ref_matrix.TestSpecificHumidityMatrix.test_values)


@pytest.mark.parametrize("invalid_values,exp0", _RH["invalid_values,exp0"])
@pytest.mark.parametrize("method", _RH["method"])
def test_relative_humidity_from_dewpoint_oracle(method, invalid_values, exp0):
    k = ref_matrix.K2C
    tas = ref_matrix._s(np.array([-20, -10, -1, 10, 20, 25, 30, 40, 60]) + k,
                        "K")
    tdps = ref_matrix._s(np.array([-15, -10, -2, 5, 10, 20, 29, 20, 30]) + k,
                         "K")
    kw = dict(method=method, invalid_values=invalid_values)
    want = jconv.relative_humidity(tas, tdps=tdps, **kw)
    got = conv.relative_humidity(to_port(tas), tdps=to_port(tdps), **kw)
    close(got, want, rtol=ESAT_RTOL)
    np.testing.assert_allclose(got.values,
                               [exp0, 100, 93, 71, 52, 73, 94, 31, 20],
                               rtol=0.02, atol=1)


@pytest.mark.parametrize("invalid_values,exp0", _RHQ["invalid_values,exp0"])
@pytest.mark.parametrize("method", _RHQ["method"])
def test_relative_humidity_from_huss_oracle(method, invalid_values, exp0):
    tas = ref_matrix._s(np.array([-10, -10, 10, 20, 35, 50, 75, 95])
                        + ref_matrix.K2C, "K")
    ps = ref_matrix._s([101325] * 8, "Pa")
    huss = ref_matrix._s([0.003, 0.001] + [0.005] * 6, "1")
    kw = dict(method=method, invalid_values=invalid_values,
              ice_thresh="0 degC")
    want = jconv.relative_humidity(tas, huss=huss, ps=ps, **kw)
    got = conv.relative_humidity(to_port(tas), huss=to_port(huss),
                                 ps=to_port(ps), **kw)
    close(got, want, rtol=ESAT_RTOL)
    np.testing.assert_allclose(
        got.values, [exp0, 62.5, 66.0, 35.0, 14.5, 6.5, 2.0, 1.0],
        atol=0.5, rtol=0.005)


@pytest.mark.parametrize("invalid_values,exp0", _HUSS["invalid_values,exp0"])
@pytest.mark.parametrize("method", _HUSS["method"])
def test_specific_humidity_oracle(method, invalid_values, exp0):
    tas = ref_matrix._s(np.array([20, -10, 10, 20, 35, 50, 75, 95])
                        + ref_matrix.K2C, "K")
    hurs = ref_matrix._s([150, 10, 90, 20, 80, 50, 70, 40], "%")
    ps = ref_matrix._s(1000 * np.array([100] * 4 + [101] * 4), "Pa")
    kw = dict(method=method, invalid_values=invalid_values,
              ice_thresh="0 degC")
    want = jconv.specific_humidity(tas, hurs, ps, **kw)
    got = conv.specific_humidity(to_port(tas), to_port(hurs), to_port(ps),
                                 **kw)
    close(got, want, rtol=ESAT_RTOL)
    np.testing.assert_allclose(
        got.values,
        [exp0, 1.6e-4, 6.9e-3, 3.0e-3, 2.9e-2, 4.1e-2, 2.1e-1, 5.7e-1],
        atol=1e-4, rtol=0.05)


_SNOW = _marks(ref_methods.TestSnowfallApproximation.test_methods)
_RAIN = _marks(ref_methods.TestRainApproximation.test_methods)


@pytest.mark.parametrize("kind,method,exp,kws", [
    ("snowfall", *c) for c in _SNOW["method,exp,kws"]] + [
    ("rain", *c) for c in _RAIN["method,exp,kws"]])
def test_phase_approximation_oracles(kind, method, exp, kws):
    pr = ref_methods._series(np.ones(10), "kg m-2 s-1")
    tas = ref_methods._series(np.arange(10), "degC")
    name = f"{kind}_approximation"
    want = getattr(jconv, name)(pr, tas, method=method, **kws)
    got = getattr(conv, name)(to_port(pr), to_port(tas), method=method, **kws)
    close(got, want, rtol=0.0, atol=FRAC_ATOL)
    if exp is not None:
        np.testing.assert_allclose(got.values, exp, atol=1e-5, rtol=1e-3)


def _pet_oracle_inputs():
    """The reference's PET and water-budget oracle inputs
    (test_converter_methods.py: TestPETMethods, TestWaterBudget)."""
    s, k, lat = ref_methods._series, ref_methods.K2C, ref_methods.LAT45
    ms = dict(start="1990-01-01", freq="MS", coords={"lat": lat})
    tn, tx, tm = (s(np.array(v) + k, "K") for v in ([0, 5, 10], [10, 15, 20],
                                                     [5, 10, 15]))
    return {
        "DA02": (jconv.potential_evapotranspiration, dict(
            tasmin=s([0, 5, 10], "degC", **ms),
            tasmax=s([10, 15, 20], "degC", **ms),
            tas=s([5, 10, 15], "degC", **ms),
            pr=s([30, 0, 60], "mm/month", **ms), lat=lat, method="DA02")),
        "TW48": (jconv.potential_evapotranspiration, dict(
            tas=s(np.ones(12), "degC", **ms), method="TW48")),
        "MB05": (jconv.potential_evapotranspiration, dict(
            tasmin=tn, tasmax=tx, lat=lat, method="MB05")),
        "HG85": (jconv.potential_evapotranspiration, dict(
            tasmin=tn, tasmax=tx, tas=tm, lat=lat, method="HG85")),
        "wb_BR65": (jconv.water_budget, dict(
            pr=s([10, 10, 10], "mm/day"), tasmin=tn, tasmax=tx, lat=lat,
            method="BR65")),
        "wb_TW48": (jconv.water_budget, dict(
            pr=s(np.ones(12) * 10, "mm/day", **ms),
            tas=s(np.ones(12), "degC", **ms), method="TW48")),
    }


@pytest.mark.parametrize("case", ["DA02", "TW48", "MB05", "HG85", "wb_BR65",
                                  "wb_TW48"])
def test_pet_oracle_inputs(case):
    fn, kw = _pet_oracle_inputs()[case]
    want = fn(**kw)
    pkw = {k: to_port(v) if isinstance(v, JClimArray) else v
           for k, v in kw.items()}
    got = getattr(conv, fn.__name__)(**pkw)
    close(got, want, rtol=RTOL, atol=1e-12)


# -- helpers ------------------------------------------------------------------


def _times():
    """A daily noleap axis, a standard daily axis and a 3-hourly one."""
    from xclim_tpu_torch.core.calendar import date_range

    return {"daily_noleap": ("2000-01-01", 730, "D", "noleap"),
            "daily_standard": ("2001-03-01", 400, "D", "standard"),
            "3h": ("2000-06-20", 96, "3h", "standard")}, date_range


SOLAR = {
    "solar_declination": lambda m, t, d: m.solar_declination(t),
    "solar_declination_simple": lambda m, t, d: m.solar_declination(
        t, method="simple"),
    "eccentricity": lambda m, t, d: m.eccentricity_correction_factor(t),
    "day_angle": lambda m, t, d: m.day_angle(t),
    "extraterrestrial_solar_radiation": lambda m, t, d:
        m.extraterrestrial_solar_radiation(t, LAT, **d),
    "extraterrestrial_scalar_lat": lambda m, t, d:
        m.extraterrestrial_solar_radiation(t, 45.0, method="simple", **d),
    "day_lengths": lambda m, t, d: m.day_lengths(t, LAT, **d),
    "csza_average": lambda m, t, d: m.cosine_of_solar_zenith_angle(
        t, LAT, **d),
    "csza_sunlit": lambda m, t, d: m.cosine_of_solar_zenith_angle(
        t, np.array([10.0, 45.0, 80.0, -80.0]), sunlit=True, **d),
    "csza_instant": lambda m, t, d: m.cosine_of_solar_zenith_angle(
        t, LAT, lon=np.array([30.0]), stat="instant", **d),
    "distance_from_sun": lambda m, t, d: m.distance_from_sun(t, **d),
    "time_correction": lambda m, t, d: m.time_correction_for_solar_angle(
        t, **d),
    "gladstones_k": lambda m, t, d:
        m.gladstones_day_length_latitude_coefficient(t, LAT, **d),
    "jones_k": lambda m, t, d: m.jones_day_length_latitude_coefficient(
        t, LAT, **d),
    "jones_k_gladstones_floor": lambda m, t, d:
        m.jones_day_length_latitude_coefficient(t, LAT, method="gladstones",
                                                floor=True, **d),
}


@pytest.mark.parametrize("fn,tkey", [
    (fn, tkey) for fn in sorted(SOLAR)
    for tkey in ("daily_noleap", "daily_standard", "3h")
    # Jones' coefficient sums a daily series over seasons
    if not (fn.startswith("jones") and tkey == "3h")])
def test_solar_helpers_against_reference(fn, tkey):
    spec, tdate_range = _times()
    start, n, freq, cal = spec[tkey]
    jt = jdate_range(start, periods=n, freq=freq, calendar=cal)
    tt = tdate_range(start, periods=n, freq=freq, calendar=cal)
    want = SOLAR[fn](jhelpers, jt, {})
    got = SOLAR[fn](helpers, tt, {"device": "cpu"})
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        return
    # host geometry cast once to float32 on both sides: equal; Jones'
    # seasonal sum is one float32 sum of ~214 day lengths (segment sums:
    # within 3 ulp, tests/test_torch_segments.py)
    close(got, want, rtol=4e-7 if fn.startswith("jones") else 0.0)


def test_huglin_coefficient_and_hourly_temperature(fields):
    for method in ("huglin", "interpolated"):
        np.testing.assert_array_equal(
            helpers.huglin_day_length_latitude_coefficient(
                np.array([30.0, 41.0, 45.5, 49.9, 55.0]), method=method),
            jhelpers.huglin_day_length_latitude_coefficient(
                np.array([30.0, 41.0, 45.5, 49.9, 55.0]), method=method))
    jn, tn = fields["tasmin"]
    jx, tx = fields["tasmax"]
    jn, tn, jx, tx = (a.isel(time=slice(0, 40)) for a in (jn, tn, jx, tx))
    close(helpers.make_hourly_temperature(tn, tx),
          jhelpers.make_hourly_temperature(jn, jx), rtol=RTOL)
    close(helpers.wind_speed_height_conversion(fields["sfcWind"][1], "10 m",
                                               "2 m"),
          jhelpers.wind_speed_height_conversion(fields["sfcWind"][0], "10 m",
                                                "2 m"), rtol=RTOL)


def test_resample_map(fields):
    jt, tt = fields["tas"]
    want = jhelpers.resample_map(jt, "time", "YS",
                                 lambda d: d.max(dim="time"))
    got = helpers.resample_map(tt, "time", "YS", lambda d: d.max(dim="time"))
    np.testing.assert_array_equal(got.values, np.asarray(want.data))
    assert got.dims == want.dims
    want = jhelpers.resample_map(jt, "time", "MS", lambda d: d * 2.0)
    got = helpers.resample_map(tt, "time", "MS", lambda d: d * 2.0)
    close(got, want, rtol=0.0)


_DECL = _marks(ref_solar.test_solar_declination)
_CSZA = _marks(ref_solar.TestCosineSolarZenith.test_sunlit_average_vs_pywgbt)


@pytest.mark.parametrize("method,tol", _DECL["method,rtol"])
def test_solar_declination_oracle(method, tol):
    """tests/test_solar_helpers.py's NOAA timestamps (sub-daily, three
    centuries): the same host float64 values, and the NOAA declinations
    at the reference's tolerance."""
    kw = dict(year=np.array([1793, 1969, 2022]), month=np.array([1, 7, 5]),
              day=np.array([21, 20, 20]), hour=np.array([10, 20, 16]),
              minute=np.array([22, 17, 55]), second=np.array([0, 40, 48]))
    from xclim_tpu.core.calendar import TimeIndex as JTimeIndex

    got = helpers.solar_declination(TimeIndex(**kw), method=method)
    np.testing.assert_array_equal(
        got, jhelpers.solar_declination(JTimeIndex(**kw), method=method))
    np.testing.assert_allclose(got, np.deg2rad([-19.83, 20.64, 20.00]),
                               atol=tol * 2 * np.deg2rad(23.44))


@pytest.mark.parametrize("sunlit", [True, False])
@pytest.mark.parametrize("calendar", _CSZA["calendar"])
def test_cosine_of_solar_zenith_angle_hourly_oracle_inputs(calendar, sunlit):
    """The PyWGBT hourly inputs of tests/test_solar_helpers.py (intervals
    that start at the timestamps, crossing midnight, a polar latitude):
    equal to the reference."""
    from xclim_tpu_torch.core.calendar import date_range

    lat, lon = np.array([0.0, 45.0, 70.0]), np.array([-40.0, 0.0, 80.0])
    kw = dict(stat="average", sunlit=sunlit)
    want = jhelpers.cosine_of_solar_zenith_angle(
        jdate_range("1900-01-01 00:30", periods=49, freq="h",
                    calendar=calendar), lat, lon, **kw)
    got = helpers.cosine_of_solar_zenith_angle(
        date_range("1900-01-01 00:30", periods=49, freq="h",
                   calendar=calendar), lat, lon, device="cpu", **kw)
    close(got, want, rtol=0.0)
    if sunlit:
        np.testing.assert_allclose(got.values[7:12, :], [
            [0.0, 0.0610457, 0.0], [0.09999178, 0.18221077, 0.0],
            [0.31387116, 0.285383, 0.0], [0.52638271, 0.35026199, 0.0],
            [0.70303168, 0.37242693, 0.0]], rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("case", ["humidex", "heat_index", "wind_chill",
                                  "utci", "utci_hot", "wind_roundtrip"])
def test_comfort_and_wind_oracles(case):
    """tests/test_converters.py's single-value oracles (its ``_s`` series
    builder): the port equals the reference and the published value."""
    s = ref_conv._s
    calls = {
        "humidex": ((s([30.0], units="degC"), s([21.1], units="degC",
                                                   var="tdps")),
                    lambda m, t, d: m.humidex(t, tdps=d), 38.5, 0.5),
        "heat_index": ((s([30.0], units="degC"), s([70.0], units="%",
                                                      var="hurs")),
                       lambda m, t, h: m.heat_index(t, h), 35.0, 1.5),
        "wind_chill": ((s([-20.0], units="degC"), s([30.0], units="km/h",
                                                       var="sfcWind")),
                       lambda m, t, w: m.wind_chill_index(t, w), -32.6, 1.0),
        "utci": ((s([25.0], units="degC"), s([50.0], units="%", var="hurs"),
                  s([1.0], units="m/s", var="sfcWind"),
                  s([298.15], units="K")),
                 lambda m, t, h, w, r: m.universal_thermal_climate_index(
                     t, h, w, mrt=r), 298.05, 1.0),
        "utci_hot": ((s([35.0], units="degC"), s([80.0], units="%",
                                                    var="hurs"),
                      s([1.0], units="m/s", var="sfcWind"),
                      s([308.15], units="K")),
                     lambda m, t, h, w, r: m.universal_thermal_climate_index(
                         t, h, w, mrt=r), None, None),
        "wind_roundtrip": ((s([3.0, 0.0, -4.0], units="m/s", var="uas"),
                            s([4.0, 5.0, 0.0], units="m/s", var="vas")),
                           lambda m, u, v: m.sfcwind_to_uas_vas(
                               *m.uas_vas_to_sfcwind(u, v)), None, None),
    }
    args, fn, oracle, tol = calls[case]
    want = fn(jconv, *args)
    got = fn(conv, *[to_port(a) for a in args])
    if isinstance(want, tuple):
        close(tuple(got), tuple(want), rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got[0].values, [3.0, 0.0, -4.0],
                                   atol=1e-4)
        return
    close(got, want, rtol=RTOL, atol=UTCI_ATOL if "utci" in case else 0.0)
    if oracle is not None:
        np.testing.assert_allclose(got.values[0], oracle, atol=tol)
    else:
        assert got.values[0] - 273.15 > 40
