"""The port's ``indices/_agro.py`` and the ten atmos temperature indicators
built on it against the JAX package's on the same numpy inputs: seeded
daily fields (4 noleap years x 3 latitudes x 4 longitudes, 1 % NaN, half
the precipitation days dry), hourly temperature for the chill models, and
the oracle inputs of the reference's ``tests/test_agro.py`` (its series
fixtures), through the reference's XLA route.

Bounds. Counts, days of year and zones are equal; period sums of degree
days and heat units within ``RTOL`` (1e-6) relative (the port sums in
float64 and rounds once, the reference adds float32 partials). Stated
exceptions:

- ``CHILL_RTOL`` (1e-5): the chill-portion recurrence carries E from hour
  to hour through exp(-A1 exp(-E1/T)) and exp(EE/T); XLA:CPU's float32
  exp differs from torch's by an ulp, and the carry keeps it, so a year's
  sum of portions holds to 1e-5 relative.
- SPI with a gamma fit: XLA's float32 igamma is 5.3e-6 from scipy and the
  approximate-ML shape cancels in float32 (``tests/test_torch_stats.py``
  holds both to float64/scipy, no worse than the reference):
  ``SPI_ATOL`` 5e-3 (the largest difference on this file's inputs is
  2.3e-3). SPEI's fisk fit is the closed-form PWM estimate for every
  method; its shape beta = (2 w1 - w0) / (6 w1 - w0 - 6 w2) cancels in
  float32, and the two packages add the weighted moments in another
  order: ``SPEI_ATOL`` 1e-3 (the largest difference on this file's inputs
  is 1.3e-4).
"""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import xclim_tpu.indicators.atmos as jatmos
from xclim_tpu import indices as jindices
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.ops.pallas import capability
from xclim_tpu.testing.helpers import test_timeseries
from xclim_tpu_torch import indices
from xclim_tpu_torch.indicators import atmos
from xclim_tpu_torch.indices import _agro

from test_torch_converters import close, to_port

RTOL = 1e-6
CHILL_RTOL = 1e-5
SPI_ATOL = 5e-3
SPEI_ATOL = 1e-3
YEARS = 4
NT = 365 * YEARS
LAT = np.array([10.0, 45.0, -38.0])
K = 273.15


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _field(name, units, mu, sd, seed, seas=0.0, positive=False, dry=None,
           attrs=None, n=NT, freq="D", start="2000-01-01"):
    rng = np.random.default_rng(seed)
    per = 365 if freq == "D" else 365 * 24
    season = np.cos(2 * np.pi * (np.arange(n) % per - per * 0.55) / per)
    x = (mu + seas * season[:, None, None]
         + rng.normal(0, sd, (n, 3, 4))).astype(np.float32)
    if positive:
        x = np.abs(x)
    if dry is not None:
        x[rng.random(x.shape) < dry] = 0.0
    x[rng.random(x.shape) < 0.01] = np.nan
    t = jdate_range(start, periods=n, freq=freq, calendar="noleap")
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": LAT, "lon": np.arange(4.0)},
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


def _temp_attrs(cm):
    return {"standard_name": "air_temperature", "cell_methods": cm}


@pytest.fixture(scope="module")
def fields():
    return {
        "tas": _field("tas", "K", 283, 4, 0, seas=12,
                      attrs=_temp_attrs("time: mean")),
        "tasmax": _field("tasmax", "K", 289, 4, 1, seas=12,
                         attrs=_temp_attrs("time: maximum")),
        "tasmin": _field("tasmin", "K", 277, 4, 2, seas=12,
                         attrs=_temp_attrs("time: minimum")),
        "pr": _field("pr", "kg m-2 s-1", 3e-5, 3e-5, 3, positive=True,
                     dry=0.5, attrs={"standard_name": "precipitation_flux"}),
        "pet": _field("evspsblpot", "kg m-2 s-1", 2e-5, 1e-5, 4,
                      positive=True, attrs={
                          "standard_name":
                              "water_potential_evapotranspiration_flux"}),
        "wb": _field("wb", "kg m-2 s-1", 0.0, 3e-5, 5),
        # two hourly winters and the summer between them
        "tas_h": _field("tas", "K", 281, 3, 6, seas=9, n=24 * 500, freq="h",
                        start="2000-10-01", attrs=_temp_attrs("time: point")),
    }


CASES = {
    "corn_heat_units": (lambda m, a: m.corn_heat_units(a["tasmin"],
                                                       a["tasmax"]),
                        RTOL, 0.0),
    "cool_night_index": (lambda m, a: m.cool_night_index(a["tasmin"]),
                         RTOL, 0.0),
    "cool_night_index_south": (lambda m, a: m.cool_night_index(
        a["tasmin"], lat="south"), RTOL, 0.0),
    "dryness_index": (lambda m, a: m.dryness_index(a["pr"], a["pet"]),
                      RTOL, 1e-3),
    "latitude_temperature_index": (
        lambda m, a: m.latitude_temperature_index(a["tas"]), RTOL, 0.0),
    "qian_weighted_mean_average": (
        lambda m, a: m.qian_weighted_mean_average(a["tas"]), RTOL, 0.0),
    "hardiness_zones_usda": (lambda m, a: m.hardiness_zones(
        a["tasmin"], window=2), 0.0, 0.0),
    "hardiness_zones_anbg": (lambda m, a: m.hardiness_zones(
        a["tasmin"], window=3, method="anbg"), 0.0, 0.0),
    "chill_units": (lambda m, a: m.chill_units(a["tas_h"]), 0.0, 0.0),
    "chill_units_positive": (lambda m, a: m.chill_units(
        a["tas_h"], positive_only=True), 0.0, 0.0),
    "chill_portions": (lambda m, a: m.chill_portions(a["tas_h"]),
                       CHILL_RTOL, 1e-6),
    "chill_portions_months": (lambda m, a: m.chill_portions(
        a["tas_h"], month=[10, 11, 12, 1, 2]), CHILL_RTOL, 1e-6),
    "spi_gamma": (lambda m, a: m.standardized_precipitation_index(
        a["pr"], freq="MS", window=3, method="APP"), 0.0, SPI_ATOL),
    "spei_fisk": (lambda m, a:
                  m.standardized_precipitation_evapotranspiration_index(
                      a["wb"], freq="MS", window=3), 0.0, SPEI_ATOL),
}
for _method in ("huglin", "interpolated"):
    CASES[f"huglin_index_{_method}"] = (
        lambda m, a, _me=_method: m.huglin_index(a["tas"], a["tasmax"],
                                                 method=_me), RTOL, 0.0)
for _method in ("gladstones", "icclim", "huglin", "interpolated"):
    CASES[f"bedd_{_method}"] = (
        lambda m, a, _me=_method: m.biologically_effective_degree_days(
            a["tasmin"], a["tasmax"], method=_me), RTOL, 0.0)
for _method in ("bootsma", "qian"):
    CASES[f"effective_growing_degree_days_{_method}"] = (
        lambda m, a, _me=_method: m.effective_growing_degree_days(
            a["tasmax"], a["tasmin"], method=_me), RTOL, 0.0)
for _ds, _de in (("per_day", "per_day"), ("total", "total"),
                 ("per_day", "total")):
    CASES[f"rain_season_{_ds}_{_de}"] = (
        lambda m, a, _s=_ds, _e=_de: m.rain_season(
            a["pr"], method_dry_start=_s, method_dry_end=_e,
            thresh_wet_start="15 mm", window_not_dry_start=10), 0.0, 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_against_reference(fields, case):
    fn, rtol, atol = CASES[case]
    want = fn(jindices, {k: v[0] for k, v in fields.items()})
    got = fn(indices, {k: v[1] for k, v in fields.items()})
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close(got, want, rtol=rtol, atol=atol)


def test_chill_scan_is_one_pass_per_hour(fields, monkeypatch):
    """The recurrence's carry stays a tensor: no host sync inside the loop
    (``.item()``, ``.tolist()``, ``bool()`` of a tensor would raise here)."""
    import torch

    x = fields["tas_h"][1].data[:48] + 0.0

    def forbidden(*a, **k):
        raise AssertionError("host sync inside the chill scan")

    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    monkeypatch.setattr(torch.Tensor, "__bool__", forbidden)
    out = _agro._chill_portion_scan(x, 0)
    assert out.shape == x.shape


def test_chill_check_holds_the_cpu_run_to_a_float64_replay(fields):
    """check_chill_portions accepts the port's CPU run: its banking
    decisions differ from float64's only within 1e-5 of E = 1, its sums
    hold to the replay at CHILL_RTOL, and the replay's sums hold to the
    reference's at CHILL_RTOL (the fixture's NaN hours included)."""
    from xclim_tpu_torch.testing import check_chill_portions

    j, p = fields["tas_h"]
    out, rep = check_chill_portions(p)
    assert rep["flip_gap"] <= 1e-5 and rep["max_rel_err"] <= CHILL_RTOL
    want = np.asarray(jindices.chill_portions(j).data, np.float64)
    np.testing.assert_allclose(rep["replay"].numpy(), want,
                               rtol=CHILL_RTOL, atol=1e-6)
    close(out, jindices.chill_portions(j), rtol=CHILL_RTOL, atol=1e-6)


@pytest.mark.parametrize("fault", ["decision", "sum"])
def test_chill_check_refuses_a_faulty_run(fields, monkeypatch, fault):
    """A banking decision away from E = 1 (E scaled by 1.001), or a period
    sum off by 1e-3 portion, fails the check (the fixture's NaN hours set
    to 281 K, so that E runs the whole series)."""
    import torch

    from xclim_tpu_torch.testing import check_chill_portions

    _, p = fields["tas_h"]
    p = p.copy(data=torch.nan_to_num(p.data, nan=281.0))
    if fault == "decision":
        inner = _agro._chill_intermediate
        monkeypatch.setattr(_agro, "_chill_intermediate", lambda x: tuple(
            v * m for v, m in zip(inner(x), (1.001, 1.0))))
        match = "banking decision"
    else:
        inner = _agro.chill_portions
        monkeypatch.setattr(_agro, "chill_portions", lambda *a, **k: (
            lambda o: o.copy(data=o.data + 1e-3))(inner(*a, **k)))
        match = "period sums"
    with pytest.raises(AssertionError, match=match):
        check_chill_portions(p)


# -- the ten temperature indicators ------------------------------------------

INDICATORS = {
    "huglin_index": lambda m, a: m.huglin_index(a["tas"], a["tasmax"]),
    "biologically_effective_degree_days": lambda m, a:
        m.biologically_effective_degree_days(a["tasmin"], a["tasmax"]),
    "latitude_temperature_index": lambda m, a:
        m.latitude_temperature_index(a["tas"]),
    "usda_hardiness_zones": lambda m, a: m.usda_hardiness_zones(
        a["tasmin"], window=2),
    "australian_hardiness_zones": lambda m, a: m.australian_hardiness_zones(
        a["tasmin"], window=2),
    "cool_night_index": lambda m, a: m.cool_night_index(a["tasmin"]),
    "corn_heat_units": lambda m, a: m.corn_heat_units(a["tasmin"],
                                                      a["tasmax"]),
    "effective_growing_degree_days": lambda m, a:
        m.effective_growing_degree_days(a["tasmax"], a["tasmin"]),
    "cp": lambda m, a: m.cp(a["tas_h"]),
    "cu": lambda m, a: m.cu(a["tas_h"]),
    "chill_portions": lambda m, a: m.chill_portions(a["tas_h"], freq="YS"),
    "chill_units": lambda m, a: m.chill_units(a["tas_h"], freq="YS"),
}


@pytest.mark.parametrize("name", sorted(INDICATORS))
def test_temperature_indicators_against_reference(fields, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = INDICATORS[name](jatmos, {k: v[0] for k, v in fields.items()})
        got = INDICATORS[name](atmos, {k: v[1] for k, v in fields.items()})
    rtol = CHILL_RTOL if name in ("cp", "chill_portions") else RTOL
    close(got, want, rtol=rtol, atol=1e-6 if rtol == CHILL_RTOL else 0.0)


# -- the reference's oracle inputs (tests/test_agro.py) ----------------------


def test_oracle_corn_heat_units_huglin_bedd(tasmin_series, tasmax_series,
                                            tas_series):
    tn = tasmin_series(np.array([10.0]), units="degC")
    tx = tasmax_series(np.array([20.0]), units="degC")
    got = indices.corn_heat_units(to_port(tn), to_port(tx))
    close(got, jindices.corn_heat_units(tn, tx))
    np.testing.assert_allclose(got.values[0], (10.008 + 24.9) / 2, rtol=1e-4)

    n = 365
    tas = tas_series(np.full(n, 15.0), units="degC", start="2001-01-01")
    tx = tasmax_series(np.full(n, 25.0), units="degC", start="2001-01-01")
    tas.coords["lat"] = np.asarray(45.0)
    got = indices.huglin_index(to_port(tas), to_port(tx), method="huglin",
                               freq="YS")
    close(got, jindices.huglin_index(tas, tx, method="huglin", freq="YS"))
    np.testing.assert_allclose(got.values[0], 10.4 * 183, rtol=1e-4)

    tn = tasmin_series(np.full(n, 12.0), units="degC", start="2001-01-01")
    tx = tasmax_series(np.full(n, 22.0), units="degC", start="2001-01-01")
    got = indices.biologically_effective_degree_days(
        to_port(tn), to_port(tx), method="icclim", freq="YS")
    close(got, jindices.biologically_effective_degree_days(
        tn, tx, method="icclim", freq="YS"))
    np.testing.assert_allclose(got.values[0], 7 * 214, rtol=1e-4)


def test_oracle_cool_night_and_lti(tasmin_series, tas_series):
    vals = np.full(365, 10.0)
    t = test_timeseries(vals, "tasmin", units="degC", start="2001-01-01")
    vals[t.time.month == 9] = 14.0
    tn = tasmin_series(vals, units="degC", start="2001-01-01")
    tn.coords["lat"] = np.asarray(45.0)
    got = indices.cool_night_index(to_port(tn), freq="YS")
    close(got, jindices.cool_night_index(tn, freq="YS"))
    np.testing.assert_allclose(got.values[0], 14.0, rtol=1e-6)
    tas = tas_series(np.full(365, 20.0), units="degC", start="2001-01-01")
    tas.coords["lat"] = np.asarray(45.0)
    got = indices.latitude_temperature_index(to_port(tas), freq="YS")
    close(got, jindices.latitude_temperature_index(tas, freq="YS"))
    np.testing.assert_allclose(got.values[0], 20 * (75 - 45), rtol=1e-5)


def test_oracle_chill(tas_series):
    tas = tas_series(np.full(48, 5.0), units="degC", freq="h",
                     start="2001-01-01")
    got = indices.chill_units(to_port(tas), freq="YS")
    close(got, jindices.chill_units(tas, freq="YS"))
    np.testing.assert_allclose(got.values[0], 48.0)
    n = 24 * 60
    tas = tas_series((6 + 4 * np.sin(np.arange(n) * 2 * np.pi / 24)
                      ).astype(np.float32), units="degC", freq="h",
                     start="2001-01-01")
    got = indices.chill_portions(to_port(tas), freq="YS")
    close(got, jindices.chill_portions(tas, freq="YS"), rtol=CHILL_RTOL)
    assert float(got.values[0]) > 10


def test_oracle_hardiness_and_rain_season(tasmin_series, pr_series):
    tn = tasmin_series(np.full(365 * 31, -10.0), units="degC",
                       start="1980-07-01")
    got = indices.hardiness_zones(to_port(tn), window=30, freq="YS-JUL")
    close(got, jindices.hardiness_zones(tn, window=30, freq="YS-JUL"))
    v = got.values
    assert (v[~np.isnan(v)] == 14).all()
    vals = np.zeros(365)
    vals[151:211] = 20 / 86400
    pr = pr_series(vals, start="2001-01-01")
    kw = dict(date_min_start="05-01", date_max_start="12-31",
              date_min_end="09-01", freq="YS")
    got = indices.rain_season(to_port(pr), **kw)
    close(got, tuple(jindices.rain_season(pr, **kw)))
    assert got[0].values[0] == 153 and np.isnan(got[1].values[0])
    assert got[2].values[0] == 365 - 152
