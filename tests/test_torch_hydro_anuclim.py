"""The port's ``indices/_hydrology.py``, ``_anuclim.py`` and
``_synoptic.py`` against the JAX package's on the same numpy inputs:
seeded daily fields (4 noleap years x 3 latitudes x 4 longitudes, 1 % NaN,
half the precipitation days dry) and the oracle inputs of the reference's
``tests/test_hydro_anuclim.py`` (its series fixtures), through the
reference's XLA route.

Bounds. Counts, days of year and zones are equal. Period sums and means:
the port sums in float64 and rounds once, the reference adds float32
partials (``tests/test_torch_segments.py``): within ``RTOL`` (1e-6)
relative, ratios of two of them too. Stated exceptions:

- ``lag_snowpack_flow_peaks`` averages float32 seconds since the start
  (~1.3e8 s at 4 years, ulp 8 s) over up to ~37 high-flow days; the two
  packages add them in another order, so the mean date moves by up to half
  an ulp of the sum (256 s): ``LAG_ATOL`` 4e-3 days.
- ``sen_slope`` takes pairwise differences of annual means that differ by
  up to 3 float32 ulps: the slope within 8 ulps of the means' scale.
- The standardized streamflow index with its default GEV fit: the GEV PWM
  estimator cancels in float32 (``tests/test_torch_stats.py`` holds it to
  a float64 evaluation, no worse than the reference): ``SSI_ATOL`` 1e-3.
  With a normal fit, the monthly means the fit sees already differ by up
  to 3 ulps (1.1e-5 at 50 m3/s); over the fit's spread (~3.6 m3/s) that
  moves z by ~1e-5: ``NORM_ATOL`` 5e-5. ``sen_slope_ratio`` divides two
  such slopes (~0.1-1): 1e-4 relative.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from xclim_tpu import indices as jindices
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch import indices

from test_torch_converters import close, to_port

RTOL = 1e-6
LAG_ATOL = 4e-3
SSI_ATOL = 1e-3
NORM_ATOL = 5e-5
YEARS = 4
NT = 365 * YEARS
LAT = np.array([10.0, 45.0, -70.0])


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _field(name, units, mu, sd, seed, seas=0.0, positive=False, dry=None,
           attrs=None):
    rng = np.random.default_rng(seed)
    season = np.cos(2 * np.pi * (np.arange(NT) % 365 - 200) / 365.0)
    x = (mu + seas * season[:, None, None]
         + rng.normal(0, sd, (NT, 3, 4))).astype(np.float32)
    if positive:
        x = np.abs(x)
    if dry is not None:
        x[rng.random(x.shape) < dry] = 0.0
    x[rng.random(x.shape) < 0.01] = np.nan
    t = jdate_range("2000-01-01", periods=NT, calendar="noleap")
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": LAT, "lon": np.arange(4.0)},
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


@pytest.fixture(scope="module")
def fields():
    return {
        "tas": _field("tas", "K", 283, 4, 0, seas=12),
        "tasmax": _field("tasmax", "K", 289, 4, 1, seas=12),
        "tasmin": _field("tasmin", "K", 277, 4, 2, seas=12),
        "pr": _field("pr", "kg m-2 s-1", 3e-5, 3e-5, 3, positive=True,
                     dry=0.5, attrs={"standard_name": "precipitation_flux"}),
        "pet": _field("evspsblpot", "kg m-2 s-1", 2e-5, 1e-5, 4,
                      positive=True, attrs={
                          "standard_name":
                              "water_potential_evapotranspiration_flux"}),
        "q": _field("q", "m3 s-1", 50, 20, 5, seas=10, positive=True,
                    attrs={"standard_name":
                           "water_volume_transport_in_river_channel"}),
        "q2": _field("q", "m3 s-1", 55, 20, 6, seas=10, positive=True),
        "snw": _field("snw", "kg m-2", 100, 30, 7, seas=80, positive=True,
                      attrs={"standard_name": "surface_snow_amount"}),
        "snd": _field("snd", "m", 0.3, 0.1, 8, seas=0.2, positive=True,
                      attrs={"standard_name": "surface_snow_thickness"}),
    }


def _slope_atol(f):
    means = np.nanmax(np.abs(np.asarray(f["q"][0].data)))
    return 8 * float(np.spacing(np.float32(means)))


CASES = {
    # ANUCLIM
    "isothermality": (lambda m, a: m.isothermality(a["tasmin"], a["tasmax"]),
                      RTOL, 0.0),
    "temperature_seasonality": (lambda m, a: m.temperature_seasonality(
        a["tas"]), RTOL, 0.0),
    "precip_seasonality": (lambda m, a: m.precip_seasonality(a["pr"]),
                           RTOL, 0.0),
    "prcptot": (lambda m, a: m.prcptot(a["pr"], thresh="1 mm/d"), RTOL, 0.0),
    "prcptot_wetdry_period_driest": (lambda m, a: m.prcptot_wetdry_period(
        a["pr"], op="driest"), RTOL, 0.0),
    "prcptot_wetdry_period_wettest": (lambda m, a: m.prcptot_wetdry_period(
        a["pr"], op="wettest", freq="YS"), RTOL, 0.0),
    # hydrology
    "base_flow_index": (lambda m, a: m.base_flow_index(a["q"]), RTOL, 0.0),
    "base_flow_index_seasonal_ratio": (
        lambda m, a: m.base_flow_index_seasonal_ratio(a["q"]), RTOL, 0.0),
    "rb_flashiness_index": (lambda m, a: m.rb_flashiness_index(a["q"]),
                            RTOL, 0.0),
    "snd_max": (lambda m, a: m.snd_max(a["snd"]), 0.0, 0.0),
    "snd_max_doy": (lambda m, a: m.snd_max_doy(a["snd"]), 0.0, 0.0),
    "snw_max": (lambda m, a: m.snw_max(a["snw"]), 0.0, 0.0),
    "snw_max_doy": (lambda m, a: m.snw_max_doy(a["snw"]), 0.0, 0.0),
    "snow_melt_we_max": (lambda m, a: m.snow_melt_we_max(a["snw"]),
                         RTOL, 0.0),
    "melt_and_precip_max": (lambda m, a: m.melt_and_precip_max(
        a["snw"], a["pr"]), RTOL, 0.0),
    "flow_index": (lambda m, a: m.flow_index(a["q"]), RTOL, 0.0),
    "high_flow_frequency": (lambda m, a: m.high_flow_frequency(
        a["q"], threshold_factor=1.5), 0.0, 0.0),
    "low_flow_frequency": (lambda m, a: m.low_flow_frequency(
        a["q"], threshold_factor=0.8), 0.0, 0.0),
    "lag_snowpack_flow_peaks": (lambda m, a: m.lag_snowpack_flow_peaks(
        a["snw"], a["q"]), 0.0, LAG_ATOL),
    "lag_snowpack_flow_peaks_monthly": (
        lambda m, a: m.lag_snowpack_flow_peaks(a["snw"], a["q"], freq="MS",
                                               p=0.75), 0.0, LAG_ATOL),
    "antecedent_precipitation_index": (
        lambda m, a: m.antecedent_precipitation_index(a["pr"]), RTOL, 0.0),
    "antecedent_precipitation_index_w3": (
        lambda m, a: m.antecedent_precipitation_index(a["pr"], window=3,
                                                      p_exp=0.8), RTOL, 0.0),
    "runoff_ratio": (lambda m, a: m.runoff_ratio(a["q"], a["pr"],
                                                 area="1000 km2"), RTOL, 0.0),
    "aridity_index": (lambda m, a: m.aridity_index(a["pr"], a["pet"]),
                      RTOL, 0.0),
    "sen_slope": (lambda m, a: m.sen_slope(a["q"]), RTOL, _slope_atol),
    "sen_slope_ratio": (lambda m, a: m.sen_slope_ratio(a["q"], a["q2"]),
                        1e-4, _slope_atol),
    "standardized_streamflow_index": (
        lambda m, a: m.standardized_streamflow_index(a["q"], freq="MS"),
        0.0, SSI_ATOL),
    "standardized_groundwater_index_norm": (
        lambda m, a: m.standardized_groundwater_index(
            m.snw_to_snd(a["snw"]), freq="MS", window=2, dist="norm"),
        0.0, NORM_ATOL),
    "standardized_streamflow_index_norm": (
        lambda m, a: m.standardized_streamflow_index(
            a["q"], freq="MS", dist="norm", method="ML"), 0.0, NORM_ATOL),
}
for _op in ("warmest", "coldest"):
    CASES[f"tg_mean_warmcold_quarter_{_op}"] = (
        lambda m, a, _o=_op: m.tg_mean_warmcold_quarter(a["tas"], op=_o),
        RTOL, 0.0)
    CASES[f"prcptot_warmcold_quarter_{_op}"] = (
        lambda m, a, _o=_op: m.prcptot_warmcold_quarter(a["pr"], a["tas"],
                                                        op=_o), RTOL, 0.0)
for _op in ("wettest", "driest"):
    CASES[f"tg_mean_wetdry_quarter_{_op}"] = (
        lambda m, a, _o=_op: m.tg_mean_wetdry_quarter(a["tas"], a["pr"],
                                                      op=_o), RTOL, 0.0)
    CASES[f"prcptot_wetdry_quarter_{_op}"] = (
        lambda m, a, _o=_op: m.prcptot_wetdry_quarter(a["pr"], op=_o),
        RTOL, 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_against_reference(fields, case):
    fn, rtol, atol = CASES[case]
    if callable(atol):
        atol = atol(fields)
    want = fn(jindices, {k: v[0] for k, v in fields.items()})
    got = fn(indices, {k: v[1] for k, v in fields.items()})
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close(got, want, rtol=rtol, atol=atol)


def test_quarters_ties_and_all_nan_periods():
    """The wettest quarter's temperature where two quarters tie (the first
    wins, as the reference's argmax) and a cell whose precipitation is all
    NaN (NaN out)."""
    n = 3 * 365
    t = jdate_range("2001-01-01", periods=n, calendar="noleap")
    pr = np.zeros((n, 2), np.float32)
    pr[::50, 0] = 5e-5          # equal weekly sums at many quarters
    pr[:, 1] = np.nan
    tas = (280 + 10 * np.sin(np.arange(n) / 58.0))[:, None].repeat(2, 1)
    jp = JClimArray(jnp.asarray(pr), ("time", "x"), {"time": t},
                    {"units": "kg m-2 s-1",
                     "standard_name": "precipitation_flux"}, "pr")
    jt = JClimArray(jnp.asarray(tas.astype(np.float32)), ("time", "x"),
                    {"time": t}, {"units": "K"}, "tas")
    for op in ("wettest", "driest"):
        close(indices.tg_mean_wetdry_quarter(to_port(jt), to_port(jp), op=op),
              jindices.tg_mean_wetdry_quarter(jt, jp, op=op), rtol=RTOL)


# -- the reference's oracle inputs (tests/test_hydro_anuclim.py) ---------------


def test_oracle_flat_flows_and_precip(q_series, pr_series, evspsblpot_series):
    q = q_series(np.full(365, 10.0), start="2001-01-01")
    got = indices.base_flow_index(to_port(q), freq="YS")
    close(got, jindices.base_flow_index(q, freq="YS"))
    np.testing.assert_allclose(got.values[0], 1.0, rtol=1e-5)
    q4 = q_series(np.array([10.0, 10, 10, 10]), start="2001-01-01")
    got = indices.rb_flashiness_index(to_port(q4), freq="YS")
    close(got, jindices.rb_flashiness_index(q4, freq="YS"))
    np.testing.assert_allclose(got.values[0], 0.0, atol=1e-6)
    pr = pr_series(np.full(365, 2 / 86400), start="2001-01-01")
    got = indices.prcptot(to_port(pr), freq="YS")
    close(got, jindices.prcptot(pr, freq="YS"))
    np.testing.assert_allclose(got.values[0], 2 * 365, rtol=1e-4)
    pet = evspsblpot_series(np.full(365, 4 / 86400), start="2001-01-01")
    got = indices.aridity_index(to_port(pr), to_port(pet), freq="YS")
    close(got, jindices.aridity_index(pr, pet, freq="YS"))
    np.testing.assert_allclose(got.values[0], 0.5, rtol=1e-5)


def _jet(n=365, nlat=21, seed=0, nan_days=()):
    lats = np.linspace(20, 70, nlat)
    rng = np.random.default_rng(seed)
    # the reference test's jet centred at 45N
    u = 20 * np.exp(-((lats[None, :] - 45) / 10) ** 2) + \
        rng.normal(0, 1, (n, nlat))
    u = u.astype(np.float32)
    for d in nan_days:
        u[d] = np.nan
    u[100:103, 5] = np.nan
    time = jdate_range("2001-01-01", periods=n, freq="D")
    return JClimArray(jnp.asarray(u), ("time", "lat"),
                      {"time": time, "lat": lats}, {"units": "m/s"}, "ua")


@pytest.mark.parametrize("nan_days", [(), (200, 201)])
def test_jetstream_metric_woollings(nan_days):
    """The 61-day Lanczos window (NaN-padded at both ends) summed from its
    first tap, then the latitude of the maximum: NaN as -inf, NaN where a
    day is all NaN."""
    ua = _jet(nan_days=nan_days)
    want = jindices.jetstream_metric_woollings(ua)
    got = indices.jetstream_metric_woollings(to_port(ua))
    close(got, tuple(want), rtol=RTOL, atol=1e-6)
    lv = got[0].values
    ok = ~np.isnan(lv)
    assert abs(np.nanmean(lv[ok]) - 45) < 3
