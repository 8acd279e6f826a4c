"""The port's ``indicators/land`` (snow and streamflow), ``indicators/seaIce``
and ``indicators/generic`` against the JAX package's, on the same numpy
inputs: seeded daily fields of 4 noleap years x 3 latitudes x 4 longitudes
(1 % NaN) with a seasonal snow cover and storms, streamflow with a
seasonal cycle, sea-ice concentration over a cell-area grid, through the
reference's XLA route. Each indicator is compared with its values, NaN
pattern, dims, name and attributes (history but for its timestamp and
package name).

Bounds (as ``tests/test_torch_hydro_anuclim.py`` and
``tests/test_torch_threshold.py`` hold the indices underneath). Counts,
days of year and run lengths are equal. Period sums and means within
``RTOL`` (1e-6) relative: the port sums in float64 and rounds once, the
reference adds float32 partials. Stated exceptions:

- ``lag_snowpack_flow_peaks`` averages float32 seconds since the start in
  another order: ``LAG_ATOL`` 4e-3 days.
- ``sen_slope`` takes differences of annual means up to 3 ulps apart:
  within 8 ulps of the means' scale.
- ``ssi`` (GEV PWM, which cancels in float32): ``SSI_ATOL`` 1e-3;
  ``sgi`` with a normal fit: ``NORM_ATOL`` 5e-5.
- The generic ``fit`` of a GEV by maximum likelihood runs BFGS, which does
  not repeat jax's iterates: 1e-3 relative (the reference's own oracle
  tolerance, ``tests/test_torch_stats.py``).
"""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import xclim_tpu.indicators.generic as jgeneric
import xclim_tpu.indicators.land as jland
import xclim_tpu.indicators.seaIce as jseaice
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.indicator import Indicator as JIndicator
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch.indicators import generic, land, seaIce

from test_torch_converters import close, to_port

RTOL = 1e-6
LAG_ATOL = 4e-3
SSI_ATOL = 1e-3
NORM_ATOL = 5e-5
BFGS_RTOL = 1e-3
YEARS = 4
NT = 365 * YEARS
LAT = np.array([55.0, 65.0, -70.0])


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _pair(x, name, units, attrs=None, dims=("time", "lat", "lon")):
    coords = {"lat": LAT, "lon": np.arange(4.0)}
    if "time" in dims:
        coords["time"] = jdate_range("2000-01-01", periods=NT,
                                     calendar="noleap")
    j = JClimArray(jnp.asarray(x.astype(np.float32)), dims, coords,
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(20)
    shape = (NT, len(LAT), 4)
    season = np.cos(2 * np.pi * (np.arange(NT) % 365 - 20) / 365.0)
    season = season[:, None, None] * np.ones(shape)

    def holes(x):
        x[rng.random(x.shape) < 0.01] = np.nan
        return x

    # a winter snow pack, with storms (sudden depth gains)
    depth = np.clip(0.35 * season + 0.05 * rng.normal(size=shape), 0, None)
    depth[rng.random(shape) < 0.03] += 0.3
    q = np.abs(50 + 25 * np.roll(season, 120, axis=0)
               + rng.lognormal(2, 1, shape))
    sic = np.clip(50 + 60 * season + 20 * rng.normal(size=shape), 0, 100)
    area = np.linspace(1e3, 2e3, 12).reshape(3, 4)
    return {
        "snd": _pair(holes(depth.copy()), "snd", "m",
                     {"standard_name": "surface_snow_thickness"}),
        "snw": _pair(holes(depth * 250), "snw", "kg m-2",
                     {"standard_name": "surface_snow_amount"}),
        "prsn": _pair(holes(np.where(rng.random(shape) < 0.3,
                                     rng.gamma(1, 1e-5, shape), 0.0)),
                      "prsn", "kg m-2 s-1",
                      {"standard_name": "snowfall_flux"}),
        "pr": _pair(holes(np.where(rng.random(shape) < 0.5,
                                   rng.gamma(1, 3e-5, shape), 0.0)),
                    "pr", "kg m-2 s-1",
                    {"standard_name": "precipitation_flux"}),
        "sfcWind": _pair(holes(np.abs(5 + 3 * rng.normal(size=shape))),
                         "sfcWind", "m s-1", {"standard_name": "wind_speed"}),
        "q": _pair(holes(q), "q", "m3 s-1", {
            "standard_name": "water_volume_transport_in_river_channel"}),
        "siconc": _pair(holes(sic), "siconc", "%",
                        {"standard_name": "sea_ice_area_fraction"}),
        "areacello": _pair(area, "areacello", "km2",
                           {"standard_name": "cell_area"},
                           dims=("lat", "lon")),
    }


def _slope_atol(f):
    scale = np.nanmax(np.abs(np.asarray(f["q"][0].data)))
    return 8 * float(np.spacing(np.float32(scale)))


# indicator name (with "-variant" where one is held twice) -> (call on a
# realm module and its inputs, rtol, atol)
LAND = {
    "snd_season_length": (lambda m, a: m.snd_season_length(a["snd"]), 0, 0),
    "snw_season_length": (lambda m, a: m.snw_season_length(
        a["snw"], window=5), 0, 0),
    "snd_season_start": (lambda m, a: m.snd_season_start(a["snd"]), 0, 0),
    "snw_season_start": (lambda m, a: m.snw_season_start(a["snw"]), 0, 0),
    "snd_season_end": (lambda m, a: m.snd_season_end(a["snd"]), 0, 0),
    "snw_season_end": (lambda m, a: m.snw_season_end(a["snw"]), 0, 0),
    "snd_storm_days": (lambda m, a: m.snd_storm_days(
        a["snd"], thresh="20 cm"), 0, 0),
    "snw_storm_days": (lambda m, a: m.snw_storm_days(
        a["snw"], thresh="40 kg m-2", freq="MS"), 0, 0),
    "snd_days_above": (lambda m, a: m.snd_days_above(a["snd"]), 0, 0),
    "snw_days_above": (lambda m, a: m.snw_days_above(
        a["snw"], freq="YS", month=[12, 1, 2]), 0, 0),
    "blowing_snow": (lambda m, a: m.blowing_snow(
        a["snd"], a["sfcWind"], snd_thresh="5 cm",
        sfcWind_thresh="15 km/h"), 0, 0),
    "snow_depth": (lambda m, a: m.snow_depth(a["snd"], freq="MS"), RTOL, 0),
    "snd_max_doy": (lambda m, a: m.snd_max_doy(a["snd"]), 0, 0),
    "snw_max": (lambda m, a: m.snw_max(a["snw"]), 0, 0),
    "snw_max_doy": (lambda m, a: m.snw_max_doy(a["snw"], freq="YS"), 0, 0),
    "snow_melt_we_max": (lambda m, a: m.snow_melt_we_max(a["snw"]), RTOL, 0),
    "melt_and_precip_max": (lambda m, a: m.melt_and_precip_max(
        a["snw"], a["pr"]), RTOL, 0),
    "holiday_snow_days": (lambda m, a: m.holiday_snow_days(a["snd"]), 0, 0),
    "holiday_snow_and_snowfall_days": (
        lambda m, a: m.holiday_snow_and_snowfall_days(
            a["snd"], a["prsn"], date_start="11-20"), 0, 0),
    "base_flow_index": (lambda m, a: m.base_flow_index(a["q"]), RTOL, 0),
    "rb_flashiness_index": (lambda m, a: m.rb_flashiness_index(a["q"]),
                            RTOL, 0),
    "doy_qmax": (lambda m, a: m.doy_qmax(a["q"]), 0, 0),
    "doy_qmin": (lambda m, a: m.doy_qmin(a["q"], season="JJA"), 0, 0),
    "standardized_streamflow_index": (
        lambda m, a: m.standardized_streamflow_index(a["q"], freq="MS"),
        0, SSI_ATOL),
    "standardized_groundwater_index": (
        lambda m, a: m.standardized_groundwater_index(
            a["snd"], freq="MS", window=2, dist="norm"), 0, NORM_ATOL),
    "flow_index": (lambda m, a: m.flow_index(a["q"], p=0.95), RTOL, 0),
    "high_flow_frequency": (lambda m, a: m.high_flow_frequency(
        a["q"], threshold_factor=1.5), 0, 0),
    "low_flow_frequency": (lambda m, a: m.low_flow_frequency(
        a["q"], threshold_factor=0.8), 0, 0),
    "base_flow_index_seasonal_ratio": (
        lambda m, a: m.base_flow_index_seasonal_ratio(a["q"]), RTOL, 0),
    "lag_snowpack_flow_peaks": (lambda m, a: m.lag_snowpack_flow_peaks(
        a["snw"], a["q"]), 0, LAG_ATOL),
    "runoff_ratio": (lambda m, a: m.runoff_ratio(
        a["q"], a["pr"], area="1000 km2"), RTOL, 0),
    "sen_slope": (lambda m, a: m.sen_slope(a["q"]), RTOL, _slope_atol),
    # the reference's land also exposes the convert realm's snd <-> snw
    "snd_to_snw": (lambda m, a: m.snd_to_snw(a["snd"]), RTOL, 0),
    "snw_to_snd": (lambda m, a: m.snw_to_snd(a["snw"]), RTOL, 0),
}

SEAICE = {
    "sea_ice_extent": (lambda m, a: m.sea_ice_extent(
        a["siconc"], a["areacello"]), RTOL, 0),
    "sea_ice_area": (lambda m, a: m.sea_ice_area(
        a["siconc"], a["areacello"], thresh="30 %"), RTOL, 0),
}

GENERIC = {
    "stats": (lambda m, a: m.stats(a["q"], freq="YS", op="max"), 0, 0),
    "stats-seasonal_min": (lambda m, a: m.stats(
        a["q"], freq="YS", op="min", season="MAM"), 0, 0),
    "stats-mean_doy_bounds": (lambda m, a: m.stats(
        a["pr"], freq="MS", op="mean", doy_bounds=(60, 240)), RTOL, 0),
    "fit": (lambda m, a: m.fit(m.stats(a["q"], freq="MS", op="max"),
                               dist="norm"), RTOL, 0),
    "fit-genextreme_ml": (lambda m, a: m.fit(
        m.stats(a["q"], freq="MS", op="max"), dist="genextreme"),
        BFGS_RTOL, 0),
    "return_level": (lambda m, a: m.return_level(
        a["q"], mode="max", t=[2, 5], dist="norm", method="ML"), RTOL, 0),
    "return_level-gumbel_window": (lambda m, a: m.return_level(
        a["q"], mode="max", t=2, dist="gumbel_r", window=7), RTOL, 0),
}

REALMS = {"land": (jland, land, LAND), "seaIce": (jseaice, seaIce, SEAICE),
          "generic": (jgeneric, generic, GENERIC)}


@pytest.mark.parametrize("realm", sorted(REALMS))
def test_every_indicator_of_the_realm_is_held(realm):
    ref, _, cases = REALMS[realm]
    names = {n for n in dir(ref) if not n.startswith("_")
             and isinstance(getattr(ref, n), JIndicator)}
    assert names == {c.split("-")[0] for c in cases}


@pytest.mark.parametrize("realm,name", [
    (r, n) for r in sorted(REALMS) for n in sorted(REALMS[r][2])])
def test_indicator_against_reference(fields, realm, name):
    ref, port, cases = REALMS[realm]
    fn, rtol, atol = cases[name]
    if callable(atol):
        atol = atol(fields)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fn(ref, {k: v[0] for k, v in fields.items()})
        got = fn(port, {k: v[1] for k, v in fields.items()})
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close(got, want, rtol=rtol, atol=atol)
