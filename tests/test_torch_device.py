"""Where the port puts data. Host data given without a device goes to
``xclim_tpu_torch.default_device()`` (the card; it raises without one), and
a tensor keeps its device. No path inside the package reaches the default:
with it made to raise, the public calls of every slice run on CPU tensors."""

import numpy as np
import pytest
import torch

import xclim_tpu_torch
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import (
    from_reference_percentiles,
    percentile_doy,
)

YEARS = 4


@pytest.fixture
def no_default(monkeypatch):
    """default_device() raises for the test's duration."""
    def forbidden():
        raise AssertionError("a path reached default_device()")

    monkeypatch.setattr(xclim_tpu_torch, "default_device", forbidden)


def _series(name, mu, seed, cells=3):
    t = date_range("1981-01-01", periods=YEARS * 365, calendar="noleap")
    rng = np.random.default_rng(seed)
    x = rng.normal(mu, 5.0, (len(t), cells)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    return ClimArray(torch.as_tensor(x), ("time", "x"), {"time": t},
                     {"units": "K", "standard_name": "air_temperature",
                      "cell_methods": "time: mean"}, name)


def test_host_data_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((3, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClimArray(x, ("time", "x"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference_percentiles(x, ("dayofyear", "x"), {}, {})
    assert ClimArray(x, ("time", "x"), device="cpu").device.type == "cpu"
    assert from_reference_percentiles(
        x, ("dayofyear", "x"), {}, {}, device="cpu").device.type == "cpu"


def test_tensors_keep_their_device_and_copies_follow(no_default):
    a = ClimArray(torch.zeros(3, 2), ("time", "x"))
    assert a.device.type == "cpu"
    assert a.copy(data=np.ones((3, 2), np.float32)).device.type == "cpu"
    assert (a + np.ones(2, np.float32)).device.type == "cpu"


def test_tg_mean_on_cpu_tensors(no_default):
    from xclim_tpu_torch.indicators import atmos

    out = atmos.tg_mean(_series("tas", 285.0, 1), freq="MS")
    assert out.device.type == "cpu" and out.shape == (YEARS * 12, 3)


def test_qdm_train_adjust_on_cpu_tensors(no_default):
    from xclim_tpu_torch.sdba import Grouper, QuantileDeltaMapping

    adj = QuantileDeltaMapping.train(
        _series("ref", 285.0, 2), _series("hist", 287.0, 3),
        group=Grouper("time.dayofyear", 31), nquantiles=10, kind="+")
    out = adj.adjust(_series("sim", 289.0, 4))
    assert out.device.type == "cpu" and out.shape == (YEARS * 365, 3)


def test_percentiles_and_bootstrap_on_cpu_tensors(no_default):
    from xclim_tpu_torch.indicators import atmos

    tasmax = _series("tasmax", 295.0, 5)
    tasmax.attrs["cell_methods"] = "time: maximum"
    per = percentile_doy(tasmax, window=5, per=90)
    assert per.device.type == "cpu"
    tx = atmos.tx90p(tasmax, tasmax_per=per, freq="YS", bootstrap=True)
    wsdi = atmos.warm_spell_duration_index(tasmax, tasmax_per=per, window=3,
                                           freq="YS", bootstrap=True)
    assert tx.device.type == wsdi.device.type == "cpu"


def test_ensemble_percentiles_on_cpu_tensors(no_default):
    from xclim_tpu_torch.ensembles import (
        create_ensemble,
        ensemble_percentiles,
        robustness_fractions,
    )

    ens = create_ensemble([_series("tas", 285.0, 10 + m) for m in range(5)])
    per = ensemble_percentiles(ens, values=[10, 50, 90])
    assert all(v.device.type == "cpu" for v in per.values())
    rf = robustness_fractions(ens.isel(time=slice(730, 1460)),
                              ens.isel(time=slice(0, 730)), test="ttest",
                              weights=np.ones(5))
    assert rf["changed"].device.type == "cpu"


def test_threshold_and_spell_indicators_on_cpu_tensors(no_default):
    from xclim_tpu_torch import climjit, climjit_chain, indices
    from xclim_tpu_torch.indicators import atmos

    tasmax = _series("tasmax", 295.0, 20)
    tasmax.attrs["cell_methods"] = "time: maximum"
    tasmin = _series("tasmin", 288.0, 21)
    tasmin.attrs["cell_methods"] = "time: minimum"
    outs = [
        atmos.tx_days_above(tasmax, thresh="25 degC", freq="YS"),
        atmos.heat_wave_frequency(tasmin, tasmax, thresh_tasmin="15 degC",
                                  thresh_tasmax="22 degC", freq="YS"),
        atmos.growing_season_length(tasmin, freq="YS"),
        atmos.degree_days_exceedance_date(tasmin, freq="YS"),
        atmos.heat_spell_frequency(tasmin=tasmin, tasmax=tasmax),
        *climjit_chain([indices.tx_days_above, indices.tx_days_below])(
            tasmax, freq="MS"),
        climjit(indices.hot_spell_max_magnitude)(tasmax),
    ]
    events = indices.run_length.find_events(tasmax > 296.0, 2, freq="YS")
    assert all(o.device.type == "cpu" for o in outs)
    assert all(v.device.type == "cpu" for v in events.values())


def test_rest_of_sdba_and_stats_on_cpu_tensors(no_default, tmp_path):
    import xclim_tpu_torch.sdba as sdba
    from xclim_tpu_torch.indices import stats
    from xclim_tpu_torch.sdba import measures, processing, properties

    ref, hist, sim = (_series(n, mu, s) for n, mu, s in
                      (("ref", 285.0, 30), ("hist", 287.0, 31),
                       ("sim", 289.0, 32)))
    month = sdba.Grouper("time.month")
    dqm = sdba.DetrendedQuantileMapping.train(
        ref, hist, group=sdba.Grouper("time.dayofyear", 31), nquantiles=10)
    outs = [dqm.adjust(sim),
            sdba.Scaling.train(ref, hist, group=month).adjust(sim),
            sdba.LOCI.train(ref, hist, group=month, thresh="280 K").adjust(sim)]
    ev = sdba.ExtremeValues.train(ref, hist, cluster_thresh="290 K",
                                  q_thresh=0.5)
    outs.append(ev.adjust(outs[0], sim))
    dqm.save(tmp_path / "dqm.npz")
    back = sdba.DetrendedQuantileMapping.load(tmp_path / "dqm.npz",
                                              device="cpu")
    outs.append(back.adjust(sim))
    mv = processing.stack_variables({"a": ref, "b": hist}).isel(x=0)
    mv = mv.copy(data=torch.nan_to_num(mv.data, nan=285.0))
    ha, _ = sdba.npdf_transform(mv, mv, None, n_iter=2, nquantiles=10)
    outs += [ha, sdba.OTC.adjust(mv.isel(time=slice(0, 300)),
                                 mv.isel(time=slice(300, 600)), n_iter=5),
             sdba.dOTC.adjust(mv.isel(time=slice(0, 300)),
                              mv.isel(time=slice(300, 600)),
                              mv.isel(time=slice(600, 900)), n_iter=5),
             processing.jitter_under_thresh(ref, "280 K"),
             processing.adapt_freq(ref, sim, thresh="280 K")[0],
             processing.normalize(ref)[0],
             properties.quantile(sim), properties.acf(sim),
             properties.spell_length_distribution(sim, thresh="290 K"),
             properties.return_value(sim, period=5),
             measures.rmse(sim, ref),
             stats.fit(sim.resample("YS").max(), "genextreme"),
             stats.standardized_index(sim, freq="MS", dist="norm",
                                      zero_inflated=False)]
    assert all(o.device.type == "cpu" for o in outs)
    with pytest.raises(AssertionError, match="default_device"):
        sdba.DetrendedQuantileMapping.load(tmp_path / "dqm.npz")


def _with_lat(da, units, name, standard_name=None):
    """da's data as another variable on a (time, lat) grid."""
    attrs = {"units": units}
    if standard_name:
        attrs["standard_name"] = standard_name
    return ClimArray(da.data, ("time", "lat"),
                     {"time": da.time, "lat": np.array([10.0, 45.0, -40.0])},
                     attrs, name)


def test_index_breadth_on_cpu_tensors(no_default):
    """converters, helpers, _agro, _anuclim, _hydrology and _synoptic on
    CPU tensors: the solar helpers take the data's device, the chill scan
    keeps its carry there."""
    from xclim_tpu_torch import indices
    from xclim_tpu_torch.indices import helpers

    tas = _with_lat(_series("tas", 285.0, 40), "K", "tas", "air_temperature")
    tasmin = _with_lat(_series("tasmin", 279.0, 41), "K", "tasmin")
    tasmax = _with_lat(_series("tasmax", 291.0, 42), "K", "tasmax")
    rad = {n: _with_lat(_series(n, mu, s).copy(
        data=torch.nan_to_num(_series(n, mu, s).data.abs(), nan=mu)),
        "W m-2", n) for n, mu, s in (("rsds", 200.0, 43), ("rsus", 40.0, 44),
                                     ("rlds", 300.0, 45), ("rlus", 380.0, 46))}
    hurs = _with_lat(_series("hurs", 70.0, 47), "%", "hurs")
    wind = _with_lat(_series("sfcWind", 5.0, 48).copy(
        data=_series("sfcWind", 5.0, 48).data.abs()), "m s-1", "sfcWind")
    pr = _with_lat((_series("pr", 0.0, 49) * 1e-5).copy(
        data=(_series("pr", 0.0, 49).data * 1e-5).clamp(min=0)),
        "kg m-2 s-1", "pr", "precipitation_flux")
    outs = [indices.potential_evapotranspiration(
        tasmin=tasmin, tasmax=tasmax, tas=tas, hurs=hurs, sfcWind=wind, pr=pr,
        method=m, **rad) for m in ("BR65", "HG85", "DA02", "MB05", "TW48",
                                   "FAO_PM98")]
    outs += [indices.universal_thermal_climate_index(tas, hurs, wind, **rad),
             indices.clearness_index(rad["rsds"]),
             indices.rain_approximation(pr, tas, method="dai_seasonal"),
             indices.precip_accumulation(pr, tas=tas, phase="solid"),
             indices.liquid_precip_ratio(pr, tas=tas),
             indices.huglin_index(tas, tasmax),
             indices.biologically_effective_degree_days(tasmin, tasmax),
             indices.cool_night_index(tasmin),
             indices.dryness_index(pr, pr.copy(data=pr.data * 0.5)),
             indices.effective_growing_degree_days(tasmax, tasmin),
             indices.hardiness_zones(tasmin, window=2),
             indices.prcptot_wetdry_quarter(pr),
             indices.tg_mean_wetdry_quarter(tas, pr),
             indices.antecedent_precipitation_index(pr),
             indices.sen_slope(ClimArray(tas.data, tas.dims,
                                         dict(tas.coords),
                                         {"units": "m3 s-1"}, "q"))[0],
             helpers.make_hourly_temperature(tasmin, tasmax),
             helpers.jones_day_length_latitude_coefficient(
                 tas.time, np.array([45.0]), device="cpu")]
    outs += list(indices.rain_season(pr))
    hourly = helpers.make_hourly_temperature(tasmin.isel(time=slice(0, 60)),
                                             tasmax.isel(time=slice(0, 60)))
    outs += [indices.chill_portions(hourly), indices.chill_units(hourly)]
    ua = ClimArray(tas.data, tas.dims, dict(tas.coords), {"units": "m s-1"},
                   "ua")
    outs += list(indices.jetstream_metric_woollings(ua))
    assert all(o.device.type == "cpu" for o in outs)
    with pytest.raises(AssertionError, match="default_device"):
        helpers.day_lengths(tas.time, np.array([45.0]))


def test_precip_convert_indicators_and_chain_on_cpu_tensors(no_default):
    from xclim_tpu_torch import climjit_chain
    from xclim_tpu_torch.core.indicator import registry
    from xclim_tpu_torch.indicators import atmos, convert

    tas = _series("tas", 285.0, 50)
    pr = _series("pr", 0.0, 51)
    pr = ClimArray((pr.data * 1e-5).clamp(min=0), pr.dims, dict(pr.coords),
                   {"units": "kg m-2 s-1",
                    "standard_name": "precipitation_flux"}, "pr")
    ws = ClimArray(tas.data * 0 + 5.0, tas.dims, dict(tas.coords),
                   {"units": "m s-1", "standard_name": "wind_speed"},
                   "sfcWind")
    outs = [atmos.cdd(pr), atmos.precip_accumulation(pr),
            atmos.liquid_precip_accumulation(pr, tas=tas),
            atmos.wet_spell_max_length(pr), atmos.windy_days(ws),
            atmos.rain_season(pr)[0], convert.rain_approximation(pr, tas),
            convert.wind_chill_index(tas, ws)]
    steps = [lambda t, p, k=k, v=v: registry[k](t if v == "tas" else p)
             for k, v in (("TG_MEAN", "tas"), ("CDD", "pr"),
                          ("PRCPTOT", "pr"))]
    outs += list(climjit_chain(steps)(tas, pr))
    assert all(o.device.type == "cpu" for o in outs)


def test_fao_allen98_host_arrays_take_the_default_device(no_default):
    """With no tensor among its inputs fao_allen98 asks default_device();
    given a CPU tensor it stays on the CPU."""
    from xclim_tpu_torch.indices import converters

    rng = np.random.default_rng(52)
    rn, t, w, es, ea = (rng.uniform(lo, hi, 4).astype(np.float32)
                        for lo, hi in ((5, 20), (5, 30), (0.5, 6),
                                       (1.5, 4.0), (0.5, 1.5)))
    with pytest.raises(AssertionError, match="default_device"):
        converters.fao_allen98(rn, t, w, es, ea, 0.1, 0.066)
    assert converters.fao_allen98(torch.as_tensor(rn), t, w, es, ea, 0.1,
                                  0.066).device.type == "cpu"


def test_fire_indices_and_indicators_on_cpu_tensors(no_default):
    """CFFWIS (always on, with a season, overwintering and a dry start),
    the KBDI -> DF -> FFDI chain and the fire season on CPU tensors, with
    initial codes given as numpy arrays: the day lengths and the state go
    to the data's device."""
    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.indices import fire

    tas = _with_lat(_series("tas", 285.0, 60), "K", "tas", "air_temperature")
    tasmax = _with_lat(_series("tasmax", 291.0, 61), "K", "tasmax")
    pr = _with_lat(_series("pr", 0.0, 62).copy(
        data=(_series("pr", 0.0, 62).data * 1e-5).clamp(min=0)),
        "kg m-2 s-1", "pr", "precipitation_flux")
    hurs = _with_lat(_series("hurs", 70.0, 63), "%", "hurs")
    wind = _with_lat(_series("sfcWind", 5.0, 64).copy(
        data=_series("sfcWind", 5.0, 64).data.abs()), "m s-1", "sfcWind")
    tas, tasmax, pr, hurs, wind = (x.isel(time=slice(0, 400)) for x in
                                   (tas, tasmax, pr, hurs, wind))
    codes = {"dc0": np.full(3, 100.0, np.float32),
             "dmc0": np.full(3, 20.0, np.float32)}
    outs = list(fire.cffwis_indices(tas, pr, wind, hurs))
    outs += list(fire.cffwis_indices(tas, pr, wind, hurs, season_method="WF93",
                                     overwintering=True, **codes))
    outs += [fire.drought_code(tas, pr, season_method="WF93",
                               dry_start="CFS", dc0=codes["dc0"]),
             fire.fire_season(tas, method="WF93")]
    kbdi = atmos.kbdi(pr, tasmax, "800 mm/yr")
    df = atmos.df(pr, kbdi)
    outs += [kbdi, df, atmos.ffdi(df, tasmax, hurs, wind),
             atmos.fire_season(tas), atmos.cffwis(tas, pr, wind, hurs)[0]]
    assert all(o.device.type == "cpu" for o in outs)


def test_land_seaice_generic_indicators_on_cpu_tensors(no_default):
    from xclim_tpu_torch.indicators import generic, land, seaIce

    snd = _series("snd", 0.2, 65)
    snd = ClimArray(snd.data.abs(), snd.dims, dict(snd.coords),
                    {"units": "m", "standard_name": "surface_snow_thickness"},
                    "snd")
    q = _series("q", 50.0, 66)
    q = ClimArray(q.data.abs(), q.dims, dict(q.coords),
                  {"units": "m3 s-1"}, "q")
    sic = _series("siconc", 50.0, 67)
    sic = ClimArray(sic.data.clamp(0, 100), sic.dims, dict(sic.coords),
                    {"units": "%", "standard_name": "sea_ice_area_fraction"},
                    "siconc")
    area = ClimArray(torch.full((3,), 1e3), ("x",), {},
                     {"units": "km2", "standard_name": "cell_area"},
                     "areacello")
    outs = [land.snd_season_length(snd), land.snd_days_above(snd),
            land.snd_storm_days(snd), land.base_flow_index(q),
            land.doy_qmax(q), land.flow_index(q, p=0.95),
            seaIce.sea_ice_extent(sic, area), seaIce.sea_ice_area(sic, area),
            generic.stats(q, freq="YS", op="max"),
            generic.fit(generic.stats(q, freq="MS", op="max"), dist="norm"),
            generic.return_level(q, mode="max", t=2, dist="gumbel_r")]
    assert all(o.device.type == "cpu" for o in outs)


def test_calendar_array_operations_on_cpu_tensors(no_default):
    from xclim_tpu_torch.core import calendar as cal

    tas = _series("tas", 285.0, 68)
    doys = ClimArray(torch.full((3,), 100.0), ("x",), {}, {}, "d")
    outs = [cal.stack_periods(tas, window=2, stride=1),
            cal.unstack_periods(cal.stack_periods(tas, window=2)),
            cal.convert_calendar(tas, "360_day"),
            cal.convert_calendar(tas, "standard", missing=np.nan),
            cal.mask_between_doys(tas, (60, 200)),
            cal.mask_between_doys(tas, (doys, doys + 50)),
            cal.select_time(tas, season="JJA"),
            cal.convert_doy(tas.resample("YS").max(), "360_day"),
            cal.within_bnds_doy(tas, low=torch.full((365, 3), 280.0),
                                high=torch.full((365, 3), 290.0))]
    mu, sd = cal.climatological_mean_doy(tas.data, tas.time)
    assert all(o.device.type == "cpu" for o in outs)
    assert mu.device.type == "cpu" and sd.device.type == "cpu"
    with pytest.raises(AssertionError, match="default_device"):
        cal.climatological_mean_doy(tas.values, tas.time)


def test_yaml_modules_on_cpu_tensors(no_default):
    from xclim_tpu_torch.indicators import anuclim, cf, icclim

    tas = _series("tas", 285.0, 69)
    tasmax = _series("tasmax", 291.0, 70)
    tasmax.attrs["cell_methods"] = "time: maximum"
    outs = [icclim.TG(tas, freq="YS"), icclim.SU(tasmax, freq="YS"),
            anuclim.P4_TempSeasonality(tas), cf.txx(tasmax, freq="MS"),
            cf.ctmgeTT(tas, threshold="10 degC", freq="YS")]
    assert all(o.device.type == "cpu" for o in outs)


def test_dataflags_and_analogs_on_cpu_tensors(no_default):
    from xclim_tpu_torch import analog
    from xclim_tpu_torch.core.dataarray import ClimDataset
    from xclim_tpu_torch.core.dataflags import data_flags, ecad_compliant

    tas = _series("tas", 285.0, 71)
    ds = ClimDataset({"tas": tas, "tasmax": _series("tasmax", 291.0, 72)})
    flags = data_flags(tas, ds, freq="MS")
    assert all(v.device.type == "cpu" for v in flags.values() if v is not None)
    assert ecad_compliant(ds)["ecad_qc_flag"].device.type == "cpu"
    target = ClimArray(torch.randn(30, 2), ("time", "variables"))
    cand = ClimArray(torch.randn(30, 2, 3), ("time", "variables", "x"))
    for method in ("kldiv", "friedman_rafsky"):
        out = analog.spatial_analogs(target, cand, method=method)
        assert out.device.type == "cpu" and out.shape == (3,)


def test_io_cli_and_helpers_take_the_device_they_are_given(tmp_path, no_default):
    from xclim_tpu_torch.cli import Pipeline, get_indicator
    from xclim_tpu_torch.io import open_dataset, to_netcdf
    from xclim_tpu_torch.parallel import sharded_jit, space_mesh
    from xclim_tpu_torch.testing import generate_atmos

    ds = generate_atmos(nyears=1, device="cpu")
    to_netcdf(ds, tmp_path / "a.nc")
    back = open_dataset(tmp_path / "a.nc", device="cpu")
    assert back["tas"].device.type == "cpu"
    pipe = Pipeline(str(tmp_path / "a.nc"), device="cpu")
    pipe.indicator(get_indicator("icclim.TG"), freq="YS")
    assert pipe.finish()["TG"].device.type == "cpu"
    mesh = space_mesh(devices=[torch.device("cpu")] * 2)
    grid = ClimArray(torch.rand(10, 2, 2), ("time", "lat", "lon"))
    assert sharded_jit(lambda x: x.data.mean(0), mesh)(grid).device.type == "cpu"


def test_io_and_helpers_need_a_device_without_a_card(tmp_path, monkeypatch):
    from xclim_tpu_torch.io import open_dataset, to_netcdf
    from xclim_tpu_torch.testing import generate_atmos

    to_netcdf(generate_atmos(nyears=1, device="cpu"), tmp_path / "a.nc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_dataset(tmp_path / "a.nc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_atmos(nyears=1)
