"""The port's data flags (``xclim_tpu_torch.core.dataflags``) and spatial
analogs (``xclim_tpu_torch.analog``) against the JAX package's, on the same
numpy inputs.

Flags: 8 standard-calendar years x 3 cells of tas, tasmax, tasmin, pr,
sfcWind, wsgsmax, hurs, psl and snd with planted faults (tasmax under
tasmin, values past the physical bounds, runs of repeated values at and
away from the flag thresholds, a spike past 5 standard deviations of the
day-of-year climatology); every flag is an exact boolean equal to the
reference's, reduced over all dims, over none and by month, with the same
names, attributes and exception messages.

Analogs: a target of 30 annual samples x 3 indicators against candidate
cells of the same shape, each metric through ``spatial_analogs`` (batched
over the cells on the port) and alone. Bounds, float32 throughout:

- seuclidean, mahalanobis, kldiv: ``RTOL`` 1e-5 relative (a few float32
  sums, a 3 x 3 solve, logs of distance ratios).
- nearest_neighbor, kolmogorov_smirnov: means of 0/1 over 60 or 30
  samples: within 1e-6.
- zech_aslan: three means of -log(distance) of order 1 that cancel to
  ~0.05: ``ZA_ATOL`` 1e-5.
- szekely_rizzo: nx ny / (nx + ny) = 15 times four 900-term float32 means
  of distances of order 1-3 that cancel: ``SR_ATOL`` 2e-4.
- friedman_rafsky: the same scipy tree on the host: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.analog as janalog
from xclim_tpu.core import dataflags as jdf
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.dataarray import ClimDataset as JClimDataset
from xclim_tpu.ops.pallas import capability
import xclim_tpu_torch.analog as analog
from xclim_tpu_torch.core import dataflags as df
from xclim_tpu_torch.core.dataarray import ClimDataset

from test_torch_converters import to_port

RTOL = 1e-5
COUNT_ATOL = 1e-6
ZA_ATOL = 1e-5
SR_ATOL = 2e-4
NT = 8 * 365 + 2  # 2000-2007, standard calendar


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


#: name -> (units, mean, sd, standard_name)
FLAG_VARS = {
    "tas": ("K", 283.0, 4.0, "air_temperature"),
    "tasmax": ("K", 289.0, 4.0, "air_temperature"),
    "tasmin": ("K", 277.0, 4.0, "air_temperature"),
    "pr": ("kg m-2 s-1", 3e-5, 3e-5, "precipitation_flux"),
    "sfcWind": ("m s-1", 5.0, 2.0, "wind_speed"),
    "wsgsmax": ("m s-1", 14.0, 4.0, "wind_speed_of_gust"),
    "hurs": ("%", 70.0, 10.0, "relative_humidity"),
    "psl": ("Pa", 101300.0, 800.0, "air_pressure_at_sea_level"),
    "snd": ("m", 0.2, 0.1, "surface_snow_thickness"),
}


def _planted():
    """numpy fields (NT, 3) with one fault of each kind in cell 1 or 2;
    cell 0 is clean."""
    rng = np.random.default_rng(11)
    season = 10 * np.cos(2 * np.pi * (np.arange(NT) - 200) / 365.25)
    out = {}
    for i, (k, (_, mu, sd, _)) in enumerate(FLAG_VARS.items()):
        x = mu + rng.normal(0, sd, (NT, 3))
        if k.startswith("tas"):
            x += season[:, None]
        if k in ("pr", "sfcWind", "wsgsmax", "snd"):
            x = np.abs(x)
        out[k] = x
    d = 86400.0
    out["tasmax"][100, 1] = out["tasmin"][100, 1] - 1.0   # tasmax < tasmin
    out["tas"][200, 2] = out["tasmax"][200, 2] + 0.5       # tas > tasmax
    out["tas"][300, 1] = out["tasmin"][300, 1] - 0.5       # tas < tasmin
    out["tasmax"][400, 2] = 273.15 + 61.0                  # > 60 degC
    out["tasmin"][500, 1] = 273.15 - 91.0                  # < -90 degC
    out["tasmin"][600:606, 2] = 271.5                      # 6 repeats
    out["tas"][700, 2] += 80.0                             # > 5 sd
    out["pr"][50, 1] = -1e-5                               # negative
    out["pr"][60, 2] = 301.0 / d                           # > 300 mm/d
    out["pr"][70:75, 1] = 5.0 / d                          # 5 x 5 mm/d
    out["pr"][80:90, 2] = 1.0 / d                          # 10 x 1 mm/d
    out["pr"][95:103, 0] = 2.0 / d                         # away from thresholds
    out["sfcWind"][30, 1] = 47.0                           # > 46 m/s
    out["sfcWind"][40:46, 2] = 3.0                         # 6 x 3 m/s > 2
    out["wsgsmax"][120:125, 1] = 5.0                       # 5 x 5 m/s > 4
    out["hurs"][10, 2] = 101.0                             # > 100 %
    out["psl"][900:905, 1] = 101000.0                      # 5 repeats
    out["snd"][20, 2] = -0.01                              # negative
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def flag_data():
    t = jdate_range("2000-01-01", periods=NT, calendar="standard")
    jds = JClimDataset()
    for k, x in _planted().items():
        units, _, _, sn = FLAG_VARS[k]
        jds[k] = JClimArray(jnp.asarray(x), ("time", "site"),
                            {"time": t, "site": np.arange(3)},
                            {"units": units, "standard_name": sn}, k)
    pds = ClimDataset({k: to_port(v) for k, v in jds.items()})
    return jds, pds


def _same_flags(got, exp):
    assert list(got.keys()) == list(exp.keys())
    for k in exp:
        if exp[k] is None:
            assert got[k] is None, k
            continue
        g, e = got[k], exp[k]
        assert g.dims == e.dims and g.name == e.name and g.attrs == e.attrs, k
        assert g.data.dtype == torch.bool, k
        np.testing.assert_array_equal(g.values, np.asarray(e.values), err_msg=k)


@pytest.mark.parametrize("reduce", [{}, {"dims": None}, {"freq": "MS"}])
@pytest.mark.parametrize("var", list(FLAG_VARS))
def test_data_flags_equal_the_reference(var, reduce, flag_data):
    jds, pds = flag_data
    exp = jdf.data_flags(jds[var], jds, **reduce)
    got = df.data_flags(pds[var], pds, **reduce)
    _same_flags(got, exp)
    if reduce == {"dims": None}:
        # the planted fault raises its flag somewhere
        assert any(bool(v.values.any()) for v in got.values() if v is not None)


def test_data_flags_without_companions(flag_data):
    jds, pds = flag_data
    _same_flags(df.data_flags(pds["tas"]), jdf.data_flags(jds["tas"]))


def test_ecad_compliant_equals_the_reference(flag_data):
    jds, pds = flag_data
    exp = jdf.ecad_compliant(jds, dims=None)
    got = df.ecad_compliant(pds, dims=None)
    assert list(got.keys()) == list(exp.keys())
    np.testing.assert_array_equal(got["ecad_qc_flag"].values,
                                  np.asarray(exp["ecad_qc_flag"].values))
    assert got["ecad_qc_flag"].attrs == exp["ecad_qc_flag"].attrs
    e = df.ecad_compliant(pds, append=False)
    assert e.name == "ecad_qc_flag" and not bool(e.values)


def test_raise_flags_messages(flag_data):
    jds, pds = flag_data
    with pytest.raises(jdf.DataQualityException) as jerr:
        jdf.data_flags(jds["pr"], jds, raise_flags=True)
    with pytest.raises(df.DataQualityException) as perr:
        df.data_flags(pds["pr"], pds, raise_flags=True)
    assert str(perr.value) == str(jerr.value)
    assert perr.value.flags == jerr.value.flags
    with pytest.raises(df.DataQualityException):
        df.ecad_compliant(pds, raise_flags=True)
    with pytest.raises(NotImplementedError, match="do not exist for 'x'"):
        df.data_flags(pds["tas"].rename("x"), raise_flags=True)
    assert len(df.data_flags(pds["tas"].rename("x"))) == 0


@pytest.mark.parametrize("func,kwargs", [
    ("values_op_thresh_repeating_for_n_or_more_days",
     {"op": "eq", "n": 5, "thresh": "5 mm d-1"}),
    ("values_op_thresh_repeating_for_n_or_more_days",
     {"op": ">", "n": 6, "thresh": "2.0 m s-1"}),
    ("outside_n_standard_deviations_of_climatology", {"n": 5}),
    ("values_repeating_for_n_or_more_days", {"n": 5}),
    ("temperature_extremely_low", {"thresh": "-40.5 degC"}),
    ("wind_values_outside_of_bounds", None),
])
def test_flag_keys(func, kwargs):
    f, template = df._REGISTRY[func]
    jf, jtemplate = jdf._REGISTRY[func]
    assert template == jtemplate
    assert df._flag_key(f, template, kwargs) == jdf._flag_key(jf, jtemplate, kwargs)


def _samples(seed, n=30, d=3, shift=0.0, scale=1.0):
    return (np.random.default_rng(seed).normal(shift, scale, (n, d))
            .astype(np.float32))


#: metric -> (rtol, atol)
ANALOG_TOL = {
    "seuclidean": (RTOL, 0.0),
    "nearest_neighbor": (0.0, COUNT_ATOL),
    "zech_aslan": (0.0, ZA_ATOL),
    "szekely_rizzo": (0.0, SR_ATOL),
    "mahalanobis": (RTOL, 0.0),
    "kolmogorov_smirnov": (0.0, COUNT_ATOL),
    "kldiv": (RTOL, 0.0),
    "friedman_rafsky": (0.0, 0.0),
}
CELLS = 6


@pytest.fixture(scope="module")
def analog_data():
    target = _samples(0)
    cand = np.stack([_samples(10 + s, shift=0.3 * s, scale=1.0 + 0.1 * s)
                     for s in range(CELLS)], axis=-1)  # (n, d, cells)
    t = jdate_range("2000-01-01", periods=30, freq="YS")
    jt = JClimArray(jnp.asarray(target), ("time", "variables"), {"time": t},
                    {}, "target")
    jc = JClimArray(jnp.asarray(cand), ("time", "variables", "site"),
                    {"time": t, "site": np.arange(CELLS)}, {}, "cand")
    return target, cand, jt, jc


@pytest.mark.parametrize("method", list(ANALOG_TOL))
def test_spatial_analogs_equal_the_reference(method, analog_data):
    target, cand, jt, jc = analog_data
    exp = janalog.spatial_analogs(jt, jc, method=method)
    got = analog.spatial_analogs(to_port(jt), to_port(jc), method=method)
    assert got.dims == exp.dims == ("site",) and got.attrs == exp.attrs
    assert got.name == exp.name and got.data.dtype == torch.float32
    rtol, atol = ANALOG_TOL[method]
    np.testing.assert_allclose(got.values, np.asarray(exp.values),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", [m for m in ANALOG_TOL if m != "friedman_rafsky"])
def test_metric_alone_equals_the_reference(method, analog_data):
    target, cand, _, _ = analog_data
    y = np.ascontiguousarray(cand[:, :, 2])
    exp = float(janalog.metrics[method](jnp.asarray(target), jnp.asarray(y)))
    got = analog.metrics[method](torch.as_tensor(target), torch.as_tensor(y))
    assert got.shape == ()
    rtol, atol = ANALOG_TOL[method]
    np.testing.assert_allclose(float(got), exp, rtol=rtol, atol=atol)


def test_analog_options(analog_data):
    target, cand, jt, jc = analog_data
    x, y = torch.as_tensor(target), torch.as_tensor(cand[:, :, 1])
    jx, jy = jnp.asarray(target), jnp.asarray(cand[:, :, 1])
    np.testing.assert_allclose(
        float(analog.szekely_rizzo(x, y, standardize=False)),
        float(janalog.szekely_rizzo(jx, jy, standardize=False)), atol=SR_ATOL)
    np.testing.assert_allclose(float(analog.kldiv(x, y, k=3)),
                               float(janalog.kldiv(jx, jy, k=3)), rtol=RTOL)
    got = analog.spatial_analogs(to_port(jt), to_port(jc), method="kldiv", k=2)
    exp = janalog.spatial_analogs(jt, jc, method="kldiv", k=2)
    np.testing.assert_allclose(got.values, np.asarray(exp.values), rtol=RTOL)
    assert analog.friedman_rafsky(x, y) == janalog.friedman_rafsky(
        np.asarray(jx), np.asarray(jy))
    sx, sy = analog.standardize(x, y)
    jsx, jsy = janalog.standardize(jx, jy)
    np.testing.assert_allclose(sx.numpy(), np.asarray(jsx), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), rtol=RTOL, atol=1e-6)


def test_registered_metric_runs_per_cell(analog_data):
    """A user's metric (registered with ``metric``) sees one cell at a time."""
    target, cand, jt, jc = analog_data
    shapes = []

    @analog.metric
    def mean_gap(x, y):
        shapes.append(tuple(y.shape))
        return (x.mean(0) - y.mean(0)).abs().sum()

    try:
        got = analog.spatial_analogs(to_port(jt), to_port(jc), method="mean_gap")
    finally:
        del analog.metrics["mean_gap"]
    want = np.abs(target.mean(0)[:, None] - cand.mean(0)).sum(0)
    np.testing.assert_allclose(got.values, want, rtol=RTOL)
    assert shapes == [(30, 3)]
