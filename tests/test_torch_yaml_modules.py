"""The port's YAML virtual modules (``xclim_tpu_torch.indicators.icclim``,
``anuclim``, ``cf``: 131 indicators) against the JAX package's, on the same
numpy inputs: seeded daily fields of 4 noleap years x 4 x 4 cells (1 % NaN,
half the precipitation days dry, snow in winter), with the percentile
inputs (``tas_per``, ``tasmax_per``, ``tasmin_per``, ``pr_per``) computed
once by the JAX package's ``percentile_doy`` over another draw of the same
climate (a base period) and carried into the port
(``from_reference_percentiles``), through the reference's XLA route. The
JAX side of each module is computed once, in a module fixture.

Each output is compared with its values, NaN pattern, dims, name and
attributes (history but for its timestamp and package name): counts, run
lengths and days of year equal, floats within ``RTOL`` (1e-6) relative
(the port sums periods in float64 and rounds once, the reference adds
float32 partials). Stated exceptions: none.

Also: the registry's keys, identifiers, modules and attributes, the French
translations, the JSON copies of the module files against
``yaml.safe_load`` of the JAX package's YAML, the schema's errors (the
reference's messages), a module built from a user's file (its registry
entries removed afterwards), the ``compute:`` path rule, and the clix-meta
adapter.
"""

import inspect
import json
import pathlib
import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import xclim_tpu
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.dataarray import ClimDataset as JClimDataset
from xclim_tpu.core.indicator import registry as jregistry
from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
from xclim_tpu.ops.pallas import capability
import xclim_tpu_torch
import xclim_tpu_torch.indicators  # noqa: F401  (builds the YAML modules)
from xclim_tpu_torch.core.dataarray import ClimDataset
from xclim_tpu_torch.core.indicator import registry
from xclim_tpu_torch.core.percentiles import from_reference_percentiles

from test_torch_converters import close, to_port

RTOL = 1e-6
YEARS = 4
NT = 365 * YEARS
SHAPE = (4, 4)
LAT = np.array([-40.0, 10.0, 45.0, 60.0])
MODULES = ("icclim", "anuclim", "cf")
ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = {m: sorted(k for k in jregistry if k.startswith(f"{m}."))
        for m in MODULES}


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _t(cm):
    return {"standard_name": "air_temperature", "cell_methods": cm}


#: name -> (units, mean, sd, seasonal amplitude, attrs, options)
SPECS = {
    "tas": ("K", 281.0, 4.0, 12.0, _t("time: mean"), {}),
    "tasmax": ("K", 287.0, 4.0, 12.0, _t("time: maximum"), {}),
    "tasmin": ("K", 275.0, 4.0, 12.0, _t("time: minimum"), {}),
    "pr": ("kg m-2 s-1", 0.0, 7e-5, 0.0,
           {"standard_name": "precipitation_flux"},
           {"exponential": True, "dry": 0.5}),
    "snd": ("m", 0.05, 0.3, -0.3, {"standard_name": "surface_snow_thickness"},
            {"clip": 0.0}),
    "hurs": ("%", 70.0, 15.0, 0.0, {"standard_name": "relative_humidity"}, {}),
    "psl": ("Pa", 101300.0, 900.0, 0.0,
            {"standard_name": "air_pressure_at_sea_level"}, {}),
    "sfcWind": ("m s-1", 5.0, 3.0, 0.0, {"standard_name": "wind_speed"},
                {"positive": True}),
    "wsgsmax": ("m s-1", 14.0, 5.0, 0.0, {"standard_name": "wind_speed_of_gust"},
                {"positive": True}),
    "sund": ("s", 20000.0, 12000.0, 8000.0, {"standard_name": "duration_of_sunshine"},
             {"clip": 0.0}),
}
#: the units of pr each module is given: anuclim's precipitation totals
#: convert their output to "mm", which needs an amount rate
PR_UNITS = {"icclim": "kg m-2 s-1", "anuclim": "mm d-1", "cf": "kg m-2 s-1"}
#: percentile input -> (variable, percentile)
PERCENTILES = {"tas_per": ("tas", 90), "tasmax_per": ("tasmax", 90),
               "tasmin_per": ("tasmin", 10), "pr_per": ("pr", 75)}


def _field(name, seed, units=None):
    spec_units, mu, sd, seas, attrs, opt = SPECS[name]
    units = units or spec_units
    if units != spec_units:  # pr as an amount rate
        mu, sd = mu * 86400.0, sd * 86400.0
    rng = np.random.default_rng(seed)
    season = np.cos(2 * np.pi * (np.arange(NT) % 365 - 200) / 365.0)
    north = np.sign(LAT)[None, :, None]
    noise = rng.normal(0, sd, (NT,) + SHAPE)
    if opt.get("exponential"):
        noise = rng.exponential(sd, (NT,) + SHAPE)
    elif spec_units == "K":
        # an AR(1) anomaly (0.8 a day): warm and cold spells
        for t in range(1, NT):
            noise[t] = 0.8 * noise[t - 1] + 0.6 * noise[t]
    x = mu + seas * season[:, None, None] * north + noise
    if opt.get("positive"):
        x = np.abs(x)
    if "clip" in opt:
        x = np.clip(x, opt["clip"], None)
    if "dry" in opt:
        x[rng.random(x.shape) < opt["dry"]] = 0.0
    # 1 % missing in one cell: its missing-value mask
    x[:, 0, 0][rng.random(NT) < 0.01] = np.nan
    t = jdate_range("2000-01-01", periods=NT, calendar="noleap")
    return JClimArray(jnp.asarray(x.astype(np.float32)), ("time", "lat", "lon"),
                      {"time": t, "lat": LAT, "lon": np.arange(float(SHAPE[1]))},
                      dict({"units": units}, **attrs), name)


def _datasets(pr_units):
    units = {"pr": pr_units}
    jds = JClimDataset({k: _field(k, i, units.get(k))
                        for i, k in enumerate(SPECS)})
    for key, (var, per) in PERCENTILES.items():
        # thresholds of a base period: another draw of the same climate
        base = _field(var, 100 + list(SPECS).index(var), units.get(var))
        jds[key] = jpercentile_doy(base, window=5, per=per)
    pds = ClimDataset()
    for k, v in jds.items():
        if k in PERCENTILES:
            pds[k] = from_reference_percentiles(
                np.asarray(v.data), v.dims, v.coords, v.attrs, name=k,
                device="cpu")
        else:
            pds[k] = to_port(v)
    return jds, pds


@pytest.fixture(scope="module")
def datasets():
    """Per module, the same inputs as the JAX package's and the port's
    ClimDatasets."""
    return {m: _datasets(PR_UNITS[m]) for m in MODULES}


def _kwargs(ind):
    """freq="YS" where the indicator takes a freq that its module does not
    set; a threshold of 10 degC where the module leaves it open (cf's
    ``*TT`` temperature spells and sums)."""
    out = {}
    for name, value in (("freq", "YS"), ("threshold", "10 degC")):
        p = ind.parameters.get(name)
        if p is not None and not p.injected and (
                name == "freq" or p.default is inspect.Parameter.empty):
            out[name] = value
    return out


def _run(ind, ds):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ind(ds=ds, **_kwargs(ind))


def _outcome(ind, ds):
    """The indicator's output, or the error it raised."""
    try:
        return _run(ind, ds)
    except Exception as err:  # noqa: BLE001  (compared with the port's)
        return err


@pytest.fixture(scope="module")
def reference(datasets):
    """Every YAML indicator's output (or error) in the JAX package, computed
    once."""
    return {key: _outcome(jregistry[key], datasets[m][0]) for m in MODULES
            for key in KEYS[m]}


def test_module_sizes():
    assert {m: len(k) for m, k in KEYS.items()} == {"icclim": 55, "anuclim": 19,
                                                    "cf": 57}


@pytest.mark.parametrize("key", [k for m in MODULES for k in KEYS[m]])
def test_yaml_indicator_matches_reference(key, datasets, reference):
    exp = reference[key]
    got = _outcome(registry[key], datasets[key.split(".")[0]][1])
    if isinstance(exp, Exception):
        # the reference refuses these inputs: the port refuses them alike
        assert type(got).__name__ == type(exp).__name__, got
        assert str(got) == str(exp)
        return
    assert not isinstance(got, Exception), got
    close(got, exp, rtol=RTOL)


def _port_keys():
    """The port's registry keys but those a test builds and removes."""
    return {k for k, v in registry.items()
            if v.module is None or v.module in MODULES}


def test_registry_equals_the_reference():
    """The port's 349 registry entries are the reference's: key,
    identifier, module, realm, registry id and ``json()`` (attributes,
    parameters, outputs). The reference's registry may hold entries its own
    tests leaked, so the comparison runs over the port's keys."""
    keys = _port_keys()
    assert len(keys) == 349
    for k in sorted(keys):
        p, j = registry[k], jregistry[k]
        assert (p.identifier, p.module, p.realm, p._registry_id) == (
            j.identifier, j.module, j.realm, j._registry_id), k
        assert json.dumps(p.json(), default=str, sort_keys=True) == json.dumps(
            j.json(), default=str, sort_keys=True), k


@pytest.mark.parametrize("module", MODULES)
def test_virtual_module_attributes(module):
    import importlib

    pm = importlib.import_module(f"xclim_tpu_torch.indicators.{module}")
    jm = importlib.import_module(f"xclim_tpu.indicators.{module}")
    names = sorted(n for n, _ in jm.iter_indicators())
    assert sorted(n for n, _ in pm.iter_indicators()) == names
    for n in names:
        assert getattr(pm, n) is registry[f"{module}.{n.upper()}"]
    assert pm.__doc__ == jm.__doc__


@pytest.mark.parametrize("key", ["icclim.TG", "icclim.SU", "anuclim.P4_TEMPSEASONALITY",
                                 "cf.CDD"])
def test_french_metadata(key, datasets):
    """Under metadata_locales=["fr"] the outputs carry the reference's
    French attributes."""
    from xclim_tpu.core.options import set_options as jset_options
    from xclim_tpu_torch.core.options import set_options

    m = key.split(".")[0]
    with jset_options(metadata_locales=["fr"]):
        exp = _run(jregistry[key], datasets[m][0])
    with set_options(metadata_locales=["fr"]):
        got = _run(registry[key], datasets[m][1])
    assert any(a.endswith("_fr") for a in got.attrs)
    close(got, exp, rtol=RTOL)


@pytest.mark.parametrize("module", MODULES)
def test_json_copies_equal_the_yaml(module):
    yaml = pytest.importorskip("yaml")
    with open(ROOT / "xclim_tpu" / "data" / f"{module}.yml", encoding="utf-8") as f:
        want = yaml.safe_load(f)
    with open(ROOT / "xclim_tpu_torch" / "data" / f"{module}.json",
              encoding="utf-8") as f:
        assert json.load(f) == want


#: malformed modules (the reference's tests/test_modules.py TestYamlSchema)
BAD_MODULES = {
    "unknown indicator key": "module: bad1\nindicators:\n  x:\n    computee: tg_mean\n",
    "parameter type": ("module: bad2\nindicators:\n  x:\n    base: tx_days_above\n"
                       "    parameters:\n      thresh: [30, 40]\n"),
    "no indicators": "module: bad3\nrealm: atmos\n",
    "allowed periods": ("module: bad4\nindicators:\n  x:\n    base: tg_mean\n"
                        "    allowed_periods: [X]\n"),
    "two errors": ("module: bad5\nindicators:\n  x:\n    computee: tg_mean\n"
                   "    title: 5\n"),
    "not a mapping": "- a\n- b\n",
}


@pytest.mark.parametrize("case", list(BAD_MODULES))
def test_schema_errors_are_the_references(case, tmp_path):
    from xclim_tpu.core._exceptions import ValidationError as JValidationError
    from xclim_tpu_torch.core._exceptions import ValidationError

    path = tmp_path / "bad.yml"
    path.write_text(BAD_MODULES[case])
    with pytest.raises(JValidationError) as jerr:
        xclim_tpu.build_indicator_module_from_yaml(path)
    with pytest.raises(ValidationError) as perr:
        xclim_tpu_torch.build_indicator_module_from_yaml(path)
    assert str(perr.value) == str(jerr.value)


def _forget(module):
    """Remove a test module's registry entries from both packages."""
    import sys

    for reg in (registry, jregistry):
        for k in [k for k, v in reg.items() if v.module == module]:
            del reg[k]
    for pkg in ("xclim_tpu", "xclim_tpu_torch"):
        sys.modules.pop(f"{pkg}.indicators.{module}", None)


CUSTOM = """
module: custom_port_test
realm: atmos
indicators:
  my_tg:
    base: tg_mean
  hot30:
    base: tx_days_above
    parameters:
      thresh: 30 degC
  wet_spells:
    compute: xclim_tpu.indices.generic.spell_length
    input:
      data: pr
    parameters:
      threshold: 1 mm day-1
      reducer: max
      op: '>='
    units: days
    long_name: Longest wet spell
"""


def test_module_from_a_users_file(tmp_path, datasets):
    """A user's YAML file builds the same module in both packages (a
    ``compute:`` path into the JAX package resolves to the port's module of
    the same name); the outputs agree."""
    import xclim_tpu_torch.indices.generic as pgeneric

    path = tmp_path / "custom.yml"
    path.write_text(CUSTOM)
    try:
        jm = xclim_tpu.build_indicator_module_from_yaml(path)
        pm = xclim_tpu_torch.build_indicator_module_from_yaml(path)
        assert pm.__name__ == "xclim_tpu_torch.indicators.custom_port_test"
        assert pm.wet_spells.compute.__wrapped__ is pgeneric.spell_length
        jds, pds = datasets["icclim"]
        for name in ("my_tg", "hot30", "wet_spells"):
            close(_run(getattr(pm, name), pds), _run(getattr(jm, name), jds),
                  rtol=RTOL)
    finally:
        _forget("custom_port_test")
    assert "custom_port_test.MY_TG" not in registry


def test_compute_paths_never_reach_the_jax_package():
    """``compute: xclim_tpu.<module>.<name>`` resolves to the port's module;
    a module the port lacks raises. Checked where importing jax fails."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from xclim_tpu_torch.core.indicator import _resolve_compute\n"
        "import xclim_tpu_torch.indices as I\n"
        "assert _resolve_compute('xclim_tpu.indices.tg_mean') is I.tg_mean\n"
        "assert _resolve_compute('xclim_tpu.indices.generic.statistics') is "
        "I.generic.statistics\n"
        "try:\n"
        "    _resolve_compute('xclim_tpu.no_such_module.f')\n"
        "except ValueError as err:\n"
        "    assert 'does not have' in str(err)\n"
        "else:\n"
        "    raise AssertionError('no error')\n"
        "assert not any(k.split('.')[0] == 'xclim_tpu' for k in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


CLIX_CDD = """
indices:
  cdd:
    reference: ETCCDI
    default_period: annual
    output:
      var_name: "cdd"
      standard_name: spell_length_of_days_with_lwe_thickness_of_precipitation_amount_below_threshold
      proposed_standard_name: spell_length_with_lwe_thickness_of_precipitation_amount_below_threshold
      long_name: "Maximum consecutive dry days (Precip < 1mm)"
      units: "day"
      cell_methods:
        - time: sum within days
        - time: sum over days
    input:
      data: pr
    index_function:
      name: spell_length
      parameters:
        threshold:
          kind: quantity
          standard_name: lwe_precipitation_rate
          long_name: "Wet day threshold"
          data: 1
          units: "mm day-1"
        condition:
          kind: operator
          operator: "<"
        reducer:
          kind: reducer
          reducer: max
    ET:
      short_name: "cdd"
      long_name: "Consecutive dry days"
      definition: "Maximum number of consecutive days with P<1mm"
      comment: "maximum consecutive days when daily total precipitation is below 1 mm"
"""


def test_clix_meta_adapter(tmp_path, datasets):
    """The port's clix-meta adapter writes the reference's module YAML,
    and the module it gives runs as the reference's."""
    yaml = pytest.importorskip("yaml")
    from xclim_tpu.core.utils import adapt_clix_meta_yaml as jadapt
    from xclim_tpu_torch.core.utils import adapt_clix_meta_yaml

    jadapt(CLIX_CDD, tmp_path / "j.yml")
    adapt_clix_meta_yaml(CLIX_CDD, tmp_path / "p.yml")
    got = yaml.safe_load((tmp_path / "p.yml").read_text())
    assert got == yaml.safe_load((tmp_path / "j.yml").read_text())
    assert got["indicators"]["cdd"]["parameters"]["op"] == "<"
    try:
        jm = xclim_tpu.build_indicator_module_from_yaml(tmp_path / "j.yml",
                                                        name="clix_port_test")
        pm = xclim_tpu_torch.build_indicator_module_from_yaml(
            tmp_path / "p.yml", name="clix_port_test")
        close(_run(pm.cdd, datasets["icclim"][1]),
              _run(jm.cdd, datasets["icclim"][0]), rtol=RTOL)
    finally:
        _forget("clix_port_test")


def test_core_utils_match_the_reference(tmp_path):
    """The rest of ``core/utils.py``: ``lazy_indexing`` gathers as the
    reference's ``jnp.take`` (a NaN index reads position 0, one out of
    range gives NaN), ``split_auxiliary_coordinates``, ``deprecated``,
    ``load_module`` and the dask shims."""
    import torch

    from xclim_tpu.core import utils as jutils
    from xclim_tpu.core.dataarray import ClimArray as JClimArray
    from xclim_tpu_torch.core import utils
    from xclim_tpu_torch.core.dataarray import ClimArray

    data = np.arange(6, dtype=np.float32) * 10
    for idx in ([[0, 5], [-1, 7]], [0.0, np.nan, 2.0, -7.0]):
        jidx = JClimArray(jnp.asarray(idx), ("a", "b")[:np.ndim(idx)])
        pidx = ClimArray(torch.as_tensor(np.asarray(idx)), jidx.dims)
        exp = jutils.lazy_indexing(JClimArray(jnp.asarray(data), ("time",)), jidx)
        got = utils.lazy_indexing(ClimArray(torch.as_tensor(data), ("time",)), pidx)
        np.testing.assert_array_equal(got.values, np.asarray(exp.data))
        assert got.dims == exp.dims
    da = ClimArray(torch.zeros(3, 2), ("time", "x"),
                   {"x": np.arange(2), "height": np.array(2.0)})
    out, aux = utils.split_auxiliary_coordinates(da)
    assert list(aux) == ["height"] and "height" not in out.coords
    assert utils.split_auxiliary_coordinates(out) == (out, {})

    @utils.deprecated(from_version="0.1", suggested="g")
    def f(x):
        return x + 1

    with pytest.warns(FutureWarning, match="`f` is deprecated since 0.1; use `g`"):
        assert f(1) == 2
    (tmp_path / "mod_x.py").write_text("VALUE = 3\n")
    assert utils.load_module(tmp_path / "mod_x.py").VALUE == 3
    assert utils.uses_dask(da) is False and utils.ensure_chunk_size(da, time=2) is da
    from xclim_tpu_torch.core.indicator import InputKind

    assert utils.InputKind is InputKind


def test_builder_helpers():
    """``add_iter_indicators``, ``IndicatorRegistrar`` and
    ``StandardizedIndexes`` as the reference has them."""
    import types

    from xclim_tpu.core import indicator as jind
    from xclim_tpu_torch.core import indicator as pind

    mod = types.ModuleType("m")
    mod.__all__ = ["tg", "other"]
    mod.tg, mod.other = registry["TG_MEAN"], 3
    assert list(pind.add_iter_indicators(mod).iter_indicators()) == [
        ("tg", registry["TG_MEAN"])]
    with pytest.raises(ValueError, match="No instance of IndicatorRegistrar"):
        pind.IndicatorRegistrar.get_instance()
    for attr in ("realm", "missing", "src_freq"):
        assert getattr(pind.StandardizedIndexes, attr) == getattr(
            jind.StandardizedIndexes, attr)
    assert issubclass(pind.StandardizedIndexes, pind.ResamplingIndicator)
    assert set(pind._BASE_CLASSES) == set(jind._BASE_CLASSES)
