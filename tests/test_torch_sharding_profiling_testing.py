"""The port's ``parallel.sharding``, ``utils.profiling`` and ``testing``
helpers.

Sharding: a mesh of 8 CPU devices (the JAX tests' 8-device CPU mesh,
``tests/test_sharding.py``) with the JAX package's factoring and error
text; ``pad_to_mesh`` equal to the reference's NaN padding; indicator
pipelines block by block through ``sharded_jit`` equal to the unsplit call
(counts and thresholds exactly; means within 1e-6 relative, since a
block's float32 mean may add its cells' lanes in another order). The
testing helpers give the JAX package's values for the same seed.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.parallel import pad_to_mesh, shard_space, sharded_jit, space_mesh

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


@pytest.fixture
def mesh():
    return space_mesh(devices=CPU8)


def _grid(shape=(730, 4, 4), name="tasmax", seed=0):
    rng = np.random.default_rng(seed)
    t = date_range("2001-01-01", periods=shape[0], freq="D", calendar="noleap")
    v = rng.normal(295, 8, shape).astype(np.float32)
    return ClimArray(torch.as_tensor(v), ("time", "lat", "lon"),
                     {"time": t, "lat": np.arange(shape[1]) * 1.0,
                      "lon": np.arange(shape[2]) * 1.0},
                     {"units": "K", "standard_name": "air_temperature",
                      "cell_methods": "time: maximum"}, name)


def test_mesh_shape(mesh):
    assert mesh.devices.size == 8 and mesh.shape == (2, 4)
    assert set(mesh.axis_names) == {"lat", "lon"}
    one = space_mesh()
    assert one.shape == (1, 1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_factoring_is_the_references(n):
    from xclim_tpu.parallel import space_mesh as jspace_mesh

    assert space_mesh(n, devices=CPU8).shape == jspace_mesh(n).devices.shape
    assert space_mesh(n, shape=(1, n), devices=CPU8).shape == (1, n)


def test_too_many_devices_error():
    from xclim_tpu.parallel import space_mesh as jspace_mesh

    with pytest.raises(ValueError, match="only .* visible") as perr:
        space_mesh(16, devices=CPU8)
    with pytest.raises(ValueError) as jerr:
        jspace_mesh(len(jax.devices()) * 2)
    first = str(jerr.value).split(". ")[0]
    assert str(perr.value).split(". ")[0] == first
    assert "devices=[torch.device('cpu')] * 16" in str(perr.value)


@pytest.mark.parametrize("shape", [(5, 7), (4, 8), (3, 721 % 8 + 1)])
def test_pad_to_mesh_is_the_references(shape, mesh):
    from xclim_tpu.parallel import space_mesh as jspace_mesh
    from xclim_tpu.parallel.sharding import pad_to_mesh as jpad_to_mesh

    x = np.random.default_rng(1).normal(size=(3,) + shape).astype(np.float32)
    got, unpad = pad_to_mesh(torch.as_tensor(x), mesh)
    exp, junpad = jpad_to_mesh(jnp.asarray(x), jspace_mesh())
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert torch.equal(unpad(got), torch.as_tensor(x))
    assert got.shape[-2] % 2 == 0 and got.shape[-1] % 4 == 0


def test_blocks_keep_their_coordinates(mesh):
    da = _grid((10, 5, 7))
    blocks = shard_space(da, mesh)
    assert blocks.shape == (2, 4)
    np.testing.assert_array_equal(
        np.concatenate([b.coords["lon"] for b in blocks[0]]), da.coords["lon"])
    np.testing.assert_array_equal(
        np.concatenate([b.coords["lat"] for b in blocks[:, 0]]), da.coords["lat"])
    for (i, j), b in np.ndenumerate(blocks):
        assert b.device == mesh.devices[i, j]
    joined = torch.cat([torch.cat([b.data for b in row], -1) for row in blocks], -2)
    assert torch.equal(joined, da.data)


def test_threshold_count_blocks_equal_unsplit(mesh):
    from xclim_tpu_torch.indices import tx_days_above

    da = _grid()
    base = tx_days_above(da, thresh="300 K", freq="YS")
    out = sharded_jit(lambda x: tx_days_above(x, thresh="300 K", freq="YS"),
                      mesh)(da)
    assert torch.equal(out.data, base.data)
    assert out.dims == base.dims
    np.testing.assert_array_equal(out.coords["lon"], base.coords["lon"])


def test_percentile_pipeline_blocks_equal_unsplit(mesh):
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.indices import tx90p

    da = _grid((365 * 4, 4, 4))

    def pipeline(x):
        return tx90p(tasmax=x, tasmax_per=percentile_doy(x, per=90.0), freq="YS")

    assert torch.equal(sharded_jit(pipeline, mesh)(da).data, pipeline(da).data)


def test_spell_statistics_blocks_equal_unsplit(mesh):
    from xclim_tpu_torch.indices import hot_spell_max_length
    from xclim_tpu_torch.indices.generic import spell_length_statistics

    da = _grid((365 * 3, 4, 4))

    def both(x):
        return (hot_spell_max_length(x, thresh="300 K", window=3, freq="YS"),
                spell_length_statistics(x, "300 K", window=3, win_reducer="min",
                                        op=">", spell_reducer="sum", freq="YS"))

    got, exp = sharded_jit(both, mesh)(da), both(da)
    assert isinstance(got, tuple) and len(got) == 2
    for g, e in zip(got, exp):
        assert torch.equal(g.data, e.data)


def test_indicator_blocks_equal_unsplit(mesh):
    from xclim_tpu_torch.indicators import atmos

    da = _grid(name="tas")
    da.attrs["cell_methods"] = "time: mean"
    one = space_mesh(devices=CPU8[:1])
    for m in (mesh, one):
        got = sharded_jit(lambda x: atmos.tg_mean(x, freq="MS"), m)(da)
        exp = atmos.tg_mean(da, freq="MS")
        np.testing.assert_allclose(got.values, exp.values, rtol=1e-6)
        assert got.attrs["units"] == exp.attrs["units"] and got.dims == exp.dims


def test_sharded_jit_wrapper_on_tensors(mesh):
    x = _grid().data
    out = sharded_jit(lambda a: a.mean(dim=0), mesh)(x)
    np.testing.assert_allclose(out.numpy(), x.numpy().mean(0), rtol=1e-6)


def test_profile_writes_a_chrome_trace(tmp_path):
    from xclim_tpu_torch.utils import profile

    from xclim_tpu_torch.ops.quantile import nan_quantile

    with profile(str(tmp_path)) as logdir:
        torch.ones(64).cumsum(0)
        nan_quantile(torch.rand(80, 3), [0.5], axis=0)
    (trace,) = list(tmp_path.glob("trace-*.json"))
    assert logdir == str(tmp_path)
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any(n and "cumsum" in n for n in names)
    # the program's spans are on inside the block
    assert "xtt:op.quantile" in names


def test_timed(capsys):
    from xclim_tpu_torch.utils import timed

    with timed("block", sync=lambda: torch.ones(3)) as t:
        torch.ones(8).sum()
    assert t["seconds"] > 0
    assert "[xclim_tpu_torch] block:" in capsys.readouterr().out
    with timed() as t:
        t["sync"] = (ClimArray(torch.ones(2), ("x",)), [torch.zeros(1)])
    assert t["seconds"] > 0


@pytest.mark.parametrize("calendar", ["standard", "noleap", "360_day"])
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_atmos_is_the_references(seed, calendar):
    from xclim_tpu.testing.helpers import generate_atmos as jgenerate_atmos
    from xclim_tpu_torch.testing import generate_atmos

    exp = jgenerate_atmos(seed=seed, nyears=2, calendar=calendar)
    got = generate_atmos(seed=seed, nyears=2, calendar=calendar, device="cpu")
    assert list(got.keys()) == list(exp.keys())
    for k in exp:
        np.testing.assert_array_equal(got[k].values, np.asarray(exp[k].data))
        assert got[k].attrs == exp[k].attrs and got[k].dims == exp[k].dims
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].time.doy, exp[k].time.doy)


def test_series_helpers_are_the_references():
    from xclim_tpu.testing import helpers as jhelpers
    from xclim_tpu_torch.testing import helpers

    v = np.random.default_rng(3).normal(280, 5, (40, 2, 3))
    for name, args in (("test_timeseries", (v[:, 0, 0], "pr")),
                       ("test_grid", (v, "tasmax"))):
        got = getattr(helpers, name)(*args, device="cpu")
        exp = getattr(jhelpers, name)(*args)
        np.testing.assert_array_equal(got.values, np.asarray(exp.data))
        assert got.attrs == exp.attrs and got.dims == exp.dims
    ds = helpers.test_timeseries(np.arange(3), "tas", as_dataset=True, device="cpu")
    assert list(ds.keys()) == ["tas"]


def test_fixture_factories():
    from xclim_tpu_torch.testing import fixtures

    make = fixtures.sfcWind_series._get_wrapped_function()()
    da = make(np.ones(10), device="cpu")
    assert da.attrs["units"] == "km h-1" and da.time.year[0] == 2000
    assert fixtures.pr_series._get_wrapped_function()()(
        np.ones(3), device="cpu").time.month[0] == 1


def test_assert_lazy():
    from xclim_tpu_torch.testing import assert_lazy

    with assert_lazy:  # CPU tensors: host and device memory are one
        float(torch.ones(3).sum())
    if torch.cuda.is_available():
        x = torch.ones(3, device="cuda")
        with pytest.raises(RuntimeError, match="assert_lazy"):
            with assert_lazy:
                float(x.sum())


#: the realms and YAML modules the packages build their indicators in
REALMS = ("atmos", "land", "seaIce", "generic")
MODULES = (None, "icclim", "anuclim", "cf")


def _builtin(inputs: dict, registry) -> dict:
    """``list_input_variables()`` cut to the built-in modules' indicators."""
    keys = {k.lower() for k, v in registry.items() if v.module in MODULES}
    cut = {var: [k for k in inds if k in keys] for var, inds in inputs.items()}
    return {var: inds for var, inds in cut.items() if inds}


def test_testing_utils(tmp_path):
    from xclim_tpu.testing import utils as jutils
    from xclim_tpu_torch.io import to_netcdf
    from xclim_tpu_torch.testing import generate_atmos, utils

    with pytest.raises(FileNotFoundError, match="without network access"):
        utils.nimbus(cache_dir=tmp_path).fetch("missing.nc")
    to_netcdf(generate_atmos(nyears=1, device="cpu"), tmp_path / "a.nc")
    ds = utils.open_dataset("a.nc", cache_dir=tmp_path, device="cpu")
    assert ds["tas"].device.type == "cpu"
    assert "torch" in utils.show_versions()
    assert utils.publish_release_notes() == jutils.publish_release_notes()
    # only the built-in realms and modules, on both sides: other test files
    # register indicators of their own in either registry
    from xclim_tpu.core.indicator import registry as jregistry
    from xclim_tpu_torch.core.indicator import registry

    got = _builtin(utils.list_input_variables(realms=REALMS), registry)
    exp = _builtin(jutils.list_input_variables(realms=REALMS), jregistry)
    assert got["tas"] and set(got) <= set(exp)
    for var, inds in got.items():
        assert set(inds) <= set(exp[var]), var
    assert utils.audit_url("https://example.org/x") == "https://example.org/x"
