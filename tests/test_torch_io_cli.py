"""The port's netCDF IO (``xclim_tpu_torch.io``: the native classic-NetCDF
reader with its scipy fallback, the HDF5 reader and writer) and its command
line (``xclim_tpu_torch.cli``) against the JAX package's, on the same files:
the reference's hostile classic files (short-int packing, fill values,
360_day, descending latitudes, hour units; ``tests/test_io_hostile.py``)
and netCDF4 files written by either package from ``generate_atmos``.

Decoded values equal the reference's bit for bit (the same float32 unpack
arithmetic), with the same NaN pattern, attributes and coordinates. The
command line runs with ``--device cpu``; its output files hold the JAX
command line's values within ``RTOL`` (1e-6) relative (the indicators'
bound, ``tests/test_torch_yaml_modules.py``), plain and ``--fused``.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from xclim_tpu.cli import cli as jcli
from xclim_tpu.io import open_dataset as jopen
from xclim_tpu.io import to_netcdf as jto_netcdf
from xclim_tpu.ops.pallas import capability
from xclim_tpu.testing.helpers import generate_atmos as jgenerate_atmos
from xclim_tpu_torch.cli import cli
from xclim_tpu_torch.io import netcdf
from xclim_tpu_torch.io import open_dataset, to_netcdf

from test_io_hostile import write_hostile

RTOL = 1e-6

#: write_hostile settings: each decodes through the native reader
HOSTILE = {
    "i2 packed, _FillValue": dict(fill_days=(3, 40)),
    "i2 packed, missing_value": dict(fill_attr="missing_value", fill_days=(5,)),
    "both fill attributes": dict(fill_attr="both", fill_days=(1, 2)),
    "byte packed": dict(pack="b", scale=0.5, fill_days=(7,)),
    "float, fill": dict(pack="f4", fill_days=(9,)),
    "360_day": dict(calendar="360_day"),
    "hours since": dict(time_units="hours since 2000-01-01"),
    "descending lat": dict(lat_descending=True),
}


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _same_time(got, exp):
    assert got.calendar == exp.calendar
    for f in ("year", "month", "day", "hour", "minute", "second"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f))


def _same_dataset(got, exp, rtol=0.0):
    assert sorted(got.keys()) == sorted(exp.keys())
    assert got.attrs == exp.attrs
    for k in exp:
        g, e = got[k], exp[k]
        assert g.dims == e.dims and g.name == e.name, k
        assert g.attrs == e.attrs, k
        gv, ev = g.values, np.asarray(e.values)
        assert gv.dtype == ev.dtype, k
        if rtol:
            np.testing.assert_allclose(gv, ev, rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(gv, ev, err_msg=k)
        for c in e.coords:
            if c == "time":
                _same_time(g.time, e.time)
            else:
                np.testing.assert_array_equal(g.coords[c], e.coords[c])


@pytest.mark.parametrize("case", list(HOSTILE))
def test_native_reader_equals_the_reference(case, tmp_path):
    path = tmp_path / "hostile.nc"
    write_hostile(path, **HOSTILE[case])
    before = dict(netcdf.opens)
    got = open_dataset(path, device="cpu")
    assert netcdf.opens["native"] == before["native"] + 1
    assert netcdf.opens["scipy"] == before["scipy"]
    assert got["tas"].device.type == "cpu"
    _same_dataset(got, jopen(path))


def test_scipy_serves_when_the_native_reader_fails(tmp_path, monkeypatch):
    from xclim_tpu_torch.io import native

    path = tmp_path / "hostile.nc"
    write_hostile(path, fill_days=(3,))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    before = dict(netcdf.opens)
    got = open_dataset(path, device="cpu")
    assert netcdf.opens["scipy"] == before["scipy"] + 1
    assert netcdf.opens["native"] == before["native"]
    _same_dataset(got, jopen(path))


def test_native_library_builds_outside_the_sources():
    from xclim_tpu_torch.io import native

    assert native.get_lib() is not None
    path = native.lib_path()
    assert path.parent.name == "_build" and path.exists()
    assert not list(path.parents[1].joinpath("io", "native").glob("*.so"))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("calendar", ["standard", "noleap"])
def test_hdf5_files_of_either_package(writer, calendar, tmp_path):
    """netCDF4 files written by either package read the same in both."""
    from xclim_tpu_torch.testing import generate_atmos

    path = tmp_path / "atmos.nc"
    if writer == "port":
        to_netcdf(generate_atmos(seed=4, nyears=2, calendar=calendar,
                                 device="cpu"), path)
    else:
        jto_netcdf(jgenerate_atmos(seed=4, nyears=2, calendar=calendar), path)
    before = netcdf.opens["h5py"]
    got = open_dataset(path, device="cpu")
    assert netcdf.opens["h5py"] == before + 1
    _same_dataset(got, jopen(path))
    np.testing.assert_array_equal(
        got["tas"].values,
        np.asarray(jgenerate_atmos(seed=4, nyears=2, calendar=calendar)["tas"].data))


@pytest.fixture
def nc_file(tmp_path):
    path = tmp_path / "in.nc"
    jto_netcdf(jgenerate_atmos(seed=1, nyears=3), path)
    return path


CHAIN = ["icclim.TG", "--freq", "YS", "icclim.SU", "icclim.RX5day",
         "icclim.CDD", "anuclim.P4_TempSeasonality", "cf.TXX", "--freq", "YS",
         "tx_days_above", "--thresh", "25 degC", "--freq", "YS"]


def _invoke(group, args):
    res = CliRunner().invoke(group, args)
    assert res.exit_code == 0, (res.output, res.exception)
    return res


@pytest.mark.parametrize("fused", [False, True])
def test_cli_chain_equals_the_reference(fused, nc_file, tmp_path):
    flag = ["--fused"] if fused else []
    _invoke(jcli, [*flag, "-i", str(nc_file), "-o", str(tmp_path / "j.nc"), *CHAIN])
    res = _invoke(cli, [*flag, "--device", "cpu", "-i", str(nc_file),
                        "-o", str(tmp_path / "p.nc"), *CHAIN])
    assert f"Writing to file {tmp_path / 'p.nc'}" in res.output
    got = open_dataset(tmp_path / "p.nc", device="cpu")
    assert len(got.keys()) == 7
    exp = jopen(tmp_path / "j.nc")
    for k in exp:
        exp[k].attrs.pop("history", None)
        got[k].attrs.pop("history", None)
    _same_dataset(got, exp, rtol=RTOL)


def test_cli_plain_and_fused_agree(nc_file, tmp_path):
    for flag in ("--no-fused", "--fused"):
        _invoke(cli, [flag, "--device", "cpu", "-i", str(nc_file), "-o",
                      str(tmp_path / f"{flag}.nc"), *CHAIN])
    a = open_dataset(tmp_path / "--no-fused.nc", device="cpu")
    b = open_dataset(tmp_path / "--fused.nc", device="cpu")
    for k in a:
        a[k].attrs.pop("history")
        b[k].attrs.pop("history")
    _same_dataset(a, b)


def test_cli_fused_defers_the_whole_chain(nc_file, monkeypatch):
    from xclim_tpu_torch import cli as climod

    seen = []
    run_fused = climod.Pipeline.run_fused

    def spy(self):
        seen.append(len(self.pending))
        run_fused(self)

    monkeypatch.setattr(climod.Pipeline, "run_fused", spy)
    _invoke(cli, ["--fused", "--device", "cpu", "-i", str(nc_file),
                  "icclim.TG", "--freq", "YS", "icclim.FD"])
    assert seen[0] == 2


@pytest.mark.parametrize("variables", [["-v", "tas"], ["-v", "pr", "-v", "tasmax"], []])
def test_cli_dataflags_equal_the_reference(variables, nc_file, tmp_path):
    exp = _invoke(jcli, ["-i", str(nc_file), "-o", str(tmp_path / "j.nc"),
                         "dataflags", *variables])
    got = _invoke(cli, ["--device", "cpu", "-i", str(nc_file), "-o",
                        str(tmp_path / "p.nc"), "dataflags", *variables])
    assert got.output.replace(str(tmp_path / "p.nc"), "") == exp.output.replace(
        str(tmp_path / "j.nc"), "")
    _same_dataset(open_dataset(tmp_path / "p.nc", device="cpu"),
                  jopen(tmp_path / "j.nc"))


def test_cli_info_and_indices():
    from xclim_tpu_torch.core.indicator import registry

    for name in ("icclim.TG", "cf.CDD", "tg_mean"):
        assert _invoke(cli, ["info", name]).output == _invoke(
            jcli, ["info", name]).output
    # the built-in modules' indicators: other test files register their own
    builtin = {k.lower() for k, v in registry.items()
               if v.module in (None, "icclim", "anuclim", "cf")}
    got = [line for line in _invoke(cli, ["indices"]).output.splitlines()
           if line.split(" : ")[0] in builtin]
    assert len(got) == len(builtin) == 349
    assert set(got) <= set(_invoke(jcli, ["indices"]).output.splitlines())


def test_cli_other_commands():
    out = _invoke(cli, ["show_version_info"]).output
    assert f"torch: {torch.__version__}" in out and "devices:" in out
    assert "synthetic" in _invoke(cli, ["prefetch_testing_data"]).output
    assert _invoke(cli, ["release_notes"]).output == _invoke(
        jcli, ["release_notes"]).output


def test_cli_errors(nc_file):
    res = CliRunner().invoke(cli, ["--device", "cpu", "tg_mean", "--freq", "YS"])
    assert res.exit_code == 2 and "No input file provided" in res.output
    res = CliRunner().invoke(cli, ["-i", str(nc_file), "no_such_indicator"])
    assert res.exit_code == 2 and "not found in xclim_tpu_torch" in res.output


def test_cli_device_defaults_to_the_card(nc_file, monkeypatch):
    """Without --device the work goes to the card; without one it raises
    (naming device='cpu'), as default_device() does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(cli, ["-i", str(nc_file), "icclim.TG"])
    assert res.exit_code != 0
    assert isinstance(res.exception, RuntimeError)
    assert "device='cpu'" in str(res.exception)


def test_pipeline_without_click(nc_file, tmp_path):
    """The click-free pipeline gives what the command line gives."""
    from xclim_tpu_torch.cli import Pipeline, get_indicator

    pipe = Pipeline(str(nc_file), str(tmp_path / "a.nc"), device="cpu")
    lines = pipe.dataflags()
    pipe.indicator(get_indicator("icclim.TG"), freq="YS")
    pipe.indicator(get_indicator("icclim.SU"))
    out = pipe.finish()
    assert sorted(out.keys())[:2] == ["SU", "TG"] and len(lines) >= len(out) - 2
    _invoke(cli, ["--device", "cpu", "-i", str(nc_file), "-o",
                  str(tmp_path / "b.nc"), "dataflags", "icclim.TG", "--freq",
                  "YS", "icclim.SU"])
    a = open_dataset(tmp_path / "a.nc", device="cpu")
    b = open_dataset(tmp_path / "b.nc", device="cpu")
    for k in ("TG", "SU"):
        a[k].attrs.pop("history")
        b[k].attrs.pop("history")
    _same_dataset(a, b)
