"""The port's ClimArray against the JAX package's on the same numpy data:
NaN reductions, selection, broadcasting binops and quantiles."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray

T, NY, NX = 60, 3, 4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    x = rng.normal(280.0, 8.0, (T, NY, NX)).astype(np.float32)
    x[rng.random(x.shape) < 0.15] = np.nan
    x[:, 0, 0] = np.nan                     # all-NaN lane
    coords = {"lat": np.arange(NY), "lon": np.arange(NX)}
    a = ClimArray(torch.as_tensor(x), ("time", "lat", "lon"),
                  {"time": date_range("2000-01-01", periods=T), **coords},
                  {"units": "K"}, "tas")
    b = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": jdate_range("2000-01-01", periods=T), **coords},
                   {"units": "K"}, "tas")
    return a, b


def _same(a, b, rtol=1e-6, atol=1e-6):
    assert a.dims == b.dims
    assert a.shape == tuple(b.shape)
    got = a.values
    exp = np.asarray(b.data)
    if got.dtype == bool or exp.dtype == bool:
        np.testing.assert_array_equal(got, exp)
    else:
        # float32 NaN reductions, summed in another order (1e-6, SURVEY §6)
        np.testing.assert_allclose(got, exp.astype(got.dtype), rtol=rtol,
                                   atol=atol, equal_nan=True)


@pytest.mark.parametrize("op", ["sum", "mean", "std", "var", "max", "min",
                                "median", "count"])
@pytest.mark.parametrize("dim", ["time", ("lat", "lon"), None])
def test_reductions(pair, op, dim):
    a, b = pair
    # std/var of ~280 K values: a two-pass variance in another summation
    # order keeps ~5 digits of the 64 K² variance, so rtol 1e-5 there
    rtol = 1e-5 if op in ("std", "var") else 1e-6
    _same(getattr(a, op)(dim), getattr(b, op)(dim), rtol=rtol)


@pytest.mark.parametrize("q", [0.5, [0.1, 0.9]])
@pytest.mark.parametrize("dim", ["time", None])
def test_quantile(pair, q, dim):
    a, b = pair
    _same(a.quantile(q, dim=dim), b.quantile(q, dim=dim))


def test_binops_broadcast_by_dim(pair):
    a, b = pair
    am, bm = a.mean("time"), b.mean("time")
    # the time means differ by an ulp of ~280 K (3e-5, summation order),
    # which a difference of two K-scale values keeps as absolute error
    _same(a - am, b - bm, atol=1e-4)
    _same(am * 2.0 + a, bm * 2.0 + b)
    _same(a > am, b > bm)
    _same(a.where(a > 280.0), b.where(b > 280.0))


def test_selection(pair):
    a, b = pair
    _same(a.isel(time=slice(5, 20), lat=1), b.isel(time=slice(5, 20), lat=1))
    _same(a.transpose("lon", "time", "lat"), b.transpose("lon", "time", "lat"))
    _same(a.sel_time(month=[1]), b.sel_time(month=[1]))
    _same(a.select_time(doy_bounds=(10, 30)), b.select_time(doy_bounds=(10, 30)))
    _same(a.shift_time(3), b.shift_time(3))
    _same(a.diff_time(), b.diff_time())
    _same(a.fillna(0.0), b.fillna(0.0))
    assert isinstance(a.values, np.ndarray)


@pytest.mark.parametrize("freq", ["MS", "7D"])
@pytest.mark.parametrize("op", ["mean", "max", "count", "argmax_doy"])
def test_resample(pair, op, freq):
    a, b = pair
    _same(getattr(a.resample(freq), op)(), getattr(b.resample(freq), op)())


@pytest.mark.parametrize("op", ["sum", "mean", "std"])
@pytest.mark.parametrize("center", [False, True])
def test_rolling(pair, op, center):
    a, b = pair
    # centred data: the rolling variance is E[x^2] - E[x]^2 in float32 on
    # both sides (xclim_tpu/ops/segments.py:399-404)
    _same(getattr((a - 280.0).rolling(5, center=center), op)(),
          getattr((b - 280.0).rolling(5, center=center), op)(),
          rtol=1e-6, atol=1e-6)
