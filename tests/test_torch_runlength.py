"""The port's run-length engine (ops/runlength.py) and its ClimArray layer
(indices/run_length.py) against the JAX package's on the same numpy inputs:
every function, with the segment spec unset and set, ``index`` first and
last, and ``resample_before_rl`` False. Run lengths, counts and positions
are exact. Float run sums differ: the reference scans in float32, one
rounding a step, while the port rounds a float64 cumulative sum once, so a
run of n values may differ by ~n float32 ulps of the sum (rtol 1e-5 for the
runs here, at most ~30 values of magnitude ~1). Float statistics of run
lengths (mean, std, quantiles) round alike up to a few ulps (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.calendar import resample_segments as jresample_segments
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import run_length as jrl_idx
from xclim_tpu.ops import runlength as jrl
from xclim_tpu.ops.pallas import capability
from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indices import run_length as rl_idx
from xclim_tpu_torch.ops import runlength as rl

T = 400


@pytest.fixture(autouse=True)
def _xla_reference_route():
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _data(seed, cells=6):
    """(T, cells) float32 with runs of every length, NaN holes, an all-NaN
    and an all-positive lane, and zeros (a float run is consecutive
    non-zero values)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (T, cells))
    for t in range(1, T):
        x[t] = 0.7 * x[t - 1] + 0.7 * x[t]
    x = np.where(x > 0.2, x, 0.0).astype(np.float32)
    x[rng.random((T, cells)) < 0.05] = np.nan
    x[:, 1] = np.nan
    x[:, 2] = np.abs(x[:, 2]) + 1.0
    x[np.isnan(x[:, 2]), 2] = 1.0
    return x


def _specs(freq):
    if freq is None:
        return None, None
    return (resample_segments(date_range("2000-01-01", periods=T,
                                         calendar="noleap"), freq),
            jresample_segments(jdate_range("2000-01-01", periods=T,
                                           calendar="noleap"), freq))


def _eq(got, exp):
    g, e = got.numpy(), np.asarray(exp)
    assert g.shape == e.shape
    np.testing.assert_array_equal(g.astype(np.float64), e.astype(np.float64))


def _close(got, exp, rtol):
    g, e = got.numpy(), np.asarray(exp)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    np.testing.assert_allclose(g, e, rtol=rtol, atol=0.0, equal_nan=True)


FREQS = [None, "MS", "QS-DEC"]


@pytest.mark.parametrize("index", ["first", "last"])
@pytest.mark.parametrize("kind", ["bool", "float", "float_nan_reset", "int"])
@pytest.mark.parametrize("freq", FREQS)
def test_cumsum_reset(kind, index, freq):
    x = _data(1)
    spec, jspec = _specs(freq)
    reset_at = None if spec is None else rl.segment_boundaries(spec, index)
    jreset_at = None if jspec is None else jrl.segment_boundaries(jspec, index)
    kw = {"reset_on_zero": kind != "float_nan_reset"}
    a = {"bool": np.nan_to_num(x) > 0, "int": np.nan_to_num(x).astype(np.int32)
         }.get(kind, x)
    got = rl.cumsum_reset(torch.as_tensor(a), index=index, reset_at=reset_at,
                          **kw)
    exp = jrl.cumsum_reset(jnp.asarray(a), index=index, reset_at=jreset_at,
                           **kw)
    if kind in ("bool", "int"):
        _eq(got, exp)
    else:
        _close(got, exp, rtol=1e-5)


@pytest.mark.parametrize("index", ["first", "last"])
@pytest.mark.parametrize("freq", FREQS)
def test_rle(index, freq):
    x = _data(2)
    spec, jspec = _specs(freq)
    got = rl.rle(torch.as_tensor(x), index=index, reset_spec=spec)
    exp = jrl.rle(jnp.asarray(x), index=index, reset_spec=jspec)
    _eq(got, exp)


@pytest.mark.parametrize("rbrl", [True, False])
@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("reducer", ["max", "min", "sum", "mean", "std",
                                     "median", "q75"])
def test_rle_statistics(reducer, freq, rbrl):
    x = _data(3)
    spec, jspec = _specs(freq)
    got = rl.rle_statistics(torch.as_tensor(x), reducer, 2, spec=spec,
                            resample_before_rl=rbrl)
    exp = jrl.rle_statistics(jnp.asarray(x), reducer, 2, spec=jspec,
                             resample_before_rl=rbrl)
    if reducer in ("max", "min", "sum"):
        _eq(got, exp)
    else:
        _close(got, exp, rtol=1e-6)


@pytest.mark.parametrize("rbrl", [True, False])
@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("fn", ["longest_run", "windowed_run_count",
                                "windowed_run_events"])
def test_spell_statistics(fn, window, freq, rbrl):
    x = _data(4 + window)
    spec, jspec = _specs(freq)
    args = () if fn == "longest_run" else (window,)
    got = getattr(rl, fn)(torch.as_tensor(x), *args, spec=spec,
                          resample_before_rl=rbrl)
    exp = getattr(jrl, fn)(jnp.asarray(x), *args, spec=jspec,
                           resample_before_rl=rbrl)
    _eq(got, exp)


@pytest.mark.parametrize("rbrl", [True, False])
@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("window", [1, 3])
def test_windowed_max_run_sum(window, freq, rbrl):
    x = _data(5)
    spec, jspec = _specs(freq)
    got = rl.windowed_max_run_sum(torch.as_tensor(x), window, spec=spec,
                                  resample_before_rl=rbrl)
    exp = jrl.windowed_max_run_sum(jnp.asarray(x), window, spec=jspec,
                                   resample_before_rl=rbrl)
    _close(got, exp, rtol=1e-5)


@pytest.mark.parametrize("rbrl", [True, False])
@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("fn", ["first_run", "last_run"])
def test_boundary_runs(fn, window, freq, rbrl):
    x = _data(6)
    spec, jspec = _specs(freq)
    got = getattr(rl, fn)(torch.as_tensor(x), window, spec=spec,
                          resample_before_rl=rbrl)
    exp = getattr(jrl, fn)(jnp.asarray(x), window, spec=jspec,
                           resample_before_rl=rbrl)
    _eq(got, exp)


@pytest.mark.parametrize("window,op,thresh", [(3, ">", None), (5, ">", None),
                                              (3, ">", 0.5), (4, "==", 0.0),
                                              (2, "<=", 1.0)])
def test_suspicious_run(window, op, thresh):
    rng = np.random.default_rng(7)
    x = np.round(rng.normal(0.0, 1.0, (T, 5)) * 1.5).astype(np.float32)
    x[100:110, 0] = 2.0
    x[200:203, 1] = 0.0
    x[50:60, 2] = np.nan
    x[300:320, 3] = 0.0
    got = rl.suspicious_run(torch.as_tensor(x), window=window, op=op,
                            thresh=thresh)
    exp = jrl.suspicious_run(jnp.asarray(x), window=window, op=op,
                             thresh=thresh)
    _eq(got, exp)


def test_time_axis_not_first():
    x = _data(8)
    spec, jspec = _specs("MS")
    xt = np.ascontiguousarray(x.T)
    got = rl.windowed_run_count(torch.as_tensor(xt), 3, axis=1, spec=spec)
    exp = jrl.windowed_run_count(jnp.asarray(xt), 3, axis=1, spec=jspec)
    _eq(got, exp)


def _arrays(seed):
    x = _data(seed)[:, :4].reshape(T, 2, 2)
    dims = ("time", "lat", "lon")
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": date_range("2000-01-01", periods=T,
                                      calendar="noleap")}, {"units": ""}, "x")
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jdate_range("2000-01-01", periods=T,
                                        calendar="noleap")}, {"units": ""},
                   "x")
    return a, b


@pytest.mark.parametrize("freq", [None, "MS", "YS"])
@pytest.mark.parametrize("fn,args", [
    ("longest_run", ()), ("windowed_run_count", (3,)),
    ("windowed_run_events", (2,)), ("windowed_max_run_sum", (2,)),
    ("rle_statistics", ("max", 2)), ("statistics_run", ("mean", 1))])
def test_climarray_layer(fn, args, freq):
    a, b = _arrays(9)
    got = getattr(rl_idx, fn)(a, *args, freq=freq)
    exp = getattr(jrl_idx, fn)(b, *args, freq=freq)
    assert got.dims == exp.dims and got.attrs == exp.attrs
    _close(got.data, exp.data, rtol=1e-5)
    if freq is not None:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())


@pytest.mark.parametrize("fn,kw", [("cumsum_reset", {}),
                                   ("cumsum_reset", {"index": "first"}),
                                   ("rle", {}), ("rle", {"index": "last"})])
def test_climarray_elementwise(fn, kw):
    a, b = _arrays(10)
    got = getattr(rl_idx, fn)(a, **kw)
    exp = getattr(jrl_idx, fn)(b, **kw)
    assert got.dims == exp.dims
    _close(got.data, exp.data, rtol=1e-5)
