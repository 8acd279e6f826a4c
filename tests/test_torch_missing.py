"""The port's missing-value methods (core/missing.py) against the JAX
package's on the same numpy inputs: every registered method, several
frequencies and calendars, time indexers, and the option-driven
``missing_from_context``. Masks are booleans and must match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core import missing as jmissing
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.calendar import resample_segments as jresample_segments
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.options import set_options as jset_options
from xclim_tpu.ops.runlength import longest_run as jlongest_run
from xclim_tpu_torch.core import missing
from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.options import set_options
from xclim_tpu_torch.ops.runlength import longest_run

NY, NX = 3, 4


def _pair(cal, seed, years=2, start="2000-01-01"):
    """The same NaN-holed series as a port and a reference ClimArray: 3 %
    scattered holes, a 6-day gap in lane (0, 1), a 12-day gap in (1, 1),
    an all-NaN lane (2, 3) and a fully valid lane (0, 0)."""
    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * years
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n, NY, NX)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    x[40:46, 0, 1] = np.nan
    x[200:212, 1, 1] = np.nan
    x[:, 2, 3] = np.nan
    x[:, 0, 0] = 285.0
    dims = ("time", "lat", "lon")
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": date_range(start, periods=n, calendar=cal)},
                  {"units": "K"}, "tas")
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jdate_range(start, periods=n, calendar=cal)},
                   {"units": "K"}, "tas")
    return a, b


def _same_mask(got, exp):
    assert got.dims == exp.dims
    g, e = got.values, np.asarray(exp.data)
    assert g.dtype == np.bool_ and g.shape == e.shape
    np.testing.assert_array_equal(g, e)
    if "time" in got.dims:
        assert got.time == exp.time or np.array_equal(
            got.time.encode(), exp.time.encode())


METHODS = [
    ("missing_any", {}),
    ("missing_wmo", {}),
    ("missing_wmo", {"nm": 3, "nc": 2}),
    ("missing_pct", {"tolerance": 0.05}),
    ("at_least_n_valid", {"n": 25}),
    ("missing_some_but_not_all", {}),
]


@pytest.mark.parametrize("cal", ["noleap", "360_day", "standard"])
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC"])
@pytest.mark.parametrize("fn,kw", METHODS, ids=lambda v: str(v))
def test_method_matches_reference(fn, kw, freq, cal):
    a, b = _pair(cal, seed=len(fn) + len(freq))
    _same_mask(getattr(missing, fn)(a, freq, **kw),
               getattr(jmissing, fn)(b, freq, **kw))


@pytest.mark.parametrize("indexer", [{"month": [6, 7, 8]}, {"season": "DJF"},
                                     {"doy_bounds": (100, 200)},
                                     {"date_bounds": ("03-15", "10-01")}],
                         ids=lambda v: next(iter(v)))
@pytest.mark.parametrize("fn", ["missing_any", "missing_pct",
                                "at_least_n_valid"])
def test_indexers(fn, indexer):
    a, b = _pair("standard", seed=4)
    _same_mask(getattr(missing, fn)(a, "YS", **indexer),
               getattr(jmissing, fn)(b, "YS", **indexer))


def test_full_period_without_freq():
    a, b = _pair("noleap", seed=6)
    _same_mask(missing.missing_any(a, None), jmissing.missing_any(b, None))


def test_pct_with_monthly_subfreq():
    a, b = _pair("noleap", seed=8)
    got = missing.MissingPct(tolerance=0.1, subfreq="MS")(a, "YS")
    exp = jmissing.MissingPct(tolerance=0.1, subfreq="MS")(b, "YS")
    _same_mask(got, exp)


@pytest.mark.parametrize("method,opts", [("any", {}), ("wmo", {"nm": 5}),
                                         ("pct", {"tolerance": 0.02})])
def test_missing_from_context(method, opts):
    a, b = _pair("360_day", seed=10)
    with set_options(check_missing=method, missing_options={method: opts}):
        got = missing.missing_from_context(a, "MS")
    with jset_options(check_missing=method,
                      missing_options={method: opts}):
        exp = jmissing.missing_from_context(b, "MS")
    _same_mask(got, exp)


def test_partial_first_and_last_periods():
    # starts mid-month and ends mid-year: those periods are incomplete
    a, b = _pair("standard", seed=12, years=1, start="2001-03-17")
    for freq in ("MS", "YS", "QS-DEC"):
        _same_mask(missing.missing_any(a, freq),
                   jmissing.missing_any(b, freq))


@pytest.mark.parametrize("freq", ["MS", "QS-DEC", "YS"])
def test_longest_run_helper(freq):
    rng = np.random.default_rng(14)
    b = rng.random((365, 6)) < 0.4
    b[28:35, 2] = True                     # a run across a month boundary
    b[:, 5] = True                         # one run per period
    t = date_range("2000-01-01", periods=365, calendar="noleap")
    jt = jdate_range("2000-01-01", periods=365, calendar="noleap")
    spec, jspec = resample_segments(t, freq), jresample_segments(jt, freq)
    got = longest_run(torch.as_tensor(b), axis=0, spec=spec)
    exp = jlongest_run(jnp.asarray(b), axis=0, spec=jspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
