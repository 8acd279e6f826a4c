"""The port's day-of-year percentiles (core/percentiles.py, the calendar
helpers and core/utils.py) against the JAX package on the same numpy
inputs.

Bounds: the reference's XLA quantile rounds within 2-3 float32 ulps of the
clean sequence the port follows (ROADMAP Queue 3): its compiler fuses the
virtual index ``n*q + c`` into one rounding and weighs the order statistics
by a one-hot contraction. Percentiles of K-scale data are held to 3 ulps of
the reference value (4 where a leap-day interpolation mixes two of them);
``calc_perc`` on data around zero to the bound its test derives. Gathers,
tables and the doy helpers are exact. The doy-axis positions are built on
the host with the reference's float32 sequence: equal for every 360/365
source; from a 366-doy source a few positions sit one ulp apart, so
``resample_doy`` from a 366-doy array onto another calendar is held to
1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core import calendar as jcalendar
from xclim_tpu.core import utils as jutils
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.percentiles import _interp_doy_axis as j_interp_doy_axis
from xclim_tpu.core.percentiles import adjust_doy_calendar as jadjust_doy_calendar
from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
from xclim_tpu.core.percentiles import resample_doy as jresample_doy
from xclim_tpu_torch.core import calendar, utils
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import (
    _doy_positions,
    _interp_doy_axis,
    adjust_doy_calendar,
    build_climatology_bounds,
    from_reference_percentiles,
    percentile_doy,
    resample_doy,
)

NDAYS = {"noleap": 365, "360_day": 360, "standard": 365}


def _pair(cal, seed, years=5, start="2000-01-01", nanfrac=0.03):
    n = NDAYS[cal] * years + (2 if cal == "standard" else 0)
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 8.0, (n, 3, 4)).astype(np.float32)
    x[rng.random(x.shape) < nanfrac] = np.nan
    x[:, 2, 3] = np.nan                       # all-NaN lane
    x[:, 0, 1] = np.round(x[:, 0, 1])         # ties
    dims = ("time", "lat", "lon")
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": calendar.date_range(start, periods=n, calendar=cal)},
                  {"units": "K"}, "tas")
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jcalendar.date_range(start, periods=n,
                                                 calendar=cal)},
                   {"units": "K"}, "tas")
    return a, b


def _within_ulps(got, exp, n):
    """|got - exp| within n float32 ulps of exp."""
    g, e = np.asarray(got), np.asarray(exp)
    assert g.shape == e.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
    ok = ~np.isnan(e)
    bound = n * np.spacing(np.abs(e[ok]).astype(np.float32))
    assert np.all(np.abs(g[ok] - e[ok]) <= bound), \
        np.max(np.abs(g[ok] - e[ok]) / bound * n)


@pytest.mark.parametrize("window", [1, 5])
@pytest.mark.parametrize("per", [10, 50, 90, [10, 50, 90]], ids=str)
@pytest.mark.parametrize("cal", ["noleap", "360_day", "standard"])
def test_percentile_doy_matches_reference(cal, per, window):
    a, b = _pair(cal, seed=len(cal) + window)
    got = percentile_doy(a, window=window, per=per)
    exp = jpercentile_doy(b, window=window, per=per)
    assert got.dims == exp.dims and got.name == exp.name
    assert got.attrs == exp.attrs
    assert set(got.coords) == set(exp.coords)
    for k in got.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[k]),
                                      np.asarray(exp.coords[k]))
    _within_ulps(got.values, exp.data, 4 if cal == "standard" else 3)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5, 0.5)])
def test_percentile_doy_other_interpolations(alpha, beta):
    a, b = _pair("noleap", seed=3)
    _within_ulps(percentile_doy(a, 5, 75, alpha=alpha, beta=beta).values,
                 jpercentile_doy(b, 5, 75, alpha=alpha, beta=beta).data, 3)


@pytest.mark.parametrize("n_src,n_tgt", [(365, 366), (360, 365), (360, 366),
                                         (365, 360), (365, 365), (360, 360),
                                         (366, 366)])
def test_doy_positions_equal_the_reference_linspace(n_src, n_tgt):
    np.testing.assert_array_equal(
        _doy_positions(n_src, n_tgt),
        np.asarray(jnp.linspace(1.0, float(n_tgt), n_src)))


@pytest.mark.parametrize("n_tgt", [365, 360])
def test_doy_positions_from_366_within_an_ulp(n_tgt):
    got = _doy_positions(366, n_tgt)
    exp = np.asarray(jnp.linspace(1.0, float(n_tgt), 366))
    assert np.all(np.abs(got - exp) <= np.spacing(exp))


@pytest.mark.parametrize("n_src,n_tgt", [(365, 366), (360, 365), (365, 360)])
def test_interp_doy_axis_matches_reference(n_src, n_tgt):
    p = np.random.default_rng(n_src).normal(285.0, 5.0, (n_src, 3, 2)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        _interp_doy_axis(torch.as_tensor(p), n_src, n_tgt).numpy(),
        np.asarray(j_interp_doy_axis(jnp.asarray(p), n_src, n_tgt)))


def _carried(cal):
    """A reference percentile array and the port's copy of it."""
    _, b = _pair(cal, seed=7)
    jp = jpercentile_doy(b, window=5, per=90)
    tp = from_reference_percentiles(np.asarray(jp.data), jp.dims, jp.coords,
                                    jp.attrs, device="cpu")
    return jp, tp


@pytest.mark.parametrize("tcal", ["noleap", "360_day", "standard"])
@pytest.mark.parametrize("scal", ["noleap", "360_day", "standard"])
def test_resample_doy_matches_reference(scal, tcal):
    jp, tp = _carried(scal)
    a, b = _pair(tcal, seed=8, years=2, start="2003-06-01")
    got = resample_doy(tp, a)
    exp = jresample_doy(jp, b)
    assert got.dims == exp.dims and got.attrs == exp.attrs
    np.testing.assert_array_equal(got.time.encode(), exp.time.encode())
    if scal == "standard" and tcal != "standard":
        np.testing.assert_allclose(got.values, np.asarray(exp.data),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.values, np.asarray(exp.data))


@pytest.mark.parametrize("tcal", ["noleap", "360_day", "standard"])
def test_adjust_doy_calendar_matches_reference(tcal):
    jp, tp = _carried("noleap")
    a, b = _pair(tcal, seed=9, years=1)
    got = adjust_doy_calendar(tp, a)
    exp = jadjust_doy_calendar(jp, b)
    np.testing.assert_array_equal(got.coords["dayofyear"],
                                  exp.coords["dayofyear"])
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))


@pytest.mark.parametrize("window", [1, 3, 5, 7])
@pytest.mark.parametrize("cal", ["noleap", "360_day", "standard", "all_leap",
                                 "julian"])
def test_percentile_doy_table_matches_reference(cal, window):
    t = calendar.date_range("1999-11-20", periods=900, calendar=cal)
    jt = jcalendar.date_range("1999-11-20", periods=900, calendar=cal)
    got = calendar.percentile_doy_table(t, window)
    exp = jcalendar.percentile_doy_table(jt, window)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


def test_percentile_doy_table_rejects_even_window():
    t = calendar.date_range("2000-01-01", periods=30, calendar="noleap")
    with pytest.raises(ValueError, match="odd"):
        calendar.percentile_doy_table(t, 4)


@pytest.mark.parametrize("cal", ["noleap", "standard", "360_day"])
def test_doy_days_since_helpers(cal):
    rng = np.random.default_rng(11)
    years = rng.integers(1990, 2030, 50)
    doy = rng.integers(1, 360, 50).astype(np.float64)
    for start in (1, 100, 300):
        ds = calendar.doy_to_days_since(doy, years, start, cal)
        np.testing.assert_array_equal(
            ds, jcalendar.doy_to_days_since(doy, years, start, cal))
        back = calendar.days_since_to_doy(ds, years, start, cal)
        np.testing.assert_array_equal(
            back, jcalendar.days_since_to_doy(ds, years, start, cal))
        np.testing.assert_array_equal(back, doy)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3)])
@pytest.mark.parametrize("per", [[50.0], [10.0, 90.0], None], ids=str)
def test_calc_perc_matches_reference(per, alpha, beta):
    rng = np.random.default_rng(12)
    x = rng.normal(0.0, 3.0, (4, 5, 40)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    x[0, 0] = np.nan
    got = utils.calc_perc(x, per, alpha=alpha, beta=beta, device="cpu")
    exp = jutils.calc_perc(x, per, alpha=alpha, beta=beta)
    assert isinstance(got, np.ndarray) and got.shape == exp.shape
    # besides the order statistics' rounding, the reference's compiler fuses
    # h = n*q + c into one rounding where the port rounds twice: the weight
    # can move by an ulp of h, times the gap between the order statistics
    # (at most the sample range)
    bound = (3 * np.spacing(np.float32(np.nanmax(np.abs(x))))
             + np.spacing(np.float32(x.shape[-1]))
             * (np.nanmax(x) - np.nanmin(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=0, atol=bound)
    got = utils.nan_calc_percentiles(x, per, axis=1, alpha=alpha, beta=beta,
                                     device="cpu")
    exp = jutils.nan_calc_percentiles(x, per, axis=1, alpha=alpha, beta=beta)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=0, atol=bound)


def test_is_percentile_dataarray_and_bounds():
    a, b = _pair("noleap", seed=13)
    assert build_climatology_bounds(a) == jcalendar_bounds(b)
    per = percentile_doy(a, 5, 90)
    assert utils.is_percentile_dataarray(per)
    assert utils.is_percentile_dataarray(per) == \
        jutils.is_percentile_dataarray(jpercentile_doy(b, 5, 90))
    assert not utils.is_percentile_dataarray(a)
    assert not utils.is_percentile_dataarray(np.zeros(3))


def jcalendar_bounds(b):
    from xclim_tpu.core.percentiles import build_climatology_bounds as jbcb

    return jbcb(b)
