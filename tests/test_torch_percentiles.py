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


# --------------------------------------------- the doy quantile op's dispatch


@pytest.mark.parametrize("device,dtype,n,kernel", [
    ("cuda", torch.float32, 150, True),
    ("cuda", torch.float32, 1816, True),
    ("cuda", torch.float32, 1817, False),
    ("cuda", torch.float32, 0, False),
    ("cuda", torch.float64, 150, False),
    ("cpu", torch.float32, 150, False),
])
def test_doy_quantile_dispatch(device, dtype, n, kernel):
    """The card's kernel for a CUDA float32 series whose rows fit its
    shared memory (1816 samples: 32 threads x 4 bytes each); the old path
    for the CPU, float64 and longer rows."""
    from types import SimpleNamespace

    from xclim_tpu_torch.ops import doyquantile

    series = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert doyquantile.on_kernel(series, n) is kernel
    assert doyquantile.kernel_takes(n) is (0 < n <= 1816)


@pytest.mark.parametrize("window,per", [(1, [10, 90]), (5, 90), (31, 50)])
@pytest.mark.parametrize("cal", ["noleap", "360_day", "standard"])
def test_percentile_doy_cpu_takes_the_old_path(cal, window, per):
    """On CPU tensors percentile_doy runs the twin, counted in twin_calls:
    the gather and nan_quantile, value for value as before."""
    from xclim_tpu_torch.core.percentiles import doy_quantile_gather
    from xclim_tpu_torch.ops import doyquantile
    from xclim_tpu_torch.ops.quantile import nan_quantile

    a, _ = _pair(cal, seed=window + 40)
    counts = (doyquantile.launches, doyquantile.twin_calls)
    got = percentile_doy(a, window=window, per=per)
    assert (doyquantile.launches, doyquantile.twin_calls) == (counts[0],
                                                              counts[1] + 1)
    sub = a.sel_time(mask=a.time.doy < 366) if cal == "standard" else a
    g, doys, _ = doy_quantile_gather(sub, window)
    q = np.atleast_1d(np.asarray(per, dtype=np.float32)) / 100.0
    exp = nan_quantile(g, q, axis=1, alpha=1 / 3, beta=1 / 3).movedim(0, -1)
    if cal == "standard":
        exp = _interp_doy_axis(exp, len(doys), 366)
    assert got.data.shape == exp.shape
    np.testing.assert_array_equal(got.data.numpy(), exp.numpy())


def test_doy_quantile_on_the_cpu_ignores_the_slide_plan():
    """window and slides only steer the kernel: the CPU twin's values do not
    depend on them."""
    from xclim_tpu_torch.ops import doyquantile

    a, _ = _pair("noleap", seed=3)
    table, _ = calendar.percentile_doy_table(a.time, 5)
    x = a.data.movedim(a.time_axis, 0)
    t = torch.as_tensor(table)
    ref = doyquantile.doy_quantile_plain(x, t, [0.1, 0.9], 1 / 3, 1 / 3)
    for window, slides in ((1, None), (5, doyquantile.slide_flags(table, 5)),
                           (5, np.zeros(len(table), dtype=bool))):
        got = doyquantile.doy_quantile(x, t, [0.1, 0.9], 1 / 3, 1 / 3,
                                       window=window, slides=slides)
        assert got.shape == (2, 365, 3, 4)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_doy_quantile_rejects_a_float_table():
    from xclim_tpu_torch.ops import doyquantile

    with pytest.raises(TypeError, match="integer"):
        doyquantile.doy_quantile(torch.zeros(10, 2), torch.zeros(3, 5), [0.5])


def _slides(cal, window, start="2000-01-01", years=4, drop_366=False):
    from xclim_tpu_torch.ops import doyquantile

    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * years + 1
    t = calendar.date_range(start, periods=n, calendar=cal)
    if drop_366:
        t = t[t.doy < 366]
    table, doys = calendar.percentile_doy_table(t, window)
    return doyquantile.slide_flags(table, window), doys


@pytest.mark.parametrize("window", [1, 5, 31])
@pytest.mark.parametrize("cal", ["noleap", "360_day"])
def test_slide_flags_on_a_regular_calendar(cal, window):
    """Every doy after the first moves each year's window on by one day,
    from a start in March too (the first year's early windows read -1)."""
    for start in ("2000-01-01", "2000-03-15"):
        flags, doys = _slides(cal, window, start)
        assert len(flags) == len(doys) == NDAYS[cal]
        assert not flags[0] and flags[1:].all()


@pytest.mark.parametrize("window", [1, 5])
def test_slide_flags_on_a_standard_table(window):
    """The standard calendar: with its doy 366 row (a day of the leap years
    only) that row is no slide of doy 365; as percentile_doy builds it
    (doy 366 dropped) every later doy is one, the leap years' Dec 31 a -1
    in their windows."""
    flags, doys = _slides("standard", window)
    assert doys[-1] == 366 and len(flags) == 366
    assert list(np.flatnonzero(~flags)) == ([0] if window == 1 else [0, 365])
    flags, doys = _slides("standard", window, drop_366=True)
    assert doys[-1] == 365
    assert not flags[0] and flags[1:].all()


def test_slide_flags_refuse_what_is_no_slide():
    """A row that is not the previous one moved on by a day is sorted anew;
    a window that does not divide the row raises."""
    from xclim_tpu_torch.ops import doyquantile

    t = calendar.date_range("2000-01-01", periods=365 * 3, calendar="noleap")
    table, _ = calendar.percentile_doy_table(t, 5)
    table = table.copy()
    table[100, 7] = table[100, 8]
    flags = doyquantile.slide_flags(table, 5)
    assert list(np.flatnonzero(~flags)) == [0, 100, 101]
    with pytest.raises(ValueError, match="table"):
        doyquantile.slide_flags(table, 4)


def test_percentile_doy_builds_its_table_once_per_time_axis(monkeypatch):
    """A second call over the same days reuses the table and its slide
    flags; another axis or window builds its own, with the same values as
    a fresh build."""
    from xclim_tpu_torch.core import percentiles as P

    built = []
    real = P.percentile_doy_table

    def counted(time, window=5):
        built.append(window)
        return real(time, window=window)

    monkeypatch.setattr(P, "percentile_doy_table", counted)
    monkeypatch.setattr(P, "_PLANS", {})
    a, _ = _pair("noleap", seed=21)
    first = percentile_doy(a, window=5, per=90)
    again = percentile_doy(a.copy(), window=5, per=90)
    assert built == [5]
    np.testing.assert_array_equal(first.data.numpy(), again.data.numpy())
    percentile_doy(a, window=3, per=90)
    percentile_doy(a.isel(time=slice(1, None)), window=5, per=90)
    assert built == [5, 3, 5]
    table, doys, slides = P._doy_plan(a.time, 5)
    exp_table, exp_doys = real(a.time, window=5)
    np.testing.assert_array_equal(table, exp_table)
    np.testing.assert_array_equal(doys, exp_doys)
    from xclim_tpu_torch.ops import doyquantile

    np.testing.assert_array_equal(slides,
                                  doyquantile.slide_flags(exp_table, 5))
    for k in range(P._PLANS_KEPT + 2):
        P._doy_plan(a.isel(time=slice(k + 2, None)).time, 5)
    assert len(P._PLANS) == P._PLANS_KEPT
