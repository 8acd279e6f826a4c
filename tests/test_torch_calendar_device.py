"""The array half of the port's ``core/calendar.py`` (the reference's
``xclim_tpu/core/calendar.py:901-1300``) against the JAX package's, on the
same numpy inputs: period stacking and its inverse, period bounds, the
day-of-year climatology, doy masks and bounds, calendar conversion of
data and of day-of-year values, the season split and coordinate, and
``select_time``. Host tables (gather tables, labels, masks of a time axis)
are equal; gathered data are equal bit for bit; arithmetic on data
(climatological means, converted doys) holds to ``RTOL`` (1e-6)
relative."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.core.calendar as jcal
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu_torch.core import calendar as cal
from xclim_tpu_torch.core import percentiles
from xclim_tpu_torch.core.dataarray import ClimArray

from test_torch_converters import to_port

RTOL = 1e-6


def _series(calendar="noleap", years=5, cells=(3, 4), seed=0, freq="D",
            start="2001-01-01", periods=None):
    t = jcal.date_range(start, periods=periods or years * 365, freq=freq,
                        calendar=calendar)
    rng = np.random.default_rng(seed)
    x = rng.normal(280, 8, (len(t),) + cells).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": np.arange(cells[0]) * 10.0,
                    "lon": np.arange(cells[1]) * 10.0},
                   {"units": "K", "standard_name": "air_temperature"}, "tas")
    return j, to_port(j)


def _same_time(a, b):
    assert a.calendar == b.calendar
    np.testing.assert_array_equal(a.encode(), b.encode())


def _same(got, want, rtol=0.0):
    """Equal dims, name, attrs, time coordinate and values (within rtol)."""
    assert got.dims == want.dims and got.name == want.name
    assert got.attrs == want.attrs
    g, w = got.values, np.asarray(want.data)
    assert g.shape == w.shape and g.dtype == w.dtype
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, w)
    if want.coords.get("time") is not None:
        _same_time(got.time, want.time)


def test_every_function_of_the_reference_module_is_here():
    """Each function and class the reference module defines or re-exports
    has a counterpart of the same name in the port."""
    names = {n for n, v in vars(jcal).items() if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__.startswith("xclim_tpu.")}
    assert names - {n for n in dir(cal)} - set(cal._FROM_PERCENTILES) == set()
    for n in cal._FROM_PERCENTILES:
        assert getattr(cal, n) is getattr(percentiles, n)
    assert cal.DayOfYearStr is str
    assert cal.uniform_calendars == jcal.uniform_calendars


@pytest.mark.parametrize("kw", [
    {"window": 2}, {"window": 3, "stride": 1}, {"window": 2, "stride": 3},
    {"window": 4, "stride": 2, "min_length": 3},
    {"window": 3, "stride": 2, "min_length": 2},
    {"window": 6, "freq": "QS-DEC"}, {"window": 12, "stride": 6, "freq": "MS"}],
    ids=str)
def test_stack_periods_table_and_stack_unstack(kw):
    j, p = _series(years=5)
    tbl, starts = cal.stack_periods_table(p.time, **kw)
    jtbl, jstarts = jcal.stack_periods_table(j.time, **kw)
    np.testing.assert_array_equal(tbl, jtbl)
    _same_time(starts, jstarts)
    want = jcal.stack_periods(j, **kw)
    got = cal.stack_periods(p, **kw)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_array_equal(got.values, np.asarray(want.data))
    _same_time(got.coords["period"], want.coords["period"])
    _same(cal.unstack_periods(got), jcal.unstack_periods(want))


def test_stack_periods_of_a_time_last_array():
    j, p = _series(years=4)
    j2 = JClimArray(jnp.moveaxis(j.data, 0, -1), ("lat", "lon", "time"),
                    j.coords, j.attrs, j.name)
    p2 = ClimArray(torch.movedim(p.data, 0, -1), ("lat", "lon", "time"),
                   p.coords, p.attrs, p.name)
    want = jcal.stack_periods(j2, window=2, stride=1)
    got = cal.stack_periods(p2, window=2, stride=1)
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.values, np.asarray(want.data))
    _same(cal.unstack_periods(got), jcal.unstack_periods(want))


def test_stack_periods_without_a_complete_period_raises():
    _, p = _series(years=1)
    with pytest.raises(ValueError, match="No complete periods"):
        cal.stack_periods_table(p.time, window=3)


@pytest.mark.parametrize("freq", [None, "MS", "YS", "QS-DEC", "7D", "YE"])
@pytest.mark.parametrize("calendar", ["noleap", "standard", "360_day"])
def test_time_bnds(freq, calendar):
    j, p = _series(calendar, years=2)
    for got, want in zip(cal.time_bnds(p.time, freq), jcal.time_bnds(j.time, freq)):
        _same_time(got, want)


@pytest.mark.parametrize("window", [1, 5, 31])
@pytest.mark.parametrize("ndim", [1, 2])
def test_climatological_mean_doy(window, ndim, monkeypatch):
    """On (time,) and (time, cell) arrays (the reference's two cases); a
    numpy array goes to default_device() (here made the CPU) and comes
    back as numpy."""
    import xclim_tpu_torch

    monkeypatch.setattr(xclim_tpu_torch, "default_device",
                        lambda: torch.device("cpu"))
    j, p = _series("standard", years=4)
    x = np.asarray(j.data).reshape(len(j.time), -1)
    x = x[:, 5] if ndim == 1 else x
    want = jcal.climatological_mean_doy(x, j.time, window=window)
    host = cal.climatological_mean_doy(x, p.time, window=window)
    dev = cal.climatological_mean_doy(torch.as_tensor(x), p.time,
                                      window=window)
    for h, d, w in zip(host, dev, want):
        assert isinstance(h, np.ndarray) and isinstance(d, torch.Tensor)
        assert h.shape == w.shape and d.device.type == "cpu"
        np.testing.assert_allclose(h, w, rtol=RTOL,
                                   equal_nan=True)
        np.testing.assert_array_equal(d.numpy(), h)


@pytest.mark.parametrize("bounds,include", [
    ((60, 200), (True, True)), ((300, 40), (True, True)),
    ((60, 200), (False, True)), ((300, 40), (True, False)),
    ((1, 366), (True, True))])
@pytest.mark.parametrize("calendar", ["noleap", "standard", "360_day"])
def test_mask_between_int_doys(bounds, include, calendar):
    j, p = _series(calendar, years=2)
    _same(cal.mask_between_doys(p, bounds, include),
          jcal.mask_between_doys(j, bounds, include))
    np.testing.assert_array_equal(
        cal.mask_between_doys(p.time, bounds, include),
        jcal.mask_between_doys(j.time, bounds, include))


@pytest.mark.parametrize("include", [(True, True), (False, False)])
def test_mask_between_per_cell_doys(include):
    """Per-cell bounds as ClimArrays without a time dim, some wrapping the
    year end and some NaN (then the year's first or last day)."""
    j, p = _series("noleap", years=2)
    rng = np.random.default_rng(3)
    lo = rng.integers(1, 365, (3, 4)).astype(np.float32)
    hi = rng.integers(1, 365, (3, 4)).astype(np.float32)
    lo[0, 0] = np.nan
    hi[1, 2] = np.nan
    bj = [JClimArray(jnp.asarray(v), ("lat", "lon"), {}, {}, "b")
          for v in (lo, hi)]
    _same(cal.mask_between_doys(p, [to_port(b) for b in bj], include),
          jcal.mask_between_doys(j, bj, include))


@pytest.mark.parametrize("source,target,missing", [
    ("noleap", "360_day", None), ("360_day", "noleap", None),
    ("standard", "noleap", None), ("noleap", "standard", np.nan),
    ("standard", "all_leap", None), ("standard", "360_day", -99.0),
    ("noleap", "noleap", None)])
def test_convert_calendar(source, target, missing):
    j, p = _series(source, years=3, start="2000-01-01",
                   periods=1096 if source == "standard" else None)
    _same(cal.convert_calendar(p, target, missing=missing),
          jcal.convert_calendar(j, target, missing=missing))


def test_convert_calendar_round_trip_noleap_360_day():
    j, p = _series("noleap", years=3)
    there = cal.convert_calendar(p, "360_day")
    back = cal.convert_calendar(there, "noleap")
    _same(back, jcal.convert_calendar(jcal.convert_calendar(j, "360_day"),
                                      "noleap"))


def test_ensure_cftime_array():
    _, p = _series("standard", years=1)
    assert cal.ensure_cftime_array(p.time) is p.time
    dt = p.time.to_datetime64()
    _same_time(cal.ensure_cftime_array(dt), jcal.ensure_cftime_array(dt))
    with pytest.raises(TypeError):
        cal.ensure_cftime_array([1, 2, 3])


@pytest.mark.parametrize("divisor,offset", [
    ("D", "MS"), ("h", "D"), ("7h", "D"), ("MS", "YS"), ("2MS", "QS-DEC"),
    ("QS", "YS"), ("5MS", "YS"), ("W", "2W"), ("W", "MS"), ("YS", "MS"),
    ("3h", "12h"), ("5min", "h"), ("7min", "h"), ("D", "W")])
def test_is_offset_divisor(divisor, offset):
    assert cal.is_offset_divisor(divisor, offset) == \
        jcal.is_offset_divisor(divisor, offset)


def test_within_bnds_doy():
    """Per-doy bounds with a 'dayofyear' coordinate (and as plain arrays
    indexed from doy 1), gathered onto the time axis."""
    j, p = _series("noleap", years=2)
    rng = np.random.default_rng(4)
    base = 280 + 8 * np.cos(np.arange(365) / 58.0)[:, None, None]
    lo = (base - rng.uniform(2, 8, (365, 3, 4))).astype(np.float32)
    hi = (base + rng.uniform(2, 8, (365, 3, 4))).astype(np.float32)
    coords = {"dayofyear": np.arange(1, 366)}
    bj = [JClimArray(jnp.asarray(v), ("dayofyear", "lat", "lon"), coords, {},
                     "b") for v in (lo, hi)]
    want = jcal.within_bnds_doy(j, low=bj[0], high=bj[1])
    _same(cal.within_bnds_doy(p, low=to_port(bj[0]), high=to_port(bj[1])),
          want)
    _same(cal.within_bnds_doy(p, low=torch.as_tensor(lo),
                              high=torch.as_tensor(hi)), want)


@pytest.mark.parametrize("source_cal,target_cal", [
    ("standard", "360_day"), ("360_day", "noleap"), ("noleap", "all_leap")])
def test_convert_doy(source_cal, target_cal):
    rng = np.random.default_rng(5)
    years = 6
    t = jcal.date_range("2000-01-01", periods=years, freq="YS",
                        calendar=source_cal)
    doy = rng.integers(1, 360, (years, 3)).astype(np.float32)
    j = JClimArray(jnp.asarray(doy), ("time", "x"), {"time": t},
                   {"units": "", "is_dayofyear": 1}, "doy")
    got = cal.convert_doy(to_port(j), target_cal)
    want = jcal.convert_doy(j, target_cal)
    _same(got, want, rtol=RTOL)
    got = cal.convert_doy(torch.as_tensor(doy), target_cal,
                          source_cal=source_cal)
    want = jcal.convert_doy(jnp.asarray(doy), target_cal,
                            source_cal=source_cal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_split_time_to_season_year_and_add_season_coord():
    """A QS-DEC series that starts in March and ends in a December (whose
    DJF of the next year holds only that month's value)."""
    t = jcal.date_range("2001-03-01", periods=16, freq="QS-DEC",
                        calendar="noleap")
    x = np.arange(16 * 6, dtype=np.float32).reshape(16, 2, 3)
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   {"time": t, "lat": np.arange(2.0), "lon": np.arange(3.0)},
                   {"units": "K"}, "tas")
    got = cal.split_time_to_season_year(to_port(j))
    want = jcal.split_time_to_season_year(j)
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.values, np.asarray(want.data))
    for k in ("year", "season", "lat", "lon"):
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    np.testing.assert_array_equal(
        cal.add_season_coord(to_port(j)).coords["season"],
        jcal.add_season_coord(j).coords["season"])


@pytest.mark.parametrize("indexer", [
    {"season": "JJA"}, {"season": ["DJF", "MAM"]}, {"month": [1, 7, 12]},
    {"doy_bounds": (100, 250)}, {"doy_bounds": (320, 30)},
    {"date_bounds": ("02-15", "06-30")}, {"date_bounds": ("11-01", "02-28")}],
    ids=str)
@pytest.mark.parametrize("drop", [False, True])
def test_select_time(indexer, drop):
    """The function, the method and the reference agree (the function is
    the method)."""
    j, p = _series("standard", years=2)
    want = jcal.select_time(j, drop=drop, **indexer)
    got = cal.select_time(p, drop=drop, **indexer)
    _same(got, want)
    _same(p.select_time(drop=drop, **indexer), want)
