"""Host tables of the PyTorch port against the JAX package: calendars, date
ranges, resample segments, Grouper tables and unit conversions must be
identical (they are numpy on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core import calendar as jcal
from xclim_tpu.core import units as junits
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.sdba.grouping import Grouper as JGrouper
from xclim_tpu_torch.core import calendar as tcal
from xclim_tpu_torch.core import units as tunits
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.sdba.grouping import Grouper

CALENDARS = ["noleap", "standard", "360_day"]
GROUPS = [("time.dayofyear", 31), ("time.dayofyear", 5), ("time.dayofyear", 1),
          ("time.month", 1), ("time.season", 1), ("time", 1)]


def _same_index(a, b):
    assert a.calendar == b.calendar
    for f in ("year", "month", "day", "hour", "minute", "second"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("calendar", CALENDARS + ["all_leap", "julian"])
@pytest.mark.parametrize("start,kw", [
    ("1981-01-01", {"periods": 7 * 365, "freq": "D"}),
    ("1999-12-15", {"end": "2004-03-01", "freq": "D"}),
    ("2000-01-01", {"periods": 30, "freq": "MS"}),
    ("2000-03-01", {"periods": 10, "freq": "YS-JUL"}),
    ("2000-02-28", {"periods": 50, "freq": "6h"}),
])
def test_date_range(calendar, start, kw):
    _same_index(tcal.date_range(start, calendar=calendar, **kw),
                jcal.date_range(start, calendar=calendar, **kw))


@pytest.mark.parametrize("calendar", CALENDARS)
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC", "7D", "YS-JUL", "ME"])
def test_resample_segments(calendar, freq):
    t = tcal.date_range("1990-01-01", periods=4 * 365 + 3, calendar=calendar)
    tj = jcal.date_range("1990-01-01", periods=4 * 365 + 3, calendar=calendar)
    a, b = tcal.resample_segments(t, freq), jcal.resample_segments(tj, freq)
    assert a.nseg == b.nseg and a.uniform == b.uniform
    for f in ("seg_id", "counts", "expected", "starts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    _same_index(a.labels, b.labels)


@pytest.mark.parametrize("freq", ["D", "MS", "QS-DEC", "YS-JUL", "2W", "h"])
def test_parse_offset(freq):
    assert tcal.parse_offset(freq) == jcal.parse_offset(freq)
    assert tcal.construct_offset(*tcal.parse_offset(freq)) == \
        jcal.construct_offset(*jcal.parse_offset(freq))


@pytest.mark.parametrize("calendar", CALENDARS)
@pytest.mark.parametrize("group,window", GROUPS)
def test_grouper_tables(calendar, group, window):
    t = tcal.date_range("1981-01-01", periods=6 * 365 + 40, calendar=calendar)
    tj = jcal.date_range("1981-01-01", periods=6 * 365 + 40, calendar=calendar)
    g, gj = Grouper(group, window), JGrouper(group, window)
    np.testing.assert_array_equal(g.doy_table(t), gj.doy_table(tj))
    np.testing.assert_array_equal(g.train_table(t), gj.train_table(tj))
    for a, b in zip(g.adjust_table(t), gj.adjust_table(tj)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("calendar", CALENDARS)
def test_device_tables_memoized_on_device(calendar):
    t = tcal.date_range("1981-01-01", periods=3 * 365, calendar=calendar)
    g = Grouper("time.dayofyear", 31)
    dev = torch.device("cpu")
    doy = g.device_doy_table(t, dev)
    assert doy.dtype == torch.int64 and doy.device == dev
    np.testing.assert_array_equal(doy.numpy(), g.doy_table(t))
    assert g.device_doy_table(t, dev) is doy
    train = g.device_train_table(t, dev)
    np.testing.assert_array_equal(train.numpy(), g.train_table(t))
    adj = g.device_adjust_table(t, dev)
    assert g.device_adjust_table(t, dev) is adj
    for a, b in zip(adj, g.adjust_table(t)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("src,tgt", [("K", "degC"), ("degC", "K"),
                                     ("degF", "K"), ("K", "degF")])
def test_convert_units_to(src, tgt):
    rng = np.random.default_rng(1)
    x = rng.normal(280.0, 10.0, (40, 3)).astype(np.float32)
    t = tcal.date_range("2000-01-01", periods=40)
    tj = jcal.date_range("2000-01-01", periods=40)
    a = tunits.convert_units_to(
        ClimArray(torch.as_tensor(x), ("time", "x"), {"time": t},
                  {"units": src}), tgt)
    b = junits.convert_units_to(
        JClimArray(jnp.asarray(x), ("time", "x"), {"time": tj},
                   {"units": src}), tgt)
    assert a.attrs == b.attrs
    assert a.data.dtype == torch.float32
    # data * factor + delta in float32 on both sides (1e-6, SURVEY §6)
    np.testing.assert_allclose(a.values, np.asarray(b.data), rtol=1e-6)
    us, ut = tunits.units2pint(src), tunits.units2pint(tgt)
    js, jt = junits.units2pint(src), junits.units2pint(tgt)
    assert tunits._conversion(us, ut, None) == junits._conversion(js, jt, None)
    assert (us.scale, us.offset) == (js.scale, js.offset)


@pytest.mark.parametrize("q", ["5 degC", "1 mm/d", "3 kg m-2 s-1", "10 km/h"])
def test_str2pint(q):
    a, b = tunits.str2pint(q), junits.str2pint(q)
    assert a.magnitude == b.magnitude
    assert (a.units.scale, a.units.offset) == (b.units.scale, b.units.offset)
    assert tunits.pint2cfunits(a.units) == junits.pint2cfunits(b.units)
