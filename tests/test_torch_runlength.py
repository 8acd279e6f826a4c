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


# ---------------------------------------------------------------------------
# the date, season and event functions of indices/run_length.py
# ---------------------------------------------------------------------------


def _masks(seed, p=0.6):
    """(T, 2, 2) bool conditions as port and reference ClimArrays: random
    runs in three lanes and an all-False lane."""
    rng = np.random.default_rng(seed)
    m = np.zeros((T, 4), dtype=bool)
    state = False
    for t in range(T):
        if rng.random() < (0.25 if state else 0.25 * (1 - p) / p + 0.05):
            state = not state
        m[t, :3] = state if rng.random() > 0.1 else not state
    m[:, 1] = np.roll(m[:, 1], 37)
    m[:, 2] = rng.random(T) < p
    return _bool_pair(m.reshape(T, 2, 2))


def _bool_pair(m):
    dims = ("time",) + ("lat", "lon")[:m.ndim - 1]
    n = m.shape[0]
    a = ClimArray(torch.as_tensor(m), dims,
                  {"time": date_range("2000-01-01", periods=n,
                                      calendar="noleap")}, {"units": ""}, "m")
    b = JClimArray(jnp.asarray(m), dims,
                   {"time": jdate_range("2000-01-01", periods=n,
                                        calendar="noleap")}, {"units": ""}, "m")
    return a, b


def _same(got, exp):
    assert got.dims == exp.dims and got.attrs == exp.attrs
    _eq(got.data, exp.data)
    if "time" in got.dims:
        np.testing.assert_array_equal(got.time.encode(), exp.time.encode())


@pytest.mark.parametrize("coord", [False, "dayofyear"])
@pytest.mark.parametrize("freq", [None, "MS", "YS"])
@pytest.mark.parametrize("fn", ["first_run", "last_run"])
def test_first_last_run_layer(fn, freq, coord):
    a, b = _masks(11)
    _same(getattr(rl_idx, fn)(a, 3, freq=freq, coord=coord),
          getattr(jrl_idx, fn)(b, 3, freq=freq, coord=coord))


@pytest.mark.parametrize("freq", ["YS", "YS-JUL", "MS"])
@pytest.mark.parametrize("fn,date", [
    ("first_run_after_date", "03-01"), ("last_run_before_date", "07-01"),
    ("first_run_before_date", "07-01"), ("first_run_before_date", None),
    ("run_end_after_date", "07-01"), ("run_end_after_date", "12-25")])
def test_date_runs(fn, date, freq):
    a, b = _masks(12)
    for window in (1, 3):
        _same(getattr(rl_idx, fn)(a, window, date=date, freq=freq),
              getattr(jrl_idx, fn)(b, window, date=date, freq=freq))


@pytest.mark.parametrize("mid_date", [None, "07-01"])
@pytest.mark.parametrize("freq", [None, "YS", "YS-JUL"])
@pytest.mark.parametrize("fn", ["season_start", "season_end", "season_length"])
def test_seasons(fn, freq, mid_date):
    a, b = _masks(13, p=0.7)
    kw = {"coord": "dayofyear"} if fn != "season_length" else {}
    _same(getattr(rl_idx, fn)(a, 4, mid_date=mid_date, freq=freq, **kw),
          getattr(jrl_idx, fn)(b, 4, mid_date=mid_date, freq=freq, **kw))


def test_season_dict():
    a, b = _masks(14, p=0.7)
    got = rl_idx.season(a, 3, mid_date="07-01", freq="YS")
    exp = jrl_idx.season(b, 3, mid_date="07-01", freq="YS")
    assert list(got) == list(exp)
    for k in exp:
        _same(got[k], exp[k])


def _edge_masks():
    """(T, 8) start and stop masks: all True, all False, a start and a
    stop on one step, runs across the first year boundary (day 365), a
    stop without a start, alternating steps, and two equally long runs."""
    start = np.zeros((T, 8), dtype=bool)
    stop = np.zeros((T, 8), dtype=bool)
    start[:, 0] = True
    start[100:110, 2] = True
    stop[105, 2] = True
    start[200, 2] = stop[200, 2] = True
    start[355:375, 3] = True
    stop[380:383, 3] = True
    stop[50:60, 4] = True
    start[::2, 5] = True
    stop[1::2, 5] = True
    start[10:20, 6] = start[30:40, 6] = True
    start[360:370, 7] = start[380:385, 7] = True
    return start, stop


def test_runs_with_holes_edge_cases():
    start, stop = _edge_masks()
    for ws, wp in ((1, 1), (2, 1), (1, 3), (3, 2)):
        a, b = _bool_pair(start)
        c, d = _bool_pair(stop | ~start if wp > 1 else stop)
        got = rl_idx.runs_with_holes(a, ws, c, wp)
        exp = jrl_idx.runs_with_holes(b, ws, d, wp)
        _same(got, exp)


@pytest.mark.parametrize("seed", [15, 16])
def test_runs_with_holes_random(seed):
    a, b = _masks(seed)
    c, d = _masks(seed + 10, p=0.3)
    for ws, wp in ((1, 1), (3, 2), (2, 4)):
        _same(rl_idx.runs_with_holes(a, ws, c, wp),
              jrl_idx.runs_with_holes(b, ws, d, wp))


@pytest.mark.parametrize("freq", [None, "MS", "YS"])
def test_keep_longest_run(freq):
    start, _ = _edge_masks()
    for a, b in (_masks(17), _bool_pair(start)):
        _same(rl_idx.keep_longest_run(a, freq=freq),
              jrl_idx.keep_longest_run(b, freq=freq))


def test_suspicious_run_layer():
    a, b = _arrays(18)
    x = np.round(a.values * 2) / 2
    a, b = a.copy(data=torch.as_tensor(x)), b.copy(data=jnp.asarray(x))
    _same(rl_idx.suspicious_run(a, window=3, op="gt", thresh=0.5),
          jrl_idx.suspicious_run(b, window=3, op="gt", thresh=0.5))


@pytest.mark.parametrize("max_events", [None, 3])
@pytest.mark.parametrize("freq", [None, "YS", "MS"])
def test_find_events(freq, max_events):
    a, b = _masks(19)
    x, jx = _arrays(20)
    got = rl_idx.find_events(a, 3, window_stop=2, data=x, freq=freq,
                             max_events=max_events)
    exp = jrl_idx.find_events(b, 3, window_stop=2, data=jx, freq=freq,
                              max_events=max_events)
    assert list(got) == list(exp)
    for k in exp:
        g, e = got[k], exp[k]
        assert g.dims == e.dims and g.attrs == e.attrs and g.name == e.name
        np.testing.assert_array_equal(g.coords["event"], e.coords["event"])
        if k == "event_sum":
            # float sums of at most ~T values of magnitude ~1 (index_add_
            # and segment_sum add in the same order here; held at 1e-6)
            _close(g.data, e.data, rtol=1e-6)
        else:
            _eq(g.data, e.data)


@pytest.mark.parametrize("coord", [False, True, "dayofyear"])
def test_run_bounds(coord):
    a, b = _masks(21)
    got = rl_idx.run_bounds(a, coord=coord)
    exp = jrl_idx.run_bounds(b, coord=coord)
    assert got.dims == exp.dims
    _eq(got.data, exp.data)


def _dispatches(fn):
    """Number of torch operator calls fn() makes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@pytest.mark.parametrize("freq", [None, "YS"])
def test_scans_make_a_fixed_number_of_torch_calls(freq):
    """runs_with_holes and keep_longest_run run no Python loop over time:
    the number of torch calls is the same at 100 and at 1000 steps."""
    counts = []
    for n in (100, 1000):
        rng = np.random.default_rng(n)
        a, _ = _bool_pair(rng.random((n, 3)) < 0.6)
        c, _ = _bool_pair(rng.random((n, 3)) < 0.3)
        counts.append((
            _dispatches(lambda: rl_idx.runs_with_holes(a, 2, c, 2)),
            _dispatches(lambda: rl_idx.keep_longest_run(a, freq=freq))))
    assert counts[0] == counts[1]
