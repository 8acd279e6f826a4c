"""The port's Zhang-2005 bootstrap (ops/bootstrap.py, core/bootstrapping.py)
and the percentile indices built on it, against the JAX package on the same
numpy inputs.

* The candidate tables and the year-replaced quantiles are held exactly to
  both of the reference's table routes: ``merge_rank_replaced_year_quantile``
  and ``topk_replaced_year_quantile`` (which its public bootstrap calls).
* tx90p, tn10p, WSDI and CSDI with ``bootstrap=True`` get the SAME
  percentile array: the reference's ``percentile_doy`` output, carried into
  the port with ``from_reference_percentiles``. Out-of-base years then use
  identical thresholds, and in-base years thresholds from the tables, which
  are bit-identical; the day counts and their means over the replacements
  are exact.
* The recount of an in-base year reads the days of that year's periods
  alone (for ``QS-DEC``, March to the next February); WSDI and CSDI with
  ``resample_before_rl=False``, whose runs cross the periods' bounds, read
  the whole series. Both routes are exact, and counted.
* The 50th percentile takes the re-sort route, whose thresholds come from
  the sort quantile and may sit a few ulps from the reference's (ROADMAP
  Queue 3); a count could then move only for a day within those ulps of
  its threshold, which these inputs do not hold: exact as well.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu import indices as jindices
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.core.percentiles import percentile_doy as jpercentile_doy
from xclim_tpu.ops import bootstrap as jboot
from xclim_tpu_torch import indices
from xclim_tpu_torch.core import bootstrapping
from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import from_reference_percentiles
from xclim_tpu_torch.ops import bootstrap as boot
from xclim_tpu_torch.utils.profiling import tracing

Y, W, C = 6, 5, 48
MODES = ["plain", "nans", "ties", "dead_lane", "nan_edges"]


def _samples(mode, seed, w=W):
    """(Y, w, C) doy-window samples of one doy, by year."""
    rng = np.random.default_rng(seed)
    D = rng.normal(285.0, 5.0, (Y, w, C)).astype(np.float32)
    if mode == "nans":
        D[rng.random(D.shape) < 0.2] = np.nan
    elif mode == "ties":
        D = np.round(D)
    elif mode == "dead_lane":
        D[:, :, 0] = np.nan
        D[1:, :, 1] = np.nan             # one valid year
    elif mode == "nan_edges":
        D[0, :2] = np.nan                # the window before the series start
        D[-1, 3:] = np.nan               # ... and after its end
    return D


def _tables(D, q):
    w = D.shape[1]
    flat = D.reshape(Y * w, C)
    year_id = np.arange(Y).repeat(w)
    K = boot.topk_capacity(Y * w, w, q)
    assert K == jboot.topk_capacity(Y * w, w, q)
    return (boot.topk_rank_tables(torch.as_tensor(flat), year_id, K),
            jboot.topk_rank_tables(jnp.asarray(flat), year_id, K))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [0.9, 0.1])
def test_topk_rank_tables(q, mode):
    D = _samples(mode, seed=int(q * 10) + len(mode))
    got, exp = _tables(D, q)
    for i in (0, 2, 4):      # values and valid counts
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(exp[i]))
    if mode != "ties":       # year tags; ties may pick either year
        for i in (1, 3):
            finite = np.isfinite(np.asarray(exp[i - 1]))
            np.testing.assert_array_equal(got[i].numpy()[finite],
                                          np.asarray(exp[i])[finite])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [0.9, 0.1, 0.75, 0.25])
def test_replaced_year_quantile_matches_both_reference_routes(q, mode):
    _check_replaced_year_quantile(_samples(mode, seed=int(q * 100) + len(mode)),
                                  q)


@pytest.mark.parametrize("mode", ["plain", "ties", "nan_edges"])
@pytest.mark.parametrize("q", [0.9, 0.1])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 7])
def test_replaced_year_quantile_other_windows(w, q, mode):
    """The added samples' sorting network at windows other than 5."""
    _check_replaced_year_quantile(
        _samples(mode, seed=int(q * 100) + len(mode) + w, w=w), q)


def _check_replaced_year_quantile(D, q):
    tabs, jtabs = _tables(D, q)
    Dt = D.transpose(2, 0, 1)                 # (C, Y, W)
    for b in range(Y):
        others = [o for o in range(Y) if o != b]
        A_b, A_o = Dt[:, b], np.stack([Dt[:, o] for o in others])
        got = boot.merge_rank_replaced_year_quantile(
            *tabs, torch.as_tensor(A_b), torch.as_tensor(A_o), b, q).numpy()
        jt = [jnp.broadcast_to(t, (Y - 1,) + t.shape) for t in jtabs]
        jb = jnp.broadcast_to(jnp.asarray(A_b), (Y - 1,) + A_b.shape)
        for fn in (jboot.merge_rank_replaced_year_quantile,
                   jboot.topk_replaced_year_quantile):
            exp = np.asarray(fn(*jt, jb, jnp.asarray(A_o), b, q))
            np.testing.assert_array_equal(got, exp, err_msg=fn.__name__)


def _pair(cal, seed, name):
    """Six years of AR(1) temperature (warm and cold spells occur) with 2 %
    holes, as a port and a reference ClimArray (2 x 4 cells)."""
    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * 6
    n += 2 if cal == "standard" else 0
    rng = np.random.default_rng(seed)
    e = rng.normal(0.0, 1.0, (n, 2, 4))
    ar = np.zeros_like(e)
    for t in range(1, n):
        ar[t] = 0.8 * ar[t - 1] + 0.6 * e[t]
    x = (290.0 + 10.0 * np.sin(np.arange(n) / 365.0 * 2 * np.pi)[:, None, None]
         + 5.0 * ar).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    dims = ("time", "lat", "lon")
    attrs = {"units": "K", "standard_name": "air_temperature"}
    a = ClimArray(torch.as_tensor(x), dims,
                  {"time": date_range("2000-01-01", periods=n, calendar=cal)},
                  attrs, name)
    b = JClimArray(jnp.asarray(x), dims,
                   {"time": jdate_range("2000-01-01", periods=n,
                                        calendar=cal)}, attrs, name)
    return a, b


def _carried_per(b, per, base_years=4):
    """The reference's percentiles over the first years (the later years
    are out of base), and the port's copy of them."""
    jper = jpercentile_doy(b.sel_time(mask=b.time.year < 2000 + base_years),
                           window=5, per=per)
    return jper, from_reference_percentiles(np.asarray(jper.data), jper.dims,
                                            jper.coords, jper.attrs,
                                            device="cpu")


CASES = [("tx90p", "tasmax", 90, {}), ("tn10p", "tasmin", 10, {}),
         ("warm_spell_duration_index", "tasmax", 90, {"window": 4}),
         ("cold_spell_duration_index", "tasmin", 10, {"window": 3}),
         ("tg90p", "tas", 90, {}), ("tx10p", "tasmax", 10, {})]


@pytest.mark.parametrize("freq", ["YS", "MS", "QS-DEC"])
@pytest.mark.parametrize("cal", ["noleap", "360_day", "standard"])
@pytest.mark.parametrize("fn,var,per,kw", CASES, ids=[c[0] for c in CASES])
def test_bootstrapped_index_matches_reference(fn, var, per, kw, cal, freq):
    a, b = _pair(cal, seed=len(fn) + len(cal), name=var)
    jper, tper = _carried_per(b, per)
    got = getattr(indices, fn)(a, tper, freq=freq, bootstrap=True, **kw)
    exp = getattr(jindices, fn)(b, jper, freq=freq, bootstrap=True, **kw)
    assert got.dims == exp.dims and got.attrs == exp.attrs
    np.testing.assert_array_equal(got.time.encode(), exp.time.encode())
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))
    # the bootstrap changes the in-base years only
    plain = getattr(indices, fn)(a, tper, freq=freq, **kw).values
    out_of_base = got.time.year >= 2004
    np.testing.assert_array_equal(got.values[out_of_base],
                                  plain[out_of_base])


@pytest.mark.parametrize("cal", ["noleap", "standard"])
def test_median_takes_the_resort_route(cal):
    a, b = _pair(cal, seed=21, name="tasmax")
    jper, tper = _carried_per(b, 50)
    got = indices.tx90p(a, tper, freq="YS", bootstrap=True)
    exp = jindices.tx90p(b, jper, freq="YS", bootstrap=True)
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))


def test_two_percentiles_at_once():
    a, b = _pair("noleap", seed=22, name="tasmax")
    jper, tper = _carried_per(b, [90, 95])
    got = indices.tx90p(a, tper, freq="YS", bootstrap=True)
    exp = jindices.tx90p(b, jper, freq="YS", bootstrap=True)
    assert got.dims == exp.dims and got.shape[-1] == 2
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))


def test_bootstrap_needs_bounds_and_two_base_years():
    a, b = _pair("noleap", seed=23, name="tasmax")
    _, tper = _carried_per(b, 90)
    no_bounds = tper.copy()
    no_bounds.attrs = {k: v for k, v in tper.attrs.items()
                       if k != "climatology_bounds"}
    with pytest.raises(KeyError, match="climatology_bounds"):
        indices.tx90p(a, no_bounds, bootstrap=True)
    one_year = tper.copy()
    one_year.attrs = dict(tper.attrs,
                          climatology_bounds=["2010-01-01", "2010-12-31"])
    with pytest.raises(KeyError, match="two in-base years"):
        indices.tx90p(a, one_year, bootstrap=True)


def _spell_across_new_year(a, b, year=2003):
    """Put a 4-day run over 31 December of ``year`` (the base's last) into
    both arrays: above every threshold at lat 0, below every one at lat 1,
    with a day of the other sign either side of it. Each period holds 2 of
    its days, fewer than the windows: it counts only where runs cross the
    periods' bounds. (Its 2 days in the base sit above the 90th and below
    the 10th of the 20 samples of their days' thresholds.)"""
    t = a.time
    i = int(np.nonzero((t.year == year) & (t.month == 12) & (t.day == 30))[0][0])
    x = a.data.numpy().copy()
    warm = np.array([250.0, 330.0, 330.0, 330.0, 330.0, 250.0])[:, None]
    x[i - 1:i + 5, 0] = warm
    x[i - 1:i + 5, 1] = 580.0 - warm
    return a.copy(data=torch.as_tensor(x)), b.copy(data=jnp.asarray(x))


SPELLS = [c for c in CASES if "spell" in c[0]]


@pytest.mark.parametrize("cal", ["noleap", "standard"])
@pytest.mark.parametrize("fn,var,per,kw", SPELLS, ids=[c[0] for c in SPELLS])
def test_runs_across_the_periods_take_the_whole_series(fn, var, per, kw, cal):
    a, b = _spell_across_new_year(*_pair(cal, seed=31 + len(fn), name=var))
    jper, tper = _carried_per(b, per)
    got = getattr(indices, fn)(a, tper, freq="YS", bootstrap=True,
                               resample_before_rl=False, **kw)
    exp = getattr(jindices, fn)(b, jper, freq="YS", bootstrap=True,
                                resample_before_rl=False, **kw)
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))
    # the run over 31 December 2003 counts here, and not period by period
    split = getattr(indices, fn)(a, tper, freq="YS", bootstrap=True, **kw)
    in_2003 = got.time.year == 2003
    assert (got.values[in_2003] > split.values[in_2003]).any()


def _recorded(monkeypatch):
    """The time steps of the series each recount hands the index, recorded
    by a wrapper around the index."""
    seen = []
    real = bootstrapping.bootstrap_func

    def spy(index, **kwargs):
        def recorded(**kw):
            per = next(v for k, v in kw.items() if k.endswith("_per"))
            if "_bootstrap" in per.dims:
                da = next(v for k, v in kw.items()
                          if isinstance(v, ClimArray) and v.time is not None)
                seen.append(len(da.time))
            return index(**kw)
        return real(recorded, **kwargs)

    monkeypatch.setattr(bootstrapping, "bootstrap_func", spy)
    return seen


def test_the_recount_reads_the_years_own_days(monkeypatch):
    """4 in-base years (2000 a leap year) a call: tx90p and WSDI recount
    each over its own 366 or 365 days; with ``resample_before_rl=False``
    WSDI and CSDI recount over the whole series."""
    a, b = _pair("standard", seed=41, name="tasmax")
    _, t90 = _carried_per(b, 90)
    _, t10 = _carried_per(b, 10)
    seen = _recorded(monkeypatch)
    with tracing() as tr:
        indices.tx90p(a, t90, freq="YS", bootstrap=True)
        indices.warm_spell_duration_index(a, t90, window=4, freq="YS",
                                          bootstrap=True)
    assert (tr.counters["bootstrap_sliced"], tr.counters["bootstrap_whole"]) \
        == (8, 0)
    assert seen == [366, 365, 365, 365] * 2
    seen.clear()
    with tracing() as tr:
        indices.warm_spell_duration_index(a, t90, window=4, freq="YS",
                                          bootstrap=True,
                                          resample_before_rl=False)
        indices.cold_spell_duration_index(a.rename("tasmin"), t10, window=3,
                                          freq="YS", bootstrap=True,
                                          resample_before_rl=False)
    assert (tr.counters["bootstrap_sliced"], tr.counters["bootstrap_whole"]) \
        == (0, 8)
    assert seen == [len(a.time)] * 8


@pytest.mark.parametrize("gap", [False, True])
def test_periods_that_a_slice_would_move_take_the_whole_series(gap):
    """``30D`` periods are anchored at the series' first day. Without the day
    that starts 2001's first period, a slice from that period's first day
    would anchor them a day later: that call recounts over the whole
    series."""
    a, b = _pair("noleap", seed=7, name="tasmax")
    jper, tper = _carried_per(b, 90)
    if gap:
        starts = resample_segments(a.time, "30D").starts
        first = starts[np.nonzero(a.time.year[starts] == 2001)[0][0]]
        keep = np.arange(len(a.time)) != first
        a, b = a.sel_time(mask=keep), b.sel_time(mask=keep)
    with tracing() as tr:
        got = indices.tx90p(a, tper, freq="30D", bootstrap=True)
    exp = jindices.tx90p(b, jper, freq="30D", bootstrap=True)
    np.testing.assert_array_equal(got.values, np.asarray(exp.data))
    assert (tr.counters["bootstrap_sliced"], tr.counters["bootstrap_whole"]) \
        == ((0, 4) if gap else (4, 0))


# ------------------------------------------------- the entry's two forms


def _sample_tensor(mode, seed, n_doy=2, w=W):
    """(n_doy, Y, w, C) in-base samples: one doy of ``_samples`` each."""
    return torch.as_tensor(np.stack([_samples(mode, seed + d, w=w)
                                     for d in range(n_doy)]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [0.9, 0.1, 0.75, 0.25])
def test_keyword_form_equals_the_positional_form(q, mode):
    """``samples=`` (the sample tensor, year b skipped) gives the positional
    form's bits for A_b = year b and A_o = the other years in order, and a
    CPU call of either form runs the twin."""
    D = _sample_tensor(mode, seed=int(q * 100) + len(mode))
    n_doy = D.shape[0]
    K = boot.topk_capacity(Y * W, W, q)
    tabs = boot.topk_rank_tables(D.reshape(n_doy, Y * W, C),
                                 np.arange(Y).repeat(W), K)
    for b in range(Y):
        counts = (boot.twin_calls, boot.launches)
        got = boot.merge_rank_replaced_year_quantile(*tabs, None, None, b, q,
                                                     samples=D)
        others = [o for o in range(Y) if o != b]
        A_b = D[:, b].movedim(-1, -2)
        A_o = torch.stack([D[:, o].movedim(-1, -2) for o in others])
        exp = boot.merge_rank_replaced_year_quantile(*tabs, A_b, A_o, b, q)
        assert (boot.twin_calls, boot.launches) == (counts[0] + 2, counts[1])
        assert got.shape == (Y - 1, n_doy, C)
        assert torch.equal(torch.isnan(got), torch.isnan(exp))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(exp))


def _entry_args(**over):
    D = _sample_tensor("plain", seed=3)
    tabs = boot.topk_rank_tables(D.reshape(2, Y * W, C),
                                 np.arange(Y).repeat(W), 12)
    args = dict(zip(["topv", "topyear", "botv", "botyear", "nvalid"], tabs),
                A_b=None, A_o=None, b=1, q=0.9, samples=D)
    args.update(over)
    return args


REFUSED = [
    ("integer values", TypeError,
     lambda a: dict(samples=a["samples"].to(torch.int32))),
    ("float year tags", TypeError,
     lambda a: dict(topyear=a["topyear"].float())),
    ("bool valid counts", TypeError, lambda a: dict(nvalid=a["nvalid"] > 0)),
    ("both forms", ValueError,
     lambda a: dict(A_b=a["samples"][:, 0].movedim(-1, -2))),
    ("tables of another shape", ValueError,
     lambda a: dict(topv=a["topv"][..., :-1])),
    ("samples of another cell count", ValueError,
     lambda a: dict(samples=a["samples"][..., :-1])),
    ("samples without a doy axis", ValueError,
     lambda a: dict(samples=a["samples"][0])),
    ("a year past the samples", ValueError, lambda a: dict(b=Y)),
    ("q past 1", ValueError, lambda a: dict(q=1.5)),
    ("inputs on two devices", ValueError,
     lambda a: dict(samples=a["samples"].to("meta"))),
    ("a device without the kernel", ValueError,
     lambda a: {k: v.to("meta") for k, v in a.items()
                if isinstance(v, torch.Tensor)}),
    ("positional windows that differ", ValueError,
     lambda a: dict(samples=None, A_b=torch.zeros(2, C, W),
                    A_o=torch.zeros(3, 2, C, W + 1))),
    ("positional shapes that do not broadcast", ValueError,
     lambda a: dict(samples=None, A_b=torch.zeros(3, C, W),
                    A_o=torch.zeros(3, 2, C, W))),
]


@pytest.mark.parametrize("what,err,change", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_the_entry_refuses_before_any_work(what, err, change):
    args = _entry_args()
    args.update(change(args))
    counts = (boot.twin_calls, boot.launches)
    with tracing() as tr:
        with pytest.raises(err):
            boot.merge_rank_replaced_year_quantile(
                args.pop("topv"), args.pop("topyear"), args.pop("botv"),
                args.pop("botyear"), args.pop("nvalid"), args.pop("A_b"),
                args.pop("A_o"), args.pop("b"), args.pop("q"), **args)
    assert (boot.twin_calls, boot.launches) == counts
    assert [s["name"] for s in tr.spans] == ["op.bootstrap"]


def test_a_cpu_bootstrap_counts_the_twin_once_a_base_year():
    """tx90p with the bootstrap on CPU tensors: one twin call an in-base
    year (4) and percentile, no launch, and the span each time."""
    a, b = _pair("noleap", seed=51, name="tasmax")
    _, tper = _carried_per(b, 90)
    counts = (boot.twin_calls, boot.launches)
    with tracing() as tr:
        indices.tx90p(a, tper, freq="YS", bootstrap=True)
    assert (boot.twin_calls, boot.launches) == (counts[0] + 4, counts[1])
    assert sum(s["name"] == "op.bootstrap" for s in tr.spans) == 4


def test_a_float64_series_bootstraps_on_the_twin_as_before(monkeypatch):
    """tx90p with the bootstrap on a float64 CPU series: the entry hands the
    float64 samples to the twin, which computes in float64, with the bits
    of the twin called on the other years' copy (the call it replaced)."""
    a, b = _pair("noleap", seed=52, name="tasmax")
    a = a.copy(data=a.data.double())
    _, tper = _carried_per(b, 90)
    entry = bootstrapping.merge_rank_replaced_year_quantile
    seen = []

    def spy(*args, **kwargs):
        out = entry(*args, **kwargs)
        seen.append((kwargs["samples"].dtype, out.dtype))
        return out

    monkeypatch.setattr(bootstrapping, "merge_rank_replaced_year_quantile",
                        spy)
    got = indices.tx90p(a, tper, freq="YS", bootstrap=True)
    assert seen == [(torch.float64, torch.float64)] * 4

    def copied(topv, topyear, botv, botyear, nvalid, A_b, A_o, b, q,
               alpha, beta, samples):
        Dt = samples.permute(0, 3, 1, 2)            # (n_doy, C, nyears, w)
        others = torch.as_tensor([o for o in range(Dt.shape[2]) if o != b])
        return boot.merge_rank_replaced_year_quantile_plain(
            topv, topyear, botv, botyear, nvalid, Dt[:, :, b],
            Dt.index_select(2, others).movedim(2, 0), b, q, alpha=alpha,
            beta=beta)

    monkeypatch.setattr(bootstrapping, "merge_rank_replaced_year_quantile",
                        copied)
    exp = indices.tx90p(a, tper, freq="YS", bootstrap=True)
    np.testing.assert_array_equal(got.values, exp.values)
