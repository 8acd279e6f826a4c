"""The port's ensembles package (``xclim_tpu_torch.ensembles``) against the
JAX package's on the same numpy inputs, on CPU tensors (the axisquantile
twin).

Tolerances, with their reasons:

* percentiles: rtol 1e-6 (SURVEY §6). The reference's CPU dispatch serves
  these shapes by its XLA sort route, which fuses ``n*q + coff`` into one
  FMA: 1 ulp (``tests/test_torch_axisquantile.py``).
* means, stdevs, moments: rtol 1e-6; float32 sums over members or time in
  another order. The weighted quantile's cumulative weights likewise.
* p-values (t-tests, Brown-Forsythe): rtol 1e-3. Both packages evaluate
  the same continued fraction, but XLA's float32 ``lgamma`` is less
  accurate than torch's: on 20000 t-test-like points XLA's betainc sits
  within 1e-3 relative of scipy's double-precision one and the port's
  within 2e-4 (``test_betainc_against_scipy_double``), and ``exp`` turns
  the lgamma error into a relative error of p.
  atol 1e-6 for p-values near 0. From p = 0.5 up, atol 3e-3: the float32
  ``x = df / (df + t^2)`` resolves t^2 only above df * 6e-8, so a t-test
  p-value near 1 carries an absolute error up to ~0.8 * sqrt(df * 6e-8)
  (2.6e-3 at df = 181) in either package. Mann-Whitney (erfc of exact
  counts): rtol 1e-5.
* fractions: exact (sums of dyadic weights), except ``changed*`` in cells
  where a member's p-value lies within the p-value tolerance of
  ``p_change``, and, for the t-tests, ``positive``, ``negative`` and
  ``agree`` where one lies within 3e-3 of 1 (a change within rounding of
  0, whose sign may flip; under 10 % of cells). ``valid`` is always exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.scipy.special import betainc as j_betainc

import xclim_tpu.ensembles as jens
import xclim_tpu_torch.ensembles as tens
from xclim_tpu.core.calendar import date_range as j_date_range
from xclim_tpu.core.dataarray import ClimArray as JArray
from xclim_tpu.core.dataarray import ClimDataset as JDataset
from xclim_tpu_torch.core.calendar import date_range as t_date_range
from xclim_tpu_torch.core.dataarray import ClimArray as TArray
from xclim_tpu_torch.core.dataarray import ClimDataset as TDataset
from xclim_tpu_torch.ensembles._robustness import _betainc

RTOL = 1e-6
P_RTOL = 1e-3
P_ATOL = 1e-6
P_NEAR_ONE = 3e-3
NREAL, NT, NLAT, NLON = 6, 20, 10, 20      # 200 cells
WEIGHTS = np.asarray([1.0, 2.0, 0.5, 1.0, 4.0, 0.25], np.float32)


def _pair(data, dims, time=None, calendar="noleap", start="2000-01-01",
          freq="D", name="tas", **coords):
    """The same array as a reference and a port ClimArray."""
    jc, tc = dict(coords), dict(coords)
    if time is not None:
        jc["time"] = j_date_range(start, periods=time, freq=freq,
                                  calendar=calendar)
        tc["time"] = t_date_range(start, periods=time, freq=freq,
                                  calendar=calendar)
    attrs = {"units": "K", "description": "mean temperature"}
    return (JArray(jnp.asarray(data), dims, jc, dict(attrs), name),
            TArray(torch.as_tensor(data), dims, tc, dict(attrs), name))


def _vals(a):
    return np.asarray(a.values)


def _close(got, exp, rtol=RTOL, atol=0.0):
    got, exp = _vals(got), _vals(exp)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol, equal_nan=True)


def _same_labels(t, j):
    assert t.dims == j.dims and t.name == j.name
    assert set(t.coords) == set(j.coords)
    assert t.attrs == j.attrs


def _members(n=NREAL, nt=NT, seed=0, nan=True):
    """n members (time, lat, lon) at ~285 K with a member-specific trend
    over time; a few NaN holes, one member all NaN in cell (0, 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 3.0, (n, nt, NLAT, NLON)).astype(np.float32)
    x += (np.linspace(0.0, 1.0, nt, dtype=np.float32)[None, :, None, None]
          * rng.normal(2.0, 1.5, (n, 1, NLAT, NLON)).astype(np.float32))
    if nan:
        x[rng.random(x.shape) < 0.02] = np.nan
        x[0, :, 0, 0] = np.nan
        x[:, :, 0, 1] = np.nan                    # every member missing
    return x


def _ensemble(x, **kw):
    coords = {"lat": np.arange(NLAT), "lon": np.arange(NLON)}
    pairs = [_pair(m, ("time", "lat", "lon"), time=x.shape[1], **coords, **kw)
             for m in x]
    return (jens.create_ensemble([p[0] for p in pairs]),
            tens.create_ensemble([p[1] for p in pairs]))


# ---------------------------------------------------------------------------
# creation and statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("calendars", [
    ("standard", "noleap"), ("noleap", "360_day", "standard"),
    ("all_leap", "noleap")])
def test_create_ensemble_mixed_calendars(calendars):
    rng = np.random.default_rng(len(calendars))
    jm, tm = [], []
    for i, cal in enumerate(calendars):
        x = rng.normal(285.0, 3.0, (400, 3)).astype(np.float32)
        j, t = _pair(x, ("time", "site"), time=400, calendar=cal,
                     start=f"2000-0{i + 1}-01", site=np.arange(3))
        jm.append(j)
        tm.append(t)
    je = jens.create_ensemble(jm)
    te = tens.create_ensemble(tm, realizations=None)
    assert te.dims == je.dims == ("realization", "time", "site")
    np.testing.assert_array_equal(_vals(te), _vals(je))
    assert te.time.calendar == je.time.calendar
    np.testing.assert_array_equal(te.time.encode(), je.time.encode())
    np.testing.assert_array_equal(te.coords["realization"],
                                  je.coords["realization"])


def test_create_ensemble_of_datasets():
    x = _members(3, nan=False)
    jd, td = [], []
    for m in x:
        (ja, ta), (jb, tb) = (_pair(m, ("time", "lat", "lon"), time=NT, name=n)
                              for n in ("tas", "pr"))
        jd.append(JDataset({"tas": ja, "pr": jb}))
        td.append(TDataset({"tas": ta, "pr": tb}))
    je = jens.create_ensemble(jd, realizations=["a", "b", "c"])
    te = tens.create_ensemble(td, realizations=["a", "b", "c"])
    assert list(te.keys()) == list(je.keys())
    for k in je.keys():
        np.testing.assert_array_equal(_vals(te[k]), _vals(je[k]))
        np.testing.assert_array_equal(te[k].coords["realization"],
                                      je[k].coords["realization"])


@pytest.mark.parametrize("weights", [None, WEIGHTS])
def test_ensemble_mean_std_max_min(weights):
    je, te = _ensemble(_members())
    jo = jens.ensemble_mean_std_max_min(JDataset({"tas": je}), weights=weights)
    to = tens.ensemble_mean_std_max_min(TDataset({"tas": te}), weights=weights)
    assert list(to.keys()) == list(jo.keys())
    for k in jo.keys():
        _same_labels(to[k], jo[k])
        # stdev: sqrt of a difference of sums near 9 K^2
        _close(to[k], jo[k], atol=1e-6 if k.endswith("stdev") else 0.0)


# ---------------------------------------------------------------------------
# percentiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", [True, False])
def test_ensemble_percentiles(split):
    je, te = _ensemble(_members())
    values = [10, 50, 90]
    jo = jens.ensemble_percentiles(je, values=values, split=split)
    to = tens.ensemble_percentiles(te, values=values, split=split)
    if split:
        assert list(to) == list(jo) == [10.0, 50.0, 90.0]
        pairs = [(to[k], jo[k]) for k in jo]
    else:
        np.testing.assert_array_equal(to.coords["percentiles"],
                                      jo.coords["percentiles"])
        pairs = [(to, jo)]
    for t, j in pairs:
        _same_labels(t, j)
        _close(t, j)
    if not split:
        v = _vals(to)
        ok = ~np.isnan(v[0])
        assert (v[0][ok] <= v[1][ok]).all() and (v[1][ok] <= v[2][ok]).all()
        assert np.isnan(v[:, :, 0, 1]).all()


def test_ensemble_percentiles_dataset_and_odd_values():
    je, te = _ensemble(_members(seed=3))
    values = [5, 33.3, 50, 97.5]
    jo = jens.ensemble_percentiles(JDataset({"tas": je}), values=values)
    to = tens.ensemble_percentiles(TDataset({"tas": te}), values=values)
    assert list(to.keys()) == list(jo.keys())
    for k in jo.keys():
        _same_labels(to[k], jo[k])
        _close(to[k], jo[k])


def test_ensemble_percentiles_weighted():
    je, te = _ensemble(_members(seed=4))
    jo = jens.ensemble_percentiles(je, values=[10, 50, 90], weights=WEIGHTS,
                                   split=False)
    to = tens.ensemble_percentiles(te, values=[10, 50, 90], weights=WEIGHTS,
                                   split=False)
    _same_labels(to, jo)
    _close(to, jo)


# ---------------------------------------------------------------------------
# robustness
# ---------------------------------------------------------------------------

TESTS = [None, "threshold", "ttest", "welch-ttest", "mannwhitney-utest",
         "brownforsythe-test", "ipcc-ar6-c"]
P_TESTS = ("ttest", "welch-ttest", "brownforsythe-test")


def _fut_hist(seed=5):
    """fut = days 10-19, hist = days 0-9 of a trending ensemble."""
    je, te = _ensemble(_members(seed=seed))
    return ((je.isel(time=slice(NT // 2, NT)), je.isel(time=slice(0, NT // 2))),
            (te.isel(time=slice(NT // 2, NT)), te.isel(time=slice(0, NT // 2))))


def _kwargs(test):
    if test == "threshold":
        return {"abs_thresh": 0.8}
    if test in P_TESTS + ("mannwhitney-utest",):
        return {"p_change": 0.05}
    return {}


_SIGNS = ("positive", "negative", "agree")


def _check_fractions(to, jo, test, p_change=0.05):
    """Fractions equal; returns the cells exempt from `changed` or from the
    sign, for the callers' checks of the outputs built on them."""
    assert list(to.keys()) == list(jo.keys())
    exempt = np.zeros(_vals(jo["changed"]).shape, dtype=bool)
    sign_exempt = exempt
    if "pvals" in jo:
        p_rtol = 1e-5 if test == "mannwhitney-utest" else P_RTOL
        _same_labels(to["pvals"], jo["pvals"])
        tp, jp = _vals(to["pvals"]), _vals(jo["pvals"])
        np.testing.assert_array_equal(np.isnan(tp), np.isnan(jp))
        high = jp >= 0.5
        np.testing.assert_allclose(tp[~high], jp[~high], rtol=p_rtol,
                                   atol=P_ATOL, equal_nan=True)
        np.testing.assert_allclose(tp[high], jp[high], rtol=0.0,
                                   atol=P_NEAR_ONE)
        # changed (and so changed_*) may flip near p_change; for the t-tests
        # a p-value near 1 means a change within rounding of 0, whose sign
        # (positive, negative, agree) may flip. `valid` is never exempt.
        rax = jo["pvals"].dims.index("realization")
        exempt = (np.abs(jp - p_change)
                  <= p_rtol * p_change + P_ATOL).any(axis=rax)
        if test in ("ttest", "welch-ttest"):
            sign_exempt = (jp >= 1.0 - P_NEAR_ONE).any(axis=rax)
        assert sign_exempt.mean() < 0.10
    for k in jo.keys():
        if k == "pvals":
            continue
        _same_labels(to[k], jo[k])
        t, j = _vals(to[k]), _vals(jo[k])
        skip = (sign_exempt if k in _SIGNS
                else exempt if k.startswith("changed")
                else np.zeros_like(exempt))
        np.testing.assert_array_equal(t[~skip], j[~skip], err_msg=k)
    return exempt | sign_exempt


@pytest.mark.parametrize("strict_sign", [True, False])
@pytest.mark.parametrize("weights", [None, WEIGHTS])
@pytest.mark.parametrize("test", TESTS)
def test_robustness_fractions_with_ref(test, weights, strict_sign):
    (jf, jh), (tf, th) = _fut_hist()
    kw = _kwargs(test)
    jo = jens.robustness_fractions(jf, jh, test=test, weights=weights,
                                   strict_sign=strict_sign, **kw)
    to = tens.robustness_fractions(tf, th, test=test, weights=weights,
                                   strict_sign=strict_sign, **kw)
    exempt = _check_fractions(to, jo, test)
    assert exempt.mean() < 0.05
    # fractions of the valid members: in [0, 1], and the significant
    # positive and negative ones together no more than the significant ones
    for k in to.keys():
        if k != "pvals":
            v = _vals(to[k])
            assert ((v >= 0) & (v <= 1)).all(), k
    both = _vals(to["changed_positive"]) + _vals(to["changed_negative"])
    assert (both <= _vals(to["changed"]) + 1e-6).all()


@pytest.mark.parametrize("strict_sign", [True, False])
@pytest.mark.parametrize("kw", [{}, {"abs_thresh": 0.8}])
def test_robustness_fractions_of_deltas(kw, strict_sign):
    x = _members(seed=6)
    delta = x[:, NT // 2:].mean(axis=1) - x[:, :NT // 2].mean(axis=1)
    delta[:, 2, 2] = 0.0                       # no change in one cell
    j, t = _pair(delta, ("realization", "lat", "lon"),
                 realization=np.arange(NREAL))
    test = "threshold" if kw else None
    jo = jens.robustness_fractions(j, test=test, strict_sign=strict_sign, **kw)
    to = tens.robustness_fractions(t, test=test, strict_sign=strict_sign, **kw)
    _check_fractions(to, jo, test)


def test_robustness_fractions_rejects_what_the_reference_rejects():
    (_, _), (tf, th) = _fut_hist()
    with pytest.raises(ValueError, match="requires a reference"):
        tens.robustness_fractions(tf.isel(time=0), test="ttest")
    with pytest.raises(ValueError, match="abs_thresh or rel_thresh"):
        tens.robustness_fractions(tf, th, test="threshold")
    with pytest.raises(ValueError, match="Unknown significance test"):
        tens.robustness_fractions(tf, th, test="ks")


def test_robustness_fractions_rel_thresh():
    (jf, jh), (tf, th) = _fut_hist(seed=7)
    jo = jens.robustness_fractions(jf, jh, test="threshold", rel_thresh=0.003)
    to = tens.robustness_fractions(tf, th, test="threshold", rel_thresh=0.003)
    _check_fractions(to, jo, "threshold")


def test_robustness_categories():
    (jf, jh), (tf, th) = _fut_hist(seed=8)
    jo = jens.robustness_fractions(jf, jh, test="ttest")
    to = tens.robustness_fractions(tf, th, test="ttest")
    exempt = _check_fractions(to, jo, "ttest")
    jc = jens.robustness_categories(jo)
    tc = tens.robustness_categories(to)
    assert tc.attrs == jc.attrs and tc.dims == jc.dims
    assert tc.data.dtype == torch.int32
    np.testing.assert_array_equal(_vals(tc)[~exempt], _vals(jc)[~exempt])
    jc2 = jens.robustness_categories(jo["changed"], jo["agree"],
                                     thresholds=[(0.5, 0.6), (0.5, None),
                                                 (0.5, 0.6)])
    tc2 = tens.robustness_categories(to["changed"], to["agree"],
                                     thresholds=[(0.5, 0.6), (0.5, None),
                                                 (0.5, 0.6)])
    np.testing.assert_array_equal(_vals(tc2)[~exempt], _vals(jc2)[~exempt])


@pytest.mark.parametrize("with_space", [True, False])
def test_robustness_coefficient(with_space):
    x = _members(seed=9, nan=False)
    if not with_space:
        x = x[:, :, :1, :1]
    j, t = _ensemble(x) if with_space else (None, None)
    if not with_space:
        j, t = _pair(x[:, :, 0, 0], ("realization", "time"), time=NT,
                     realization=np.arange(NREAL))
    jr = j.isel(realization=0)
    tr = t.isel(realization=0)
    jo = jens.robustness_coefficient(j, jr - 1.0)
    to = tens.robustness_coefficient(t, tr - 1.0)
    assert to.dims == jo.dims and to.attrs == jo.attrs and to.name == jo.name
    # the members' time means (float32 sums of 20 values near 285 K in
    # another order) may sit an ulp (3e-5 K) apart; they are breakpoints of
    # the integrated CDFs, ~0.1-1 K from their neighbours, so A1/A2 and R
    # move by up to ~1e-4
    _close(to, jo, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the slice as a whole: percentiles + t-test fractions, as bench composes them
# ---------------------------------------------------------------------------


def test_ensembles_slice():
    x = _members(n=30, nt=40, seed=10)
    je, te = _ensemble(x)
    jp = jens.ensemble_percentiles(je, values=[10, 50, 90])
    tp = tens.ensemble_percentiles(te, values=[10, 50, 90])
    for k in jp:
        _close(tp[k], jp[k])
    jo = jens.robustness_fractions(je.isel(time=slice(20, 40)),
                                   je.isel(time=slice(0, 20)), test="ttest")
    to = tens.robustness_fractions(te.isel(time=slice(20, 40)),
                                   te.isel(time=slice(0, 20)), test="ttest")
    exempt = _check_fractions(to, jo, "ttest")
    assert exempt.mean() < 0.05
    changed = _vals(to["changed"])
    assert 0.0 < np.nanmean(changed) < 1.0


# ---------------------------------------------------------------------------
# the incomplete beta function
# ---------------------------------------------------------------------------


def _betainc_close(a, b, x):
    got = _betainc(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(x)).numpy()
    exp = np.asarray(j_betainc(a, b, x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=P_RTOL, atol=P_ATOL,
                               equal_nan=True)
    return got


@pytest.mark.parametrize("b", [0.5, 1.0, 3.0, 40.0])
def test_betainc_grid(b):
    a = np.linspace(0.5, 100.0, 40, dtype=np.float32)
    x = np.linspace(0.001, 0.999, 50, dtype=np.float32)
    A, X = np.meshgrid(a, x)
    # both sides of the symmetry switch x = (a+1)/(a+b+2)
    switch = X < (A + 1) / (A + b + 2)
    assert switch.any() and (~switch).any()
    _betainc_close(A, np.full_like(A, b), X)


def test_betainc_ttest_arguments():
    rng = np.random.default_rng(1)
    df = rng.integers(1, 200, 5000).astype(np.float32)
    t = np.abs(rng.standard_t(10, 5000)).astype(np.float32) * 2
    x = df / (df + t * t)
    _betainc_close(df / 2, np.full_like(df, 0.5), x)


def test_betainc_random_arguments():
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0.05, 60.0, 4000).astype(np.float32) for _ in "ab")
    _betainc_close(a, b, rng.uniform(0.0, 1.0, 4000).astype(np.float32))


def test_betainc_against_scipy_double():
    # t-test-like arguments: the port's float32 result sits closer to
    # scipy's double-precision betainc than XLA's float32 result does
    from scipy.special import betainc as s_betainc

    rng = np.random.default_rng(3)
    a = (rng.integers(1, 200, 20000) / 2).astype(np.float32)
    b = np.full_like(a, 0.5)
    x = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    exact = s_betainc(a.astype(np.float64), 0.5, x.astype(np.float64))
    ok = exact > 1e-6
    port = _betainc(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(x)).numpy()
    xla = np.asarray(j_betainc(a, b, x))
    port_rel = np.max(np.abs(port - exact)[ok] / exact[ok])
    xla_rel = np.max(np.abs(xla - exact)[ok] / exact[ok])
    assert port_rel <= 2e-4
    assert xla_rel <= 1e-3
    assert port_rel < xla_rel


def test_ttest_pvalues_against_scipy_double():
    # float32 moments and betainc against scipy's double t-test: within
    # 1e-3 relative below p = 0.5; above, within P_NEAR_ONE (x = df /
    # (df + t^2) rounds to 1 when t^2 < df * 6e-8)
    from scipy import stats

    from xclim_tpu_torch.ensembles._robustness import _fractions

    g = torch.Generator()
    g.manual_seed(1981)
    x = torch.randn((30, 365, 2048), generator=g) * 5 + 285
    x += torch.linspace(0, 1, 365)[:, None] * (torch.rand(
        (30, 1, 1), generator=g) * 2)
    fut, hist = x[:, 183:], x[:, :182]
    p32 = _fractions(fut, hist, torch.ones(30), "ttest", True, True, 1, 0,
                     {})[-1].numpy()
    f64, h64 = fut.double().numpy(), hist.double().numpy()
    p64 = stats.ttest_1samp(f64, h64.mean(axis=1)[:, None, :], axis=1)[1]
    high = p64 >= 0.5
    np.testing.assert_allclose(p32[~high], p64[~high], rtol=P_RTOL,
                               atol=P_ATOL)
    np.testing.assert_allclose(p32[high], p64[high], rtol=0.0,
                               atol=P_NEAR_ONE)


def test_betainc_special_cases():
    a = np.asarray([0, 1, 0, 2, np.inf, 1, 2, -1, 2, np.nan, 0, 2, 1e-39,
                    3], np.float32)
    b = np.asarray([1, 0, 0, np.inf, 2, 2, 2, 2, -1, 1, 1, 2, 2, np.nan],
                   np.float32)
    x = np.asarray([0.5, 0.5, 0.5, 0.3, 0.3, 0.0, 1.0, 0.5, 0.5, 0.5, 0.0,
                    1.5, 0.5, 0.5], np.float32)
    got = _betainc_close(a, b, x)
    np.testing.assert_array_equal(got[:7], [1, 0, np.nan, 1, 0, 0, 1])


# ---------------------------------------------------------------------------
# filters, partitioning, reduction
# ---------------------------------------------------------------------------


def _scen_model_member(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 2.0, (3, 4, 3, 12)).astype(np.float32)
    x[1, 2] = np.nan                              # model 2 lacks scenario 1
    x[0, 0, 0, 5] = np.nan                        # member 0 incomplete
    x[2, :, :, :6] = np.nan                       # scenario 2 starts late
    coords = {"scenario": np.asarray(["historical", "ssp245", "ssp585"]),
              "model": np.arange(4), "member": np.arange(3)}
    return _pair(x, ("scenario", "model", "member", "time"), time=12,
                 freq="YS", **coords)


def test_filters():
    j, t = _scen_model_member()
    for fn in ("_model_in_all_scens", "_single_member"):
        jo, to = getattr(jens, fn)(j), getattr(tens, fn)(t)
        assert to.dims == jo.dims
        np.testing.assert_array_equal(_vals(to), _vals(jo))
        for k in jo.coords:
            if k != "time":
                np.testing.assert_array_equal(to.coords[k], jo.coords[k])
    jo = jens._concat_hist(j.isel(member=0), scenario="historical")
    to = tens._concat_hist(t.isel(member=0), scenario="historical")
    assert to.dims == jo.dims
    np.testing.assert_array_equal(_vals(to), _vals(jo))
    dims = {"scenario": "exp", "model": "source", "member": "run"}
    jr = j.copy()
    jr.dims = tuple(dims[d] if d in dims else d for d in j.dims)
    jr.coords = {dims.get(k, k): v for k, v in j.coords.items()}
    tr = t.copy()
    tr.dims, tr.coords = jr.dims, {dims.get(k, k): v for k, v in t.coords.items()}
    inv = {v: k for k, v in dims.items()}
    jo = jens._single_member(jr, dimensions=inv)
    to = tens._single_member(tr, dimensions=inv)
    assert to.dims == jo.dims
    np.testing.assert_array_equal(_vals(to), _vals(jo))


def _partition_input(ndim, seed=12):
    rng = np.random.default_rng(seed)
    shape = (40, 3, 4, 2)[:ndim]
    trend = np.linspace(0.0, 3.0, 40)[(slice(None),) + (None,) * (ndim - 1)]
    data = (280.0 + trend * (1 + 0.3 * np.arange(3))[:, None].reshape(
        (1, 3) + (1,) * (ndim - 2)) + rng.normal(0.0, 0.5, shape)).astype(
        np.float32)
    dims = ("time", "scenario", "model", "downscaling")[:ndim]
    coords = {"scenario": np.asarray(["a", "b", "c"]), "model": np.arange(4),
              "downscaling": np.arange(2)}
    return _pair(data, dims, time=40, freq="YS", start="1981-01-01",
                 **{d: coords[d] for d in dims[1:]})


@pytest.mark.parametrize("fn,ndim,kw", [
    ("hawkins_sutton", 3, {"baseline": ("1981", "2000")}),
    ("hawkins_sutton", 3, {"baseline": ("1981", "2000"), "kind": "*",
                           "weights": [1.0, 2.0, 1.0, 0.5]}),
    ("lafferty_sriver", 4, {}),
    ("lafferty_sriver", 4, {"bb13": True}),
    ("general_partition", 4, {"var_first": ["model", "downscaling"]}),
    ("general_partition", 3, {})])
def test_partitioning(fn, ndim, kw):
    j, t = _partition_input(ndim)
    jg, ju = getattr(jens, fn)(j, **kw)
    tg, tu = getattr(tens, fn)(t, **kw)
    for a, b in ((tg, jg), (tu, ju)):
        assert a.dims == b.dims and a.name == b.name
    # the same float64 host arithmetic on the same data
    np.testing.assert_array_equal(_vals(tg), _vals(jg))
    np.testing.assert_array_equal(_vals(tu), _vals(ju))
    np.testing.assert_array_equal(tu.coords["uncertainty"],
                                  ju.coords["uncertainty"])
    np.testing.assert_array_equal(_vals(tens.fractional_uncertainty(tu)),
                                  _vals(jens.fractional_uncertainty(ju)))


def test_make_criteria_and_kkz():
    je, te = _ensemble(_members(n=12, seed=13))
    jc = jens.make_criteria(je.isel(time=0))
    tc = tens.make_criteria(te.isel(time=0))
    assert tc.dims == jc.dims
    np.testing.assert_array_equal(_vals(tc), _vals(jc))
    for kw in ({}, {"standardize": False}):
        assert tens.kkz_reduce_ensemble(tc, 5, **kw) == \
            jens.kkz_reduce_ensemble(jc, 5, **kw)


@pytest.mark.parametrize("method", [{"n_clusters": 4}, {"rsq_cutoff": 0.75},
                                    {"rsq_optimize": None}])
def test_kmeans_reduce_ensemble(method):
    pytest.importorskip("sklearn")
    crit = np.random.default_rng(0).normal(0.0, 1.0, (12, 6))
    j_ids, j_labels, j_fig = jens.kmeans_reduce_ensemble(
        crit, method=method, random_state=0)
    t_ids, t_labels, t_fig = tens.kmeans_reduce_ensemble(
        crit, method=method, random_state=0)
    assert t_ids == j_ids
    np.testing.assert_array_equal(t_labels, j_labels)
    assert t_fig["n_clusters"] == j_fig["n_clusters"]
