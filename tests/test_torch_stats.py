"""The port's ``indices/stats.py`` against the JAX package's on the same
numpy data: every fitter and method, the parametric quantile/cdf/pdf,
``fa``/``frequency_analysis``/``dist_method``, the standardized-index trio,
and the maximum-likelihood oracles the reference is held to
(``tests/test_stats_oracles.py``).

Bounds. Closed forms that are well conditioned hold to 1e-6 relative.
Where a closed form cancels in float32 (the GEV and fisk PWM estimators;
gamma's, whose PWM shape goes through l2 = 2 b1 - b0 and whose
approximate ML through A = log(mean) - mean(log)), the two packages'
sums in another order show at up to ~4e-4 of a parameter, so the port is
held to the same estimator evaluated in float64 (the port on float64
tensors): no further from it than twice the reference is. Where the
reference's float32 special function is the less accurate side (XLA's
igamma, up to 5.3e-6 from scipy; torch's gammainc 9e-7), the port is held
to scipy: no further than the reference. BFGS does not repeat jax's
iterates step by step, so its optima hold to the published values and to
the reference's fit at 1e-3 (the reference's own oracle tolerance)."""

import numpy as np
import pytest
import scipy.special as sc
import scipy.stats as sps
import torch

import jax
import jax.numpy as jnp

from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import stats as jstats
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indices import stats
from xclim_tpu_torch.sdba.grouping import Grouper

from test_stats_oracles import GEV_DATA, WEIBULL_DATA

NS, C = 40, 16
CLOSED = [("norm", "ML"), ("norm", "MM"), ("expon", "ML"),
          ("lognorm", "ML"), ("gumbel_r", "ML"),
          ("gumbel_r", "PWM"), ("weibull_min", "PWM"), ("weibull_min", "MM")]
ILL = [("gamma", "APP"), ("gamma", "ML"), ("gamma", "PWM"),
       ("genextreme", "PWM"), ("fisk", "PWM")]


def _samples(seed=0, n=NS, cells=C):
    rng = np.random.default_rng(seed)
    x = (rng.gamma(2.0, 3.0, (n, cells)) + 1).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    return x


def _pair(x, units="mm/d", start="2000-01-01", calendar="noleap"):
    dims = ("time",) if x.ndim == 1 else ("time", "c")
    tj = jdate_range(start, periods=x.shape[0], calendar=calendar)
    tt = date_range(start, periods=x.shape[0], calendar=calendar)
    return (JClimArray(jnp.asarray(x), dims, {"time": tj}, {"units": units},
                       "x"),
            ClimArray(torch.as_tensor(x), dims, {"time": tt},
                      {"units": units}, "x"))


def _port64(x):
    t = date_range("2000-01-01", periods=x.shape[0], calendar="noleap")
    return ClimArray(torch.as_tensor(x.astype(np.float64)), ("time", "c"),
                     {"time": t}, {"units": "mm/d"}, "x")


def _no_worse(port, ref, exact, factor=2.0, name=""):
    """Per parameter row: the port's largest distance to the float64
    evaluation is at most factor x the reference's (plus 1e-6 of the
    row's scale)."""
    for k in range(exact.shape[0]):
        scale = np.nanmax(np.abs(exact[k]))
        d_port = np.nanmax(np.abs(port[k] - exact[k]))
        d_ref = np.nanmax(np.abs(ref[k] - exact[k]))
        assert d_port <= factor * d_ref + 1e-6 * scale, (name, k, d_port,
                                                         d_ref)


@pytest.mark.parametrize("dist, method", CLOSED)
def test_closed_form_fits(dist, method):
    ja, ta = _pair(_samples())
    want = jstats.fit(ja, dist, method)
    got = stats.fit(ta, dist, method)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_array_equal(got.coords["dparams"],
                                  want.coords["dparams"])
    np.testing.assert_allclose(got.values, np.asarray(want.data), rtol=1e-6,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("dist, method", ILL)
def test_cancelling_closed_forms_no_worse_than_reference(dist, method):
    x = _samples(1, cells=200)
    ja, ta = _pair(x)
    want = np.asarray(jstats.fit(ja, dist, method).data)
    got = stats.fit(ta, dist, method).values
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    exact = stats.fit(_port64(x), dist, method).values
    _no_worse(got, want, exact, name=f"{dist} {method}")


def test_lmoments_and_gpd_pieces():
    x = _samples(2)
    got = stats._lmoments(torch.as_tensor(x), 0)
    want = jstats._lmoments(jnp.asarray(x), 0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # l2 and l3 are differences of the probability-weighted moments: held
    # at 1e-6 of l1, the scale the b's carry
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(want[0])).max())


def test_ml_scipy_is_the_same_host_fit():
    ja, ta = _pair(_samples(3, n=30, cells=3))
    want = jstats.fit(ja, "gamma", "ML_scipy")
    got = stats.fit(ta, "gamma", "ML_scipy")
    np.testing.assert_array_equal(got.values, np.asarray(want.data))
    assert got.attrs == want.attrs


def _series64(vals):
    t = date_range("2045-02-02", periods=len(vals), freq="D")
    return ClimArray(torch.as_tensor(np.asarray(vals, dtype=np.float32)),
                     ("time",), {"time": t}, {"units": ""}, "q")


@pytest.mark.parametrize("dist, data, expected", [
    # xclim:tests/test_stats.py:147, :153 — diverge without a good start
    ("weibull_min", WEIBULL_DATA, (1.7760067, -322.092552, 4355.262679)),
    ("genextreme", GEV_DATA, (0.20949, 297.954091, 75.7911863)),
])
def test_ml_oracles(dist, data, expected):
    p = stats.fit(_series64(data), dist).values
    np.testing.assert_allclose(p, expected, rtol=1e-3)


def test_ml_nan_equals_censor():
    vals = np.asarray(GEV_DATA, dtype=float)
    vals_nan = vals.copy()
    vals_nan[0] = np.nan
    np.testing.assert_allclose(stats.fit(_series64(vals_nan), "genextreme").values,
                               stats.fit(_series64(vals[1:]), "genextreme").values,
                               rtol=1e-5)


@pytest.mark.parametrize("dist, c", [("genextreme", 0.25),
                                     ("weibull_min", 1.8)])
def test_ml_fits_against_reference(dist, c):
    """The batched BFGS over 12 cells of 40 draws from the distribution,
    against the reference's vmapped BFGS: the same optimum at 1e-3."""
    rng = np.random.default_rng(5)
    x = getattr(sps, dist).rvs(c, loc=10.0, scale=3.0, size=(40, 12),
                               random_state=rng).astype(np.float32)
    ja, ta = _pair(x)
    got = stats.fit(ta, dist, "ML").values
    want = np.asarray(jstats.fit(ja, dist, "ML").data)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def _fitted(dist):
    """The reference's fit of dist to yearly maxima, and the same numbers
    as a port ClimArray: both packages evaluate one set of parameters."""
    x = _samples(4, n=12 * 365, cells=6)
    ja, ta = _pair(x)
    method = "PWM" if dist in ("genextreme", "gumbel_r", "fisk",
                               "gamma") else "ML"
    pj = jstats.fit(ja.resample("YS").max(), dist, method)
    pt = stats.fit(ta.resample("YS").max(), dist, method)
    pt = ClimArray(torch.as_tensor(np.asarray(pj.data)), pt.dims, pt.coords,
                   pt.attrs, pt.name)
    return pj, pt


DISTS = list(stats.DIST_PARAMS)
QS = [0.1, 0.5, 0.9, 0.99]
VS = [5.0, 10.0, 20.0]


def _scipy(dist, p, fn, v):
    """scipy's float64 value of fn at each v for each cell's parameters."""
    p = np.asarray(p, dtype=np.float64)
    return np.stack([getattr(getattr(sps, dist), fn)(vv, *p) for vv in v])


@pytest.mark.parametrize("dist", DISTS)
def test_parametric_quantile_and_cdf(dist):
    pj, pt = _fitted(dist)
    q_got = stats.parametric_quantile(pt, QS).values
    q_want = np.asarray(jstats.parametric_quantile(pj, QS).data)
    c_got = stats.parametric_cdf(pt, VS).values
    c_want = np.asarray(jstats.parametric_cdf(pj, VS).data)
    np.testing.assert_array_equal(np.isnan(q_got), np.isnan(q_want))
    np.testing.assert_array_equal(np.isnan(c_got), np.isnan(c_want))
    if dist == "gamma":
        # XLA's igamma is the less accurate side: held to scipy instead
        p = np.asarray(pj.data)
        _no_worse(q_got, q_want, _scipy(dist, p, "ppf", QS), factor=1.0)
        _no_worse(c_got, c_want, _scipy(dist, p, "cdf", VS), factor=1.0)
        return
    np.testing.assert_allclose(q_got, q_want, rtol=1e-6, equal_nan=True)
    # a cdf in [0, 1]: 1e-6 absolute (8 ulp of 1)
    np.testing.assert_allclose(c_got, c_want, rtol=0, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("dist", DISTS)
def test_parametric_pdf_is_the_cdf_quotient(dist):
    """The pdf is (cdf(v + 1e-6) - cdf(v - 1e-6)) / 2e-6 in float32 on both
    sides (the reference's definition): it differs from the reference by
    exactly the two cdfs' differences over 2e-6 (plus the quotient's own
    rounding), which is what it is held to."""
    pj, pt = _fitted(dist)
    got = stats.parametric_pdf(pt, VS).values
    want = np.asarray(jstats.parametric_pdf(pj, VS).data)
    hi = [v + 1e-6 for v in VS]
    lo = [v - 1e-6 for v in VS]
    d_hi = np.abs(stats.parametric_cdf(pt, hi).values
                  - np.asarray(jstats.parametric_cdf(pj, hi).data))
    d_lo = np.abs(stats.parametric_cdf(pt, lo).values
                  - np.asarray(jstats.parametric_cdf(pj, lo).data))
    bound = (d_hi + d_lo) / 2e-6 * (1 + 1e-6) + 2.0 ** -22 * np.abs(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (np.abs(got - want)[ok] <= bound[ok]).all()


def test_dist_method_dispatch():
    _, pt = _fitted("gumbel_r")
    for fn, call in (("cdf", stats.parametric_cdf),
                     ("ppf", stats.parametric_quantile),
                     ("pdf", stats.parametric_pdf)):
        arg = QS if fn == "ppf" else VS
        np.testing.assert_array_equal(stats.dist_method(fn, pt, arg).values,
                                      call(pt, arg).values)
    with pytest.raises(NotImplementedError):
        stats.dist_method("sf", pt, VS)


@pytest.mark.parametrize("dist", ["gumbel_r", "norm"])
def test_fa_and_frequency_analysis(dist):
    ja, ta = _pair(_samples(6, n=12 * 365, cells=4))
    method = "PWM" if dist == "gumbel_r" else "ML"
    want = jstats.frequency_analysis(ja, "max", [2, 20], dist, window=3,
                                     method=method)
    got = stats.frequency_analysis(ta, "max", [2, 20], dist, window=3,
                                   method=method)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_array_equal(got.coords["return_period"],
                                  want.coords["return_period"])
    np.testing.assert_allclose(got.values, np.asarray(want.data), rtol=1e-6)
    lows = stats.fa(ta.resample("YS").min(), [5], dist, mode="min",
                    method=method)
    lows_want = jstats.fa(ja.resample("YS").min(), [5], dist, mode="min",
                          method=method)
    np.testing.assert_allclose(lows.values, np.asarray(lows_want.data),
                               rtol=1e-6)


def _pr(seed=8, years=12, cells=5):
    rng = np.random.default_rng(seed)
    n = years * 365
    x = np.where(rng.random((n, cells)) < 0.4, 0.0,
                 rng.gamma(2.0, 3.0, (n, cells))).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    return x


@pytest.mark.parametrize("freq, window", [("MS", 3), ("MS", 1), (None, 1)])
def test_preprocess_standardized_index(freq, window):
    ja, ta = _pair(_pr())
    (jd, jg), (td, tg) = (jstats.preprocess_standardized_index(ja, freq,
                                                               window),
                          stats.preprocess_standardized_index(ta, freq,
                                                              window))
    assert jg == tg and td.dims == jd.dims
    np.testing.assert_allclose(td.values, np.asarray(jd.data), rtol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("dist, method, zero_inflated", [
    ("norm", "ML", False), ("lognorm", "ML", True)])
def test_standardized_index_fit_params(dist, method, zero_inflated):
    ja, ta = _pair(_pr())
    want = jstats.standardized_index_fit_params(ja, "MS", 3, dist, method,
                                                zero_inflated)
    got = stats.standardized_index_fit_params(ta, "MS", 3, dist, method,
                                              zero_inflated)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_allclose(got.values, np.asarray(want.data), rtol=1e-6,
                               atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("method", ["APP", "PWM"])
def test_standardized_index_gamma_fit_params_no_worse(method):
    x = _pr(9, cells=40)
    ja, ta = _pair(x)
    want = np.asarray(jstats.standardized_index_fit_params(
        ja, "MS", 3, "gamma", method).data)
    got = stats.standardized_index_fit_params(ta, "MS", 3, "gamma",
                                              method).values
    t = date_range("2000-01-01", periods=x.shape[0], calendar="noleap")
    exact = stats.standardized_index_fit_params(
        ClimArray(torch.as_tensor(x.astype(np.float64)), ("time", "c"),
                  {"time": t}, {"units": "mm/d"}, "x"),
        "MS", 3, "gamma", method).values
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _no_worse(got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1),
              exact.reshape(exact.shape[0], -1), name=f"gamma {method}")


@pytest.mark.parametrize("freq", ["MS", None])
def test_gamma_standardized_index_no_worse_than_reference(freq):
    """The gamma SPI from one set of parameters (the reference's fit) is
    ndtri of the zero-inflated gamma cdf: the port no further from scipy's
    float64 evaluation of that formula than twice the reference (XLA's
    igamma is the less accurate side, module doc; its error grows with the
    shape, up to 6e-5 of probability here at a ~ 200)."""
    ja, ta = _pair(_pr(10))
    pj = jstats.standardized_index_fit_params(ja, freq, 3 if freq else 1,
                                              "gamma", "APP", True)
    pt = ClimArray(torch.as_tensor(np.asarray(pj.data)), pj.dims,
                   dict(pj.coords), dict(pj.attrs), pj.name)
    want = jstats.standardized_index(ja, params=pj)
    got = stats.standardized_index(ta, params=pt)
    assert got.dims == want.dims and got.attrs == want.attrs
    w, g = np.asarray(want.data), got.values
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    # the same formula in float64 on the reference's own preprocessed
    # series and per-step parameters
    xd, _ = jstats.preprocess_standardized_index(ja, freq, 3 if freq else 1)
    x = np.asarray(xd.data).astype(np.float64)
    gid = Grouper(pj.attrs["group"]).group_of_step(xd.time)
    p = np.asarray(pj.data).astype(np.float64)[:, np.minimum(
        gid, pj.shape[1] - 1)]                     # (4, T, cells)
    a, loc, scale, p0 = p
    with np.errstate(invalid="ignore", divide="ignore"):
        cdf = sc.gammainc(a, np.maximum(x - loc, 0) / scale)
    prob = np.where(x > 0, p0 + (1 - p0) * cdf, p0 / 2)
    exact = sc.ndtri(np.clip(prob, 5e-4, 1 - 5e-4))
    ok = ~np.isnan(w) & np.isfinite(exact)
    assert np.abs(g - exact)[ok].max() <= 2 * np.abs(w - exact)[ok].max() \
        + 1e-6


def test_normal_standardized_index_given_the_same_params():
    """The normal SPI from one set of parameters: ndtri(ndtr(z)) on both
    sides; a cdf difference dP (8 ulp of 1) moves the index by dP over the
    normal density at it."""
    ja, ta = _pair(_pr(10))
    pj = jstats.standardized_index_fit_params(ja, "MS", 3, "norm", "ML",
                                              False)
    pt = ClimArray(torch.as_tensor(np.asarray(pj.data)), pj.dims,
                   dict(pj.coords), dict(pj.attrs), pj.name)
    w = np.asarray(jstats.standardized_index(ja, params=pj).data)
    g = stats.standardized_index(ta, params=pt).values
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    bound = 1e-6 / sps.norm.pdf(w[ok]) + 1e-6 * np.abs(w[ok])
    assert (np.abs(g[ok] - w[ok]) <= bound).all()


def test_standardized_index_end_to_end_calibration_period():
    ja, ta = _pair(_pr(11), start="1990-01-01")
    kw = dict(freq="MS", window=2, dist="norm", method="ML",
              zero_inflated=False, cal_start="1992", cal_end="1998")
    want = jstats.standardized_index(ja, **kw)
    got = stats.standardized_index(ta, **kw)
    w, g = np.asarray(want.data), got.values
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    bound = 1e-6 / sps.norm.pdf(w[ok]) + 1e-6 * np.abs(w[ok])
    assert (np.abs(g[ok] - w[ok]) <= bound).all()


def test_gammainc_edges_follow_the_reference():
    a = np.array([np.inf, 1.0, 1.0, 0.0, 0.0, -1.0, 2.0, np.nan, 2.0, 3.0],
                 np.float32)
    x = np.array([np.inf, np.inf, 0.0, 1.0, 0.0, 1.0, -1.0, 1.0, np.nan, 2.5],
                 np.float32)
    got = stats._gammainc(torch.as_tensor(a), torch.as_tensor(x)).numpy()
    want = np.asarray(jax.scipy.special.gammainc(jnp.asarray(a),
                                                jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    # the interior value: torch's is the closer one to scipy
    assert abs(got[-1] - sc.gammainc(3.0, 2.5)) <= abs(
        want[-1] - sc.gammainc(3.0, 2.5)) + 1e-7
    np.testing.assert_array_equal(got[ok][:-1], want[ok][:-1])
