"""The port's sdba ``processing``, ``properties`` and ``measures`` against the
JAX package's on the same numpy series (12 noleap years x 4 cells of tas
in K and pr in mm/d with dry days and gaps).

Random draws (jitter, adapt_freq) come from ``jax.random`` in the
reference and a ``torch.Generator`` in the port, so they are held to the
reference's property tests (``tests/test_sdba_diagnostics.py``), and their
deterministic parts (adapt_freq's pth and dP0, the values left unchanged)
to the reference itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xclim_tpu.sdba as jsdba
import xclim_tpu_torch.sdba as tsdba
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray

NY, C = 12, 4


def _data():
    rng = np.random.default_rng(42)
    T = NY * 365
    doy = np.arange(T) % 365
    tas = (285 + 10 * np.sin(2 * np.pi * doy / 365)[:, None]
           + 0.05 * np.arange(T)[:, None] / 365
           + rng.normal(0, 3, (T, C))).astype(np.float32)
    tas2 = (tas + rng.normal(0.5, 1.5, (T, C))).astype(np.float32)
    pr = np.where(rng.random((T, C)) < 0.5, 0.0,
                  rng.gamma(0.9, 4.0, (T, C))).astype(np.float32)
    pr2 = np.where(rng.random((T, C)) < 0.65, 0.0,
                   rng.gamma(0.9, 3.0, (T, C))).astype(np.float32)
    for a in (tas, pr):
        a[rng.random(a.shape) < 0.02] = np.nan
    return {"tas": (tas, "K"), "tas2": (tas2, "K"), "pr": (pr, "mm/d"),
            "pr2": (pr2, "mm/d")}


def _arrays(port: bool):
    dr, cls, make = ((date_range, ClimArray, torch.as_tensor) if port
                     else (jdate_range, JClimArray, jnp.asarray))
    t = dr("1990-01-01", periods=NY * 365, calendar="noleap")
    return {k: cls(make(v), ("time", "cell"), {"time": t}, {"units": u}, k)
            for k, (v, u) in _data().items()}


@pytest.fixture(scope="module")
def both():
    return _arrays(False), _arrays(True)


def _values(a):
    return a.values if isinstance(a, ClimArray) else np.asarray(a.data)


def _same(got, want, rtol=1e-6, atol=0.0, attrs=True):
    assert got.dims == want.dims
    if attrs:
        assert got.attrs == want.attrs
    g, w = _values(got), _values(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)


# -- properties --------------------------------------------------------------

#: name: (property, its arguments, input, rtol, atol). Means, variances
#: and quantiles of the same float32 values summed in another order: 1e-6;
#: moments of a deviation (var, skewness, acf, correlations) are held at
#: 1e-6 of their scale (the deviations cancel); day counts and doys exact.
PROPS = {
    "mean": ("mean", {}, "tas", 1e-6, 0.0),
    "mean_month": ("mean", {"group": "time.month"}, "tas", 1e-6, 0.0),
    "var_season": ("var", {"group": "time.season"}, "tas", 1e-5, 0.0),
    "std": ("std", {}, "tas", 1e-6, 0.0),
    "skewness": ("skewness", {"group": "time.month"}, "pr", 0.0, 1e-5),
    "quantile": ("quantile", {"q": 0.98}, "pr", 1e-6, 0.0),
    "quantile_month": ("quantile", {"q": 0.5, "group": "time.month"}, "tas",
                       1e-6, 0.0),
    "relative_frequency": ("relative_frequency", {"thresh": "1 mm/d"}, "pr",
                           1e-6, 0.0),
    "relative_frequency_month": ("relative_frequency",
                                 {"op": "<", "thresh": "0.5 mm/d",
                                  "group": "time.month"}, "pr", 1e-6, 0.0),
    "transition_probability": ("transition_probability",
                               {"initial_op": ">=", "final_op": "<"}, "pr",
                               1e-6, 0.0),
    "acf": ("acf", {"lag": 1}, "tas", 0.0, 1e-5),
    "acf_month": ("acf", {"lag": 2, "group": "time.month"}, "pr", 0.0, 1e-5),
    "annual_cycle_amplitude": ("annual_cycle_amplitude", {}, "tas", 1e-6,
                               0.0),
    "relative_annual_cycle_amplitude": ("relative_annual_cycle_amplitude", {},
                                        "tas", 1e-6, 0.0),
    "annual_cycle_phase": ("annual_cycle_phase", {}, "tas", 0.0, 0.0),
    # the slope's covariance of ~285 K yearly means with the years cancels:
    # 1e-6 x 285 K over the years' spread (3.5 yr) is ~8e-5 K/yr; held at
    # 1e-5 (measured 2.2e-6). The intercept, mean - slope x ~1995.5 yr,
    # carries that times the mean year
    "trend": ("trend", {}, "tas", 0.0, 1e-5),
    "trend_intercept": ("trend", {"output": "intercept"}, "tas", 0.0, 0.02),
    "spell_length_mean": ("spell_length_distribution", {}, "pr", 1e-6, 0.0),
    "spell_length_max": ("spell_length_distribution",
                         {"op": "<", "stat": "max", "window": 2}, "pr", 0.0,
                         0.0),
    "return_value": ("return_value", {"period": 10, "dist": "gumbel_r"},
                     "tas", 1e-6, 0.0),
}


@pytest.mark.parametrize("name", list(PROPS))
def test_properties(both, name):
    fn, kw, var, rtol, atol = PROPS[name]
    ja, ta = both
    _same(getattr(tsdba.properties, fn)(ta[var], **kw),
          getattr(jsdba.properties, fn)(ja[var], **kw), rtol, atol)


@pytest.mark.parametrize("corr_type, group", [("Spearman", "time"),
                                              ("Pearson", "time.season")])
def test_corr_btw_var(both, corr_type, group):
    ja, ta = both
    # ranks are exact integers; the correlation of ranks or values cancels
    # in its centred products: 1e-6 absolute on a value in [-1, 1]
    _same(tsdba.properties.corr_btw_var(ta["tas"], ta["tas2"], corr_type,
                                        group),
          jsdba.properties.corr_btw_var(ja["tas"], ja["tas2"], corr_type,
                                        group), 0.0, 1e-6)


# -- measures ----------------------------------------------------------------


@pytest.mark.parametrize("measure", ["bias", "relative_bias", "ratio",
                                     "rmse", "mae"])
def test_measures(both, measure):
    ja, ta = both
    # the difference of two ~285 K values: absolute, 1e-6 of the operands
    atol = 6e-4 if measure == "bias" else 0.0
    _same(getattr(tsdba.measures, measure)(ta["tas2"], ta["tas"]),
          getattr(jsdba.measures, measure)(ja["tas2"], ja["tas"]), 1e-6, atol)


def test_measures_of_properties(both):
    ja, ta = both
    _same(tsdba.measures.bias(tsdba.properties.mean(ta["tas2"]),
                              tsdba.properties.mean(ta["tas"])),
          jsdba.measures.bias(jsdba.properties.mean(ja["tas2"]),
                              jsdba.properties.mean(ja["tas"])), 0.0, 6e-4)
    got = tsdba.measures.circular_bias(
        tsdba.properties.annual_cycle_phase(ta["tas2"]),
        tsdba.properties.annual_cycle_phase(ta["tas"]))
    want = jsdba.measures.circular_bias(
        jsdba.properties.annual_cycle_phase(ja["tas2"]),
        jsdba.properties.annual_cycle_phase(ja["tas"]))
    _same(got, want, 0.0, 1e-4)


def test_annual_cycle_correlation(both):
    ja, ta = both
    _same(tsdba.measures.annual_cycle_correlation(ta["tas2"], ta["tas"]),
          jsdba.measures.annual_cycle_correlation(ja["tas2"], ja["tas"]),
          0.0, 1e-6)


# -- processing --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("group", ["time", "time.month"])
def test_normalize(both, kind, group):
    ja, ta = both
    (g, gn), (w, wn) = (tsdba.processing.normalize(ta["tas"], group=group,
                                                   kind=kind),
                        jsdba.processing.normalize(ja["tas"], group=group,
                                                   kind=kind))
    _same(gn, wn)
    # x - mean cancels: absolute, 1e-6 of ~285 K
    _same(g, w, *((0.0, 6e-4) if kind == "+" else (1e-6, 0.0)))


def test_standardize_roundtrip(both):
    ja, ta = both
    (g, gm, gs), (w, wm, ws) = (tsdba.processing.standardize(ta["tas"]),
                                jsdba.processing.standardize(ja["tas"]))
    _same(gm, wm, attrs=False)
    _same(gs, ws, 1e-5, attrs=False)
    # (x - mean) / std: the deviation cancels, ~1e-6 x 285 K / 10 K
    _same(g, w, 0.0, 5e-5)
    _same(tsdba.processing.unstandardize(g, gm, gs),
          jsdba.processing.unstandardize(w, wm, ws), 1e-6)


def test_reordering_is_exact(both):
    ja, ta = both
    _same(tsdba.processing.reordering(ta["tas"], ta["tas2"]),
          jsdba.processing.reordering(ja["tas"], ja["tas2"]), 0.0, 0.0)


@pytest.mark.parametrize("trans, lower, upper", [("log", "0 mm/d", None),
                                                 ("logit", "-1 mm/d",
                                                  "200 mm/d")])
def test_additive_space(both, trans, lower, upper):
    ja, ta = both
    g = tsdba.processing.to_additive_space(ta["pr"], lower, upper, trans)
    w = jsdba.processing.to_additive_space(ja["pr"], lower, upper, trans)
    _same(g, w, 1e-6, 1e-6)
    _same(tsdba.processing.from_additive_space(g),
          jsdba.processing.from_additive_space(w), 1e-6, 1e-6)


def test_stack_unstack_and_escore(both):
    ja, ta = both
    gs = tsdba.processing.stack_variables({"tas": ta["tas"],
                                           "tas2": ta["tas2"]})
    ws = jsdba.processing.stack_variables({"tas": ja["tas"],
                                           "tas2": ja["tas2"]})
    _same(gs, ws, 0.0, 0.0)
    back = tsdba.processing.unstack_variables(gs)
    assert list(back) == ["tas", "tas2"]
    assert back["tas2"].attrs == {"units": "K"}
    torch.testing.assert_close(back["tas"].data, ta["tas"].data, rtol=0,
                               atol=0, equal_nan=True)
    # escore of (multivar, time) samples: a host float. It is 2 E|x - y| -
    # E|x - x'| - E|y - y'| (times n m / (n + m) / 2), three mean distances
    # of ~10 K that cancel to ~3e-3 K: each within 1e-6 of the reference
    # (means of 2.5e5-6.4e5 distances summed in another order), so the
    # bound is 1e-6 x their sum, scaled
    tgt = gs.isel(cell=0)
    sim = gs.isel(cell=1).copy(data=torch.nan_to_num(gs.isel(cell=1).data))
    tgt = tgt.copy(data=torch.nan_to_num(tgt.data))
    jt = ws.isel(cell=0)
    jt = jt.copy(data=jnp.nan_to_num(jt.data))
    js_ = ws.isel(cell=1)
    js_ = js_.copy(data=jnp.nan_to_num(js_.data))
    for kw in ({"N": 800}, {"N": 500, "scale": True}):
        g = tsdba.processing.escore(tgt, sim, **kw)
        w = jsdba.processing.escore(jt, js_, **kw)
        assert isinstance(g, float)
        x = tgt.values[:, :kw["N"]].astype(np.float64)
        y = sim.values[:, :kw["N"]].astype(np.float64)
        if kw.get("scale"):
            xy = np.concatenate([x, y], axis=1)
            mu, sd = xy.mean(1, keepdims=True), xy.std(1, keepdims=True)
            x, y = (x - mu) / sd, (y - mu) / sd

        def md(a, b):
            return np.sqrt(((a[:, :, None] - b[:, None, :]) ** 2).sum(0)).mean()

        n = x.shape[1]
        total = (2 * md(x, y) + md(x, x) + md(y, y)) * n * n / (2 * n) / 2
        assert abs(g - w) <= 1e-6 * total


def _pr_series(dry, seed, port, n=3650):
    rng = np.random.default_rng(seed)
    v = np.where(rng.random(n) < dry, 0, rng.gamma(2, 4, n)).astype(np.float32)
    dr, cls, make = ((date_range, ClimArray, torch.as_tensor) if port
                     else (jdate_range, JClimArray, jnp.asarray))
    t = dr("2000-01-01", periods=n, freq="D", calendar="noleap")
    return cls(make(v), ("time",), {"time": t}, {"units": "mm/d"}, "pr"), v


def test_jitter_under_and_over_thresh():
    """The reference's property test (tests/test_sdba_diagnostics.py:179):
    values under the threshold become noise in (0, thresh), the rest are
    kept; over a threshold, noise in (thresh, upper); one generator state,
    one draw."""
    da, v = _pr_series(0.5, 0, True)
    out = tsdba.processing.jitter_under_thresh(
        da, "0.1 mm/d", generator=torch.Generator().manual_seed(1)).values
    assert (out > 0).all() and (out[v == 0] < 0.1).all()
    np.testing.assert_array_equal(out[v >= 0.1], v[v >= 0.1])
    again = tsdba.processing.jitter_under_thresh(
        da, "0.1 mm/d", generator=torch.Generator().manual_seed(1)).values
    np.testing.assert_array_equal(out, again)
    over = tsdba.processing.jitter_over_thresh(
        da, "20 mm/d", "25 mm/d", generator=torch.Generator().manual_seed(2))
    o = over.values
    assert ((o[v > 20] > 20) & (o[v > 20] < 25)).all()
    np.testing.assert_array_equal(o[v <= 20], v[v <= 20])
    with pytest.raises(ValueError):
        tsdba.processing.jitter(da, upper="20 mm/d")


@pytest.mark.parametrize("group", ["time", "time.month"])
def test_adapt_freq(group):
    """pth and dP0 (deterministic) against the reference; the dry fraction
    matched and the wet values kept (the reference's property test)."""
    ref, refv = _pr_series(0.4, 0, True)
    sim, simv = _pr_series(0.7, 1, True)
    jref, _ = _pr_series(0.4, 0, False)
    jsim, _ = _pr_series(0.7, 1, False)
    sa, pth, dP0 = tsdba.processing.adapt_freq(
        ref, sim, group=group, thresh="0.1 mm/d",
        generator=torch.Generator().manual_seed(3))
    _, jpth, jdP0 = jsdba.processing.adapt_freq(jref, jsim, group=group,
                                                thresh="0.1 mm/d")
    _same(pth, jpth)
    _same(dP0, jdP0)
    s = sa.values
    np.testing.assert_allclose((s < 0.1).mean(), (refv < 0.1).mean(),
                               atol=0.02)
    np.testing.assert_array_equal(s[simv >= 0.1], simv[simv >= 0.1])
    assert (s[simv < 0.1] >= 0).all()
