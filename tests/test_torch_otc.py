"""The port's OTC, dOTC and ``optimal_transport_plan`` against the JAX
package on the same samples (at most ``max_points`` steps, so neither side
subsamples and both are deterministic), and the reference's golden cases
(``tests/test_sdba_golden.py`` OTC/dOTC: closed-form optimal-transport
maps) on the port."""

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

N = 400


def _series(values, units="K", torch_side=True):
    dr, cls, make = ((date_range, ClimArray, torch.as_tensor) if torch_side
                     else (jdate_range, JClimArray, jnp.asarray))
    t = dr("2000-01-01", periods=values.shape[-1], freq="D",
           calendar="noleap")
    v = np.asarray(values, dtype=np.float32)
    if v.ndim == 1:
        return cls(make(v), ("time",), {"time": t}, {"units": units}, "x")
    return cls(make(v), ("multivar", "time"),
               {"time": t, "multivar": np.array(["a", "b", "c"][:len(v)])},
               {"units": units}, "mv")


def _samples(d):
    """ref, hist, sim: (d, N) correlated ref, shifted hist and sim (1-D
    series for d = 1)."""
    rng = np.random.default_rng(d)
    ref = rng.normal(5.0, 2.0, (d, N))
    ref[-1] += 0.5 * ref[0]
    hist = rng.normal(0.0, 1.0, (d, N))
    sim = hist * 1.2 + 3.0 + rng.normal(0, 0.1, (d, N))
    out = [np.abs(a) + 0.5 for a in (ref, hist, sim)]  # positive, for '*'
    return [a[0] if d == 1 else a for a in out]


def _both(method, d, **kw):
    ins = _samples(d)
    n_in = 2 if method == "OTC" else 3
    got = getattr(tsdba, method).adjust(*[_series(a) for a in ins[:n_in]],
                                        **kw)
    want = getattr(jsdba, method).adjust(
        *[_series(a, torch_side=False) for a in ins[:n_in]], **kw)
    return got, want


# Sinkhorn runs 200 log-domain steps in float32 on both sides: logsumexp
# and the cost matrix round differently (torch's max-shifted logsumexp vs
# XLA's; the matmul's sums in another order), and the plan's barycentres
# are P-weighted means of ref: the output (values of 0.5-15) is held at
# 2e-5 absolute, ~2e-6 of its scale (measured: 1e-5 at most).
@pytest.mark.parametrize("d", [1, 3])
def test_otc_against_reference(d):
    got, want = _both("OTC", d)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_allclose(got.values, np.asarray(want.data), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("kind", ["+", "*"])
def test_dotc_against_reference(d, kind):
    got, want = _both("dOTC", d, kind=kind)
    assert got.dims == want.dims and got.attrs == want.attrs
    np.testing.assert_allclose(got.values, np.asarray(want.data), rtol=0,
                               atol=2e-5)


def test_plan_marginals_and_median_scale():
    """The plan's marginals are uniform and its regularization scales the
    median cost with the two middle values averaged (an even count)."""
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (64, 2)).astype(np.float32)
    Y = rng.normal(1, 1, (50, 2)).astype(np.float32)
    P = tsdba.optimal_transport_plan(torch.as_tensor(X), torch.as_tensor(Y))
    Pj = np.asarray(jsdba.optimal_transport_plan(jnp.asarray(X),
                                                 jnp.asarray(Y)))
    np.testing.assert_allclose(P.sum(1).numpy(), 1 / 64, rtol=1e-4)
    np.testing.assert_allclose(P.sum(0).numpy(), 1 / 50, rtol=1e-4)
    np.testing.assert_allclose(P.numpy(), Pj, rtol=1e-3, atol=1e-9)


def test_subsample_draws_from_the_generator():
    rng = np.random.default_rng(4)
    ref, hist = rng.normal(3, 1, 600), rng.normal(0, 1, 600)
    runs = [tsdba.OTC.adjust(_series(ref), _series(hist), max_points=200,
                             generator=torch.Generator().manual_seed(s)).values
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert abs(runs[0].mean() - 3.0) < 0.2


# -- the reference's golden cases (tests/test_sdba_golden.py:40-107) --------


def test_golden_gaussian_affine_map():
    """1-D N(0,1)→N(5,2): the unique monotone OT map is T(x) = 5 + 2x."""
    rng = np.random.default_rng(0)
    hist = rng.normal(0, 1, 1500)
    ref = rng.normal(5, 2, 1500)
    o = tsdba.OTC.adjust(_series(ref), _series(hist), reg=0.01,
                         n_iter=300).values
    assert np.sqrt(((o - (5 + 2 * hist)) ** 2).mean()) < 0.3
    assert abs(o.mean() - 5) < 0.15 and abs(o.std() - 2) < 0.15
    # monotone: the order of hist is preserved
    assert (np.diff(o[np.argsort(hist)]) < -0.05).sum() == 0


def test_golden_two_point_discrete():
    """Equal-mass atoms {0,1} → {10,11}: T(0)=10, T(1)=11."""
    h = np.repeat([0.0, 1.0], 400)
    r = np.repeat([10.0, 11.0], 400)
    o = tsdba.OTC.adjust(_series(r), _series(h), reg=0.005,
                         n_iter=500).values
    np.testing.assert_allclose(o[:400].mean(), 10.0, atol=0.2)
    np.testing.assert_allclose(o[400:].mean(), 11.0, atol=0.2)


def test_golden_dotc_additive_evolution():
    """hist~N(0,1), sim=hist+3, ref~N(5,2) → scen ~ N(8,2)."""
    rng = np.random.default_rng(0)
    hist = rng.normal(0, 1, 1500)
    ref = rng.normal(5, 2, 1500)
    sim = hist + 3.0
    o = tsdba.dOTC.adjust(_series(ref), _series(hist), _series(sim),
                          reg=0.01, n_iter=300).values
    assert abs(o.mean() - 8.0) < 0.2 and abs(o.std() - 2.0) < 0.2

    def rank(a):
        return np.argsort(np.argsort(a))

    assert np.corrcoef(rank(o), rank(sim))[0, 1] > 0.99


def test_golden_dotc_multiplicative_evolution():
    """kind='*': sim = 2·hist doubles the evolved reference."""
    rng = np.random.default_rng(0)
    hist = rng.lognormal(0, 0.3, 1500)
    ref = rng.lognormal(1.0, 0.3, 1500)
    o = tsdba.dOTC.adjust(_series(ref, "mm/d"), _series(hist, "mm/d"),
                          _series(2.0 * hist, "mm/d"), reg=0.01, n_iter=300,
                          kind="*").values
    assert abs(o.mean() / ref.mean() - 2.0) < 0.1
