"""The port's DQM, Scaling, LOCI, ExtremeValues and ``npdf_transform``
against the JAX package on the same numpy series (a few years x 6 cells),
trained state carried across with ``from_reference_state`` for every class,
and ``.save()``/``.load()`` checkpoints read by the other package.

The JAX side runs once, in the module fixture ``reference``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xclim_tpu.sdba as jsdba
import xclim_tpu_torch.sdba as tsdba
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.sdba.adjustment import random_rotation_matrices as jrot
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.ops import winquantile
from xclim_tpu_torch.sdba.adjustment import from_reference_state

NY, C = 6, 6
NPDF_DAYS, NPDF_ITER = 730, 5

#: name: (method, calendar, group, window, kind, data, train kwargs)
CASES = {
    "dqm_doy": ("DetrendedQuantileMapping", "noleap", "time.dayofyear", 31,
                "+", "tas", {"nquantiles": 50}),
    "dqm_doy_mul": ("DetrendedQuantileMapping", "noleap", "time.dayofyear",
                    31, "*", "tas", {"nquantiles": 50}),
    "dqm_doy_standard": ("DetrendedQuantileMapping", "standard",
                         "time.dayofyear", 31, "+", "tas", {"nquantiles": 50}),
    "dqm_month": ("DetrendedQuantileMapping", "noleap", "time.month", 1, "+",
                  "tas", {"nquantiles": 50}),
    "scaling_month": ("Scaling", "noleap", "time.month", 1, "*", "pr", {}),
    "scaling_time": ("Scaling", "noleap", "time", 1, "+", "tas", {}),
    "loci_month": ("LOCI", "noleap", "time.month", 1, "*", "pr",
                   {"thresh": "1 mm/d"}),
    "extremes": ("ExtremeValues", "noleap", "time", 1, "+", "pr",
                 {"cluster_thresh": "1 mm/d", "q_thresh": 0.9}),
}
#: the scalars each class keeps besides its arrays
PARAMS = {"LOCI": ("thresh",), "ExtremeValues": ("cluster_thresh",)}


def _days(calendar):
    return len(date_range("1981-01-01", periods=NY * 365, calendar=calendar))


def _tas(calendar):
    """ref (K), hist (degC), sim (K, +0.03 K a year of trend) with missing
    values and an all-NaN sim cell; numpy float32."""
    rng = np.random.default_rng(2024)
    T = _days(calendar)
    ref = rng.normal(285.0, 5.0, (T, C)).astype(np.float32)
    hist = rng.normal(287.0, 6.0, (T, C)).astype(np.float32)
    sim = rng.normal(289.0, 6.0, (T, C)).astype(np.float32)
    sim += (0.03 * np.arange(T) / 365.0).astype(np.float32)[:, None]
    hist[rng.random(hist.shape) < 0.05] = np.nan
    sim[rng.random(sim.shape) < 0.05] = np.nan
    sim[:, -1] = np.nan
    hist_c = (hist - np.float32(273.15)).astype(np.float32)
    return {"ref": (ref, "K"), "hist": (hist_c, "degC"), "sim": (sim, "K"),
            "scen": (sim + np.float32(1.0), "K")}


def _pr(calendar):
    """Gamma-like daily precipitation (mm/d) with ~55 % dry days, a wetter
    sim, and missing values."""
    rng = np.random.default_rng(7)
    T = _days(calendar)
    out = {}
    for k, (dry, scale) in {"ref": (0.55, 4.0), "hist": (0.45, 3.0),
                            "sim": (0.45, 3.5)}.items():
        x = np.where(rng.random((T, C)) < dry, 0.0,
                     rng.gamma(0.8, scale, (T, C))).astype(np.float32)
        x[rng.random(x.shape) < 0.02] = np.nan
        out[k] = (x, "mm/d")
    out["scen"] = ((out["sim"][0] * np.float32(0.9)).astype(np.float32),
                   "mm/d")
    return out


def _series(name):
    _, cal, *_, data, _ = CASES[name]
    return (_tas if data == "tas" else _pr)(cal)


def _arrays(make, array_cls, series, time):
    return {k: array_cls(make(v), ("time", "cell"), {"time": time},
                         {"units": u}, k) for k, (v, u) in series.items()}


def _train(sdba, arrays, name):
    method, _, group, window, kind, _, kw = CASES[name]
    kw = dict(kw)
    if method not in ("LOCI", "ExtremeValues"):
        kw["kind"] = kind
    return getattr(sdba, method).train(
        arrays["ref"], arrays["hist"], group=sdba.Grouper(group, window), **kw)


def _adjust(adj, arrays):
    if type(adj).__name__ == "ExtremeValues":
        return adj.adjust(arrays["scen"], arrays["sim"], frac=0.4, power=1.5)
    return adj.adjust(arrays["sim"])


def _jax_arrays(name):
    cal = CASES[name][1]
    t = jdate_range("1981-01-01", periods=_days(cal), calendar=cal)
    return _arrays(jnp.asarray, JClimArray, _series(name), t)


def _port_arrays(name):
    cal = CASES[name][1]
    t = date_range("1981-01-01", periods=_days(cal), calendar=cal)
    return _arrays(torch.as_tensor, ClimArray, _series(name), t)


def _npdf_inputs():
    """(ref, hist, sim) as (multivar, time) float32: a correlated ref and
    independent hist/sim."""
    rng = np.random.default_rng(11)
    L = np.linalg.cholesky(np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.5],
                                     [0.3, 0.5, 1.0]]))
    ref = (L @ rng.normal(0, 1, (3, NPDF_DAYS))).astype(np.float32)
    hist = rng.normal(0.2, 1.1, (3, NPDF_DAYS)).astype(np.float32)
    sim = rng.normal(0.5, 1.2, (3, NPDF_DAYS)).astype(np.float32)
    return ref, hist, sim


def _multivar(make, cls, dr, m):
    t = dr("2000-01-01", periods=m.shape[1], calendar="noleap")
    return cls(make(m), ("multivar", "time"),
               {"time": t, "multivar": np.array(["a", "b", "c"])},
               {"units": ""}, "mv")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's trained state, adjusted output and attrs per case,
    and its npdf_transform with the rotations it drew."""
    out = {}
    for name in CASES:
        arrays = _jax_arrays(name)
        adj = _train(jsdba, arrays, name)
        res = _adjust(adj, arrays)
        out[name] = ({k: np.asarray(v) for k, v in adj.ds.items()},
                     np.asarray(res.data), dict(res.attrs),
                     {p: getattr(adj, p) for p in PARAMS.get(CASES[name][0],
                                                               ())})
    ins = [_multivar(jnp.asarray, JClimArray, jdate_range, m)
           for m in _npdf_inputs()]
    key = jax.random.PRNGKey(3)
    ha, sa = jsdba.npdf_transform(*ins, n_iter=NPDF_ITER, nquantiles=30,
                                  key=key)
    out["npdf"] = (np.asarray(jrot(key, NPDF_ITER, 3)), np.asarray(ha.data),
                   np.asarray(sa.data))
    return out


def _check_values(got, ref, rtol, atol=0.0):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, equal_nan=True)


def _check_dqm_state(ds, ref_ds, kind):
    np.testing.assert_array_equal(ds["quantiles"], ref_ds["quantiles"])
    # scaling = mean(ref) - mean(hist) (or their ratio): two ~290 K window
    # means, each within 1e-6 of the reference (f32 sums in another
    # order), so 2 x 1e-6 x 300 K absolute, or 2e-6 relative
    if kind == "+":
        _check_values(ds["scaling"].numpy(), ref_ds["scaling"], 0.0, 6e-4)
    else:
        _check_values(ds["scaling"].numpy(), ref_ds["scaling"], 2e-6)
    # hist_q: quantiles of the scaled hist, with the reference's 2-3 ulp
    # quantile gap (ROADMAP Queue 3) on ~290 K values
    _check_values(ds["hist_q"].numpy(), ref_ds["hist_q"], 1e-6)
    af, ref_af = ds["af"].numpy(), ref_ds["af"]
    if kind == "+":
        # af = ref_q - hist_q: the 1e-6 of each ~290 K quantile, absolute
        bound = 1e-6 * (np.abs(ref_af + ref_ds["hist_q"])
                        + np.abs(ref_ds["hist_q"]))
        ok = ~np.isnan(ref_af)
        np.testing.assert_array_equal(np.isnan(af), np.isnan(ref_af))
        assert (np.abs(af - ref_af)[ok] <= bound[ok]).all()
    else:
        _check_values(af, ref_af, 2e-6)


@pytest.mark.parametrize("name", ["dqm_doy", "dqm_doy_mul",
                                  "dqm_doy_standard", "dqm_month"])
def test_dqm_train_adjust(reference, name):
    arrays = _port_arrays(name)
    adj = _train(tsdba, arrays, name)
    res = _adjust(adj, arrays)
    ref_ds, ref_out, ref_attrs, _ = reference[name]
    _check_dqm_state(adj.ds, ref_ds, CASES[name][4])
    # DQM is EQM on the detrended series: EQM's 5e-6 (the reference's
    # quantile gap times the local slope d af / d hist_q,
    # tests/test_torch_sdba.py), plus the per-cell trend solve and
    # nanmean(trend) summed in another order. A detrended value 1 ulp off
    # can land on the other side of the two end nodes (q = 1e-4 and 0.01
    # of 186 samples, often < 0.01 K apart), where d af / d hist_q reaches
    # ~10: such a value moves by up to 1.1e-5 relative (1 of 13140 here)
    _check_values(res.values, ref_out, 2e-5)
    assert res.attrs == ref_attrs


def test_dqm_preserves_the_trend_and_sim_trend_is_planted():
    """The +0.03 K a year planted in sim comes back in scen (DQM retrends
    with sim's own trend)."""
    arrays = _port_arrays("dqm_doy")
    res = _adjust(_train(tsdba, arrays, "dqm_doy"), arrays)
    t = np.arange(res.shape[0]) / 365.0
    for cell in range(C - 1):
        ok = ~np.isnan(arrays["sim"].values[:, cell])
        slope_sim = np.polyfit(t[ok], arrays["sim"].values[ok, cell], 1)[0]
        slope_scen = np.polyfit(t[ok], res.values[ok, cell], 1)[0]
        assert abs(slope_scen - slope_sim) < 0.05


#: output bounds (rtol, atol) given the state above
_OUT_TOL = {
    "scaling_month": (1e-6, 0.0),
    # sim + af: af's absolute 6e-4 K bound carries over
    "scaling_time": (0.0, 6e-4),
    # max(af (sim - s_thresh) + thresh, 0) cancels near 0: an absolute
    # bound of 1e-6 mm/d (~8 ulp of the 1 mm/d threshold)
    "loci_month": (1e-6, 1e-6),
    # the GPD transfer of the 5e-5 parameters above, blended with scen
    "extremes": (5e-5, 0.0),
}


@pytest.mark.parametrize("name", ["scaling_month", "scaling_time",
                                  "loci_month", "extremes"])
def test_other_methods_train_adjust(reference, name):
    arrays = _port_arrays(name)
    adj = _train(tsdba, arrays, name)
    res = _adjust(adj, arrays)
    ref_ds, ref_out, ref_attrs, ref_params = reference[name]
    assert set(adj.ds) == set(ref_ds)
    for k, v in ref_ds.items():
        got = adj.ds[k].numpy()
        if k in ("n_ref", "n_hist"):
            np.testing.assert_array_equal(got, v)     # counts: exact
        elif k[:2] in ("k_", "s_"):
            # GPD k = l1 / l2 - 2 and sigma = l1 (1 + k): l2 = 2 b1 - b0
            # cancels, so the sums' order shows at ~2e-5 (the reference's
            # own float32 rounding of the same estimator)
            _check_values(got, v, 5e-5)
        elif name == "scaling_time":
            # mean(ref) - mean(hist) of ~290 K values, each mean within
            # 1e-6 of the reference: 2 x 1e-6 x 300 K absolute
            _check_values(got, v, 0.0, 6e-4)
        else:
            # means, ratios and order statistics of the same float32
            # values, summed in another order (the POT level within the
            # reference's 2-3 ulp quantile gap, ROADMAP Queue 3)
            _check_values(got, v, 1e-6)
    for p, v in ref_params.items():
        assert getattr(adj, p) == pytest.approx(v, rel=1e-12)
    _check_values(res.values, ref_out, *_OUT_TOL[name])
    assert res.attrs == ref_attrs


@pytest.mark.parametrize("name", list(CASES))
def test_carry_over_reference_state(reference, name):
    method = CASES[name][0]
    ref_ds, ref_out, ref_attrs, ref_params = reference[name]
    units = "K" if CASES[name][5] == "tas" else "mm/d"
    adj = from_reference_state(
        getattr(tsdba, method), ref_ds,
        group=tsdba.Grouper(CASES[name][2], CASES[name][3]),
        kind=CASES[name][4] if method not in ("LOCI", "ExtremeValues")
        else ("*" if method == "LOCI" else "+"),
        train_units=units, device="cpu", **ref_params)
    res = _adjust(adj, _port_arrays(name))
    # the same trained state on both sides: only the adjust step differs
    # (LOCI's output near 0 is held absolutely, as above)
    rtol = 5e-6 if method == "DetrendedQuantileMapping" else 1e-6
    _check_values(res.values, ref_out, rtol, 1e-6 if method == "LOCI" else 0)
    assert res.attrs == ref_attrs


@pytest.mark.parametrize("name", ["dqm_doy", "loci_month", "extremes"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(reference, tmp_path, name, writer):
    """A checkpoint written by one package loads in the other and adjusts
    as the writer's own object does."""
    path = tmp_path / "adj.npz"
    if writer == "port":
        arrays = _port_arrays(name)
        adj = _train(tsdba, arrays, name)
        adj.save(path)
        loaded = getattr(jsdba, CASES[name][0]).load(path)
        got = np.asarray(_adjust(loaded, _jax_arrays(name)).data)
        want = _adjust(adj, arrays).values
        assert loaded.train_units == adj.train_units
    else:
        arrays = _jax_arrays(name)
        adj = _train(jsdba, arrays, name)
        adj.save(path)
        loaded = getattr(tsdba, CASES[name][0]).load(path, device="cpu")
        got = _adjust(loaded, _port_arrays(name)).values
        want = np.asarray(_adjust(adj, arrays).data)
        # the nodes stay a host array, the rest become CPU tensors
        for k, v in loaded.ds.items():
            assert isinstance(v, np.ndarray if k == "quantiles"
                              else torch.Tensor), k
    assert type(loaded).__name__ == CASES[name][0]
    assert (loaded.group.group, loaded.group.window) == (
        CASES[name][2], CASES[name][3])
    for p in PARAMS.get(CASES[name][0], ()):
        assert getattr(loaded, p) == pytest.approx(getattr(adj, p))
    rtol = 5e-6 if CASES[name][0] == "DetrendedQuantileMapping" else 1e-6
    _check_values(got, want, rtol, 1e-6 if name == "loci_month" else 0)


def test_port_roundtrip_is_exact(tmp_path):
    arrays = _port_arrays("extremes")
    adj = _train(tsdba, arrays, "extremes")
    adj.save(tmp_path / "ev.npz")
    loaded = tsdba.ExtremeValues.load(tmp_path / "ev.npz", device="cpu")
    for k, v in adj.ds.items():
        torch.testing.assert_close(loaded.ds[k], v, rtol=0, atol=0,
                                   equal_nan=True)
    assert loaded.cluster_thresh == adj.cluster_thresh


def test_dqm_train_runs_winquantile_twice_on_the_twin():
    counts = (winquantile.launches, winquantile.twin_calls)
    arrays = _port_arrays("dqm_doy")
    _train(tsdba, arrays, "dqm_doy")
    assert (winquantile.launches, winquantile.twin_calls) == (
        counts[0], counts[1] + 2)


def test_npdf_transform_with_the_reference_rotations(reference):
    rots, ref_h, ref_s = reference["npdf"]
    ins = [_multivar(torch.as_tensor, ClimArray, date_range, m)
           for m in _npdf_inputs()]
    ha, sa = tsdba.npdf_transform(*ins, n_iter=NPDF_ITER, nquantiles=30,
                                  rotations=rots)
    # 5 rounds of rotate -> QDM over 730 ranks -> rotate back: each round
    # adds the rotation's f32 products summed in another order (~1 ulp of
    # a unit-scale value), carried by later rounds. Two rotated values
    # that close can swap ranks, which moves both by one rank's factor
    # step (~1e-3) and, through the later rotations, their other
    # coordinates: under 1 % of the values, each within 2e-3
    for got, want in ((ha.values, ref_h), (sa.values, ref_s)):
        assert got.shape == want.shape and not np.isnan(got).any()
        err = np.abs(got - want)
        assert np.mean(err > 2e-5) < 0.01 and err.max() < 2e-3


def test_random_rotations_are_orthogonal_and_seeded():
    gen = torch.Generator().manual_seed(5)
    rots = tsdba.adjustment.random_rotation_matrices(gen, 8, 4)
    eye = torch.eye(4).expand(8, 4, 4)
    torch.testing.assert_close(rots @ rots.transpose(1, 2), eye, atol=1e-5,
                               rtol=0)
    again = tsdba.adjustment.random_rotation_matrices(
        torch.Generator().manual_seed(5), 8, 4)
    assert torch.equal(rots, again)
