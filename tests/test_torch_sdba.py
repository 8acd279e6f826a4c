"""The port's QDM and EQM ``train().adjust()`` against the JAX package, end to
end, on the same numpy series: day-of-year window 31 with 50 quantiles (the
north-star config, cut to 6 years x 8 cells), a standard calendar, a
multiplicative QDM, a monthly grouping, and trained state carried from the
JAX package into the port with ``from_reference_state``.

The JAX side runs once, in the module fixture ``reference``."""

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
from xclim_tpu_torch.ops import qdmadjust, winquantile
from xclim_tpu_torch.sdba.adjustment import from_reference_state

NY, C = 6, 8
CASES = {
    # name: (method, calendar, group, window, kind)
    "qdm_doy": ("QuantileDeltaMapping", "noleap", "time.dayofyear", 31, "+"),
    "eqm_doy": ("EmpiricalQuantileMapping", "noleap", "time.dayofyear", 31, "+"),
    "qdm_doy_standard": ("QuantileDeltaMapping", "standard", "time.dayofyear",
                         31, "+"),
    "qdm_doy_mul": ("QuantileDeltaMapping", "noleap", "time.dayofyear", 31, "*"),
    "qdm_month": ("QuantileDeltaMapping", "noleap", "time.month", 1, "+"),
    "eqm_month": ("EmpiricalQuantileMapping", "noleap", "time.month", 1, "+"),
}


def _series(calendar):
    """ref (K), hist (degC), sim (K) with missing values; numpy float32."""
    rng = np.random.default_rng(2024)
    T = len(date_range("1981-01-01", periods=NY * 365, calendar=calendar))
    ref = rng.normal(285.0, 5.0, (T, C)).astype(np.float32)
    hist = rng.normal(287.0, 6.0, (T, C)).astype(np.float32)
    sim = rng.normal(289.0, 6.0, (T, C)).astype(np.float32)
    hist[rng.random(hist.shape) < 0.05] = np.nan
    sim[rng.random(sim.shape) < 0.05] = np.nan
    sim[:, -1] = np.nan                          # all-NaN cell
    hist_c = (hist - np.float32(273.15)).astype(np.float32)
    return {"ref": (ref, "K"), "hist": (hist_c, "degC"), "sim": (sim, "K")}


def _arrays(make, array_cls, series, time):
    return {k: array_cls(make(v), ("time", "cell"), {"time": time},
                         {"units": u}, k) for k, (v, u) in series.items()}


def _run(sdba, arrays, method, group, window, kind):
    adj = getattr(sdba, method).train(
        arrays["ref"], arrays["hist"], group=sdba.Grouper(group, window),
        nquantiles=50, kind=kind)
    return adj, adj.adjust(arrays["sim"])


@pytest.fixture(scope="module")
def reference():
    """The JAX package's trained state and adjusted output per case."""
    out = {}
    for name, (method, cal, group, window, kind) in CASES.items():
        series = _series(cal)
        t = jdate_range("1981-01-01", periods=NY * 365, calendar=cal)
        arrays = _arrays(jnp.asarray, JClimArray, series, t)
        adj, res = _run(jsdba, arrays, method, group, window, kind)
        out[name] = ({k: np.asarray(v) for k, v in adj.ds.items()},
                     np.asarray(res.data), dict(res.attrs))
    return out


def _port(name):
    method, cal, group, window, kind = CASES[name]
    t = date_range("1981-01-01", periods=NY * 365, calendar=cal)
    arrays = _arrays(torch.as_tensor, ClimArray, _series(cal), t)
    return _run(tsdba, arrays, method, group, window, kind), arrays


def _check_state(ds, ref_ds, kind):
    hq, ref_hq = ds["hist_q"].numpy(), ref_ds["hist_q"]
    np.testing.assert_array_equal(ds["quantiles"], ref_ds["quantiles"])
    np.testing.assert_array_equal(np.isnan(hq), np.isnan(ref_hq))
    # windowed quantiles: shared f32 op sequence, the reference's one-hot
    # einsum rounds within a few ulp (1e-6, SURVEY §6)
    np.testing.assert_allclose(hq, ref_hq, rtol=1e-6, equal_nan=True)
    af, ref_af = ds["af"].numpy(), ref_ds["af"]
    np.testing.assert_array_equal(np.isnan(af), np.isnan(ref_af))
    if kind == "+":
        # af = ref_q - hist_q: each K-scale quantile carries the 1e-6 of
        # SURVEY §6, so their difference carries 1e-6 * (|ref_q| + |hist_q|)
        # (~6e-4 K; the 1e-4 atol alone is below the reference's own
        # 2-3 ulp einsum rounding of two ~290 K values)
        bound = 1e-6 * (np.abs(ref_af + ref_hq) + np.abs(ref_hq))
        ok = ~np.isnan(ref_af)
        assert (np.abs(af - ref_af)[ok] <= bound[ok]).all()
    else:
        # af = ref_q / hist_q: the 1e-6 relative errors of the two
        # quantiles add up in the ratio
        np.testing.assert_allclose(af, ref_af, rtol=2e-6, equal_nan=True)


def _check_output(res, ref_out, ref_attrs, rtol=1e-6):
    got = res.values
    assert got.shape == ref_out.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref_out))
    np.testing.assert_allclose(got, ref_out, rtol=rtol, equal_nan=True)
    assert res.attrs == ref_attrs


@pytest.mark.parametrize("name", ["qdm_doy", "qdm_doy_standard", "qdm_doy_mul",
                                  "qdm_month"])
def test_qdm_train_adjust(reference, name):
    (adj, res), _ = _port(name)
    ref_ds, ref_out, ref_attrs = reference[name]
    _check_state(adj.ds, ref_ds, CASES[name][-1])
    # QDM ranks sim against itself (exact counts) and interpolates af at
    # the rank: the output carries af's error on a ~289 K value
    _check_output(res, ref_out, ref_attrs)


@pytest.mark.parametrize("name", ["eqm_doy", "eqm_month"])
def test_eqm_train_adjust(reference, name):
    (adj, res), _ = _port(name)
    ref_ds, ref_out, ref_attrs = reference[name]
    _check_state(adj.ds, ref_ds, "+")
    # EQM interpolates af over the hist_q nodes, so the few-ulp node
    # rounding of the reference (above) is multiplied by the local slope
    # d af / d hist_q: the bound is 5e-6 here, not 1e-6
    _check_output(res, ref_out, ref_attrs, rtol=5e-6)


@pytest.mark.parametrize("name", ["qdm_doy", "eqm_doy", "qdm_doy_mul",
                                  "qdm_month"])
def test_carry_over_reference_state(reference, name):
    method, cal, group, window, kind = CASES[name]
    ref_ds, ref_out, ref_attrs = reference[name]
    adj = from_reference_state(getattr(tsdba, method), ref_ds,
                               group=tsdba.Grouper(group, window), kind=kind,
                               train_units="K", device="cpu")
    t = date_range("1981-01-01", periods=NY * 365, calendar=cal)
    sim, units = _series(cal)["sim"]
    res = adj.adjust(ClimArray(torch.as_tensor(sim), ("time", "cell"),
                               {"time": t}, {"units": units}, "sim"))
    # the same trained state on both sides: only the adjust step differs
    # (exact ranks, one f32 interpolation sequence; 1e-6, SURVEY §6)
    _check_output(res, ref_out, ref_attrs)


def test_slice_serves_twins_on_cpu():
    counts = (winquantile.launches, winquantile.twin_calls,
              qdmadjust.launches, qdmadjust.twin_calls)
    (adj, res), _ = _port("qdm_doy")
    assert (winquantile.launches, winquantile.twin_calls,
            qdmadjust.launches, qdmadjust.twin_calls) == (
        counts[0], counts[1] + 2, counts[2], counts[3] + 1)
    assert adj.ds["af"].device.type == res.data.device.type == "cpu"


def test_qdm_adjust_reads_through_the_table(monkeypatch):
    """QDM's adjust hands the series and its group table to the qdmadjust
    op (one twin call on the CPU): no group gather of its own."""
    from xclim_tpu_torch.sdba import adjustment

    (adj, res), arrays = _port("qdm_doy")
    gathers = []
    monkeypatch.setattr(adjustment, "gather_groups",
                        lambda *a: gathers.append(a))
    counts = (qdmadjust.launches, qdmadjust.twin_calls)
    again = adj.adjust(arrays["sim"])
    assert (qdmadjust.launches, qdmadjust.twin_calls) == (counts[0],
                                                          counts[1] + 1)
    assert gathers == []
    torch.testing.assert_close(again.data, res.data, rtol=0, atol=0,
                               equal_nan=True)


def test_qdm_train_past_the_kernel_window():
    """w31 over 300 years (9300 samples a window, past what the kernel
    keeps in shared memory): the port trains as the reference does, on a
    few cells."""
    years, cells = 300, 3
    rng = np.random.default_rng(300)
    data = {k: (rng.normal(mu, 5.0, (years * 365, cells)).astype(np.float32),
                "K") for k, mu in (("ref", 285.0), ("hist", 287.0))}
    assert not winquantile.window_in_shared(31, years)
    out = []
    for sdba, make, cls, dr in ((jsdba, jnp.asarray, JClimArray, jdate_range),
                                (tsdba, torch.as_tensor, ClimArray,
                                 date_range)):
        t = dr("1701-01-01", periods=years * 365, calendar="noleap")
        arrays = _arrays(make, cls, data, t)
        adj = sdba.QuantileDeltaMapping.train(
            arrays["ref"], arrays["hist"], group=sdba.Grouper(
                "time.dayofyear", 31), nquantiles=50, kind="+")
        out.append(adj.ds)
    _check_state(out[1], {k: np.asarray(v) for k, v in out[0].items()}, "+")


def test_time_axis_and_space_shape():
    """Time need not lead and space may be n-d: the same numbers as the
    (time, cell) run, transposed."""
    (_, flat), arrays = _port("qdm_doy")
    method, cal, group, window, kind = CASES["qdm_doy"]

    def grid(da):   # (time, cell) -> (y, time, x) with cell = y * 2 + x
        data = da.data.reshape(da.shape[0], C // 2, 2).permute(1, 0, 2)
        return ClimArray(data, ("y", "time", "x"), dict(da.coords),
                         dict(da.attrs), da.name)

    _, res = _run(tsdba, {k: grid(v) for k, v in arrays.items()}, method,
                  group, window, kind)
    assert res.dims == ("y", "time", "x")
    torch.testing.assert_close(res.data, grid(flat).data, rtol=0, atol=0,
                               equal_nan=True)
