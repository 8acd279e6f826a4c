"""The winquantile op's plain twin against the JAX package's XLA formulation
``doy_window_quantiles_xla`` on the same numpy doy slices, and the op's
dispatch (CPU tensors go to the twin; the kernel itself is checked on the
card by test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.ops.pallas.winquantile import doy_window_quantiles_xla
from xclim_tpu_torch.ops import winquantile
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes

Q = equally_spaced_nodes(50).astype(np.float32)


def _slices(n_doy, Y, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan       # partly missing lanes
    x[:, :, 0] = np.nan                         # all-NaN lane
    x[:, 1:, 1] = np.nan                        # one valid sample per slice
    x[:, ::2, 2] = np.round(x[:, ::2, 2])       # ties
    if n_doy == 366:
        x[365, 1:, :] = np.nan                  # doy 366: leap years only
    return x


@pytest.mark.parametrize("n_doy,window", [(365, 31), (366, 31), (365, 5),
                                          (366, 5), (360, 1)])
def test_twin_matches_reference(n_doy, window):
    x = _slices(n_doy, 6, 5, seed=n_doy + window)
    got = winquantile.doy_window_quantiles_plain(torch.as_tensor(x), Q, window)
    exp = np.asarray(doy_window_quantiles_xla(jnp.asarray(x), Q, window))
    got = got.numpy()
    assert got.shape == exp.shape == (n_doy, len(Q), 5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # same sort and f32 op sequence; the reference's one-hot einsum rounds
    # the two weighted order statistics within a few ulp (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


def test_twin_chunks_over_cells(monkeypatch):
    x = torch.as_tensor(_slices(365, 4, 7, seed=3))
    whole = winquantile.doy_window_quantiles_plain(x, Q, 31)
    monkeypatch.setattr(winquantile, "_SLAB_BYTES", 365 * 31 * 4 * 4 * 2)
    chunked = winquantile.doy_window_quantiles_plain(x, Q, 31)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3)])
def test_node_constants_round_like_nan_quantile(alpha, beta):
    qv, coff = winquantile._node_constants(Q, alpha, beta)
    qt = torch.as_tensor(Q)
    np.testing.assert_array_equal(
        coff, (qt * (1 - alpha - beta) + alpha).numpy())
    assert qv.dtype == coff.dtype == np.float32


def test_cpu_tensor_takes_twin_and_counts():
    x = torch.as_tensor(_slices(365, 3, 4, seed=1))
    launches, twins = winquantile.launches, winquantile.twin_calls
    out = winquantile.doy_window_quantiles(x, Q, 5)
    assert winquantile.twin_calls == twins + 1
    assert winquantile.launches == launches
    torch.testing.assert_close(
        out, winquantile.doy_window_quantiles_plain(x, Q, 5), equal_nan=True)


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros(5, 3, 2, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(5, 6, dtype=torch.float32), ValueError),
    (lambda: torch.zeros(5, 3, 2, dtype=torch.float32, device="meta"),
     ValueError),
])
def test_rejects_what_neither_path_takes(bad, err):
    with pytest.raises(err):
        winquantile.doy_window_quantiles(bad(), Q, 5)


def test_even_window_rejected():
    with pytest.raises(ValueError, match="odd"):
        winquantile.doy_window_quantiles(torch.zeros(5, 3, 2), Q, 4)


@pytest.mark.parametrize("calendar,window", [("noleap", 31), ("standard", 5)])
def test_doy_gathers_and_windowed_mean(calendar, window):
    from xclim_tpu.core.calendar import date_range as jdate_range
    from xclim_tpu.sdba import utils as jutils
    from xclim_tpu.sdba.grouping import Grouper as JGrouper
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.sdba import utils as tutils
    from xclim_tpu_torch.sdba.grouping import Grouper

    t = date_range("1981-01-01", periods=4 * 365 + 1, calendar=calendar)
    tj = jdate_range("1981-01-01", periods=4 * 365 + 1, calendar=calendar)
    rng = np.random.default_rng(window)
    xf = rng.normal(285.0, 5.0, (len(t), 3, 2)).astype(np.float32)
    xf[rng.random(xf.shape) < 0.2] = np.nan
    table = Grouper("time.dayofyear", window).device_doy_table(t, "cpu")
    jtable = JGrouper("time.dayofyear", window).doy_table(tj)
    got = tutils.gather_doy_slices(torch.as_tensor(xf), table).numpy()
    exp = np.asarray(jutils.gather_doy_slices(jnp.asarray(xf), jtable))
    np.testing.assert_array_equal(got, exp)
    got = tutils.windowed_doy_mean(torch.as_tensor(xf), table, window).numpy()
    exp = np.asarray(jutils.windowed_doy_mean(jnp.asarray(xf), jtable, window))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # window sums of ~285 K values in another order (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)
