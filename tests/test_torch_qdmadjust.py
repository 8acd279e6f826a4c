"""The qdmadjust op's plain twin (grouped_rank + interp_hat_nodes) against
the JAX package's ``_qdm_adjust_core`` on the same numpy doy slices, with
ties and NaN lanes, and the port's rank/interpolation utilities against the
reference's. The kernel itself is checked on the card by
test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.sdba import utils as jutils
from xclim_tpu.sdba.adjustment import _qdm_adjust_core
from xclim_tpu_torch.ops import qdmadjust
from xclim_tpu_torch.sdba import utils as tutils

Q = tutils.equally_spaced_nodes(50).astype(np.float32)


def _case(G, Y, C, nanfrac, seed):
    rng = np.random.default_rng(seed)
    xd = rng.normal(289.0, 6.0, (G, Y, C)).astype(np.float32)
    xd[rng.random(xd.shape) < nanfrac] = np.nan
    xd[:, :, 0] = np.nan                    # all-NaN lane
    xd[:, 1:, 1] = np.nan                   # single valid sample
    xd[:, :, 2] = xd[:, :1, 2]              # one full tie run
    xd[:, ::3, 3] = np.round(xd[:, ::3, 3])  # partial ties
    af = np.sort(rng.normal(0.0, 2.0, (G, len(Q), C)).astype(np.float32),
                 axis=1)
    return xd, af


def _reference(xd, af, kind):
    """_qdm_adjust_core on a time axis that is the flattened slices."""
    G, Y, C = xd.shape
    table = np.arange(G * Y, dtype=np.int32).reshape(G, Y)
    out = _qdm_adjust_core(jnp.asarray(xd.reshape(G * Y, C)),
                           jnp.asarray(table), jnp.arange(G * Y),
                           jnp.asarray(af), jnp.asarray(Q), kind=kind,
                           interp="linear", extrapolation="constant")
    return np.asarray(out).reshape(G, Y, C)


def _close(got, exp):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # ranks are exact counts; the interpolation is the same f32 op sequence
    # (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("G,Y,C,nanfrac", [(7, 30, 9, 0.0), (5, 13, 8, 0.3),
                                           (3, 64, 6, 0.1), (366, 6, 5, 0.2)])
def test_twin_matches_reference(kind, G, Y, C, nanfrac):
    xd, af = _case(G, Y, C, nanfrac, seed=G * C + Y)
    got = qdmadjust.qdm_adjust_doy_plain(torch.as_tensor(xd),
                                         torch.as_tensor(af), Q, kind).numpy()
    _close(got, _reference(xd, af, kind))


def test_cpu_tensor_takes_twin_and_counts():
    xd, af = _case(4, 10, 5, 0.1, seed=5)
    launches, twins = qdmadjust.launches, qdmadjust.twin_calls
    out = qdmadjust.qdm_adjust_doy(torch.as_tensor(xd), torch.as_tensor(af),
                                   Q, "*")
    assert (qdmadjust.launches, qdmadjust.twin_calls) == (launches, twins + 1)
    _close(out.numpy(), _reference(xd, af, "*"))


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("calendar,years", [("noleap", 30), ("standard", 9),
                                            ("360_day", 9)])
def test_series_twin_matches_reference(calendar, years, kind):
    """The series entry's twin on a time axis, through the port's adjust
    table, against the reference's _qdm_adjust_core through its own."""
    from xclim_tpu.core.calendar import date_range as jdate_range
    from xclim_tpu.sdba.grouping import Grouper as JGrouper
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.sdba.grouping import Grouper

    n = years * 365
    t = date_range("1981-01-01", periods=n, calendar=calendar)
    tj = jdate_range("1981-01-01", periods=n, calendar=calendar)
    table, _, flat_pos = Grouper("time.dayofyear").adjust_table(t)
    jtable, _, jflat = JGrouper("time.dayofyear").adjust_table(tj)
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_array_equal(flat_pos, jflat)
    G = table.shape[0]
    assert G == {"noleap": 365, "standard": 366, "360_day": 360}[calendar]
    rng = np.random.default_rng(years)
    x = rng.normal(289.0, 6.0, (n, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan          # holes
    x[:, 0] = np.nan                               # all-NaN cell
    x[:, 1] = np.round(x[:, 1])                    # ties
    af = np.sort(rng.normal(0.0, 2.0, (G, len(Q), 6)), axis=1)
    af = (1.0 + 0.01 * af if kind == "*" else af).astype(np.float32)
    got = qdmadjust.qdm_adjust_series_plain(
        torch.as_tensor(x), torch.as_tensor(table.astype(np.int64)),
        torch.as_tensor(af), Q, kind).numpy()
    exp = np.asarray(_qdm_adjust_core(
        jnp.asarray(x), jnp.asarray(jtable), jnp.asarray(jflat),
        jnp.asarray(af), jnp.asarray(Q), kind=kind, interp="linear",
        extrapolation="constant"))
    _close(got, exp)


@pytest.mark.parametrize("q", [
    Q, np.asarray([0.0, 1.0]), np.asarray([0.5, 0.5]),
    np.asarray([0.0, 0.25, 0.25, 0.5, 0.5, 0.5, 1.0]),
    np.asarray([0.1] * 7 + [0.9] * 6),
    np.round(np.linspace(0.0, 1.0, 500) * 250) / 250])
@pytest.mark.parametrize("Y", [1, 7, 30, 64])
def test_bracket_table_equals_the_twins_interpolation(q, Y):
    """The kernel's (n_valid, rank) table of brackets and weights: the
    bracket is the linear count #(q <= tc) on tied and repeated nodes,
    and the weight is interp_hat_nodes' float32 value, bit for bit."""
    q = np.asarray(q, np.float32)
    table = qdmadjust.bracket_table(q, Y)
    assert table.shape == (Y + 1, Y + 1, 2) and table.dtype == np.int32
    nv = np.arange(Y + 1)[:, None].repeat(Y + 1, axis=1)
    cnt = np.arange(Y + 1)[None, :].repeat(Y + 1, axis=0)
    tau = (torch.as_tensor(cnt, dtype=torch.float32)
           / torch.as_tensor(np.maximum(nv, 1), dtype=torch.float32))
    qt = torch.as_tensor(q)
    tc = torch.minimum(torch.maximum(tau, qt[0]), qt[-1]).numpy()
    linear = (q[None, None, :] <= tc[..., None]).sum(axis=-1)
    np.testing.assert_array_equal(table[..., 0],
                                  np.clip(linear, 1, len(q) - 1))
    # interp_hat_nodes with one group per (n_valid, cnt), factor 1 at the
    # bracket's upper node and 0 elsewhere, gives 0 + w * 1 = w exactly
    G = (Y + 1) ** 2
    yq = torch.zeros((G, len(q), 1))
    yq[np.arange(G), table[..., 0].reshape(-1), 0] = 1.0
    w = tutils.interp_hat_nodes(tau.reshape(G, 1, 1), q, yq).numpy()
    np.testing.assert_array_equal(table[..., 1].view(np.float32),
                                  w.reshape(Y + 1, Y + 1))


@pytest.mark.parametrize("entry", ["doy", "series"])
def test_decreasing_nodes_are_refused(entry):
    xd, af = _case(4, 10, 5, 0.1, seed=3)
    q = Q.copy()
    q[[10, 11]] = q[[11, 10]]
    with pytest.raises(ValueError, match="non-decreasing"):
        if entry == "doy":
            qdmadjust.qdm_adjust_doy(torch.as_tensor(xd), torch.as_tensor(af),
                                     q)
        else:
            table = torch.arange(40).reshape(4, 10)
            qdmadjust.qdm_adjust_series(torch.as_tensor(xd.reshape(40, 5)),
                                        table, torch.as_tensor(af), q)


@pytest.mark.parametrize("kind", ["+", "*"])
def test_doy_entry_is_the_series_entry_over_slot_rows(kind):
    # the kernel's doy entry reads slot (g, y) at row g*Y + y of the
    # (G * Y, C) view, its series entry through a table: on the table of
    # those rows the series twin gives the doy twin's values
    xd, af = _case(6, 11, 7, 0.2, seed=11)
    rows = torch.arange(66, dtype=torch.int32).reshape(6, 11)
    got = qdmadjust.qdm_adjust_series_plain(
        torch.as_tensor(xd.reshape(66, 7)), rows, torch.as_tensor(af), Q,
        kind)
    want = qdmadjust.qdm_adjust_doy_plain(torch.as_tensor(xd),
                                          torch.as_tensor(af), Q, kind)
    torch.testing.assert_close(got.reshape(6, 11, 7), want, rtol=0, atol=0,
                               equal_nan=True)


def test_series_on_cpu_takes_twin_and_counts():
    xd, af = _case(4, 10, 5, 0.1, seed=7)
    # 4 groups of 10 steps, interleaved on the time axis
    table = torch.arange(40).reshape(10, 4).T.contiguous()
    xf = torch.as_tensor(xd.transpose(1, 0, 2).reshape(40, 5))
    launches, twins = qdmadjust.launches, qdmadjust.twin_calls
    out = qdmadjust.qdm_adjust_series(xf, table, torch.as_tensor(af), Q, "+")
    assert (qdmadjust.launches, qdmadjust.twin_calls) == (launches, twins + 1)
    want = _reference(xd, af, "+").transpose(1, 0, 2).reshape(40, 5)
    _close(out.numpy(), want)


@pytest.mark.parametrize("ms", [20, 200])
def test_grouped_rank_both_formulations(ms):
    rng = np.random.default_rng(ms)
    g = np.round(rng.normal(0, 3, (4, ms, 6))).astype(np.float32)  # ties
    g[rng.random(g.shape) < 0.2] = np.nan
    nv = (~np.isnan(g)).sum(axis=1)
    got = tutils.grouped_rank(torch.as_tensor(g), torch.as_tensor(nv)).numpy()
    exp = np.asarray(jutils.grouped_rank(jnp.asarray(g), jnp.asarray(nv)))
    ok = ~np.isnan(g)       # NaN slots carry an inert rank in both engines
    np.testing.assert_array_equal(got[ok], exp[ok])


def test_interp_on_quantiles():
    rng = np.random.default_rng(9)
    xq = np.sort(rng.normal(0, 2, (3, 12, 5)), axis=1).astype(np.float32)
    yq = rng.normal(0, 1, (3, 12, 5)).astype(np.float32)
    x = rng.normal(0, 3, (3, 20, 5)).astype(np.float32)
    x[0, :3] = np.nan
    for extrap in ("constant", "nan"):
        got = tutils.interp_on_quantiles(torch.as_tensor(x),
                                         torch.as_tensor(xq),
                                         torch.as_tensor(yq),
                                         extrapolation=extrap).numpy()
        exp = np.asarray(jutils.interp_on_quantiles(
            jnp.asarray(x), jnp.asarray(xq), jnp.asarray(yq),
            extrapolation=extrap))
        _close(got, exp)


@pytest.mark.parametrize("kwargs,err", [
    ({"kind": "-"}, ValueError),
    ({"q": Q[:1]}, ValueError),
    ({"af": torch.zeros(4, 3, 5)}, ValueError),
])
def test_rejects_bad_arguments(kwargs, err):
    xd, af = _case(4, 10, 5, 0.0, seed=1)
    args = {"xd": torch.as_tensor(xd), "af": torch.as_tensor(af), "q": Q,
            "kind": "+"} | kwargs
    with pytest.raises(err):
        qdmadjust.qdm_adjust_doy(**args)
