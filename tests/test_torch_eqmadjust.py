"""The eqmadjust op on the CPU: its argument checks, its twin route, and the
twin against the EQM adjust body it replaced (the group gather, the node
count and interpolation of ``interp_on_quantiles``, the kind and the
un-gather through ``flat_pos``), value for value. The kernel against the
twin is in ``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.ops import eqmadjust
from xclim_tpu_torch.sdba import Grouper, adjustment
from xclim_tpu_torch.sdba.utils import gather_groups, interp_on_quantiles


def _inputs(calendar, group, years, C, nq, kind, seed):
    """Series, adjust tables and (G, nq, C) nodes and factors: cell 0 all
    NaN, cell 1 an all-NaN node column, cell 2 tied nodes (3 K steps),
    cell 3 values beyond both end nodes, cell 4 +-inf values, cell 5 its
    top nodes NaN; the rest 10 % missing."""
    t = date_range("1981-01-01", periods=years * 365 + years // 4,
                   calendar=calendar)
    table, _, flat_pos = Grouper(group).adjust_table(t)
    rng = np.random.default_rng(seed)
    x = rng.normal(289.0, 6.0, (len(t), C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    hq = np.sort(rng.normal(289.0, 6.0, (table.shape[0], nq, C)), axis=1)
    af = rng.normal(0.0, 2.0, (table.shape[0], nq, C))
    if kind == "*":
        af = 1.0 + 0.01 * af
    x[:, 0] = np.nan
    hq[:, :, 1] = np.nan
    hq[:, :, 2] = np.round(hq[:, :, 2] / 3.0) * 3.0
    x[::2, 3] = 400.0
    x[1::2, 3] = 200.0
    x[::3, 4] = np.inf
    x[1::3, 4] = -np.inf
    hq[:, nq // 2:, 5] = np.nan
    as_t = torch.as_tensor
    return (as_t(x), as_t(table.astype(np.int64)), as_t(flat_pos),
            as_t(hq.astype(np.float32)), as_t(af.astype(np.float32)))


def _parent_body(xf, table, flat_pos, hist_q, af, kind, extrapolation):
    """The EQM adjust body before the op: gather, interpolate, un-gather."""
    g = gather_groups(xf, table)
    (g, hist_q, af), sshape = adjustment._spacify(g, hist_q, af)
    af_v = interp_on_quantiles(g, hist_q, af, extrapolation=extrapolation)
    adj = adjustment._apply_kind(g, af_v, kind)
    adj = adj.reshape(tuple(adj.shape[:2]) + sshape)
    flat = adj.reshape((-1,) + tuple(adj.shape[2:]))
    return flat[flat_pos]


def _value_equal(got, exp):
    assert got.shape == exp.shape and got.dtype == exp.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(exp))
    ok = ~torch.isnan(exp)
    assert torch.equal(got[ok], exp[ok])


@pytest.mark.parametrize("extrapolation", ["constant", "nan"])
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("calendar,group,nq", [
    ("noleap", "time.dayofyear", 52), ("standard", "time.dayofyear", 3),
    ("noleap", "time.month", 12), ("360_day", "time", 52)])
def test_twin_equals_the_parent_body(calendar, group, nq, kind,
                                     extrapolation):
    xf, table, flat_pos, hq, af = _inputs(calendar, group, 4, 9, nq, kind,
                                          seed=nq)
    exp = _parent_body(xf, table, flat_pos, hq, af, kind, extrapolation)
    before = eqmadjust.twin_calls
    got = eqmadjust.eqm_adjust_series(xf, table, hq, af, kind, extrapolation)
    assert eqmadjust.twin_calls == before + 1
    _value_equal(got, exp)
    _value_equal(eqmadjust.eqm_adjust_series_plain(xf, table, hq, af, kind,
                                                   extrapolation), exp)


@pytest.mark.parametrize("space", [(), (3, 4)])
def test_the_body_keeps_the_space_shape(space):
    """1-D series and several space dims reach the op as (T, C)."""
    C = int(np.prod(space))
    xf, table, flat_pos, hq, af = _inputs("noleap", "time.dayofyear", 2,
                                          max(C, 6), 20, "+", seed=3)
    xf, hq, af = xf[:, :C], hq[..., :C], af[..., :C]
    shape = (xf.shape[0],) + space
    g_shape = tuple(hq.shape[:2]) + space
    args = (xf.reshape(shape), table, flat_pos, hq.reshape(g_shape),
            af.reshape(g_shape))
    got = adjustment._eqm_adjust_body(*args, kind="+", interp="linear",
                                      extrapolation="constant")
    assert got.shape == shape
    _value_equal(got, _parent_body(*args, "+", "constant"))


def _small():
    xf, table, _, hq, af = _inputs("noleap", "time.dayofyear", 1, 6, 5, "+",
                                   seed=1)
    return xf, table, hq, af


@pytest.mark.parametrize("change,error,match", [
    (lambda a: dict(a, kind="-"), ValueError, "kind"),
    (lambda a: dict(a, xf2=a["xf2"][:, 0]), ValueError, r"\(T, C\)"),
    (lambda a: dict(a, table=a["table"].reshape(-1)), ValueError,
     r"\(T, C\)"),
    (lambda a: dict(a, table=a["table"].float()), TypeError, "integers"),
    (lambda a: dict(a, table=a["table"] >= 0), TypeError, "integers"),
    (lambda a: dict(a, hist_q=a["hist_q"][1:]), ValueError, "hist_q shape"),
    (lambda a: dict(a, af=a["af"][..., 1:]), ValueError, "af shape"),
    (lambda a: dict(a, af=a["af"][:, 1:]), ValueError, "differ"),
    (lambda a: dict(a, hist_q=a["hist_q"][:, :1], af=a["af"][:, :1]),
     ValueError, "two quantile nodes"),
    (lambda a: dict(a, af=a["af"].to("meta")), ValueError, "meta"),
    (lambda a: dict(a, xf2=a["xf2"].to(torch.int32)), TypeError,
     "floating point"),
    (lambda a: dict(a, hist_q=a["hist_q"].to(torch.int32)), TypeError,
     "floating point"),
])
def test_the_entry_refuses_what_it_does_not_take(change, error, match):
    xf, table, hq, af = _small()
    args = change({"xf2": xf, "table": table, "hist_q": hq, "af": af})
    before = eqmadjust.twin_calls
    with pytest.raises(error, match=match):
        eqmadjust.eqm_adjust_series(**args)
    assert eqmadjust.twin_calls == before


def test_a_device_without_the_kernel_raises():
    args = [a.to("meta") for a in _small()]
    counts = (eqmadjust.launches, eqmadjust.twin_calls)
    with pytest.raises(ValueError, match="no eqmadjust kernel"):
        eqmadjust.eqm_adjust_series(*args)
    assert (eqmadjust.launches, eqmadjust.twin_calls) == counts


def test_the_twin_takes_float64_on_the_cpu():
    xf, table, hq, af = (a.double() if a.is_floating_point() else a
                         for a in _small())
    got = eqmadjust.eqm_adjust_series(xf, table, hq, af)
    assert got.dtype == torch.float64
    _value_equal(got, eqmadjust.eqm_adjust_series_plain(xf, table, hq, af))


def test_the_tables_route_follows_the_nodes():
    assert eqmadjust.tables_in_shared(52)
    assert eqmadjust.tables_in_shared(454)
    assert not eqmadjust.tables_in_shared(455)
