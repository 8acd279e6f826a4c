"""Statistical properties of climate series for adjustment diagnostics
(reference: the external xsdba package's ``properties`` module, re-exported
through xclim.sdba — xclim:src/xclim/sdba.py).

Each property reduces the time dimension (optionally per group) so that the
same property computed on ref, hist and scen can be compared with a measure
from :mod:`xclim_tpu_torch.sdba.measures`. Every one is the static-table
group gather + masked reduction pattern of the adjustment training step, on
the data's device.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, str2pint
from xclim_tpu_torch.ops.quantile import _nanstd, _nanvar
from xclim_tpu_torch.sdba.grouping import Grouper
from xclim_tpu_torch.sdba.utils import gather_groups

__all__ = [
    "acf",
    "annual_cycle_amplitude",
    "annual_cycle_phase",
    "corr_btw_var",
    "mean",
    "quantile",
    "relative_annual_cycle_amplitude",
    "relative_frequency",
    "return_value",
    "skewness",
    "spell_length_distribution",
    "std",
    "transition_probability",
    "trend",
    "var",
]

_SEASONS = np.array(["DJF", "MAM", "JJA", "SON"])


def _gather(da: ClimArray, grouper: Grouper) -> torch.Tensor:
    """(G, m, ...) group-gathered data, NaN where padded/missing."""
    xf = da.data.movedim(da.time_axis, 0)
    return gather_groups(xf, grouper.device_train_table(da.time, xf.device))


def _space(da: ClimArray):
    space_dims = tuple(d for d in da.dims if d != "time")
    return space_dims, {k: v for k, v in da.coords.items() if k in space_dims}


def _wrap(da: ClimArray, data, grouper: Grouper, units: str, name: str):
    """Wrap per-group output (G, ...) into a ClimArray; squeeze group='time'."""
    space_dims, coords = _space(da)
    if grouper.group == "time":
        return ClimArray(data[0], space_dims, coords, {"units": units}, name)
    prop = grouper.prop
    if grouper.group == "time.month":
        coords[prop] = np.arange(1, 13)
    elif grouper.group == "time.season":
        coords[prop] = _SEASONS
    else:
        coords[prop] = np.arange(1, data.shape[0] + 1)
    return ClimArray(data, (prop,) + space_dims, coords, {"units": units},
                     name)


def _grouper(group) -> Grouper:
    return group if isinstance(group, Grouper) else Grouper(group)


def _th(thresh, da: ClimArray) -> float:
    return convert_units_to(str2pint(thresh), da) if isinstance(thresh, str) \
        else float(thresh)


def _corr(x, y, dim):
    """NaN-masked Pearson correlation of x and y along dim."""
    ok = ~torch.isnan(x) & ~torch.isnan(y)
    x = torch.where(ok, x, torch.nan)
    y = torch.where(ok, y, torch.nan)
    mx = torch.nanmean(x, dim=dim, keepdim=True)
    my = torch.nanmean(y, dim=dim, keepdim=True)
    num = torch.nanmean((x - mx) * (y - my), dim=dim)
    den = _nanstd(x, dim) * _nanstd(y, dim)
    return num / torch.where(den == 0, torch.nan, den)


def mean(da: ClimArray, group="time") -> ClimArray:
    """Temporal mean (xsdba properties.mean)."""
    gr = _grouper(group)
    return _wrap(da, torch.nanmean(_gather(da, gr), dim=1), gr,
                 da.attrs.get("units", ""), "mean")


def var(da: ClimArray, group="time") -> ClimArray:
    """Temporal variance (xsdba properties.var)."""
    gr = _grouper(group)
    u = da.attrs.get("units", "")
    u2 = f"({u})2" if u else ""
    return _wrap(da, _nanvar(_gather(da, gr), 1), gr, u2, "var")


def std(da: ClimArray, group="time") -> ClimArray:
    """Temporal standard deviation (xsdba properties.std)."""
    gr = _grouper(group)
    return _wrap(da, _nanstd(_gather(da, gr), 1), gr,
                 da.attrs.get("units", ""), "std")


def skewness(da: ClimArray, group="time") -> ClimArray:
    """Temporal skewness E[(x−μ)³]/σ³ (xsdba properties.skewness)."""
    gr = _grouper(group)
    g = _gather(da, gr)
    mu = torch.nanmean(g, dim=1, keepdim=True)
    sd = _nanstd(g, 1).unsqueeze(1)
    z = (g - mu) / torch.where(sd == 0, torch.nan, sd)
    return _wrap(da, torch.nanmean(z ** 3, dim=1), gr, "", "skewness")


def quantile(da: ClimArray, q: float = 0.98, group="time") -> ClimArray:
    """Temporal quantile (xsdba properties.quantile)."""
    from xclim_tpu_torch.ops.quantile import nan_quantile

    gr = _grouper(group)
    out = nan_quantile(_gather(da, gr).movedim(1, 0), [float(q)], axis=0)[0]
    return _wrap(da, out, gr, da.attrs.get("units", ""), "quantile")


def relative_frequency(da: ClimArray, op: str = ">=", thresh="1 mm d-1",
                       group="time") -> ClimArray:
    """Fraction of steps satisfying ``da op thresh``
    (xsdba properties.relative_frequency)."""
    from xclim_tpu_torch.indices.generic import compare

    gr = _grouper(group)
    cond = compare(da, op, _th(thresh, da))
    g = _gather(cond.copy(data=cond.data.to(torch.float32)), gr)
    return _wrap(da, torch.nanmean(g, dim=1), gr, "", "relative_frequency")


def transition_probability(da: ClimArray, initial_op: str = ">=",
                           final_op: str = ">=", thresh="1 mm d-1") -> ClimArray:
    """P(day t+1 satisfies final_op | day t satisfies initial_op)
    (xsdba properties.transition_probability)."""
    from xclim_tpu_torch.indices.generic import compare

    th = _th(thresh, da)
    ax = da.time_axis
    af = compare(da, initial_op, th).data.to(torch.float32).movedim(ax, 0)
    bf = compare(da, final_op, th).data.to(torch.float32).movedim(ax, 0)
    valid = ~torch.isnan(da.data.movedim(ax, 0))
    vv = (valid[:-1] & valid[1:]).to(torch.float32)
    num = torch.sum(af[:-1] * bf[1:] * vv, dim=0)
    den = torch.sum(af[:-1] * vv, dim=0)
    space_dims, coords = _space(da)
    return ClimArray(num / torch.where(den == 0, torch.nan, den), space_dims,
                     coords, {"units": ""}, "transition_probability")


def acf(da: ClimArray, lag: int = 1, group="time.season") -> ClimArray:
    """Lag-k autocorrelation per group (xsdba properties.acf).

    Computed over the group-gathered member axis: corr(x_t, x_{t+lag}) with
    both members inside the group, NaN-masked."""
    gr = _grouper(group)
    g = _gather(da, gr)  # (G, m, ...)
    return _wrap(da, _corr(g[:, :-lag], g[:, lag:], 1), gr, "", "acf")


def _yearly_stat(da: ClimArray, op: str):
    return getattr(da.resample("YS"), op)()


def annual_cycle_amplitude(da: ClimArray,
                           amplitude_type: str = "absolute") -> ClimArray:
    """Mean over years of (yearly max − yearly min)
    (xsdba properties.annual_cycle_amplitude)."""
    amp = _yearly_stat(da, "max") - _yearly_stat(da, "min")
    if amplitude_type == "relative":
        amp = amp / _yearly_stat(da, "mean") * 100.0
    out = amp.mean(dim="time")
    out.attrs["units"] = "%" if amplitude_type == "relative" \
        else da.attrs.get("units", "")
    out.name = "annual_cycle_amplitude"
    return out


def relative_annual_cycle_amplitude(da: ClimArray) -> ClimArray:
    """Relative amplitude of the annual cycle in percent."""
    return annual_cycle_amplitude(da, amplitude_type="relative")


def annual_cycle_phase(da: ClimArray) -> ClimArray:
    """Mean day-of-year of the yearly maximum
    (xsdba properties.annual_cycle_phase)."""
    from xclim_tpu_torch.indices.generic import doymax

    phase = doymax(da, freq="YS").mean(dim="time")
    phase.attrs["units"] = ""
    phase.name = "annual_cycle_phase"
    return phase


def trend(da: ClimArray, output: str = "slope") -> ClimArray:
    """Linear trend of the annual means, per year (xsdba properties.trend)."""
    ym = _yearly_stat(da, "mean")
    x = ym.data.movedim(ym.time_axis, 0)
    tt = torch.as_tensor(ym.time.year.astype(np.float32),
                         device=x.device).reshape((-1,) + (1,) * (x.ndim - 1))
    valid = ~torch.isnan(x)
    n = valid.sum(dim=0)
    tm = torch.sum(torch.where(valid, tt, 0.0), dim=0) / n
    xm = torch.nansum(torch.where(valid, x, 0.0), dim=0) / n
    cov = torch.nansum(torch.where(valid, (tt - tm) * (x - xm), 0.0), dim=0)
    vt = torch.nansum(torch.where(valid, (tt - tm) ** 2, 0.0), dim=0)
    slope = cov / torch.where(vt == 0, torch.nan, vt)
    out = xm - slope * tm if output == "intercept" else slope
    space_dims, coords = _space(da)
    u = da.attrs.get("units", "")
    return ClimArray(out, space_dims, coords,
                     {"units": f"{u} yr-1" if output == "slope" else u},
                     "trend")


def spell_length_distribution(da: ClimArray, op: str = ">=",
                              thresh="1 mm d-1", stat: str = "mean",
                              window: int = 1) -> ClimArray:
    """Statistic of the distribution of spell lengths satisfying
    ``da op thresh`` for at least `window` steps
    (xsdba properties.spell_length_distribution)."""
    from xclim_tpu_torch.indices.generic import compare
    from xclim_tpu_torch.ops import runlength as rl

    cond = compare(da, op, _th(thresh, da))
    stats = rl.rle_statistics(cond.data, reducer=stat, window=window,
                              axis=da.time_axis, spec=None)
    space_dims, coords = _space(da)
    return ClimArray(stats, space_dims, coords, {"units": "d"},
                     "spell_length_distribution")


def corr_btw_var(da1: ClimArray, da2: ClimArray, corr_type: str = "Spearman",
                 group="time") -> ClimArray:
    """Correlation between two variables (xsdba properties.corr_btw_var)."""
    gr = _grouper(group)
    g1 = _gather(da1, gr)
    g2 = _gather(da2, gr)
    if corr_type.lower() == "spearman":
        # rank-transform the member axis (NaNs keep NaN); stable sorts, as
        # jnp.argsort
        def _rank(g):
            order = torch.argsort(torch.where(torch.isnan(g), torch.inf, g),
                                  dim=1, stable=True)
            ranks = torch.argsort(order, dim=1, stable=True).to(torch.float32)
            return torch.where(torch.isnan(g), torch.nan, ranks)

        g1 = _rank(g1)
        g2 = _rank(g2)
    return _wrap(da1, _corr(g1, g2, 1), gr, "", "corr_btw_var")


def return_value(da: ClimArray, period: int = 20, op: str = "max",
                 dist: str = "genextreme") -> ClimArray:
    """T-year return value of the block extreme (xsdba properties.return_value)."""
    from xclim_tpu_torch.indices.stats import frequency_analysis

    out = frequency_analysis(da, mode=op, t=period, dist=dist, freq="YS")
    out.name = "return_value"
    # drop the return-period axis (single period requested)
    if "return_period" in out.dims:
        out = out.isel(return_period=0)
    return out
