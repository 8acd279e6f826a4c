"""Measures comparing a property computed on a simulation against the same
property on a reference (reference: the external xsdba package's
``measures`` module, re-exported through xclim.sdba — xclim:src/xclim/sdba.py).

All measures are elementwise over matching-shaped property arrays (the
output of :mod:`xclim_tpu_torch.sdba.properties` on sim and ref)."""

from __future__ import annotations

import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to

__all__ = [
    "annual_cycle_correlation",
    "bias",
    "circular_bias",
    "mae",
    "ratio",
    "relative_bias",
    "rmse",
]


def _pair(sim: ClimArray, ref: ClimArray):
    if sim.attrs.get("units") and ref.attrs.get("units"):
        sim = convert_units_to(sim, ref)
    return sim, ref


def _named(out: ClimArray, units: str, name: str) -> ClimArray:
    out.attrs["units"] = units
    out.name = name
    return out


def bias(sim: ClimArray, ref: ClimArray) -> ClimArray:
    """sim − ref (xsdba measures.bias)."""
    sim, ref = _pair(sim, ref)
    return _named(sim - ref, ref.attrs.get("units", ""), "bias")


def relative_bias(sim: ClimArray, ref: ClimArray) -> ClimArray:
    """(sim − ref) / ref (xsdba measures.relative_bias)."""
    sim, ref = _pair(sim, ref)
    return _named((sim - ref) / ref, "", "relative_bias")


def ratio(sim: ClimArray, ref: ClimArray) -> ClimArray:
    """sim / ref (xsdba measures.ratio)."""
    sim, ref = _pair(sim, ref)
    return _named(sim / ref, "", "ratio")


def circular_bias(sim: ClimArray, ref: ClimArray,
                  period: float = 365.25) -> ClimArray:
    """Bias on a circular variable (day of year): the signed shortest
    distance around the cycle (xsdba measures.circular_bias)."""
    d = torch.remainder(sim.data - ref.data, period)
    return _named(sim.copy(data=torch.where(d > period / 2, d - period, d)),
                  "d", "circular_bias")


def rmse(sim: ClimArray, ref: ClimArray, dim: str = "time") -> ClimArray:
    """Root-mean-square error along `dim` (xsdba measures.rmse)."""
    sim, ref = _pair(sim, ref)
    out = ((sim - ref) * (sim - ref)).mean(dim=dim)
    return _named(out.copy(data=torch.sqrt(out.data)),
                  ref.attrs.get("units", ""), "rmse")


def mae(sim: ClimArray, ref: ClimArray, dim: str = "time") -> ClimArray:
    """Mean absolute error along `dim` (xsdba measures.mae)."""
    sim, ref = _pair(sim, ref)
    d = sim - ref
    return _named(d.copy(data=torch.abs(d.data)).mean(dim=dim),
                  ref.attrs.get("units", ""), "mae")


def annual_cycle_correlation(sim: ClimArray, ref: ClimArray,
                             window: int = 15) -> ClimArray:
    """Correlation between the smoothed mean annual cycles of sim and ref
    (xsdba measures.annual_cycle_correlation), the smoothing by
    :func:`~xclim_tpu_torch.ops.segments.rolling_reduce`."""
    from xclim_tpu_torch.ops.segments import rolling_reduce
    from xclim_tpu_torch.sdba.grouping import Grouper
    from xclim_tpu_torch.sdba.properties import _corr, _gather, _space

    sim, ref = _pair(sim, ref)

    def cycle(da):
        cyc = torch.nanmean(_gather(da, Grouper("time.dayofyear")), dim=1)
        return rolling_reduce(cyc, window, "mean", axis=0, center=True)

    space_dims, coords = _space(sim)
    return ClimArray(_corr(cycle(sim), cycle(ref), 0), space_dims, coords,
                     {"units": ""}, "annual_cycle_correlation")
