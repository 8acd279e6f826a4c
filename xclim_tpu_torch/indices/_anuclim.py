"""ANUCLIM bioclimatic indices P3-P19 (reference: xclim:src/xclim/indices/_anuclim.py).

Quarters are rolling 13-week (or 3-month) sums or means of a weekly series
(``rolling_reduce``); the wettest/warmest quarter's other variable is taken
at the index ``segment_argminmax`` gives, whose ties go to the first
occurrence and whose all-NaN periods give NaN, as ``jnp.argmax`` after the
reference's NaN fill. Period sums and means take the segment engine.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, declare_units, rate2amount, str2pint
from xclim_tpu_torch.indices._multivariate import (
    daily_temperature_range,
    extreme_temperature_range,
    precip_accumulation,
)
from xclim_tpu_torch.indices._simple import tg_mean
from xclim_tpu_torch.indices.generic import select_resample_op
from xclim_tpu_torch.ops.segments import rolling_reduce, segment_argminmax

__all__ = [
    "isothermality",
    "precip_seasonality",
    "prcptot",
    "prcptot_warmcold_quarter",
    "prcptot_wetdry_period",
    "prcptot_wetdry_quarter",
    "temperature_seasonality",
    "tg_mean_warmcold_quarter",
    "tg_mean_wetdry_quarter",
]


@declare_units(tasmin="[temperature]", tasmax="[temperature]")
def isothermality(tasmin: ClimArray, tasmax: ClimArray, freq: str = "YS") -> ClimArray:
    """P3: mean diurnal range / annual range ×100 (xclim:_anuclim.py:66)."""
    dtr = daily_temperature_range(tasmin=tasmin, tasmax=tasmax, freq=freq)
    etr = extreme_temperature_range(tasmin=tasmin, tasmax=tasmax, freq=freq)
    iso = dtr / etr * 100
    iso.attrs["units"] = "%"
    return iso


def _coeff_var(arr: ClimArray, freq: str) -> ClimArray:
    std = arr.resample(freq).std()
    mu = arr.resample(freq).mean()
    return std / mu


@declare_units(tas="[temperature]")
def temperature_seasonality(tas: ClimArray, freq: str = "YS") -> ClimArray:
    """P4: temperature coefficient of variation ×100 (xclim:_anuclim.py:105)."""
    t = convert_units_to(tas, "K")
    seas = _coeff_var(t, freq) * 100
    seas.attrs["units"] = "%"
    return seas


@declare_units(pr="[precipitation]")
def precip_seasonality(pr: ClimArray, freq: str = "YS") -> ClimArray:
    """P15: precipitation coefficient of variation ×100 (xclim:_anuclim.py:150)."""
    from xclim_tpu_torch.core.units import units2pint

    if units2pint(pr).dims == units2pint("mm/s").dims:
        pr = convert_units_to(pr, "mm d-1", context="hydro")
    seas = _coeff_var(pr, freq) * 100
    seas.attrs["units"] = "%"
    return seas


def _to_quarter(pr: ClimArray | None = None, tas: ClimArray | None = None) -> ClimArray:
    """Rolling quarter series at weekly/monthly resolution (xclim:_anuclim.py:562)."""
    if (pr is None) == (tas is None):
        raise ValueError("Supply exactly one variable, 'tas' or 'pr'.")
    ts_var = tas if tas is not None else pr
    freq = ts_var.time.infer_freq()
    if freq is None:
        raise ValueError("Can't infer sampling frequency of the input data.")
    if freq.upper().startswith("D"):
        if tas is not None:
            ts_var = tg_mean(ts_var, freq="7D")
        else:
            ts_var = precip_accumulation(ts_var, freq="7D")
            ts_var = convert_units_to(ts_var, "mm", context="hydro")
            ts_var.attrs["units"] = "mm/week"
        freq = "W"
    if freq.upper().startswith("W") or freq == "7D":
        window = 13
    elif freq.upper().startswith("M"):
        window = 3
    else:
        raise NotImplementedError(f"Unknown input time frequency {freq!r}")
    if tas is not None:
        out = ts_var.copy(data=rolling_reduce(ts_var.data, window, "mean",
                                              axis=ts_var.time_axis))
        out.attrs = dict(ts_var.attrs)
    else:
        pram = rate2amount(ts_var) if "week" not in ts_var.attrs.get("units", "") \
            else ts_var
        out = pram.copy(data=rolling_reduce(pram.data, window, "sum",
                                            axis=pram.time_axis))
        out.attrs = dict(pram.attrs)
    return out


_NP_OPS = {"wettest": "max", "warmest": "max", "driest": "min", "dryest": "min",
           "coldest": "min"}


def _quarter_op(op: str) -> str:
    """Validate a quarter-selection op (xclim:_anuclim.py:577 raises
    NotImplementedError on unknown ops)."""
    if op not in _NP_OPS:
        raise NotImplementedError(
            f"Unknown operation '{op}'; expected one of {sorted(_NP_OPS)}.")
    return _NP_OPS[op]


def _from_other_arg(criteria: ClimArray, output: ClimArray, op: str,
                    freq: str) -> ClimArray:
    """Per period: value of `output` at the time of `criteria`'s extreme
    (xclim:_anuclim.py:528)."""
    spec = criteria.segments(freq)
    ax = criteria.time_axis
    idx, has = segment_argminmax(criteria.data, spec, op, axis=ax)
    outf = torch.movedim(output.data, ax, 0)  # (T, ...)
    safe = torch.movedim(torch.where(idx >= 0, idx, 0), ax, 0)  # (nseg, ...)
    g = torch.take_along_dim(outf, safe.to(torch.int64), dim=0)
    g = torch.where(torch.movedim(has, ax, 0), g, torch.nan)
    data = torch.movedim(g, 0, ax)
    coords = dict(output.coords)
    coords["time"] = spec.labels
    return ClimArray(data, output.dims, coords, dict(output.attrs), output.name)


@declare_units(tas="[temperature]")
def tg_mean_warmcold_quarter(tas: ClimArray, op: str = "warmest",
                             freq: str = "YS") -> ClimArray:
    """P10/P11: mean temperature of warmest/coldest quarter (xclim:_anuclim.py:215)."""
    q = _to_quarter(tas=tas)
    out = select_resample_op(q, _quarter_op(op), freq)
    out.attrs["units"] = q.attrs.get("units", "")
    return out


@declare_units(tas="[temperature]", pr="[precipitation]")
def tg_mean_wetdry_quarter(tas: ClimArray, pr: ClimArray, op: str = "wettest",
                           freq: str = "YS") -> ClimArray:
    """P8/P9: mean temperature of wettest/driest quarter (xclim:_anuclim.py:262)."""
    tas_q = _to_quarter(tas=tas)
    pr_q = _to_quarter(pr=pr)
    out = _from_other_arg(pr_q, tas_q, _quarter_op(op), freq)
    out.attrs["units"] = tas_q.attrs.get("units", "")
    return out


@declare_units(pr="[precipitation]")
def prcptot_wetdry_quarter(pr: ClimArray, op: str = "wettest",
                           freq: str = "YS") -> ClimArray:
    """P16/P17: precipitation of wettest/driest quarter (xclim:_anuclim.py:311)."""
    q = _to_quarter(pr=pr)
    out = select_resample_op(q, _quarter_op(op), freq)
    out.attrs["units"] = q.attrs.get("units", "")
    return out


@declare_units(pr="[precipitation]", tas="[temperature]")
def prcptot_warmcold_quarter(pr: ClimArray, tas: ClimArray, op: str = "warmest",
                             freq: str = "YS") -> ClimArray:
    """P18/P19: precipitation of warmest/coldest quarter (xclim:_anuclim.py:358)."""
    tas_q = _to_quarter(tas=tas)
    pr_q = _to_quarter(pr=pr)
    out = _from_other_arg(tas_q, pr_q, _quarter_op(op), freq)
    out.attrs["units"] = pr_q.attrs.get("units", "")
    return out


@declare_units(pr="[precipitation]", thresh="[precipitation]")
def prcptot(pr: ClimArray, thresh: str = "0 mm/d", freq: str = "YS") -> ClimArray:
    """P12: total precipitation over threshold days (xclim:_anuclim.py:412)."""
    t = convert_units_to(str2pint(thresh), pr, context="hydro")
    pram = rate2amount(pr.where(pr >= t, 0))
    u = pram.attrs["units"]
    out = pram.resample(freq).sum()
    out.attrs["units"] = u
    return out


@declare_units(pr="[precipitation]")
def prcptot_wetdry_period(pr: ClimArray, op: str = "wettest",
                          freq: str = "MS") -> ClimArray:
    """P13/P14: precipitation of wettest/driest period (xclim:_anuclim.py:445)."""
    pram = rate2amount(pr)
    u = pram.attrs["units"]
    out = getattr(pram.resample(freq), _NP_OPS[op])()
    out.attrs["units"] = u
    return out
