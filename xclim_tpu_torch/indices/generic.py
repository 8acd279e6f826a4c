"""Generic index building blocks (reference: xclim:src/xclim/indices/generic.py).

Parameterizable compute functions used by the index library. All operate on
ClimArrays; thresholds are quantified strings converted host-side so the
device sees plain scalars.

Ported so far: the comparison helpers, the resample/rolling reductions and
``threshold_count``. The spell family and the rest wait for the spells and
index-breadth slices.
"""

from __future__ import annotations

import operator
from typing import Sequence

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, str2pint, to_agg_units
from xclim_tpu_torch.ops.segments import rolling_reduce

__all__ = [
    "binary_ops",
    "compare",
    "default_freq",
    "doymax",
    "doymin",
    "get_op",
    "select_resample_op",
    "select_rolling_resample_op",
    "threshold_count",
]

binary_ops = {">": "gt", "<": "lt", ">=": "ge", "<=": "le", "==": "eq", "!=": "ne"}


def get_op(op: str, constrain: Sequence[str] | None = None):
    """Comparison-operator lookup with constraint validation (xclim generic.py:255)."""
    if op == "gteq":
        op = "ge"
    if op == "lteq":
        op = "le"
    if op in binary_ops:
        binop = binary_ops[op]
    elif op in binary_ops.values():
        binop = op
    else:
        raise ValueError(f"Operation `{op}` not recognized.")
    if constrain:
        allowed = set()
        for c in constrain:
            allowed.add(c)
            allowed.add(binary_ops.get(c, c))
        if op not in allowed and binop not in allowed:
            raise ValueError(f"Operation `{op}` not permitted for indice.")
    return getattr(operator, binop)


def compare(left: ClimArray, op: str, right, constrain=None) -> ClimArray:
    """Boolean mask ``left op right`` (xclim generic.py:301)."""
    return get_op(op, constrain)(left, right)


def _thresh(threshold, like: ClimArray, context: str = "infer"):
    """Quantified string/number → scalar in `like`'s units."""
    if isinstance(threshold, ClimArray):
        return convert_units_to(threshold, like, context=context)
    if isinstance(threshold, (int, float)):
        return float(threshold)
    return convert_units_to(str2pint(threshold), like, context=context)


def default_freq(**indexer) -> str:
    """Default annual resampling frequency anchored to the time indexer
    (xclim generic.py:224): season='DJF' → 'YS-DEC', month=[6,7] → 'YS-JUN'."""
    months = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP",
              "OCT", "NOV", "DEC"]
    if not indexer:
        return "YS-JAN"
    group, value = next(iter(indexer.items()))
    if group == "season":
        if isinstance(value, (list, tuple)):
            value = value[0]
        month = {"DJF": 12, "MAM": 3, "JJA": 6, "SON": 9}[value]
    elif group == "month":
        month = int(np.atleast_1d(value)[0])
    else:
        return "YS-JAN"
    return f"YS-{months[month - 1]}"


def doymax(da: ClimArray, freq: str = "YS") -> ClimArray:
    """Day of year of the maximum (xclim generic.py:177)."""
    out = da.resample(freq).argmax_doy()
    return to_agg_units(out, da, "doymax")


def doymin(da: ClimArray, freq: str = "YS") -> ClimArray:
    """Day of year of the minimum (xclim generic.py:177)."""
    out = da.resample(freq).argmin_doy()
    return to_agg_units(out, da, "doymin")


def select_resample_op(da: ClimArray, op: str, freq: str = "YS", out_units=None,
                       **indexer) -> ClimArray:
    """resample(freq).op over the (optionally time-subset) array
    (xclim generic.py:83)."""
    da = da.select_time(**indexer)
    if op in ("doymin", "doymax"):
        out = da.resample(freq).argmax_doy() if op == "doymax" else da.resample(freq).argmin_doy()
    else:
        out = getattr(da.resample(freq), op.replace("integral", "sum"))()
    if out_units is not None:
        out.attrs["units"] = out_units
        return out
    if op in ("std", "var"):
        out.attrs["units"] = da.attrs.get("units", "")
    return to_agg_units(out, da, op)


def select_rolling_resample_op(da: ClimArray, op: str, window: int,
                               window_center: bool = True, window_op: str = "mean",
                               freq: str = "YS", out_units=None, **indexer) -> ClimArray:
    """Rolling stat then resample-reduce (xclim generic.py:128)."""
    rolled = da.copy(data=rolling_reduce(da.data, window, window_op, axis=da.time_axis,
                                         center=window_center))
    rolled.attrs = dict(da.attrs)
    return select_resample_op(rolled, op, freq=freq, out_units=out_units, **indexer)


def threshold_count(da: ClimArray, op: str, threshold, freq: str,
                    constrain=None) -> ClimArray:
    """Count steps where ``da op threshold`` per period (xclim generic.py:329).

    The comparison's 0/1 mask is summed per period by the segment engine
    (the ``segred`` kernel on a CUDA tensor). A NaN input compares False and
    is not counted; all-NaN periods are left to the missing-value masks.
    """
    if constrain is None:
        constrain = (">", "<", ">=", "<=")
    thresh = _thresh(threshold, da)
    c = compare(da, op, thresh, constrain)
    return c.astype(torch.float32).resample(freq).sum()
