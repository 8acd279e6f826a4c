"""Simple per-period reductions (reference: xclim:src/xclim/indices/_simple.py).

Each function is a thin composition of the generic building blocks; the
device work happens in the segment engine (``ops/segments.py``).
"""

from __future__ import annotations

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import (
    convert_units_to,
    declare_units,
    rate2amount,
    to_agg_units,
)
from xclim_tpu_torch.indices.generic import select_resample_op, threshold_count
from xclim_tpu_torch.ops.segments import rolling_reduce

__all__ = [
    "frost_days",
    "hot_days",
    "ice_days",
    "max_1day_precipitation_amount",
    "max_n_day_precipitation_amount",
    "max_pr_intensity",
    "sfcWind_max",
    "sfcWind_mean",
    "sfcWind_min",
    "sfcWindmax_max",
    "sfcWindmax_mean",
    "sfcWindmax_min",
    "snow_depth",
    "tg_max",
    "tg_mean",
    "tg_min",
    "tn_max",
    "tn_mean",
    "tn_min",
    "tx_max",
    "tx_mean",
    "tx_min",
]


@declare_units(tas="[temperature]")
def tg_max(tas: ClimArray, freq: str = "YS") -> ClimArray:
    """Highest mean daily temperature (xclim:_simple.py:46)."""
    return select_resample_op(tas, op="max", freq=freq)


@declare_units(tas="[temperature]")
def tg_mean(tas: ClimArray, freq: str = "YS") -> ClimArray:
    """Mean of daily mean temperature (xclim:_simple.py:77)."""
    return select_resample_op(tas, op="mean", freq=freq)


@declare_units(tas="[temperature]")
def tg_min(tas: ClimArray, freq: str = "YS") -> ClimArray:
    """Lowest mean daily temperature (xclim:_simple.py:117)."""
    return select_resample_op(tas, op="min", freq=freq)


@declare_units(tasmin="[temperature]")
def tn_max(tasmin: ClimArray, freq: str = "YS") -> ClimArray:
    """Highest minimum temperature (xclim:_simple.py:148)."""
    return select_resample_op(tasmin, op="max", freq=freq)


@declare_units(tasmin="[temperature]")
def tn_mean(tasmin: ClimArray, freq: str = "YS") -> ClimArray:
    """Mean minimum temperature (xclim:_simple.py:179)."""
    return select_resample_op(tasmin, op="mean", freq=freq)


@declare_units(tasmin="[temperature]")
def tn_min(tasmin: ClimArray, freq: str = "YS") -> ClimArray:
    """Lowest minimum temperature (xclim:_simple.py:210)."""
    return select_resample_op(tasmin, op="min", freq=freq)


@declare_units(tasmax="[temperature]")
def tx_max(tasmax: ClimArray, freq: str = "YS") -> ClimArray:
    """Highest max temperature (xclim:_simple.py:241)."""
    return select_resample_op(tasmax, op="max", freq=freq)


@declare_units(tasmax="[temperature]")
def tx_mean(tasmax: ClimArray, freq: str = "YS") -> ClimArray:
    """Mean max temperature (xclim:_simple.py:272)."""
    return select_resample_op(tasmax, op="mean", freq=freq)


@declare_units(tasmax="[temperature]")
def tx_min(tasmax: ClimArray, freq: str = "YS") -> ClimArray:
    """Lowest max temperature (xclim:_simple.py:303)."""
    return select_resample_op(tasmax, op="min", freq=freq)


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def hot_days(tasmax: ClimArray, thresh: str = "25 degC", freq: str = "YS") -> ClimArray:
    """Number of days with tasmax > thresh (xclim:_simple.py:334-337)."""
    out = threshold_count(tasmax, ">", thresh, freq)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(tasmin="[temperature]", thresh="[temperature]")
def frost_days(tasmin: ClimArray, thresh: str = "0 degC", freq: str = "YS",
               **indexer) -> ClimArray:
    """Number of days with tasmin < thresh (xclim:_simple.py:373)."""
    tasmin = tasmin.select_time(**indexer)
    out = threshold_count(tasmin, "<", thresh, freq)
    return to_agg_units(out, tasmin, "count", deffreq="D")


@declare_units(tasmax="[temperature]", thresh="[temperature]")
def ice_days(tasmax: ClimArray, thresh: str = "0 degC", freq: str = "YS") -> ClimArray:
    """Number of days with tasmax < thresh (xclim:_simple.py:412)."""
    out = threshold_count(tasmax, "<", thresh, freq)
    return to_agg_units(out, tasmax, "count", deffreq="D")


@declare_units(pr="[precipitation]")
def max_1day_precipitation_amount(pr: ClimArray, freq: str = "YS") -> ClimArray:
    """Highest 1-day precipitation amount (xclim:_simple.py:447)."""
    return select_resample_op(pr, op="max", freq=freq)


@declare_units(pr="[precipitation]")
def max_n_day_precipitation_amount(pr: ClimArray, window: int = 1,
                                   freq: str = "YS") -> ClimArray:
    """Highest precipitation amount over a rolling n-day window
    (xclim:_simple.py:485)."""
    pram = rate2amount(pr)
    rolled = pram.copy(data=rolling_reduce(pram.data, window, "sum", axis=pram.time_axis))
    rolled.attrs = dict(pram.attrs)
    out = select_resample_op(rolled, op="max", freq=freq)
    return convert_units_to(out, "mm", context="hydro")


@declare_units(pr="[precipitation]")
def max_pr_intensity(pr: ClimArray, window: int = 1, freq: str = "YS",
                     **indexer) -> ClimArray:
    """Highest mean precipitation rate over a rolling window
    (xclim:_simple.py:529)."""
    rolled = pr.copy(data=rolling_reduce(pr.data, window, "mean", axis=pr.time_axis))
    rolled.attrs = dict(pr.attrs)
    out = select_resample_op(rolled, op="max", freq=freq, **indexer)
    out.attrs["units"] = pr.attrs.get("units", "")
    return out


@declare_units(snd="[length]")
def snow_depth(snd: ClimArray, freq: str = "YS") -> ClimArray:
    """Mean snow depth (xclim:_simple.py:573)."""
    return select_resample_op(snd, op="mean", freq=freq)


@declare_units(sfcWind="[speed]")
def sfcWind_max(sfcWind: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Highest daily mean wind speed (xclim:_simple.py:598)."""
    return select_resample_op(sfcWind, op="max", freq=freq)


@declare_units(sfcWind="[speed]")
def sfcWind_mean(sfcWind: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Mean daily mean wind speed (xclim:_simple.py:638)."""
    return select_resample_op(sfcWind, op="mean", freq=freq)


@declare_units(sfcWind="[speed]")
def sfcWind_min(sfcWind: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Lowest daily mean wind speed (xclim:_simple.py:678)."""
    return select_resample_op(sfcWind, op="min", freq=freq)


@declare_units(sfcWindmax="[speed]")
def sfcWindmax_max(sfcWindmax: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Highest daily max wind speed (xclim:_simple.py:718)."""
    return select_resample_op(sfcWindmax, op="max", freq=freq)


@declare_units(sfcWindmax="[speed]")
def sfcWindmax_mean(sfcWindmax: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Mean daily max wind speed (xclim:_simple.py:757)."""
    return select_resample_op(sfcWindmax, op="mean", freq=freq)


@declare_units(sfcWindmax="[speed]")
def sfcWindmax_min(sfcWindmax: ClimArray, freq: str = "YS") -> ClimArray:  # noqa: N802
    """Lowest daily max wind speed (xclim:_simple.py:796)."""
    return select_resample_op(sfcWindmax, op="min", freq=freq)
