"""Percentile-based indices with the Zhang-2005 bootstrap
(reference: xclim:src/xclim/indices/_multivariate.py).

Ported so far: the six doy-percentile day counts (tg90p ... tx10p) and the
warm and cold spell duration indices. The rest of the module waits for the
spells and index-breadth slices.
"""

from __future__ import annotations

from xclim_tpu_torch.core.bootstrapping import percentile_bootstrap
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import resample_doy
from xclim_tpu_torch.core.units import convert_units_to, declare_units, to_agg_units
from xclim_tpu_torch.indices import run_length as rl
from xclim_tpu_torch.indices.generic import compare, threshold_count

__all__ = [
    "cold_spell_duration_index",
    "tg10p",
    "tg90p",
    "tn10p",
    "tn90p",
    "tx10p",
    "tx90p",
    "warm_spell_duration_index",
]


def _per_thresh(per: ClimArray, da: ClimArray, context=None) -> ClimArray:
    per = convert_units_to(per, da, context=context)
    return resample_doy(per, da)


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def cold_spell_duration_index(tasmin: ClimArray, tasmin_per: ClimArray, window: int = 6,
                              freq: str = "YS", resample_before_rl: bool = True,
                              bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days in >= window-day runs below the doy 10th percentile
    (xclim:_multivariate.py:69)."""
    thresh = _per_thresh(tasmin_per, tasmin)
    below = compare(tasmin, op, thresh, constrain=("<", "<="))
    out = rl.windowed_run_count(below, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmin, "count", deffreq="D")


def _t_percentile_days(da, per, freq, op, constrain):
    thresh = _per_thresh(per, da)
    out = threshold_count(da, op, thresh, freq, constrain=constrain)
    return to_agg_units(out, da, "count", deffreq="D")


@declare_units(tas="[temperature]", tas_per="[temperature]")
@percentile_bootstrap
def tg90p(tas: ClimArray, tas_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tas over the 90th doy percentile (xclim:_multivariate.py:1300)."""
    return _t_percentile_days(tas, tas_per, freq, op, (">", ">="))


@declare_units(tas="[temperature]", tas_per="[temperature]")
@percentile_bootstrap
def tg10p(tas: ClimArray, tas_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tas under the 10th doy percentile (xclim:_multivariate.py:1359)."""
    return _t_percentile_days(tas, tas_per, freq, op, ("<", "<="))


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def tn90p(tasmin: ClimArray, tasmin_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tasmin over the 90th doy percentile (xclim:_multivariate.py:1418)."""
    return _t_percentile_days(tasmin, tasmin_per, freq, op, (">", ">="))


@declare_units(tasmin="[temperature]", tasmin_per="[temperature]")
@percentile_bootstrap
def tn10p(tasmin: ClimArray, tasmin_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tasmin under the 10th doy percentile (xclim:_multivariate.py:1477)."""
    return _t_percentile_days(tasmin, tasmin_per, freq, op, ("<", "<="))


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def tx90p(tasmax: ClimArray, tasmax_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days with tasmax over the 90th doy percentile (xclim:_multivariate.py:1536)."""
    return _t_percentile_days(tasmax, tasmax_per, freq, op, (">", ">="))


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def tx10p(tasmax: ClimArray, tasmax_per: ClimArray, freq: str = "YS",
          bootstrap: bool = False, op: str = "<") -> ClimArray:
    """Days with tasmax under the 10th doy percentile (xclim:_multivariate.py:1595)."""
    return _t_percentile_days(tasmax, tasmax_per, freq, op, ("<", "<="))


@declare_units(tasmax="[temperature]", tasmax_per="[temperature]")
@percentile_bootstrap
def warm_spell_duration_index(tasmax: ClimArray, tasmax_per: ClimArray, window: int = 6,
                              freq: str = "YS", resample_before_rl: bool = True,
                              bootstrap: bool = False, op: str = ">") -> ClimArray:
    """Days in >= window-day runs over the doy 90th percentile
    (xclim:_multivariate.py:1719)."""
    thresh = _per_thresh(tasmax_per, tasmax)
    above = compare(tasmax, op, thresh, constrain=(">", ">="))
    out = rl.windowed_run_count(above, window, freq=freq,
                                resample_before_rl=resample_before_rl)
    return to_agg_units(out, tasmax, "count", deffreq="D")
