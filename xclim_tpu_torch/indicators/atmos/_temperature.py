"""Temperature indicator declarations
(reference: xclim:src/xclim/indicators/atmos/_temperature.py).

Realm subclasses mirror the reference ladder (Temp(Daily) etc.,
_temperature.py:117-140); instances are plain declarative constructions.
Ported so far: the indicators whose compute is in ``indices/_simple.py``,
the six doy-percentile day counts and the warm and cold spell duration
indices.
"""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import (
    Daily,
    ResamplingIndicatorWithIndexing,
)

__all__ = [
    "cold_spell_duration_index",
    "frost_days",
    "hot_days",
    "ice_days",
    "tg10p",
    "tg_max",
    "tg_mean",
    "tg_min",
    "tg90p",
    "tn10p",
    "tn_max",
    "tn_mean",
    "tn_min",
    "tn90p",
    "tx10p",
    "tx_max",
    "tx_mean",
    "tx_min",
    "tx90p",
    "warm_spell_duration_index",
]


class Temp(Daily):
    """Daily temperature indicator (xclim:_temperature.py:117)."""

    realm = "atmos"
    keywords = "temperature"
    context = "none"


class TempWithIndexing(ResamplingIndicatorWithIndexing):
    """Temperature indicator with **indexer support (xclim:_temperature.py:130)."""

    realm = "atmos"
    keywords = "temperature"
    src_freq = "D"
    context = "none"


tg_mean = TempWithIndexing(
    identifier="tg_mean",
    title="Mean temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Mean daily mean temperature",
    description="{freq} mean of daily mean temperature.",
    abstract="Mean of daily mean temperature.",
    cell_methods="time: mean over days",
    compute=indices.tg_mean,
)

tg_max = TempWithIndexing(
    identifier="tg_max",
    title="Maximum of mean temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Maximum daily mean temperature",
    description="{freq} maximum of daily mean temperature.",
    cell_methods="time: maximum over days",
    compute=indices.tg_max,
)

tg_min = TempWithIndexing(
    identifier="tg_min",
    title="Minimum of mean temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Minimum daily mean temperature",
    description="{freq} minimum of daily mean temperature.",
    cell_methods="time: minimum over days",
    compute=indices.tg_min,
)

tx_mean = TempWithIndexing(
    identifier="tx_mean",
    title="Mean of maximum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Mean daily maximum temperature",
    description="{freq} mean of daily maximum temperature.",
    cell_methods="time: mean over days",
    compute=indices.tx_mean,
)

tx_max = TempWithIndexing(
    identifier="tx_max",
    title="Maximum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Maximum daily maximum temperature",
    description="{freq} maximum of daily maximum temperature.",
    cell_methods="time: maximum over days",
    compute=indices.tx_max,
)

tx_min = TempWithIndexing(
    identifier="tx_min",
    title="Minimum of maximum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Minimum daily maximum temperature",
    description="{freq} minimum of daily maximum temperature.",
    cell_methods="time: minimum over days",
    compute=indices.tx_min,
)

tn_mean = TempWithIndexing(
    identifier="tn_mean",
    title="Mean of minimum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Mean daily minimum temperature",
    description="{freq} mean of daily minimum temperature.",
    cell_methods="time: mean over days",
    compute=indices.tn_mean,
)

tn_max = TempWithIndexing(
    identifier="tn_max",
    title="Maximum of minimum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Maximum daily minimum temperature",
    description="{freq} maximum of daily minimum temperature.",
    cell_methods="time: maximum over days",
    compute=indices.tn_max,
)

tn_min = TempWithIndexing(
    identifier="tn_min",
    title="Minimum temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Minimum daily minimum temperature",
    description="{freq} minimum of daily minimum temperature.",
    cell_methods="time: minimum over days",
    compute=indices.tn_min,
)

frost_days = TempWithIndexing(
    identifier="frost_days",
    title="Frost days",
    units="days",
    long_name="Number of days where the daily minimum temperature is below {thresh}",
    description="{freq} number of days where the daily minimum temperature is "
                "below {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.frost_days,
)

hot_days = TempWithIndexing(
    identifier="hot_days",
    title="Hot days",
    units="days",
    standard_name="days_with_air_temperature_above_threshold",
    long_name="Number of days where the daily maximum temperature is above "
              "{thresh}",
    description="{freq} number of days where the daily maximum temperature "
                "is above {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.hot_days,
)

ice_days = TempWithIndexing(
    identifier="ice_days",
    title="Ice days",
    units="days",
    long_name="Number of days where the daily maximum temperature stays below {thresh}",
    description="{freq} number of days where the daily maximum temperature stays "
                "below {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.ice_days,
)

tg90p = TempWithIndexing(
    identifier="tg90p",
    title="Days with mean temperature above the 90th percentile",
    units="days",
    long_name="Number of days with mean temperature above the 90th percentile",
    description="{freq} number of days with mean temperature above the 90th "
                "percentile ({tas_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tg90p,
)

tg10p = TempWithIndexing(
    identifier="tg10p",
    title="Days with mean temperature below the 10th percentile",
    units="days",
    long_name="Number of days with mean temperature below the 10th percentile",
    description="{freq} number of days with mean temperature below the 10th "
                "percentile ({tas_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tg10p,
)

tx90p = TempWithIndexing(
    identifier="tx90p",
    title="Days with maximum temperature above the 90th percentile",
    units="days",
    long_name="Number of days with maximum temperature above the 90th percentile",
    description="{freq} number of days with maximum temperature above the 90th "
                "percentile ({tasmax_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tx90p,
)

tx10p = TempWithIndexing(
    identifier="tx10p",
    title="Days with maximum temperature below the 10th percentile",
    units="days",
    long_name="Number of days with maximum temperature below the 10th percentile",
    description="{freq} number of days with maximum temperature below the 10th "
                "percentile ({tasmax_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tx10p,
)

tn90p = TempWithIndexing(
    identifier="tn90p",
    title="Days with minimum temperature above the 90th percentile",
    units="days",
    long_name="Number of days with minimum temperature above the 90th percentile",
    description="{freq} number of days with minimum temperature above the 90th "
                "percentile ({tasmin_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tn90p,
)

tn10p = TempWithIndexing(
    identifier="tn10p",
    title="Days with minimum temperature below the 10th percentile",
    units="days",
    long_name="Number of days with minimum temperature below the 10th percentile",
    description="{freq} number of days with minimum temperature below the 10th "
                "percentile ({tasmin_per_period} period).",
    cell_methods="time: sum over days",
    compute=indices.tn10p,
)

cold_spell_duration_index = Temp(
    identifier="cold_spell_duration_index",
    title="Cold spell duration index",
    units="days",
    long_name="Days part of a run of at least {window} days with minimum "
              "temperature below the 10th percentile",
    description="{freq} number of days with at least {window} consecutive days "
                "where the minimum temperature is below the 10th percentile.",
    cell_methods="time: sum over days",
    compute=indices.cold_spell_duration_index,
)

warm_spell_duration_index = Temp(
    identifier="warm_spell_duration_index",
    title="Warm spell duration index",
    units="days",
    long_name="Days part of a run of at least {window} days with maximum "
              "temperature above the 90th percentile",
    description="{freq} number of days with at least {window} consecutive days "
                "where the maximum temperature is above the 90th percentile.",
    cell_methods="time: sum over days",
    compute=indices.warm_spell_duration_index,
)
