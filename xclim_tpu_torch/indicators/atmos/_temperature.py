"""Temperature indicator declarations
(reference: xclim:src/xclim/indicators/atmos/_temperature.py).

Realm subclasses mirror the reference ladder (Temp(Daily) etc.,
_temperature.py:117-140); instances are plain declarative constructions.
Ported so far: the indicators whose compute is in ``indices/_simple.py``.
"""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import (
    Daily,
    ResamplingIndicatorWithIndexing,
)

__all__ = [
    "frost_days",
    "hot_days",
    "ice_days",
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
