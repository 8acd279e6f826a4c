"""Temperature indicator declarations
(reference: xclim:src/xclim/indicators/atmos/_temperature.py).

Realm subclasses mirror the reference ladder (Temp(Daily) etc.,
_temperature.py:117-140); instances are plain declarative constructions.
"""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import (
    Daily,
    Hourly,
    ResamplingIndicatorWithIndexing,
)

__all__ = [
    "australian_hardiness_zones",
    "cool_night_index",
    "cooling_degree_days_approximation",
    "corn_heat_units",
    "cp",
    "cu",
    "dlyfrzthw",
    "effective_growing_degree_days",
    "fire_season",
    "first_day_tg_below",
    "first_day_tn_below",
    "first_day_tx_below",
    "freezethaw_spell_frequency",
    "freezethaw_spell_max_length",
    "freezethaw_spell_mean_length",
    "freezing_degree_days",
    "frost_free_spell_max_length",
    "heat_spell_frequency",
    "heat_spell_max_length",
    "heat_spell_total_length",
    "heating_degree_days_approximation",
    "hot_days",
    "late_frost_days",
    "latitude_temperature_index",
    "thawing_degree_days",
    "usda_hardiness_zones",
    "cold_spell_days",
    "cold_spell_duration_index",
    "cold_spell_frequency",
    "cold_spell_max_length",
    "cold_spell_total_length",
    "cooling_degree_days",
    "daily_temperature_range",
    "daily_temperature_range_variability",
    "degree_days_exceedance_date",
    "extreme_temperature_range",
    "first_day_tg_above",
    "first_day_tn_above",
    "first_day_tx_above",
    "freshet_start",
    "frost_days",
    "frost_free_season_end",
    "frost_free_season_length",
    "frost_free_season_start",
    "frost_season_length",
    "growing_degree_days",
    "growing_season_end",
    "growing_season_length",
    "growing_season_start",
    "heat_wave_frequency",
    "heat_wave_index",
    "heat_wave_max_length",
    "heat_wave_total_length",
    "heating_degree_days",
    "hot_spell_frequency",
    "hot_spell_max_length",
    "hot_spell_max_magnitude",
    "hot_spell_total_length",
    "ice_days",
    "last_spring_frost",
    "max_daily_temperature_range",
    "consecutive_frost_days",
    "consecutive_frost_free_days",
    "daily_freezethaw_cycles",
    "maximum_consecutive_frost_days",
    "maximum_consecutive_frost_free_days",
    "maximum_consecutive_tx_days",
    "tg10p",
    "tg90p",
    "tg_days_above",
    "tg_days_below",
    "tg_max",
    "tg_mean",
    "tg_min",
    "tn10p",
    "tn90p",
    "tn_days_above",
    "tn_days_below",
    "tn_max",
    "tn_mean",
    "tn_min",
    "tx10p",
    "tx90p",
    "tx_days_above",
    "tx_days_below",
    "tx_max",
    "tx_mean",
    "tx_min",
    "tx_tn_days_above",
    "warm_spell_duration_index",
    "tropical_nights",
    "maximum_consecutive_warm_days",
    "cold_and_dry_days",
    "warm_and_dry_days",
    "warm_and_wet_days",
    "cold_and_wet_days",
    "huglin_index",
    "biologically_effective_degree_days",
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

tx_days_above = TempWithIndexing(
    identifier="tx_days_above",
    title="Days with maximum temperature above a threshold",
    units="days",
    long_name="Number of days where the daily maximum temperature exceeds {thresh}",
    description="{freq} number of days where the daily maximum temperature "
                "exceeds {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.tx_days_above,
)

tx_days_below = TempWithIndexing(
    identifier="tx_days_below",
    title="Days with maximum temperature below a threshold",
    units="days",
    long_name="Number of days where the daily maximum temperature is below {thresh}",
    description="{freq} number of days where the daily maximum temperature is "
                "below {thresh}.",
    compute=indices.tx_days_below,
)

tn_days_above = TempWithIndexing(
    identifier="tn_days_above",
    title="Days with minimum temperature above a threshold",
    units="days",
    long_name="Number of days where the daily minimum temperature exceeds {thresh}",
    description="{freq} number of days where the daily minimum temperature "
                "exceeds {thresh}.",
    compute=indices.tn_days_above,
)

tn_days_below = TempWithIndexing(
    identifier="tn_days_below",
    title="Days with minimum temperature below a threshold",
    units="days",
    long_name="Number of days where the daily minimum temperature is below {thresh}",
    description="{freq} number of days where the daily minimum temperature is "
                "below {thresh}.",
    compute=indices.tn_days_below,
)

tg_days_above = TempWithIndexing(
    identifier="tg_days_above",
    title="Days with mean temperature above a threshold",
    units="days",
    long_name="Number of days where the daily mean temperature exceeds {thresh}",
    description="{freq} number of days where the daily mean temperature exceeds "
                "{thresh}.",
    compute=indices.tg_days_above,
)

tg_days_below = TempWithIndexing(
    identifier="tg_days_below",
    title="Days with mean temperature below a threshold",
    units="days",
    long_name="Number of days where the daily mean temperature is below {thresh}",
    description="{freq} number of days where the daily mean temperature is below "
                "{thresh}.",
    compute=indices.tg_days_below,
)

growing_degree_days = TempWithIndexing(
    identifier="growing_degree_days",
    title="Growing degree days",
    units="K days",
    long_name="Cumulative sum of temperature degrees above {thresh}",
    description="{freq} growing degree days (temperature above {thresh}).",
    cell_methods="time: sum over days",
    compute=indices.growing_degree_days,
)

cooling_degree_days = TempWithIndexing(
    identifier="cooling_degree_days",
    title="Cooling degree days",
    units="K days",
    long_name="Cumulative sum of temperature degrees above {thresh}",
    description="{freq} cooling degree days (mean temperature above {thresh}).",
    cell_methods="time: sum over days",
    compute=indices.cooling_degree_days,
)

heating_degree_days = TempWithIndexing(
    identifier="heating_degree_days",
    title="Heating degree days",
    units="K days",
    long_name="Cumulative sum of temperature degrees below {thresh}",
    description="{freq} heating degree days (mean temperature below {thresh}).",
    cell_methods="time: sum over days",
    compute=indices.heating_degree_days,
)

cold_spell_days = Temp(
    identifier="cold_spell_days",
    title="Cold spell days",
    units="days",
    long_name="Number of days part of a cold spell",
    description="{freq} number of days that are part of a cold spell (at least "
                "{window} consecutive days with mean temperature below {thresh}).",
    cell_methods="time: sum over days",
    compute=indices.cold_spell_days,
)

cold_spell_frequency = Temp(
    identifier="cold_spell_frequency",
    title="Cold spell frequency",
    units="",
    long_name="Number of cold spell events",
    description="{freq} number of cold spell events (at least {window} "
                "consecutive days with mean temperature below {thresh}).",
    compute=indices.cold_spell_frequency,
)

cold_spell_max_length = Temp(
    identifier="cold_spell_max_length",
    title="Longest cold spell",
    units="days",
    long_name="Longest spell of low temperatures below {thresh}",
    description="{freq} longest spell of at least {window} consecutive days with "
                "mean temperature below {thresh}.",
    compute=indices.cold_spell_max_length,
)

cold_spell_total_length = Temp(
    identifier="cold_spell_total_length",
    title="Total cold spell length",
    units="days",
    long_name="Total days in cold spells below {thresh}",
    description="{freq} total number of days in cold spells of at least {window} "
                "days with mean temperature below {thresh}.",
    compute=indices.cold_spell_total_length,
)

hot_spell_frequency = Temp(
    identifier="hot_spell_frequency",
    title="Hot spell frequency",
    units="",
    long_name="Number of hot spell events",
    description="{freq} number of hot spells (at least {window} consecutive days "
                "with maximum temperature above {thresh}).",
    compute=indices.hot_spell_frequency,
)

hot_spell_max_length = Temp(
    identifier="hot_spell_max_length",
    title="Longest hot spell",
    units="days",
    long_name="Longest spell of high temperatures above {thresh}",
    description="{freq} longest spell of at least {window} consecutive days with "
                "maximum temperature above {thresh}.",
    compute=indices.hot_spell_max_length,
)

hot_spell_total_length = Temp(
    identifier="hot_spell_total_length",
    title="Total hot spell length",
    units="days",
    long_name="Total days in hot spells above {thresh}",
    description="{freq} total number of days in hot spells of at least {window} "
                "days with maximum temperature above {thresh}.",
    compute=indices.hot_spell_total_length,
)

hot_spell_max_magnitude = Temp(
    identifier="hot_spell_max_magnitude",
    title="Hot spell maximum magnitude",
    units="K d",
    long_name="Maximum cumulative temperature excess of hot spells",
    description="{freq} maximum cumulative temperature excess above {thresh} of "
                "any hot spell of at least {window} days.",
    compute=indices.hot_spell_max_magnitude,
)

heat_wave_index = Temp(
    identifier="heat_wave_index",
    title="Heat wave index",
    units="days",
    long_name="Number of days that are part of a heatwave",
    description="{freq} number of days that are part of a heatwave (at least "
                "{window} consecutive days with maximum temperature above {thresh}).",
    compute=indices.heat_wave_index,
)

heat_wave_frequency = Temp(
    identifier="heat_wave_frequency",
    title="Heat wave frequency",
    units="",
    long_name="Number of heat wave events",
    description="{freq} number of heat waves (at least {window} consecutive days "
                "with minimum temperature above {thresh_tasmin} and maximum "
                "temperature above {thresh_tasmax}).",
    compute=indices.heat_wave_frequency,
)

heat_wave_max_length = Temp(
    identifier="heat_wave_max_length",
    title="Heat wave maximum length",
    units="days",
    long_name="Longest heat wave",
    description="{freq} longest heat wave (minimum temperature above "
                "{thresh_tasmin} and maximum temperature above {thresh_tasmax} for "
                "at least {window} days).",
    compute=indices.heat_wave_max_length,
)

heat_wave_total_length = Temp(
    identifier="heat_wave_total_length",
    title="Heat wave total length",
    units="days",
    long_name="Total days in heat waves",
    description="{freq} total number of days in heat waves (minimum temperature "
                "above {thresh_tasmin} and maximum temperature above "
                "{thresh_tasmax} for at least {window} days).",
    compute=indices.heat_wave_total_length,
)

maximum_consecutive_frost_days = Temp(
    identifier="consecutive_frost_days",
    title="Maximum consecutive frost days",
    units="days",
    long_name="Maximum number of consecutive days with minimum temperature below "
              "{thresh}",
    description="{freq} maximum number of consecutive days with minimum "
                "temperature below {thresh}.",
    compute=indices.maximum_consecutive_frost_days,
)

# reference module-attribute names (xclim:indicators/atmos/_temperature.py:1078
# exposes these under the identifier names)
consecutive_frost_days = maximum_consecutive_frost_days

maximum_consecutive_frost_free_days = Temp(
    identifier="consecutive_frost_free_days",
    title="Maximum consecutive frost-free days",
    units="days",
    long_name="Maximum number of consecutive days with minimum temperature at or "
              "above {thresh}",
    description="{freq} maximum number of consecutive days with minimum "
                "temperature at or above {thresh}.",
    compute=indices.maximum_consecutive_frost_free_days,
)

consecutive_frost_free_days = maximum_consecutive_frost_free_days

maximum_consecutive_tx_days = Temp(
    identifier="maximum_consecutive_tx_days",
    title="Maximum consecutive warm days",
    units="days",
    long_name="Maximum number of consecutive days with maximum temperature above "
              "{thresh}",
    description="{freq} maximum number of consecutive days with maximum "
                "temperature above {thresh}.",
    compute=indices.maximum_consecutive_tx_days,
)

growing_season_start = Temp(
    identifier="growing_season_start",
    title="Growing season start",
    units="1",
    long_name="First day of the growing season",
    description="Day of year when temperature exceeds {thresh} for at least "
                "{window} consecutive days.",
    compute=indices.growing_season_start,
)

growing_season_end = Temp(
    identifier="growing_season_end",
    title="Growing season end",
    units="1",
    long_name="Last day of the growing season",
    description="Day of year of the end of the growing season (temperature below "
                "{thresh} for {window} consecutive days after {mid_date}).",
    compute=indices.growing_season_end,
)

growing_season_length = Temp(
    identifier="growing_season_length",
    title="Growing season length",
    units="days",
    long_name="Length of the growing season",
    description="{freq} number of days between the first occurrence of at least "
                "{window} consecutive days with mean daily temperature over "
                "{thresh} and the first occurrence of at least {window} "
                "consecutive days with mean daily temperature below {thresh}, "
                "occurring after {mid_date}.",
    compute=indices.growing_season_length,
)

frost_season_length = Temp(
    identifier="frost_season_length",
    title="Frost season length",
    units="days",
    long_name="Length of the frost season",
    description="{freq} number of days between the first occurrence of at least "
                "{window} consecutive days with minimum daily temperature below "
                "freezing and the first occurrence of at least {window} "
                "consecutive days with minimum daily temperature above freezing "
                "after {mid_date}.",
    compute=indices.frost_season_length,
)

frost_free_season_start = Temp(
    identifier="frost_free_season_start",
    title="Frost-free season start",
    units="1",
    long_name="First day of the frost-free season",
    description="Day of year of the start of the frost-free season (minimum "
                "temperature at or above {thresh} for {window} consecutive days).",
    compute=indices.frost_free_season_start,
)

frost_free_season_end = Temp(
    identifier="frost_free_season_end",
    title="Frost-free season end",
    units="1",
    long_name="Last day of the frost-free season",
    description="Day of year of the end of the frost-free season.",
    compute=indices.frost_free_season_end,
)

frost_free_season_length = Temp(
    identifier="frost_free_season_length",
    title="Frost-free season length",
    units="days",
    long_name="Length of the frost-free season",
    description="{freq} length of the frost-free season.",
    compute=indices.frost_free_season_length,
)

last_spring_frost = Temp(
    identifier="last_spring_frost",
    title="Last spring frost",
    units="1",
    long_name="Last day of minimum temperature below {thresh}",
    description="Day of year of the last spring frost (minimum temperature below "
                "{thresh} before {before_date}).",
    compute=indices.last_spring_frost,
)

first_day_tn_above = Temp(
    identifier="first_day_tn_above",
    title="First day with minimum temperature above a threshold",
    units="1",
    long_name="First day of year with minimum temperature above {thresh}",
    description="First day of year with minimum temperature above {thresh} for "
                "at least {window} days.",
    compute=indices.first_day_temperature_above,
    parameters={"tas": {"description": "Minimum daily temperature."}},
)

first_day_tg_above = Temp(
    identifier="first_day_tg_above",
    title="First day with mean temperature above a threshold",
    units="1",
    long_name="First day of year with mean temperature above {thresh}",
    description="First day of year with mean temperature above {thresh} for at "
                "least {window} days.",
    compute=indices.first_day_temperature_above,
)

first_day_tx_above = Temp(
    identifier="first_day_tx_above",
    title="First day with maximum temperature above a threshold",
    units="1",
    long_name="First day of year with maximum temperature above {thresh}",
    description="First day of year with maximum temperature above {thresh} for "
                "at least {window} days.",
    compute=indices.first_day_temperature_above,
)

freshet_start = Temp(
    identifier="freshet_start",
    title="Freshet start",
    units="1",
    long_name="First day where temperature threshold of {thresh} is exceeded for "
              "at least {window} days",
    description="Day of year of the spring freshet start (mean temperature above "
                "{thresh} for {window} consecutive days).",
    compute=indices.first_day_temperature_above,
    parameters={"thresh": "0 degC", "window": 5},
)

daily_temperature_range = TempWithIndexing(
    identifier="dtr",
    title="Mean of daily temperature range",
    units="K",
    long_name="Mean diurnal temperature range",
    description="{freq} mean diurnal temperature range.",
    cell_methods="time: range within days time: mean over days",
    compute=indices.daily_temperature_range,
    parameters={"op": "mean"},
)

max_daily_temperature_range = TempWithIndexing(
    identifier="dtrmax",
    title="Maximum of daily temperature range",
    units="K",
    long_name="Maximum diurnal temperature range",
    description="{freq} maximum diurnal temperature range.",
    cell_methods="time: range within days time: max over days",
    compute=indices.daily_temperature_range,
    parameters={"op": "max"},
)

daily_temperature_range_variability = TempWithIndexing(
    identifier="dtrvar",
    title="Variability of daily temperature range",
    units="K",
    long_name="Mean absolute day-to-day variation in daily temperature range",
    description="{freq} mean absolute day-to-day variation in daily temperature "
                "range.",
    compute=indices.daily_temperature_range_variability,
)

extreme_temperature_range = TempWithIndexing(
    identifier="etr",
    title="Extreme temperature range",
    units="K",
    long_name="Intra-period extreme temperature range",
    description="{freq} range between the maximum of daily maximum temperature "
                "and the minimum of daily minimum temperature.",
    compute=indices.extreme_temperature_range,
)

tx_tn_days_above = TempWithIndexing(
    identifier="tx_tn_days_above",
    title="Days with hot maximum and minimum temperature",
    units="days",
    long_name="Number of days with maximum temperature above {thresh_tasmax} and "
              "minimum temperature above {thresh_tasmin}",
    description="{freq} number of days with maximum temperature above "
                "{thresh_tasmax} and minimum temperature above {thresh_tasmin}.",
    compute=indices.tx_tn_days_above,
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

degree_days_exceedance_date = Temp(
    identifier="degree_days_exceedance_date",
    title="Degree day exceedance date",
    units="1",
    long_name="Day of year when the integral of mean daily temperature "
              "{op} {thresh} exceeds {sum_thresh}",
    description="Day of year when the integral of degree days (mean temperature "
                "{op} {thresh}) exceeds {sum_thresh}.",
    compute=indices.degree_days_exceedance_date,
)


tropical_nights = TempWithIndexing(
    identifier="tropical_nights",
    title="Tropical nights",
    units="days",
    long_name="Number of days with minimum temperature above {thresh}",
    description="{freq} number of tropical nights (minimum temperature above "
                "{thresh}).",
    cell_methods="time: sum over days",
    compute=indices.tn_days_above,
    parameters={"thresh": {"default": "20.0 degC"}},
)

maximum_consecutive_warm_days = Temp(
    identifier="maximum_consecutive_warm_days",
    title="Maximum consecutive warm days",
    units="days",
    long_name="Maximum number of consecutive days with maximum temperature "
              "above {thresh}",
    description="{freq} longest spell of consecutive days with maximum "
                "temperature above {thresh}.",
    compute=indices.maximum_consecutive_tx_days,
)

cold_and_dry_days = TempWithIndexing(
    identifier="cold_and_dry_days",
    title="Cold and dry days",
    units="days",
    long_name="Number of days where temperature is below the 25th percentile "
              "and precipitation below the 25th percentile",
    description="{freq} number of days with cold (< 25th percentile) and dry "
                "(< 25th percentile) conditions.",
    compute=indices.cold_and_dry_days,
)

warm_and_dry_days = TempWithIndexing(
    identifier="warm_and_dry_days",
    title="Warm and dry days",
    units="days",
    long_name="Number of days with warm (> 75th percentile) and dry "
              "(< 25th percentile) conditions",
    description="{freq} number of days with warm and dry conditions.",
    compute=indices.warm_and_dry_days,
)

warm_and_wet_days = TempWithIndexing(
    identifier="warm_and_wet_days",
    title="Warm and wet days",
    units="days",
    long_name="Number of days with warm (> 75th percentile) and wet "
              "(> 75th percentile) conditions",
    description="{freq} number of days with warm and wet conditions.",
    compute=indices.warm_and_wet_days,
)

cold_and_wet_days = TempWithIndexing(
    identifier="cold_and_wet_days",
    title="Cold and wet days",
    units="days",
    long_name="Number of days with cold (< 25th percentile) and wet "
              "(> 75th percentile) conditions",
    description="{freq} number of days with cold and wet conditions.",
    compute=indices.cold_and_wet_days,
)



# ---------------------------------------------------------------------------
# additional reference indicators (xclim:_temperature.py, second half)
# ---------------------------------------------------------------------------

first_day_tg_below = Temp(
    identifier="first_day_tg_below",
    title="First day with mean temperature below a threshold",
    units="1",
    long_name="First day of year with mean temperature below {thresh}",
    description="First day of year with mean temperature below {thresh} for "
                "at least {window} days.",
    compute=indices.first_day_temperature_below,
    parameters={"thresh": {"default": "0 degC"}},
)

first_day_tn_below = Temp(
    identifier="first_day_tn_below",
    title="First day with minimum temperature below a threshold",
    units="1",
    long_name="First day of year with minimum temperature below {thresh}",
    description="First day of year with minimum temperature below {thresh} "
                "for at least {window} days.",
    compute=indices.first_day_temperature_below,
    input={"tas": "tasmin"},
    parameters={"thresh": {"default": "0 degC"}},
)

first_day_tx_below = Temp(
    identifier="first_day_tx_below",
    title="First day with maximum temperature below a threshold",
    units="1",
    long_name="First day of year with maximum temperature below {thresh}",
    description="First day of year with maximum temperature below {thresh} "
                "for at least {window} days.",
    compute=indices.first_day_temperature_below,
    input={"tas": "tasmax"},
    parameters={"thresh": {"default": "0 degC"}},
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

late_frost_days = TempWithIndexing(
    identifier="late_frost_days",
    title="Late frost days",
    units="days",
    standard_name="days_with_air_temperature_below_threshold",
    long_name="Number of days where the daily minimum temperature is below "
              "{thresh}",
    description="{freq} number of days where the daily minimum temperature "
                "is below {thresh} over the period {indexer}.",
    cell_methods="time: sum over days",
    compute=indices.frost_days,
)

freezing_degree_days = TempWithIndexing(
    identifier="freezing_degree_days",
    title="Freezing degree days",
    units="K days",
    standard_name="integral_of_air_temperature_deficit_wrt_time",
    long_name="Cumulative sum of temperature degrees for mean daily "
              "temperature below {thresh}",
    description="{freq} freezing degree days (mean temperature below "
                "{thresh}).",
    cell_methods="time: sum over days",
    compute=indices.heating_degree_days,
    parameters={"thresh": {"default": "0 degC"}},
)

thawing_degree_days = TempWithIndexing(
    identifier="thawing_degree_days",
    title="Thawing degree days",
    units="K days",
    standard_name="integral_of_air_temperature_excess_wrt_time",
    long_name="Cumulative sum of temperature degrees for mean daily "
              "temperature above {thresh}",
    description="{freq} thawing degree days (mean temperature above "
                "{thresh}).",
    cell_methods="time: sum over days",
    compute=indices.growing_degree_days,
    parameters={"thresh": {"default": "0 degC"}},
)

cooling_degree_days_approximation = TempWithIndexing(
    identifier="cooling_degree_days_approximation",
    title="Cooling degree days approximation",
    units="K days",
    long_name="Cooling degree days approximated from min and max temperature",
    description="{freq} cooling degree days approximated from daily minimum, "
                "maximum and mean temperatures (UK Met Office method), above "
                "{thresh}.",
    cell_methods="time: sum over days",
    compute=indices.cooling_degree_days_approximation,
)

heating_degree_days_approximation = TempWithIndexing(
    identifier="heating_degree_days_approximation",
    title="Heating degree days approximation",
    units="K days",
    long_name="Heating degree days approximated from min and max temperature",
    description="{freq} heating degree days approximated from daily minimum, "
                "maximum and mean temperatures (UK Met Office method), below "
                "{thresh}.",
    cell_methods="time: sum over days",
    compute=indices.heating_degree_days_approximation,
)

dlyfrzthw = TempWithIndexing(
    identifier="dlyfrzthw",
    title="Daily freeze-thaw cycles",
    units="days",
    long_name="Number of days with a diurnal freeze-thaw cycle",
    description="{freq} number of days with a diurnal freeze-thaw cycle: "
                "maximum daily temperature above {thresh_tasmax} and minimum "
                "daily temperature at or below {thresh_tasmin}.",
    compute=indices.multiday_temperature_swing,
    parameters={"op": "sum", "window": 1,
                "thresh_tasmax": {"default": "0 degC"},
                "thresh_tasmin": {"default": "0 degC"},
                "op_tasmax": {"default": ">"},
                "op_tasmin": {"default": "<="}},
)

# reference module-attribute name for the dlyfrzthw indicator
# (xclim:indicators/atmos/_temperature.py:721)
daily_freezethaw_cycles = dlyfrzthw

freezethaw_spell_frequency = Temp(
    identifier="freezethaw_spell_frequency",
    title="Freeze-thaw spell frequency",
    units="days",
    long_name="Number of freeze-thaw spells of at least {window} days",
    description="{freq} number of freeze-thaw spells: maximum daily "
                "temperature above {thresh_tasmax} and minimum daily "
                "temperature at or below {thresh_tasmin} for at least "
                "{window} consecutive day(s).",
    compute=indices.multiday_temperature_swing,
    parameters={"op": "count",
                "thresh_tasmax": {"default": "0 degC"},
                "thresh_tasmin": {"default": "0 degC"},
                "op_tasmax": {"default": ">"},
                "op_tasmin": {"default": "<="}},
)

freezethaw_spell_mean_length = Temp(
    identifier="freezethaw_spell_mean_length",
    title="Freeze-thaw spell mean length",
    units="days",
    long_name="Average length of freeze-thaw spells of at least {window} days",
    description="{freq} average length of freeze-thaw spells: maximum daily "
                "temperature above {thresh_tasmax} and minimum daily "
                "temperature at or below {thresh_tasmin} for at least "
                "{window} consecutive day(s).",
    compute=indices.multiday_temperature_swing,
    parameters={"op": "mean",
                "thresh_tasmax": {"default": "0 degC"},
                "thresh_tasmin": {"default": "0 degC"},
                "op_tasmax": ">", "op_tasmin": "<="},
)

freezethaw_spell_max_length = Temp(
    identifier="freezethaw_spell_max_length",
    title="Freeze-thaw spell maximum length",
    units="days",
    long_name="Maximal length of freeze-thaw spells of at least {window} days",
    description="{freq} maximal length of freeze-thaw spells: maximum daily "
                "temperature above {thresh_tasmax} and minimum daily "
                "temperature at or below {thresh_tasmin} for at least "
                "{window} consecutive day(s).",
    compute=indices.multiday_temperature_swing,
    parameters={"op": "max",
                "thresh_tasmax": {"default": "0 degC"},
                "thresh_tasmin": {"default": "0 degC"},
                "op_tasmax": ">", "op_tasmin": "<="},
)

frost_free_spell_max_length = Temp(
    identifier="frost_free_spell_max_length",
    title="Frost-free spell maximum length",
    units="days",
    long_name="Maximal length of frost-free spells of at least {window} days",
    description="{freq} maximal length of spells with minimum temperature at "
                "or above {thresh} for at least {window} consecutive day(s).",
    compute=indices.frost_free_spell_max_length,
)

heat_spell_frequency = Temp(
    identifier="heat_spell_frequency",
    title="Heat spell frequency",
    units="",
    long_name="Number of heat spells",
    description="{freq} number of heat spells: {window}-day averages of "
                "daily minimum and maximum temperatures each exceeding "
                "{threshold1} and {threshold2}.",
    keywords="health",
    compute=indices.generic.bivariate_spell_length_statistics,
    input={"data1": "tasmin", "data2": "tasmax"},
    parameters={"spell_reducer": "count", "op": ">=",
                "window": {"default": 3},
                "win_reducer": {"default": "mean"},
                "freq": {"default": "YS"},
                "threshold1": {"default": "20 degC"},
                "threshold2": {"default": "33 degC"}},
)

heat_spell_max_length = Temp(
    identifier="heat_spell_max_length",
    title="Heat spell maximum length",
    units="days",
    long_name="Longest heat spell",
    description="{freq} longest heat spell: {window}-day averages of daily "
                "minimum and maximum temperatures each exceeding {threshold1} "
                "and {threshold2}.",
    keywords="health",
    compute=indices.generic.bivariate_spell_length_statistics,
    input={"data1": "tasmin", "data2": "tasmax"},
    parameters={"spell_reducer": "max", "op": ">=",
                "window": {"default": 3},
                "win_reducer": {"default": "mean"},
                "freq": {"default": "YS"},
                "threshold1": {"default": "20 degC"},
                "threshold2": {"default": "33 degC"}},
)

heat_spell_total_length = Temp(
    identifier="heat_spell_total_length",
    title="Heat spell total length",
    units="days",
    long_name="Total length of heat spells",
    description="{freq} total length of heat spells: {window}-day averages "
                "of daily minimum and maximum temperatures each exceeding "
                "{threshold1} and {threshold2}.",
    keywords="health",
    compute=indices.generic.bivariate_spell_length_statistics,
    input={"data1": "tasmin", "data2": "tasmax"},
    parameters={"spell_reducer": "sum", "op": ">=",
                "window": {"default": 3},
                "win_reducer": {"default": "mean"},
                "freq": {"default": "YS"},
                "threshold1": {"default": "20 degC"},
                "threshold2": {"default": "33 degC"}},
)

fire_season = Temp(
    identifier="fire_season",
    title="Fire season mask",
    units="",
    long_name="Fire season mask",
    description="Fire season mask, computed with method {method}.",
    missing="skip",
    compute=indices.fire_season,
)


# ---------------------------------------------------------------------------
# agroclimatic indicators (xclim:_temperature.py; compute in indices/_agro.py)
# ---------------------------------------------------------------------------


class HourlyTemp(Hourly):
    """Hourly temperature indicator (chill models;
    xclim:_temperature.py:884)."""

    realm = "atmos"
    keywords = "temperature agriculture"


huglin_index = Temp(
    identifier="huglin_index",
    title="Huglin heliothermal index",
    units="",
    long_name="Huglin heliothermal index",
    description="Heat-summation index for viticulture (Huglin).",
    compute=indices.huglin_index,
)

biologically_effective_degree_days = Temp(
    identifier="biologically_effective_degree_days",
    title="Biologically effective degree days",
    units="K days",
    long_name="Biologically effective growing degree days",
    description="Considers daily tasmin/tasmax with latitude-adjusted degree "
                "days between {start_date} and {end_date}.",
    compute=indices.biologically_effective_degree_days,
)

latitude_temperature_index = Temp(
    identifier="latitude_temperature_index",
    title="Latitude temperature index",
    units="",
    var_name="lti",
    long_name="Mean temperature of warmest month multiplied by the "
              "difference of {lat_factor} minus latitude",
    description="A viticulture suitability index: mean temperature of the "
                "warmest month multiplied by ({lat_factor} - latitude).",
    allowed_periods=["Y"],
    compute=indices.latitude_temperature_index,
    parameters={"lat_factor": 60},
)

usda_hardiness_zones = Temp(
    identifier="usda_hardiness_zones",
    title="USDA hardiness zones",
    units="",
    var_name="hz",
    long_name="Hardiness zones",
    description="Plant-suitability classification from a {window}-year "
                "rolling average of the annual minimum temperature (USDA "
                "10-degF zones with half-zones).",
    allowed_periods=["Y"],
    compute=indices.hardiness_zones,
    parameters={"method": "usda"},
)

australian_hardiness_zones = Temp(
    identifier="australian_hardiness_zones",
    title="Australian hardiness zones",
    units="",
    var_name="hz",
    long_name="Hardiness zones",
    description="Plant-suitability classification from a {window}-year "
                "rolling average of the annual minimum temperature (ANBG "
                "5-degC zones).",
    allowed_periods=["Y"],
    compute=indices.hardiness_zones,
    parameters={"method": "anbg"},
)

cool_night_index = Temp(
    identifier="cool_night_index",
    title="Cool night index",
    units="degC",
    long_name="Mean minimum temperature in late summer",
    description="Mean minimum temperature in September (northern hemisphere) "
                "or March (southern hemisphere); a viticulture ripening "
                "index.",
    allowed_periods=["Y"],
    compute=indices.cool_night_index,
)

corn_heat_units = Temp(
    identifier="corn_heat_units",
    title="Corn heat units",
    units="",
    long_name="Corn heat units (Tmin > {thresh_tasmin} and Tmax > "
              "{thresh_tasmax})",
    description="Temperature-based index of crop development for corn, from "
                "daily minimum and maximum temperatures.",
    missing="skip",
    compute=indices.corn_heat_units,
)

effective_growing_degree_days = Temp(
    identifier="effective_growing_degree_days",
    title="Effective growing degree days",
    units="K days",
    var_name="egdd",
    long_name="Integral of mean daily temperature above {thresh} between "
              "dynamically-determined season start and end dates",
    description="{freq} heat-summation between a {method}-determined growing "
                "season start and the first fall frost after {after_date}.",
    compute=indices.effective_growing_degree_days,
)

cp = HourlyTemp(
    identifier="cp",
    title="Chill portions",
    units="",
    long_name="Chill portions after the Dynamic Model",
    description="Chill portions estimate the bud-breaking potential of "
                "crops via the two-step dynamic model of cold-temperature "
                "accumulation (requires hourly temperature).",
    cell_methods="time: sum",
    allowed_periods=["Y"],
    missing="skip",
    compute=indices.chill_portions,
)

cu = HourlyTemp(
    identifier="cu",
    title="Chill units",
    units="",
    long_name="Chill units after the Utah Model",
    description="Chill units estimate the bud-breaking potential of crops "
                "with the Utah model's hourly temperature weights.",
    cell_methods="time: sum",
    allowed_periods=["Y"],
    missing="skip",
    compute=indices.chill_units,
)
