"""Snow indicator declarations (reference: xclim:src/xclim/indicators/land/_snow.py)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Daily, ResamplingIndicatorWithIndexing

__all__ = [
    "holiday_snow_and_snowfall_days",
    "holiday_snow_days",
    "melt_and_precip_max",
    "snd_max_doy",
    "snow_melt_we_max",
    "snw_max",
    "snw_max_doy",
    "blowing_snow",
    "snd_days_above",
    "snd_season_end",
    "snd_season_length",
    "snd_season_start",
    "snd_storm_days",
    "snw_days_above",
    "snw_season_end",
    "snw_season_length",
    "snw_season_start",
    "snw_storm_days",
    "snow_depth",
]


class Snow(Daily):
    realm = "land"
    keywords = "snow"


class SnowWithIndexing(ResamplingIndicatorWithIndexing):
    """Snow indicator with **indexer support (xclim:land/_snow.py)."""

    realm = "land"
    keywords = "snow"
    src_freq = "D"


snd_season_length = SnowWithIndexing(
    identifier="snd_season_length",
    title="Snow cover duration (depth)",
    units="days",
    long_name="Number of days with snow depth at or above {thresh}",
    description="The duration of the snow season, starting with at least {window} "
                "days with snow depth above {thresh} and ending with at least "
                "{window} days with snow depth under {thresh}.",
    compute=indices.snd_season_length,
)

snw_season_length = SnowWithIndexing(
    identifier="snw_season_length",
    title="Snow cover duration (amount)",
    units="days",
    long_name="Number of days with snow amount at or above {thresh}",
    description="The duration of the snow season, defined by snow amount {thresh}.",
    compute=indices.snw_season_length,
)

snd_season_start = Snow(
    identifier="snd_season_start",
    title="Start date of continuous snow depth cover",
    units="1",
    long_name="Start date of continuous snow depth cover",
    description="Day of year when snow depth is above {thresh} for at least "
                "{window} days.",
    compute=indices.snd_season_start,
)

snw_season_start = Snow(
    identifier="snw_season_start",
    title="Start date of continuous snow amount cover",
    units="1",
    long_name="Start date of continuous snow amount cover",
    description="Day of year when snow amount is above {thresh} for at least "
                "{window} days.",
    compute=indices.snw_season_start,
)

snd_season_end = Snow(
    identifier="snd_season_end",
    title="End date of continuous snow depth cover",
    units="1",
    long_name="End date of continuous snow depth cover",
    description="Day of year when snow depth is below {thresh} for at least "
                "{window} days.",
    compute=indices.snd_season_end,
)

snw_season_end = Snow(
    identifier="snw_season_end",
    title="End date of continuous snow amount cover",
    units="1",
    long_name="End date of continuous snow amount cover",
    description="Day of year when snow amount is below {thresh} for at least "
                "{window} days.",
    compute=indices.snw_season_end,
)

snd_storm_days = SnowWithIndexing(
    identifier="snd_storm_days",
    title="Winter storm days (depth)",
    units="days",
    long_name="Days with snowfall depth accumulation at or above {thresh}",
    description="{freq} number of days with snowfall accumulation above {thresh}.",
    compute=indices.snd_storm_days,
)

snw_storm_days = SnowWithIndexing(
    identifier="snw_storm_days",
    title="Winter storm days (amount)",
    units="days",
    long_name="Days with snowfall amount accumulation at or above {thresh}",
    description="{freq} number of days with snowfall amount accumulation above "
                "{thresh}.",
    compute=indices.snw_storm_days,
)

snd_days_above = SnowWithIndexing(
    identifier="snd_days_above",
    title="Days with snow (depth)",
    units="days",
    long_name="Number of days with snow depth at or above {thresh}",
    description="{freq} number of days with snow depth at or above {thresh}.",
    compute=indices.snd_days_above,
)

snw_days_above = SnowWithIndexing(
    identifier="snw_days_above",
    title="Days with snow (amount)",
    units="days",
    long_name="Number of days with snow amount at or above {thresh}",
    description="{freq} number of days with snow amount at or above {thresh}.",
    compute=indices.snw_days_above,
)

blowing_snow = Snow(
    identifier="blowing_snow",
    title="Blowing snow days",
    units="days",
    long_name="Days with snowfall and wind speed at or above given thresholds",
    description="{freq} number of days with snowfall over last {window} days "
                "above {snd_thresh} and wind speed above {sfcWind_thresh}.",
    compute=indices.blowing_snow,
)


snow_depth = SnowWithIndexing(
    identifier="snow_depth",
    title="Mean snow depth",
    units="cm",
    long_name="Mean of daily snow depth",
    description="{freq} mean of daily mean snow depth.",
    cell_methods="time: mean over days",
    compute=indices.snow_depth,
)


snd_max_doy = SnowWithIndexing(
    identifier="snd_max_doy",
    title="Day of year of maximum snow depth",
    units="",
    standard_name="day_of_year",
    var_name="{freq}_snd_max_doy",
    long_name="Day of the year when snow depth reaches its maximum value",
    description="The {freq} day of the year when snow depth reaches its "
                "maximum value.",
    compute=indices.snd_max_doy,
)

snw_max = SnowWithIndexing(
    identifier="snw_max",
    title="Maximum snow amount",
    units="kg m-2",
    standard_name="surface_snow_amount",
    var_name="{freq}_snw_max",
    long_name="Maximum snow amount equivalent",
    description="The {freq} maximum snow amount equivalent on the surface.",
    compute=indices.snw_max,
)

snw_max_doy = SnowWithIndexing(
    identifier="snw_max_doy",
    title="Day of year of maximum snow amount",
    units="",
    standard_name="day_of_year",
    var_name="{freq}_snw_max_doy",
    long_name="Day of the year when snow amount equivalent reaches its "
              "maximum value",
    description="The {freq} day of the year when snow amount equivalent "
                "reaches its maximum value.",
    compute=indices.snw_max_doy,
)

snow_melt_we_max = Snow(
    identifier="snow_melt_we_max",
    title="Maximum snow melt",
    units="kg m-2",
    standard_name="change_over_time_in_surface_snow_amount",
    var_name="{freq}_snow_melt_we_max",
    long_name="Maximum snow melt over a {window}-day window",
    description="The {freq} maximum water-equivalent snow melt over a "
                "{window}-day window.",
    compute=indices.snow_melt_we_max,
)

melt_and_precip_max = Snow(
    identifier="melt_and_precip_max",
    title="Maximum melt and precipitation",
    units="kg m-2",
    var_name="{freq}_melt_and_precip_max",
    long_name="Maximum combined snow melt and precipitation over a "
              "{window}-day window",
    description="The {freq} maximum combined water-equivalent snow melt and "
                "precipitation over a {window}-day window.",
    compute=indices.melt_and_precip_max,
)

holiday_snow_days = Snow(
    identifier="holiday_snow_days",
    title="Christmas snow days",
    units="days",
    long_name="Number of holiday days with snow",
    description="Number of holiday days (between {date_start} and "
                "{date_end}) with snow depth {snd_op} {snd_thresh}.",
    missing="skip",
    compute=indices.holiday_snow_days,
)

holiday_snow_and_snowfall_days = Snow(
    identifier="holiday_snow_and_snowfall_days",
    title="Perfect Christmas snow days",
    units="days",
    long_name="Number of holiday days with snow and snowfall",
    description="Number of holiday days (between {date_start} and "
                "{date_end}) with snow depth {snd_op} {snd_thresh} and "
                "snowfall {prsn_op} {prsn_thresh}.",
    missing="skip",
    compute=indices.holiday_snow_and_snowfall_days,
)
