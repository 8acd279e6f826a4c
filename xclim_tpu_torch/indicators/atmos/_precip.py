"""Precipitation indicator declarations
(reference: xclim:src/xclim/indicators/atmos/_precip.py)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Daily, Hourly, ResamplingIndicatorWithIndexing

__all__ = [
    "api",
    "aridity_index",
    "cffwis",
    "days_over_precip_doy_thresh",
    "days_with_snow",
    "dc",
    "df",
    "dmc",
    "dryness_index",
    "ffdi",
    "first_snowfall",
    "fraction_over_precip_doy_thresh",
    "kbdi",
    "last_snowfall",
    "liquid_precip_ratio",
    "liquidprcpavg",
    "rain_season",
    "rprctot",
    "snowfall_frequency",
    "snowfall_intensity",
    "solidprcpavg",
    "spei",
    "spi",
    "water_cycle_intensity",
    "cdd",
    "cwd",
    "daily_pr_intensity",
    "days_over_precip_thresh",
    "dry_days",
    "dry_spell_frequency",
    "dry_spell_max_length",
    "dry_spell_total_length",
    "fraction_over_precip_thresh",
    "high_precip_low_temp",
    "liquid_precip_accumulation",
    "max_1day_precipitation_amount",
    "max_n_day_precipitation_amount",
    "max_pr_intensity",
    "precip_accumulation",
    "precip_average",
    "rain_on_frozen_ground_days",
    "solid_precip_accumulation",
    "wet_spell_frequency",
    "wet_spell_max_length",
    "wet_spell_total_length",
    "wetdays",
    "wetdays_prop",
    "wet_prcptot",
]


class Precip(Daily):
    """Daily precipitation indicator (xclim:_precip.py)."""

    realm = "atmos"
    keywords = "precipitation"
    context = "hydro"


class PrecipWithIndexing(ResamplingIndicatorWithIndexing):
    realm = "atmos"
    keywords = "precipitation"
    src_freq = "D"
    context = "hydro"


class HrPrecip(Hourly):
    """Indicator on hourly pr series (xclim:atmos/_precip.py:120)."""

    realm = "atmos"
    context = "hydro"
    keywords = "precipitation"
    src_freq = "h"


precip_accumulation = PrecipWithIndexing(
    identifier="prcptot",
    title="Total accumulated precipitation",
    units="mm",
    standard_name="lwe_thickness_of_precipitation_amount",
    long_name="Total accumulated precipitation",
    description="{freq} total precipitation.",
    cell_methods="time: sum over days",
    compute=indices.precip_accumulation,
)

liquid_precip_accumulation = PrecipWithIndexing(
    identifier="liquidprcptot",
    title="Total accumulated liquid precipitation",
    units="mm",
    standard_name="lwe_thickness_of_rainfall_amount",
    long_name="Total accumulated liquid precipitation",
    description="{freq} total liquid precipitation (temperature above {thresh}).",
    compute=indices.precip_accumulation,
    parameters={"phase": "liquid"},
)

solid_precip_accumulation = PrecipWithIndexing(
    identifier="solidprcptot",
    title="Total accumulated solid precipitation",
    units="mm",
    standard_name="lwe_thickness_of_snowfall_amount",
    long_name="Total accumulated solid precipitation",
    description="{freq} total solid precipitation (temperature below {thresh}).",
    compute=indices.precip_accumulation,
    parameters={"phase": "solid"},
)

precip_average = PrecipWithIndexing(
    identifier="prcpavg",
    title="Averaged precipitation amount",
    units="mm",
    long_name="Averaged precipitation amount",
    description="{freq} mean precipitation amount.",
    compute=indices.precip_average,
)

wetdays = PrecipWithIndexing(
    identifier="wetdays",
    title="Number of wet days",
    units="days",
    long_name="Number of days with precipitation at or above {thresh}",
    description="{freq} number of days with precipitation at or above {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.wetdays,
)

wetdays_prop = PrecipWithIndexing(
    identifier="wetdays_prop",
    title="Proportion of wet days",
    units="1",
    long_name="Proportion of days with precipitation at or above {thresh}",
    description="{freq} proportion of days with precipitation at or above {thresh}.",
    compute=indices.wetdays_prop,
)

dry_days = PrecipWithIndexing(
    identifier="dry_days",
    title="Number of dry days",
    units="days",
    long_name="Number of days with precipitation below {thresh}",
    description="{freq} number of days with precipitation below {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.dry_days,
)

max_1day_precipitation_amount = PrecipWithIndexing(
    identifier="rx1day",
    title="Maximum 1-day precipitation amount",
    units="mm/day",
    standard_name="lwe_precipitation_rate",
    long_name="Maximum 1-day total precipitation",
    description="{freq} maximum 1-day total precipitation.",
    cell_methods="time: maximum over days",
    compute=indices.max_1day_precipitation_amount,
)

max_n_day_precipitation_amount = Precip(
    identifier="max_n_day_precipitation_amount",
    title="Maximum n-day precipitation amount",
    units="mm",
    standard_name="lwe_thickness_of_precipitation_amount",
    long_name="Maximum {window}-day total precipitation amount",
    description="{freq} maximum {window}-day total precipitation amount.",
    cell_methods="time: maximum over days",
    compute=indices.max_n_day_precipitation_amount,
)

max_pr_intensity = HrPrecip(
    identifier="max_pr_intensity",
    title="Maximum precipitation intensity",
    units="mm h-1",
    long_name="Maximum precipitation intensity over a {window}-window",
    description="{freq} maximum precipitation intensity over a rolling "
                "{window}-window.",
    cell_methods="time: max",
    compute=indices.max_pr_intensity,
)

daily_pr_intensity = PrecipWithIndexing(
    identifier="sdii",
    title="Average precipitation during wet days",
    units="mm d-1",
    long_name="Average precipitation during days with daily precipitation over "
              "{thresh} (simple daily intensity index)",
    description="{freq} average precipitation for days with daily precipitation "
                "over {thresh} (simple daily intensity index).",
    compute=indices.daily_pr_intensity,
)

cdd = Precip(
    identifier="cdd",
    title="Maximum consecutive dry days",
    units="days",
    long_name="Maximum consecutive days with daily precipitation below {thresh}",
    description="{freq} maximum number of consecutive days with daily "
                "precipitation below {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.maximum_consecutive_dry_days,
)

cwd = Precip(
    identifier="cwd",
    title="Maximum consecutive wet days",
    units="days",
    long_name="Maximum consecutive days with daily precipitation at or above "
              "{thresh}",
    description="{freq} maximum number of consecutive days with daily "
                "precipitation at or above {thresh}.",
    cell_methods="time: sum over days",
    compute=indices.maximum_consecutive_wet_days,
)

rain_on_frozen_ground_days = PrecipWithIndexing(
    identifier="rain_frzgr",
    title="Rain on frozen ground days",
    units="days",
    long_name="Number of rain on frozen ground days (mean daily temperature > 0℃ "
              "and precipitation > {thresh})",
    description="{freq} number of days with rain above {thresh} after a series of "
                "seven days with average daily temperature below 0℃.",
    compute=indices.rain_on_frozen_ground_days,
)

high_precip_low_temp = PrecipWithIndexing(
    identifier="high_precip_low_temp",
    title="Days with precipitation and cold temperature",
    units="days",
    long_name="Days with precipitation at or above {pr_thresh} and temperature "
              "below {tas_thresh}",
    description="{freq} number of days with precipitation at or above {pr_thresh} "
                "and temperature below {tas_thresh}.",
    compute=indices.high_precip_low_temp,
)

days_over_precip_thresh = PrecipWithIndexing(
    identifier="days_over_precip_thresh",
    title="Number of days with precipitation above a given percentile",
    units="days",
    long_name="Number of days with precipitation flux above the {pr_per_thresh}th "
              "percentile of {pr_per_period}",
    description="{freq} number of days with precipitation above a daily "
                "percentile threshold.",
    cell_methods="time: sum over days",
    compute=indices.days_over_precip_thresh,
)

fraction_over_precip_thresh = PrecipWithIndexing(
    identifier="fraction_over_precip_thresh",
    title="Fraction of precipitation due to wet days with strong precipitation",
    units="1",
    long_name="Fraction of precipitation due to days with precipitation above a "
              "daily percentile threshold",
    description="{freq} fraction of total precipitation due to days with "
                "precipitation above a daily percentile threshold.",
    compute=indices.fraction_over_precip_thresh,
)

dry_spell_frequency = Precip(
    identifier="dry_spell_frequency",
    title="Dry spell frequency",
    units="",
    long_name="Number of dry periods of {window} day(s) or more",
    description="{freq} number of dry periods of {window} day(s) or more, during "
                "which the accumulated precipitation on a window of {window} "
                "day(s) is below {thresh}.",
    compute=indices.dry_spell_frequency,
)

dry_spell_total_length = Precip(
    identifier="dry_spell_total_length",
    title="Dry spell total length",
    units="days",
    long_name="Number of days in dry periods of {window} day(s) or more",
    description="{freq} number of days in dry periods of {window} day(s) or more.",
    compute=indices.dry_spell_total_length,
)

dry_spell_max_length = Precip(
    identifier="dry_spell_max_length",
    title="Dry spell maximum length",
    units="days",
    long_name="Maximum length of dry spells",
    description="{freq} maximum length of dry spells.",
    compute=indices.dry_spell_max_length,
)

wet_spell_frequency = Precip(
    identifier="wet_spell_frequency",
    title="Wet spell frequency",
    units="",
    long_name="Number of wet periods of {window} day(s) or more",
    description="{freq} number of wet periods of {window} day(s) or more.",
    compute=indices.wet_spell_frequency,
)

wet_spell_total_length = Precip(
    identifier="wet_spell_total_length",
    title="Wet spell total length",
    units="days",
    long_name="Number of days in wet periods of {window} day(s) or more",
    description="{freq} number of days in wet periods of {window} day(s) or more.",
    compute=indices.wet_spell_total_length,
)

wet_spell_max_length = Precip(
    identifier="wet_spell_max_length",
    title="Wet spell maximum length",
    units="days",
    long_name="Maximum length of wet spells",
    description="{freq} maximum length of wet spells.",
    compute=indices.wet_spell_max_length,
)


wet_prcptot = PrecipWithIndexing(
    identifier="wet_prcptot",
    title="Total accumulated precipitation over wet days",
    units="mm",
    long_name="Total accumulated precipitation over days with precipitation at "
              "or above {thresh}",
    description="{freq} total precipitation over wet days (precipitation at or "
                "above {thresh}).",
    compute=indices.prcptot,
    parameters={"thresh": {"default": "1 mm/d"}},
)


# ---------------------------------------------------------------------------
# additional reference indicators (xclim:_precip.py second half: fire, snow,
# standardized indices, ratios)
# ---------------------------------------------------------------------------


class FireWeather(Precip):
    """Fire-weather indicator (CFFWIS / FFDI families)."""

    keywords = "fire"
    missing = "skip"


cffwis = FireWeather(
    identifier="cffwis",
    title="Canadian Forest Fire Weather Index System",
    cf_attrs=[
        {"var_name": "dc", "units": "", "long_name": "Drought code"},
        {"var_name": "dmc", "units": "", "long_name": "Duff moisture code"},
        {"var_name": "ffmc", "units": "",
         "long_name": "Fine fuel moisture code"},
        {"var_name": "isi", "units": "", "long_name": "Initial spread index"},
        {"var_name": "bui", "units": "", "long_name": "Buildup index"},
        {"var_name": "fwi", "units": "", "long_name": "Fire weather index"},
        {"var_name": "dsr", "units": "",
         "long_name": "Daily severity rating"},
    ],
    compute=indices.cffwis_indices,
)

dc = FireWeather(
    identifier="dc",
    title="Drought code",
    units="",
    long_name="Drought code",
    description="Numerical code estimating the average moisture content of "
                "deep, compact organic layers (CFFWIS).",
    compute=indices.drought_code,
)

dmc = FireWeather(
    identifier="dmc",
    title="Duff moisture code",
    units="",
    long_name="Duff moisture code",
    description="Numerical code estimating the average moisture content of "
                "loosely compacted organic layers of moderate depth (CFFWIS).",
    compute=indices.duff_moisture_code,
)

kbdi = FireWeather(
    identifier="kbdi",
    title="Keetch-Byram drought index",
    units="mm/day",
    long_name="Keetch-Byram drought index",
    description="Amount of water necessary to bring the soil moisture "
                "content back to field capacity.",
    compute=indices.keetch_byram_drought_index,
)

df = FireWeather(
    identifier="df",
    title="Griffiths drought factor",
    units="",
    long_name="Griffiths drought factor",
    description="Numeric indicator of the forest fire fuel availability in "
                "the deep litter bed (Griffiths method).",
    compute=indices.griffiths_drought_factor,
)

ffdi = FireWeather(
    identifier="ffdi",
    title="McArthur forest fire danger index",
    units="",
    long_name="McArthur forest fire danger index (Mark 5)",
    description="Numeric rating of the potential danger of a forest fire.",
    compute=indices.mcarthur_forest_fire_danger_index,
)

spi = Precip(
    identifier="spi",
    title="Standardized precipitation index",
    units="",
    standard_name="spi",
    long_name="Standardized precipitation index (SPI)",
    description="Precipitation over a moving {window}-X window, normalized "
                "such that SPI averages to 0 for the calibration data.",
    cell_methods="",
    compute=indices.standardized_precipitation_index,
)

spei = Precip(
    identifier="spei",
    title="Standardized precipitation evapotranspiration index",
    units="",
    standard_name="spei",
    long_name="Standardized precipitation evapotranspiration index (SPEI)",
    description="Water budget (precipitation minus evapotranspiration) over "
                "a moving {window}-X window, normalized such that SPEI "
                "averages to 0 for the calibration data.",
    cell_methods="",
    compute=indices.standardized_precipitation_evapotranspiration_index,
)

rain_season = Precip(
    identifier="rain_season",
    title="Rain season",
    cf_attrs=[
        {"var_name": "rain_season_start", "units": "",
         "long_name": "Day of year of the start of the rain season"},
        {"var_name": "rain_season_end", "units": "",
         "long_name": "Day of year of the end of the rain season"},
        {"var_name": "rain_season_length", "units": "days",
         "long_name": "Length of the rain season"},
    ],
    compute=indices.rain_season,
)

days_over_precip_doy_thresh = PrecipWithIndexing(
    identifier="days_over_precip_doy_thresh",
    title="Days over daily percentile precipitation",
    units="days",
    standard_name="number_of_days_with_lwe_thickness_of_precipitation_amount_"
                  "above_daily_threshold",
    long_name="Number of days with daily precipitation flux above the "
              "{pr_per_thresh}th daily percentile",
    description="{freq} number of days with precipitation above the "
                "{pr_per_thresh}th daily percentile; only days with at least "
                "{thresh} are counted.",
    cell_methods="time: sum over days",
    compute=indices.days_over_precip_thresh,
)

fraction_over_precip_doy_thresh = PrecipWithIndexing(
    identifier="fraction_over_precip_doy_thresh",
    title="Fraction of precipitation due to days over daily percentile",
    units="",
    long_name="Fraction of precipitation due to days with daily "
              "precipitation above the {pr_per_thresh}th daily percentile",
    description="{freq} fraction of total precipitation due to days with "
                "precipitation above the {pr_per_thresh}th daily percentile.",
    cell_methods="",
    compute=indices.fraction_over_precip_thresh,
)

days_with_snow = PrecipWithIndexing(
    identifier="days_with_snow",
    title="Days with snowfall",
    units="days",
    long_name="Number of days with snowfall between {low} and {high} "
              "thresholds",
    description="{freq} number of days with snowfall larger than {low} and "
                "at most {high}.",
    cell_methods="time: sum over days",
    compute=indices.days_with_snow,
)

first_snowfall = PrecipWithIndexing(
    identifier="first_snowfall",
    title="First snowfall",
    units="",
    standard_name="day_of_year",
    long_name="Day of year of the first snowfall at or above {thresh}",
    description="First day of year with snowfall at or above {thresh}.",
    compute=indices.first_snowfall,
)

last_snowfall = PrecipWithIndexing(
    identifier="last_snowfall",
    title="Last snowfall",
    units="",
    standard_name="day_of_year",
    long_name="Day of year of the last snowfall at or above {thresh}",
    description="Last day of year with snowfall at or above {thresh}.",
    compute=indices.last_snowfall,
)

snowfall_frequency = PrecipWithIndexing(
    identifier="snowfall_frequency",
    title="Snowfall frequency",
    units="%",
    long_name="Percentage of days with snowfall at or above {thresh}",
    description="{freq} percentage of days with snowfall at or above "
                "{thresh}.",
    compute=indices.snowfall_frequency,
)

snowfall_intensity = PrecipWithIndexing(
    identifier="snowfall_intensity",
    title="Snowfall intensity",
    units="mm/day",
    long_name="Mean daily snowfall on days with snowfall at or above {thresh}",
    description="{freq} mean daily liquid-water-equivalent snowfall on days "
                "with snowfall at or above {thresh}.",
    compute=indices.snowfall_intensity,
)

liquid_precip_ratio = PrecipWithIndexing(
    identifier="liquid_precip_ratio",
    title="Liquid precipitation ratio",
    units="",
    long_name="Fraction of liquid to total precipitation (temperature above "
              "{thresh})",
    description="{freq} ratio of liquid (temperature above {thresh}) to "
                "total precipitation.",
    cell_methods="",
    compute=indices.liquid_precip_ratio,
)

liquidprcpavg = PrecipWithIndexing(
    identifier="liquidprcpavg",
    title="Mean liquid precipitation",
    units="mm",
    standard_name="lwe_average_of_liquid_precipitation_amount",
    long_name="Mean liquid precipitation (temperature above {thresh})",
    description="{freq} mean liquid precipitation, estimated as "
                "precipitation when temperature is above {thresh}.",
    cell_methods="time: mean over days",
    compute=indices.precip_average,
    parameters={"phase": "liquid"},
)

solidprcpavg = PrecipWithIndexing(
    identifier="solidprcpavg",
    title="Mean solid precipitation",
    units="mm",
    standard_name="lwe_average_of_solid_precipitation_amount",
    long_name="Mean solid precipitation (temperature at or below {thresh})",
    description="{freq} mean solid precipitation, estimated as precipitation "
                "when temperature is at or below {thresh}.",
    cell_methods="time: mean over days",
    compute=indices.precip_average,
    parameters={"phase": "solid"},
)

rprctot = PrecipWithIndexing(
    identifier="rprctot",
    title="Proportion of accumulated precipitation from convective storms",
    units="",
    long_name="Proportion of accumulated precipitation arising from "
              "convective processes",
    description="{freq} proportion of total precipitation due to convective "
                "precipitation, on days with total precipitation at or above "
                "{thresh}.",
    cell_methods="time: sum",
    compute=indices.rprctot,
)

water_cycle_intensity = PrecipWithIndexing(
    identifier="water_cycle_intensity",
    title="Water cycle intensity",
    units="mm",
    long_name="Water cycle intensity",
    description="{freq} sum of precipitation and actual evapotranspiration.",
    cell_methods="time: sum over days",
    compute=indices.water_cycle_intensity,
)

aridity_index = PrecipWithIndexing(
    identifier="aridity_index",
    title="Aridity index",
    units="",
    long_name="Aridity index",
    description="Ratio of precipitation over potential evapotranspiration.",
    allowed_periods=["Y"],
    compute=indices.aridity_index,
)

api = Precip(
    identifier="api",
    title="Antecedent precipitation index",
    units="mm",
    long_name="Antecedent precipitation index",
    description="Weighted summation of daily precipitation over a {window}-"
                "day window (weight {p_exp}^days-ago).",
    missing="skip",
    compute=indices.antecedent_precipitation_index,
)

dryness_index = Precip(
    identifier="dryness_index",
    title="Dryness index",
    units="mm",
    long_name="Growing season humidity",
    description="Estimate of growing-season soil humidity: initial reserve "
                "plus precipitation minus adjusted potential transpiration "
                "and evaporation (April-September, northern hemisphere).",
    allowed_periods=["Y"],
    compute=indices.dryness_index,
)
