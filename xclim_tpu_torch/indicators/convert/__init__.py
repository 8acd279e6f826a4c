"""Conversion indicator declarations
(reference: xclim:src/xclim/indicators/convert/_conversion.py)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Indicator

__all__ = [
    "clearness_index",
    "longwave_upwelling_radiation_from_net_downwelling",
    "mean_temperature_from_max_and_min",
    "shortwave_upwelling_radiation_from_net_downwelling",
    "tdps_from_huss",
    "vapor_pressure",
    "vapor_pressure_deficit",
    "water_budget_from_tas",
    "heat_index",
    "humidex",
    "mean_radiant_temperature",
    "potential_evapotranspiration",
    "rain_approximation",
    "relative_humidity",
    "relative_humidity_from_dewpoint",
    "saturation_vapor_pressure",
    "sfcwind_to_uas_vas",
    "snd_to_snw",
    "snowfall_approximation",
    "snw_to_snd",
    "specific_humidity",
    "specific_humidity_from_dewpoint",
    "tg",
    "uas_vas_to_sfcwind",
    "universal_thermal_climate_index",
    "water_budget",
    "wind_chill_index",
    "wind_power_potential",
    "wind_profile",
]


class Converter(Indicator):
    """Conversion indicator: no resampling, missing check skipped
    (xclim:convert/_conversion.py)."""

    realm = "atmos"
    missing = "skip"


humidex = Converter(
    identifier="humidex",
    title="Humidex",
    units="C",
    long_name="Humidex index",
    description="Humidex index describing the temperature felt by the average "
                "person in response to relative humidity.",
    cell_methods="",
    compute=indices.humidex,
)

heat_index = Converter(
    identifier="heat_index",
    title="Heat index",
    units="C",
    long_name="Heat index",
    description="Perceived temperature after relative humidity is taken into "
                "account.",
    compute=indices.heat_index,
)

tg = Converter(
    identifier="tg",
    title="Mean temperature",
    units="K",
    standard_name="air_temperature",
    long_name="Daily mean temperature",
    description="Estimated mean temperature from maximum and minimum "
                "temperatures.",
    cell_methods="time: mean within days",
    compute=indices.tas_from_tasmin_tasmax,
)

uas_vas_to_sfcwind = Converter(
    identifier="wind_speed_from_vector",
    title="Wind speed and direction from vector",
    cf_attrs=[
        {"var_name": "sfcWind", "units": "m s-1", "standard_name": "wind_speed",
         "long_name": "Near-surface wind speed"},
        {"var_name": "sfcWindfromdir", "units": "degree",
         "standard_name": "wind_from_direction",
         "long_name": "Near-surface wind from direction"},
    ],
    compute=indices.uas_vas_to_sfcwind,
)

sfcwind_to_uas_vas = Converter(
    identifier="wind_vector_from_speed",
    title="Wind vector from speed and direction",
    cf_attrs=[
        {"var_name": "uas", "units": "m s-1", "standard_name": "eastward_wind",
         "long_name": "Near-surface eastward wind"},
        {"var_name": "vas", "units": "m s-1", "standard_name": "northward_wind",
         "long_name": "Near-surface northward wind"},
    ],
    compute=indices.sfcwind_to_uas_vas,
)

saturation_vapor_pressure = Converter(
    identifier="e_sat",
    title="Saturation vapor pressure",
    units="Pa",
    long_name="Saturation vapor pressure",
    description="Saturation vapor pressure calculated from temperature with "
                "the {method} method.",
    compute=indices.saturation_vapor_pressure,
)

relative_humidity = Converter(
    identifier="hurs",
    title="Relative humidity",
    units="%",
    standard_name="relative_humidity",
    long_name="Relative humidity",
    description="Relative humidity computed from temperature, specific "
                "humidity and pressure ({method} method).",
    compute=indices.relative_humidity,
    parameters={"tdps": None},
)

relative_humidity_from_dewpoint = Converter(
    identifier="hurs_fromdewpoint",
    title="Relative humidity from dewpoint",
    units="%",
    standard_name="relative_humidity",
    long_name="Relative humidity",
    description="Relative humidity computed from temperature and dewpoint "
                "temperature.",
    compute=indices.relative_humidity,
    parameters={"huss": None, "ps": None},
)

specific_humidity = Converter(
    identifier="huss",
    title="Specific humidity",
    units="1",
    standard_name="specific_humidity",
    long_name="Specific humidity",
    description="Specific humidity from temperature, relative humidity and "
                "pressure.",
    compute=indices.specific_humidity,
)

specific_humidity_from_dewpoint = Converter(
    identifier="huss_fromdewpoint",
    title="Specific humidity from dewpoint",
    units="1",
    standard_name="specific_humidity",
    long_name="Specific humidity",
    description="Specific humidity from dewpoint temperature and pressure.",
    compute=indices.specific_humidity_from_dewpoint,
)

snowfall_approximation = Converter(
    identifier="prsn",
    title="Snowfall approximation",
    units="kg m-2 s-1",
    standard_name="snowfall_flux",
    long_name="Solid precipitation",
    description="Solid precipitation estimated from total precipitation and "
                "temperature ({method} method, {thresh} threshold).",
    compute=indices.snowfall_approximation,
)

rain_approximation = Converter(
    identifier="prlp",
    title="Rainfall approximation",
    units="kg m-2 s-1",
    standard_name="rainfall_flux",
    long_name="Liquid precipitation",
    description="Liquid precipitation estimated from total precipitation and "
                "temperature ({method} method, {thresh} threshold).",
    compute=indices.rain_approximation,
)

snd_to_snw = Converter(
    identifier="snd_to_snw",
    var_name="snw",
    title="Snow amount from snow depth",
    units="kg m-2",
    standard_name="surface_snow_amount",
    long_name="Surface snow amount",
    description="Snow amount from snow depth and density.",
    compute=indices.snd_to_snw,
)

snw_to_snd = Converter(
    identifier="snw_to_snd",
    var_name="snd",
    title="Snow depth from snow amount",
    units="m",
    standard_name="surface_snow_thickness",
    long_name="Surface snow thickness",
    description="Snow depth from snow amount and density.",
    compute=indices.snw_to_snd,
)

wind_chill_index = Converter(
    identifier="wind_chill",
    title="Wind chill",
    units="degC",
    long_name="Wind chill index",
    description="Wind chill factor ({method} method).",
    compute=indices.wind_chill_index,
)

potential_evapotranspiration = Converter(
    identifier="potential_evapotranspiration",
    title="Potential evapotranspiration",
    units="kg m-2 s-1",
    standard_name="water_potential_evapotranspiration_flux",
    long_name="Potential evapotranspiration",
    description="Potential evapotranspiration ({method} method).",
    compute=indices.converters.potential_evapotranspiration,
)

water_budget = Converter(
    identifier="water_budget",
    title="Water budget",
    units="kg m-2 s-1",
    long_name="Water budget",
    description="Precipitation minus potential evapotranspiration.",
    compute=indices.converters.water_budget,
)

universal_thermal_climate_index = Converter(
    identifier="utci",
    title="Universal Thermal Climate Index",
    units="K",
    long_name="Universal Thermal Climate Index",
    description="UTCI temperature-equivalent of the thermal condition felt by "
                "the human body.",
    compute=indices.universal_thermal_climate_index,
)

mean_radiant_temperature = Converter(
    identifier="mean_radiant_temperature",
    title="Mean radiant temperature",
    units="K",
    long_name="Mean radiant temperature",
    description="Mean radiant temperature from radiative fluxes ({stat}).",
    compute=indices.mean_radiant_temperature,
)

wind_profile = Converter(
    identifier="wind_profile",
    title="Wind profile",
    units="m s-1",
    long_name="Wind speed at height {h}",
    description="Wind speed at {h} computed from the speed at {h_r} with the "
                "power law.",
    compute=indices.wind_profile,
)

wind_power_potential = Converter(
    identifier="wind_power_potential",
    title="Wind power potential",
    units="",
    long_name="Wind power potential",
    description="Fraction of rated turbine power producible from the wind "
                "speed.",
    compute=indices.wind_power_potential,
)


vapor_pressure = Converter(
    identifier="vapor_pressure",
    title="Vapor pressure",
    units="Pa",
    standard_name="water_vapor_partial_pressure_in_air",
    long_name="Water vapor partial pressure",
    description="Water vapor partial pressure computed from specific "
                "humidity and pressure.",
    compute=indices.vapor_pressure,
)

vapor_pressure_deficit = Converter(
    identifier="vapor_pressure_deficit",
    title="Vapor pressure deficit",
    units="Pa",
    standard_name="water_vapor_saturation_deficit_in_air",
    long_name="Water vapor saturation deficit",
    description="Difference between saturation and actual vapor pressure "
                "({method} method).",
    compute=indices.vapor_pressure_deficit,
)

tdps_from_huss = Converter(
    identifier="tdps_from_huss",
    title="Dewpoint temperature from specific humidity",
    units="K",
    standard_name="dew_point_temperature",
    long_name="Dewpoint temperature",
    description="Dewpoint temperature from specific humidity and pressure "
                "({method} method).",
    compute=indices.dewpoint_from_specific_humidity,
)

longwave_upwelling_radiation_from_net_downwelling = Converter(
    identifier="longwave_upwelling_radiation_from_net_downwelling",
    title="Upwelling longwave radiation",
    units="W m-2",
    standard_name="surface_upwelling_longwave_flux",
    long_name="Upwelling longwave flux",
    description="Upwelling longwave radiation from net and downwelling "
                "longwave fluxes.",
    compute=indices.longwave_upwelling_radiation_from_net_downwelling,
)

shortwave_upwelling_radiation_from_net_downwelling = Converter(
    identifier="shortwave_upwelling_radiation_from_net_downwelling",
    title="Upwelling shortwave radiation",
    units="W m-2",
    standard_name="surface_upwelling_shortwave_flux",
    long_name="Upwelling shortwave flux",
    description="Upwelling shortwave radiation from net and downwelling "
                "shortwave fluxes.",
    compute=indices.shortwave_upwelling_radiation_from_net_downwelling,
)

clearness_index = Converter(
    identifier="clearness_index",
    title="Clearness index",
    units="",
    long_name="Clearness index",
    description="Ratio of shortwave downwelling radiation to "
                "extraterrestrial radiation.",
    compute=indices.clearness_index,
)

mean_temperature_from_max_and_min = Converter(
    identifier="mean_temperature_from_max_and_min",
    title="Mean temperature from maximum and minimum temperatures",
    units="K",
    standard_name="air_temperature",
    long_name="Daily mean temperature",
    description="Estimated mean daily temperature from maximum and minimum "
                "temperatures.",
    cell_methods="time: mean within days",
    compute=indices.tas_from_tasmin_tasmax,
)

water_budget_from_tas = Converter(
    identifier="water_budget_from_tas",
    title="Water budget from temperature",
    units="kg m-2 s-1",
    long_name="Water budget ({method} method)",
    description="Precipitation minus potential evapotranspiration estimated "
                "from temperature ({method} method).",
    compute=indices.converters.water_budget,
    parameters={"evspsblpot": None},
)
