"""Official variable vocabulary (CMIP6-style), used by health checks, the
indicator layer and the testing helpers.

Re-derivation of the reference's variable registry
(xclim:src/xclim/data/variables.yml, 47 entries) in compact Python form:
name → (canonical units, CF standard name, cell_methods, description).
"""

from __future__ import annotations

_V = {
    # name: (canonical_units, standard_name, cell_methods)
    "air_density": ("kg m-3", "air_density", "time: mean"),
    "areacella": ("m2", "cell_area", "area: sum"),
    "areacello": ("m2", "cell_area", "area: sum"),
    "ci": ("W m-2", None, "time: mean"),
    "discharge": ("m3 s-1", "water_volume_transport_in_river_channel", "time: mean"),
    "dtr": ("K", "air_temperature", "time: range within days"),
    "evspsbl": ("kg m-2 s-1", "water_evapotranspiration_flux", "time: mean"),
    "evspsblpot": ("kg m-2 s-1", "water_potential_evapotranspiration_flux", "time: mean"),
    "gwl": ("m", None, ""),
    "hurs": ("%", "relative_humidity", "time: mean"),
    "huss": ("1", "specific_humidity", "time: mean"),
    "lat": ("degrees_north", "latitude", ""),
    "pr": ("kg m-2 s-1", "precipitation_flux", "time: mean"),
    "prc": ("kg m-2 s-1", "convective_precipitation_flux", "time: mean"),
    "prsn": ("kg m-2 s-1", "snowfall_flux", "time: mean"),
    "prsnd": ("m s-1", None, "time: mean"),
    "ps": ("Pa", "surface_air_pressure", "time: mean"),
    "psl": ("Pa", "air_pressure_at_sea_level", "time: mean"),
    "rls": ("W m-2", "surface_net_downward_longwave_flux", "time: mean"),
    "rss": ("W m-2", "surface_net_downward_shortwave_flux", "time: mean"),
    "rlds": ("W m-2", "surface_downwelling_longwave_flux", "time: mean"),
    "rsds": ("W m-2", "surface_downwelling_shortwave_flux", "time: mean"),
    "rlus": ("W m-2", "surface_upwelling_longwave_flux", "time: mean"),
    "rsus": ("W m-2", "surface_upwelling_shortwave_flux", "time: mean"),
    "sfcWind": ("m s-1", "wind_speed", "time: mean"),
    "sfcWindmax": ("m s-1", "wind_speed", "time: max"),
    "sfcWindfromdir": ("degree", "wind_from_direction", "time: mean"),
    "siconc": ("%", "sea_ice_area_fraction", "time: mean"),
    "smd": ("mm d-1", "soil_moisture_deficit", "time: mean"),
    "snc": ("%", "surface_snow_area_fraction", "time: mean"),
    "snd": ("m", "surface_snow_thickness", "time: mean"),
    "snr": ("kg m-3", "surface_snow_density", "time: mean"),
    "snw": ("kg m-2", "surface_snow_amount", "time: mean"),
    "sund": ("s", "duration_of_sunshine", "time: mean"),
    "swe": ("m", "lwe_thickness_of_surface_snow_amount", "time: mean"),
    "qspec": ("m s-1", None, "time: mean"),
    "q": ("m3 s-1", "water_volume_transport_in_river_channel", "time: mean"),
    "tas": ("K", "air_temperature", "time: mean"),
    "tasmax": ("K", "air_temperature", "time: maximum"),
    "tasmin": ("K", "air_temperature", "time: minimum"),
    "tdps": ("K", "dew_point_temperature", "time: mean"),
    "thickness_of_rainfall_amount": ("m", "thickness_of_rainfall_amount", "time: sum"),
    "ua": ("m s-1", "eastward_wind", "time: mean"),
    "uas": ("m s-1", "eastward_wind", "time: mean"),
    "vas": ("m s-1", "northward_wind", "time: mean"),
    "wind_speed": ("m s-1", "wind_speed", "time: mean"),
    "wsgsmax": ("m s-1", "wind_speed_of_gust", "time: maximum"),
}

VARIABLES: dict[str, dict] = {
    name: {
        "canonical_units": u,
        "standard_name": sn,
        "cell_methods": cm,
        "description": f"Official variable {name}.",
    }
    for name, (u, sn, cm) in _V.items()
}
