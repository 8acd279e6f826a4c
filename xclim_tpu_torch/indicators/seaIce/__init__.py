"""Sea-ice indicators (reference: xclim:src/xclim/indicators/seaIce/)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Indicator

__all__ = ["sea_ice_area", "sea_ice_extent"]


class SiconcAreacello(Indicator):
    """Sea-ice indicator on the ocean grid (xclim:seaIce/_seaice.py)."""

    realm = "seaIce"
    keywords = "seaice"
    missing = "skip"


sea_ice_extent = SiconcAreacello(
    identifier="sea_ice_extent",
    title="Sea ice extent",
    units="m2",
    standard_name="sea_ice_extent",
    long_name="Sum of ocean areas where sea ice concentration is at least {thresh}",
    description="The sum of ocean areas where sea ice concentration is at least "
                "{thresh}.",
    compute=indices.sea_ice_extent,
)

sea_ice_area = SiconcAreacello(
    identifier="sea_ice_area",
    title="Sea ice area",
    units="m2",
    standard_name="sea_ice_area",
    long_name="Sum of ice-covered areas where sea ice concentration is at least "
              "{thresh}",
    description="The sum of ice-covered areas where sea ice concentration is at "
                "least {thresh}.",
    compute=indices.sea_ice_area,
)
