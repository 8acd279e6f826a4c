"""Synoptic indicator declarations
(reference: xclim:src/xclim/indicators/atmos/_synoptic.py)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Indicator

__all__ = ["jetstream_metric_woollings"]


class JetStream(Indicator):
    """Indicator involving daily u-component wind series
    (xclim:indicators/atmos/_synoptic.py:10-14)."""

    realm = "atmos"
    src_freq = "D"
    missing = "skip"


jetstream_metric_woollings = JetStream(
    title="Strength and latitude of jetstream",
    identifier="jetstream_metric_woollings",
    cf_attrs=[
        {"var_name": "jetlat", "units": "degrees_north",
         "long_name": "Latitude of maximum smoothed zonal wind speed",
         "description": "Daily latitude of maximum Lanczos smoothed zonal "
                        "wind speed."},
        {"var_name": "jetstr", "units": "m s-1",
         "long_name": "Maximum strength of smoothed zonal wind speed",
         "description": "Daily maximum strength of Lanczos smoothed zonal "
                        "wind speed."},
    ],
    compute=indices.jetstream_metric_woollings,
)
