"""Atmospheric indicators (reference: xclim:src/xclim/indicators/atmos/)."""

from xclim_tpu_torch.indicators.atmos._precip import *  # noqa: F401,F403
from xclim_tpu_torch.indicators.atmos._synoptic import *  # noqa: F401,F403
from xclim_tpu_torch.indicators.atmos._temperature import *  # noqa: F401,F403
from xclim_tpu_torch.indicators.atmos._wind import *  # noqa: F401,F403

# ---------------------------------------------------------------------------
# Reference module-attribute aliases: the reference exposes several
# indicators under long names that differ from their identifiers
# (xclim:src/xclim/indicators/atmos/_precip.py:48-65, _temperature.py:1577,
# _agro.py, fire/). The registry identifier stays the short form; the
# module attribute matches the reference API.
# ---------------------------------------------------------------------------
from xclim_tpu_torch.indicators.atmos._precip import (  # noqa: E402
    cdd as _cdd,
    cwd as _cwd,
    liquidprcpavg as _lpa,
    solidprcpavg as _spa,
    wet_prcptot as _wpt,
)

maximum_consecutive_dry_days = _cdd
maximum_consecutive_wet_days = _cwd
liquid_precip_average = _lpa
solid_precip_average = _spa
wet_precip_accumulation = _wpt

from xclim_tpu_torch.indicators.atmos._temperature import cp as _cp, cu as _cu  # noqa: E402

chill_portions = _cp
chill_units = _cu

from xclim_tpu_torch.indicators.atmos._precip import api as _api  # noqa: E402
antecedent_precipitation_index = _api

from xclim_tpu_torch.indicators.atmos._precip import (  # noqa: E402
    cffwis as _cffwis,
    dc as _dc,
    df as _df,
    dmc as _dmc,
    ffdi as _ffdi,
    kbdi as _kbdi,
)

cffwis_indices = _cffwis
drought_code = _dc
duff_moisture_code = _dmc
griffiths_drought_factor = _df
mcarthur_forest_fire_danger_index = _ffdi
keetch_byram_drought_index = _kbdi

from xclim_tpu_torch.indicators.atmos._precip import spei as _spei, spi as _spi  # noqa: E402

standardized_precipitation_evapotranspiration_index = _spei
standardized_precipitation_index = _spi
