"""Atmospheric indicators (reference: xclim:src/xclim/indicators/atmos/)."""

from xclim_tpu_torch.indicators.atmos._temperature import *  # noqa: F401,F403
