"""Land indicators: snow & streamflow (reference: xclim:src/xclim/indicators/land/)."""

from xclim_tpu_torch.indicators.land._snow import *  # noqa: F401,F403
from xclim_tpu_torch.indicators.land._streamflow import *  # noqa: F401,F403

# reference-name aliases: snd<->snw conversions live in the convert realm
# here but the reference also exposes them from land
# (xclim:src/xclim/indicators/land/_snow.py __all__)
from xclim_tpu_torch.indicators.convert import snd_to_snw, snw_to_snd  # noqa: E402,F401
