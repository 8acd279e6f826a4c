"""Index functions (reference: xclim:src/xclim/indices/__init__.py).

Every index module of the reference: the simple per-period reductions, the
threshold, multivariate (with the doy-percentile indices and their
bootstrap), agroclimatic, ANUCLIM, hydrological, synoptic and fire-weather
indices, the physical converters, the solar helpers, the generic and
run-length building blocks, and the distribution fitting of ``stats.py``.
"""

# generic first: the reference exposes generic only as a submodule, so any
# name collision (extreme_temperature_range) must resolve to the specific
# family module, as in xclim.indices (xclim:indices/__init__.py:5-16)
from xclim_tpu_torch.indices.generic import *  # noqa: F401,F403
from xclim_tpu_torch.indices._simple import *  # noqa: F401,F403
from xclim_tpu_torch.indices._agro import *  # noqa: F401,F403
from xclim_tpu_torch.indices._anuclim import *  # noqa: F401,F403
from xclim_tpu_torch.indices._hydrology import *  # noqa: F401,F403
from xclim_tpu_torch.indices._synoptic import *  # noqa: F401,F403
from xclim_tpu_torch.indices._threshold import *  # noqa: F401,F403
from xclim_tpu_torch.indices._multivariate import *  # noqa: F401,F403
from xclim_tpu_torch.indices import converters, generic  # noqa: F401
from xclim_tpu_torch.indices.converters import *  # noqa: F401,F403
from xclim_tpu_torch.indices import helpers, run_length, stats  # noqa: F401
from xclim_tpu_torch.indices import fire  # noqa: F401
from xclim_tpu_torch.indices.fire import *  # noqa: F401,F403
