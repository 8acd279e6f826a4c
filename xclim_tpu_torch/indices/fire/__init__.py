"""Fire weather indices (reference: xclim:src/xclim/indices/fire/)."""

from xclim_tpu_torch.indices.fire._cffwis import *  # noqa: F401,F403
from xclim_tpu_torch.indices.fire._ffdi import *  # noqa: F401,F403
