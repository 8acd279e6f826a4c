"""Bias adjustment (sdba): EQM and QDM on the windowed doy quantile and QDM
adjust kernels (reference: the external xsdba package, re-exported by
xclim.sdba — xclim:src/xclim/sdba.py)."""

from xclim_tpu_torch.sdba.adjustment import (  # noqa: F401
    EmpiricalQuantileMapping,
    QuantileDeltaMapping,
)
from xclim_tpu_torch.sdba.grouping import Grouper  # noqa: F401
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes  # noqa: F401
