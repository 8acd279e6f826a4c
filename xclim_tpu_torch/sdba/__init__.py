"""Bias adjustment (sdba): EQM / DQM / QDM / Scaling / LOCI / ExtremeValues,
the N-dimensional pdf transfer and optimal transport, on the windowed doy
quantile and QDM adjust kernels (reference: the external xsdba package,
re-exported by xclim.sdba — xclim:src/xclim/sdba.py)."""

from xclim_tpu_torch.sdba.adjustment import (  # noqa: F401
    LOCI,
    DetrendedQuantileMapping,
    EmpiricalQuantileMapping,
    ExtremeValues,
    QuantileDeltaMapping,
    Scaling,
    npdf_transform,
)
from xclim_tpu_torch.sdba import measures, processing, properties  # noqa: F401
from xclim_tpu_torch.sdba._otc import (  # noqa: F401
    OTC,
    dOTC,
    optimal_transport_plan,
)
from xclim_tpu_torch.sdba.grouping import Grouper  # noqa: F401
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes  # noqa: F401
