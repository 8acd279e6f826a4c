"""Index functions (reference: xclim:src/xclim/indices/__init__.py).

Ported so far: the simple per-period reductions (``_simple.py``), the
threshold indices (``_threshold.py``), the multivariate indices
(``_multivariate.py``, with the doy-percentile ones and their bootstrap),
the generic and run-length building blocks they use, and the distribution
fitting and frequency analysis of ``stats.py``.
"""

from xclim_tpu_torch.indices.generic import *  # noqa: F401,F403
from xclim_tpu_torch.indices._simple import *  # noqa: F401,F403
from xclim_tpu_torch.indices._threshold import *  # noqa: F401,F403
from xclim_tpu_torch.indices._multivariate import *  # noqa: F401,F403
from xclim_tpu_torch.indices import generic, run_length, stats  # noqa: F401
