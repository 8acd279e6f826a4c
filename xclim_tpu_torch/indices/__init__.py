"""Index functions (reference: xclim:src/xclim/indices/__init__.py).

Ported so far: the simple per-period reductions (``_simple.py``) and the
generic building blocks they use.
"""

from xclim_tpu_torch.indices.generic import *  # noqa: F401,F403
from xclim_tpu_torch.indices._simple import *  # noqa: F401,F403
from xclim_tpu_torch.indices import generic  # noqa: F401
