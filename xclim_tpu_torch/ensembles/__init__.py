"""Ensemble tools (reference: xclim:src/xclim/ensembles/).

Ensembles are ClimArrays with a 'realization' dim. On a CUDA tensor,
:func:`ensemble_percentiles` runs the axisquantile kernel over the members
(``xclim_tpu_torch.ops.axisquantile.launches`` counts it); on a CPU tensor
its plain twin.
"""

from xclim_tpu_torch.ensembles._base import (  # noqa: F401
    create_ensemble,
    ensemble_mean_std_max_min,
    ensemble_percentiles,
)
from xclim_tpu_torch.ensembles._filters import (  # noqa: F401
    _concat_hist,
    _model_in_all_scens,
    _single_member,
)
from xclim_tpu_torch.ensembles._partitioning import (  # noqa: F401
    fractional_uncertainty,
    general_partition,
    hawkins_sutton,
    lafferty_sriver,
)
from xclim_tpu_torch.ensembles._reduce import (  # noqa: F401
    kkz_reduce_ensemble,
    kmeans_reduce_ensemble,
    make_criteria,
    plot_rsqprofile,
)
from xclim_tpu_torch.ensembles._robustness import (  # noqa: F401
    robustness_categories,
    robustness_coefficient,
    robustness_fractions,
)
