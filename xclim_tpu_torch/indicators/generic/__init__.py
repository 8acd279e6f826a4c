"""Generic indicators (reference: xclim:src/xclim/indicators/generic/_stats.py)."""

from __future__ import annotations

from xclim_tpu_torch.core.indicator import Indicator, ReducingIndicator, ResamplingIndicator
from xclim_tpu_torch.indices.generic import select_resample_op



class Generic(ResamplingIndicator):
    realm = "generic"


stats = Generic(
    identifier="stats",
    title="Simple resampled statistic of the values.",
    # no declared units: the output keeps the units to_agg_units derives
    # from the input (reference declares none, xclim:generic/_stats.py:52-60)
    var_name="stat_{indexer}{op:r}",
    long_name="{op:noun} of variable",
    description="{freq} {op:noun} of variable ({indexer}).",
    compute=select_resample_op,
)


class GenericReducing(ReducingIndicator):
    """Time-collapsing generic indicator — missing checks apply with
    freq=None over the whole series (xclim:indicators/generic/_stats.py:13
    Generic(ReducingIndicator), missing from context)."""

    realm = "generic"


def _fit_compute(da: "ClimArray", dist="norm", method="ML", **fitkwargs):
    from xclim_tpu_torch.indices.stats import fit as _fit

    return _fit(da, dist=dist, method=method, **fitkwargs)


def _return_level_compute(da: "ClimArray", mode="max", t=20, dist="genextreme", window=1,
                          freq="YS", method="PWM", **indexer):
    from xclim_tpu_torch.indices.stats import frequency_analysis

    return frequency_analysis(da, mode=mode, t=t, dist=dist, window=window,
                              freq=freq, method=method, **indexer)


fit = GenericReducing(
    identifier="fit",
    title="Distribution parameters fitted over the time dimension",
    units="",
    long_name="{dist} distribution parameters",
    description="Parameters of the {dist} distribution fitted over the time "
                "dimension.",
    compute=_fit_compute,
)

return_level = GenericReducing(
    identifier="return_level",
    title="Return level from frequency analysis",
    # no declared units: frequency_analysis restores the input's units
    # (reference declares none, xclim:generic/_stats.py:39-48)
    var_name="fa_{window}{mode:r}{indexer}",
    long_name="N-year return level",
    description="Frequency analysis for the {mode} {indexer} {window}-day "
                "value estimated using the {dist} distribution.",
    compute=_return_level_compute,
)

__all__ = ["stats", "fit", "return_level"]
