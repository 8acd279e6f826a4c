"""Percentile helpers of the reference's ``xclim_tpu/core/utils.py``
(xclim:core/utils.py:279, :326). The rest of that module waits for the
slices that use it."""

from __future__ import annotations

import numpy as np
import torch

import xclim_tpu_torch
from xclim_tpu_torch.ops.quantile import nan_quantile

__all__ = ["calc_perc", "nan_calc_percentiles", "is_percentile_dataarray"]


def calc_perc(arr, percentiles=None, alpha: float = 1.0, beta: float = 1.0,
              copy: bool = True, device=None) -> np.ndarray:
    """NaN-aware Hyndman-Fan percentiles along the LAST axis, with the
    percentile axis last (the reference's apply_ufunc kernel,
    xclim:core/utils.py:279). Returns a host numpy array, as the
    reference does."""
    return nan_calc_percentiles(arr, percentiles, axis=-1, alpha=alpha,
                                beta=beta, copy=copy, device=device)


def nan_calc_percentiles(arr, percentiles=None, axis=-1, alpha: float = 1.0,
                         beta: float = 1.0, copy: bool = True,
                         device=None) -> np.ndarray:
    """NaN-aware percentiles along `axis`, with the percentile axis appended
    last (xclim:core/utils.py:326). Returns a host numpy array. A tensor is
    computed on its device; host values on ``device`` (default:
    :func:`xclim_tpu_torch.default_device`)."""
    if percentiles is None:
        percentiles = [50.0]
    q = np.asarray(percentiles, dtype=np.float32) / 100.0
    if not isinstance(arr, torch.Tensor) and device is None:
        device = xclim_tpu_torch.default_device()
    x = torch.as_tensor(arr, dtype=torch.float32, device=device)
    out = nan_quantile(x.movedim(axis, 0), q, axis=0, alpha=alpha, beta=beta)
    return out.movedim(0, -1).cpu().numpy()


def is_percentile_dataarray(da) -> bool:
    """Whether an array carries doy-percentile climatology metadata
    (xclim:core/utils.py)."""
    return (hasattr(da, "attrs")
            and da.attrs.get("climatology_bounds") is not None
            and ("percentiles" in getattr(da, "coords", {})
                 or "percentiles" in da.attrs))
