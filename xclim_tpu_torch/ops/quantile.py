"""NaN-aware Hyndman-Fan quantiles.

Replicates the semantics of xclim's percentile kernel
(``_nan_quantile``, xclim:src/xclim/core/utils.py:494-558), as the reference's
``xclim_tpu.ops.quantile._nan_quantile_xla`` does:

* interpolation parameterized by (alpha, beta): alpha=beta=1 is H&F type 7
  (numpy linear), alpha=beta=1/3 is type 8 (median-unbiased, used by
  ``percentile_doy``);
* slices with 0 valid values yield NaN; slices with exactly 1 valid value yield
  that value for every quantile (xclim:core/utils.py:524-530);
* virtual indexes above the valid range clip to the slice maximum.

The float32 op sequence is the reference's: ``h = n*q + (q*(1-a-b)+a) - 1``,
clip to ``[0, n-1]``, floor, ``gamma = h - floor(h)``, ``v0*(1-gamma) +
v1*gamma``.

:func:`nan_quantile` dispatches as the reference's does
(xclim_tpu/ops/quantile.py:32-66, :88-147): a CUDA float32 tensor whose
reduce axis holds 2 to 64 samples goes to the hand-written axisquantile
kernel (:func:`~xclim_tpu_torch.ops.axisquantile.axis_quantile_small`);
everything else to :func:`nan_quantile_plain`, the sort formulation, which
gives the kernel's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.utils.profiling import span

__all__ = ["nan_quantile", "nan_quantile_plain", "nan_percentile"]


def _node_constants(q, alpha: float, beta: float):
    """(qvals, coffs) rounded at float32 exactly where nan_quantile's op
    sequence rounds them: q, then q*(1-a-b) + a."""
    qv = np.asarray(q, dtype=np.float32).reshape(-1)
    coff = (qv * np.float32(1 - alpha - beta)) + np.float32(alpha)
    return qv, coff.astype(np.float32)


def nan_quantile(x: torch.Tensor, q, axis: int = -1, alpha: float = 1.0,
                 beta: float = 1.0) -> torch.Tensor:
    """Compute quantiles along `axis`, skipping NaNs.

    Parameters
    ----------
    x : float32 tensor
    q : 1-D quantiles in [0, 1] (sequence, numpy array or tensor)
    axis : reduction axis
    alpha, beta : Hyndman-Fan interpolation parameters.

    Returns
    -------
    tensor with shape q.shape + x.shape-without-axis (quantile axis first,
    matching xclim ``_nan_quantile``), on x's device.
    """
    with span("op.quantile"):
        # imported here: ops.axisquantile imports this module
        from xclim_tpu_torch.ops import axisquantile

        ax = axis % x.ndim
        if 1 < x.shape[ax] <= axisquantile.MAX_AXIS and x.dtype == torch.float32:
            if x.device.type == "cuda":
                return axisquantile.axis_quantile_small(x, q, ax, alpha, beta)
            if x.device.type == "cpu":
                axisquantile.twin_calls += 1
        return nan_quantile_plain(x, q, ax, alpha, beta)


def nan_quantile_plain(x: torch.Tensor, q, axis: int = -1, alpha: float = 1.0,
                       beta: float = 1.0) -> torch.Tensor:
    """The sort formulation of :func:`nan_quantile`, on any device: the two
    order statistics are gathered from the sorted axis (torch.sort puts
    NaNs last)."""
    if isinstance(q, torch.Tensor):
        q = q.to(device=x.device, dtype=torch.float32).reshape(-1)
    else:
        q = torch.as_tensor(np.asarray(q, dtype=np.float32).reshape(-1),
                            device=x.device)
    xm = x.movedim(axis % x.ndim, -1)
    xs = torch.sort(xm, dim=-1).values                 # NaNs sort to the end
    n = (~torch.isnan(xm)).sum(dim=-1, keepdim=True).to(torch.float32)
    h = n * q + (q * (1 - alpha - beta) + alpha) - 1.0     # (..., Q)
    upper = torch.clamp(n - 1.0, min=0.0)
    h = torch.minimum(torch.clamp(h, min=0.0), upper)
    prev = torch.floor(h)
    gamma = h - prev
    nxt = torch.minimum(prev + 1.0, upper)
    v0 = xs.gather(-1, prev.to(torch.int64))
    v1 = xs.gather(-1, nxt.to(torch.int64))
    out = v0 * (1.0 - gamma) + v1 * gamma
    out = torch.where(n == 0, torch.nan, out)
    return out.movedim(-1, 0)


def _nanvar(x, axis=None):
    """Population variance (ddof=0) of the valid values, as ``jnp.nanvar``."""
    dims = axis if axis is not None else tuple(range(x.ndim))
    mu = torch.nanmean(x, dim=dims, keepdim=True)
    return torch.nanmean((x - mu) ** 2, dim=dims)


def _nanstd(x, axis=None):
    return torch.sqrt(_nanvar(x, axis))


def _nanmedian(x, axis=None):
    """Mean of the two middle values, as ``jnp.nanmedian`` (torch's own
    ``nanmedian`` returns the lower one)."""
    if axis is None:
        return nan_quantile(x.reshape(-1), [0.5], axis=0)[0]
    if isinstance(axis, tuple):
        keep = [d for d in range(x.ndim) if d not in axis]
        x = x.permute(keep + list(axis)).reshape(
            [x.shape[d] for d in keep] + [-1])
        axis = -1
    return nan_quantile(x, [0.5], axis=axis)[0]


def nan_percentile(x, percentiles, axis: int = -1, alpha: float = 1.0,
                   beta: float = 1.0):
    """Percentile variant (0-100), quantile axis moved to the END
    (xclim ``calc_perc`` convention, core/utils.py:279)."""
    p = torch.as_tensor(percentiles, dtype=torch.float32,
                        device=x.device) / 100.0
    out = nan_quantile(x, p, axis=axis, alpha=alpha, beta=beta)
    return out.movedim(0, -1)
