"""sdba numerical utilities: group gathers, windowed doy quantiles, ranks and
quantile-axis interpolation (reference: xsdba.utils — xclim.sdba shim,
xclim:src/xclim/sdba.py).

Every function takes and returns tensors on the caller's device. The one-hot
selection sums of the reference become ``gather`` along the quantile axis:
a sum of one selected value and zeros is that value, so both give the same
float32 numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.ops import winquantile
from xclim_tpu_torch.ops.eqmadjust import interp_on_quantiles
from xclim_tpu_torch.ops.qdmadjust import (
    gather_groups,
    grouped_rank,
    interp_hat_nodes,
)
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import span

__all__ = ["equally_spaced_nodes", "grouped_quantile", "interp_on_quantiles",
           "grouped_rank",
           "interp_hat_nodes", "gather_groups", "gather_doy_slices",
           "windowed_doy_quantile", "windowed_doy_mean"]


def equally_spaced_nodes(n: int, eps: float | None = 1e-4) -> np.ndarray:
    """n quantile nodes, offset from 0/1 (xsdba.utils.equally_spaced_nodes)."""
    dq = 1.0 / n / 2.0
    q = np.linspace(dq, 1 - dq, n)
    if eps is None:
        return q
    return np.insert(np.append(q, 1 - eps), 0, eps)


def generator_or_default(generator, device) -> torch.Generator:
    """The caller's generator, else one seeded with 0 on ``device`` (the
    reference's default key is PRNGKey(0))."""
    if generator is not None:
        return generator
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


def grouped_quantile(da, grouper, q, alpha: float = 1.0,
                     beta: float = 1.0) -> torch.Tensor:
    """Per-group quantiles of a ClimArray: (n_groups, nq, ...space) on its
    device (the winquantile op for ``time.dayofyear``)."""
    xf = da.data.movedim(da.time_axis, 0)
    if grouper.group == "time.dayofyear":
        return windowed_doy_quantile(
            xf, grouper.device_doy_table(da.time, xf.device), grouper.window,
            q, alpha=alpha, beta=beta)
    g = gather_groups(xf, grouper.device_train_table(da.time, xf.device))
    out = nan_quantile(g, np.asarray(q, dtype=np.float32), axis=1,
                       alpha=alpha, beta=beta)            # (nq, G, ...)
    return out.movedim(0, 1)


def gather_doy_slices(xf: torch.Tensor, doy_table: torch.Tensor) -> torch.Tensor:
    """(T, ...) time-first tensor -> (n_doy, occ, ...) doy slices, NaN padded."""
    return gather_groups(xf, doy_table)


def windowed_doy_quantile(xf: torch.Tensor, doy_table: torch.Tensor,
                          window: int, q, alpha: float = 1.0,
                          beta: float = 1.0) -> torch.Tensor:
    """Quantiles of every ±half-doy window: (n_doy, nq, ...space).

    Runs :func:`xclim_tpu_torch.ops.winquantile.doy_window_quantiles` on the
    doy slices: the CUDA kernel for tensors on the card, its plain twin for
    CPU tensors. Hyndman-Fan semantics of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`.
    """
    with span("sdba.quantiles"):
        xd = gather_doy_slices(xf, doy_table)     # (n_doy, occ, ...space)
        sshape = tuple(xd.shape[2:])
        xd2 = xd.reshape(tuple(xd.shape[:2]) + (-1,)) if xd.ndim != 3 else xd
        out = winquantile.doy_window_quantiles(xd2, q, window, alpha=alpha,
                                               beta=beta)
        return out.reshape(tuple(out.shape[:2]) + sshape)


def windowed_doy_mean(xf: torch.Tensor, doy_table: torch.Tensor,
                      window: int) -> torch.Tensor:
    """NaN-mean of every ±half-doy window: (n_doy, ...space).

    Per-doy sums/counts then a circular window-sum over the doy axis — one
    pass over the data instead of the window-times-redundant gather."""
    xd = gather_doy_slices(xf, doy_table)
    ok = ~torch.isnan(xd)
    s = torch.where(ok, xd, 0.0).sum(dim=1)       # (n_doy, ...)
    c = ok.sum(dim=1).to(torch.float32)
    n_doy = s.shape[0]
    half = window // 2
    rows = ((torch.arange(n_doy)[:, None]
             + torch.arange(-half, half + 1)[None, :]) % n_doy).to(xf.device)
    sw = s[rows.reshape(-1)].reshape((n_doy, window) + tuple(s.shape[1:])).sum(dim=1)
    cw = c[rows.reshape(-1)].reshape((n_doy, window) + tuple(c.shape[1:])).sum(dim=1)
    return torch.where(cw > 0, sw / torch.clamp(cw, min=1.0), torch.nan)
