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
from xclim_tpu_torch.ops.qdmadjust import (
    _take_nodes,
    gather_groups,
    grouped_rank,
    interp_hat_nodes,
)
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import count, span

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


def interp_on_quantiles(x: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor,
                        method: str = "linear",
                        extrapolation: str = "constant") -> torch.Tensor:
    """y(x) by piecewise-linear interp of (xq → yq) along the quantile axis.

    x: (..., ms, C); xq, yq: (..., nq, C) sorted along -2. Constant
    extrapolation clamps to the edge values (xsdba default
    ``extrapolation='constant'``). The bracketing index is a comparison
    count over the nodes (NaN nodes compare False, i.e. count as greater),
    one pass over ``x`` a node, each counted as ``eqm_node_passes``.
    """
    nq = xq.shape[-2]
    # the narrowest count that holds nq: the loop reads and writes it once
    # a node
    cnt = torch.zeros(x.shape, device=x.device,
                      dtype=torch.int16 if nq < 2**15 else torch.int64)
    for k in range(nq):
        cnt += xq[..., k:k + 1, :] <= x
        count("eqm_node_passes")
    hi = torch.clamp(cnt, 1, nq - 1).to(torch.int64)
    lo = hi - 1
    x0 = _take_nodes(xq, lo)
    x1 = _take_nodes(xq, hi)
    y0 = _take_nodes(yq, lo)
    y1 = _take_nodes(yq, hi)
    denom = x1 - x0
    w = torch.where(denom != 0,
                    (x - x0) / torch.where(denom == 0, 1.0, denom), 0.0)
    if extrapolation == "constant":
        w = torch.clamp(w, 0.0, 1.0)
    y = y0 + w * (y1 - y0)
    return torch.where(torch.isnan(x), torch.nan, y)
