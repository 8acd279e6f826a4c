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


def gather_groups(xf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Group-gather a time-first tensor with an integer table, NaN-padding
    the -1 slots. xf: (T, ...); table: (G, ms) → (G, ms, ...)."""
    g = xf[table.clamp(min=0)]
    ok = (table >= 0).reshape(tuple(table.shape) + (1,) * (g.ndim - 2))
    return torch.where(ok, g, torch.nan)


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


def _take_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes (..., nq, C) at per-element node index idx (..., ms, C)."""
    shape = torch.broadcast_shapes(tuple(nodes.shape[:-2]),
                                   tuple(idx.shape[:-2]))
    nodes = nodes.expand(shape + tuple(nodes.shape[-2:]))
    idx = idx.expand(shape + tuple(idx.shape[-2:]))
    return nodes.gather(-2, idx)


def grouped_rank(sim_g: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Empirical pct rank of each sample within its group (xsdba.utils.rank).

    sim_g: (G, ms, C) group-gathered values (NaN padded). Returns same-shape
    ranks in (0, 1]: rank = #(group ≤ v) / n_valid (max rank 1.0).

    Two formulations sharing the same tie semantics (upper count):

    * small groups (ms <= 128, the windowless adjust tables): a
      compare-count #(group <= v), accumulated one group member at a time;
    * large groups: one stable sort yields the permutation; the tie-run
      upper bound comes from a flipped cummin over the run ends; a scatter
      through the permutation un-sorts the counts.
    """
    ms = sim_g.shape[-2]
    n = torch.clamp(nvalid.unsqueeze(-2), min=1).to(torch.float32)
    if ms <= 128:
        cnt = torch.zeros(sim_g.shape, dtype=torch.int32, device=sim_g.device)
        for j in range(ms):
            cnt += sim_g[..., j:j + 1, :] <= sim_g
        return cnt.to(torch.float32) / n
    # NaNs sort last and never equal anything → their counts are inert
    S, perm = torch.sort(sim_g, dim=-2, stable=True)
    nxt_same = torch.cat([S[..., 1:, :] == S[..., :-1, :],
                          torch.zeros_like(S[..., :1, :], dtype=torch.bool)],
                         dim=-2)
    # #(group ≤ S[j]) = end of j's tie run + 1: the nearest run end at or
    # after j, by a reverse cummin over the run-end positions
    pos = torch.arange(1, ms + 1, dtype=torch.int64,
                       device=sim_g.device)[:, None]
    base = torch.where(nxt_same, torch.iinfo(torch.int64).max, pos)
    u = torch.flip(torch.cummin(torch.flip(base, dims=(-2,)), dim=-2).values,
                   dims=(-2,))
    cnt = torch.empty_like(u).scatter_(-2, perm, u)
    return cnt.to(torch.float32) / n


def interp_hat_nodes(tau: torch.Tensor, q, yq: torch.Tensor) -> torch.Tensor:
    """y(tau) by piecewise-linear interpolation on the SHARED sorted 1-D node
    vector ``q`` (not necessarily uniform):

        y = Σ_k φ_k(tau) · yq[k],   φ_k the hat on [q_{k-1}, q_k, q_{k+1}]

    tau: (G, ms, C); q: (nq,) strictly increasing; yq: (G, nq, C).
    Constant extrapolation (clamp into [q₀, q_{nq−1}]). The bracketing node
    is a comparison count over q; the two bracketing nodes and factors are
    gathered.
    """
    q = torch.as_tensor(q, dtype=torch.float32, device=tau.device)
    nq = q.shape[0]
    tc = torch.minimum(torch.maximum(tau, q[0]), q[-1])
    cnt = torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    for k in range(nq):
        cnt += q[k] <= tc
    hi = torch.clamp(cnt, 1, nq - 1)
    lo = hi - 1
    x0 = q[lo]
    x1 = q[hi]
    y0 = _take_nodes(yq, lo)
    y1 = _take_nodes(yq, hi)
    denom = x1 - x0
    w = (tc - x0) / torch.where(denom == 0, 1.0, denom)
    w = torch.clamp(w, 0.0, 1.0)
    out = y0 + w * (y1 - y0)
    return torch.where(torch.isnan(tau), torch.nan, out)
