"""Optimal-transport bias correction: OTC and dOTC
(reference: xsdba's OTC/dOTC, Robin et al. 2019, re-exported through
xclim.sdba — xclim:src/xclim/sdba.py).

As in the JAX package, the transport plan between (sub)samples comes from
entropy-regularized Sinkhorn iterations — a fixed number of log-domain
softmin updates (``torch.logsumexp``) — instead of the reference's binned
histogram + exact EMD. The mapping is the barycentric projection of the
plan; `reg → 0` recovers the exact-OT map in the limit.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.ops.quantile import _nanmedian, _nanstd
from xclim_tpu_torch.sdba.utils import generator_or_default

__all__ = ["OTC", "dOTC", "optimal_transport_plan"]


def _cost(X, Y):
    """Squared euclidean cost matrix: X (n, d), Y (m, d) → (n, m)."""
    x2 = torch.sum(X * X, dim=1)[:, None]
    y2 = torch.sum(Y * Y, dim=1)[None, :]
    return x2 + y2 - 2.0 * X @ Y.T


def optimal_transport_plan(X, Y, reg: float = 0.05, n_iter: int = 200,
                           wx=None, wy=None):
    """Entropy-regularized OT plan between samples X (n, d) and Y (m, d)
    via log-domain Sinkhorn (fixed `n_iter` iterations).

    Returns the (n, m) plan with marginals wx/wy (uniform by default).
    `reg` scales the median cost (the mean of the two middle values for an
    even count, as ``jnp.median``), so it is shape- and unit-free.
    """
    n, m = X.shape[0], Y.shape[0]
    C = _cost(X, Y)
    a = torch.full((n,), 1.0 / n, dtype=C.dtype, device=C.device) \
        if wx is None else torch.as_tensor(wx, device=C.device)
    b = torch.full((m,), 1.0 / m, dtype=C.dtype, device=C.device) \
        if wy is None else torch.as_tensor(wy, device=C.device)
    log_a, log_b = torch.log(a), torch.log(b)
    K = -C / (reg * _nanmedian(C))
    u = torch.zeros(n, dtype=C.dtype, device=C.device)
    v = torch.zeros(m, dtype=C.dtype, device=C.device)
    for _ in range(n_iter):
        u = log_a - torch.logsumexp(K + v[None, :], dim=1)
        v = log_b - torch.logsumexp(K + u[:, None], dim=0)
    return torch.exp(K + u[:, None] + v[None, :])


def _barycentric_map(P, Y):
    """T(x_i) = Σ_j P_ij y_j / Σ_j P_ij."""
    w = P.sum(dim=1, keepdim=True)
    return (P @ Y) / torch.where(w == 0, 1.0, w)


def _points(da: ClimArray) -> torch.Tensor:
    """(T, d) sample matrix of a ('multivar', 'time') stacked array or a
    series."""
    if da.dims[0] == "multivar":
        return da.data.movedim(0, -1)
    return da.data[:, None] if da.data.ndim == 1 else da.data


def _to_points(da: ClimArray, max_points: int,
               generator: torch.Generator) -> torch.Tensor:
    """(T, d) sample matrix, subsampled without replacement to at most
    `max_points` rows drawn from ``generator``."""
    X = _points(da)
    T = X.shape[0]
    if T > max_points:
        idx = torch.randperm(T, generator=generator, device=generator.device)
        return X[idx[:max_points].to(X.device)]
    return X


def _standardizer(X):
    mu = torch.nanmean(X, dim=0)
    sd = _nanstd(X, 0)
    return mu, torch.where(sd == 0, 1.0, sd)


def _map_back(full, sub, mapped_sub, like: ClimArray) -> ClimArray:
    """Map every step of ``full`` through its nearest subsampled point."""
    out_pts = mapped_sub[torch.argmin(_cost(full, sub), dim=1)]  # (T, d)
    out = out_pts.movedim(-1, 0) if like.dims[0] == "multivar" \
        else out_pts[:, 0]
    return like.copy(data=out.reshape(like.shape))


class OTC:
    """Optimal Transport Correction: map hist onto ref's multivariate
    distribution (xsdba.OTC; Robin et al. 2019).

    ``OTC.adjust(ref, hist)`` with ('multivar', 'time') stacked inputs (see
    :func:`xclim_tpu_torch.sdba.processing.stack_variables`); 1-D series
    also work. Subsamples of more than `max_points` steps are drawn from
    ``generator`` (seeded with 0 on the data's device when None).
    """

    @classmethod
    def adjust(cls, ref: ClimArray, hist: ClimArray, *, reg: float = 0.05,
               n_iter: int = 200, max_points: int = 2048,
               generator=None) -> ClimArray:
        gen = generator_or_default(generator, hist.data.device)
        Xr = _to_points(ref, max_points, gen)
        Xh = _to_points(hist, max_points, gen)
        mu, sd = _standardizer(torch.cat([Xr, Xh], dim=0))
        P = optimal_transport_plan((Xh - mu) / sd, (Xr - mu) / sd,
                                   reg=reg, n_iter=n_iter)
        mapped_sub = _barycentric_map(P, (Xr - mu) / sd) * sd + mu  # (n_sub, d)
        res = _map_back(_points(hist), Xh, mapped_sub, hist)
        res.attrs = dict(hist.attrs)
        res.attrs["history"] = (hist.attrs.get("history", "") +
                                "\nAdjusted with OTC (Sinkhorn optimal "
                                f"transport, reg={reg}).")
        return res


class dOTC:
    """Dynamical OTC: transfer the hist→sim evolution onto ref
    (xsdba.dOTC; Robin, Vrac & Naveau 2019, HESS 23:773-786).

    The published three-plan construction:
      1. plan(hist → sim) gives each hist sample's evolution
         ``v_i = T₀₁(x0_i) − x0_i`` (ratio for ``kind='*'``);
      2. plan(ref → hist) carries those evolutions onto ref,
         ``Y1 = Y0 ∘ v`` — the reference evolved by the model's change;
      3. OTC maps sim onto the evolved reference Y1.
    The scen therefore has ref's (evolved) multivariate distribution while
    preserving the model's hist→sim change signal.
    """

    @classmethod
    def adjust(cls, ref: ClimArray, hist: ClimArray, sim: ClimArray, *,
               reg: float = 0.05, n_iter: int = 200, max_points: int = 2048,
               kind: str = "+", generator=None) -> ClimArray:
        gen = generator_or_default(generator, sim.data.device)
        Xr = _to_points(ref, max_points, gen)
        Xh = _to_points(hist, max_points, gen)
        Xs = _to_points(sim, max_points, gen)
        mu, sd = _standardizer(torch.cat([Xr, Xh], dim=0))

        def std(X):
            return (X - mu) / sd

        # 1. model evolution per hist sample: T01(x0_i) − x0_i
        P01 = optimal_transport_plan(std(Xh), std(Xs), reg=reg, n_iter=n_iter)
        mapped01 = _barycentric_map(P01, std(Xs)) * sd + mu
        if kind == "*":
            v = mapped01 / torch.where(Xh == 0, torch.nan, Xh)
        else:
            v = mapped01 - Xh

        # 2. carry the evolution onto ref through plan(ref → hist)
        Pr0 = optimal_transport_plan(std(Xr), std(Xh), reg=reg, n_iter=n_iter)
        v_ref = _barycentric_map(Pr0, v)
        Y1 = Xr * v_ref if kind == "*" else Xr + v_ref

        # 3. OTC: map sim onto the evolved reference
        mu1, sd1 = _standardizer(torch.cat([Y1, Xs], dim=0))
        P1 = optimal_transport_plan((Xs - mu1) / sd1, (Y1 - mu1) / sd1,
                                    reg=reg, n_iter=n_iter)
        mapped_sub = _barycentric_map(P1, (Y1 - mu1) / sd1) * sd1 + mu1
        res = _map_back(_points(sim), Xs, mapped_sub, sim)
        res.attrs = dict(sim.attrs)
        res.attrs["history"] = (sim.attrs.get("history", "") +
                                "\nAdjusted with dOTC (Sinkhorn optimal "
                                f"transport, reg={reg}, kind={kind}).")
        return res
