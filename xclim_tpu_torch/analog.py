"""Spatial analogs (reference: xclim:src/xclim/analog.py, 628 LoC).

Dissimilarity metrics between the multivariate distribution of a target site
and every candidate grid cell. The pairwise-distance metrics (seuclidean,
nearest_neighbor, zech_aslan, szekely_rizzo, mahalanobis,
kolmogorov_smirnov, kldiv) are torch ops on the data's device, batched over
the candidate cells: each takes samples ``x`` (..., n, d) and ``y`` (..., m,
d) whose leading batch dims broadcast, and returns the metric for each
batch entry. friedman_rafsky (a minimum spanning tree) runs on the host
with scipy, one cell at a time, as the JAX package runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray

__all__ = ["friedman_rafsky", "kldiv", "kolmogorov_smirnov", "mahalanobis",
           "metric", "metrics", "nearest_neighbor", "seuclidean",
           "spatial_analogs", "standardize", "szekely_rizzo", "zech_aslan"]


def _batched(x, y):
    """x and y expanded to their common batch dims."""
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    return (x.expand(batch + x.shape[-2:]), y.expand(batch + y.shape[-2:]))


def _nanvar(x):
    """Population variance over the samples (axis -2), NaN skipped."""
    mu = torch.nanmean(x, dim=-2, keepdim=True)
    return torch.nanmean((x - mu) ** 2, dim=-2)


def _sample_var(x):
    """ddof=1 variance over the samples (axis -2), NaN skipped."""
    n = (~torch.isnan(x)).sum(dim=-2)
    return _nanvar(x) * n / torch.clamp(n - 1, min=1)


def _pairwise_dists(x, y):
    """Euclidean distances: x (..., n, d), y (..., m, d) -> (..., n, m)."""
    d2 = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    return torch.sqrt(torch.clamp(d2, min=0))


def seuclidean(x, y):
    """Standardized-Euclidean distance between sample means, scaled by the
    REFERENCE sample's ddof=1 variance (xclim:analog.py:182,
    ``spatial.distance.seuclidean(mx, my, x.var(axis=0, ddof=1))``)."""
    mx = torch.nanmean(x, dim=-2)
    my = torch.nanmean(y, dim=-2)
    v = _sample_var(x)
    return torch.sqrt((((mx - my) ** 2) / torch.where(v == 0, 1, v)).sum(-1))


def nearest_neighbor(x, y):
    """Mean proportion of same-sample nearest neighbours (xclim:analog.py:217)."""
    x, y = _batched(x, y)
    pooled = torch.cat([x, y], dim=-2)
    n = pooled.shape[-2]
    labels = torch.cat([torch.zeros(x.shape[-2], device=x.device),
                        torch.ones(y.shape[-2], device=x.device)])
    d = _pairwise_dists(pooled, pooled)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=x.device),
                    torch.inf, d)
    nn = torch.argmin(d, dim=-1)
    same = labels == labels[nn]
    return same.to(torch.float32).mean(-1)


def _sed_scale(x, y):
    """Per-dimension 1/sqrt(sx sy) scaling of the standardized Euclidean
    distance used by zech_aslan / szekely_rizzo (xclim:analog.py:277,346;
    V = x.std(ddof=1) * y.std(ddof=1))."""
    v = torch.sqrt(_sample_var(x)) * torch.sqrt(_sample_var(y))
    return 1.0 / torch.sqrt(torch.where(v == 0, 1.0, v))


def zech_aslan(x, y, dmin: float = 1e-12):
    """Zech-Aslan energy statistic on the standardized Euclidean distance
    with the log weight function (xclim:analog.py:255-321)."""
    nx, ny = x.shape[-2], y.shape[-2]
    s = _sed_scale(x, y)[..., None, :]
    xs, ys = x * s, y * s

    def phi(dist):
        return -torch.log(torch.clamp(dist, min=dmin))

    iu = torch.triu_indices(nx, nx, 1, device=x.device)
    phi_xx = phi(_pairwise_dists(xs, xs)[..., iu[0], iu[1]]).sum(-1) / (
        nx * (nx - 1))
    iv = torch.triu_indices(ny, ny, 1, device=x.device)
    phi_yy = phi(_pairwise_dists(ys, ys)[..., iv[0], iv[1]]).sum(-1) / (
        ny * (ny - 1))
    phi_xy = phi(_pairwise_dists(xs, ys)).sum((-2, -1)) / (nx * ny)
    return phi_xx + phi_yy - phi_xy


def szekely_rizzo(x, y, standardize: bool = True):
    """Szekely-Rizzo energy distance (xclim:analog.py:323-388).

    ``standardize=True`` (the reference default) measures distances in the
    standardized Euclidean metric with V = sx sy; ``False`` reproduces the
    R ``energy::edist`` two-sample statistic."""
    nx, ny = x.shape[-2], y.shape[-2]
    if standardize:
        s = _sed_scale(x, y)[..., None, :]
        x, y = x * s, y * s
    dxy = _pairwise_dists(x, y).mean((-2, -1))
    dxx = _pairwise_dists(x, x).mean((-2, -1))
    dyy = _pairwise_dists(y, y).mean((-2, -1))
    return (nx * ny) / (nx + ny) * (2 * dxy - dxx - dyy)


def mahalanobis(x, y):
    """Mahalanobis distance between sample means (xclim:analog.py:591)."""
    x, y = _batched(x, y)
    mx = torch.nanmean(x, dim=-2, keepdim=True)
    my = torch.nanmean(y, dim=-2, keepdim=True)
    pooled = torch.cat([x - mx, y - my], dim=-2)
    cov = pooled.transpose(-1, -2) @ pooled / (pooled.shape[-2] - 1)
    cov = cov + 1e-8 * torch.eye(cov.shape[-1], device=x.device)
    diff = (mx - my)[..., 0, :]
    sol = torch.linalg.solve(cov, diff[..., None])[..., 0]
    return torch.sqrt((diff * sol).sum(-1))


def kolmogorov_smirnov(x, y):
    """Fasano-Franceschini multivariate KS statistic (xclim:analog.py:434):
    quadrant-count differences over 2^d orthants around each pivot point,
    maximized over both pivot samples."""
    x, y = _batched(x, y)
    d = x.shape[-1]
    mf = 2 ** torch.arange(d, device=x.device)
    q = torch.arange(2 ** d, device=x.device)[:, None]

    def pivot(a, b):
        def codes(p):
            # code[..., i, j] = orthant of a[j] relative to pivot p[i]
            c = a.transpose(-1, -2)[..., None, :, :] <= p[..., :, :, None]
            return (c * mf[:, None]).sum(dim=-2)  # (..., np, na)

        cx = (codes(a)[..., :, None, :] == q).to(torch.float32).mean(-3)
        cy = (codes(b)[..., :, None, :] == q).to(torch.float32).mean(-3)
        return torch.abs(cx - cy).amax((-2, -1))

    return torch.maximum(pivot(x, y), pivot(y, x))


def kldiv(x, y, k: int = 1):
    """Kullback-Leibler divergence via k-NN estimator (Perez-Cruz 2008;
    xclim:analog.py:499)."""
    n, d = x.shape[-2:]
    m = y.shape[-2]
    dxx = torch.where(torch.eye(n, dtype=torch.bool, device=x.device),
                      torch.inf, _pairwise_dists(x, x))
    dxy = _pairwise_dists(x, y)
    r = torch.sort(dxx, dim=-1).values[..., k - 1]
    s = torch.sort(dxy, dim=-1).values[..., k - 1]
    eps = 1e-10
    return (d * torch.mean(torch.log(torch.clamp(s, min=eps)
                                     / torch.clamp(r, min=eps)), dim=-1)
            + float(np.log(m / (n - 1.0))))


def _friedman_rafsky_host(x, y):
    """Friedman-Rafsky runs test via MST (host, scipy; xclim:analog.py:389)."""
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial.distance import cdist

    pooled = np.concatenate([x, y], axis=0)
    labels = np.concatenate([np.zeros(len(x)), np.ones(len(y))])
    d = cdist(pooled, pooled)
    mst = minimum_spanning_tree(d)
    rows, cols = mst.nonzero()
    cross = (labels[rows] != labels[cols]).sum()
    n = len(pooled)
    # the reference's runs statistic: 1 - (1 + #cross-sample edges)/n
    # (xclim:analog.py:421), range [0, (n-1)/n]
    return 1.0 - (1.0 + cross) / n


metrics = {
    "seuclidean": seuclidean,
    "nearest_neighbor": nearest_neighbor,
    "zech_aslan": zech_aslan,
    "szekely_rizzo": szekely_rizzo,
    "mahalanobis": mahalanobis,
    "kolmogorov_smirnov": kolmogorov_smirnov,
    "kldiv": kldiv,
    "friedman_rafsky": _friedman_rafsky_host,
}

#: the metrics above that take batches of candidate cells in one call
_BATCHED = {seuclidean, nearest_neighbor, zech_aslan, szekely_rizzo,
            mahalanobis, kolmogorov_smirnov, kldiv}


def spatial_analogs(target: ClimArray, candidates: ClimArray,
                    dist_dim: str = "time", method: str = "kldiv",
                    **kwargs) -> ClimArray:
    """Dissimilarity of every candidate cell to the target distribution
    (xclim:analog.py:21).

    target: dims (time, variables) [or (time,)]; candidates: same plus spatial
    dims. Returns the metric over the spatial dims, on the candidates'
    device.
    """
    tdims = target.dims
    if "variables" not in tdims:
        target = target.expand_dims("variables", size=1, axis=target.ndim)
        candidates = candidates.expand_dims("variables", size=1, axis=candidates.ndim)
    # reorder: target (time, variables); candidates (time, variables, space...)
    t = target.transpose(dist_dim, "variables")
    space_dims = tuple(d for d in candidates.dims if d not in (dist_dim, "variables"))
    c = candidates.transpose(dist_dim, "variables", *space_dims)
    tx = t.data.to(c.data.device)
    cx = c.data.reshape(c.shape[0], c.shape[1], -1)  # (n, d, S)
    S = cx.shape[-1]

    fn = metrics[method] if not callable(method) else method
    if method == "friedman_rafsky":
        tn = tx.cpu().numpy()
        cn = cx.cpu().numpy()
        outs = np.array([
            _friedman_rafsky_host(tn, cn[:, :, s]) for s in range(S)
        ], dtype=np.float32)
        data = torch.as_tensor(outs, device=cx.device)
    else:
        cells = cx.permute(2, 0, 1)  # (S, n, d)
        if fn in _BATCHED:
            data = fn(tx, cells, **kwargs)
        else:
            data = torch.vmap(lambda cc: fn(tx, cc, **kwargs))(cells)
        data = data.to(torch.float32)

    shape = tuple(c.shape[2 + i] for i in range(len(space_dims)))
    data = data.reshape(shape) if shape else data.reshape(())
    coords = {k: v for k, v in candidates.coords.items() if k in space_dims}
    out = ClimArray(data, space_dims, coords,
                    {"units": "", "indices": method,
                     "long_name": f"Dissimilarity of the distribution with the "
                                  f"target, as measured by the {method} metric."},
                    method)
    return out


def standardize(x, y):
    """Standardize x and y jointly by their pooled mean/std
    (xclim:analog.py)."""
    both = torch.cat([x, y], dim=0)
    mu = torch.nanmean(both, dim=0)
    sd = torch.sqrt(torch.nanmean((both - mu) ** 2, dim=0))
    sd = torch.where(sd == 0, torch.nan, sd)
    return (x - mu) / sd, (y - mu) / sd


def metric(func):
    """Register a function as a spatial-analog dissimilarity metric
    (xclim:analog.py:metric decorator). It is called on one candidate cell
    at a time: (n, d) and (m, d) samples."""
    metrics[func.__name__] = func
    return func


def friedman_rafsky(x, y):
    """Friedman-Rafsky multivariate runs test dissimilarity (host MST;
    xclim:analog.py:389)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    return _friedman_rafsky_host(host(x), host(y))
