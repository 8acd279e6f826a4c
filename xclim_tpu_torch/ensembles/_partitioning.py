"""Uncertainty partitioning (reference: xclim:src/xclim/ensembles/_partitioning.py).

Host-side numpy implementations (ensemble axes are small); dims follow the
reference convention: ('time', 'scenario', 'model', ...) for Hawkins-Sutton
and ('time', 'scenario', 'model', 'downscaling', ...) for Lafferty-Sriver.
"""

from __future__ import annotations

import numpy as np

from xclim_tpu_torch.core.dataarray import ClimArray

__all__ = ["fractional_uncertainty", "general_partition", "hawkins_sutton",
           "lafferty_sriver"]


def _polyfit_sm(vals: np.ndarray, deg: int = 4) -> np.ndarray:
    """4th-order polynomial smoothing along axis 0 (time)."""
    T = vals.shape[0]
    t = np.arange(T, dtype=np.float64)
    flat = vals.reshape(T, -1)
    sm = np.full_like(flat, np.nan)
    ok_cols = ~np.isnan(flat).all(axis=0)
    for j in np.nonzero(ok_cols)[0]:
        y = flat[:, j]
        m = ~np.isnan(y)
        if m.sum() <= deg:
            continue
        c = np.polyfit(t[m], y[m], deg)
        sm[:, j] = np.where(m, np.polyval(c, t), np.nan)
    return sm.reshape(vals.shape)


def _host(da: ClimArray, *dims) -> np.ndarray:
    return np.asarray(da.transpose(*dims).values, dtype=np.float64)


def _result(da: ClimArray, g, names, comps) -> tuple[ClimArray, ClimArray]:
    """(mean change, uncertainty components) as the reference returns them."""
    tcoord = da.coords.get("time")
    gx = ClimArray(g.astype(np.float32), ("time",), {"time": tcoord},
                   dict(da.attrs), "mean_change", device=da.device)
    unc = ClimArray(np.stack(comps).astype(np.float32), ("uncertainty", "time"),
                    {"uncertainty": np.array(names), "time": tcoord},
                    {"units": ""}, "uncertainty", device=da.device)
    return gx, unc


def hawkins_sutton(da: ClimArray, sm: ClimArray | None = None, weights=None,
                   baseline: tuple[str, str] = ("1971", "2000"), kind: str = "+"):
    """Hawkins & Sutton (2009) variance partitioning
    (xclim:ensembles/_partitioning.py:57).

    Returns (mean_change g(t), uncertainty components ClimArray with an
    'uncertainty' dim: variability/model/scenario/total).
    """
    for d in ("time", "scenario", "model"):
        if d not in da.dims:
            raise ValueError("DataArray dimensions should include 'time', "
                             "'scenario' and 'model'.")
    dims = ("time", "scenario", "model")
    vals = _host(da, *dims)  # (T, S, M)
    years = da.time.year
    w = np.ones(vals.shape[2]) if weights is None else np.asarray(weights, np.float64)
    wn = w / w.sum()

    smv = _polyfit_sm(vals) if sm is None else _host(sm, *dims)

    # decadal mean residuals → internal variability
    res = vals - smv
    k = 10
    kern = np.ones(k) / k
    resr = np.full_like(res, np.nan)
    for s in range(res.shape[1]):
        for m in range(res.shape[2]):
            y = res[:, s, m]
            if np.isnan(y).all():
                continue
            resr[:, s, m] = np.convolve(np.nan_to_num(y), kern, mode="same")
    post2000 = years >= 2000
    nv_u = np.nansum(wn * np.nanvar(resr[post2000], axis=(0, 1)))

    # baseline removal
    y0, y1 = int(baseline[0]), int(baseline[1])
    base = (years >= y0) & (years <= y1)
    ref = np.nanmean(smv[base], axis=0)  # (S, M)
    if kind == "+":
        smb = smv - ref
    else:
        smb = smv / ref

    wmean = np.nansum(wn * smb, axis=2)  # (T, S)
    model_u = np.nanmean(np.nansum(wn * (smb - wmean[:, :, None]) ** 2, axis=2), axis=1)
    scenario_u = np.nanvar(wmean, axis=1)  # (T,)
    total = nv_u + scenario_u + model_u

    g = np.nanmean(wmean, axis=1)
    return _result(da, g, ["variability", "model", "scenario", "total"],
                   [np.full_like(total, nv_u), model_u, scenario_u, total])


def lafferty_sriver(da: ClimArray, sm: ClimArray | None = None,
                    bb13: bool = False):
    """Lafferty & Sriver (2023) partitioning with a 'downscaling' dim
    (xclim:ensembles/_partitioning.py:192)."""
    for d in ("time", "scenario", "model", "downscaling"):
        if d not in da.dims:
            raise ValueError("DataArray dimensions should include 'time', "
                             "'scenario', 'model' and 'downscaling'.")
    dims = ("time", "scenario", "model", "downscaling")
    vals = _host(da, *dims)  # (T, S, M, D)
    smv = _polyfit_sm(vals) if sm is None else _host(sm, *dims)
    res = vals - smv
    nv_u = np.nanmean(np.nanvar(res, axis=0))  # scalar internal variability
    # model uncertainty: variance over models of (mean over scenarios, downscaling)
    model_u = np.nanmean(np.nanvar(smv, axis=2), axis=(1, 2))
    scenario_u = np.nanvar(np.nanmean(smv, axis=(2, 3)), axis=1)
    downscaling_u = np.nanmean(np.nanvar(smv, axis=3), axis=(1, 2))
    total = nv_u + model_u + scenario_u + downscaling_u
    if bb13:
        total = np.maximum(total, 1e-12)
    g = np.nanmean(smv, axis=(1, 2, 3))
    return _result(da, g, ["variability", "model", "scenario", "downscaling",
                           "total"],
                   [np.full_like(total, nv_u), model_u, scenario_u,
                    downscaling_u, total])


def general_partition(da: ClimArray, sm: ClimArray | str = "poly",
                      var_first: list | None = None, mean_first: list | None = None,
                      weights: list | None = None):
    """General mean/variance partitioning over arbitrary ensemble dims
    (xclim:ensembles/_partitioning.py:284)."""
    var_first = var_first or ["model"]
    mean_first = mean_first or ["scenario"]
    dims = ("time",) + tuple(var_first) + tuple(mean_first)
    vals = _host(da, *dims)
    smv = _polyfit_sm(vals) if isinstance(sm, str) else _host(sm, *dims)
    res = vals - smv
    nv_u = np.nanmean(np.nanvar(res, axis=0))
    comps = {}
    for i, d in enumerate(var_first, start=1):
        other = tuple(j for j in range(1, vals.ndim) if j != i)
        comps[d] = np.nanmean(np.nanvar(smv, axis=i), axis=tuple(
            j - (1 if j > i else 0) for j in other))
    for i, d in enumerate(mean_first, start=1 + len(var_first)):
        other = tuple(j for j in range(1, vals.ndim) if j != i)
        mean_o = np.nanmean(smv, axis=other)
        comps[d] = np.nanvar(mean_o, axis=1)
    total = nv_u + sum(comps.values())
    g = np.nanmean(smv, axis=tuple(range(1, vals.ndim)))
    return _result(da, g, ["variability"] + list(comps) + ["total"],
                   [np.full_like(total, nv_u)] + list(comps.values()) + [total])


def fractional_uncertainty(u: ClimArray) -> ClimArray:
    """Uncertainty components → percent of total (xclim:_partitioning.py:404)."""
    vals = np.asarray(u.values, dtype=np.float64)
    names = list(np.asarray(u.coords["uncertainty"]))
    tot_idx = names.index("total") if "total" in names else None
    tot = vals[tot_idx] if tot_idx is not None else vals.sum(axis=0)
    frac = vals / np.where(tot == 0, np.nan, tot) * 100.0
    out = u.copy(data=frac.astype(np.float32))
    out.attrs["units"] = "%"
    return out
