"""Ensemble creation & statistics (reference: xclim:src/xclim/ensembles/_base.py)."""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import common_calendar
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset, concat
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import span

__all__ = ["create_ensemble", "ensemble_mean_std_max_min", "ensemble_percentiles"]


def create_ensemble(datasets, realizations=None, calendar: str | None = None,
                    cal_kwargs=None) -> ClimDataset | ClimArray:
    """Concatenate members along a new 'realization' dimension
    (xclim:ensembles/_base.py:31).

    Members with different calendars are converted to a common calendar
    (dropping impossible dates); time axes are intersected.
    """
    items = list(datasets)
    if isinstance(items[0], ClimArray):
        return _stack(items, calendar, realizations)
    # datasets: merge per variable
    keys = set(items[0].keys())
    for d in items[1:]:
        keys &= set(d.keys())
    out = ClimDataset()
    for k in sorted(keys):
        out[k] = _stack([d[k] for d in items], calendar, realizations)
    return out


def _stack(arrays: list[ClimArray], calendar, realizations) -> ClimArray:
    aligned = _align(arrays, calendar)
    return concat(aligned, "realization",
                  coord=np.asarray(realizations if realizations is not None
                                   else np.arange(len(aligned))))


def _align(arrays: list[ClimArray], calendar: str | None):
    tis = [a.time for a in arrays]
    if any(t is None for t in tis):
        return arrays
    cal = calendar or common_calendar([t.calendar for t in tis])
    conv = []
    for a, t in zip(arrays, tis):
        if t.calendar != cal:
            new_t, keep = t.convert_calendar(cal)
            a = a.sel_time(mask=keep)
            a.coords["time"] = new_t
        conv.append(a)
    # intersect time ranges
    encs = [set(a.time.encode().tolist()) for a in conv]
    commont = sorted(set.intersection(*encs))
    out = []
    for a in conv:
        mask = np.isin(a.time.encode(), commont)
        out.append(a if mask.all() else a.sel_time(mask=mask))
    return out


def ensemble_mean_std_max_min(ens: ClimDataset | ClimArray,
                              weights=None) -> ClimDataset:
    """Mean/stdev/max/min over realization (xclim:ensembles/_base.py:141)."""
    if isinstance(ens, ClimArray):
        ens = ClimDataset({ens.name or "data": ens})
    out = ClimDataset()
    for k, da in ens.items():
        if "realization" not in da.dims:
            continue
        if weights is None:
            out[f"{k}_mean"] = da.mean(dim="realization", keep_attrs=True)
            out[f"{k}_stdev"] = da.std(dim="realization", keep_attrs=True)
        else:
            ax = da.dims.index("realization")
            shape = [1] * da.ndim
            shape[ax] = len(weights)
            wr = torch.as_tensor(np.asarray(weights, dtype=np.float32),
                                 device=da.device).reshape(shape)
            valid = ~torch.isnan(da.data)
            wsum = torch.where(valid, wr, 0.0).sum(dim=ax)
            mean = torch.where(valid, da.data * wr, 0.0).sum(dim=ax) / wsum
            var = torch.where(valid, wr * (da.data - mean.unsqueeze(ax)) ** 2,
                              0.0).sum(dim=ax) / wsum
            dims = tuple(d for d in da.dims if d != "realization")
            coords = {c: v for c, v in da.coords.items() if c != "realization"}
            out[f"{k}_mean"] = ClimArray(mean, dims, coords, dict(da.attrs))
            out[f"{k}_stdev"] = ClimArray(torch.sqrt(var), dims, coords,
                                          dict(da.attrs))
        out[f"{k}_max"] = da.max(dim="realization", keep_attrs=True)
        out[f"{k}_min"] = da.min(dim="realization", keep_attrs=True)
        for suffix in ("mean", "stdev", "max", "min"):
            o = out[f"{k}_{suffix}"]
            o.attrs["description"] = (f"{suffix.capitalize()} of the ensemble of "
                                      f"{da.attrs.get('description', k)}")
    return out


def ensemble_percentiles(ens, values=None, keep_chunk_size=None, weights=None,
                         split: bool = True, method: str = "linear"):
    """Ensemble percentiles over realization (xclim:ensembles/_base.py:214).

    The unweighted path is one call of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile` over the realization
    axis, which a CUDA tensor of up to 64 members serves with the
    axisquantile kernel; the weighted path uses the weighted-quantile
    estimator on sorted members.
    """
    if values is None:
        values = [10, 50, 90]
    if isinstance(ens, ClimDataset):
        out = ClimDataset()
        for k, da in ens.items():
            res = ensemble_percentiles(da, values, weights=weights, split=split,
                                       method=method)
            if split:
                for p, arr in res.items():
                    out[f"{k}_p{int(p):02d}" if float(p).is_integer() else f"{k}_p{p}"] = arr
            else:
                out[k] = res
        return out

    with span("ensembles.percentiles"):
        da = ens
        ax = da.dims.index("realization")
        # q stays a host numpy array: the kernel takes its nodes from the host
        q = np.asarray(values, dtype=np.float32) / np.float32(100.0)
        if weights is None:
            res = nan_quantile(da.data, q, axis=ax)  # (Q, ...)
        else:
            w = torch.as_tensor(np.asarray(weights, np.float32),
                                device=da.device)
            res = _weighted_quantile(da.data, w, q, axis=ax)
        dims = ("percentiles",) + tuple(d for d in da.dims
                                        if d != "realization")
        coords = {c: v for c, v in da.coords.items() if c != "realization"}
        coords["percentiles"] = np.asarray(values)
        full = ClimArray(res, dims, coords, dict(da.attrs), da.name)
        full.attrs["description"] = (f"Percentiles of the ensemble of "
                                     f"{da.attrs.get('description', da.name or '')}")
        if not split:
            return full
        out = {}
        for i, p in enumerate(np.asarray(values)):
            arr = full.isel(percentiles=i)
            arr.name = f"{da.name or 'data'}_p{int(p):02d}"
            out[float(p)] = arr
        return out


def _weighted_quantile(x, w, q, axis):
    """Weighted quantile via the cumulative-weight inversion on sorted members
    (reference uses xr.weighted(...).quantile)."""
    xm = x.movedim(axis, -1)
    order = torch.argsort(xm, dim=-1, stable=True)
    xs = torch.take_along_dim(xm, order, dim=-1)
    ws = torch.broadcast_to(w, xm.shape).take_along_dim(order, dim=-1)
    valid = ~torch.isnan(xs)
    ws = torch.where(valid, ws, 0.0)
    cw = torch.cumsum(ws, dim=-1)
    tot = cw[..., -1:]
    # position of each sorted sample: (cw - w/2) / tot
    pos = (cw - 0.5 * ws) / torch.where(tot == 0, 1.0, tot)
    last = xs.shape[-1] - 1
    outs = []
    for qq in np.asarray(q).tolist():
        # linear interp of xs against pos at qq
        below = pos <= qq
        idx_lo = torch.clamp(below.sum(dim=-1, keepdim=True) - 1, 0, last)
        idx_hi = torch.clamp(idx_lo + 1, 0, last)
        x0 = xs.gather(-1, idx_lo)[..., 0]
        x1 = xs.gather(-1, idx_hi)[..., 0]
        p0 = pos.gather(-1, idx_lo)[..., 0]
        p1 = pos.gather(-1, idx_hi)[..., 0]
        denom = p1 - p0
        t = torch.where(denom > 0, (qq - p0) / torch.where(denom == 0, 1.0, denom),
                        0.0)
        t = torch.clamp(t, 0.0, 1.0)
        outs.append(x0 + t * (x1 - x0))
    res = torch.stack(outs, dim=0)
    allnan = (~valid).all(dim=-1)
    return torch.where(allnan[None], torch.nan, res)
