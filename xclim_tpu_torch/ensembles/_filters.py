"""Ensemble pre-filters (reference: xclim:src/xclim/ensembles/_filters.py)."""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray

__all__ = ["_concat_hist", "_model_in_all_scens", "_single_member"]


def _concat_hist(da: ClimArray, **hist) -> ClimArray:
    """Concatenate historical scenario with the other scenarios along time
    (xclim:ensembles/_filters.py:12). e.g. ``_concat_hist(da, scenario='historical')``."""
    if len(hist) > 1:
        raise ValueError("Too many keyword arguments.")
    (dim, label), = hist.items()
    ax = da.dims.index(dim)
    labels = list(np.asarray(da.coords[dim]))
    ih = labels.index(label)
    h = da.isel(**{dim: ih})
    others = [i for i in range(len(labels)) if i != ih]
    rest = da.isel(**{dim: others})
    # the reference concatenates hist's valid time range before each
    # scenario's (xclim:_filters.py:58-66); on the shared time axis this
    # means: during the historical PERIOD (times where hist has any data)
    # every scenario takes the historical values; afterwards each scenario
    # keeps its own values — including NaN for simulations that don't exist
    h_tax = h.dims.index("time")
    hvals = np.asarray(h.values)
    hist_period = ~np.isnan(np.moveaxis(hvals, h_tax, 0)
                            .reshape(hvals.shape[h_tax], -1)).all(axis=1)
    shape = [1] * rest.ndim
    shape[rest.dims.index("time")] = hist_period.size
    mask = torch.as_tensor(hist_period.reshape(shape), device=da.device)
    hb = h.data.unsqueeze(ax)
    filled = torch.where(mask, torch.broadcast_to(hb, rest.data.shape), rest.data)
    return rest.copy(data=filled)


def _rename_dims(da: ClimArray, mapping: dict | None) -> ClimArray:
    """Rename dims per a {original: standard} mapping (the reference's
    ``da.rename(reverse_dict(dimensions))`` step, xclim:_filters.py:100-103)."""
    if not mapping:
        return da
    out = da.copy()
    out.dims = tuple(mapping.get(d, d) for d in da.dims)
    out.coords = {mapping.get(k, k): v for k, v in da.coords.items()}
    return out


def _model_in_all_scens(da: ClimArray, dimensions: dict | None = None) -> ClimArray:
    """Keep only models with at least one member with data in every scenario
    (xclim:_filters.py:68). ``dimensions`` maps original dim names onto the
    standard 'scenario'/'model'/'member' names."""
    da = _rename_dims(da, dimensions)
    other = [d for d in da.dims if d not in ("model", "scenario")]
    max_ = da.max(dim=other) if other else da
    ok = ~np.isnan(np.asarray(max_.transpose("model", "scenario").values)).any(axis=1)
    keep = np.nonzero(ok)[0]
    out = da.isel(model=keep)
    return _rename_dims(out, {v: k for k, v in (dimensions or {}).items()})


def _single_member(da: ClimArray, dimensions: dict | None = None) -> ClimArray:
    """Keep the first member with data per (model, scenario)
    (xclim:_filters.py:110-155)."""
    da = _rename_dims(da, dimensions)
    if "member" not in da.dims:
        return _rename_dims(da, {v: k for k, v in (dimensions or {}).items()})
    # first member with FULLY valid data per (scenario, model) — the
    # reference drops stacked columns with any NaN (dropna how="any",
    # xclim:_filters.py:147)
    other = [d for d in da.dims if d not in ("member", "scenario", "model")]
    v = da.transpose("scenario", "model", "member", *other)
    vals = np.asarray(v.values)
    valid = ~np.isnan(vals.reshape(vals.shape[:3] + (-1,))).any(axis=-1)
    first = np.argmax(valid, axis=-1)                       # (S, M)
    s_idx = np.arange(vals.shape[0])[:, None]
    m_idx = np.arange(vals.shape[1])[None, :]
    picked = vals[s_idx, m_idx, first]                      # (S, M, *other)
    coords = {k: c for k, c in v.coords.items() if k != "member"}
    out = ClimArray(torch.as_tensor(picked, device=da.device),
                    ("scenario", "model") + tuple(other), coords,
                    dict(da.attrs), da.name)
    return _rename_dims(out, {v2: k for k, v2 in (dimensions or {}).items()})
