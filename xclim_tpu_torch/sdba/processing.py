"""Pre/post-processing utilities for bias adjustment
(reference: the external xsdba package's ``processing`` module, re-exported
through xclim.sdba — xclim:src/xclim/sdba.py).

Every randomized operation draws from an explicit ``torch.Generator`` on
the data's device (a generator seeded with 0 when none is given): the same
generator state gives the same draw, and no global RNG state is read."""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.units import convert_units_to, str2pint
from xclim_tpu_torch.sdba.grouping import Grouper
from xclim_tpu_torch.sdba.utils import generator_or_default

__all__ = [
    "adapt_freq",
    "escore",
    "from_additive_space",
    "jitter",
    "jitter_over_thresh",
    "jitter_under_thresh",
    "normalize",
    "reordering",
    "stack_variables",
    "standardize",
    "to_additive_space",
    "unstack_variables",
    "unstandardize",
]


def _thresh(value, like: ClimArray) -> float:
    if isinstance(value, str):
        return convert_units_to(str2pint(value), like)
    return float(value)


def _uniform(gen: torch.Generator, shape, lo, hi, like: torch.Tensor):
    """Uniform draws in [lo, hi) of like's dtype, on like's device."""
    u = torch.rand(tuple(shape), generator=gen, device=like.device)
    return (lo + u * (hi - lo)).to(like.dtype)


def jitter_under_thresh(x: ClimArray, thresh, generator=None) -> ClimArray:
    """Replace values under `thresh` by uniform noise in (0, thresh)
    (xsdba processing.jitter_under_thresh). Breaks ties among censored
    values (e.g. zero precipitation) before quantile mapping."""
    return jitter(x, lower=thresh, generator=generator)


def jitter_over_thresh(x: ClimArray, thresh, upper_bnd,
                       generator=None) -> ClimArray:
    """Replace values above `thresh` by uniform noise in (thresh, upper_bnd)
    (xsdba processing.jitter_over_thresh)."""
    return jitter(x, upper=thresh, maximum=upper_bnd, generator=generator)


def jitter(x: ClimArray, lower=None, upper=None, minimum=None, maximum=None,
           generator=None) -> ClimArray:
    """Replace values under `lower` (resp. over `upper`) by uniform noise in
    (minimum|0, lower) (resp. (upper, maximum)) (xsdba processing.jitter)."""
    gen = generator_or_default(generator, x.data.device)
    data = x.data
    if lower is not None:
        lo = _thresh(lower, x)
        mn = _thresh(minimum, x) if minimum is not None else 0.0
        noise = _uniform(gen, data.shape, mn, lo, data)
        data = torch.where(data < lo, noise, data)
    if upper is not None:
        if maximum is None:
            raise ValueError("`maximum` must be given with `upper`.")
        up = _thresh(upper, x)
        noise = _uniform(gen, data.shape, up, _thresh(maximum, x), data)
        data = torch.where(data > up, noise, data)
    out = x.copy(data=data)
    out.attrs = dict(x.attrs)
    return out


def adapt_freq(ref: ClimArray, sim: ClimArray, *, group="time",
               thresh="0 mm d-1", generator=None):
    """Adapt the frequency of values under `thresh` in sim to match ref
    (Themeßl et al. 2012; xsdba processing.adapt_freq).

    Where sim has a larger dry-day fraction P0_sim than ref's P0_ref, the
    excess dry steps (fraction dP0 = (P0_sim − P0_ref)/P0_sim of them) get a
    uniform random value in (thresh, pth], pth being ref's quantile at
    P0_sim — so the wet-day frequency matches without disturbing the wet
    distribution's upper part.

    Returns (sim_ad, pth, dP0); pth/dP0 per group (group axis dropped for
    group='time'), as the reference does.
    """
    from xclim_tpu_torch.sdba.properties import _gather, _wrap

    gr = group if isinstance(group, Grouper) else Grouper(group)
    sim = convert_units_to(sim, ref)
    th = _thresh(thresh, ref)

    gref = _gather(ref, gr)   # (G, m, ...)
    gsim = _gather(sim, gr)

    def dry_frac(g):
        return torch.nanmean(torch.where(torch.isnan(g), torch.nan,
                                         (g < th).to(torch.float32)), dim=1)

    P0r = dry_frac(gref)
    P0s = dry_frac(gsim)
    dP0 = torch.clamp((P0s - P0r) / torch.where(P0s == 0, torch.nan, P0s),
                      min=0.0)
    # pth: REF's value at SIM's dry-day probability — the wet intensity the
    # reference reaches at that probability level; adapted dry steps land in
    # (thresh, pth]. Per-lane varying-q quantile via sort + fractional index.
    gq = gref.movedim(1, 0)  # (m, G, ...)
    s = torch.sort(gq, dim=0).values
    nv = (~torch.isnan(gq)).sum(dim=0)
    top = torch.clamp(nv - 1, min=0)
    h = torch.minimum(torch.clamp(P0s * (nv - 1), min=0), top).to(torch.float32)
    k0 = torch.floor(h).to(torch.int64)
    k1 = torch.minimum(k0 + 1, top)
    g0 = s.gather(0, k0[None])[0]
    g1 = s.gather(0, k1[None])[0]
    pth = g0 + (h - k0) * (g1 - g0)

    ax = sim.time_axis
    xf = sim.data.movedim(ax, 0)
    gid = gr.device_group_of_step(sim.time, xf.device)
    pth_t = pth[gid]
    dP0_t = dP0[gid]
    gen = generator_or_default(generator, xf.device)
    u = torch.rand(tuple(xf.shape), generator=gen, device=xf.device)
    # among the dry steps, convert the dP0 fraction with the smallest u
    wet_val = th + torch.rand(tuple(xf.shape), generator=gen,
                              device=xf.device) * torch.clamp(pth_t - th,
                                                              min=0)
    convert = (xf < th) & (u < dP0_t) & (pth_t > th)
    out = torch.where(convert, wet_val.to(xf.dtype), xf)
    sim_ad = sim.copy(data=out.movedim(0, ax))
    sim_ad.attrs = dict(sim.attrs)
    pth_a = _wrap(sim, pth, gr, sim.attrs.get("units", ""), "pth")
    dP0_a = _wrap(sim, dP0, gr, "", "dP0")
    return sim_ad, pth_a, dP0_a


def normalize(data: ClimArray, *, group="time", kind: str = "+"):
    """Subtract (or divide by) the per-group mean
    (xsdba processing.normalize). Returns (normalized, norm)."""
    from xclim_tpu_torch.sdba.adjustment import _grouped_mean
    from xclim_tpu_torch.sdba.properties import _wrap

    gr = group if isinstance(group, Grouper) else Grouper(group)
    norm = _grouped_mean(data, gr)  # (G, ...)
    ax = data.time_axis
    xf = data.data.movedim(ax, 0)
    nt = norm[gr.device_group_of_step(data.time, xf.device)]
    out = xf - nt if kind == "+" else xf / torch.where(nt == 0, torch.nan, nt)
    res = data.copy(data=out.movedim(0, ax))
    res.attrs = dict(data.attrs)
    if kind == "*":
        res.attrs["units"] = ""
    return res, _wrap(data, norm, gr, data.attrs.get("units", ""), "norm")


def standardize(da: ClimArray, mean=None, std=None, dim: str = "time"):
    """(da − mean)/std along `dim` (xsdba processing.standardize).
    Returns (standardized, mean, std)."""
    mu = da.mean(dim=dim) if mean is None else mean
    sd = da.std(dim=dim) if std is None else std
    out = (da - mu) / sd
    out.attrs["units"] = ""
    return out, mu, sd


def unstandardize(da: ClimArray, mean, std) -> ClimArray:
    """Inverse of :func:`standardize`."""
    out = da * std + mean
    out.attrs["units"] = std.attrs.get("units", "")
    return out


def reordering(ref: ClimArray, sim: ClimArray) -> ClimArray:
    """Reorder sim along time so its rank structure matches ref's (the
    Schaake-shuffle step of multivariate methods; xsdba
    processing.reordering): output[t] holds sim's k-th smallest value where
    k is the rank of ref[t]."""
    ax = ref.time_axis
    r = ref.data.movedim(ax, 0)
    s = convert_units_to(sim, ref).data.movedim(ax, 0)
    # stable sorts, as jnp.argsort: ties keep time order
    order = torch.argsort(r, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    out = torch.sort(s, dim=0).values.gather(0, ranks)
    res = sim.copy(data=out.movedim(0, ax))
    res.attrs = dict(ref.attrs)
    return res


def to_additive_space(data: ClimArray, lower_bound, upper_bound=None,
                      trans: str = "log") -> ClimArray:
    """Transform a bounded variable to (−∞, ∞) (xsdba
    processing.to_additive_space): ``log(x − lb)`` or
    ``logit((x − lb)/(ub − lb))``."""
    lb = _thresh(lower_bound, data)
    x = data.data - lb
    if trans == "log":
        out = torch.log(torch.where(x <= 0, torch.nan, x))
    elif trans == "logit":
        if upper_bound is None:
            raise ValueError("logit transform needs `upper_bound`.")
        ub = _thresh(upper_bound, data)
        p = x / (ub - lb)
        p = torch.where((p <= 0) | (p >= 1), torch.nan, p)
        out = torch.log(p / (1 - p))
    else:
        raise NotImplementedError(trans)
    res = data.copy(data=out)
    res.attrs = {"units": "",
                 "sdba_transform": trans,
                 "sdba_transform_lower": float(lb)}
    if upper_bound is not None:
        res.attrs["sdba_transform_upper"] = _thresh(upper_bound, data)
    if data.attrs.get("units") is not None:
        res.attrs["sdba_transform_units"] = data.attrs.get("units", "")
    return res


def from_additive_space(data: ClimArray, lower_bound=None, upper_bound=None,
                        trans: str | None = None,
                        units: str | None = None) -> ClimArray:
    """Inverse of :func:`to_additive_space`; parameters default to the attrs
    stamped by the forward transform."""
    trans = trans or data.attrs.get("sdba_transform")
    lb = data.attrs.get("sdba_transform_lower", 0.0) if lower_bound is None \
        else _thresh(lower_bound, data)
    units = units or data.attrs.get("sdba_transform_units", "")
    if trans == "log":
        out = torch.exp(data.data) + lb
    elif trans == "logit":
        ub = data.attrs.get("sdba_transform_upper") if upper_bound is None \
            else _thresh(upper_bound, data)
        p = 1 / (1 + torch.exp(-data.data))
        out = p * (ub - lb) + lb
    else:
        raise NotImplementedError(str(trans))
    res = data.copy(data=out)
    res.attrs = {"units": units}
    return res


def stack_variables(ds_or_dict, dim: str = "multivar") -> ClimArray:
    """Stack the variables of a dataset/dict on a new leading dim
    (xsdba processing.stack_variables). Units are recorded per variable in
    attrs; data is NOT unit-harmonized (match the reference's behaviour of
    stacking raw magnitudes)."""
    items = list(ds_or_dict.items())
    names = [k for k, _ in items]
    first = items[0][1]
    data = torch.stack([v.data for _, v in items], dim=0)
    coords = dict(first.coords)
    coords[dim] = np.array(names)
    attrs = {"units": "",
             "_units": {k: v.attrs.get("units", "") for k, v in items}}
    return ClimArray(data, (dim,) + first.dims, coords, attrs, dim)


def unstack_variables(da: ClimArray, dim: str = "multivar") -> ClimDataset:
    """Inverse of :func:`stack_variables` → ClimDataset."""
    names = list(np.asarray(da.coords[dim]))
    units = da.attrs.get("_units", {})
    pax = da.dims.index(dim)
    out = ClimDataset()
    sub_dims = tuple(d for d in da.dims if d != dim)
    coords = {k: v for k, v in da.coords.items() if k != dim}
    for i, name in enumerate(names):
        out[str(name)] = ClimArray(da.data.select(pax, i), sub_dims,
                                   dict(coords),
                                   {"units": units.get(name, "")}, str(name))
    return out


def escore(tgt: ClimArray, sim: ClimArray, N: int = 0,
           scale: bool = False) -> float:
    """Energy score between two multivariate samples (Székely & Rizzo;
    xsdba processing.escore). Arrays are (multivar, time); lower = more
    similar. `N` subsamples each series (0 = use all). A host float: one
    device sync."""
    x = tgt.data.to(torch.float32)
    y = sim.data.to(torch.float32)
    if x.ndim == 1:
        x = x[None]
        y = y[None]
    if N:
        x = x[:, :N]
        y = y[:, :N]
    if scale:
        xy = torch.cat([x, y], dim=1)
        mu = torch.nanmean(xy, dim=1, keepdim=True)
        sd = torch.sqrt(torch.nanmean((xy - mu) ** 2, dim=1, keepdim=True))
        x = (x - mu) / sd
        y = (y - mu) / sd
    n, m = x.shape[1], y.shape[1]

    def _mean_dist(a, b):
        d = a[:, :, None] - b[:, None, :]
        return torch.nanmean(torch.sqrt(torch.sum(d * d, dim=0)))

    # Székely-Rizzo e-statistic, scaled as the reference does (×n·m/(n+m)/2)
    e = 2 * _mean_dist(x, y) - _mean_dist(x, x) - _mean_dist(y, y)
    return float(e * n * m / (n + m) / 2)
