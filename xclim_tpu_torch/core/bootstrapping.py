"""Zhang-2005 iterated bootstrap for percentile-based indices
(reference: xclim:src/xclim/core/bootstrapping.py).

The reference's per-year loop of full ``percentile_doy`` recomputes
(bootstrapping.py:81-212) becomes a batched computation: the doy-window
samples are gathered once into a (doy, year, window, ...) tensor, and for
each in-base year b the thresholds with b replaced by every other year are
computed at once, stacked on a ``_bootstrap`` dim, like the reference. The
index is recomputed with them over the days of year b's periods only (a
contiguous view of the series, with the thresholds' rows of those days),
averaged over ``_bootstrap``, and year b's periods of the plain result are
overwritten with that mean. Every period's value then depends on its own
days alone, as the reference hands the index each year's slice. Where a run
may be counted across a period's bounds (``resample_before_rl=False``), or
the output's periods are not the series' own at ``freq``, the index is
recomputed over the whole series and year b's periods taken from it.

Per-pair quantiles: tail percentiles (<= 25 % or >= 75 %: tx90p, tn10p and
kin) come from the top-k / bottom-k candidate tables of
:mod:`xclim_tpu_torch.ops.bootstrap` without any re-sort; other percentiles
re-sort the year-replaced (replacement, doy, year * window, ...) block with
:func:`~xclim_tpu_torch.ops.quantile.nan_quantile`.
"""

from __future__ import annotations

import functools
import inspect
import math

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import (
    max_doy,
    percentile_doy_table,
    resample_segments,
)
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.percentiles import _interp_doy_axis
from xclim_tpu_torch.ops.bootstrap import (
    merge_rank_replaced_year_quantile,
    topk_capacity,
    topk_rank_tables,
)
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import count, span

__all__ = ["percentile_bootstrap", "bootstrap_func"]


def percentile_bootstrap(func):
    """Decorator activating the bootstrap when ``bootstrap=True`` is passed
    (xclim:core/bootstrapping.py:22)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        ba = inspect.signature(func).bind(*args, **kwargs)
        ba.apply_defaults()
        if ba.arguments.get("bootstrap", False):
            return bootstrap_func(func, **ba.arguments)
        return func(*args, **kwargs)

    return wrapper


def _find_keys(kwargs):
    per_key = None
    da_key = None
    for name, val in kwargs.items():
        if isinstance(val, ClimArray):
            if name.endswith("_per"):
                per_key = name
            elif val.time is not None and da_key is None:
                da_key = name
    if per_key is None or da_key is None:
        raise KeyError("bootstrap requires a percentile array (name ending in _per) "
                       "and a data array argument.")
    return per_key, da_key


def _periods_days(kwargs, time, out_time, years, n_doy) -> dict | None:
    """For each of ``years`` with periods in the output, the steps of
    ``time`` its periods cover, as a slice, where the index evaluated on
    those steps alone gives the values it gives there on the whole series;
    None where it may not, and the recount takes the whole series.

    That holds where the output's periods are ``time``'s own at ``freq``
    (the slice's too), no run is counted across their bounds (which
    ``resample_before_rl=False`` does), and the thresholds' ``n_doy`` days
    of year are the series' (the index would otherwise stretch them onto
    each slice's range instead of the series').
    """
    freq = kwargs.get("freq")
    doy = time.doy
    if (freq is None or not kwargs.get("resample_before_rl", True)
            or (doy.min(), doy.max()) != (1, n_doy)):
        return None
    spec = resample_segments(time, freq)
    if spec.labels != out_time:
        return None
    bounds = np.append(spec.starts, len(time))
    days = {}
    for year in years:
        sel = np.nonzero(out_time.year == year)[0]
        if len(sel) == 0:
            continue
        steps = slice(int(bounds[sel[0]]), int(bounds[sel[-1] + 1]))
        if resample_segments(time[steps], freq).labels != out_time[sel]:
            return None
        days[year] = steps
    return days


def bootstrap_func(compute_index_func, **kwargs) -> ClimArray:
    """Bootstrap the percentile climatology year by year and average
    (xclim:core/bootstrapping.py:81)."""
    per_key, da_key = _find_keys(kwargs)
    kwargs.pop("bootstrap", None)
    per = kwargs[per_key]
    da: ClimArray = kwargs[da_key]

    clim_bounds = per.attrs.get("climatology_bounds")
    if clim_bounds is None:
        raise KeyError("The percentile array lacks `climatology_bounds` attrs; "
                       "compute it with percentile_doy.")
    window = int(per.attrs.get("window", 5))
    alpha = float(per.attrs.get("alpha", 1 / 3))
    beta = float(per.attrs.get("beta", 1 / 3))
    percentiles = np.atleast_1d(np.asarray(per.coords.get(
        "percentiles", per.attrs.get("percentiles", [90.0])), dtype=np.float32))
    keep_per_dim = "percentiles" in per.dims

    y0 = int(str(clim_bounds[0])[:4])
    y1 = int(str(clim_bounds[1])[:4])
    years = np.unique(da.time.year)
    in_base_years = years[(years >= y0) & (years <= y1)]
    if len(in_base_years) <= 1:
        raise KeyError("Bootstrap needs at least two in-base years overlapping the data.")

    # plain (non-bootstrapped) result for all periods
    with span("bootstrap.plain"):
        plain = compute_index_func(**kwargs)

    with span("bootstrap.tables"):
        # --- the in-base sample tensor (doy, year, window, ...) ---
        sub = da.sel_time(mask=np.isin(da.time.year, in_base_years))
        mx = max_doy(da.time.calendar)
        has_366 = int(sub.time.doy.max()) == 366
        if has_366:
            sub = sub.sel_time(mask=sub.time.doy < 366)
        table, doys = percentile_doy_table(sub.time, window=window)
        n_doy = len(doys)
        nyears = len(in_base_years)
        xf = sub.data.movedim(da.time_axis, 0)
        t = torch.as_tensor(table.reshape(n_doy, nyears, window),
                            dtype=torch.int64, device=xf.device)
        D = xf[t.clamp(min=0)]  # (n_doy, nyears, window, ...)
        D = torch.where((t >= 0).reshape(t.shape + (1,) * (D.ndim - 3)), D,
                        torch.nan)

        space_dims = tuple(d for d in da.dims if d != "time")
        space_coords = {k: v for k, v in da.coords.items() if k in space_dims}
        space_shape = tuple(D.shape[3:])

        # --- the per-pair quantile strategy: candidate tables for the tails
        qs_np = percentiles / 100.0
        tails = np.minimum(qs_np, 1 - qs_np)
        use_topk = bool((tails <= 0.25).all())
        if use_topk:
            N = nyears * window
            C = math.prod(space_shape)
            year_id = np.arange(nyears).repeat(window)
            K = max(topk_capacity(N, window, float(qv)) for qv in qs_np)
            tabs = topk_rank_tables(D.reshape(n_doy, N, C), year_id, K)
            Dt = D.reshape(n_doy, nyears, window, C).permute(0, 3, 1, 2)

    def per_for_replacement(b_idx: int) -> torch.Tensor:
        """(O, doy, ..., Q) percentiles with year b replaced by each other year."""
        others = torch.as_tensor([o for o in range(nyears) if o != b_idx],
                                 device=D.device)
        O = len(others)
        if use_topk:
            A_b = Dt[:, :, b_idx]                                   # (n_doy, C, w)
            A_o = Dt.index_select(2, others).movedim(2, 0)          # (O, n_doy, C, w)
            # the (n_doy, C, k) tables broadcast over O: no copy
            ps = [merge_rank_replaced_year_quantile(
                *tabs, A_b, A_o, b_idx, float(qv), alpha=alpha, beta=beta)
                for qv in qs_np]                                    # each (O, n_doy, C)
            p = torch.stack(ps, dim=-1).reshape(
                (O, n_doy) + space_shape + (len(qs_np),))
        else:
            Do = D.index_select(1, others).movedim(1, 0)    # (O, n_doy, window, ...)
            onehot = (torch.arange(nyears, device=D.device) == b_idx).reshape(
                (1, 1, nyears, 1) + (1,) * (D.ndim - 3))
            repl = torch.where(onehot, Do[:, :, None], D[None])  # (O, n_doy, nyears, window, ...)
            flat = repl.reshape((O, n_doy, nyears * window) + space_shape)
            p = nan_quantile(flat, qs_np, axis=2, alpha=alpha, beta=beta)
            p = p.movedim(0, -1)                            # (O, n_doy, ..., Q)
        if has_366:
            p = _interp_doy_axis(p.movedim(1, 0), n_doy, mx).movedim(0, 1)
        return p

    doy_coord = np.arange(1, (mx if has_366 else int(doys.max())) + 1,
                          dtype=np.int32)
    if keep_per_dim:
        pdims = ("_bootstrap", "dayofyear") + space_dims + ("percentiles",)
        pcoords = {**space_coords, "dayofyear": doy_coord,
                   "percentiles": percentiles}
    else:
        pdims = ("_bootstrap", "dayofyear") + space_dims
        pcoords = {**space_coords, "dayofyear": doy_coord}

    data = plain.data.clone()
    out_tax = plain.dims.index("time")
    # which output periods belong to each calendar year (the reference
    # groups the resampled output by year; bootstrapping.py:178-210)
    out_years = plain.time.year
    days = _periods_days(kwargs, da.time, plain.time, in_base_years,
                         len(doy_coord))
    for b_idx, b_year in enumerate(in_base_years):
        sel = np.nonzero(out_years == b_year)[0]
        if len(sel) == 0:
            continue
        with span("bootstrap.year"):
            with span("bootstrap.thresholds"):
                p = per_for_replacement(b_idx)
                if not keep_per_dim:
                    p = p[..., 0]
            with span("bootstrap.recount"):
                kw = dict(kwargs)
                if days is None:
                    count("bootstrap_whole")
                    first = int(sel[0])     # year b's first period in the result
                    kw[per_key] = ClimArray(p, pdims, pcoords,
                                            dict(per.attrs), per.name)
                else:
                    count("bootstrap_sliced")
                    steps = days[b_year]
                    kw[da_key] = ClimArray(
                        da.data.narrow(da.time_axis, steps.start,
                                       steps.stop - steps.start),
                        da.dims, {**da.coords, "time": da.time[steps]},
                        dict(da.attrs), da.name)
                    # the thresholds of the slice's days of year
                    doy = da.time[steps].doy
                    lo, hi = int(doy.min()), int(doy.max())
                    kw[per_key] = ClimArray(
                        p.narrow(1, lo - 1, hi - lo + 1), pdims,
                        {**pcoords, "dayofyear": doy_coord[lo - 1:hi]},
                        dict(per.attrs), per.name)
                    first = 0
                res_mean = compute_index_func(**kw).mean(dim="_bootstrap")
                # year b's periods, in the plain result's dim order
                take = res_mean.data.narrow(res_mean.dims.index("time"),
                                            first, len(sel))
                take = take.permute([res_mean.dims.index(d)
                                     for d in plain.dims])
                data.narrow(out_tax, int(sel[0]), len(sel)).copy_(take)

    out = plain.copy(data=data)
    out.attrs = dict(plain.attrs)
    return out
