"""Day-of-year climatological percentiles (reference: xclim percentile_doy,
src/xclim/core/calendar.py:396-497, and utils.calc_perc).

The centred rolling window + year x doy unstack of the reference is ONE
static table of time indices (built host-side by
:func:`~xclim_tpu_torch.core.calendar.percentile_doy_table`); the
Hyndman-Fan quantiles of each row's samples are
:func:`~xclim_tpu_torch.ops.doyquantile.doy_quantile`'s: one kernel launch
reading the series in place on the card, the gather and the sort quantile
elsewhere. The same table reshaped to (doy, year, window) serves the
bootstrap's year replacement.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import max_doy, percentile_doy_table
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.ops import _build, doyquantile
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import span

__all__ = [
    "percentile_doy",
    "resample_doy",
    "adjust_doy_calendar",
    "build_climatology_bounds",
    "doy_quantile_gather",
    "from_reference_percentiles",
]


def build_climatology_bounds(da: ClimArray) -> list[str]:
    """[start, end] ISO dates of the data used for the climatology
    (xclim:core/calendar.py:497)."""
    t = da.time
    return [t.isoformat(0)[:10], t.isoformat(len(t) - 1)[:10]]


def doy_quantile_gather(da: ClimArray, window: int):
    """Gather the (doy, year * window, ...) sample tensor for doy percentiles.

    Returns (samples, doys, table); samples are NaN at missing positions.
    """
    table, doys = percentile_doy_table(da.time, window=window)
    xf = da.data.movedim(da.time_axis, 0)
    t = torch.as_tensor(table, dtype=torch.int64, device=xf.device)
    return doyquantile.gather_samples(xf, t), doys, table


#: (calendar, window, the axis' days) -> percentile_doy_table's (table,
#: doys) and the table's slide flags; the few latest time axes
_PLANS: dict = {}
_PLANS_KEPT = 8


def _doy_plan(time, window: int):
    """``percentile_doy_table(time, window)`` and its
    :func:`~xclim_tpu_torch.ops.doyquantile.slide_flags`, built once per time
    axis and window: a call over the same base period reuses them (the
    table depends on the axis' days and calendar alone). The arrays are
    shared: read them, do not write them."""
    key = (time.calendar, window, time.ordinal.tobytes())
    plan = _PLANS.get(key)
    if plan is None:
        table, doys = percentile_doy_table(time, window=window)
        plan = (table, doys, doyquantile.slide_flags(table, window))
        if len(_PLANS) >= _PLANS_KEPT:
            del _PLANS[next(iter(_PLANS))]
        _PLANS[key] = plan
    return plan


def percentile_doy(arr: ClimArray, window: int = 5, per=10.0,
                   alpha: float = 1.0 / 3.0, beta: float = 1.0 / 3.0,
                   copy: bool = True) -> ClimArray:
    """Climatological percentile for each day of the year
    (xclim:core/calendar.py:396).

    Returns a ClimArray with dims ('dayofyear', ..., 'percentiles') carrying
    the ``climatology_bounds``/``window``/``alpha``/``beta`` attrs the
    bootstrap reads.
    """
    with span("percentiles.doy"):
        per_arr = np.atleast_1d(np.asarray(per, dtype=np.float32))
        mx = max_doy(arr.time.calendar)
        present_366 = int(arr.time.doy.max()) == 366
        # with a doy 366, compute on doys 1..365 and interpolate to 1..366
        # (the 366th doy has a quarter of the samples;
        # xclim:core/calendar.py:489-491)
        sub = arr.sel_time(mask=arr.time.doy < 366) if present_366 else arr

        table, doys, slides = _doy_plan(sub.time, window)
        xf = sub.data.movedim(sub.time_axis, 0)
        # the table reaches the device once per value set
        t = _build.device_copy(table.tobytes(), torch.int32,
                               xf.device).view(table.shape)
        p = doyquantile.doy_quantile(xf, t, per_arr / 100.0, alpha, beta,
                                     window=window, slides=slides,
                                     quantile=nan_quantile)
        p = p.movedim(0, -1)  # (n_doy, ..., Q)
        if present_366:
            p = _interp_doy_axis(p, len(doys), mx)
            doy_coord = np.arange(1, mx + 1, dtype=np.int32)
        else:
            doy_coord = doys

        space_dims = tuple(d for d in arr.dims if d != "time")
        dims = ("dayofyear",) + space_dims + ("percentiles",)
        coords = {k: v for k, v in arr.coords.items() if k in space_dims}
        coords["dayofyear"] = doy_coord
        coords["percentiles"] = per_arr
        attrs = dict(arr.attrs)
        attrs["climatology_bounds"] = build_climatology_bounds(arr)
        attrs["window"] = window
        attrs["alpha"] = alpha
        attrs["beta"] = beta
        return ClimArray(p, dims, coords, attrs, "per")


def _doy_positions(n_src: int, n_tgt: int) -> np.ndarray:
    """float32 positions of ``n_src`` doys stretched over 1..n_tgt.

    The reference takes them from ``jnp.linspace(1, n_tgt, n_src)``, which
    its compiler evaluates as ``1 * (1 - i*r) + i * (n_tgt*r)`` with ``r =
    f32(1 / (n_src - 1))`` and the last product-sum fused (one rounding),
    the last point set to n_tgt. ``torch.linspace`` rounds differently in
    about half of the points, so they are built here on the host with that
    sequence: equal to the reference's for 365 -> 366 (the leap-day
    interpolation) and every 360/365 source (tests/test_torch_percentiles.py).
    """
    f32, f64 = np.float32, np.float64
    i = np.arange(n_src - 1, dtype=f32)
    r = f32(f32(1.0) / f32(n_src - 1))
    head = (f32(1.0) * (f32(1.0) - (i * r).astype(f32))).astype(f32)
    pos = (head.astype(f64) + i.astype(f64) * f64(f32(f32(n_tgt) * r))).astype(f32)
    return np.append(pos, f32(n_tgt))


def _interp_doy_axis(p: torch.Tensor, n_src: int, n_tgt: int) -> torch.Tensor:
    """Linearly stretch the doy axis (axis 0) from n_src to n_tgt points
    (xclim _interpolate_doy_calendar, core/calendar.py:690). Positions and
    weights are host float32 arrays."""
    src_pos = _doy_positions(n_src, n_tgt)
    tgt = np.arange(1, n_tgt + 1, dtype=np.float32)
    idx = np.clip(np.searchsorted(src_pos, tgt, side="right") - 1, 0, n_src - 2)
    x0, x1 = src_pos[idx], src_pos[idx + 1]
    w = ((tgt - x0) / (x1 - x0)).astype(np.float32)
    wt = torch.as_tensor(w, device=p.device).reshape(
        (n_tgt,) + (1,) * (p.ndim - 1))
    it = torch.as_tensor(idx, dtype=torch.int64, device=p.device)
    return p[it] * (1 - wt) + p[it + 1] * wt


def adjust_doy_calendar(source: ClimArray, target: ClimArray) -> ClimArray:
    """Stretch a doy-indexed array onto the target's doy range
    (xclim:core/calendar.py:729)."""
    tgt_max = int(target.time.doy.max())
    tgt_min = int(target.time.doy.min())
    src_doy = source.coords["dayofyear"]
    if int(src_doy.max()) == tgt_max and int(src_doy.min()) == tgt_min:
        return source
    dax = source.dims.index("dayofyear")
    p = source.data.movedim(dax, 0)
    out = _interp_doy_axis(p, p.shape[0], tgt_max - tgt_min + 1).movedim(0, dax)
    coords = dict(source.coords)
    coords["dayofyear"] = np.arange(tgt_min, tgt_max + 1, dtype=np.int32)
    return ClimArray(out, source.dims, coords, dict(source.attrs), source.name)


def resample_doy(doy_arr: ClimArray, arr: ClimArray) -> ClimArray:
    """Broadcast a doy-indexed array onto arr's time axis
    (xclim:core/calendar.py:763)."""
    adoy = adjust_doy_calendar(doy_arr, arr)
    dax = adoy.dims.index("dayofyear")
    doy_min = int(adoy.coords["dayofyear"].min())
    idx = np.clip((arr.time.doy - doy_min).astype(np.int64), 0,
                  adoy.shape[dax] - 1)
    data = torch.index_select(adoy.data, dax,
                              torch.as_tensor(idx, device=adoy.data.device))
    dims = list(adoy.dims)
    dims[dax] = "time"
    coords = {k: v for k, v in adoy.coords.items() if k != "dayofyear"}
    coords["time"] = arr.time
    return ClimArray(data, tuple(dims), coords, dict(adoy.attrs), adoy.name)


def from_reference_percentiles(data, dims, coords: dict, attrs: dict,
                               name="per", device=None) -> ClimArray:
    """A percentile array of the port from the JAX package's
    ``percentile_doy`` output, passed as host values: ``data`` a numpy array,
    ``dims``/``coords``/``attrs`` the reference array's. The data move to
    ``device`` (default: :func:`xclim_tpu_torch.default_device`) as
    float32; the attrs (``climatology_bounds``, ``window``, ``alpha``,
    ``beta``) are what the bootstrap reads."""
    return ClimArray(np.array(data, dtype=np.float32), dims, dict(coords),
                     dict(attrs), name, device=device)
