"""ClimArray: the framework's labeled-array data model over a ``torch.Tensor``.

A deliberately lean xarray replacement: named dims, host-side coordinates
(numpy arrays; the time coordinate is a calendar-aware
:class:`~xclim_tpu_torch.core.calendar.TimeIndex`), CF attrs, and a torch
tensor as data. Coordinates never leave the host; the data stays on the
device it was created on, and every method returns data on that device.
"""

from __future__ import annotations

import numpy as np
import torch

import xclim_tpu_torch
from xclim_tpu_torch.core.calendar import (
    SegmentSpec,
    TimeIndex,
    resample_segments,
    select_time_mask,
)
from xclim_tpu_torch.ops.quantile import _nanmedian, _nanstd, _nanvar

__all__ = ["ClimArray", "ClimDataset", "full_like", "where", "concat",
           "broadcast_arrays"]


def _tensor(x, like: torch.Tensor | None = None,
            device=None) -> torch.Tensor:
    """x as a tensor: a tensor keeps its device; host values go to
    ``like``'s device, else ``device``, else the default device."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        device = like.device
    elif device is None:
        device = xclim_tpu_torch.default_device()
    if isinstance(x, float) or (isinstance(x, np.ndarray)
                                and x.dtype == np.float64):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, device=device)


def _nanmax(x, axis=None):
    filled = torch.where(torch.isnan(x), -torch.inf, x)
    out = filled.amax() if axis is None else filled.amax(dim=axis)
    return _all_nan_to_nan(out, x, axis)


def _nanmin(x, axis=None):
    filled = torch.where(torch.isnan(x), torch.inf, x)
    out = filled.amin() if axis is None else filled.amin(dim=axis)
    return _all_nan_to_nan(out, x, axis)


def _all_nan_to_nan(out, x, axis):
    ok = ~torch.isnan(x)
    has = ok.any() if axis is None else ok.any(dim=axis)
    return torch.where(has, out, torch.nan)


def _nansum(x, axis=None):
    return torch.nansum(x) if axis is None else torch.nansum(x, dim=axis)


def _nanmean(x, axis=None):
    return torch.nanmean(x) if axis is None else torch.nanmean(x, dim=axis)


def _count(x, axis=None):
    ok = ~torch.isnan(x) if x.is_floating_point() else torch.ones_like(
        x, dtype=torch.bool)
    return ok.sum() if axis is None else ok.sum(dim=axis)


def _any(x, axis=None):
    x = x.bool()
    return x.any() if axis is None else torch.any(x, dim=axis)


def _all(x, axis=None):
    x = x.bool()
    return x.all() if axis is None else torch.all(x, dim=axis)


class ClimArray:
    """N-d tensor with named dims, host coords and CF attrs."""

    __slots__ = ("data", "dims", "coords", "attrs", "name")
    __array_priority__ = 100

    def __init__(self, data, dims, coords=None, attrs=None, name=None,
                 device=None):
        # a tensor keeps its device; host data goes to `device`, else to
        # xclim_tpu_torch.default_device() (the card; raises without one)
        if not isinstance(data, torch.Tensor):
            data = _tensor(data, device=device)
        self.data = data
        self.dims = tuple(dims)
        if len(self.dims) != data.ndim:
            raise ValueError(f"dims {self.dims} don't match data ndim {data.ndim}")
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})
        self.name = name

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return self.data.numel()

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def values(self) -> np.ndarray:
        """The data as a host numpy array (copies it off the device)."""
        return self.data.detach().cpu().numpy()

    @property
    def time(self) -> TimeIndex | None:
        return self.coords.get("time")

    @property
    def time_axis(self) -> int:
        return self.dims.index("time")

    @property
    def units(self) -> str:
        return self.attrs.get("units", "")

    def sizes(self):
        return dict(zip(self.dims, self.shape))

    def copy(self, data=None) -> "ClimArray":
        return ClimArray(self.data if data is None else data, self.dims,
                         dict(self.coords), dict(self.attrs), self.name,
                         device=self.data.device)

    def rename(self, name) -> "ClimArray":
        out = self.copy()
        out.name = name
        return out

    def assign_attrs(self, **attrs) -> "ClimArray":
        out = self.copy()
        out.attrs.update(attrs)
        return out

    def astype(self, dtype) -> "ClimArray":
        return self.copy(data=self.data.to(dtype))

    def to(self, device) -> "ClimArray":
        """The same array with its data on ``device``."""
        return self.copy(data=self.data.to(device))

    def item(self):
        return self.data.item()

    def __repr__(self):
        coord_keys = ", ".join(self.coords)
        return (f"<ClimArray {self.name or ''}{self.shape} dims={self.dims} "
                f"coords=[{coord_keys}] units={self.attrs.get('units', '')!r}>")

    def __len__(self):
        return self.shape[0]

    # ------------------------------------------------------------------
    # broadcasting arithmetic by dim names
    # ------------------------------------------------------------------
    def _binop(self, other, fn, flip=False):
        if isinstance(other, ClimArray):
            sd, od, out_dims, coords = _align_dims(self, other)
            a = _reshape_for(self, out_dims)
            b = _reshape_for(other, out_dims)
            res = fn(b, a) if flip else fn(a, b)
            return ClimArray(res, out_dims, coords, {}, self.name)
        if isinstance(other, np.ndarray):
            other = _tensor(other, self.data)
        a, b = (other, self.data) if flip else (self.data, other)
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, device=self.data.device)
        return ClimArray(fn(a, b), self.dims, dict(self.coords), {}, self.name)

    def __add__(self, o):
        return self._binop(o, torch.add)

    def __radd__(self, o):
        return self._binop(o, torch.add, flip=True)

    def __sub__(self, o):
        return self._binop(o, torch.subtract)

    def __rsub__(self, o):
        return self._binop(o, torch.subtract, flip=True)

    def __mul__(self, o):
        return self._binop(o, torch.multiply)

    def __rmul__(self, o):
        return self._binop(o, torch.multiply, flip=True)

    def __truediv__(self, o):
        return self._binop(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binop(o, torch.true_divide, flip=True)

    def __pow__(self, o):
        return self._binop(o, torch.pow)

    def __mod__(self, o):
        return self._binop(o, torch.remainder)

    def __neg__(self):
        return self.copy(data=-self.data)

    def __abs__(self):
        return self.copy(data=torch.abs(self.data))

    def __gt__(self, o):
        return self._binop(o, torch.greater)

    def __ge__(self, o):
        return self._binop(o, torch.greater_equal)

    def __lt__(self, o):
        return self._binop(o, torch.less)

    def __le__(self, o):
        return self._binop(o, torch.less_equal)

    def __eq__(self, o):  # noqa: it's an array op, like xarray
        return self._binop(o, torch.eq)

    def __ne__(self, o):
        return self._binop(o, torch.ne)

    def __and__(self, o):
        return self._binop(o, torch.logical_and)

    def __or__(self, o):
        return self._binop(o, torch.logical_or)

    def __invert__(self):
        return self.copy(data=torch.logical_not(self.data))

    __hash__ = None

    # ------------------------------------------------------------------
    # elementwise helpers
    # ------------------------------------------------------------------
    def isnull(self) -> "ClimArray":
        if self.data.is_floating_point():
            return self.copy(data=torch.isnan(self.data))
        return self.copy(data=torch.zeros(self.shape, dtype=torch.bool,
                                          device=self.data.device))

    def notnull(self) -> "ClimArray":
        return ~self.isnull()

    def fillna(self, value) -> "ClimArray":
        if not self.data.is_floating_point():
            return self.copy()
        return self.copy(data=torch.where(torch.isnan(self.data), value,
                                          self.data))

    def where(self, cond, other=torch.nan) -> "ClimArray":
        cond_arr = cond.data if isinstance(cond, ClimArray) else _tensor(
            cond, self.data)
        if isinstance(cond, ClimArray) and cond.dims != self.dims:
            out_dims = _union_dims(self.dims, cond.dims)
            a = _reshape_for(self, out_dims)
            c = _reshape_for(cond, out_dims)
            o = _reshape_for(other, out_dims) if isinstance(other, ClimArray) else other
            coords = _merged_coords(self, cond, out_dims)
            return ClimArray(torch.where(c, a, o), out_dims, coords,
                             dict(self.attrs), self.name)
        other_arr = other.data if isinstance(other, ClimArray) else other
        return self.copy(data=torch.where(cond_arr, self.data, other_arr))

    def clip(self, min=None, max=None) -> "ClimArray":
        return self.copy(data=torch.clamp(self.data, min, max))

    def round(self) -> "ClimArray":
        return self.copy(data=torch.round(self.data))

    # ------------------------------------------------------------------
    # axis reductions
    # ------------------------------------------------------------------
    def _axes(self, dim):
        if dim is None:
            return None
        if isinstance(dim, str):
            return self.dims.index(dim)
        return tuple(self.dims.index(d) for d in dim)

    def _reduce(self, fn_nan, dim=None, keep_attrs=False):
        ax = self._axes(dim)
        data = fn_nan(self.data, axis=ax)
        if dim is None:
            out_dims = ()
        else:
            drop = {dim} if isinstance(dim, str) else set(dim)
            out_dims = tuple(d for d in self.dims if d not in drop)
        coords = {k: v for k, v in self.coords.items() if k in out_dims}
        return ClimArray(data, out_dims, coords, dict(self.attrs) if keep_attrs else {}, self.name)

    def sum(self, dim=None, **kw):
        return self._reduce(_nansum, dim, **kw)

    def mean(self, dim=None, **kw):
        return self._reduce(_nanmean, dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce(_nanstd, dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce(_nanvar, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(_nanmax, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(_nanmin, dim, **kw)

    def median(self, dim=None, **kw):
        return self._reduce(_nanmedian, dim, **kw)

    def count(self, dim=None, **kw):
        return self._reduce(_count, dim, **kw)

    def any(self, dim=None, **kw):
        return self._reduce(_any, dim, **kw)

    def all(self, dim=None, **kw):
        return self._reduce(_all, dim, **kw)

    def quantile(self, q, dim=None, **kw):
        from xclim_tpu_torch.ops.quantile import nan_quantile

        ax = self._axes(dim) if dim else None
        qa = np.atleast_1d(np.asarray(q, dtype=np.float32))
        if ax is None:
            flat = self.data.reshape(-1)
            res = nan_quantile(flat, qa, axis=0)
        else:
            res = nan_quantile(self.data, qa, axis=ax)
        drop = {dim} if isinstance(dim, str) else (set(self.dims) if dim is None else set(dim))
        out_dims = ("quantile",) + tuple(d for d in self.dims if d not in drop)
        coords = {k: v for k, v in self.coords.items() if k in out_dims}
        coords["quantile"] = qa
        out = ClimArray(res, out_dims, coords, {}, self.name)
        if np.isscalar(q):
            out = out.isel(quantile=0)
        return out

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------
    def isel(self, **indexers) -> "ClimArray":
        data = self.data
        coords = dict(self.coords)
        dims = list(self.dims)
        drop = []
        for dim, idx in indexers.items():
            ax = dims.index(dim)
            sl = [slice(None)] * data.ndim
            sl[ax] = _tensor(idx, data) if isinstance(idx, (np.ndarray, list)) else idx
            data = data[tuple(sl)]
            if dim in coords:
                if isinstance(idx, (int, np.integer)):
                    coords.pop(dim)
                else:
                    coords[dim] = coords[dim][idx]
            if isinstance(idx, (int, np.integer)):
                drop.append(dim)
        out_dims = tuple(d for d in dims if d not in drop)
        return ClimArray(data, out_dims, coords, dict(self.attrs), self.name)

    def sel_time(self, *, slice_=None, mask=None, **indexer) -> "ClimArray":
        """Select along time: by boolean mask or by calendar indexer
        (season=/month=/doy_bounds=/date_bounds= — xclim select_time)."""
        time = self.time
        if mask is None:
            if slice_ is not None:
                n = len(time)
                mask = np.zeros(n, dtype=bool)
                mask[slice_] = True
            else:
                mask = select_time_mask(time, **indexer)
        idx = np.nonzero(mask)[0]
        ax = self.time_axis
        data = torch.index_select(self.data, ax,
                                  torch.as_tensor(idx, device=self.data.device))
        coords = dict(self.coords)
        coords["time"] = time[idx]
        return ClimArray(data, self.dims, coords, dict(self.attrs), self.name)

    def select_time(self, drop: bool = False, **indexer) -> "ClimArray":
        """xclim-style indexer: with drop=False, non-selected steps become NaN
        (keeps a static shape)."""
        if not indexer or all(v is None for v in indexer.values()):
            return self
        time = self.time
        mask = select_time_mask(time, **{k: v for k, v in indexer.items() if v is not None})
        if drop:
            return self.sel_time(mask=mask)
        ax = self.time_axis
        shape = [1] * self.ndim
        shape[ax] = len(mask)
        m = torch.as_tensor(mask, device=self.data.device).reshape(shape)
        data = torch.where(m, self.data, torch.nan)
        return self.copy(data=data)

    def shift_time(self, n: int, fill_value=float("nan")) -> "ClimArray":
        ax = self.time_axis
        data = torch.roll(self.data, n, dims=ax)
        sl = [slice(None)] * self.ndim
        if n > 0:
            sl[ax] = slice(0, n)
        else:
            sl[ax] = slice(self.shape[ax] + n, None)
        data[tuple(sl)] = fill_value
        return self.copy(data=data)

    def diff_time(self, n: int = 1) -> "ClimArray":
        ax = self.time_axis
        data = torch.diff(self.data, n=n, dim=ax)
        coords = dict(self.coords)
        coords["time"] = self.time[n:]
        return ClimArray(data, self.dims, coords, dict(self.attrs), self.name)

    # ------------------------------------------------------------------
    # resample / rolling
    # ------------------------------------------------------------------
    def resample(self, freq: str) -> "Resampler":
        return Resampler(self, freq)

    def segments(self, freq: str) -> SegmentSpec:
        return resample_segments(self.time, freq)

    def rolling(self, window: int, center: bool = False,
                min_periods: int | None = None) -> "Roller":
        return Roller(self, window, center, min_periods)

    def broadcast_like(self, other: "ClimArray") -> "ClimArray":
        out_dims = other.dims
        a = _reshape_for(self, out_dims)
        data = torch.broadcast_to(a, other.shape)
        return ClimArray(data, out_dims, dict(other.coords), dict(self.attrs), self.name)

    def transpose(self, *dims) -> "ClimArray":
        perm = [self.dims.index(d) for d in dims]
        return ClimArray(self.data.permute(perm), tuple(dims),
                         dict(self.coords), dict(self.attrs), self.name)

    def expand_dims(self, dim: str, size: int = 1, axis: int = 0, coord=None) -> "ClimArray":
        data = self.data.unsqueeze(axis)
        data = torch.broadcast_to(data, data.shape[:axis] + (size,) + data.shape[axis + 1:])
        dims = self.dims[:axis] + (dim,) + self.dims[axis:]
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = coord
        return ClimArray(data, dims, coords, dict(self.attrs), self.name)


def _union_dims(a_dims, b_dims):
    out = list(a_dims)
    for d in b_dims:
        if d not in out:
            out.append(d)
    return tuple(out)


def _align_dims(a: ClimArray, b: ClimArray):
    out_dims = _union_dims(a.dims, b.dims)
    return a.dims, b.dims, out_dims, _merged_coords(a, b, out_dims)


def _merged_coords(a: ClimArray, b: ClimArray, out_dims):
    coords = {}
    for src in (b, a):  # a wins
        for k, v in src.coords.items():
            if k in out_dims or k in ("quantile",):
                coords[k] = v
    return coords


def _reshape_for(arr: ClimArray, out_dims):
    """Reshape arr.data so its dims line up with out_dims (size-1 for missing)."""
    data = arr.data
    # permute existing dims into out_dims order
    present = [d for d in out_dims if d in arr.dims]
    perm = [arr.dims.index(d) for d in present]
    data = data.permute(perm)
    src_shapes = dict(zip(present, data.shape))
    shape = [src_shapes.get(d, 1) for d in out_dims]
    return data.reshape(shape)


class Resampler:
    """``da.resample(freq)`` handle; reductions go to the segment engine
    (:func:`~xclim_tpu_torch.ops.segments.segment_reduce`)."""

    def __init__(self, da: ClimArray, freq: str):
        self.da = da
        self.freq = freq
        self.spec = resample_segments(da.time, freq)

    def _apply(self, op, keep_attrs=False, **kw):
        from xclim_tpu_torch.ops.segments import segment_reduce

        da = self.da
        data = segment_reduce(da.data, self.spec, op, axis=da.time_axis, **kw)
        coords = dict(da.coords)
        coords["time"] = self.spec.labels
        attrs = dict(da.attrs) if keep_attrs else {}
        return ClimArray(data, da.dims, coords, attrs, da.name)

    def mean(self, keep_attrs=False):
        return self._apply("mean", keep_attrs=keep_attrs)

    def sum(self, keep_attrs=False):
        return self._apply("sum", keep_attrs=keep_attrs)

    def max(self, keep_attrs=False):
        return self._apply("max", keep_attrs=keep_attrs)

    def min(self, keep_attrs=False):
        return self._apply("min", keep_attrs=keep_attrs)

    def std(self, keep_attrs=False):
        return self._apply("std", keep_attrs=keep_attrs)

    def var(self, keep_attrs=False):
        return self._apply("var", keep_attrs=keep_attrs)

    def median(self, keep_attrs=False):
        return self._apply("median", keep_attrs=keep_attrs)

    def count(self):
        return self._apply("count")

    def any(self):
        return self._apply("any")

    def all(self):
        return self._apply("all")

    def argmax_doy(self):
        """Day-of-year of the per-period maximum (for *_doy indices)."""
        return self._arg_doy("max")

    def argmin_doy(self):
        return self._arg_doy("min")

    def _arg_doy(self, op):
        from xclim_tpu_torch.ops.segments import segment_argminmax

        da = self.da
        idx, has = segment_argminmax(da.data, self.spec, op, axis=da.time_axis)
        doys = torch.as_tensor(
            np.concatenate([da.time.doy, [0]]).astype(np.float32),
            device=da.data.device)
        vals = doys[torch.where(idx >= 0, idx, len(da.time)).long()]
        vals = torch.where(has, vals, torch.nan)
        coords = dict(da.coords)
        coords["time"] = self.spec.labels
        return ClimArray(vals, da.dims, coords, {}, da.name)


class Roller:
    """``da.rolling(window)`` handle over the time axis."""

    def __init__(self, da: ClimArray, window: int, center: bool, min_periods):
        self.da = da
        self.window = window
        self.center = center
        self.min_periods = min_periods

    def _apply(self, op):
        from xclim_tpu_torch.ops.segments import rolling_reduce

        da = self.da
        data = rolling_reduce(da.data, self.window, op, axis=da.time_axis,
                              min_periods=self.min_periods, center=self.center)
        return da.copy(data=data)

    def sum(self):
        return self._apply("sum")

    def mean(self):
        return self._apply("mean")

    def max(self):
        return self._apply("max")

    def min(self):
        return self._apply("min")

    def std(self):
        return self._apply("std")

    def var(self):
        return self._apply("var")


class ClimDataset:
    """Mapping of variable name -> ClimArray with shared coords."""

    def __init__(self, data_vars: dict[str, ClimArray] | None = None,
                 attrs=None):
        self.data_vars: dict[str, ClimArray] = dict(data_vars or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, key) -> ClimArray:
        return self.data_vars[key]

    def __setitem__(self, key, val: ClimArray):
        val = val.rename(key) if val.name != key else val
        self.data_vars[key] = val

    def __contains__(self, key):
        return key in self.data_vars

    def __iter__(self):
        return iter(self.data_vars)

    def __len__(self):
        return len(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def values(self):
        return self.data_vars.values()

    def items(self):
        return self.data_vars.items()

    def get(self, key, default=None):
        return self.data_vars.get(key, default)

    @property
    def time(self):
        for v in self.data_vars.values():
            if v.time is not None:
                return v.time
        return None

    def copy(self):
        return ClimDataset(dict(self.data_vars), dict(self.attrs))

    def __repr__(self):
        inner = ", ".join(f"{k}{v.shape}" for k, v in self.data_vars.items())
        return f"<ClimDataset {inner}>"


def full_like(da: ClimArray, fill, dtype=None) -> ClimArray:
    data = torch.full(da.shape, fill, dtype=dtype or da.dtype,
                      device=da.data.device)
    return ClimArray(data, da.dims, dict(da.coords), dict(da.attrs), da.name)


def where(cond: ClimArray, x, y) -> ClimArray:
    """xr.where equivalent."""
    if isinstance(x, ClimArray):
        return x.where(cond, y)
    if isinstance(y, ClimArray):
        out_dims = _union_dims(y.dims, cond.dims)
        c = _reshape_for(cond, out_dims)
        b = _reshape_for(y, out_dims)
        coords = _merged_coords(y, cond, out_dims)
        return ClimArray(torch.where(c, x, b), out_dims, coords,
                         dict(y.attrs), y.name)
    return cond.copy(data=torch.where(cond.data, x, y))


def concat(arrays: list[ClimArray], dim: str, coord=None) -> ClimArray:
    """Concatenate along a new or existing dim."""
    first = arrays[0]
    if dim in first.dims:
        ax = first.dims.index(dim)
        data = torch.cat([a.data for a in arrays], dim=ax)
        coords = dict(first.coords)
        if dim in coords and all(dim in a.coords for a in arrays):
            vals = [a.coords[dim] for a in arrays]
            if isinstance(vals[0], TimeIndex):
                coords[dim] = TimeIndex(
                    *(np.concatenate([getattr(v, f) for v in vals])
                      for f in ("year", "month", "day", "hour", "minute",
                                "second")),
                    vals[0].calendar)
            else:
                coords[dim] = np.concatenate(vals)
        return ClimArray(data, first.dims, coords, dict(first.attrs),
                         first.name)
    data = torch.stack([a.data for a in arrays], dim=0)
    dims = (dim,) + first.dims
    coords = dict(first.coords)
    if coord is not None:
        coords[dim] = np.asarray(coord)
    return ClimArray(data, dims, coords, dict(first.attrs), first.name)


def broadcast_arrays(*arrays: ClimArray) -> list[ClimArray]:
    out_dims = ()
    for a in arrays:
        out_dims = _union_dims(out_dims, a.dims)
    datas = [_reshape_for(a, out_dims) for a in arrays]
    shape = tuple(max(d.shape[i] for d in datas) for i in range(len(out_dims)))
    coords = {}
    for a in arrays:
        for k, v in a.coords.items():
            if k in out_dims and k not in coords:
                coords[k] = v
    return [ClimArray(torch.broadcast_to(d, shape), out_dims, dict(coords),
                      dict(a.attrs), a.name)
            for d, a in zip(datas, arrays)]
