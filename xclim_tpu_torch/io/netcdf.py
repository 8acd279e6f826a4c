"""NetCDF I/O without the netCDF4/xarray stack.

NetCDF4 files are HDF5: read/write through h5py with dimension scales
(imported where it is used, so that classic files need no h5py); classic
NetCDF3 files go through the native reader (:mod:`xclim_tpu_torch.io.native`)
and, where it fails, scipy.io.netcdf_file. :data:`opens` counts which reader
served each open. Time coordinates are decoded to
:class:`~xclim_tpu_torch.core.calendar.TimeIndex` via their CF units, and
the variables go to ``device`` (default:
:func:`xclim_tpu_torch.default_device`). (Replaces the reference's
xarray/h5netcdf IO path, e.g. xclim:cli.py:54-74.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import xclim_tpu_torch
from xclim_tpu_torch.core.calendar import TimeIndex
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset

__all__ = ["open_dataset", "opens", "to_netcdf"]

#: opens served by each reader: the native classic-NetCDF reader, scipy
#: (where the native reader failed) and h5py (netCDF4 files)
opens = {"native": 0, "scipy": 0, "h5py": 0}


def _decode_attr(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.astype(str).tolist()
    if isinstance(v, np.ndarray) and v.size == 1:
        return v.item()
    return v


def _mask_and_scale(data, attrs):
    """CF packing conventions (NUG / xarray ``mask_and_scale`` semantics):
    mask ``_FillValue``/``missing_value`` on the *packed* values (any dtype,
    including the common short-int packing), then apply
    ``scale_factor``/``add_offset``. Consumes the packing attrs."""
    data = np.asarray(data)
    fills = [attrs.pop(k, None) for k in ("_FillValue", "missing_value")]
    fills = [np.asarray(f).item() for f in fills if f is not None]
    scale = attrs.pop("scale_factor", None)
    offset = attrs.pop("add_offset", None)
    mask = None
    if fills:
        mask = np.zeros(data.shape, dtype=bool)
        for f in fills:
            mask |= data == f
    if scale is not None or offset is not None:
        data = data.astype(np.float32) * np.float32(scale if scale is not None else 1.0) \
            + np.float32(offset if offset is not None else 0.0)
    if mask is not None and mask.any():
        if data.dtype.kind != "f":
            data = data.astype(np.float32)
        data = np.where(mask, np.nan, data)
    return data


def _is_hdf5(path) -> bool:
    with open(path, "rb") as f:
        magic = f.read(8)
    return magic[:4] == b"\x89HDF"


def _array(data, dims, coords, attrs, name, device) -> ClimArray:
    """A variable's values as a ClimArray on `device` (floats as float32)."""
    data = np.asarray(data)
    if data.dtype.kind == "f":
        data = data.astype(np.float32, copy=False)
    return ClimArray(data, tuple(dims), coords, attrs, name, device=device)


def open_dataset(path, decode_times: bool = True, device=None) -> ClimDataset:
    """Open a NetCDF file (classic or netCDF4/HDF5) as a ClimDataset whose
    variables are on `device` (default:
    :func:`xclim_tpu_torch.default_device`)."""
    path = Path(path)
    if device is None:
        device = xclim_tpu_torch.default_device()
    if _is_hdf5(path):
        return _open_h5(path, decode_times, device)
    return _open_nc3(path, decode_times, device)


def _open_h5(path, decode_times, device) -> ClimDataset:
    import h5py

    ds = ClimDataset()
    with h5py.File(path, "r") as f:
        # coordinate variables: name == a dimension (has CLASS=DIMENSION_SCALE)
        coords_raw = {}
        varnames = []
        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            if obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                coords_raw[name] = (obj[()], {k: _decode_attr(v)
                                              for k, v in obj.attrs.items()
                                              if not k.startswith(("CLASS", "NAME",
                                                                   "REFERENCE_LIST",
                                                                   "_Netcdf4"))})
            else:
                varnames.append(name)
        time_idx = None
        if "time" in coords_raw and decode_times:
            vals, attrs = coords_raw["time"]
            units = attrs.get("units", "days since 1970-01-01")
            calendar = attrs.get("calendar", "standard")
            time_idx = TimeIndex.from_cf(np.asarray(vals), units, calendar)
        for name in varnames:
            obj = f[name]
            dims = []
            for i in range(obj.ndim):
                dim_name = None
                try:
                    scales = obj.dims[i]
                    if len(scales):
                        dim_name = scales[0].name.split("/")[-1]
                except Exception:
                    pass
                dims.append(dim_name or f"dim_{i}")
            attrs = {k: _decode_attr(v) for k, v in obj.attrs.items()
                     if not k.startswith(("DIMENSION_LIST", "_Netcdf4", "CLASS",
                                          "NAME"))}
            data = _mask_and_scale(obj[()], attrs)
            coords = {}
            for d in dims:
                if d == "time" and time_idx is not None:
                    coords["time"] = time_idx
                elif d in coords_raw:
                    coords[d] = np.asarray(coords_raw[d][0])
            ds[name] = _array(data, dims, coords, attrs, name, device)
        ds.attrs = {k: _decode_attr(v) for k, v in f.attrs.items()}
    opens["h5py"] += 1
    return ds


def _open_nc3(path, decode_times, device) -> ClimDataset:
    # fast path: native mmap reader (xclim_tpu_torch/io/native, C++); any
    # failure of it falls back to scipy, as the reference does
    try:
        ds = _open_nc3_native(path, decode_times, device)
        opens["native"] += 1
        return ds
    except Exception:
        pass
    from scipy.io import netcdf_file

    ds = ClimDataset()
    with netcdf_file(str(path), "r", mmap=False) as f:
        time_idx = None
        if "time" in f.variables and decode_times:
            tv = f.variables["time"]
            units = _decode_attr(getattr(tv, "units", b"days since 1970-01-01"))
            calendar = _decode_attr(getattr(tv, "calendar", b"standard"))
            time_idx = TimeIndex.from_cf(np.asarray(tv[:]), units, calendar)
        for name, var in f.variables.items():
            if name in f.dimensions:
                continue
            dims = var.dimensions
            attrs = {k: _decode_attr(v) for k, v in var._attributes.items()}
            data = _mask_and_scale(np.asarray(var[:]), attrs)
            coords = {}
            for d in dims:
                if d == "time" and time_idx is not None:
                    coords["time"] = time_idx
                elif d in f.variables:
                    coords[d] = np.asarray(f.variables[d][:])
            ds[name] = _array(data, dims, coords, attrs, name, device)
        ds.attrs = {k: _decode_attr(v) for k, v in f._attributes.items()}
    opens["scipy"] += 1
    return ds


def to_netcdf(ds: ClimDataset | ClimArray, path, engine: str = "h5") -> None:
    """Write a ClimDataset to a netCDF4 (HDF5) file readable by netCDF tools
    (needs h5py, imported here)."""
    import h5py

    if isinstance(ds, ClimArray):
        ds = ClimDataset({ds.name or "data": ds})
    path = Path(path)
    with h5py.File(path, "w") as f:
        written_dims: dict[str, int] = {}
        # collect dim sizes
        for da in ds.values():
            for d, s in zip(da.dims, da.shape):
                written_dims.setdefault(d, s)
        # coordinate variables
        for d, size in written_dims.items():
            coord = None
            attrs = {}
            for da in ds.values():
                if d in da.coords:
                    c = da.coords[d]
                    if isinstance(c, TimeIndex):
                        coord = np.asarray(c.to_cf("days since 1970-01-01"),
                                           dtype=np.float64)
                        attrs = {"units": "days since 1970-01-01",
                                 "calendar": c.calendar,
                                 "standard_name": "time"}
                    else:
                        coord = np.asarray(c)
                    break
            if coord is None:
                coord = np.arange(size)
            dset = f.create_dataset(d, data=coord)
            dset.make_scale(d)
            for k, v in attrs.items():
                dset.attrs[k] = v
        for name, da in ds.items():
            v = f.create_dataset(name, data=np.asarray(da.values))
            for i, d in enumerate(da.dims):
                v.dims[i].attach_scale(f[d])
            for k, val in da.attrs.items():
                if val is None:
                    continue
                if isinstance(val, (list, tuple)) and val and isinstance(val[0], str):
                    val = [s.encode() for s in val]
                try:
                    v.attrs[k] = val
                except TypeError:
                    v.attrs[k] = str(val)
        for k, val in ds.attrs.items():
            try:
                f.attrs[k] = val
            except TypeError:
                f.attrs[k] = str(val)


def _open_nc3_native(path, decode_times, device) -> ClimDataset:
    from xclim_tpu_torch.io.native import NativeNC3

    ds = ClimDataset()
    with NativeNC3(path) as nc:
        allvars = nc.variables()
        time_idx = None
        if "time" in allvars and decode_times:
            dims, vals, attrs = allvars["time"]
            units = attrs.get("units", "days since 1970-01-01")
            calendar = attrs.get("calendar", "standard")
            time_idx = TimeIndex.from_cf(np.asarray(vals), units, calendar)
        for name, (dims, data, attrs) in allvars.items():
            if name in nc.dims:
                continue
            data = _mask_and_scale(np.asarray(data), attrs)
            coords = {}
            for d in dims:
                if d == "time" and time_idx is not None:
                    coords["time"] = time_idx
                elif d in allvars:
                    coords[d] = np.asarray(allvars[d][1])
            ds[name] = _array(data, dims, coords, attrs, name, device)
        ds.attrs = nc.global_attrs
    return ds
