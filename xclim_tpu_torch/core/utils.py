"""Misc core utilities (reference: xclim:src/xclim/core/utils.py): the
public percentile entry points around :mod:`xclim_tpu_torch.ops.quantile`,
the clix-meta adapter and compatibility helpers. Dask-specific machinery
(``uses_dask``, chunk handling) is kept as no-op shims: data are dense
tensors on one device.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

import xclim_tpu_torch
from xclim_tpu_torch.core.indicator import InputKind, infer_kind_from_parameter  # noqa: F401
from xclim_tpu_torch.ops.quantile import nan_quantile

__all__ = [
    "InputKind",
    "adapt_clix_meta_yaml",
    "calc_perc",
    "deprecated",
    "ensure_chunk_size",
    "infer_kind_from_parameter",
    "is_percentile_dataarray",
    "lazy_indexing",
    "load_module",
    "nan_calc_percentiles",
    "split_auxiliary_coordinates",
    "uses_dask",
]


def deprecated(from_version: str | None = None, suggested: str | None = None):
    """Mark a function as deprecated (xclim:core/utils.py:deprecated)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            msg = f"`{func.__name__}` is deprecated"
            if from_version:
                msg += f" since {from_version}"
            if suggested:
                msg += f"; use `{suggested}` instead"
            warnings.warn(msg, FutureWarning, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator


def load_module(path, name: str | None = None):
    """Load a python module from a path (xclim:core/utils.py:load_module)."""
    import importlib.util
    from pathlib import Path

    path = Path(path)
    spec = importlib.util.spec_from_file_location(name or path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def uses_dask(*args) -> bool:
    """Always False: there is no dask here (xclim:core/utils.py:177)."""
    return False


def ensure_chunk_size(da, **minchunks):
    """No-op: arrays are dense tensors, not chunked (xclim:core/utils.py)."""
    return da


def lazy_indexing(da, index, dim=None):
    """Gather values of `da` along its first axis at (possibly
    array-valued) integer indices, on `da`'s device
    (xclim:core/utils.py:202). As the reference's ``jnp.take``: a NaN index
    reads position 0, a negative one counts from the end, and one out of
    range gives NaN (the lowest integer for integer data)."""
    data = da.data if hasattr(da, "data") else torch.as_tensor(da)
    idx = index.data if hasattr(index, "data") else torch.as_tensor(index)
    idx = idx.to(data.device)
    if idx.is_floating_point():
        idx = torch.nan_to_num(idx, nan=0.0)
    idx = idx.to(torch.int64)
    n = data.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.index_select(data, 0, idx.clamp(0, max(n - 1, 0)).reshape(-1))
    out = out.reshape(tuple(idx.shape) + tuple(data.shape[1:]))
    fill = torch.nan if data.is_floating_point() else torch.iinfo(data.dtype).min
    out = torch.where(ok.reshape(ok.shape + (1,) * (data.ndim - 1)), out, fill)
    if hasattr(index, "copy"):
        res = index.copy(data=out)
        res.attrs = dict(getattr(da, "attrs", {}))
        return res
    return out


def calc_perc(arr, percentiles=None, alpha: float = 1.0, beta: float = 1.0,
              copy: bool = True, device=None) -> np.ndarray:
    """NaN-aware Hyndman-Fan percentiles along the LAST axis, with the
    percentile axis last (the reference's apply_ufunc kernel,
    xclim:core/utils.py:279). Returns a host numpy array, as the
    reference does."""
    return nan_calc_percentiles(arr, percentiles, axis=-1, alpha=alpha,
                                beta=beta, copy=copy, device=device)


def nan_calc_percentiles(arr, percentiles=None, axis=-1, alpha: float = 1.0,
                         beta: float = 1.0, copy: bool = True,
                         device=None) -> np.ndarray:
    """NaN-aware percentiles along `axis`, with the percentile axis appended
    last (xclim:core/utils.py:326). Returns a host numpy array. A tensor is
    computed on its device; host values on ``device`` (default:
    :func:`xclim_tpu_torch.default_device`)."""
    if percentiles is None:
        percentiles = [50.0]
    q = np.asarray(percentiles, dtype=np.float32) / 100.0
    if not isinstance(arr, torch.Tensor) and device is None:
        device = xclim_tpu_torch.default_device()
    x = torch.as_tensor(arr, dtype=torch.float32, device=device)
    out = nan_quantile(x.movedim(axis, 0), q, axis=0, alpha=alpha, beta=beta)
    return out.movedim(0, -1).cpu().numpy()


def is_percentile_dataarray(da) -> bool:
    """Whether an array carries doy-percentile climatology metadata
    (xclim:core/utils.py)."""
    return (hasattr(da, "attrs")
            and da.attrs.get("climatology_bounds") is not None
            and ("percentiles" in getattr(da, "coords", {})
                 or "percentiles" in da.attrs))


def split_auxiliary_coordinates(obj):
    """Split auxiliary (non-dimension) coordinates off an array
    (xclim:core/utils.py:926). Returns (obj_without_aux, aux_dict)."""
    dims = set(getattr(obj, "dims", ()))
    aux = {}
    keep = {}
    for k, v in getattr(obj, "coords", {}).items():
        if k in dims or k == "time":
            keep[k] = v
        else:
            aux[k] = v
    if not aux:
        return obj, {}
    out = obj.copy()
    out.coords = keep
    return out, aux


#: cell_methods that describe how a DAILY input variable was derived — a
#: clix-meta output whose first cell_method restates one of these is
#: describing its input, not the indicator's operation
#: (xclim:core/utils.py:31-36)
_INPUT_CELL_METHODS = {
    "tasmin": "time: minimum within days",
    "tasmax": "time: maximum within days",
    "tas": "time: mean within days",
    "pr": "time: sum within days",
}


def adapt_clix_meta_yaml(raw, adapted) -> None:
    """Convert a clix-meta ``indices`` YAML into this framework's module
    YAML, ready for :func:`build_indicator_module_from_yaml`
    (behavioral contract of xclim:core/utils.py:734-879).

    Parameters
    ----------
    raw : path, file-like or str
        The clix-meta document (a path to it, or its text).
    adapted : path
        Where to write the adapted module YAML.

    Indices whose ``index_function`` has no implementation in
    :mod:`xclim_tpu_torch.indices.generic`, whose standard name is a
    ``number_of_days``/``precipitation_amount`` form (unit conventions this
    framework and clix-meta disagree on), or named ``nzero`` are dropped
    with a warning.
    """
    import os as _os

    import yaml as _yaml

    from xclim_tpu_torch.indices import generic as _generic

    freq_defs = {"annual": "YS", "seasonal": "QS-DEC", "monthly": "MS",
                 "weekly": "W"}

    if isinstance(raw, _os.PathLike):
        with open(raw, encoding="utf-8") as f:
            yml = _yaml.safe_load(f)
    else:
        yml = _yaml.safe_load(raw)

    yml["realm"] = "atmos"
    yml["doc"] = (
        "CF Standard indices defined by the clix-meta project\n"
        "(https://github.com/clix-meta/clix-meta), adapted to this\n"
        "framework's module YAML by adapt_clix_meta_yaml."
    )
    yml["references"] = "clix-meta https://github.com/clix-meta/clix-meta"

    dropped = []
    renamed = {}
    for cmid, data in yml["indices"].items():
        if "reference" in data:
            data["references"] = data.pop("reference")

        index_function = data.pop("index_function")
        data["compute"] = index_function["name"]
        if getattr(_generic, data["compute"], None) is None:
            dropped.append(cmid)
            warnings.warn(f"Indicator {cmid} uses non-implemented function "
                          f"{data['compute']}, removing.")
            continue

        std = data["output"].get("standard_name") or ""
        if std.startswith("number_of_days") or cmid == "nzero":
            dropped.append(cmid)
            warnings.warn(
                f"Indicator {cmid} has a 'number_of_days' standard name and "
                "this framework disagrees with the CF conventions on the "
                "correct output units, removing.")
            continue
        if std.endswith("precipitation_amount"):
            dropped.append(cmid)
            warnings.warn(
                f"Indicator {cmid} has a 'precipitation_amount' standard "
                "name and clix-meta has incoherent output units, removing.")
            continue

        placeholder_renames = {}
        if index_function["parameters"]:
            params = dict(index_function["parameters"])
            for pname, param in list(params.items()):
                kind = param["kind"]
                if kind in ("operator", "reducer"):
                    # clix-meta's `condition` is this framework's `op`
                    if pname == "condition":
                        params["op"] = param[kind]
                        del params[pname]
                    else:
                        params[pname] = param[kind]
                else:  # quantified
                    if param.get("proposed_standard_name") == \
                            "temporal_window_size":
                        del params[pname]  # window: the compute default
                    elif isinstance(param["data"], dict):
                        # declared without a value: keep as an open input
                        desc = param.get(
                            "long_name",
                            (param.get("proposed_standard_name")
                             or param.get("standard_name")).replace("_", " "))
                        params[pname] = {"description": desc,
                                         "units": param["units"]}
                        data_key = next(iter(param["data"]))
                        placeholder_renames[f"{{{data_key}}}"] = \
                            f"{{{pname}}}"
                    else:
                        params[pname] = f"{param['data']} {param['units']}"
            data["parameters"] = params

        period = data.pop("default_period")
        data.setdefault("parameters", {})["freq"] = {
            "default": freq_defs[period]}

        attrs = {}
        output = data.pop("output")
        for attr, val in output.items():
            if val is None:
                continue
            if attr == "cell_methods":
                methods = []
                for i, cell_method in enumerate(val):
                    cm = "".join(f"{dim}: {meth}"
                                 for dim, meth in cell_method.items())
                    # the first method may restate how the daily input was
                    # built — that belongs to the input, not this indicator
                    if i == 0 and cm in {_INPUT_CELL_METHODS.get(v)
                                         for v in data["input"].values()}:
                        continue
                    methods.append(cm)
                val = " ".join(methods)
            elif attr in ("var_name", "long_name"):
                for old, new in placeholder_renames.items():
                    val = val.replace(old, new)
            attrs[attr] = val
        data["cf_attrs"] = [attrs]

        data.pop("ET", None)

        if "{" in cmid:
            renamed[cmid] = cmid.replace("{", "").replace("}", "")

    for old, new in renamed.items():
        yml["indices"][new] = yml["indices"].pop(old)
    for cmid in dropped:
        del yml["indices"][cmid]
    yml["indicators"] = yml.pop("indices")

    with open(adapted, "w", encoding="utf-8") as f:
        _yaml.safe_dump(yml, f)
