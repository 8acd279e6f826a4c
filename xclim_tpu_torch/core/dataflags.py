"""Data quality flags (reference: xclim:src/xclim/core/dataflags.py, 851 LoC).

Registry of per-variable QC heuristics evaluated on the data's device;
``data_flags`` drives them and aggregates, ``ecad_compliant`` bundles the
ECA&D set.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from xclim_tpu_torch.core._exceptions import raise_warn_or_log
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.units import convert_units_to, declare_units, str2pint
from xclim_tpu_torch.indices.generic import binary_ops
from xclim_tpu_torch.indices.run_length import suspicious_run
from xclim_tpu_torch.ops.quantile import _nanstd

__all__ = [
    "DataQualityException",
    "data_flags",
    "ecad_compliant",
    "negative_accumulation_values",
    "outside_n_standard_deviations_of_climatology",
    "percentage_values_outside_of_bounds",
    "register_methods",
    "tas_below_tasmin",
    "tas_exceeds_tasmax",
    "tasmax_below_tasmin",
    "temperature_extremely_high",
    "temperature_extremely_low",
    "values_op_thresh_repeating_for_n_or_more_days",
    "values_repeating_for_n_or_more_days",
    "very_large_precipitation_events",
    "wind_values_outside_of_bounds",
]

_REGISTRY: dict[str, tuple] = {}


class DataQualityException(Exception):
    """Raised when any data-quality flag is raised (xclim:core/dataflags.py:32)."""

    def __init__(self, flag_array: ClimDataset, message="Data quality flags indicate suspicious values. Flags raised are:\n  - "):
        self.flags = []
        for name, da in flag_array.items():
            if da is not None and bool(np.asarray(da.values).any()):
                self.flags.append(da.attrs.get("description", name))
        super().__init__(message + "\n  - ".join(self.flags))


def register_methods(variable_name: str | None = None):
    """Register a data-flag check (xclim:core/dataflags.py:87)."""

    def dec(func):
        _REGISTRY[func.__name__] = (func, variable_name)
        return func

    return dec


def _flag(da: ClimArray, data, name: str, description: str) -> ClimArray:
    out = da.copy(data=data)
    out.attrs = {"description": description, "units": ""}
    out.name = name
    return out


@register_methods()
@declare_units(tasmax="[temperature]", tasmin="[temperature]")
def tasmax_below_tasmin(tasmax: ClimArray, tasmin: ClimArray) -> ClimArray:
    """tasmax < tasmin anywhere (xclim:core/dataflags.py:127)."""
    tn = convert_units_to(tasmin, tasmax)
    return _flag(tasmax, tasmax.data < tn.data, "tasmax_below_tasmin",
                 "Maximum temperature values found below minimum temperatures.")


@register_methods()
@declare_units(tas="[temperature]", tasmax="[temperature]")
def tas_exceeds_tasmax(tas: ClimArray, tasmax: ClimArray) -> ClimArray:
    """tas > tasmax (xclim:core/dataflags.py:164)."""
    tx = convert_units_to(tasmax, tas)
    return _flag(tas, tas.data > tx.data, "tas_exceeds_tasmax",
                 "Mean temperature values found above maximum temperatures.")


@register_methods()
@declare_units(tas="[temperature]", tasmin="[temperature]")
def tas_below_tasmin(tas: ClimArray, tasmin: ClimArray) -> ClimArray:
    """tas < tasmin (xclim:core/dataflags.py:201)."""
    tn = convert_units_to(tasmin, tas)
    return _flag(tas, tas.data < tn.data, "tas_below_tasmin",
                 "Mean temperature values found below minimum temperatures.")


@register_methods()
@declare_units(da="[temperature]", thresh="[temperature]")
def temperature_extremely_low(da: ClimArray, *, thresh: str = "-90 degC") -> ClimArray:
    """T < -90°C (xclim:core/dataflags.py:235)."""
    t = convert_units_to(str2pint(thresh), da)
    return _flag(da, da.data < t, "temperature_extremely_low",
                 f"Temperatures found below {thresh}.")


@register_methods()
@declare_units(da="[temperature]", thresh="[temperature]")
def temperature_extremely_high(da: ClimArray, *, thresh: str = "60 degC") -> ClimArray:
    """T > 60°C (xclim:core/dataflags.py:272)."""
    t = convert_units_to(str2pint(thresh), da)
    return _flag(da, da.data > t, "temperature_extremely_high",
                 f"Temperatures found in excess of {thresh}.")


@register_methods()
def negative_accumulation_values(da: ClimArray) -> ClimArray:
    """Negative values in an accumulation variable (xclim:core/dataflags.py:308)."""
    return _flag(da, da.data < 0, "negative_accumulation_values",
                 "Negative values found for accumulation variable.")


@register_methods()
@declare_units(da="[precipitation]", thresh="[precipitation]")
def very_large_precipitation_events(da: ClimArray, *, thresh: str = "300 mm d-1") -> ClimArray:
    """Precipitation above 300 mm/day (xclim:core/dataflags.py:342)."""
    t = convert_units_to(str2pint(thresh), da, context="hydro")
    return _flag(da, da.data > t, "very_large_precipitation_events",
                 f"Precipitation events in excess of {thresh}.")


@register_methods("values_{op}_{thresh}_repeating_for_{n}_or_more_days")
def values_op_thresh_repeating_for_n_or_more_days(da: ClimArray, *, n: int,
                                                  thresh: str,
                                                  op: str = "==") -> ClimArray:
    """Runs of n+ identical values satisfying ``value op thresh``
    (xclim:core/dataflags.py:377-416 — the reference detects identical-value
    runs first and filters them by the threshold comparison)."""
    t = convert_units_to(str2pint(thresh), da, context="infer")
    out = suspicious_run(da, window=n, op=op, thresh=t)
    return _flag(da, out.data, "values_op_thresh_repeating",
                 f"Repetitive values at {thresh} for at least {n} days found.")


@register_methods()
@declare_units(da="[speed]", lower="[speed]", upper="[speed]")
def wind_values_outside_of_bounds(da: ClimArray, *, lower: str = "0 m s-1",
                                  upper: str = "46 m s-1") -> ClimArray:
    """Wind outside [0, 46 m/s] (xclim:core/dataflags.py:422)."""
    lo = convert_units_to(str2pint(lower), da)
    hi = convert_units_to(str2pint(upper), da)
    return _flag(da, (da.data < lo) | (da.data > hi), "wind_values_outside_of_bounds",
                 f"Wind speeds found outside of [{lower}, {upper}].")


@register_methods("outside_{n}_standard_deviations_of_climatology")
def outside_n_standard_deviations_of_climatology(da: ClimArray, *, n: int,
                                                 window: int = 5) -> ClimArray:
    """|x − doy-climatology mean| > n·σ (xclim:core/dataflags.py:466)."""
    from xclim_tpu_torch.core.percentiles import doy_quantile_gather, resample_doy

    g, doys, _ = doy_quantile_gather(da, window)
    mu = torch.nanmean(g, dim=1)
    sd = _nanstd(g, axis=1)
    space_dims = tuple(d for d in da.dims if d != "time")
    coords = {k: v for k, v in da.coords.items() if k in space_dims}
    coords["dayofyear"] = doys
    mu_c = ClimArray(mu, ("dayofyear",) + space_dims, coords, {}, "mu")
    sd_c = ClimArray(sd, ("dayofyear",) + space_dims, dict(coords), {}, "sd")
    mu_t = resample_doy(mu_c, da)
    sd_t = resample_doy(sd_c, da)
    out = torch.abs(da.data - mu_t.data) > n * sd_t.data
    return _flag(da, out, "outside_n_standard_deviations_of_climatology",
                 f"Values outside of {n} standard deviations from climatology found.")


@register_methods("values_repeating_for_{n}_or_more_days")
def values_repeating_for_n_or_more_days(da: ClimArray, *, n: int) -> ClimArray:
    """Identical values n+ days in a row (xclim:core/dataflags.py:521)."""
    out = suspicious_run(da, window=n)
    return _flag(da, out.data, "values_repeating",
                 f"Runs of repetitive values for {n} or more days found.")


@register_methods()
def percentage_values_outside_of_bounds(da: ClimArray) -> ClimArray:
    """Percent values outside [0, 100] (xclim:core/dataflags.py:554)."""
    return _flag(da, (da.data < 0) | (da.data > 100),
                 "percentage_values_outside_of_bounds",
                 "Percentage values beyond bounds found.")


# which checks (with which kwargs) apply to which variables — mirrors the
# reference's variables.yml ``data_flags`` entries (xclim:src/xclim/data/
# variables.yml). A list of (check, kwargs) pairs, NOT a dict: the same
# check may run several times with different kwargs (pr's two repetition
# screens); the generated flag name disambiguates the outputs.
_TEMPERATURE_FLAGS = [
    ("temperature_extremely_high", {"thresh": "60 degC"}),
    ("temperature_extremely_low", {"thresh": "-90 degC"}),
    ("values_repeating_for_n_or_more_days", {"n": 5}),
    ("outside_n_standard_deviations_of_climatology", {"n": 5, "window": 5}),
]
_WIND_FLAGS = lambda upper, thresh, n: [  # noqa: E731
    ("wind_values_outside_of_bounds", {"upper": upper, "lower": "0 m s-1"}),
    ("values_op_thresh_repeating_for_n_or_more_days",
     {"op": "gt", "thresh": thresh, "n": n}),
]
_VARIABLE_FLAGS = {
    "tas": [("tas_exceeds_tasmax", None), ("tas_below_tasmin", None),
            *_TEMPERATURE_FLAGS],
    "tasmax": [("tas_exceeds_tasmax", None), ("tasmax_below_tasmin", None),
               *_TEMPERATURE_FLAGS],
    "tasmin": [("tasmax_below_tasmin", None), ("tas_below_tasmin", None),
               *_TEMPERATURE_FLAGS],
    "pr": [
        ("negative_accumulation_values", None),
        ("very_large_precipitation_events", {"thresh": "300 mm d-1"}),
        ("values_op_thresh_repeating_for_n_or_more_days",
         {"op": "eq", "n": 5, "thresh": "5 mm d-1"}),
        ("values_op_thresh_repeating_for_n_or_more_days",
         {"op": "eq", "n": 10, "thresh": "1 mm d-1"}),
    ],
    "prc": [("negative_accumulation_values", None)],
    "prsn": [("negative_accumulation_values", None)],
    "prsnd": [("negative_accumulation_values", None)],
    "evspsblpot": [("negative_accumulation_values", None)],
    "ps": [("values_repeating_for_n_or_more_days", {"n": 5})],
    "psl": [("values_repeating_for_n_or_more_days", {"n": 5})],
    "sfcWind": _WIND_FLAGS("46.0 m s-1", "2.0 m s-1", 6),
    "sfcWindmax": _WIND_FLAGS("46.0 m s-1", "2.0 m s-1", 6),
    "wsgsmax": _WIND_FLAGS("76.0 m s-1", "4.0 m s-1", 5),
    "hurs": [("percentage_values_outside_of_bounds", None)],
    "siconc": [("percentage_values_outside_of_bounds", None)],
    "snc": [("percentage_values_outside_of_bounds", None)],
    "snd": [("negative_accumulation_values", None)],
    "snw": [("negative_accumulation_values", None)],
    "swe": [("negative_accumulation_values", None)],
    "qspec": [("specific_discharge_extremely_high",
               {"thresh": "100 mm d-1"})],
}


def _flag_key(func, template: str | None, kwargs: dict | None) -> str:
    """Substitute call arguments into a registered ``variable_name`` template
    — ``op`` becomes its word form, quantified strings keep only their
    magnitude with ``.``→``point`` and ``-``→``minus``
    (xclim:core/dataflags.py:633-661 ``_get_variable_name``)."""
    if template is None:
        return func.__name__
    fmt = {}
    kwargs = kwargs or {}
    for arg, p in inspect.signature(func).parameters.items():
        val = kwargs.get(arg, p.default)
        if val is inspect.Parameter.empty:
            continue
        if arg == "op":
            fmt[arg] = binary_ops.get(val, val)
        elif isinstance(val, str):
            try:
                mag = str2pint(val).magnitude
            except Exception:
                fmt[arg] = val
                continue
            if mag == int(mag):
                mag = int(mag)
            fmt[arg] = str(mag).replace(".", "point").replace("-", "minus")
        elif isinstance(val, (int, float)):
            fmt[arg] = val
    return template.format(**fmt)


def data_flags(da: ClimArray, ds: ClimDataset | None = None, flags: dict | None = None,
               dims="all", freq: str | None = None,
               raise_flags: bool = False) -> ClimDataset:
    """Evaluate applicable QC flags for a variable (xclim:core/dataflags.py:581).

    Output names are generated from each check's registered template
    (``values_eq_1_repeating_for_10_or_more_days``); a check whose companion
    variable is absent from ``ds`` yields ``None`` (xclim:core/dataflags.py:
    688-694); a variable with no registered checks raises (``raise_flags``)
    or logs and returns an empty dataset.
    """
    name = da.name
    if flags is None:
        if name not in _VARIABLE_FLAGS:
            raise_warn_or_log(
                NotImplementedError(
                    f"Data quality checks do not exist for '{name}' variable."),
                mode="raise" if raise_flags else "log",
                err_type=NotImplementedError)
            return ClimDataset()
        pairs = _VARIABLE_FLAGS[name]
    else:
        pairs = list(flags.items())
    out = ClimDataset()
    for fname, kwargs in pairs:
        func, template = _REGISTRY[fname]
        kwargs = dict(kwargs or {})
        key = _flag_key(func, template, kwargs)
        sig = inspect.signature(func)
        call = {}
        first = True
        for pname, p in sig.parameters.items():
            if p.kind == inspect.Parameter.KEYWORD_ONLY:
                if pname in kwargs:
                    call[pname] = kwargs[pname]
                continue
            if first:
                call[pname] = da
                first = False
            elif ds is not None and pname in ds:
                call[pname] = ds[pname]
            elif p.default is inspect.Parameter.empty:
                call = None
                break
        if call is None:
            # comparison check whose companion variable is missing
            out.data_vars[key] = None
            continue
        res = func(**call)
        if freq is not None and res.time is not None:
            res2 = res.astype(torch.float32).resample(freq).sum() > 0
            res2.attrs = dict(res.attrs)
            res = res2
        elif dims == "all":
            red = res.any()
            red.attrs = dict(res.attrs)
            res = red
        out[key] = res
    if raise_flags:
        if any(v is not None and bool(np.asarray(v.values).any())
               for v in out.values()):
            raise DataQualityException(out)
    return out


def ecad_compliant(ds: ClimDataset, dims="all", raise_flags: bool = False,
                   append: bool = True):
    """Run ECA&D compliance flags on every variable of a dataset
    (xclim:core/dataflags.py:749)."""
    flags = ClimDataset()
    for name, da in ds.items():
        if name not in _VARIABLE_FLAGS:
            continue
        res = data_flags(da, ds, dims=dims)
        for k, v in res.items():
            if v is not None:
                flags[f"{name}_{k}"] = v
    if raise_flags:
        bad = [k for k, v in flags.items() if bool(np.asarray(v.values).any())]
        if bad:
            raise DataQualityException(flags)
    import functools

    if len(flags.data_vars):
        datas = [v.astype(torch.bool) for v in flags.values()]
        agg = functools.reduce(lambda a, b: a | b, datas)
        ecad = ~agg
        ecad.attrs = {"comment": "Adheres to ECAD quality control checks.",
                      "units": ""}
        ecad.name = "ecad_qc_flag"
    else:
        ecad = None
    if append:
        out = ds.copy()
        if ecad is not None:
            out["ecad_qc_flag"] = ecad
        return out
    return ecad


@register_methods()
@declare_units(da="[discharge]/[area]", thresh="[precipitation]")
def specific_discharge_extremely_high(da: ClimArray, *,
                                      thresh: str = "100 mm d-1") -> ClimArray:
    """Specific discharge above 100 mm/day (xclim:core/dataflags.py:823)."""
    t = convert_units_to(str2pint(thresh), da, context="hydro")
    return _flag(da, da.data > t, "specific_discharge_extremely_high",
                 f"Specific discharge values found above {thresh}.")
