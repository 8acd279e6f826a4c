"""Metadata formatting: attribute templating, history provenance
(reference: xclim:src/xclim/core/formatting.py)."""

from __future__ import annotations

import datetime as _dt
import string
import warnings

import numpy as np
from fnmatch import fnmatch
from typing import Any, Sequence

__all__ = [
    "AttrFormatter",
    "default_formatter",
    "gen_call_string",
    "merge_attributes",
    "update_history",
    "unprefix_attrs",
]

DEFAULT_FORMAT_PARAMS = {
    "tasmin_per_thresh": "{tasmin_per_thresh}",
    "tasmin_per_window": "{tasmin_per_window}",
    "tasmin_per_period": "{tasmin_per_period}",
    "tas_per_thresh": "{tas_per_thresh}",
    "tas_per_window": "{tas_per_window}",
    "tas_per_period": "{tas_per_period}",
    "tasmax_per_thresh": "{tasmax_per_thresh}",
    "tasmax_per_window": "{tasmax_per_window}",
    "tasmax_per_period": "{tasmax_per_period}",
    "pr_per_thresh": "{pr_per_thresh}",
    "pr_per_window": "{pr_per_window}",
    "pr_per_period": "{pr_per_period}",
}


class AttrFormatter(string.Formatter):
    """Formatter mapping argument values to natural-language variants with
    grammatical modifiers (xclim:core/formatting.py:42).

    ``mapping`` maps values (glob patterns allowed) to variant lists;
    ``modifiers`` name each variant slot ('r' is reserved for raw).
    """

    def __init__(self, mapping: dict[str, Sequence[str]], modifiers: Sequence[str]):
        super().__init__()
        if "r" in modifiers:
            raise ValueError("Modifier 'r' is reserved for raw formatting.")
        self.modifiers = list(modifiers)
        self.mapping = mapping

    def format(self, format_string: str, /, *args: Any, **kwargs: Any) -> str:
        for k, v in DEFAULT_FORMAT_PARAMS.items():
            kwargs.setdefault(k, v)
        return super().format(format_string, *args, **kwargs)

    def format_field(self, value, format_spec: str) -> str:
        baseval = self._match_value(value)
        if baseval is None:
            if format_spec in self.modifiers + ["r"]:
                warnings.warn(f"Requested formatting `{format_spec}` for unknown string `{value}`.")
                format_spec = ""
            return super().format_field(value, format_spec)
        if not format_spec:
            return self.mapping[baseval][0]
        if format_spec == "r":
            return super().format_field(value, "")
        if format_spec in self.modifiers:
            if len(self.mapping[baseval]) == 1:
                return self.mapping[baseval][0]
            return self.mapping[baseval][self.modifiers.index(format_spec)]
        return super().format_field(self.mapping[baseval][0], format_spec)

    def _match_value(self, value):
        if isinstance(value, str):
            for mapval in self.mapping:
                if fnmatch(value, mapval):
                    return mapval
        return None


default_formatter = AttrFormatter(
    {
        "D": ["daily", "days"],
        "YS": ["annual", "years"],
        "YS-*": ["annual", "years"],
        "MS": ["monthly", "months"],
        "QS-*": ["seasonal", "seasons"],
        "DJF": ["winter"],
        "MAM": ["spring"],
        "JJA": ["summer"],
        "SON": ["fall"],
        "norm": ["Normal"],
        "m1": ["january"], "m2": ["february"], "m3": ["march"], "m4": ["april"],
        "m5": ["may"], "m6": ["june"], "m7": ["july"], "m8": ["august"],
        "m9": ["september"], "m10": ["october"], "m11": ["november"], "m12": ["december"],
        "integral": ["integrated", "integral"],
        "count": ["count"],
        "doymin": ["day of minimum"],
        "doymax": ["day of maximum"],
        "mean": ["average"],
        "max": ["maximal", "maximum"],
        "min": ["minimal", "minimum"],
        "sum": ["total", "sum"],
        "std": ["standard deviation"],
        "var": ["variance"],
        "absamp": ["absolute amplitude"],
        "relamp": ["relative amplitude"],
    },
    ["adj", "noun"],
)


def merge_attributes(attribute: str, *inputs, new_line: str = "\n",
                     missing_str: str | None = None, **named_inputs) -> str:
    """Merge an attribute from several inputs, prefixing by name
    (xclim:core/formatting.py:342)."""
    items = [(getattr(i, "name", None), i) for i in inputs]
    items += list(named_inputs.items())
    parts = []
    for name, obj in items:
        attrs = getattr(obj, "attrs", {})
        val = attrs.get(attribute)
        if val is None and missing_str is not None:
            val = missing_str
        if val is not None:
            parts.append(f"{name}: {val}" if name else str(val))
    return new_line.join(parts)


def update_history(hist_str: str, *inputs, new_name: str | None = None,
                   **named_inputs) -> str:
    """Build a CF ``history`` line: timestamped operation + merged input
    histories (xclim:core/formatting.py:394)."""
    from xclim_tpu_torch import __version__

    merged = merge_attributes("history", *inputs, new_line="\n", missing_str="",
                              **named_inputs)
    # newest entry FIRST, then the merged input histories — the reference's
    # ordering and timestamp format (xclim:core/formatting.py:431-441)
    now = _dt.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    return (f"[{now}] {new_name or ''}: {hist_str} - xclim_tpu_torch version: "
            f"{__version__}\n") + merged


def gen_call_string(funcname: str, *args, **kwargs) -> str:
    """'func(a=1, b=2)'-style provenance string (xclim:core/formatting.py:494)."""
    elements = []
    for arg in args:
        elements.append(_format_arg(arg))
    for k, v in kwargs.items():
        elements.append(f"{k}={_format_arg(v)}")
    return f"{funcname}({', '.join(elements)})"


def _format_arg(value) -> str:
    name = getattr(value, "name", None)
    if hasattr(value, "dims"):
        return name or "<array>"
    if isinstance(value, str):
        return f"'{value}'"
    return str(value)


def prefix_attrs(source: dict, keys, prefix: str) -> dict:
    """Rename a set of attrs with a prefix (xclim:core/formatting.py)."""
    out = {}
    for k, v in source.items():
        if k in keys:
            out[f"{prefix}{k}"] = v
        else:
            out[k] = v
    return out


def unprefix_attrs(source: dict, keys, prefix: str) -> dict:
    """Remove a prefix from a set of attrs (xclim:core/formatting.py)."""
    n = len(prefix)
    out = {}
    for k, v in source.items():
        if k.startswith(prefix) and k[n:] in keys:
            out[k[n:]] = v
        else:
            out.setdefault(k, v)
    return out


def get_percentile_metadata(data, prefix: str) -> dict:
    """Climatology metadata of a percentile array for description templating
    (xclim:core/formatting.py): {prefix}_thresh / _window / _period."""
    per = data.coords.get("percentiles")
    if per is None:
        per = data.attrs.get("percentiles", "")
    clim = data.attrs.get("climatology_bounds", [])
    return {
        f"{prefix}_thresh": per,
        f"{prefix}_window": data.attrs.get("window", ""),
        f"{prefix}_period": "/".join(str(c) for c in np.atleast_1d(clim)),
    }


def parse_doc(doc: str | None) -> dict:
    """Crude numpy-style docstring parser returning title/abstract/parameters
    (xclim:core/formatting.py:239). This package declares metadata
    explicitly, so this is a compatibility helper for introspection."""
    if not doc:
        return {}
    import textwrap

    first, _, rest = doc.strip("\n").partition("\n")
    lines = [first.strip()] + [ln.rstrip()
                               for ln in textwrap.dedent(rest).split("\n")]
    out = {"title": lines[0].strip() if lines else ""}
    # abstract: everything until the first section header
    body = []
    i = 1
    while i < len(lines) and not (i + 1 < len(lines)
                                  and set(lines[i + 1].strip()) == {"-"}):
        if lines[i].strip():
            body.append(lines[i].strip())
        i += 1
    out["abstract"] = " ".join(body).strip()
    # parameters section
    params = {}
    try:
        pi = next(j for j, ln in enumerate(lines)
                  if ln.strip() == "Parameters")
        j = pi + 2
        current = None
        while j < len(lines):
            ln = lines[j]
            if ln and set(ln.strip()) == {"-"}:
                break
            if ln and not ln.startswith(" " * 4) and ":" in ln:
                name = ln.split(":")[0].strip()
                params[name] = {"description": ""}
                current = name
            elif current and ln.strip():
                params[current]["description"] += (" " if params[current]["description"] else "") + ln.strip()
            elif not ln.strip() and current:
                pass
            j += 1
    except StopIteration:
        pass
    if params:
        out["parameters"] = params
    return out


def generate_indicator_docstring(ind) -> str:
    """Render an indicator's metadata as a numpy-style docstring
    (xclim:core/formatting.py:701)."""
    attrs = ind.cf_attrs[0]
    lines = [ind.title or ind.identifier, ""]
    if attrs.get("description"):
        lines += [attrs["description"], ""]
    lines += ["Parameters", "----------"]
    for name, p in ind.parameters.items():
        if getattr(p, "injected", False):
            continue
        kind = getattr(p.kind, "name", str(p.kind))
        lines.append(f"{name} : {kind.lower()}")
        desc = getattr(p, "description", "") or ""
        if desc:
            lines.append(f"    {desc}")
    lines += ["", "Returns", "-------"]
    for a in ind.cf_attrs:
        lines.append(f"{a.get('var_name', ind.identifier)} : "
                     f"[{a.get('units', '')}] {a.get('long_name', '')}")
    return "\n".join(lines)


def update_xclim_history(func):
    """Decorator appending a call signature to the output's history attr;
    positional arguments are rendered under their parameter names, matching
    the reference's ``func(da=tas, arg1=1, ...)`` form
    (xclim:core/formatting.py update_xclim_history)."""
    import functools
    import inspect

    sig = inspect.signature(func)

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        out = func(*args, **kwargs)
        if hasattr(out, "attrs"):
            try:
                bound = sig.bind(*args, **kwargs).arguments
            except TypeError:
                bound = None
            call = (gen_call_string(func.__name__, **bound) if bound is not None
                    else gen_call_string(func.__name__, *args, **kwargs))
            das = [a for a in (*args, *kwargs.values()) if hasattr(a, "attrs")]
            out.attrs["history"] = update_history(
                call, *das, new_name=getattr(out, "name", None))
        return out

    return wrapper
