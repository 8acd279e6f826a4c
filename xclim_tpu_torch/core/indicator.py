"""Indicator engine: metadata + validation wrapper around index functions
(reference: xclim:src/xclim/core/indicator.py, 1965 LoC).

Design departure from xclim (kept from the JAX package): no metaclass
subclass-per-instance machinery and no docstring parsing — an Indicator is a
declarative object built from explicit metadata plus signature introspection of
its compute function. The call pipeline is identical in behavior:

    parse args → bind dataset variables → health checks → compute →
    unit conversion → missing-value mask → attribute templating/i18n

(reference call pipeline: core/indicator.py:865-945, _postprocess :1522-1550,
_update_attrs :1085-1148).

YAML virtual modules (``icclim``, ``anuclim``, ``cf`` and a user's own file)
are built by :func:`build_indicator_module_from_yaml`; the bundled three are
read from JSON copies of their definitions (``xclim_tpu_torch/data``) by
:mod:`xclim_tpu_torch.indicators`, through the same dict path and schema
check, so that building them needs no YAML parser.
"""

from __future__ import annotations

import inspect
import warnings
from collections import namedtuple
from enum import IntEnum
from typing import Callable

import numpy as np
import torch

from xclim_tpu_torch.core import formatting
from xclim_tpu_torch.core import missing  # noqa: F401  (registers MISSING_METHODS)
from xclim_tpu_torch.core._exceptions import MissingVariableError
from xclim_tpu_torch.core.calendar import parse_offset
from xclim_tpu_torch.core.cfchecks import cfcheck_from_name
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.datachecks import check_freq
from xclim_tpu_torch.core.locales import TRANSLATABLE_ATTRS, get_local_attrs, get_local_formatter
from xclim_tpu_torch.core.options import (
    AS_DATASET,
    CHECK_MISSING,
    MISSING_METHODS,
    MISSING_OPTIONS,
    OPTIONS,
    set_options,
)
from xclim_tpu_torch.core.units import convert_units_to, units2pint
from xclim_tpu_torch.core.variables import VARIABLES
from xclim_tpu_torch.utils.profiling import count, span

__all__ = [
    "Daily",
    "Hourly",
    "Indicator",
    "IndexingIndicator",
    "InputKind",
    "Parameter",
    "ReducingIndicator",
    "ResamplingIndicator",
    "ResamplingIndicatorWithIndexing",
    "registry",
    "iter_indicators",
    "build_indicator_module",
    "build_indicator_module_from_yaml",
]

registry: dict[str, "Indicator"] = {}


class InputKind(IntEnum):
    """Taxonomy of indicator inputs (xclim:core/utils.py:560-657)."""

    VARIABLE = 0
    OPTIONAL_VARIABLE = 1
    QUANTIFIED = 2
    FREQ_STR = 3
    NUMBER = 4
    STRING = 5
    DAY_OF_YEAR = 6
    DATE = 7
    NUMBER_SEQUENCE = 8
    BOOL = 9
    DICT = 10
    KWARGS = 50
    DATASET = 70
    OTHER_PARAMETER = 99


_empty = inspect.Parameter.empty


class Parameter:
    """Metadata for one indicator parameter (xclim:core/indicator.py:191)."""

    __slots__ = ("kind", "default", "description", "units", "choices", "value")

    def __init__(self, kind, default=_empty, description="", units=None, choices=None,
                 value=_empty):
        self.kind = kind
        self.default = default
        self.description = description
        self.units = units
        self.choices = choices
        self.value = value

    @property
    def injected(self):
        return self.value is not _empty

    def asdict(self):
        out = {"kind": int(self.kind), "description": self.description}
        if self.default is not _empty:
            out["default"] = self.default
        if self.units:
            out["units"] = self.units
        if self.choices:
            out["choices"] = list(self.choices)
        if self.injected:
            out["value"] = self.value
        return out

    def __repr__(self):
        return f"Parameter(kind={self.kind!r}, default={self.default!r})"


def infer_kind_from_parameter(param: inspect.Parameter) -> InputKind:
    """Guess the InputKind from a signature parameter
    (xclim:core/utils.py:659)."""
    name = param.name
    ann = param.annotation
    if name == "ds":
        return InputKind.DATASET
    if param.kind == inspect.Parameter.VAR_KEYWORD:
        return InputKind.KWARGS
    if name == "freq":
        return InputKind.FREQ_STR
    ann_str = str(ann)
    if "ClimArray" in ann_str:
        if "None" in ann_str or param.default is None:
            return InputKind.OPTIONAL_VARIABLE
        return InputKind.VARIABLE
    if name in VARIABLES or name.endswith("_per"):
        return InputKind.VARIABLE if param.default is _empty else InputKind.OPTIONAL_VARIABLE
    if isinstance(param.default, bool) or ann is bool:
        return InputKind.BOOL
    if isinstance(param.default, str) and any(u in str(param.default) for u in
                                              ("degC", "mm", "K", "m s-1", "kg", "%",
                                               "cm", "km/h", "Pa", "W")):
        return InputKind.QUANTIFIED
    if isinstance(param.default, str) and len(str(param.default)) == 5 and \
            str(param.default)[2] == "-":
        return InputKind.DAY_OF_YEAR
    if isinstance(param.default, (int, float)):
        return InputKind.NUMBER
    if isinstance(param.default, str):
        return InputKind.STRING
    return InputKind.OTHER_PARAMETER


_ATTRS_TO_FORMAT = ["long_name", "description", "comment", "cell_methods"]
# output attrs recognized in cf_attrs entries (xclim:core/indicator.py _cf_names)
_CF_NAMES = ["var_name", "standard_name", "long_name", "units", "units_metadata",
             "cell_methods", "description", "comment"]

# kwargs understood by select_time / IndexingIndicator (xclim select_time)
_INDEXER_KEYS = ("season", "month", "doy_bounds", "date_bounds",
                 "include_bounds")

#: Modules whose indicators register under their bare uppercase identifier
#: (xclim:core/indicator.py:291: the reference's default-submodule list).
_DEFAULT_MODULES = frozenset(
    {"atmos", "convert", "generic", "land", "ocean", "seaIce"})


class Indicator:
    """A climate indicator: metadata + checks around a compute function
    (xclim:core/indicator.py:360+).

    Construct with keyword metadata; the instance is callable and registered.
    """

    realm: str | None = None
    identifier: str | None = None
    #: Virtual-module name for YAML-built indicators. Mirrors the reference's
    #: registry naming (xclim:core/indicator.py:285-299): indicators from a
    #: non-default module register as "{module}.{IDENTIFIER}" so e.g. the
    #: ICCLIM "PRCPTOT" does not shadow atmos "prcptot".
    module: str | None = None
    missing = "from_context"
    missing_options: dict | None = None
    src_freq: str | list[str] | None = None
    context = "none"
    allowed_periods: list[str] | None = None

    title = ""
    abstract = ""
    keywords = ""
    references = ""
    notes = ""

    def __init__(self, **kwds):
        if "compute" not in kwds and getattr(self, "compute", None) is None:
            raise AttributeError("An indicator needs a `compute` function.")
        compute = kwds.pop("compute", getattr(self, "compute", None))
        input_map = kwds.pop("input", None)
        if input_map:
            # rename compute variables (official name → compute arg), like the
            # YAML factory's input: mapping (xclim:core/indicator.py:465-547)
            compute = _wrap_input_map(compute, input_map)
        self.compute = compute

        # flat cf attrs → cf_attrs list; list-valued attrs declare one
        # element per output (xclim:core/indicator.py:520-545)
        cf_attrs = kwds.pop("cf_attrs", None)
        if cf_attrs is None:
            flat = {k: kwds.pop(k) for k in list(kwds) if k in _CF_NAMES}
            lens = {k: len(v) for k, v in flat.items()
                    if isinstance(v, (list, tuple))}
            if lens:
                n = max(lens.values())
                for k, ln in lens.items():
                    if ln != n:
                        raise ValueError(
                            f"Attribute {k} has {ln} elements, expected {n} "
                            "(all list-valued output attributes must have "
                            "one entry per output).")
                cf_attrs = [{k: (v[i] if isinstance(v, (list, tuple)) else v)
                             for k, v in flat.items()} for i in range(n)]
            else:
                cf_attrs = [flat] if flat else [{}]
        if len(cf_attrs) > 1:
            for i, entry in enumerate(cf_attrs):
                if not entry.get("var_name"):
                    raise ValueError(f"Output #{i + 1} is missing a "
                                     "var_name!")
        self.cf_attrs = cf_attrs

        for k, v in kwds.items():
            if k == "parameters":
                continue
            setattr(self, k, v)

        if self.identifier is None:
            raise AttributeError("An indicator needs an `identifier`.")
        for entry in self.cf_attrs:
            entry.setdefault("var_name", self.identifier)

        # --- parameter introspection (replaces docstring parsing,
        # xclim:core/indicator.py:549 _parse_indice) ---
        self._sig = inspect.signature(self.compute)
        self.parameters: dict[str, Parameter] = {}
        in_units = getattr(self.compute, "in_units", {})
        for name, p in self._sig.parameters.items():
            kind = infer_kind_from_parameter(p)
            self.parameters[name] = Parameter(
                kind=kind, default=p.default,
                units=in_units.get(name),
            )
        overrides = kwds.get("parameters", {})
        for name, override in overrides.items():
            if name not in self.parameters:
                # new injected parameter (passed through to compute via kwargs)
                self.parameters[name] = Parameter(kind=InputKind.OTHER_PARAMETER)
            param = self.parameters[name]
            if isinstance(override, dict):
                for k, v in override.items():
                    setattr(param, k, v)
            else:
                param.value = override
        self._variables = [n for n, p in self.parameters.items()
                           if p.kind in (InputKind.VARIABLE, InputKind.OPTIONAL_VARIABLE)
                           and not p.injected]

        self._registry_id = f"{self.realm or 'generic'}.{self.identifier.upper()}"
        key = self.identifier.upper()
        if self.module and self.module not in _DEFAULT_MODULES:
            # reference semantics (xclim:core/indicator.py:285-299): prefix
            # non-default modules so ICCLIM/ANUCLIM/CF names never shadow the
            # core realms' registry entries
            key = f"{self.module}.{key}"
        if key in registry and registry[key] is not self:
            warnings.warn(f"Indicator {key} already exists "
                          "and will be overwritten.", stacklevel=2)
        registry[key] = self
        self._registry_key = key

    @property
    def units(self):
        """Declared output units: a list for multi-output indicators
        (xclim:core/indicator.py cfattr accessors)."""
        vals = [a.get("units", "") for a in self.cf_attrs]
        return vals if len(vals) > 1 else vals[0]

    def _get_translated_metadata(self, locale, var_id=None, names=None,
                                 append_locale_name=True):
        """Raw translated metadata for this indicator in one locale, looked
        up by the realm-prefixed id then the registry key; a ``var_id``
        addresses one output of a multi-output indicator
        (xclim:core/indicator.py:1060-1083)."""
        from xclim_tpu_torch.core.locales import get_local_attrs

        ids = [self._registry_id, self._registry_key]
        if var_id:
            ids = [f"{i}.{var_id}" for i in ids] + ids
        return get_local_attrs(ids, locale, names=names,
                               append_locale_name=append_locale_name)

    def translate_attrs(self, locale, fill_missing: bool = True) -> dict:
        """Unformatted translated translatable attributes; ``fill_missing``
        fills untranslated entries with their english values
        (xclim:core/indicator.py:1171-1223). Accepts the same tag /
        (tag, dict) / (tag, path) locale forms as
        :func:`~xclim_tpu_torch.core.locales.get_local_dict`.
        """
        import warnings as _warnings

        def _translate(source, names, var_id=None):
            with _warnings.catch_warnings():
                # an untranslated indicator is an expected outcome here,
                # not a user error (reference behavior: silent fill)
                _warnings.simplefilter("ignore")
                attrs = self._get_translated_metadata(
                    locale, var_id=var_id, names=names,
                    append_locale_name=False)
            if fill_missing:
                for name in names:
                    val = source.get(name) if isinstance(source, dict) \
                        else getattr(source, name, None)
                    if name not in attrs and val:
                        attrs[name] = val
            return attrs

        global_names = [a for a in TRANSLATABLE_ATTRS if a not in _CF_NAMES]
        attrs = _translate(self, global_names)
        attrs["cf_attrs"] = []
        var_id = None
        for cf_attrs in self.cf_attrs:
            if len(self.cf_attrs) > 1:
                var_id = cf_attrs["var_name"]
            attrs["cf_attrs"].append(_translate(
                cf_attrs, [a for a in TRANSLATABLE_ATTRS if a in _CF_NAMES],
                var_id=var_id))
        return attrs

    # ------------------------------------------------------------------
    # call pipeline (xclim:core/indicator.py:865-945)
    # ------------------------------------------------------------------
    def __call__(self, *args, ds: ClimDataset | None = None, **kwds):
        # dict-of-datasets batch apply: the analogue of the reference's
        # DataTree mapping (xclim:core/indicator.py:858-877) — one indicator
        # call per node, results returned as a dict keyed like the input.
        if isinstance(ds, dict) and not isinstance(ds, ClimDataset):
            from xclim_tpu_torch.core.options import set_options

            out = {}
            with set_options(as_dataset=True):
                for key, node in ds.items():
                    if node is None or (hasattr(node, "keys") and not len(node)):
                        out[key] = node  # empty node passes through
                        continue
                    out[key] = self(*args, ds=node, **kwds)
            return out
        with span("indicator.call"):
            count("indicator_calls")
            with span("indicator.checks"):
                das, params = self._parse_variables_from_call(args, kwds, ds)
                self._preprocess_and_checks(das, params)
            call_kwargs = {**das}
            for name, p in self.parameters.items():
                if name in das or p.kind == InputKind.KWARGS:
                    continue
                if p.injected:
                    call_kwargs[name] = p.value
                elif name in params:
                    call_kwargs[name] = params[name]
            # extra kwargs routed through **indexer-style catch-alls (only
            # when the compute function actually takes **kwargs; indexer
            # params for computes without them are consumed by
            # IndexingIndicator)
            if self._compute_has_kwargs():
                for name, v in params.items():
                    if name not in call_kwargs and name not in self.parameters:
                        call_kwargs[name] = v
            with span("indicator.compute"):
                outs = self.compute(**call_kwargs)
            if not isinstance(outs, tuple):
                outs = (outs,)
            if len(outs) != len(self.cf_attrs):
                raise ValueError(
                    f"Indicator {self.identifier} produced {len(outs)} outputs "
                    f"but {len(self.cf_attrs)} were declared.")
            with span("indicator.units"):
                outs = [self._convert_units(o, a)
                        for o, a in zip(outs, self.cf_attrs)]
            with span("indicator.missing"):
                outs = self._postprocess(outs, das, params)
            with span("indicator.attrs"):
                outs = [self._update_attrs(o, a, das, params)
                        for o, a in zip(outs, self.cf_attrs)]
                if OPTIONS[AS_DATASET]:
                    return ClimDataset({o.name: o for o in outs})
                if len(outs) == 1:
                    return outs[0]
                nt = namedtuple(self.identifier,
                                [a["var_name"] for a in self.cf_attrs])
                return nt(*outs)

    def _parse_variables_from_call(self, args, kwds, ds):
        """Bind call args; pull string-named variables from ds
        (xclim:core/indicator.py:946-996)."""
        bound = {}
        names = list(self.parameters)
        free_names = [n for n in names if not self.parameters[n].injected]
        for i, a in enumerate(args):
            bound[free_names[i]] = a
        for k, v in kwds.items():
            if k in bound:
                raise TypeError(f"Got multiple values for argument {k!r}")
            bound[k] = v
        das = {}
        params = {}
        for name, p in self.parameters.items():
            if p.injected:
                continue
            if name in self._variables:
                val = bound.get(name, None if p.kind == InputKind.OPTIONAL_VARIABLE
                                else _empty)
                if val is _empty or isinstance(val, str) or val is None:
                    key = val if isinstance(val, str) else name
                    if ds is not None and key in ds:
                        val = ds[key]
                    elif val is _empty or isinstance(val, str):
                        raise MissingVariableError(
                            f"Variable {key!r} missing (no dataset or not found).")
                if val is not None:
                    das[name] = val
            elif name in bound:
                params[name] = bound[name]
            elif p.default is not _empty:
                params[name] = p.default
        # pass-through extra kwargs (e.g. indexer) if compute has **kwargs;
        # otherwise indexer keys are consumed by IndexingIndicator and any
        # other stray kwarg is an error (the reference raises too)
        extra = {k: v for k, v in bound.items()
                 if k not in das and k not in params
                 and k not in self.parameters}
        if self._compute_has_kwargs():
            params.update(extra)
        elif extra:
            idx = {k: extra.pop(k) for k in list(extra)
                   if k in _INDEXER_KEYS or k == "indexer"}
            if idx:
                if not getattr(self, "_accepts_indexer", False):
                    raise TypeError(
                        f"Indicator {self.identifier} does not accept "
                        f"time-indexing arguments ({sorted(idx)}).")
                params.update(idx)
            if extra:
                raise TypeError(
                    f"{self.identifier}() got unexpected keyword "
                    f"argument(s): {sorted(extra)}")
        return das, params

    def _compute_has_kwargs(self) -> bool:
        return any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in self._sig.parameters.values())

    def _preprocess_and_checks(self, das, params):
        """Health checks (xclim:core/indicator.py:999)."""
        self._cfcheck(**das)
        self._datacheck(**das)

    def _cfcheck(self, **das):
        for name, da in das.items():
            if not hasattr(da, "attrs"):
                continue  # scalar stand-in for a variable (e.g. lat=45.0)
            cfcheck_from_name(name, da)

    def _datacheck(self, **das):
        if self.src_freq is not None:
            for da in das.values():
                if getattr(da, "time", None) is not None:
                    check_freq(da, self.src_freq, strict=True)

    def _convert_units(self, out: ClimArray, attrs: dict) -> ClimArray:
        target = attrs.get("units")
        if target is None:
            return out
        # the reference converts with the indicator's declared context
        # (xclim:core/indicator.py:917 passes self.context; Precip/Streamflow
        # realms declare "hydro"), falling back to inference from the
        # target's or output's standard_name (xclim:core/units.py:358-376).
        # Errors propagate: a dimensionality mismatch the context does not
        # license must raise, not silently return the unconverted output.
        context = None if self.context in (None, "none") else self.context
        if context is None:
            from xclim_tpu_torch.core.units import infer_context

            for sn in (attrs.get("standard_name"),
                       out.attrs.get("standard_name")):
                if infer_context(sn) == "hydro":
                    context = "hydro"
                    break
        if (units2pint(out).dims != units2pint(str(target)).dims
                or out.attrs.get("units") != target):
            out = convert_units_to(out, target, context=context)
        # the reference re-derives the attr from the declared target via
        # pint2cfattrs (xclim:core/units.py:412): dimensionless renders as
        # the CF "1", and the declared spelling ("days", not the canonical
        # "d") is what indicator outputs carry.
        if str(target).strip() in ("", "1", "dimensionless"):
            out.attrs["units"] = "1"
        else:
            out.attrs["units"] = str(target)
        return out

    def _postprocess(self, outs, das, params):
        return outs

    # ------------------------------------------------------------------
    # attribute generation (xclim:core/indicator.py:1085-1148)
    # ------------------------------------------------------------------
    def _format_args(self, das, params):
        args = dict(params)
        # injected parameters (YAML-module constants) participate in attr
        # templating just like user-passed ones (xclim:core/indicator.py:1085)
        for name, p in self.parameters.items():
            if p.injected and name not in args:
                args[name] = p.value
        indexer = args.pop("indexer", None) or {}
        for k, v in indexer.items():
            if v is not None:
                args[k] = v
        # the {indexer} template key: the single indexer value, or the freq
        # when no time-subsetting applies (xclim:core/indicator.py:1306-1315
        # — 'DJF' formats to 'winter', 'YS' to 'annual'). Indexer kwargs may
        # arrive flattened (computes with **indexer take them as plain
        # params) — scan those too.
        live_idx = {k: v for k, v in indexer.items() if v is not None}
        if not live_idx:
            live_idx = {k: args[k] for k in _INDEXER_KEYS
                        if k != "include_bounds" and args.get(k) is not None}
        if live_idx:
            dk, dv = live_idx.popitem()
            if dk == "month" and isinstance(dv, (int, np.integer)):
                dv = f"m{dv}"
            elif dk in ("doy_bounds", "date_bounds"):
                dv = f"{dv[0]} to {dv[1]}"
            args["indexer"] = dv
        else:
            args["indexer"] = args.get("freq") or "YS"
        # month=m1 style formatting hooks
        if "month" in args and isinstance(args["month"], (int, np.integer)):
            args["month"] = f"m{args['month']}"
        # per-variable percentile metadata
        for name, da in das.items():
            if name.endswith("_per"):
                args[f"{name}_thresh"] = str(np.round(np.asarray(
                    da.coords.get("percentiles", np.nan)).astype(float), 1))
                args[f"{name}_window"] = da.attrs.get("window", "")
                cb = da.attrs.get("climatology_bounds")
                if cb:
                    args[f"{name}_period"] = f"{cb[0]} to {cb[1]}"
        return args

    def _update_attrs(self, out: ClimArray, cf: dict, das, params) -> ClimArray:
        args = self._format_args(das, params)
        fmtr = formatting.default_formatter
        attrs = {}
        for key in _CF_NAMES:
            if key in ("var_name",):
                continue
            val = cf.get(key, out.attrs.get(key))
            if val is None:
                continue
            if key in _ATTRS_TO_FORMAT and isinstance(val, str):
                try:
                    val = fmtr.format(val, **args)
                except (KeyError, IndexError, ValueError):
                    pass
                # free-text fields get first-letter capitalization
                # (xclim:core/indicator.py:406-407, :1329-1330)
                if key in ("long_name", "description", "comment"):
                    val = val.strip()
                    if val:
                        val = val[0].upper() + val[1:]
            attrs[key] = val
        # locales
        for locale in OPTIONS["metadata_locales"]:
            try:
                # translations key by the realm-prefixed id (this repo's
                # fr.json scheme) or the reference-style registry key
                # (xclim:core/locales.py:148 keys by registry id); one call,
                # prefixed id wins on conflicts
                loc_attrs = get_local_attrs(
                    [self._registry_id, self._registry_key], locale,
                    names=TRANSLATABLE_ATTRS)
            except Exception:
                continue
            loc_fmt = get_local_formatter(locale)
            for k, v in loc_attrs.items():
                if isinstance(v, str):
                    try:
                        v = loc_fmt.format(v, **args)
                    except (KeyError, IndexError, ValueError):
                        pass
                attrs[k] = v
        # history provenance (xclim:core/formatting.py:394)
        callstr = formatting.gen_call_string(self.identifier, **{**das, **params})
        attrs["history"] = formatting.update_history(
            callstr, *das.values(), new_name=cf.get("var_name", self.identifier))
        new = out.copy()
        prev_units = new.attrs.get("units", attrs.get("units", ""))
        # compute-set attrs survive unless the declaration overrides them
        # (xclim merges computed attrs then overlays cf_attrs) — e.g. fit's
        # estimator/scipy_dist/original_units must reach the output
        kept = {k: v for k, v in new.attrs.items()
                if k in ("units", "is_dayofyear", "calendar",
                         "units_metadata") or k not in _CF_NAMES}
        new.attrs = {**kept, **{k: v for k, v in attrs.items() if k != "units"}}
        new.attrs.setdefault("units", prev_units)
        # var_name is a template too (xclim:indicators/generic/_stats.py:42
        # 'fa_{window}{mode:r}{indexer}' -> 'fa_1maxwinter')
        name = cf.get("var_name", self.identifier)
        if isinstance(name, str) and "{" in name:
            try:
                name = fmtr.format(name, **args)
            except (KeyError, IndexError, ValueError):
                pass
        new.name = name
        return new

    # ------------------------------------------------------------------
    # serialization (xclim:core/indicator.py:1226 json())
    # ------------------------------------------------------------------
    def json(self) -> dict:
        return {
            "identifier": self.identifier,
            "realm": self.realm,
            "title": self.title,
            "abstract": self.abstract,
            "keywords": self.keywords,
            "outputs": [dict(a) for a in self.cf_attrs],
            "parameters": {k: p.asdict() for k, p in self.parameters.items()
                           if k not in self._variables},
            "variables": list(self._variables),
        }

    def __repr__(self):
        return f"<Indicator {self._registry_id}>"


class CheckMissingIndicator(Indicator):
    """Adds the missing-value mask in postprocessing
    (xclim:core/indicator.py:1473)."""

    def _get_missing_freq(self, params):
        return params.get("freq")

    def _postprocess(self, outs, das, params):
        outs = super()._postprocess(outs, das, params)
        method = self.missing if self.missing != "from_context" else OPTIONS[CHECK_MISSING]
        if method == "skip" or not das:
            return outs
        freq = self._get_missing_freq(params)
        if freq is False:
            return outs
        cls = MISSING_METHODS.get(method)
        if cls is None:
            return outs
        options = self.missing_options or OPTIONS[MISSING_OPTIONS].get(method, {})
        indexer = params.get("indexer") or {}
        for k in ("season", "month", "doy_bounds", "date_bounds"):
            if params.get(k) is not None:
                indexer[k] = params[k]
        # mask from the union of all input variables (xclim:core/indicator.py:1530)
        masks = []
        for da in das.values():
            if getattr(da, "time", None) is None:
                continue
            m = cls(**options)(da, freq, **indexer)
            masks.append(m)
        if not masks:
            return outs
        mask = masks[0]
        for m in masks[1:]:
            mask = mask | m
        new_outs = []
        for out in outs:
            if out.time is not None and mask.time is not None and \
                    len(out.time) == len(mask.time):
                new_outs.append(out.where(~mask))
            elif mask.time is None and freq is None:
                # reducing indicator (freq=None): the mask is one bool per
                # cell; broadcast over any leading output axes (e.g. fit's
                # dparams — xclim:core/indicator.py:1552 ReducingIndicator)
                md = mask.data if hasattr(mask, "data") else torch.as_tensor(
                    mask, device=out.data.device)
                new_outs.append(out.copy(data=torch.where(
                    md, torch.nan, out.data)))
            else:
                new_outs.append(out)
        return new_outs


class ReducingIndicator(CheckMissingIndicator):
    """Collapses the time dimension entirely (xclim:core/indicator.py:1552)."""

    def _get_missing_freq(self, params):
        return None


class ResamplingIndicator(CheckMissingIndicator):
    """Requires a `freq` argument; checks allowed periods
    (xclim:core/indicator.py:1574)."""

    allowed_periods: list[str] | None = None

    def _preprocess_and_checks(self, das, params):
        super()._preprocess_and_checks(das, params)
        freq = params.get("freq")
        if freq is not None and self.allowed_periods is not None:
            if parse_offset(freq)[1] not in self.allowed_periods:
                raise ValueError(
                    f"Resampling frequency {freq} is not allowed for indicator "
                    f"{self.identifier} (needs one of {self.allowed_periods}).")


class IndexingIndicator(Indicator):
    """Adds time-indexing kwargs that subset the inputs before computation
    (xclim:core/indicator.py:1626-1655): when the compute function has no
    ``**indexer`` of its own, the inputs are masked with ``select_time``
    here, and the missing-value check sees the same indexer."""

    _accepts_indexer = True

    def _preprocess_and_checks(self, das, params):
        super()._preprocess_and_checks(das, params)
        if self._compute_has_kwargs():
            return  # the compute function applies its own indexer
        indxr = {k: params[k] for k in _INDEXER_KEYS
                 if params.get(k) is not None}
        nested = params.get("indexer")
        if isinstance(nested, dict):
            indxr.update({k: v for k, v in nested.items() if v is not None})
        if indxr:
            for name, da in list(das.items()):
                if getattr(da, "time", None) is not None:
                    das[name] = da.select_time(**indxr)


class ResamplingIndicatorWithIndexing(ResamplingIndicator, IndexingIndicator):
    """Resampling + time-subset indexing (xclim:core/indicator.py:1657)."""


class Daily(ResamplingIndicator):
    """Indicator defined on daily data (xclim:core/indicator.py:1661)."""

    src_freq = "D"


class Hourly(ResamplingIndicator):
    """Indicator defined on hourly data (xclim:core/indicator.py:1667)."""

    src_freq = "h"


def iter_indicators():
    """Iterate over all registered indicators (id, instance)."""
    yield from registry.items()


# ---------------------------------------------------------------------------
# YAML virtual modules (xclim:core/indicator.py:1703-1860)
# ---------------------------------------------------------------------------


def build_indicator_module(name: str, objs: dict, doc: str | None = None,
                           reload: bool = False):
    """Create (or extend) a virtual module holding indicator instances
    (xclim:core/indicator.py:1703)."""
    import sys
    import types

    import xclim_tpu_torch.indicators as indicators_mod

    full = f"xclim_tpu_torch.indicators.{name}"
    if full in sys.modules and not reload:
        mod = sys.modules[full]
    else:
        mod = types.ModuleType(full, doc or f"Virtual indicator module {name}.")
        sys.modules[full] = mod
        setattr(indicators_mod, name, mod)
    for key, obj in objs.items():
        setattr(mod, key, obj)
    mod.__dict__.setdefault("iter_indicators",
                            lambda: ((k, v) for k, v in vars(mod).items()
                                     if isinstance(v, Indicator)))
    return mod


_BASE_CLASSES = {
    "Indicator": Indicator,
    "ReducingIndicator": ReducingIndicator,
    "ResamplingIndicator": ResamplingIndicator,
    "ResamplingIndicatorWithIndexing": ResamplingIndicatorWithIndexing,
    "Daily": Daily,
    "Hourly": Hourly,
}


def _resolve_compute(path: str):
    """The compute function a YAML ``compute:`` names: a bare name from
    :mod:`xclim_tpu_torch.indices` or its ``generic`` module, or a dotted
    path. A dotted path into the JAX package (``xclim_tpu.<module>.<name>``)
    resolves to the port's module of the same name, never to the JAX
    package; a path whose module the port lacks raises."""
    import importlib

    if "." in path:
        modname, fname = path.rsplit(".", 1)
        root, _, rest = modname.partition(".")
        if root == "xclim_tpu":
            ported = "xclim_tpu_torch" + (f".{rest}" if rest else "")
            try:
                mod = importlib.import_module(ported)
            except ModuleNotFoundError as err:
                raise ValueError(
                    f"compute {path!r} names a module of the JAX package "
                    f"that the port does not have ({ported})") from err
        else:
            mod = importlib.import_module(modname)
        return getattr(mod, fname)
    import xclim_tpu_torch.indices as indices_mod

    if hasattr(indices_mod, path):
        return getattr(indices_mod, path)
    import xclim_tpu_torch.indices.generic as generic_mod

    return getattr(generic_mod, path)


def build_indicator_module_from_yaml(filename, name: str | None = None,
                                     indices=None, translations=None,
                                     mode: str = "raise", encoding: str = "utf-8",
                                     validate: bool = True):
    """Build indicators from a YAML definition file
    (xclim:core/indicator.py:1761). Supports the reference's YAML layout:
    ``base:``, ``compute:``, ``input:``, ``parameters:``, ``cf_attrs``/flat attrs.

    With ``validate=True`` (default) the parsed module is schema-checked
    first (xclim:core/indicator.py:1845-1852 / data/schema.yml) and a
    malformed module raises :class:`ValidationError` with a field-level
    report. Needs PyYAML (imported here, not at module import).
    """
    from pathlib import Path

    import yaml

    filepath = Path(filename)
    with open(filepath, encoding=encoding) as f:
        yml = yaml.safe_load(f)
    return _module_from_dict(
        yml, name=name or (yml.get("module") if isinstance(yml, dict) else None)
        or filepath.stem, source=filepath.name, indices=indices,
        translations=translations, mode=mode, validate=validate)


def _module_from_dict(yml: dict, name: str | None = None,
                                     source: str = "<dict>", indices=None,
                                     translations=None, mode: str = "raise",
                                     validate: bool = True):
    """Build a virtual indicator module from an already parsed module
    definition (the dict ``yaml.safe_load`` gives for a module file, or
    ``json.load`` of its JSON copy); the path of
    :func:`build_indicator_module_from_yaml` after parsing."""
    if validate:
        from xclim_tpu_torch.core.yaml_schema import check_yaml_module

        check_yaml_module(yml, source=source)
    name = name or yml.get("module", source)
    doc = yml.get("doc")
    default_base = yml.get("base", "Daily")
    realm = yml.get("realm", "atmos")
    objs = {}
    for ident, data in (yml.get("indicators") or {}).items():
        try:
            objs[ident] = _indicator_from_dict(ident, data, default_base, realm,
                                               indices=indices, module=name)
        except Exception as err:
            if mode == "raise":
                raise
            warnings.warn(f"Could not build indicator {ident}: {err}")
    mod = build_indicator_module(name, objs, doc=doc, reload=True)
    if translations:
        from xclim_tpu_torch.core.locales import load_locale

        for locale, trans in translations.items():
            load_locale(trans, locale)
    return mod


def _indicator_from_dict(identifier: str, data: dict, default_base: str, realm: str,
                         indices=None, module: str | None = None):
    data = dict(data or {})
    base_name = data.pop("base", default_base)
    # a base may name a core indicator (bare key) or a sibling indicator of
    # the same virtual module (prefixed key)
    base_key = next((k for k in (base_name.upper(),
                                 f"{module}.{base_name.upper()}")
                     if k in registry), None)
    if base_key is not None:
        base_ind = registry[base_key]
        base_cls = type(base_ind)
        compute = base_ind.compute
        inherited = {
            "realm": base_ind.realm,
            "cf_attrs": [dict(a) for a in base_ind.cf_attrs],
            "title": base_ind.title,
            "abstract": base_ind.abstract,
            "missing": base_ind.missing,
            "src_freq": base_ind.src_freq,
        }
    else:
        base_cls = _BASE_CLASSES.get(base_name, Daily)
        compute = None
        inherited = {}

    compute_name = data.pop("compute", None)
    if compute_name is not None:
        if indices is not None and compute_name in getattr(indices, "__dict__", indices if isinstance(indices, dict) else {}):
            compute = indices[compute_name] if isinstance(indices, dict) \
                else getattr(indices, compute_name)
        else:
            compute = _resolve_compute(compute_name)
    if compute is None:
        raise ValueError(f"No compute function for indicator {identifier}.")

    input_map = data.pop("input", {})
    params = data.pop("parameters", {})
    cf_flat = {k: data.pop(k) for k in list(data) if k in _CF_NAMES}
    cf_attrs = data.pop("cf_attrs", None)
    if cf_attrs is None and (cf_flat or inherited.get("cf_attrs")):
        merged = dict(inherited.get("cf_attrs", [{}])[0])
        merged.update(cf_flat)
        merged["var_name"] = identifier
        cf_attrs = [merged]

    if input_map:
        compute = _wrap_input_map(compute, input_map)

    kwds = {**inherited}
    kwds.update({k: v for k, v in data.items() if isinstance(v, (str, int, float, list, dict))})
    kwds.update({
        "identifier": identifier,
        "module": module,
        "realm": data.get("realm", realm or inherited.get("realm", "atmos")),
        "compute": compute,
        "cf_attrs": cf_attrs or [{}],
        "parameters": params,
    })
    return base_cls(**kwds)


def _wrap_input_map(compute: Callable, input_map: dict):
    """Rename compute variables per the YAML ``input:`` mapping
    (official name → compute arg)."""
    import functools

    inv = {param: official for param, official in input_map.items()}

    sig = inspect.signature(compute)
    new_params = []
    for n, p in sig.parameters.items():
        if n in inv:
            new_params.append(p.replace(name=inv[n]))
        else:
            new_params.append(p)

    @functools.wraps(compute)
    def wrapped(**kwargs):
        call = {}
        for k, v in kwargs.items():
            back = {off: par for par, off in inv.items()}
            call[back.get(k, k)] = v
        return compute(**call)

    wrapped.__signature__ = sig.replace(parameters=new_params)
    wrapped.in_units = getattr(compute, "in_units", {})
    return wrapped


class IndicatorRegistrar:
    """Compatibility alias: in the reference this mixin performs registration
    (xclim:core/indicator.py:281); here registration happens in
    :meth:`Indicator.__init__`, so this simply exposes the same surface."""

    @classmethod
    def get_instance(cls):
        for ind in registry.values():
            if type(ind) is cls:
                return ind
        raise ValueError(f"No instance of {cls.__name__} registered.")


class StandardizedIndexes(ResamplingIndicator):
    """Resampling indicator for standardized indexes (SPI/SPEI family;
    xclim:core/indicator.py:1961)."""

    realm = "atmos"
    missing = "skip"


def add_iter_indicators(module):
    """Add an ``iter_indicators`` generator to a virtual indicator module
    (xclim:core/indicator.py:1682)."""
    if not hasattr(module, "iter_indicators"):
        def iter_indicators():
            for name in getattr(module, "__all__", dir(module)):
                obj = getattr(module, name, None)
                if isinstance(obj, Indicator):
                    yield name, obj

        module.iter_indicators = iter_indicators
    return module
