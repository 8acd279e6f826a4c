"""Schema validation for YAML indicator modules.

Replicates the semantics of the reference's yamale schema
(xclim:src/xclim/data/schema.yml, validated at
xclim:src/xclim/core/indicator.py:1845-1852) without a yamale dependency:
a malformed user YAML fails with a field-level error report instead of a
confusing downstream exception. The one deliberate extension over the
reference schema is that flat CF attribute keys (``units``, ``long_name``,
...) are allowed directly inside an indicator entry — the loader in
:mod:`xclim_tpu_torch.core.indicator` supports that shorthand (and the bundled
icclim/anuclim/cf modules use it).
"""

from __future__ import annotations

from typing import Any

from xclim_tpu_torch.core._exceptions import ValidationError

__all__ = ["validate_module_dict", "check_yaml_module"]

_CF_ATTR_KEYS = {"var_name", "standard_name", "long_name", "units",
                 "units_metadata", "cell_methods", "description", "comment"}

_ALLOWED_PERIODS = {"A", "Y", "Q", "M", "W"}

_INDEXER_KEYS = {"drop", "month", "season", "doy_bounds", "date_bounds",
                 "include_bounds"}

_PARAMETER_KEYS = {"description", "default", "choices", "units", "kind",
                   "name"}

_INDICATOR_KEYS = {
    "abstract", "allowed_periods", "src_freq", "base", "compute", "input",
    "keywords", "measure", "missing", "missing_options", "notes", "cf_attrs",
    "parameters", "realm", "references", "title", "context",
} | _CF_ATTR_KEYS

_TOP_KEYS = {"base", "doc", "keywords", "module", "realm", "references",
             "indicators", "variables", "translations"}

_VARIABLE_KEYS = {"canonical_units", "cell_methods", "description",
                  "standard_name", "data_flags", "dimensions"}


def _is_str(v) -> bool:
    return isinstance(v, str)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _type_name(v) -> str:
    return type(v).__name__ if v is not None else "null"


def _check_indexer(v: dict, path: str, errs: list[str]) -> None:
    for k in v:
        if k not in _INDEXER_KEYS:
            errs.append(f"{path}.{k}: unknown indexer key "
                        f"(allowed: {sorted(_INDEXER_KEYS)})")
    if "drop" in v and not isinstance(v["drop"], bool):
        errs.append(f"{path}.drop: expected bool, got {_type_name(v['drop'])}")
    if "month" in v:
        m = v["month"]
        ok = isinstance(m, int) or (isinstance(m, list)
                                    and all(isinstance(x, int) for x in m))
        if not ok:
            errs.append(f"{path}.month: expected int or list of int, "
                        f"got {_type_name(m)}")
    if "season" in v:
        s = v["season"]
        ok = _is_str(s) or (isinstance(s, list) and all(_is_str(x) for x in s))
        if not ok:
            errs.append(f"{path}.season: expected str or list of str, "
                        f"got {_type_name(s)}")
    for key, typ, tname in (("doy_bounds", int, "int"),
                            ("date_bounds", str, "str")):
        if key in v:
            b = v[key]
            if not isinstance(b, list) or len(b) > 2 \
                    or not all(isinstance(x, typ) for x in b):
                errs.append(f"{path}.{key}: expected a list of at most "
                            f"2 {tname}, got {b!r}")
    if "include_bounds" in v:
        b = v["include_bounds"]
        ok = isinstance(b, bool) or (isinstance(b, list) and len(b) <= 2
                                     and all(isinstance(x, bool) for x in b))
        if not ok:
            errs.append(f"{path}.include_bounds: expected bool or a list of "
                        f"at most 2 bool, got {b!r}")


def _looks_like_indexer(v: dict) -> bool:
    return bool(v) and set(v) <= _INDEXER_KEYS


def _check_parameter(v: dict, path: str, errs: list[str]) -> None:
    for k in v:
        if k not in _PARAMETER_KEYS:
            errs.append(f"{path}.{k}: unknown parameter key "
                        f"(allowed: {sorted(_PARAMETER_KEYS)})")
    if "description" in v and not _is_str(v["description"]):
        errs.append(f"{path}.description: expected str, "
                    f"got {_type_name(v['description'])}")
    if "default" in v:
        d = v["default"]
        ok = d is None or _is_str(d) or _is_num(d) or isinstance(d, bool)
        if isinstance(d, dict):
            _check_indexer(d, f"{path}.default", errs)
            ok = True
        if not ok:
            errs.append(f"{path}.default: expected str/num/bool/null/indexer,"
                        f" got {_type_name(d)}")
    if "choices" in v:
        c = v["choices"]
        if not isinstance(c, list) or not all(_is_str(x) for x in c):
            errs.append(f"{path}.choices: expected list of str, got {c!r}")
    if "units" in v and not _is_str(v["units"]):
        errs.append(f"{path}.units: expected str, got {_type_name(v['units'])}")
    if "kind" in v and not isinstance(v["kind"], int):
        errs.append(f"{path}.kind: expected int, got {_type_name(v['kind'])}")


def _check_cf_attrs(v: Any, path: str, errs: list[str]) -> None:
    entries = v if isinstance(v, list) else [v]
    for i, e in enumerate(entries):
        p = f"{path}[{i}]" if isinstance(v, list) else path
        if not isinstance(e, dict):
            errs.append(f"{p}: expected a mapping of CF attributes, "
                        f"got {_type_name(e)}")
            continue
        for k, val in e.items():
            if not _is_str(val):
                errs.append(f"{p}.{k}: CF attribute values must be str, "
                            f"got {_type_name(val)}")


def _check_indicator(ident: str, data: Any, errs: list[str]) -> None:
    path = f"indicators.{ident}"
    if data is None:
        return
    if not isinstance(data, dict):
        errs.append(f"{path}: expected a mapping, got {_type_name(data)}")
        return
    for k in data:
        if k not in _INDICATOR_KEYS:
            errs.append(f"{path}.{k}: unknown indicator key "
                        f"(closest allowed: "
                        f"{sorted(x for x in _INDICATOR_KEYS if x[:2] == k[:2]) or sorted(_INDICATOR_KEYS)[:6]})")
    for k in ("abstract", "base", "compute", "keywords", "measure",
              "missing", "notes", "realm", "references", "title", "context"):
        if k in data and not _is_str(data[k]):
            errs.append(f"{path}.{k}: expected str, got {_type_name(data[k])}")
    if "allowed_periods" in data:
        ap = data["allowed_periods"]
        if not isinstance(ap, list) or not set(ap) <= _ALLOWED_PERIODS:
            errs.append(f"{path}.allowed_periods: expected a list drawn from "
                        f"{sorted(_ALLOWED_PERIODS)}, got {ap!r}")
    if "src_freq" in data:
        sf = data["src_freq"]
        if not (_is_str(sf) or (isinstance(sf, list)
                                and all(_is_str(x) for x in sf))):
            errs.append(f"{path}.src_freq: expected str or list of str, "
                        f"got {_type_name(sf)}")
    if "input" in data:
        im = data["input"]
        if not isinstance(im, dict) or not all(
                _is_str(k) and _is_str(v) for k, v in im.items()):
            errs.append(f"{path}.input: expected a str→str mapping "
                        f"(compute arg → official variable), got {im!r}")
    if "missing_options" in data and not isinstance(data["missing_options"], dict):
        errs.append(f"{path}.missing_options: expected a mapping, "
                    f"got {_type_name(data['missing_options'])}")
    if "cf_attrs" in data:
        _check_cf_attrs(data["cf_attrs"], f"{path}.cf_attrs", errs)
    for k in _CF_ATTR_KEYS:
        if k in data and not _is_str(data[k]):
            errs.append(f"{path}.{k}: expected str, got {_type_name(data[k])}")
    if "parameters" in data:
        pars = data["parameters"]
        if not isinstance(pars, dict):
            errs.append(f"{path}.parameters: expected a mapping, "
                        f"got {_type_name(pars)}")
        else:
            for pn, pv in pars.items():
                pp = f"{path}.parameters.{pn}"
                if pv is None or _is_str(pv) or _is_num(pv) \
                        or isinstance(pv, bool):
                    continue
                if isinstance(pv, dict):
                    if _looks_like_indexer(pv):
                        _check_indexer(pv, pp, errs)
                    else:
                        _check_parameter(pv, pp, errs)
                else:
                    errs.append(f"{pp}: expected str/num/bool/null or a "
                                f"parameter/indexer mapping, "
                                f"got {_type_name(pv)}")


def _check_variable(vname: str, data: Any, errs: list[str]) -> None:
    path = f"variables.{vname}"
    if not isinstance(data, dict):
        errs.append(f"{path}: expected a mapping, got {_type_name(data)}")
        return
    for k in data:
        if k not in _VARIABLE_KEYS:
            errs.append(f"{path}.{k}: unknown variable key "
                        f"(allowed: {sorted(_VARIABLE_KEYS)})")
    for req in ("canonical_units", "description"):
        if req not in data:
            errs.append(f"{path}: missing required key '{req}'")
        elif not _is_str(data[req]):
            errs.append(f"{path}.{req}: expected str, "
                        f"got {_type_name(data[req])}")
    for k in ("cell_methods", "standard_name"):
        if k in data and not _is_str(data[k]):
            errs.append(f"{path}.{k}: expected str, got {_type_name(data[k])}")


def validate_module_dict(yml: Any) -> list[str]:
    """Validate a parsed YAML indicator module; return a list of field-level
    error strings (empty when valid)."""
    errs: list[str] = []
    if not isinstance(yml, dict):
        return [f"top level: expected a mapping, got {_type_name(yml)}"]
    for k in yml:
        if k not in _TOP_KEYS:
            errs.append(f"{k}: unknown top-level key "
                        f"(allowed: {sorted(_TOP_KEYS)})")
    for k in ("base", "doc", "keywords", "module", "realm", "references"):
        if k in yml and not _is_str(yml[k]):
            errs.append(f"{k}: expected str, got {_type_name(yml[k])}")
    if "indicators" not in yml:
        errs.append("indicators: missing required section")
    elif not isinstance(yml["indicators"], dict):
        errs.append(f"indicators: expected a mapping, "
                    f"got {_type_name(yml['indicators'])}")
    else:
        import re

        for ident, data in yml["indicators"].items():
            if not re.fullmatch(r"[-\w]+", str(ident)):
                errs.append(f"indicators.{ident}: identifier must match "
                            r"^[-\w]+$")
            _check_indicator(ident, data, errs)
    if "variables" in yml:
        if not isinstance(yml["variables"], dict):
            errs.append(f"variables: expected a mapping, "
                        f"got {_type_name(yml['variables'])}")
        else:
            for vname, vdata in yml["variables"].items():
                _check_variable(vname, vdata, errs)
    return errs


def check_yaml_module(yml: Any, source: str = "<yaml>") -> None:
    """Raise :class:`ValidationError` with a field-level report when the
    parsed module dict does not conform to the schema."""
    errs = validate_module_dict(yml)
    if errs:
        lines = "\n".join(f"  - {e}" for e in errs)
        raise ValidationError(
            f"Invalid YAML indicator module {source!s} "
            f"({len(errs)} error{'s' if len(errs) > 1 else ''}):\n{lines}")
