"""Internationalization of indicator metadata (reference: xclim:src/xclim/core/locales.py).

Locale dictionaries map indicator registry ids to translated attribute
templates; they are merged into output attrs as ``<attr>_<locale>`` when
``set_options(metadata_locales=[...])`` is active.
"""

from __future__ import annotations

import json
import warnings
from copy import deepcopy
from pathlib import Path

from xclim_tpu_torch.core.formatting import AttrFormatter, default_formatter

__all__ = [
    "TRANSLATABLE_ATTRS",
    "get_local_attrs",
    "get_local_dict",
    "generate_local_dict",
    "get_local_formatter",
    "list_locales",
    "load_locale",
    "read_locale_file",
    "UnavailableLocaleError",
]

TRANSLATABLE_ATTRS = ["long_name", "description", "comment", "title", "abstract",
                      "keywords"]

_LOCALES: dict[str, dict] = {}


class UnavailableLocaleError(ValueError):
    """Requested locale is not registered (xclim:core/locales.py)."""


def list_locales() -> list[str]:
    return list(_LOCALES)


def read_locale_file(filename, module: str | None = None) -> dict:
    """Read a locale JSON file; optionally prefix ids with a module name
    (xclim:core/locales.py:250)."""
    with open(filename, encoding="utf-8") as f:
        locdict = json.load(f)
    if module is not None:
        locdict = {(k if k == "attrs_mapping" else f"{module}.{k}"): v
                   for k, v in locdict.items()}
    return locdict


def load_locale(locdict, locale: str) -> None:
    """Register or update a locale dictionary (xclim:core/locales.py:279).

    Updating an existing locale merges ``attrs_mapping`` key-by-key instead
    of replacing it, so extending a shipped locale with a few custom-indicator
    entries (docs/tutorial_extending.md) does not strip the stock frequency
    adjectives from every other indicator's formatter."""
    if isinstance(locdict, (str, Path)):
        locdict = read_locale_file(locdict)
    if locale in _LOCALES:
        cur = _LOCALES[locale]
        for k, v in locdict.items():
            if k == "attrs_mapping" and isinstance(cur.get(k), dict):
                cur[k] = {**cur[k], **v}
            else:
                cur[k] = v
    else:
        _LOCALES[locale] = dict(locdict)


def _get_loc(locale: str) -> dict:
    if locale not in _LOCALES:
        raise UnavailableLocaleError(
            f"Locale {locale!r} unavailable; registered: {list_locales()}")
    return _LOCALES[locale]


def _valid_locales(locales) -> bool:
    """Whether every entry is a registered tag or a (tag, dict|json-path)
    tuple (xclim:core/locales.py:88)."""
    if isinstance(locales, str):
        return True
    return all(
        (isinstance(loc, str) and loc in _LOCALES)
        or (not isinstance(loc, str)
            and isinstance(loc[0], str)
            and (isinstance(loc[1], dict) or Path(loc[1]).is_file()))
        for loc in locales)


def get_local_attrs(indicator, *locales, names=None,
                    append_locale_name: bool = True) -> dict:
    """Translated attrs for indicator id(s) in the requested locale(s)
    (xclim:core/locales.py:148).

    ``indicator`` may be a single registry id or a priority-ordered sequence
    (first id wins on conflicts); each locale may be a tag, a (tag, dict)
    tuple or a (tag, json-path) tuple. Warns and contributes nothing for a
    locale with no entry for any of the ids.
    """
    if isinstance(indicator, str):
        indicator = [indicator]
    if not append_locale_name and len(locales) > 1:
        raise ValueError("`append_locale_name` cannot be False if multiple "
                         "locales are requested.")
    attrs = {}
    for locale in locales:
        loc_name, loc_dict = get_local_dict(locale)
        suffix = f"_{loc_name}" if append_locale_name else ""
        local_attrs = dict(loc_dict.get(indicator[-1], {}))
        for other_ind in indicator[-2::-1]:
            local_attrs.update(loc_dict.get(other_ind, {}))
        if not local_attrs:
            warnings.warn(
                f"Attributes of indicator {', '.join(indicator)} in language "
                f"{locale} were requested, but none were found.")
            continue
        for name in TRANSLATABLE_ATTRS:
            if (names is None or name in names) and name in local_attrs:
                attrs[f"{name}{suffix}"] = local_attrs[name]
    return attrs


def get_local_formatter(locale) -> AttrFormatter:
    """AttrFormatter using the locale's value mappings; accepts the same
    tag / (tag, dict) / (tag, path) forms as :func:`get_local_dict`
    (xclim:core/locales.py:207)."""
    _, loc_dict = get_local_dict(locale)
    if "attrs_mapping" in loc_dict:
        mapping = dict(loc_dict["attrs_mapping"])
        modifiers = mapping.pop("modifiers", [])
        return AttrFormatter(mapping, modifiers)
    warnings.warn("No `attrs_mapping` entry found for locale, using the "
                  "default (english) formatter.")
    return default_formatter


def _load_builtin_locales():
    # the shipped locales live with the reference package's data files and
    # are read by path: importing that package would load JAX
    data_dir = Path(__file__).resolve().parents[2] / "xclim_tpu" / "data"
    for f in sorted(data_dir.glob("??.json")):
        load_locale(read_locale_file(f), f.stem)


_load_builtin_locales()


def get_local_dict(locale):
    """(locale_name, full translation dict) for a locale; accepts a tag, a
    (tag, dict) tuple or a (tag, path-to-json) tuple. A tuple whose tag is a
    registered locale MERGES the passed translations over the registered
    ones — passed entries win (xclim:core/locales.py:104-145)."""
    if isinstance(locale, str):
        return locale, deepcopy(_get_loc(locale))
    tag, src = locale[0], locale[1]
    trans = src if isinstance(src, dict) else read_locale_file(src)
    if tag in _LOCALES:
        loaded = deepcopy(_LOCALES[tag])
        loaded.update(trans)
        trans = loaded
    return tag, trans


def generate_local_dict(locale: str, init_english: bool = False) -> dict:
    """Skeleton translation dict with an entry per registered indicator
    (xclim:core/locales.py:300)."""
    from xclim_tpu_torch.core.indicator import registry

    try:
        _, existing = get_local_dict(locale)
    except UnavailableLocaleError:
        existing = {}
    out = {"attrs_mapping": existing.get("attrs_mapping",
                                         {"modifiers": [""]})}
    for key, ind in registry.items():
        rid = ind._registry_id
        entry = dict(existing.get(rid, {}))
        for attr in TRANSLATABLE_ATTRS:
            if attr not in entry:
                val = ind.cf_attrs[0].get(attr, getattr(ind, attr, None)) \
                    if attr != "title" else ind.title
                entry[attr] = (val or "") if init_english else ""
        out[rid] = entry
    return out
