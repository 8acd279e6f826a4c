"""Indicator realm modules (reference: xclim:src/xclim/indicators/).

Importing this package also builds the three YAML virtual modules
``icclim``, ``anuclim`` and ``cf`` (``xclim_tpu_torch.indicators.<name>``),
after the realms whose indicators they extend, as ``import xclim_tpu`` does
(xclim_tpu/__init__.py:19-27, ``mode="warn"``). Their definitions are read
from JSON copies of the YAML files (``xclim_tpu_torch/data/<name>.json``),
so that no YAML parser is needed.
"""

import json as _json
from pathlib import Path as _Path

from xclim_tpu_torch.indicators import atmos, convert, generic, land, seaIce  # noqa: F401
from xclim_tpu_torch.core.indicator import _module_from_dict

_DATA = _Path(__file__).resolve().parent.parent / "data"
for _name in ("icclim", "anuclim", "cf"):
    with open(_DATA / f"{_name}.json", encoding="utf-8") as _f:
        _module_from_dict(_json.load(_f), name=_name, source=f"{_name}.json",
                          mode="warn")
