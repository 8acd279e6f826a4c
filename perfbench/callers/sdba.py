"""Drives a train-adjust method of ``xclim_tpu_torch.sdba`` through its
public entries: ``Method.train(ref, hist, group=..., nquantiles=..., kind=...)``
(stage ``train``) and ``.adjust(sim)`` (stage ``adjust``).

The configuration's ``method`` names the class and its settings; its
``data`` makes ``ref``, ``hist`` and ``sim`` on a (time, lat, lon) grid.
The Grouper is built once, as a user's script builds it, so its device
tables are made in the warm-up and not in every call.
"""

from __future__ import annotations

import numpy as np

from perfbench import generate

#: the program's modules, imported (with the indicator registry) in set-up
IMPORTS = ("xclim_tpu_torch.sdba",)
#: stage name -> the benchmark's span around it
SPANS = {"train": "sdba.train", "adjust": "sdba.adjust"}
#: stage name -> the outputs (of :func:`outputs`) it makes
PRODUCES = {"train": ("af", "hist_q"), "adjust": ("scen",)}


def setup(config: dict, seed: int, device) -> dict:
    from xclim_tpu_torch import sdba
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    data = config["data"]
    raw = generate.make(data, seed, device)
    T = generate.days(data)
    lat, lon = data["grid"]
    arrays = {}
    for name, x in raw.items():
        time = date_range(f"{data['start_year'][name]}-01-01", periods=T,
                          freq="D", calendar=data["calendar"])
        coords = {"time": time, "lat": np.arange(lat), "lon": np.arange(lon)}
        arrays[name] = ClimArray(x, ("time", "lat", "lon"), coords,
                                 {"units": data["units"]}, name)
    m = config["method"]
    return {"raw": raw, "arrays": arrays,
            "method": getattr(sdba, m["name"]),
            "group": sdba.Grouper(m["group"], m["window"])}


def train(state: dict) -> None:
    m = state["config"]["method"]
    a = state["arrays"]
    state["adj"] = state["method"].train(
        a["ref"], a["hist"], group=state["group"],
        nquantiles=m["nquantiles"], kind=m["kind"])


def adjust(state: dict) -> None:
    state["scen"] = state["adj"].adjust(state["arrays"]["sim"])


STAGES = {"train": train, "adjust": adjust}


def cell_days(state: dict) -> int:
    """Work of one call: cells x days of sim, the series it adjusts."""
    return state["raw"]["sim"].numel()


def inputs(state: dict) -> dict:
    """The generated series as (days, cells)."""
    return {k: v.reshape(v.shape[0], -1) for k, v in state["raw"].items()}


def outputs(state: dict) -> dict:
    """The last call's trained tables and adjusted series as (rows, cells)."""
    C = state["raw"]["sim"][0].numel()
    ds = state["adj"].ds
    return {"af": ds["af"].reshape(-1, C), "hist_q": ds["hist_q"].reshape(-1, C),
            "scen": state["scen"].data.reshape(-1, C)}
