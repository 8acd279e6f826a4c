"""Drives the ETCCDI percentile indices of ``xclim_tpu_torch`` through
their public entries: ``core.percentiles.percentile_doy`` over the base
period's slice (stage ``percentiles``), then ``atmos.tx90p`` and
``atmos.warm_spell_duration_index`` with the mix's ``bootstrap`` (stage
``indices``).

The configuration's ``data`` makes ``tasmax`` on a (time, lat, lon) grid;
its ``method`` gives the base years, the window, the percentile and the
spell length.
"""

from __future__ import annotations

import numpy as np

from perfbench import generate

#: the program's modules, imported (with the indicator registry) in set-up
IMPORTS = ("xclim_tpu_torch.core.percentiles", "xclim_tpu_torch.indicators")
#: stage name -> the benchmark's span around it
SPANS = {"percentiles": "percentiles.doy", "indices": "atmos.indices"}
#: stage name -> the outputs (of :func:`outputs`) it makes
PRODUCES = {"percentiles": ("per",), "indices": ("tx90p", "wsdi")}


def setup(config: dict, seed: int, device) -> dict:
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    data = config["data"]
    raw = generate.make(data, seed, device)
    T = generate.days(data)
    lat, lon = data["grid"]
    time = date_range(f"{data['start_year']}-01-01", periods=T, freq="D",
                      calendar=data["calendar"])
    coords = {"time": time, "lat": np.arange(lat), "lon": np.arange(lon)}
    tasmax = ClimArray(raw["tasmax"], ("time", "lat", "lon"), coords,
                       {"units": "K", "standard_name": "air_temperature",
                        "cell_methods": "time: maximum"}, "tasmax")
    y0, y1 = config["method"]["base_years"]
    return {"raw": raw, "tasmax": tasmax,
            "in_base": (time.year >= y0) & (time.year <= y1)}


def percentiles(state: dict) -> None:
    from xclim_tpu_torch.core.percentiles import percentile_doy

    m = state["config"]["method"]
    base = state["tasmax"].sel_time(mask=state["in_base"])
    state["per"] = percentile_doy(base, window=m["window"], per=m["per"])


def indices(state: dict) -> None:
    from xclim_tpu_torch.indicators import atmos

    m = state["config"]["method"]
    boot = bool(state["mix"]["bootstrap"])
    tx, per = state["tasmax"], state["per"]
    state["tx90p"] = atmos.tx90p(tx, tasmax_per=per, freq="YS",
                                 bootstrap=boot)
    state["wsdi"] = atmos.warm_spell_duration_index(
        tx, tasmax_per=per, window=m["spell"], freq="YS", bootstrap=boot)


STAGES = {"percentiles": percentiles, "indices": indices}


def cell_days(state: dict) -> int:
    """Work of one call: cells x days of tasmax, the series the indices
    are counted over."""
    return state["raw"]["tasmax"].numel()


def inputs(state: dict) -> dict:
    x = state["raw"]["tasmax"]
    return {"tasmax": x.reshape(x.shape[0], -1)}


def outputs(state: dict) -> dict:
    """Thresholds (365, cells) and both indices (years, cells) of the last
    call, without the size-1 ``percentiles`` dim."""
    C = state["raw"]["tasmax"][0].numel()
    return {name: state[name].data[..., 0].reshape(-1, C)
            for name in ("per", "tx90p", "wsdi")}
