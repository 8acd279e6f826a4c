"""Drives the ECA&D indices of ``xclim_tpu_torch`` through their public
entries: each ``xclim_tpu_torch.indicators.icclim.<NAME>(ds=ds, freq=...)``
of :data:`CALLS`, as one step of a list built once in set-up, the list run
each call as ``xclim_tpu_torch.climjit_chain(steps)(ds)``, as the command
line's ``--fused`` pipeline runs its chain (stage ``suite``).

The configuration's ``data`` makes one standard normal series a variable
(``normal_series``: tas, tasmax, tasmin, pr). In set-up, in place on those
series (so that the program and the reference are handed the same values),
the caller standardises each by its ``series`` mean and spread and shapes it
by ``data.model``:

- tas: ``mean_K`` + ``season_K`` x sin(2 pi (doy - ``season_phase_doy``) /
  365) + ``anomaly_K`` x an AR(1) anomaly of unit variance (coefficient
  ``phi``) made from the tas draws;
- tasmax, tasmin: tas plus, and minus, half a daily range, ``half_K`` +
  ``half_sd_K`` x the tasmax (tasmin) draw, held to at least ``min_half_K``;
- pr: an AR(1) series of unit variance made from the pr draws (coefficient
  ``phi``). A day is wet where it passes its (1 - ``wet_share``) quantile
  q, and then rains 1 + ``scale_mm`` x (value - q)^``power`` mm/day; below
  q, down to the (1 - ``wet_share`` - ``drizzle_share``) quantile d, it
  drizzles (value - d) / (q - d) mm/day, under 1; below d it is dry (0).
  As kg m-2 s-1: mm/day / 86400.

The dataset is built once in set-up: tas, tasmax, tasmin in K with their
``standard_name`` and ``cell_methods``, pr in kg m-2 s-1 as
``precipitation_flux``, on a noleap daily time from ``data.start_year``.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from perfbench import generate

#: the program's modules, imported (with the YAML indicator modules) in
#: set-up
IMPORTS = ("xclim_tpu_torch.indicators",)
#: stage name -> the benchmark's span around it
SPANS = {"suite": "icclim.suite"}
#: each series' variable attributes
ATTRS = {
    "tas": {"units": "K", "standard_name": "air_temperature",
            "cell_methods": "time: mean"},
    "tasmax": {"units": "K", "standard_name": "air_temperature",
               "cell_methods": "time: maximum"},
    "tasmin": {"units": "K", "standard_name": "air_temperature",
               "cell_methods": "time: minimum"},
    "pr": {"units": "kg m-2 s-1", "standard_name": "precipitation_flux",
           "cell_methods": "time: mean"},
}
#: the ECA&D indices of ``indicators.icclim`` over tas, tasmax, tasmin and
#: pr alone (no percentile threshold), at icclim's default slice, the year
INDICES = ("TG", "TX", "TN", "TXx", "TXn", "TNx", "TNn", "DTR", "ETR", "vDTR",
           "SU", "TR", "FD", "ID", "CSU", "CFD", "GD4", "HD17", "GSL", "RR",
           "RR1", "SDII", "CDD", "CWD", "R10mm", "R20mm", "RX1day", "RX5day",
           "PRCPTOT")
#: (output, indicator, freq) of each call of the suite, in order: every
#: index at "YS", and TG again at "MS"
CALLS = tuple((name, name, "YS") for name in INDICES) + (("TG_MS", "TG", "MS"),)
#: stage name -> the outputs (of :func:`outputs`) it makes
PRODUCES = {"suite": tuple(o for o, _, _ in CALLS)}


def ar1(e: torch.Tensor, phi: float) -> torch.Tensor:
    """``a[t] = phi a[t-1] + sqrt(1 - phi^2) e[t]`` along axis 0 (a[0] =
    e[0]): unit variance from unit-variance draws, by a doubling scan
    (``a[t] += phi^s a[t-s]`` for s = 1, 2, 4, ...) until phi^s is below
    float32's resolution."""
    a = e.clone()
    a[1:] *= math.sqrt(1.0 - phi ** 2)
    s = 1
    while s < a.shape[0] and phi ** s > 1e-9:
        a = torch.cat([a[:s], torch.add(a[s:], a[:-s], alpha=phi ** s)])
        s *= 2
    return a


def shape_series(data: dict, raw: dict) -> None:
    """The model of ``data.model`` laid on the standard draws, in place."""
    for name, (mu, sd) in data["series"].items():
        raw[name].sub_(mu).div_(sd)
    m = data["model"]
    T = raw["tas"].shape[0]
    dev = raw["tas"].device
    grid = (1,) * (raw["tas"].ndim - 1)
    t, r, p = m["tas"], m["range"], m["pr"]
    doy = torch.arange(T, device=dev, dtype=torch.float64) % 365 + 1
    season = (t["season_K"] * torch.sin(
        2 * math.pi * (doy - t["season_phase_doy"]) / 365)).to(torch.float32)
    tas = ar1(raw["tas"], t["phi"]).mul_(t["anomaly_K"])
    tas.add_(season.reshape((T,) + grid)).add_(t["mean_K"])
    raw["tas"].copy_(tas)
    for name, sign in (("tasmax", 1.0), ("tasmin", -1.0)):
        half = raw[name].mul_(r["half_sd_K"]).add_(r["half_K"])
        half.clamp_(min=r["min_half_K"]).mul_(sign).add_(tas)
    del tas
    normal = statistics.NormalDist()
    q = normal.inv_cdf(1.0 - p["wet_share"])
    d = normal.inv_cdf(1.0 - p["wet_share"] - p["drizzle_share"])
    lat = ar1(raw["pr"], p["phi"])
    wet = (lat - q).clamp_(min=0.0).pow_(p["power"]).mul_(p["scale_mm"])
    drizzle = (lat - d).clamp_(min=0.0).div_(q - d)
    raw["pr"].copy_(torch.where(lat > q, wet.add_(1.0), drizzle) / 86400.0)


def setup(config: dict, seed: int, device) -> dict:
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
    from xclim_tpu_torch.indicators import icclim

    data = config["data"]
    raw = generate.make(data, seed, device)
    shape_series(data, raw)
    T = generate.days(data)
    lat, lon = data["grid"]
    time = date_range(f"{data['start_year']}-01-01", periods=T, freq="D",
                      calendar=data["calendar"])
    coords = {"time": time, "lat": np.arange(lat), "lon": np.arange(lon)}
    ds = ClimDataset({k: ClimArray(raw[k], ("time", "lat", "lon"), coords,
                                   dict(ATTRS[k]), k) for k in ATTRS})

    def step(ind, freq):
        return lambda d: ind(ds=d, freq=freq)

    steps = [step(getattr(icclim, name), freq) for _, name, freq in CALLS]
    return {"raw": raw, "ds": ds, "steps": steps}


def suite(state: dict) -> None:
    from xclim_tpu_torch import climjit_chain

    state["outs"] = climjit_chain(state["steps"])(state["ds"])


STAGES = {"suite": suite}


def cell_days(state: dict) -> int:
    """Work of one call: cells x days of one series (the suite reads four
    of them, 30 times over)."""
    return state["raw"]["tas"].numel()


def inputs(state: dict) -> dict:
    """The four series as shaped in set-up, (days, cells)."""
    return {k: v.reshape(v.shape[0], -1) for k, v in state["raw"].items()}


def outputs(state: dict) -> dict:
    """The last call's outputs by name, (periods, cells)."""
    C = state["raw"]["tas"][0].numel()
    return {name: out.data.reshape(-1, C)
            for name, out in zip(PRODUCES["suite"], state["outs"])}
