"""The sdba caller (``perfbench/callers/sdba.py``: its imports, spans,
stages and work) with a linear trend planted in sim: in set-up,
``data.trend_K_per_year`` times the decimal years since sim's start is
added to sim, in place, so that the program adjusts, and the reference is
handed, the trended series. ``outputs`` adds the trained ``scaling``
(DetrendedQuantileMapping's per-doy mean correction).
"""

from __future__ import annotations

import torch

from perfbench import generate
from perfbench.callers import sdba

IMPORTS = sdba.IMPORTS
SPANS = sdba.SPANS
STAGES = sdba.STAGES
PRODUCES = {"train": ("af", "hist_q", "scaling"), "adjust": ("scen",)}
cell_days = sdba.cell_days
inputs = sdba.inputs


def setup(config: dict, seed: int, device) -> dict:
    state = sdba.setup(config, seed, device)
    data = config["data"]
    sim = state["raw"]["sim"]            # the tensor the sim ClimArray holds
    years = torch.arange(generate.days(data), dtype=torch.float64,
                         device=device) / 365.0
    trend = (data["trend_K_per_year"] * years).to(sim.dtype)
    sim.add_(trend.reshape((-1,) + (1,) * (sim.ndim - 1)))
    return state


def outputs(state: dict) -> dict:
    """The sdba caller's outputs and the trained scaling as (doy, cells)."""
    out = sdba.outputs(state)
    C = state["raw"]["sim"][0].numel()
    out["scaling"] = state["adj"].ds["scaling"].reshape(-1, C)
    return out
