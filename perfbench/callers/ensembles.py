"""Drives the ensembles of ``xclim_tpu_torch`` through their public entries:
``ensembles.ensemble_percentiles(ens, values)`` (stage ``percentiles``) and
``ensembles.robustness_fractions(fut, ref, test)`` with the future and
reference periods sliced from the ensemble (stage ``robustness``).

The configuration's ``data`` makes one series a member on a (time, lat,
lon) grid. In set-up, in place on those series (so that the program and
the reference are handed the same values), the caller adds each member's
warming, a ramp over the days from 0 to a width drawn from the seed in
``data.warming_K``, and marks missing the ocean (``data.ocean_share`` of
the cells in every member) and the land-mask cells (``data.land_mask_share``
of the cells, each missing in 1 to members - 1 members); the draws come from
a generator of their own, seeded from the run's seed. The members are then
stacked once with ``create_ensemble``, as a user's script stacks them.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import generate

#: the program's modules, imported in set-up
IMPORTS = ("xclim_tpu_torch.ensembles",)
#: stage name -> the benchmark's span around it
SPANS = {"percentiles": "ensembles.percentiles",
         "robustness": "ensembles.robustness"}
#: the fractions robustness_fractions returns
FRACTIONS = ("changed", "positive", "changed_positive", "negative",
             "changed_negative", "agree", "valid")
#: stage name -> the outputs (of :func:`outputs`) it makes
PRODUCES = {"percentiles": ("p10", "p50", "p90"),
            "robustness": FRACTIONS + ("pvals",)}


def masks(data: dict, seed: int, members: int):
    """(warming (members,), missing (members, *grid) bool): each member's
    warming over the year in K, and the cells each member misses."""
    rng = np.random.default_rng([seed, 1])
    lo, hi = data["warming_K"]
    warm = rng.uniform(lo, hi, members)
    cells = int(np.prod(data["grid"]))
    ocean = rng.random(cells) < data["ocean_share"]
    land = np.flatnonzero(~ocean
                          & (rng.random(cells) < data["land_mask_share"]))
    missing = np.zeros((members, cells), dtype=bool)
    missing[:, ocean] = True
    for c in land:
        k = rng.integers(1, members)
        missing[rng.choice(members, size=k, replace=False), c] = True
    return warm, missing.reshape(members, *data["grid"])


def setup(config: dict, seed: int, device) -> dict:
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.ensembles import create_ensemble

    data = config["data"]
    raw = generate.make(data, seed, device)
    T = generate.days(data)
    lat, lon = data["grid"]
    warm, missing = masks(data, seed, len(raw))
    missing = torch.as_tensor(missing, device=device)
    ramp = torch.linspace(0.0, 1.0, T, device=device)[:, None, None]
    time = date_range(f"{data['start_year']}-01-01", periods=T, freq="D",
                      calendar=data["calendar"])
    coords = {"time": time, "lat": np.arange(lat), "lon": np.arange(lon)}
    members = []
    for m, x in enumerate(raw.values()):
        x.add_(ramp * float(warm[m])).masked_fill_(missing[m], torch.nan)
        members.append(ClimArray(x, ("time", "lat", "lon"), coords,
                                 {"units": data["units"],
                                  "standard_name": "air_temperature"}, "tas"))
    return {"raw": raw, "ens": create_ensemble(members)}


def percentiles(state: dict) -> None:
    from xclim_tpu_torch.ensembles import ensemble_percentiles

    values = state["config"]["method"]["values"]
    state["per"] = ensemble_percentiles(state["ens"], values=values)


def robustness(state: dict) -> None:
    from xclim_tpu_torch.ensembles import robustness_fractions

    m = state["config"]["method"]
    ens = state["ens"]
    state["rf"] = robustness_fractions(
        ens.isel(time=slice(*m["fut_days"])),
        ens.isel(time=slice(*m["ref_days"])), test=m["test"])


STAGES = {"percentiles": percentiles, "robustness": robustness}


def cell_days(state: dict) -> int:
    """Work of one call: members x days x cells, the member-cell-days the
    ensemble holds."""
    return state["ens"].data.numel()


def inputs(state: dict) -> dict:
    """Each member's series, with its warming and missing cells, as (days,
    cells)."""
    return {k: v.reshape(v.shape[0], -1) for k, v in state["raw"].items()}


def outputs(state: dict) -> dict:
    """The last call's percentiles (days, cells), fractions (1, cells) and
    p-values (members, cells)."""
    C = state["raw"][next(iter(state["raw"]))][0].numel()
    values = state["config"]["method"]["values"]
    out = {f"p{v}": state["per"][float(v)].data.reshape(-1, C)
           for v in values}
    rf = state["rf"]
    out.update({k: rf[k].data.reshape(1, C) for k in FRACTIONS})
    out["pvals"] = rf["pvals"].data.reshape(-1, C)
    return out
