"""Inputs made on the device from a seed, by the ``data`` section of a
configuration file.

Every generator draws from one ``torch.Generator`` on the given device,
seeded with the run's seed, in a few large calls: the same seed on the same
kind of device gives the same inputs. Series are time-first float32
``(days, *grid)`` on a noleap calendar from 1 January, which is what model
output of this kind looks like and what the plain references assume.
"""

from __future__ import annotations

import math

import torch


def days(data: dict) -> int:
    """Days of a series: whole noleap years."""
    if data["calendar"] != "noleap":
        raise ValueError("the generators make noleap series only")
    return data["years"] * 365


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def normal_series(data: dict, seed: int, device) -> dict:
    """Independent N(mean, sd) daily values for each named series
    (``data["series"]``: name -> [mean, sd]), in the order given."""
    gen = _generator(seed, device)
    shape = (days(data), *data["grid"])
    return {name: torch.randn(shape, generator=gen, device=device) * sd + mu
            for name, (mu, sd) in data["series"].items()}


def ar1_tasmax(data: dict, seed: int, device) -> dict:
    """{"tasmax"}: mean + a seasonal cycle + sd x an AR(1) anomaly with
    coefficient phi and unit variance. Without the autocorrelation, warm
    spells of 6 days above the 90th percentile would almost never occur.

    The recurrence ``a[t] = phi a[t-1] + e[t]`` runs as a doubling scan
    (``a[t] += phi^s a[t-s]`` for s = 1, 2, 4, ...) until phi^s is below
    float32's resolution, so it takes a few passes over the series and
    not one launch a day.
    """
    gen = _generator(seed, device)
    T = days(data)
    phi = float(data["phi"])
    a = torch.randn((T, *data["grid"]), generator=gen, device=device)
    a[1:] *= math.sqrt(1.0 - phi ** 2)
    s = 1
    while s < T and phi ** s > 1e-9:
        a = torch.cat([a[:s], torch.add(a[s:], a[:-s], alpha=phi ** s)])
        s *= 2
    doy = torch.arange(T, device=device) % 365 + 1
    season = data["season_K"] * torch.sin(
        2 * math.pi * (doy - data["season_phase_doy"]) / 365)
    season = season.to(torch.float32).reshape((T,) + (1,) * len(data["grid"]))
    tasmax = a.mul_(data["anomaly_K"]).add_(season).add_(data["mean_K"])
    return {"tasmax": tasmax}


GENERATORS = {"normal_series": normal_series, "ar1_tasmax": ar1_tasmax}


def make(data: dict, seed: int, device) -> dict:
    """The named input tensors of a configuration's ``data`` section."""
    return GENERATORS[data["kind"]](data, seed, device)
