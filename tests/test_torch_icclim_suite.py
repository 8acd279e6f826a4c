"""The port's ECA&D suite (30 calls of ``xclim_tpu_torch.indicators.icclim``
over tas, tasmax, tasmin and pr, chained as the benchmark's caller chains
them) against the benchmark's plain reference, ``perfbench/reference/
icclim.py`` (plain torch, float64 arithmetic, nothing of the port), on CPU
tensors at 2 x 4 cells x 4 years, on several seeds, with edge cells
planted: an all-dry year, a year whose growing season never starts and one
where it never ends, a year without frost, and a 5-day downpour across a
year's end.

Tolerances (the reference works in float64 from the same float32 inputs):

- means, extremes, ranges: 1e-4 K (the port's float32 mean of a float64
  sum, a float32 step at 300 K is 3e-5 K);
- degree days: 1e-2 K days (the thresholds 4 and 17 degC rounded to
  float32, up to 1.5e-5 K a day over a year's 365 days is 5.5e-3);
- precipitation amounts: 1e-4 mm (amounts are pr x 86400 in float32, a
  relative 6e-8 each, over a year's ~700 mm at most 4e-5);
- counts, run lengths and GSL: inside the reference's interval exactly;
  SDII and PRCPTOT inside it within 1e-4 (their float32 sums).
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from perfbench.callers import icclim as caller
from perfbench.reference import icclim as reference

CONFIG = json.loads((pathlib.Path(caller.__file__).resolve().parent.parent
                     / "configs" / "icclim_ecad_16k.json").read_text())
YEARS, GRID = 4, (2, 4)
SEEDS = (0, 7, 2**31 + 12345)
TOL = {"K": 1e-4, "K_days": 1e-2, "mm": 1e-4, "mm_per_day": 1e-4,
       "days": 0.0}
#: the planted edge cells (flat index) and their year
DRY, NO_START, NO_END, NO_FROST, DOWNPOUR = 0, 1, 2, 3, 4


def _config():
    c = copy.deepcopy(CONFIG)
    c["data"].update(grid=list(GRID), years=YEARS)
    return c


def _state(seed: int, plant: bool = True) -> dict:
    """The caller's set-up on the CPU, the edge cells planted in place in
    the series the program's dataset holds."""
    c = _config()
    state = caller.setup(c, seed, torch.device("cpu"))
    state["config"] = c
    if plant:
        x = {k: v.reshape(v.shape[0], -1) for k, v in state["raw"].items()}
        y1 = slice(365, 730)
        x["pr"][y1, DRY] = 0.0
        x["tas"][:365, NO_START] = 270.0                 # -3 degC all year
        x["tas"][2 * 365 + reference.JULY_1:3 * 365, NO_END] = 285.0
        x["tasmin"][y1, NO_FROST] = x["tasmin"][y1, NO_FROST].clamp(min=276.0)
        x["pr"][363:368, DOWNPOUR] = 80.0 / 86400.0    # 30 Dec to 3 Jan
    return state


def _compare(state):
    got = caller.outputs(state)
    want = reference.reference(caller.inputs(state), state["config"], {})
    for name in reference.NAMES:
        g, w = got[name].double(), want[name]
        tol = TOL[reference.UNITS[name]]
        if name in reference.INTERVALS:
            lo, hi = w
            nan = torch.isnan(lo)
            assert torch.equal(torch.isnan(g), nan), name
            g, lo, hi = g[~nan], lo[~nan], hi[~nan]
            slack = 1e-4 if name in ("SDII", "PRCPTOT") else 0.0
            assert bool(((g >= lo - slack) & (g <= hi + slack)).all()), \
                (name, g, lo, hi)
        else:
            assert g.shape == w.shape, name
            assert float((g - w).abs().max()) <= tol, name
    return got, want


@pytest.mark.parametrize("seed", SEEDS)
def test_the_suite_matches_the_plain_reference(seed):
    state = _state(seed, plant=False)
    caller.suite(state)
    _compare(state)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_planted_edge_cells(seed):
    state = _state(seed)
    caller.suite(state)
    got, _ = _compare(state)
    # an all-dry year: CDD the whole year, no wet day, SDII NaN (0 / 0, as
    # xclim's sum over wet days divided by their count gives)
    assert got["CDD"][1, DRY] == 365 and got["CWD"][1, DRY] == 0
    assert got["RR1"][1, DRY] == 0 and got["PRCPTOT"][1, DRY] == 0
    assert got["RR"][1, DRY] == 0 and got["RX5day"][1, DRY] >= 0
    assert torch.isnan(got["SDII"][1, DRY])
    assert not torch.isnan(got["SDII"][[0, 2, 3], DRY]).any()
    # no growing season starts: 0
    assert got["GSL"][0, NO_START] == 0
    # a season that starts and never ends runs to the year's end: 365 less
    # its first day (the first 6-day run at or above 5 degC)
    tas = caller.inputs(state)["tas"][2 * 365:3 * 365, NO_END]
    warm = (tas >= 278.15).tolist()
    start = next(d for d in range(365) if all(warm[d:d + 6]))
    assert got["GSL"][2, NO_END] == 365 - start
    # no frost
    assert got["FD"][1, NO_FROST] == 0 and got["CFD"][1, NO_FROST] == 0
    # the 5-day window ending on 3 January holds 30 December to 3 January
    # and counts to the second year
    assert got["RX5day"][1, DOWNPOUR] == pytest.approx(400.0, rel=1e-6)
    assert got["RX5day"][0, DOWNPOUR] < 400.0


def test_the_chain_returns_the_30_outputs_in_the_listed_order():
    state = _state(3, plant=False)
    caller.suite(state)
    outs = state["outs"]
    assert len(outs) == len(caller.CALLS) == len(reference.NAMES) == 30
    assert [o for o, _, _ in caller.CALLS] == list(reference.NAMES)
    for out, (_, name, freq) in zip(outs, caller.CALLS):
        assert out.name == name
        assert out.shape == ((YEARS if freq == "YS" else 12 * YEARS),
                             *GRID)
        assert out.data.dtype == torch.float32
    assert [o.attrs["units"] for o in outs[:3]] == ["K", "K", "K"]
    # the suite is the module's: the caller reimplements no index
    from xclim_tpu_torch.indicators import icclim

    assert all(hasattr(icclim, name) for _, name, _ in caller.CALLS)


def test_every_threshold_is_crossed_at_the_configured_model():
    """The configuration's series cross each threshold of the suite: frost
    and ice days, summer days, tropical nights, a growing season, R20mm."""
    c = _config()
    c["data"].update(grid=[8, 8], years=6)
    state = caller.setup(c, 11, torch.device("cpu"))
    want = reference.reference(caller.inputs(state), c, {})
    for name in ("FD", "ID", "SU", "TR", "CSU", "CFD", "R10mm", "R20mm"):
        assert float(want[name][0].sum()) > 0, name
    assert float((want["GSL"][0] > 0).double().mean()) > 0.9
    wet = caller.inputs(state)["pr"] * 86400.0 >= 1.0
    assert 0.3 < float(wet.double().mean()) < 0.5
    assert np.isfinite(want["SDII"][0].numpy()).all()
