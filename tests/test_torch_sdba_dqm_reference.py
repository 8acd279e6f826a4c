"""The port's ``DetrendedQuantileMapping`` (day-of-year window 31, 50
quantiles, ``kind="+"``, a +0.03 K a year trend planted in sim) against the
benchmark's plain reference, ``perfbench/reference/dqm.py`` (plain torch,
float64 index and time arithmetic, nothing of the port), on CPU tensors at
6 x 5 cells x 30 years: the trained scaling, factors and nodes, and the
adjusted series; that the comparison sees the detrend; and that the planted
trend survives the adjustment.

The gaps measured on 12 seeds (float32): scaling <= 1.5e-4 K, af <= 2.8e-4,
hist_q <= 3.1e-4, scen <= 4.6e-4; the reference without its detrend 0.96 to
2.3 K from the port's scen. Each tolerance below states its reason.
"""

import numpy as np
import pytest
import torch

from perfbench.reference import dqm
from xclim_tpu_torch import sdba
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray

YEARS, GRID, TREND = 30, (6, 5), 0.03
SERIES = {"ref": (285.0, 5.0, 1981), "hist": (287.0, 6.0, 1981),
          "sim": (289.0, 6.0, 2071)}
CONFIG = {"method": {"name": "DetrendedQuantileMapping",
                     "group": "time.dayofyear", "window": 31,
                     "nquantiles": 50, "kind": "+"},
          "data": {"start_year": {"sim": 2071}}}
SEEDS = (0, 1, 2**31 + 12345, 2**33 + 5)

#: scaling: two window means of 930 values near 290 K, each summed in
#: float32 in another order than the reference's (about 1e-6 of 300 K each)
SCALING_TOL = 6e-4
#: hist_q: quantiles of hist plus the scaling, so the scaling's gap, plus the
#: port's float32 virtual index against the reference's float64 one (up to
#: 4e-4 K at 2048 cells in the QDM cell, PERF.md section 2)
HIST_Q_TOL = 1e-3
#: af = ref_q - hist_q: hist_q's gap and ref_q's quantile gap (4e-4 K)
AF_TOL = 1.5e-3
#: scen = sim + scaling + af at the detrended value: the scaling's and af's
#: gaps, a few float32 steps at 290 K for the detrend and retrend, and the
#: nodes' gap times the local slope of af over hist_q (the sound runs read
#: 4.6e-4 at most)
SCEN_TOL = 2.5e-3
#: the slope of scen less the slope of sim, in K a year: the detrended series
#: has no line, so af at it adds only a noise slope (sd ~0.5 K over 10950
#: days: ~5.5e-4 K a year); EQM without the detrend scales the trend by
#: about 1 + d af / d hist_q = 5/6, 0.005 K a year off
SLOPE_TOL = 3e-3


def _inputs(seed):
    """ref, hist, sim as (days, lat, lon) float32 CPU tensors; sim with the
    planted trend, as the benchmark's caller plants it."""
    gen = torch.Generator().manual_seed(seed)
    T = YEARS * 365
    out = {k: torch.randn((T,) + GRID, generator=gen) * sd + mu
           for k, (mu, sd, _) in SERIES.items()}
    years = torch.arange(T, dtype=torch.float64) / 365.0
    out["sim"] += (TREND * years).to(torch.float32)[:, None, None]
    return out


def _array(x, name):
    time = date_range(f"{SERIES[name][2]}-01-01", periods=x.shape[0],
                      freq="D", calendar="noleap")
    coords = {"time": time, "lat": np.arange(GRID[0]),
              "lon": np.arange(GRID[1])}
    return ClimArray(x, ("time", "lat", "lon"), coords, {"units": "K"}, name)


def _port_and_reference(seed):
    x = _inputs(seed)
    adj = sdba.DetrendedQuantileMapping.train(
        _array(x["ref"], "ref"), _array(x["hist"], "hist"),
        group=sdba.Grouper("time.dayofyear", 31), nquantiles=50, kind="+")
    scen = adj.adjust(_array(x["sim"], "sim"))
    flat = {k: v.reshape(v.shape[0], -1) for k, v in x.items()}
    C = flat["sim"].shape[1]
    got = {"scaling": adj.ds["scaling"].reshape(-1, C),
           "af": adj.ds["af"].reshape(-1, C),
           "hist_q": adj.ds["hist_q"].reshape(-1, C),
           "scen": scen.data.reshape(-1, C)}
    return flat, got, dqm.reference(flat, CONFIG, {})


def _slope(x):
    """Least-squares slope of each column over the days, in K a year."""
    t = torch.arange(x.shape[0], dtype=torch.float64) / 365.0
    t = t - t.mean()
    return (t @ (x.double() - x.double().mean(dim=0))) / (t @ t)


@pytest.fixture(scope="module", params=SEEDS)
def runs(request):
    return _port_and_reference(request.param)


@pytest.mark.parametrize("name,tol", [("scaling", SCALING_TOL),
                                      ("hist_q", HIST_Q_TOL),
                                      ("af", AF_TOL), ("scen", SCEN_TOL)])
def test_port_matches_the_reference(runs, name, tol):
    _, got, want = runs
    assert got[name].shape == want[name].shape
    assert not torch.isnan(want[name]).any()
    assert torch.equal(torch.isnan(got[name]), torch.isnan(want[name]))
    assert float((got[name] - want[name]).abs().max()) <= tol


def test_the_comparison_sees_the_detrend(runs):
    """The reference with the detrend and retrend left out (the scaled sim
    mapped as it is) is farther from the port than scen's tolerance, by a
    wide margin."""
    flat, got, want = runs
    C = got["scen"].shape[1]
    T = flat["sim"].shape[0]
    hist_q = want["hist_q"].reshape(365, -1, C)
    af = want["af"].reshape(365, -1, C)
    plain = dqm.eqm(flat["sim"] + dqm.by_doy(want["scaling"], T), hist_q, af)
    assert float((got["scen"] - plain).abs().max()) > 100 * SCEN_TOL
    # and the trend that plain EQM distorts is outside the slope's bound
    gap = (_slope(plain) - _slope(flat["sim"])).abs().max()
    assert float(gap) > SLOPE_TOL


def test_the_planted_trend_survives_the_adjustment(runs):
    flat, got, _ = runs
    s_sim, s_scen = _slope(flat["sim"]), _slope(got["scen"])
    assert float((s_scen - s_sim).abs().max()) <= SLOPE_TOL
    # sim's fitted slope is the planted one within its noise (sd 6 K over
    # 10950 days: ~6.6e-3 K a year; five of it)
    assert float((s_sim - TREND).abs().max()) <= 0.035


def test_the_reference_fits_a_line_exactly():
    """A line is its own least-squares fit, with a missing value or
    without."""
    T = YEARS * 365
    t = torch.arange(T, dtype=torch.float64) / 365.0
    line = (280.0 + 0.05 * t)[:, None].repeat(1, 3)
    got = dqm.linear_trend(line, 2071)
    torch.testing.assert_close(got, line, rtol=0, atol=1e-9)
    x = line.clone()
    x[5, 1] = torch.nan                  # a missing value is skipped
    torch.testing.assert_close(dqm.linear_trend(x, 2071), line, rtol=0,
                               atol=1e-9)
