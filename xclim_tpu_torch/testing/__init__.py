"""Testing support: synthetic data generators, the laziness guard and the
testing-data utilities (reference: xclim:src/xclim/testing/; the modules
``helpers``, ``fixtures`` and ``utils``), and checks that hold the port's
results to independent float64 replays.

:func:`check_cffwis` holds the Canadian fire weather codes
(``indices.fire``) on any device to a float64 replay on the CPU, written
from the equations apart from ``indices.fire``, that starts each day from
the run's own codes of the day before, so that the replay takes every
threshold decision on the same value the run did: DMC's
equation switches at 33 and 65 with a jump, so two devices whose carries
drift apart by float32 rounding can take the two sides on a wet day and
then differ by a tenth of a code for months, each of them right.

:func:`check_chill_portions` holds the dynamic chill-portion model
(``indices._agro``) on any device to a float64 replay on the CPU. The model
banks a portion only in the hours where its intermediate product E reaches
1, so an E within float32 rounding of 1 banks on one device and not on
another, and the two devices' period sums then differ by part of a portion
or more. The replay follows the device's own banking decision at every
hour, accepts a decision that differs from float64's own E >= 1 only where
the float64 E lies within ``flip_tol`` of 1, and holds the period sums to
``rtol``: each device is held to float64 as far as float32 rounding
reaches, its flips included, and a flip away from E = 1 is a failure.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.testing.helpers import (  # noqa: F401
    assert_lazy,
    generate_atmos,
    test_grid,
    test_timeseries,
)
from xclim_tpu_torch.testing import utils  # noqa: F401
from xclim_tpu_torch.testing.utils import (  # noqa: F401
    list_input_variables,
    nimbus,
    open_dataset,
    show_versions,
)

__all__ = ["CFFWIS_FWI_ATOL", "CFFWIS_RTOL", "CFFWIS_SCALE_TOL", "chill_replay",
           "check_chill_portions", "cffwis_replay", "check_cffwis",
           "assert_lazy", "generate_atmos", "list_input_variables", "nimbus",
           "open_dataset", "show_versions", "test_grid", "test_timeseries",
           "utils"]


def chill_replay(tas_K, bank=None):
    """Float64 replay on the CPU of the dynamic chill model for hourly
    ``tas_K`` [K] with time first: (E, xi, delta), the intermediate product
    after each hour, the hour's portion factor and the portion banked.
    Where ``bank`` (bool, time first) is given a portion is banked by its
    decision, else where E >= 1 (Fishman et al. 1987;
    xclim:_agro.py:1436-1535)."""
    e0, e1 = 4153.5, 12888.8
    a0, a1 = 139500.0, 2.567e18
    slp, tetmlt = 1.6, 277.0
    x = tas_K.detach().to("cpu", torch.float64)
    sr = torch.exp(slp * tetmlt * (x - tetmlt) / x)
    xi = sr / (1 + sr)
    xs = a0 / a1 * torch.exp((e1 - e0) / x)
    decay = torch.exp(-a1 * torch.exp(-e1 / x))
    E = torch.empty_like(x)
    banked = torch.empty(x.shape, dtype=torch.bool)
    prev_E = torch.zeros(x.shape[1:], dtype=torch.float64)
    prev_bank = torch.zeros(x.shape[1:], dtype=torch.bool)
    prev_xi = torch.zeros_like(prev_E)
    for t in range(x.shape[0]):
        s = torch.where(prev_bank, prev_E - prev_E * prev_xi, prev_E)
        prev_E = xs[t] - (xs[t] - s) * decay[t]
        E[t] = prev_E
        prev_bank = bank[t] if bank is not None else prev_E >= 1
        banked[t] = prev_bank
        prev_xi = xi[t]
    return E, xi, torch.where(banked, E * xi, 0.0)


def check_chill_portions(tas, freq="YS", rtol=1e-5, atol=1e-6,
                         flip_tol=1e-5):
    """Chill portions of hourly ``tas`` on its device, held to the float64
    replay under the device's banking decisions. A NaN hour makes E NaN
    from there on in both, and neither banks again.

    Returns (portions, report). ``report``: ``bank`` and ``E``, the
    device's decisions and intermediate product (CPU, time first); ``E64``,
    the replay's; ``flips``, the hours whose decision differs from
    float64's own E >= 1, and ``flip_gap``, the largest |E64 - 1| there;
    ``replay``, the replay's period sums (period first), and
    ``max_abs_err``/``max_rel_err`` of the device's sums against them.
    Raises AssertionError for a flip gap past ``flip_tol`` or a period sum
    off by more than ``atol + rtol * |replay|``.
    """
    from xclim_tpu_torch.core.units import convert_units_to
    from xclim_tpu_torch.indices import _agro

    tk = convert_units_to(tas, "K")
    x = torch.movedim(tk.data, tk.time_axis, 0)
    inter, _ = _agro._chill_intermediate(x)
    bank = (inter >= 1).cpu()
    E64, _, delta = chill_replay(x, bank)
    flips = bank != (E64 >= 1)
    gap = float((E64[flips] - 1).abs().max()) if bool(flips.any()) else 0.0
    if gap > flip_tol:
        raise AssertionError(f"chill portions: a banking decision differs "
                             f"from float64's where |E64 - 1| = {gap:.3g} "
                             f"> {flip_tol}")
    out = _agro.chill_portions(tas, freq=freq)
    spec = tk.segments(freq)
    want = torch.stack([delta[int(s):int(s) + int(c)].sum(0)
                        for s, c in zip(spec.starts, spec.counts)])
    got = torch.movedim(out.data, out.time_axis, 0).cpu().double()
    err = (got - want).abs()
    rel = float((err / want.abs().clamp(min=atol)).max())
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"chill portions: {int(bad.sum())} period sums "
                             f"beyond rtol {rtol} atol {atol} of the float64 "
                             f"replay, max abs err {float(err.max())}")
    return out, {"bank": bank, "E": inter.cpu(), "E64": E64,
                 "flips": int(flips.sum()), "flip_gap": gap, "replay": want,
                 "max_abs_err": float(err.max()), "max_rel_err": rel}


#: check_cffwis' bounds. Each day of a float32 run is held to the float64
#: replay of that day from the run's own codes within CFFWIS_RTOL of the
#: replayed value plus CFFWIS_SCALE_TOL of the output's largest value: one
#: day's float32 rounding, where DMC's 43.43 (5.6348 - ln(...)) and DC's
#: dc0 - 400 ln(...) cancel to ~5e-7 of their scale.
CFFWIS_RTOL = 1e-5
CFFWIS_SCALE_TOL = 2e-6
#: FWI's last step, exp(2.72 (0.434 ln f)^0.647) for f > 1, is
#: Hoelder-continuous with exponent 0.647 at f = 1: a float32 rounding of f
#: by 16 ulps of 1 there moves FWI by 3.3e-4, so wherever FWI is held to
#: another computation of it, it has this absolute term besides.
CFFWIS_FWI_ATOL = 5e-4

# the start values and season parameters of the CFFWIS (xclim's defaults)
_FIRE_PARAMS = {"dc_start": 15.0, "dmc_start": 6.0, "ffmc_start": 85.0,
                "carry_over_fraction": 0.75, "wetting_efficiency_fraction": 0.75,
                "prec_thresh": 1.0, "dc_dry_factor": 5.0, "dmc_dry_factor": 2.0}


# -- the CFFWIS equations in float64 (Van Wagner 1987, with the CFS
# -- constants xclim uses), one day from yesterday's code, written apart from
# -- indices.fire so that the replay shares none of its code


def _vw_ffmc(t, p, w, h, f0):
    """FFMC (Eqs. 1-10)."""
    mo = 147.2 * (101.0 - f0) / (59.5 + f0)
    wet = p > 0.5
    rf = torch.where(wet, p - 0.5, 1.0)
    gain = 42.5 * rf * torch.exp(-100.0 / (251.0 - mo)) * (1.0 - torch.exp(-6.93 / rf))
    gain = gain + torch.where(mo > 150.0, 0.0015 * (mo - 150.0) ** 2 * rf ** 0.5,
                              0.0)
    mo = torch.where(wet, torch.clamp(mo + gain, max=250.0), mo)
    hum = 0.18 * (21.1 - t) * (1.0 - torch.exp(-0.115 * h))
    ed = 0.942 * h ** 0.679 + 11.0 * torch.exp((h - 100.0) / 10.0) + hum
    ew = 0.618 * h ** 0.753 + 10.0 * torch.exp((h - 100.0) / 10.0) + hum

    def rate(x):
        k = 0.424 * (1.0 - (x / 100.0) ** 1.7) \
            + 0.0694 * w ** 0.5 * (1.0 - (x / 100.0) ** 8)
        return 10.0 ** -(k * 0.581 * torch.exp(0.0365 * t))

    m = torch.where(mo > ed, ed + (mo - ed) * rate(h),
                    torch.where(mo < ew, ew - (ew - mo) * rate(100.0 - h), mo))
    return torch.clamp(59.5 * (250.0 - m) / (147.2 + m), 0.0, 101.0)


def _vw_dmc(t, p, h, dl, d0):
    """DMC (Eqs. 11-17)."""
    rk = torch.where(t < -1.1, 0.0, 1.894 * (t + 1.1) * (100.0 - h) * dl * 1e-4)
    re = 0.92 * p - 1.27
    b = torch.where(d0 <= 33.0, 100.0 / (0.5 + 0.3 * d0),
                    torch.where(d0 <= 65.0, 14.0 - 1.3 * torch.log(d0),
                                6.2 * torch.log(d0) - 17.2))
    mr = 20.0 + 280.0 / torch.exp(0.023 * d0) + 1000.0 * re / (48.77 + b * re)
    after_rain = torch.where(p > 1.5, 43.43 * (5.6348 - torch.log(mr - 20.0)), d0)
    return torch.clamp(torch.clamp(after_rain, min=0.0) + rk, min=0.0)


def _vw_dc(t, p, fl, d0):
    """DC (Eqs. 18-22)."""
    qr = 800.0 * torch.exp(-d0 / 400.0) + 3.937 * (0.83 * p - 1.27)
    dr = 400.0 * torch.log(800.0 / qr)
    # Dr where it is positive, else 0, as xclim tests it: a DC that is off
    # (NaN, out of season) takes 0 here and restarts from pe on a wet day
    after_rain = torch.where(dr > 0.0, dr, 0.0)
    v = torch.clamp(0.36 * (torch.clamp(t, min=-2.8) + 2.8) + fl, min=0.0)
    return torch.where(p > 2.8, after_rain, d0) + 0.5 * v


def _vw_isi(w, ffmc):
    """ISI (Eqs. 24-26)."""
    m = 147.2 * (101.0 - ffmc) / (59.5 + ffmc)
    return 0.208 * torch.exp(0.05039 * w) * 91.9 * torch.exp(-0.1386 * m) \
        * (1.0 + m ** 5.31 / 4.93e7)


def _vw_bui(dmc, dc):
    """BUI (Eqs. 27a-b)."""
    s = dmc + 0.4 * dc
    u = torch.where(dmc <= 0.4 * dc, 0.8 * dmc * dc / s,
                    dmc - (1.0 - 0.8 * dc / s) * (0.92 + (0.0114 * dmc) ** 1.7))
    return torch.where((dmc == 0) & (dc == 0), 0.0, torch.clamp(u, min=0.0))


def _vw_fwi(isi, bui):
    """FWI (Eqs. 28-30)."""
    fd = torch.where(bui <= 80.0, 0.626 * bui ** 0.809 + 2.0,
                     1000.0 / (25.0 + 108.64 * torch.exp(-0.023 * bui)))
    b = 0.1 * isi * fd
    return torch.where(b > 1.0, torch.exp(2.72 * (0.434 * torch.log(b)) ** 0.647),
                       b)


def _vw_overwintered_dc(last_dc, winter_pr, a, b, min_dc):
    """The season's first DC from last season's and the winter's
    precipitation (Lawson and Armitage 2008)."""
    qs = a * 800.0 * torch.exp(-last_dc / 400.0) + b * 3.94 * winter_pr
    return torch.clamp(400.0 * torch.log(800.0 / qs), min=min_dc)


def _replay_starts(run, first, season_mask, pr, p, overwintering, dry_start,
                   initial_start_up):
    """The (DC, DMC, FFMC) each day starts from: the run's of the day
    before (``first`` on day 0) through the day's season transitions, read
    from the mask of yesterday and today one day at a time, with the
    overwintering state carried in float64."""
    nan = torch.full_like(first[0], torch.nan)

    def or_start(x, key):
        return torch.where(torch.isnan(x), p[key], x)

    dc0, dmc0, ffmc0 = first
    codes = [nan if overwintering else dc0, dmc0, ffmc0]
    keep_dc = dc0 if overwintering else (
        or_start(dc0, "dc_start") if dry_start else nan)
    keep_dmc = or_start(dmc0, "dmc_start") if dry_start else nan
    wpr = torch.zeros_like(nan)
    was = torch.zeros_like(nan, dtype=torch.bool) if initial_start_up \
        else season_mask[0]
    starts = [torch.empty_like(r) for r in run]
    for i in range(season_mask.shape[0]):
        now = season_mask[i]
        up, down, winter = now & ~was, was & ~now, ~now & ~was
        was = now
        wet = winter & (pr[i] > p["prec_thresh"])
        dc, dmc, ffmc = codes
        if overwintering:
            keep_dc = torch.where(down, dc, keep_dc)
            wpr = torch.where(down, pr[i], torch.where(winter, wpr + pr[i], wpr))
            carried = _vw_overwintered_dc(keep_dc, wpr,
                                          p["carry_over_fraction"],
                                          p["wetting_efficiency_fraction"],
                                          p["dc_start"])
            dc = torch.where(up, torch.where(torch.isnan(keep_dc),
                                             p["dc_start"], carried), dc)
            keep_dc = torch.where(up, nan, keep_dc)
            wpr = torch.where(up, 0.0, wpr)
        elif dry_start:
            keep_dc = torch.where(down | wet, p["dc_start"], torch.where(
                winter, keep_dc + p["dc_dry_factor"], keep_dc))
            dc = torch.where(up, keep_dc, dc)
            keep_dc = torch.where(up, nan, keep_dc)
        else:
            dc = torch.where(up, p["dc_start"], dc)
        if dry_start:
            keep_dmc = torch.where(down | wet, p["dmc_start"], torch.where(
                winter, keep_dmc + p["dmc_dry_factor"], keep_dmc))
            dmc = torch.where(up, keep_dmc, dmc)
            keep_dmc = torch.where(up, nan, keep_dmc)
        else:
            dmc = torch.where(up, p["dmc_start"], dmc)
        ffmc = torch.where(up, p["ffmc_start"], ffmc)
        for s, x in zip(starts, (dc, dmc, ffmc)):
            s[i] = torch.where(down, nan, x)
        codes = [r[i] for r in run]
    return starts


def cffwis_replay(tas, pr, hurs, sfcWind, dl, flf, codes, season_mask=None,
                  dc0=None, dmc0=None, ffmc0=None, overwintering=False,
                  dry_start=None, initial_start_up=True, **params):
    """Float64 replay on the CPU of a CFFWIS run, each day from the run's
    own codes: day i starts from the run's (DC, DMC, FFMC) of day i - 1
    (the initial codes, else the start values, on day 0), goes through the
    season's transitions (the overwintering state carried in float64) and
    one step of each code. The arguments are those of
    ``indices.fire._cffwis.fire_weather_calc`` (time first: tas [degC], pr
    [mm/d], hurs [%], sfcWind [km/h], the day-length series) and the run's
    codes; returns the replayed (DC, DMC, FFMC), time first.

    The equations, the start values and the season transitions are this
    module's own, written from Van Wagner (1987) as xclim states them and
    sharing no code with ``indices.fire``, so that a wrong hoisted term or
    a wrong transition in the port fails here on every device. DMC's b
    (which jumps at 33 and 65) decides on the run's own DMC, and FFMC's
    branches, which join continuously, on moistures computed from the
    run's own FFMC, so the replay differs from a right run by one day's
    float32 rounding, never by a jump taken on its other side."""

    def f64(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            x = getattr(x, "data", x)  # a ClimArray of either package
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.detach().to("cpu", torch.float64)

    tas, pr, hurs, sfcWind = map(f64, (tas, pr, hurs, sfcWind))
    dl, flf = (f64(x).reshape(x.shape + (1,) * (tas.ndim - x.ndim))
               for x in (dl, flf))
    run = [f64(c) for c in codes]
    p = {**_FIRE_PARAMS, **params}
    nan = torch.full(tas.shape[1:], torch.nan, dtype=torch.float64)
    first = [nan if x is None else f64(x).expand(tas.shape[1:])
             for x in (dc0, dmc0, ffmc0)]
    if season_mask is None:
        first = [torch.where(torch.isnan(x), p[k], x) for x, k in
                 zip(first, ("dc_start", "dmc_start", "ffmc_start"))]
        starts = [torch.cat([f.unsqueeze(0), r[:-1]]) for f, r in
                  zip(first, run)]
    else:
        starts = _replay_starts(run, first, season_mask.cpu(), pr, p,
                                overwintering, dry_start, initial_start_up)
    return (_vw_dc(tas, pr, flf, starts[0]),
            _vw_dmc(tas, pr, hurs, dl, starts[1]),
            _vw_ffmc(tas, pr, sfcWind, hurs, starts[2]))


def check_cffwis(out, tas, pr, sfcWind, hurs, lat=None, snd=None,
                 ffmc0=None, dmc0=None, dc0=None, season_mask=None,
                 season_method=None, overwintering=False, dry_start=None,
                 initial_start_up=True, **params):
    """Hold the outputs ``out`` of ``cffwis_indices(tas, pr, sfcWind, hurs,
    **kwargs)`` (on any device) to the float64 replay of their own days
    (:func:`cffwis_replay`), and ISI, BUI, FWI and DSR to their float64
    values from the run's own codes and indices (FWI from the run's ISI
    and BUI, DSR from its FWI): every value within CFFWIS_RTOL of the
    replay's plus CFFWIS_SCALE_TOL of the output's largest value (FWI with
    CFFWIS_FWI_ATOL besides), NaN where the replay is.

    The inputs the replay reads, in the units of the equations, with the
    day-length series of the latitudes and the season mask, come from the
    port (``indices.fire._cffwis._cffwis_inputs``); tests/test_torch_fire.py
    holds those against the JAX package, the mask exactly.

    Returns a report: for each output, ``max_abs_err`` and ``max_rel_err``
    against the replay (``name: (abs, rel)``), and ``replay``, the
    replayed outputs (CPU float64, in the outputs' layout). Raises
    AssertionError for a value beyond the bound or another NaN pattern."""
    from xclim_tpu_torch.indices.fire._cffwis import _cffwis_inputs

    _, ax, args, sm = _cffwis_inputs(tas, pr, sfcWind, hurs, lat, snd,
                                     season_mask, season_method, params)
    run = [torch.movedim(o.data, ax, 0) for o in out]
    dc, dmc, ffmc = cffwis_replay(
        *args, run[:3], season_mask=sm, dc0=dc0, dmc0=dmc0, ffmc0=ffmc0,
        overwintering=overwintering, dry_start=dry_start,
        initial_start_up=initial_start_up, **params)
    # each derived index from the run's own inputs to it, so that FWI's
    # branch at BUI = 80 is taken on the run's BUI
    r64 = [r.detach().to("cpu", torch.float64) for r in run]
    wind = args[3].detach().to("cpu", torch.float64)
    want = (dc, dmc, ffmc, _vw_isi(wind, r64[2]), _vw_bui(r64[1], r64[0]),
            _vw_fwi(r64[3], r64[4]), 0.0272 * r64[5] ** 1.77)
    report = {"replay": tuple(torch.movedim(w, 0, ax) for w in want)}
    for o, g, w in zip(out, r64, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"cffwis {o.name}: NaN patterns differ from "
                                 f"the float64 replay")
        ok = ~torch.isnan(w)
        err = (g - w).abs()[ok]
        if not err.numel():
            report[o.name] = (0.0, 0.0)
            continue
        scale = float(w[ok].abs().max())
        bound = CFFWIS_RTOL * w[ok].abs() + CFFWIS_SCALE_TOL * scale + (
            CFFWIS_FWI_ATOL if o.name == "fwi" else 0.0)
        report[o.name] = (float(err.max()),
                          float((err / w[ok].abs().clamp(min=1e-12)).max()))
        if bool((err > bound).any()):
            raise AssertionError(
                f"cffwis {o.name}: {int((err > bound).sum())} values beyond "
                f"rtol {CFFWIS_RTOL} + {CFFWIS_SCALE_TOL} of the scale "
                f"{scale:.6g} of the float64 replay, max abs err "
                f"{float(err.max()):.3g}")
    return report
