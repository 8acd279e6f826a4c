"""McArthur Forest Fire Danger Index (Mark 5)
(reference: xclim:src/xclim/indices/fire/_ffdi.py).

KBDI is a recurrence over days: a Python loop over time whose carry stays
on the device, with the terms that do not read the carry computed for the
whole series first. The Griffiths drought factor's 20-day window analysis
runs as 20 passes over all days at once, each reading a shifted view of
the zero-padded precipitation.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, declare_units, str2pint
from xclim_tpu_torch.indices.fire._cffwis import _state

__all__ = [
    "griffiths_drought_factor",
    "keetch_byram_drought_index",
    "mcarthur_forest_fire_danger_index",
]


def _kbdi_scan(p, t, pa, kbdi0):
    """KBDI recurrence (Finkele et al. 2006; xclim:_ffdi.py:38-88).

    p, t: (T, ...); pa: (...) annual precip; kbdi0: (...) initial KBDI.
    """
    dry = p <= 0.0
    # the evapotranspiration factor of the day's temperature and of pa
    # (everything of et but 1e-3 * (203.2 - kbdi))
    heat = 0.968 * torch.exp(0.0875 * t + 1.5552) - 8.3
    damp = 1 + 10.88 * torch.exp(-0.00173 * pa)
    out = torch.empty_like(p)
    kbdi, rr = kbdi0, torch.full_like(kbdi0, 5.0)
    for i in range(p.shape[0]):
        prcp = p[i]
        runoff = torch.where(dry[i], prcp, torch.minimum(prcp, rr))
        rr = torch.where(dry[i], 5.0, rr - runoff)
        peff = prcp - runoff
        et = 1e-3 * (203.2 - kbdi) * heat[i] / damp
        kbdi = torch.clamp(kbdi + et - peff, 0.0, 203.2, out=out[i])
    return out


def _griffiths_df(p, smd, limiting_func: int):
    """Griffiths drought factor (xclim:_ffdi.py:92-166).

    p, smd: (T, ...). Day d's 20-day window is p[d - 19 .. d], zero before
    the series starts; its iw-th value for every day at once is a shifted
    view of p padded with 19 leading zeros. The event analysis is then a
    20-iteration loop of whole-series ops.
    """
    wl = 20
    T = p.shape[0]
    padded = torch.cat([torch.zeros_like(p[:1]).expand(
        (wl - 1,) + p.shape[1:]), p])

    conseq = torch.zeros_like(p)
    P = torch.zeros_like(p)
    pmax = torch.zeros_like(p)
    N = torch.zeros_like(p)
    x = torch.ones_like(p)

    for iw in range(wl):
        pi = padded[iw:iw + T]
        event = pi > 2.0
        event_end = ~event & (conseq != 0)
        conseq = torch.where(event, conseq + 1, conseq)
        P_new = torch.where(event, P + pi, P)
        peak = event & (pi >= pmax)
        N = torch.where(peak, float(wl - iw), N)
        pmax = torch.where(peak, pi, pmax)
        P = P_new
        # an event still open on the window's last day closes there
        close = event_end | event if iw == wl - 1 else event_end
        x_ = N ** 1.3 / (N ** 1.3 + P - 2.0)
        x = torch.where(close, torch.minimum(x_, x), x)
        conseq = torch.where(close, 0.0, conseq)
        P = torch.where(close, 0.0, P)
        pmax = torch.where(close, 0.0, pmax)

    if limiting_func == 0:  # "xlim" (Eq. 14)
        xlim = torch.where(smd < 20, 1 / (1 + 0.1135 * smd),
                           75 / (270.525 - 1.267 * smd))
        x = torch.minimum(x, xlim)
    dfw = (10.5 * (1 - torch.exp(-(smd + 30) / 40))
           * (41 * x ** 2 + x) / (40 * x ** 2 + x + 1))
    if limiting_func == 1:  # "discrete" (Eq. 13)
        dflim = torch.where(smd < 25, 6.0,
                            torch.where(smd < 42, 7.0,
                                        torch.where(smd < 65, 8.0,
                                                    torch.where(smd < 100, 9.0, 10.0))))
        dfw = torch.minimum(dfw, dflim)
    dfw = torch.clamp(dfw, max=10.0)
    # the first wl-1 days lack a full window
    dfw[:wl - 1] = torch.nan
    return dfw


@declare_units(pr="[precipitation]", tasmax="[temperature]",
               pr_annual="[precipitation]", kbdi0="[precipitation]")
def keetch_byram_drought_index(pr: ClimArray, tasmax: ClimArray, pr_annual,
                               kbdi0: ClimArray | None = None) -> ClimArray:
    """Keetch-Byram drought index [mm] (xclim:_ffdi.py:188)."""
    p = convert_units_to(pr, "mm/d", context="hydro")
    t = convert_units_to(tasmax, "degC")
    ax = p.time_axis
    pd_ = torch.movedim(p.data, ax, 0)
    td = torch.movedim(t.data, ax, 0)
    pa = convert_units_to(str2pint(pr_annual), "mm/yr") if isinstance(pr_annual, str) \
        else convert_units_to(pr_annual, "mm/yr").data
    pa = torch.as_tensor(pa, dtype=pd_.dtype, device=pd_.device) \
        * torch.ones(pd_.shape[1:], dtype=pd_.dtype, device=pd_.device)
    k0 = torch.zeros(pd_.shape[1:], dtype=pd_.dtype, device=pd_.device) \
        if kbdi0 is None else _state(kbdi0, pd_)
    out = _kbdi_scan(pd_, td, pa, k0)
    res = p.copy(data=torch.movedim(out, 0, ax))
    # the reference's KBDI convention is mm/day (xclim:_ffdi.py:265), so the
    # KBDI -> griffiths smd chain composes without unit friction
    res.attrs = {"units": "mm/day"}
    res.name = "kbdi"
    return res


@declare_units(pr="[precipitation]", smd="[precipitation]")
def griffiths_drought_factor(pr: ClimArray, smd: ClimArray,
                             limiting_func: str = "xlim") -> ClimArray:
    """Griffiths drought factor (xclim:_ffdi.py:273).

    `smd` is the soil-moisture deficit (e.g. KBDI), declared as
    [precipitation] like the reference (its KBDI convention is mm/day)."""
    p = convert_units_to(pr, "mm/d", context="hydro")
    s = convert_units_to(smd, "mm/d", context="hydro")
    lim = {"xlim": 0, "discrete": 1}[limiting_func]
    ax = p.time_axis
    out = _griffiths_df(torch.movedim(p.data, ax, 0),
                        torch.movedim(s.data, ax, 0), lim)
    res = p.copy(data=torch.movedim(out, 0, ax))
    res.attrs = {"units": ""}
    res.name = "df"
    return res


@declare_units(drought_factor="[]", tasmax="[temperature]", hurs="[]",
               sfcWind="[speed]")
def mcarthur_forest_fire_danger_index(drought_factor: ClimArray,
                                      tasmax: ClimArray, hurs: ClimArray,
                                      sfcWind: ClimArray) -> ClimArray:
    """McArthur FFDI Mark 5 (xclim:_ffdi.py:359)."""
    t = convert_units_to(tasmax, "degC")
    h = convert_units_to(hurs, "%")
    w = convert_units_to(sfcWind, "km/h")
    ffdi = drought_factor.data ** 0.987 * torch.exp(
        0.0338 * t.data - 0.0345 * h.data + 0.0234 * w.data + 0.243147)
    out = t.copy(data=ffdi)
    out.attrs = {"units": ""}
    out.name = "ffdi"
    return out
