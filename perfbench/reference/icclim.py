"""Plain reference of the ECA&D indices over tas, tasmax, tasmin and pr (the
ECA&D Algorithm Theoretical Basis Document v10.7, Klein Tank et al. 2009,
WMO-TD 1500; icclim; xclim's ``indicators.icclim``), every index at
``freq="YS"`` and TG again at ``"MS"``.

With the years and months of a noleap calendar from 1 January, per period
and cell:

- TG, TX, TN: the mean of tas, tasmax, tasmin; TXx, TXn, TNx, TNn: the
  largest and smallest tasmax and tasmin; TG_MS: the monthly mean of tas.
- DTR: the mean of tasmax - tasmin; ETR: the largest tasmax less the
  smallest tasmin; vDTR: the mean of |DTR(d) - DTR(d - 1)|, each day's
  difference with the day before it (the series' first day has none, so
  the first year has 364).
- SU: days with tasmax > 25 degC; TR: tasmin > 20 degC; FD: tasmin < 0
  degC; ID: tasmax < 0 degC. CSU, CFD: the longest run of SU days and of
  FD days.
- GD4: the sum of tas - 4 degC over the days above it; HD17: the sum of
  17 degC - tas over the days below it (K days).
- GSL: the days from the first day of the first run of 6 days with tas >=
  5 degC that starts before 1 July, to the first day of the first run of 6
  days with tas < 5 degC that starts on or after 1 July; to the year's end
  where no such run follows; 0 where no season starts.
- pr in mm/day is pr x 86400 (kg m-2 s-1, water of 1000 kg m-3); a day's
  amount in mm is that rate over one day. RR: the sum of the amounts;
  RR1, R10mm, R20mm: days with pr >= 1, 10, 20 mm/day; SDII: the sum of
  the amounts of the days with pr >= 1 mm/day over their count (NaN where
  there is none); PRCPTOT: that sum; CDD: the longest run of days with pr
  < 1 mm/day; CWD: with pr >= 1 mm/day; RX1day: the largest pr (mm/day);
  RX5day: the largest sum of 5 days' amounts, each window counted to the
  year of its last day (so a window may start in the year before; the
  series' first 4 days end no window).

A run never crosses the end of its year.

Where this follows xclim (and the port) and not the ATBD's wording:

- GSL's start compares tas >= 5 degC (the ATBD: > 5 degC), and its start
  run must lie wholly before 6 July (begin before 1 July); its end run may
  not start before 1 July (xclim's ``mid_date``);
- RR sums only days with pr >= 0 (xclim's ``prcptot`` with its 0 mm/d
  threshold);
- CSU, CFD, CDD and CWD count runs within the year (xclim's
  ``resample_before_rl``), the ATBD over the whole series.

A count, a run length, GSL, SDII and PRCPTOT are step functions of a
threshold, so a threshold one rounding away from the reference's moves a
day across it. They are given as the interval that thresholds within a
tolerance allow (``check.thresh_tol_K``, and ``check.pr_tol_rel`` of each
precipitation threshold): the low end from the threshold moved to admit
fewer days, the high end from the one that admits more. Each grows with
the set of days admitted, and GSL too (a smaller set starts the season no
earlier and ends it no later); SDII does not, and takes the smaller and
the larger of its two values.

Inputs are ``(days, cells)`` tensors of whole noleap years from 1 January,
held in ``dtype`` (the data's precision: float32 as the configuration
states, bfloat16 in the control); all arithmetic is in float64. Outputs
are ``(rows, cells)``: a row a year, or a month for TG_MS, and the
intervals as their (2, rows, cells) ends.
"""

from __future__ import annotations

import torch

#: the outputs, in the order of the suite's calls
NAMES = ("TG", "TX", "TN", "TXx", "TXn", "TNx", "TNn", "DTR", "ETR", "vDTR",
         "SU", "TR", "FD", "ID", "CSU", "CFD", "GD4", "HD17", "GSL", "RR",
         "RR1", "SDII", "CDD", "CWD", "R10mm", "R20mm", "RX1day", "RX5day",
         "PRCPTOT", "TG_MS")
COUNTS = ("SU", "TR", "FD", "ID", "RR1", "R10mm", "R20mm")
SPELLS = ("CSU", "CFD", "CDD", "CWD")
UNITS = {**{k: "K" for k in NAMES[:10]}, "TG_MS": "K",
         **{k: "days" for k in COUNTS + SPELLS + ("GSL",)},
         "GD4": "K_days", "HD17": "K_days", "RR": "mm", "PRCPTOT": "mm",
         "RX5day": "mm", "RX1day": "mm_per_day", "SDII": "mm_per_day"}
#: outputs given as the (2, ...) ends of the values allowed
INTERVALS = COUNTS + SPELLS + ("GSL", "SDII", "PRCPTOT")
#: 0 degC in K, and a noleap year's month lengths
ZERO_C = 273.15
MONTHS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
#: day of the year (0-based) of 1 July in a noleap year
JULY_1 = 181


def _years(x: torch.Tensor) -> torch.Tensor:
    """(days, cells) as (years, 365, cells)."""
    return x.reshape(x.shape[0] // 365, 365, x.shape[1])


def _ends(x: torch.Tensor, op: str, thr: float, tol: float):
    """(fewer, more): the days of ``x op thr`` with ``thr`` moved by ``tol``
    to admit fewer days, and to admit more."""
    if op in (">", ">="):
        cmp = torch.gt if op == ">" else torch.ge
        return cmp(x, thr + tol), cmp(x, thr - tol)
    cmp = torch.lt if op == "<" else torch.le
    return cmp(x, thr - tol), cmp(x, thr + tol)


def longest_run(cond: torch.Tensor) -> torch.Tensor:
    """The longest run of True along axis 1 of (years, days, cells)."""
    return run_from_start(cond).amax(dim=1).double()


def run_from_start(cond: torch.Tensor) -> torch.Tensor:
    """Along axis 1, the length of the run of True that ends at each day
    (0 where the day is False), from the last False day before it."""
    L = cond.shape[1]
    idx = torch.arange(L, device=cond.device).reshape(1, L, 1)
    last_false = torch.cummax(torch.where(cond, -1, idx), dim=1).values
    return torch.where(cond, idx - last_false, 0)


def first_run(cond: torch.Tensor, window: int) -> torch.Tensor:
    """The first day (axis 1) that begins a run of at least ``window`` True
    days within the year; the year's length where none does."""
    ahead = run_from_start(cond.flip(1)).flip(1)   # the run from each day on
    L = cond.shape[1]
    idx = torch.arange(L, device=cond.device).reshape(1, L, 1)
    return torch.where(ahead >= window, idx, L).amin(dim=1)


def growing_season(warm: torch.Tensor, window: int = 6) -> torch.Tensor:
    """GSL from ``warm`` (years, 365, cells): tas >= 5 degC."""
    L = warm.shape[1]
    idx = torch.arange(L, device=warm.device).reshape(1, L, 1)
    start = first_run(warm & (idx < JULY_1 + window - 1), window)
    end = first_run(~warm & (idx >= JULY_1), window)
    length = torch.where(end < L, end - start, L - start)
    return torch.where(start < L, length, 0).double()


def _interval(fn, pair):
    return torch.stack([fn(pair[0]), fn(pair[1])])


def reference(inputs: dict, config: dict, mix: dict,
              dtype=torch.float32) -> dict:
    """The 30 outputs of :data:`NAMES` from the cells' four series."""
    chk = config["check"]
    tol_k, rel = chk["thresh_tol_K"], chk["pr_tol_rel"]
    tas, tx, tn, pr = (inputs[k].to(dtype).double()
                       for k in ("tas", "tasmax", "tasmin", "pr"))
    pr = pr * 86400.0                                   # mm/day
    tas_y, tx_y, tn_y, pr_y = (_years(v) for v in (tas, tx, tn, pr))
    Y, C = tas_y.shape[0], tas.shape[1]
    out = {"TG": tas_y.mean(1), "TX": tx_y.mean(1), "TN": tn_y.mean(1),
           "TXx": tx_y.amax(1), "TXn": tx_y.amin(1),
           "TNx": tn_y.amax(1), "TNn": tn_y.amin(1)}
    dtr = tx - tn
    out["DTR"] = _years(dtr).mean(1)
    out["ETR"] = out["TXx"] - out["TNn"]
    step = torch.cat([torch.full_like(dtr[:1], torch.nan),
                      (dtr[1:] - dtr[:-1]).abs()])
    out["vDTR"] = _years(step).nanmean(1)

    def temp(x, op, c):
        return _ends(x, op, ZERO_C + c, tol_k)

    def wet(op, mm):
        return _ends(pr_y, op, mm, mm * rel)

    conds = {"SU": temp(tx_y, ">", 25.0), "TR": temp(tn_y, ">", 20.0),
             "FD": temp(tn_y, "<", 0.0), "ID": temp(tx_y, "<", 0.0),
             "RR1": wet(">=", 1.0), "R10mm": wet(">=", 10.0),
             "R20mm": wet(">=", 20.0)}
    for k, pair in conds.items():
        out[k] = _interval(lambda c: c.sum(1).double(), pair)
    spells = {"CSU": conds["SU"], "CFD": conds["FD"],
              "CDD": wet("<", 1.0), "CWD": conds["RR1"]}
    for k, pair in spells.items():
        out[k] = _interval(longest_run, pair)
    out["GD4"] = (tas_y - (ZERO_C + 4.0)).clamp(min=0).sum(1)
    out["HD17"] = ((ZERO_C + 17.0) - tas_y).clamp(min=0).sum(1)
    out["GSL"] = _interval(growing_season, temp(tas_y, ">=", 5.0))
    out["RR"] = torch.where(pr_y >= 0, pr_y, 0.0).sum(1)
    wet_days = conds["RR1"]
    totals = _interval(lambda c: torch.where(c, pr_y, 0.0).sum(1), wet_days)
    sdii = totals / out["RR1"]
    out["SDII"] = torch.stack([sdii.amin(0), sdii.amax(0)])
    out["PRCPTOT"] = totals
    out["RX1day"] = pr_y.amax(1)
    win = pr.unfold(0, 5, 1).sum(-1)                    # ends on day 4 on
    win = torch.cat([torch.full_like(pr[:4], torch.nan), win])
    out["RX5day"] = _years(win).nan_to_num(nan=-torch.inf).amax(1)
    months = torch.split(tas_y, list(MONTHS), dim=1)
    out["TG_MS"] = torch.stack([m.mean(1) for m in months], 1).reshape(
        Y * 12, C)
    return {k: out[k] for k in NAMES}
