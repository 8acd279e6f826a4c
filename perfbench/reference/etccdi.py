"""Plain reference of the ETCCDI TX90p and WSDI with Zhang et al.'s in-base
bootstrap (Zhang et al. 2005, J. Climate 18, 1641-1651; Zhang et al. 2011,
WIREs Clim. Change 2, 851-870; xclim's ``percentile_doy``, ``tx90p`` and
``warm_spell_duration_index`` with ``freq="YS"``).

The threshold of day of the year d is the Hyndman-Fan type 8 quantile
(alpha = beta = 1/3) of the ``window`` days centred on d in every base
year, taken along the time axis of the base period (so the days before its
first and after its last day are missing). TX90p counts a year's days with
tasmax above its day's threshold; WSDI counts a year's days that lie in
runs of at least ``spell`` such days within the year. With the bootstrap,
each base year b is counted against the thresholds of the base with b's
samples replaced by those of each other base year in turn, and gets the
mean of those counts; the years outside the base keep the plain threshold.

A count is a step function of its thresholds, so a threshold one rounding
away from the reference's moves a day across it, and a WSDI by a whole
spell. The counts are therefore given as the interval that thresholds
within ``tol`` of the reference's allow (``tol`` is the limit of the
thresholds' own comparison): the low end counts the days above threshold
+ tol, the high end those above threshold - tol. Both indices only grow
as days are added to the set above the threshold, so every count from
thresholds within ``tol`` lies between the two ends.

Inputs are ``(days, cells)`` tensors of whole noleap years from 1 January;
outputs are ``(rows, cells)``: ``per`` (365, cells), and ``tx90p`` and
``wsdi`` as their (2, years, cells) interval ends. Thresholds and
comparisons are in ``dtype``.
"""

from __future__ import annotations

import torch

from perfbench.reference.hyndman_fan import quantiles

UNITS = {"per": "K", "tx90p": "days", "wsdi": "days"}
#: outputs given as the (2, ...) ends of the values allowed
INTERVALS = ("tx90p", "wsdi")


def base_samples(x: torch.Tensor, first: int, years: int,
                 window: int) -> torch.Tensor:
    """(365, cells, years, window): the samples of each doy, year by year;
    NaN outside the base period."""
    half = window // 2
    base = x[first * 365:(first + years) * 365]
    t = (torch.arange(years, device=x.device)[None, :, None] * 365
         + torch.arange(365, device=x.device)[:, None, None]
         + torch.arange(-half, half + 1, device=x.device)[None, None, :])
    ok = (t >= 0) & (t < base.shape[0])
    s = base[t.clamp(0, base.shape[0] - 1)]           # (365, years, w, cells)
    s = torch.where(ok[..., None], s, torch.nan)
    return s.permute(0, 3, 1, 2)


def spell_days(above: torch.Tensor, spell: int) -> torch.Tensor:
    """Days in runs of at least ``spell`` True values along axis -2."""
    L = above.shape[-2]
    idx = torch.arange(L, device=above.device).reshape(L, 1)
    last_false = torch.cummax(torch.where(above, -1, idx), dim=-2).values
    next_false = torch.flip(torch.cummin(torch.flip(
        torch.where(above, L, idx), dims=(-2,)), dim=-2).values, dims=(-2,))
    length = next_false - last_false - 1
    return (above & (length >= spell)).sum(dim=-2)


def counts(x: torch.Tensor, thr: torch.Tensor, tol: float, spell: int):
    """(TX90p, WSDI) interval ends, each (2, ..., cells): days of ``x``
    (..., 365, cells) above ``thr`` (..., 365, cells) + tol, and above
    ``thr`` - tol."""
    tx, ws = [], []
    for above in (x > thr + tol, x > thr - tol):
        tx.append(above.sum(dim=-2).to(torch.float64))
        ws.append(spell_days(above, spell).to(torch.float64))
    return torch.stack(tx), torch.stack(ws)


def reference(inputs: dict, config: dict, mix: dict,
              dtype=torch.float32) -> dict:
    """{"per", "tx90p", "wsdi"} from the cells' tasmax."""
    m = config["method"]
    tol = config["limits"]["per_max_abs_K"]
    x = inputs["tasmax"].to(dtype)
    Y = x.shape[0] // 365
    first = m["base_years"][0] - config["data"]["start_year"]
    nb = m["base_years"][1] - m["base_years"][0] + 1
    q = [m["per"] / 100.0]
    a = b = 1.0 / 3.0
    s = base_samples(x, first, nb, m["window"])          # (365, C, nb, w)
    C = s.shape[1]
    per = quantiles(s.reshape(365, C, -1), q, a, b)[..., 0]   # (365, C)
    xy = x.reshape(Y, 365, C)
    tx, wsdi = counts(xy, per, tol, m["spell"])          # (2, Y, C)
    if mix.get("bootstrap"):
        for yb in range(nb):
            keep = torch.cat([s[:, :, :yb], s[:, :, yb + 1:]], dim=2)
            others = keep.permute(2, 0, 1, 3)           # (nb-1, 365, C, w)
            keep = keep.reshape(365, C, -1)
            repl = torch.cat([keep.expand(nb - 1, -1, -1, -1), others],
                             dim=-1)                    # (nb-1, 365, C, n)
            per_o = quantiles(repl, q, a, b)[..., 0]    # (nb-1, 365, C)
            t_o, w_o = counts(xy[first + yb], per_o, tol, m["spell"])
            tx[:, first + yb] = t_o.mean(dim=1)
            wsdi[:, first + yb] = w_o.mean(dim=1)
    return {"per": per, "tx90p": tx, "wsdi": wsdi}
