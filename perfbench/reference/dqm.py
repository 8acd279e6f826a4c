"""Plain reference of detrended quantile mapping with day-of-year windows
(Cannon et al. 2015, J. Climate 28, 6938-6959; xsdba's
``DetrendedQuantileMapping`` with ``group=Grouper("time.dayofyear",
window)``, ``kind="+"`` and ``detrend=1``).

Training:

- the scaling of each day of the year d is the NaN-mean of ref over the
  days of the year d - window//2 .. d + window//2 (wrapped around the year)
  of every year, less the same mean of hist;
- hist is scaled: each value plus its day of the year's scaling;
- ref's and the scaled hist's Hyndman-Fan type 7 quantiles over the same
  windows at xsdba's ``equally_spaced_nodes(nquantiles)`` (with the 1e-4
  and 1 - 1e-4 end nodes) are ``ref_q`` and ``hist_q``, and the adjustment
  factors ``af = ref_q - hist_q``.

Adjustment:

- sim is scaled as hist was;
- a least-squares line is fitted to each cell's scaled series over decimal
  years, centred on their mean and divided by their largest distance from
  it; the fit's sums and its 2 x 2 solve are in float64, and the trend is
  cast back to the values' dtype;
- the series is detrended around the trend's mean: each value less the
  trend less that mean;
- each detrended value takes ``af`` interpolated at its position among its
  own day of the year's ``hist_q`` nodes (linear, held to the end nodes;
  equal bracketing nodes take the lower factor) and adds it;
- the trend less its mean is added back.

Where this follows the port's source, the JAX package
(``xclim_tpu/sdba/adjustment.py`` ``DetrendedQuantileMapping._adjust`` and
``_dqm_adjust_core``), and not xsdba's published ``PolyDetrend(group=...)``:

- one line a cell over the whole series, not one fit a day-of-year group;
- the trend is removed around its own mean a cell (the re-centring), so the
  detrended values keep the level of the trained nodes, and retrending adds
  back the trend less that mean;
- the decimal years are centred and scaled to [-1, 1] before the fit (this
  changes no fitted value, only the fit's conditioning).

Inputs are ``(days, cells)`` tensors of whole noleap years from 1 January,
sim's from the configuration's ``data.start_year["sim"]``; outputs are
``(rows, cells)``: ``scaling`` as (doy, cells), ``af`` and ``hist_q`` as
(doy x node, cells), ``scen`` as (days, cells). Values are computed in
``dtype``; index and time arithmetic in float64.
"""

from __future__ import annotations

import torch

from perfbench.reference.qdm import nodes, window_quantiles

#: the unit of each output, for the names of the numbers compared
UNITS = {"scaling": "K", "af": "K", "hist_q": "K", "scen": "K"}


def window_means(x: torch.Tensor, window: int) -> torch.Tensor:
    """(365, cells) NaN-means of each wrapped doy window of the whole
    years of ``x`` (days, cells), in ``x``'s dtype."""
    Y = x.shape[0] // 365
    xs = x.reshape(Y, 365, -1)
    ok = ~torch.isnan(xs)
    s = torch.where(ok, xs, 0).sum(dim=0)                 # (365, cells)
    n = ok.sum(dim=0)
    half = window // 2
    d = torch.arange(365, device=x.device)
    rows = (d[:, None] + torch.arange(-half, half + 1,
                                      device=x.device)) % 365
    sw, nw = s[rows].sum(dim=1), n[rows].sum(dim=1)
    return torch.where(nw > 0, sw / nw.clamp(min=1).to(x.dtype), torch.nan)


def by_doy(table: torch.Tensor, days: int) -> torch.Tensor:
    """(365, cells) values of a day of the year laid over ``days`` days."""
    return table.repeat(days // 365, 1)


def linear_trend(x: torch.Tensor, start_year: int) -> torch.Tensor:
    """(days, cells) least-squares line of each cell of ``x`` over decimal
    years, centred and scaled; sums and solve in float64, NaN skipped."""
    t = start_year + torch.arange(x.shape[0], dtype=torch.float64,
                                  device=x.device) / 365.0
    t = t - t.mean()
    t = t / t.abs().max()
    ok = ~torch.isnan(x)
    w = ok.to(torch.float64)
    y = torch.where(ok, x, 0).to(torch.float64)
    n, st, stt = w.sum(0), t @ w, (t * t) @ w
    sy, sty = y.sum(0), t @ y
    det = n * stt - st * st
    b = (n * sty - st * sy) / det
    a = (sy - b * st) / n
    return (a + b * t[:, None]).to(x.dtype)


def eqm(x: torch.Tensor, hist_q: torch.Tensor, af: torch.Tensor):
    """x (days, cells) plus ``af`` (365, nq, cells) interpolated at each
    value's place among its day of the year's ``hist_q`` (365, nq, cells)
    nodes: linear, held to the end nodes."""
    Y = x.shape[0] // 365
    C = x.shape[-1]
    v = x.reshape(Y, 365, C).permute(1, 2, 0).contiguous()   # (365, C, Y)
    xq = hist_q.permute(0, 2, 1).contiguous()                 # (365, C, nq)
    yq = af.permute(0, 2, 1).contiguous()
    nq = xq.shape[-1]
    # the nodes ascend, so the count of nodes at or below a value is a
    # search; a missing value is searched as 0 and masked below
    hi = torch.searchsorted(xq, torch.nan_to_num(v, nan=0.0), right=True)
    hi = hi.clamp(1, nq - 1)
    lo = hi - 1
    x0, x1 = xq.gather(-1, lo), xq.gather(-1, hi)
    y0, y1 = yq.gather(-1, lo), yq.gather(-1, hi)
    span = x1 - x0
    w = torch.where(span != 0, (v - x0) / torch.where(span == 0, 1, span), 0)
    w = w.clamp(0.0, 1.0)
    out = v + (y0 + w * (y1 - y0))
    out = torch.where(torch.isnan(v), torch.nan, out)
    return out.permute(2, 0, 1).reshape(x.shape)


def reference(inputs: dict, config: dict, mix: dict,
              dtype=torch.float32) -> dict:
    """{"scaling", "af", "hist_q", "scen"} from the cells' ref, hist and
    sim (sim as the program was given it: with its trend)."""
    m = config["method"]
    if m["kind"] != "+":
        raise ValueError("the reference implements kind '+' only")
    x = {k: v.to(dtype) for k, v in inputs.items()}
    T = x["sim"].shape[0]
    q = nodes(m["nquantiles"])
    scaling = window_means(x["ref"], m["window"]) \
        - window_means(x["hist"], m["window"])
    hist_sc = x["hist"] + by_doy(scaling, x["hist"].shape[0])
    ref_q = window_quantiles(x["ref"], m["window"], q)
    hist_q = window_quantiles(hist_sc, m["window"], q)
    af = ref_q - hist_q
    sim_sc = x["sim"] + by_doy(scaling, T)
    trend = linear_trend(sim_sc, config["data"]["start_year"]["sim"])
    d = (trend.double() - trend.double().nanmean(dim=0)).to(dtype)
    scen = eqm(sim_sc - d, hist_q, af) + d
    C = scen.shape[-1]
    return {"scaling": scaling, "af": af.reshape(-1, C),
            "hist_q": hist_q.reshape(-1, C), "scen": scen}
