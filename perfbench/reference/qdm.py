"""Plain reference of quantile delta mapping with day-of-year windows
(Cannon et al. 2015, J. Climate 28, 6938-6959; xsdba's
``QuantileDeltaMapping`` with ``group=Grouper("time.dayofyear", window)``).

Training takes, for each day of the year d, the samples of the days of the
year d - window//2 .. d + window//2 (wrapped around the year) of every
year, and their Hyndman-Fan type 7 quantiles at xsdba's
``equally_spaced_nodes(nquantiles)`` (with the 1e-4 and 1 - 1e-4 end
nodes); the adjustment factors are ref's quantiles less hist's (``kind
"+"``, or their ratio for ``"*"``). Adjusting gives each value of sim its
empirical rank among the values of its own day of the year, #(group <= v)
/ n, takes the factor at that rank by linear interpolation between the
nodes (held to the end nodes), and adds it (or multiplies by it).

Inputs are ``(days, cells)`` tensors of whole noleap years from 1 January;
outputs are ``(rows, cells)``: ``af`` and ``hist_q`` as (doy x node,
cells), ``scen`` as (days, cells). Everything is computed in ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.hyndman_fan import quantiles

#: the unit of each output, for the names of the numbers compared
UNITS = {"af": "K", "hist_q": "K", "scen": "K"}
#: doys whose window samples are sorted together
DOY_BLOCK = 73


def nodes(n: int, eps: float = 1e-4) -> np.ndarray:
    """n equally spaced nodes in (0, 1) and the two end nodes, float32."""
    dq = 1.0 / n / 2.0
    q = np.linspace(dq, 1.0 - dq, n)
    return np.concatenate([[eps], q, [1.0 - eps]]).astype(np.float32)


def window_quantiles(x: torch.Tensor, window: int, q) -> torch.Tensor:
    """(365, len(q), cells) type 7 quantiles of each wrapped doy window."""
    Y = x.shape[0] // 365
    xs = x.reshape(Y, 365, -1).permute(1, 2, 0)          # (365, cells, Y)
    half = window // 2
    out = []
    for d0 in range(0, 365, DOY_BLOCK):
        d = torch.arange(d0, min(d0 + DOY_BLOCK, 365), device=x.device)
        rows = (d[:, None] + torch.arange(-half, half + 1,
                                          device=x.device)) % 365
        s = xs[rows]                                      # (b, w, cells, Y)
        s = s.permute(0, 2, 1, 3).reshape(len(d), xs.shape[1], -1)
        out.append(quantiles(s, q.astype(np.float64), 1.0, 1.0))  # (b, cells, nq)
    return torch.cat(out).permute(0, 2, 1)


def adjust(sim: torch.Tensor, af: torch.Tensor, q, kind: str) -> torch.Tensor:
    """sim (days, cells) adjusted by af (365, nq, cells) at each value's
    rank within its day of the year."""
    Y = sim.shape[0] // 365
    xs = sim.reshape(Y, 365, -1).permute(1, 0, 2)         # (365, Y, cells)
    ok = ~torch.isnan(xs)
    cnt = (xs[:, None, :, :] <= xs[:, :, None, :]).sum(dim=2)  # (365, Y, c)
    n = ok.sum(dim=1, keepdim=True).clamp(min=1)
    tau = cnt.to(sim.dtype) / n.to(sim.dtype)
    qt = torch.as_tensor(q, device=sim.device).to(sim.dtype)
    tc = torch.minimum(torch.maximum(tau, qt[0]), qt[-1])
    hi = torch.zeros(tc.shape, dtype=torch.int64, device=sim.device)
    for k in range(len(qt)):
        hi += qt[k] <= tc
    hi = hi.clamp(1, len(qt) - 1)
    lo = hi - 1
    w = ((tc - qt[lo]) / (qt[hi] - qt[lo])).clamp(0.0, 1.0)
    y0, y1 = af.gather(1, lo), af.gather(1, hi)
    factor = y0 + w * (y1 - y0)
    out = xs + factor if kind == "+" else xs * factor
    out = torch.where(ok, out, torch.nan)
    return out.permute(1, 0, 2).reshape(sim.shape)


def reference(inputs: dict, config: dict, mix: dict,
              dtype=torch.float32) -> dict:
    """{"af", "hist_q", "scen"} from the cells' ref, hist and sim."""
    m = config["method"]
    x = {k: v.to(dtype) for k, v in inputs.items()}
    q = nodes(m["nquantiles"])
    ref_q = window_quantiles(x["ref"], m["window"], q)
    hist_q = window_quantiles(x["hist"], m["window"], q)
    af = ref_q - hist_q if m["kind"] == "+" else ref_q / hist_q
    scen = adjust(x["sim"], af, q, m["kind"])
    C = scen.shape[-1]
    return {"af": af.reshape(-1, C), "hist_q": hist_q.reshape(-1, C),
            "scen": scen}
