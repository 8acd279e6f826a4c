"""Hyndman & Fan sample quantiles by a plain sort (Hyndman and Fan 1996,
Am. Stat. 50(4), definitions 7 and 8 as numpy and xclim parameterise them
by alpha and beta). NaN marks a missing sample."""

from __future__ import annotations

import torch


def quantiles(x: torch.Tensor, q, alpha: float, beta: float) -> torch.Tensor:
    """Quantiles of the last axis of ``x`` at each node of ``q``: shape
    ``x.shape[:-1] + (len(q),)``, in ``x``'s dtype.

    With n valid samples sorted as v, the node's virtual index is
    ``h = n q + alpha + q (1 - alpha - beta) - 1``, held to [0, n - 1], and
    the quantile is ``v[floor h] (1 - g) + v[floor h + 1] g`` with g the
    fraction of h. No valid sample gives NaN. The index arithmetic is
    exact (float64 on whole counts); the values keep ``x``'s precision.
    """
    q = torch.as_tensor(q, dtype=torch.float64, device=x.device)
    v = torch.sort(x, dim=-1).values           # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=-1, keepdim=True).to(torch.float64)
    h = n * q + alpha + q * (1.0 - alpha - beta) - 1.0
    h = torch.minimum(h.clamp(min=0.0), (n - 1.0).clamp(min=0.0))
    lo = torch.floor(h)
    g = (h - lo).to(x.dtype)
    hi = torch.minimum(lo + 1.0, (n - 1.0).clamp(min=0.0))
    v0 = v.gather(-1, lo.to(torch.int64))
    v1 = v.gather(-1, hi.to(torch.int64))
    out = v0 * (1 - g) + v1 * g
    return torch.where(n == 0, torch.nan, out)
