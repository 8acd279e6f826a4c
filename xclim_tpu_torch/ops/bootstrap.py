"""Year-replacement quantiles for the Zhang-2005 bootstrap, as plain torch.

The bootstrap recomputes each doy-window quantile with one in-base year's
samples replaced by another's, for every ordered year pair; xclim re-sorts
the full sample set per pair (xclim:core/bootstrapping.py:195-201). Here the
samples are ranked once into top-k / bottom-k candidate tables
(:func:`topk_rank_tables`), and each pair's order statistics are recovered
from the table with year b's entries removed, merged with the added year's
samples (:func:`merge_rank_replaced_year_quantile`): no per-pair sort.

Counterpart of the reference's ``xclim_tpu/ops/bootstrap.py``. Its public
bootstrap calls ``topk_replaced_year_quantile`` (a top_k of the table and
the added samples per pair); ``merge_rank_replaced_year_quantile`` gives the
same answer bit for bit (tests/test_ops.py), so the port serves both with
the merge form. NaNs (missing samples at series edges, absent leap days)
are excluded from every count.
"""

from __future__ import annotations

import math

import torch

__all__ = ["topk_rank_tables", "merge_rank_replaced_year_quantile",
           "topk_capacity"]


def topk_rank_tables(flat: torch.Tensor, year_id, k: int):
    """Top-k / bottom-k candidate tables for the year-replacement bootstrap
    (lanes-last layout).

    flat: (..., N, C) samples, NaN = missing; year_id: (N,) int year of each
    sample. Returns (topv, topyear, botv, botyear, nvalid): topv/botv are
    the k largest/smallest values per lane in descending/ascending order,
    shaped (..., C, k) (-inf/+inf where a lane has fewer than k valid
    values), topyear/botyear the year of each, nvalid (..., C) int32.
    """
    nan = torch.isnan(flat)
    lanes = flat.movedim(-2, -1)
    nanl = nan.movedim(-2, -1)
    topv, topi = torch.topk(torch.where(nanl, -torch.inf, lanes), k, dim=-1,
                            largest=True, sorted=True)
    botv, boti = torch.topk(torch.where(nanl, torch.inf, lanes), k, dim=-1,
                            largest=False, sorted=True)
    yid = torch.as_tensor(year_id, dtype=torch.int32, device=flat.device)
    nvalid = (~nan).sum(dim=-2, dtype=torch.int32)
    return topv, yid[topi], botv, yid[boti], nvalid


def _kept_table(table: torch.Tensor, tyear: torch.Tensor, b) -> torch.Tensor:
    """The table (descending) without year b's entries and without the
    infinite padding, compacted to the front and padded with -inf."""
    drop = ((tyear == b) | torch.isinf(table)).to(torch.int32)
    k = table.shape[-1]
    # the exclusive count of dropped entries before each slot; scanned over
    # the leading axis, which torch's scan serves far faster than a short
    # innermost one
    before = torch.cumsum(drop.movedim(-1, 0), dim=0,
                          dtype=torch.int32).movedim(0, -1) - drop
    pos = torch.arange(k, device=table.device) - before
    pos = torch.where(drop.bool(), k, pos).to(torch.int64)   # dropped -> spare slot
    out = torch.full(table.shape[:-1] + (k + 1,), -torch.inf,
                     dtype=table.dtype, device=table.device)
    return out.scatter(-1, pos, table)[..., :k]


def _merged(kept: torch.Tensor, added: torch.Tensor, j: torch.Tensor):
    """The j-th largest (0-based) of the union of ``kept`` (..., C, k) and
    ``added`` (..., C, w), both descending with -inf padding: the max over
    the splits t of min(kept[j - t], added[t - 1]) (the merge path: the top
    j+1 of the union are the top j+1-t of one list and the top t of the
    other for exactly one t). -inf where the union has no j-th element."""
    k, w = kept.shape[-1], added.shape[-1]
    t = torch.arange(w + 1, device=kept.device)
    idx = j.to(torch.int64)[..., None] - t                 # (..., C, w+1)
    shape = idx.shape[:-1] + (k,)
    xk = kept.expand(shape).gather(-1, idx.clamp(0, k - 1))
    xk = torch.where(idx < 0, torch.inf, torch.where(idx >= k, -torch.inf, xk))
    # t = 0 takes no added sample: its candidate is kept[j] itself
    return torch.maximum(xk[..., 0],
                         torch.minimum(xk[..., 1:], added).amax(dim=-1))


def _sort_desc(a: torch.Tensor) -> torch.Tensor:
    """``a`` (NaN-free) sorted descending along its last axis by an odd-even
    transposition network: w rounds of elementwise max/min (10 compare-
    exchanges for the usual 5-day window), far cheaper than a sort kernel
    over millions of w-element rows."""
    v = list(a.unbind(-1))
    w = len(v)
    for r in range(w):
        for i in range(r % 2, w - 1, 2):
            v[i], v[i + 1] = (torch.maximum(v[i], v[i + 1]),
                              torch.minimum(v[i], v[i + 1]))
    return torch.stack(v, dim=-1)


def merge_rank_replaced_year_quantile(topv, topyear, botv, botyear, nvalid,
                                      A_b, A_o, b, q: float,
                                      alpha: float = 1 / 3,
                                      beta: float = 1 / 3) -> torch.Tensor:
    """Quantile of the year-b-replaced multiset from the candidate tables.

    topv/topyear/botv/botyear/nvalid from :func:`topk_rank_tables` (they
    broadcast against the replacements: a leading replacement axis needs no
    copy of them); A_b, A_o: (..., C, w) removed/added samples, lanes-last;
    b: the removed year's index. Hyndman-Fan (alpha, beta) semantics of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`, with the reference's
    float32 op sequence: ``h = n*q + (q*(1-a-b)+a) - 1`` clipped to [0,
    n-1], and ``v0 + g*(v1 - v0)``.

    The needed order statistics of the modified multiset sit within
    ``(1-q)*n + 2`` ranks of the top (``q*n + 2`` of the bottom for q < 0.5);
    replacing one year removes at most w samples, so they lie in (table
    minus year b) + A_o when ``k >= J + w`` (:func:`topk_capacity`). The
    reference ranks that merge with a (k x w) comparison matrix; here the
    table minus year b is compacted once and the j-th element of the merge
    is read by the merge path, which picks the same element.
    """
    vb = (~torch.isnan(A_b)).sum(dim=-1, dtype=torch.int32)
    vo = (~torch.isnan(A_o)).sum(dim=-1, dtype=torch.int32)
    nmod_i = nvalid - vb + vo
    nmod = nmod_i.to(torch.float32)

    h = nmod * q + (q * (1 - alpha - beta) + alpha) - 1.0
    h = torch.minimum(torch.clamp(h, min=0.0), torch.clamp(nmod - 1.0, min=0.0))
    k0 = torch.floor(h).to(torch.int32)
    gam = h - k0.to(torch.float32)
    k1 = torch.minimum(k0 + 1, torch.clamp(nmod_i - 1, min=0))

    if q >= 0.5:
        sign, table, tyear = 1.0, topv, topyear
        j0, j1 = nmod_i - 1 - k0, nmod_i - 1 - k1
    else:
        # the bottom table ascending is the negated values descending
        sign, table, tyear = -1.0, -botv, botyear
        j0, j1 = k0, k1
    kept = _kept_table(table, tyear, b)
    added = _sort_desc(torch.where(torch.isnan(A_o) | torch.isinf(A_o),
                                   -torch.inf, sign * A_o))
    m0 = _merged(kept, added, j0.clamp(min=0))
    m1 = _merged(kept, added, j1.clamp(min=0))
    v0, v1 = sign * m0, sign * m1
    out = v0 + gam * (v1 - v0)
    out = torch.where(nmod_i <= 0, torch.nan, out)
    hit = (m0 > -torch.inf) & (m1 > -torch.inf)
    return torch.where(hit, out, torch.nan)


def topk_capacity(nmax: int, w: int, q: float) -> int:
    """Candidate-table size k that makes the table route exact for samples
    of at most `nmax` valid values, `w`-sample replacements and quantile
    `q`."""
    tail = (1 - q) if q >= 0.5 else q
    return int(math.ceil(tail * nmax)) + 2 + w
