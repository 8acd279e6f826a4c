"""Plain reference of ensemble percentiles and t-test robustness fractions
(xclim's ``ensembles.ensemble_percentiles(ens, values)`` and
``ensembles.robustness_fractions(fut, ref, test="ttest")``; the t-test is
the one Tebaldi et al. 2011, GRL 38, L23701, use).

- Percentiles: for each day and cell, the Hyndman-Fan type 7 quantiles
  (alpha = beta = 1, numpy's "linear") of the members' values present;
  NaN where no member has one.
- A member's change: the mean of its future period (days
  ``method.fut_days``) less the mean of its reference period (days
  ``method.ref_days``).
- Its significance: the single-sample t-test of the future values against
  the reference mean, t = change / (s / sqrt(n)) with s the future values'
  sample standard deviation and n their count, df = n - 1. The two-sided
  p-value is the closed form of Student's t for whole df (Abramowitz and
  Stegun 26.7.3-26.7.4: theta = arctan(t / sqrt(df)) and a finite sum of
  powers of cos(theta)), which shares nothing with the continued fraction
  of the incomplete beta function.
- A member is valid where neither period misses a value. It changed where
  p < 0.05 (xclim's ``p_change``); its change is positive where above 0 and
  negative where below (strict signs). Of the valid members: ``changed``,
  ``positive``, ``changed_positive``, ``negative``, ``changed_negative``;
  ``agree``, the largest of the positive, the negative and the no-change
  fraction; ``valid``, the valid members over all members.

Where this follows the port (``xclim_tpu/ensembles/_robustness.py``
``_fractions_program``) and not xclim's published code:

- the means divide by the count held to at least 1, the variance by n - 1
  held to at least 1, and df is n - 1 held to at least 1; for a member with
  two values or more this changes nothing, and a member that misses every
  value of both periods reads a p-value of NaN, as 0 / 0 gives;
- where no member is valid the fractions are 0 and ``agree`` is 1 (the
  no-change fraction, 1 - 0 - 0), where xclim divides by a weight of 0;
- ``agree`` counts the no-change fraction (the port's ``strict_sign``).

A significance or sign decision is a step function of a value the program
computes in float32, so the fractions are given as intervals: a member
counts either way for ``changed`` where its p-value lies within the
``pvals_max_abs_prob`` limit of 0.05, and for the signs where its change
lies within ``check.delta_tol_K`` of 0. The low end counts the members
whose decision holds at both ends of that band, the high end those whose
decision holds at either; ``agree`` lies between the largest of the low
ends and the largest of the high ends. ``valid`` is exact, rounded to
float32 as the port's quotient of two whole numbers is.

Inputs are ``(days, cells)`` tensors, one a member, held in ``dtype`` (the
data's precision: float32 as the configuration states, bfloat16 in the
control); all arithmetic is in float64. Outputs are ``(rows, cells)``:
``p10``, ``p50``, ``p90`` as (days, cells), ``pvals`` as (members, cells),
``valid`` as (1, cells), and the other fractions as their (2, 1, cells)
interval ends.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.hyndman_fan import quantiles

FRACTIONS = ("changed", "positive", "changed_positive", "negative",
             "changed_negative", "agree", "valid")
UNITS = {"p10": "K", "p50": "K", "p90": "K", "pvals": "prob",
         **{k: "frac" for k in FRACTIONS}}
#: outputs given as the (2, ...) ends of the values allowed
INTERVALS = FRACTIONS[:-1]
#: xclim's significance level of the t-test
P_CHANGE = 0.05


def t_pvalue(t: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Two-sided p-value P(|T| >= |t|) of Student's t with whole ``df`` >= 1
    degrees of freedom, in float64 (Abramowitz and Stegun 26.7.3-26.7.4):
    with theta = arctan(|t| / sqrt(df)), c = cos(theta) and s = sin(theta),
    P(|T| < |t|) is (2 / pi) (theta + s (c + 2/3 c^3 + ... + (2 4 ...
    (df - 3)) / (1 3 ... (df - 2)) c^(df - 2))) for odd df, and s (1 + 1/2
    c^2 + ... + (1 3 ... (df - 3)) / (2 4 ... (df - 2)) c^(df - 2)) for
    even df. NaN where t is."""
    t, df = t.double(), df.double()
    theta = torch.atan(t.abs() / torch.sqrt(df))
    c, s = torch.cos(theta), torch.sin(theta)
    c2 = c * c
    odd = torch.remainder(df, 2) == 1
    # the odd series' k-th term (2 4 ... 2k) / (3 5 ... (2k+1)) c^(2k+1), to
    # k = (df - 3) / 2; the even series' (1 3 ... (2k-1)) / (2 4 ... 2k)
    # c^(2k), to k = (df - 2) / 2
    term_odd, term_even = c.clone(), torch.ones_like(c)
    sum_odd = torch.where(df >= 3, term_odd, 0.0)
    sum_even = term_even.clone()
    last = int(df.max()) // 2 if df.numel() else 0
    for k in range(1, last + 1):
        term_odd = term_odd * (2.0 * k / (2.0 * k + 1.0)) * c2
        term_even = term_even * ((2.0 * k - 1.0) / (2.0 * k)) * c2
        sum_odd = sum_odd + torch.where(2 * k + 3 <= df, term_odd, 0.0)
        sum_even = sum_even + torch.where(2 * k + 2 <= df, term_even, 0.0)
    inside = torch.where(odd, 2.0 / math.pi * (theta + s * sum_odd),
                         s * sum_even)
    return (1.0 - inside).clamp(0.0, 1.0)


def moments(x: torch.Tensor):
    """(count, mean, centred sum of squares, any missing) over the days of
    ``x`` (members, days, cells), with the port's clamps."""
    ok = ~torch.isnan(x)
    n = ok.sum(dim=1).double()
    m = torch.where(ok, x, 0.0).sum(dim=1) / n.clamp(min=1.0)
    ss = torch.where(ok, (x - m[:, None]) ** 2, 0.0).sum(dim=1)
    return n, m, ss, (~ok).any(dim=1)


def reference(inputs: dict, config: dict, mix: dict,
              dtype=torch.float32) -> dict:
    """{"p10", "p50", "p90", the fractions, "pvals"} from the cells' member
    series."""
    m = config["method"]
    if m["test"] != "ttest":
        raise ValueError("the reference implements test 'ttest' only")
    x = torch.stack([v.to(dtype).double() for v in inputs.values()])
    M, _, C = x.shape                                   # (members, days, C)
    q = [v / 100.0 for v in m["values"]]
    per = quantiles(x.permute(1, 2, 0), q, 1.0, 1.0)    # (days, C, Q)
    out = {f"p{v}": per[..., i] for i, v in enumerate(m["values"])}

    n1, m1, ss1, miss_f = moments(x[:, slice(*m["fut_days"])])
    _, m2, _, miss_r = moments(x[:, slice(*m["ref_days"])])
    delta = m1 - m2
    valid = ~(miss_f | miss_r)                          # (M, C)
    s1 = torch.sqrt(ss1 / (n1 - 1.0).clamp(min=1.0))
    t = delta / (s1 / torch.sqrt(n1.clamp(min=1.0)))
    pvals = t_pvalue(t, (n1 - 1.0).clamp(min=1.0))
    out["pvals"] = pvals

    ptol = config["limits"]["pvals_max_abs_prob"]
    dtol = config["check"]["delta_tol_K"]
    nv = valid.sum(dim=0).double()
    denom = nv.clamp(min=1.0)

    def frac(mask):
        return ((mask & valid).sum(dim=0).double() / denom)[None]

    # each decision as it holds at both ends of its band (low) and at
    # either end (high)
    ends = {"changed": (pvals < P_CHANGE - ptol, pvals < P_CHANGE + ptol),
            "positive": (delta > dtol, delta > -dtol),
            "negative": (delta < -dtol, delta < dtol)}
    for k in ("positive", "negative"):
        ends[f"changed_{k}"] = tuple(c & d for c, d in
                                     zip(ends["changed"], ends[k]))
    for k, (lo, hi) in ends.items():
        out[k] = torch.stack([frac(lo), frac(hi)])
    p, n = out["positive"], out["negative"]
    zero = 1.0 - p.flip(0) - n.flip(0)          # low end from the high ones
    out["agree"] = torch.maximum(torch.maximum(p, n), zero)
    out["valid"] = (nv / M).float()[None]
    return out
