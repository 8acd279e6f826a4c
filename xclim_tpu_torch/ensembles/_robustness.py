"""Ensemble robustness metrics (reference: xclim:src/xclim/ensembles/_robustness.py).

Significance tests are computed analytically on the data's device
(Student-t / Welch / Mann-Whitney normal approximation / Brown-Forsythe F),
with :func:`_betainc`, XLA's regularized incomplete beta as the op
``ops/betainc.py`` (the kernel ``csrc/betainc.cu`` on the card), supplying
the t and F distribution functions: ``torch.special`` has none.

Spans: ``ensembles.robustness`` around :func:`robustness_fractions`, and
inside it ``ensembles.moments`` (the time moments and the t statistic) and
``ensembles.betainc`` (each :func:`_betainc` evaluation, around the op's
``op.betainc``); the counter ``betainc_terms``, counted to ``op.betainc``,
is one a kernel launch on the card and one a continued-fraction step (and
host check) of the CPU twin.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.ops import betainc
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.utils.profiling import span

__all__ = ["robustness_fractions", "robustness_categories", "robustness_coefficient"]

#: continued-fraction terms :func:`_betainc` asks for at most, plus one
_BETAINC_ITERATIONS = betainc.ITERATIONS


@span("ensembles.betainc")
def _betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta function I_x(a, b) in float32:
    :func:`xclim_tpu_torch.ops.betainc.betainc` (one kernel launch on the
    card, the plain twin on the CPU)."""
    return betainc.betainc(a, b, x, _BETAINC_ITERATIONS)


def _t_sf(t, df):
    """Two-sided p-value for a Student-t statistic (betainc identity)."""
    x = df / (df + t * t)
    return _betainc(df / 2.0, 0.5, x)


def _nanstd(x, axis, ddof=1):
    n = (~torch.isnan(x)).sum(dim=axis)
    m = torch.nanmean(x, dim=axis)
    ss = torch.nansum((x - m.unsqueeze(axis)) ** 2, dim=axis)
    return torch.sqrt(ss / torch.clamp(n - ddof, min=1))


def _count(x, axis):
    return (~torch.isnan(x)).sum(dim=axis).to(torch.float32)


def _mannwhitney(fut, ref, tax, p_change=0.05):
    """Mann-Whitney U with normal approximation & tie correction
    (xclim:_robustness.py:585; the reference uses scipy's exact/asymptotic)."""
    f = fut.movedim(tax, -1)
    r = ref.movedim(tax, -1)
    n1 = _count(f, -1)
    n2 = _count(r, -1)
    # U = sum over pairs of (f > r) + 0.5*(f == r)
    gt = (f[..., :, None] > r[..., None, :]).sum(dim=(-2, -1)).to(torch.float32)
    eq = (f[..., :, None] == r[..., None, :]).sum(dim=(-2, -1)).to(torch.float32)
    U = gt + 0.5 * eq
    mu = n1 * n2 / 2.0
    sigma = torch.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    z = (U - mu) / torch.where(sigma == 0, 1.0, sigma)
    pvals = torch.special.erfc(torch.abs(z) / float(np.float32(np.sqrt(2.0))))
    return pvals < p_change, pvals


def _nanmedian_last(x):
    """Median over the last axis, keeping it: the mean of the two middle
    valid values (``jnp.nanmedian``)."""
    return nan_quantile(x, [0.5], axis=-1)[0].unsqueeze(-1)


def _brownforsythe(fut, ref, tax, p_change=0.05):
    """Brown-Forsythe (Levene center=median) test (xclim:_robustness.py:614)."""
    f = fut.movedim(tax, -1)
    r = ref.movedim(tax, -1)
    zf = torch.abs(f - _nanmedian_last(f))
    zr = torch.abs(r - _nanmedian_last(r))
    n1 = _count(zf, -1)
    n2 = _count(zr, -1)
    m1 = torch.nanmean(zf, dim=-1)
    m2 = torch.nanmean(zr, dim=-1)
    N = n1 + n2
    grand = (n1 * m1 + n2 * m2) / N
    ssb = n1 * (m1 - grand) ** 2 + n2 * (m2 - grand) ** 2
    ssw = torch.nansum((zf - m1[..., None]) ** 2, dim=-1) + \
        torch.nansum((zr - m2[..., None]) ** 2, dim=-1)
    F = ssb * (N - 2) / torch.where(ssw == 0, torch.nan, ssw)
    d1, d2 = 1.0, N - 2
    x = d2 / (d2 + d1 * F)
    pvals = _betainc(d2 / 2.0, d1 / 2.0, x)
    return pvals < p_change, pvals


def _ipcc_ar6_c(fut, ref, tax, ref_time=None, ref_pi=None):
    """IPCC AR6 Atlas approach C (xclim:_robustness.py:637): change significant
    when |Δ| exceeds γ = √(2/20)·1.645·σ of detrended annual ref."""
    r = ref.movedim(tax, -1)
    n = r.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=r.device)
    tm = t - t.mean()
    beta = torch.nansum(r * tm, dim=-1) / torch.sum(tm * tm)
    detr = r - beta[..., None] * tm
    sigma = _nanstd(detr, -1)
    gamma = float(np.sqrt(2 / 20) * 1.645) * sigma
    delta = torch.nanmean(fut, dim=tax) - torch.nanmean(ref, dim=tax)
    return torch.abs(delta) > gamma, None


#: tests computed from the time moments inside the fractions pipeline
_MOMENT_TESTS = ("ttest", "welch-ttest")
#: tests that read the member series themselves
SIGNIFICANCE_TESTS = {
    "mannwhitney-utest": _mannwhitney,
    "brownforsythe-test": _brownforsythe,
    "ipcc-ar6-c": _ipcc_ar6_c,
}


def _moments(x, tax):
    """(n, mean, centered sum of squares, any-NaN) over time: the t-tests,
    the deltas and the validity all derive from these."""
    nan = torch.isnan(x)
    n = (~nan).sum(dim=tax).to(torch.float32)
    s = torch.where(nan, 0.0, x).sum(dim=tax)
    m = s / torch.clamp(n, min=1.0)
    ss = torch.where(nan, 0.0, (x - m.unsqueeze(tax)) ** 2).sum(dim=tax)
    return n, m, ss, nan.any(dim=tax)


def _fractions(futd, refd, w, test, strict_sign, has_ref, tax, rax, kw):
    """The fractions pipeline of the reference's jitted
    ``_fractions_program`` (xclim_tpu/ensembles/_robustness.py:132-223), as
    eager torch in the same op order."""
    with span("ensembles.moments"):
        if has_ref:
            n1, m1, ss1, nanf = _moments(futd, tax)
            n2, m2, ss2, nanr = _moments(refd, tax)
            deltas = m1 - m2
            valid = ~(nanf | nanr)
            ref_mean = m2
        else:
            deltas = futd
            valid = ~torch.isnan(deltas)
            ref_mean = None
        if test == "ttest":
            fstd = torch.sqrt(ss1 / torch.clamp(n1 - 1, min=1.0))
            t = (m1 - m2) / (fstd / torch.sqrt(torch.clamp(n1, min=1.0)))
            df = torch.clamp(n1 - 1, min=1.0)
        elif test == "welch-ttest":
            v1 = ss1 / torch.clamp(n1 - 1, min=1.0)
            v2 = ss2 / torch.clamp(n2 - 1, min=1.0)
            se2 = v1 / n1 + v2 / n2
            t = (m1 - m2) / torch.sqrt(se2)
            df = se2 ** 2 / ((v1 / n1) ** 2 / torch.clamp(n1 - 1, min=1.0)
                             + (v2 / n2) ** 2 / torch.clamp(n2 - 1, min=1.0))
            df = torch.clamp(df, min=1.0)
    pvals = None
    if test is None:
        changed = torch.ones_like(deltas, dtype=torch.bool)
    elif test == "threshold":
        if "abs_thresh" in kw:
            changed = torch.abs(deltas) > kw["abs_thresh"]
        else:
            changed = torch.abs(deltas / ref_mean) > kw["rel_thresh"]
    elif test in _MOMENT_TESTS:
        pvals = _t_sf(torch.abs(t), df)
        changed = pvals < kw.get("p_change", 0.05)
    else:
        changed, pvals = SIGNIFICANCE_TESTS[test](futd, refd, tax, **kw)

    shape = [1] * deltas.ndim
    shape[rax] = w.shape[0]
    wr = torch.broadcast_to(w.reshape(shape), deltas.shape)
    wv = torch.where(valid, wr, 0.0)
    tot = wr.sum(dim=rax)
    wtot = wv.sum(dim=rax)
    denom = torch.where(wtot == 0, 1.0, wtot)

    if strict_sign:
        pos = deltas > 0
        neg = deltas < 0
    else:
        pos = deltas >= 0
        neg = deltas <= 0

    def frac(mask):
        return torch.where(mask & valid, wv, 0.0).sum(dim=rax) / denom

    pos_frac = frac(pos)
    neg_frac = frac(neg)
    if strict_sign:
        zero_frac = 1.0 - pos_frac - neg_frac
        agree = torch.maximum(torch.maximum(pos_frac, neg_frac), zero_frac)
    else:
        agree = torch.maximum(pos_frac, neg_frac)
    return (frac(changed), pos_frac, frac(changed & pos), neg_frac,
            frac(changed & neg), agree, wtot / tot, pvals)


@span("ensembles.robustness")
def robustness_fractions(fut: ClimArray, ref: ClimArray | None = None,
                         test: str | None = None, weights=None,
                         strict_sign: bool = True, **kwargs) -> ClimDataset:
    """Fractions of members showing (significant/positive/negative) change
    (xclim:ensembles/_robustness.py:74)."""
    rax = fut.dims.index("realization")
    if ref is None:
        # fut IS the delta (no time axis) — delta-based tests still apply
        # (xclim:ensembles/_robustness.py:164-180)
        tax = -1
        out_dims = tuple(d for d in fut.dims if d != "realization")
        if test not in (None, "threshold"):
            raise ValueError(f"test {test!r} requires a reference.")
        if test == "threshold" and "abs_thresh" not in kwargs \
                and "rel_thresh" in kwargs:
            raise ValueError("rel_thresh requires a reference.")
    else:
        tax = fut.dims.index("time")
        out_dims = tuple(d for d in fut.dims if d not in ("realization", "time"))
        rax = [d for d in fut.dims if d != "time"].index("realization")
    if test == "threshold" and "abs_thresh" not in kwargs \
            and "rel_thresh" not in kwargs:
        raise ValueError("threshold test needs abs_thresh or rel_thresh")
    if test not in (None, "threshold", *_MOMENT_TESTS, *SIGNIFICANCE_TESTS):
        raise ValueError(f"Unknown significance test {test!r}")

    nreal = fut.shape[fut.dims.index("realization")]
    w = (torch.ones(nreal, dtype=torch.float32, device=fut.device)
         if weights is None else torch.as_tensor(
             np.asarray(weights, dtype=np.float32), device=fut.device))
    refd = ref.data if ref is not None else fut.data
    (changed_frac, pos_frac, changed_pos, neg_frac, changed_neg, agree,
     valid_frac, pvals) = _fractions(fut.data, refd, w, test,
                                     bool(strict_sign), ref is not None, tax,
                                     rax, kwargs)

    coords = {c: v for c, v in fut.coords.items()
              if c not in ("realization", "time")}

    def mk(data, name, desc):
        return ClimArray(data, out_dims, dict(coords),
                         {"units": "", "description": desc}, name)

    out = ClimDataset({
        "changed": mk(changed_frac, "changed",
                      "Fraction of valid members showing significant change."),
        "positive": mk(pos_frac, "positive",
                       "Fraction of valid members showing positive change."),
        "changed_positive": mk(changed_pos, "changed_positive",
                               "Fraction of valid members showing significant and "
                               "positive change."),
        "negative": mk(neg_frac, "negative",
                       "Fraction of valid members showing negative change."),
        "changed_negative": mk(changed_neg, "changed_negative",
                               "Fraction of valid members showing significant and "
                               "negative change."),
        "agree": mk(agree, "agree",
                    "Fraction of valid members agreeing on the sign of change."),
        "valid": mk(valid_frac, "valid", "Fraction of valid members."),
    })
    if pvals is not None:
        pdims = tuple(d for d in fut.dims if d != "time")
        pcoords = {c: v for c, v in fut.coords.items() if c != "time"}
        out["pvals"] = ClimArray(pvals, pdims, pcoords, {"units": ""}, "pvals")
    return out


def robustness_categories(changed_or_fractions, agree=None,
                          categories=None, ops=None, thresholds=None) -> ClimArray:
    """Bin robustness fractions into IPCC-style categories
    (xclim:ensembles/_robustness.py:336)."""
    if categories is None:
        categories = ["Robust signal", "No change or no signal", "Conflicting signal"]
    if ops is None:
        ops = [(">=", ">="), ("<", None), (">=", "<")]
    if thresholds is None:
        thresholds = [(0.66, 0.8), (0.66, None), (0.66, 0.8)]
    if isinstance(changed_or_fractions, ClimDataset):
        changed = changed_or_fractions["changed"]
        agree = changed_or_fractions["agree"]
    else:
        changed = changed_or_fractions

    opmap = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
             "<=": operator.le}
    out = torch.full(changed.shape, len(categories), dtype=torch.int32,
                     device=changed.device)
    # apply in reverse order so the first categories win
    for i in reversed(range(len(categories))):
        (op_c, op_a) = ops[i]
        (th_c, th_a) = thresholds[i]
        cond = opmap[op_c](changed.data, th_c)
        if op_a is not None:
            cond = cond & opmap[op_a](agree.data, th_a)
        out = torch.where(cond, i + 1, out).to(torch.int32)
    res = changed.copy(data=out)
    res.attrs = {"units": "",
                 "flag_values": list(range(1, len(categories) + 1)),
                 "flag_descriptions": categories}
    return res


#: elements of the dense comparisons (cells x samples x samples) that
#: robustness_coefficient builds at once
_COEF_CHUNK_ELEMS = 1 << 26


def _diff_cdf_sq_area_int(a, b):
    """Exact ∫ (CDF_a − CDF_b)² dx of two empirical CDFs for each cell of a
    batch — the reference's piecewise integral
    (xclim:ensembles/_robustness.py:464-482) by dense comparisons. a: (C,
    na), b: (C, nb) -> (C,)."""
    xs = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    y1 = (a[:, None, :] <= xs[:, :, None]).sum(
        dim=-1, dtype=torch.float32) / a.shape[-1]
    y2 = (b[:, None, :] <= xs[:, :, None]).sum(
        dim=-1, dtype=torch.float32) / b.shape[-1]
    return torch.sum(torch.diff(xs, dim=-1) * (y1 - y2)[:, :-1] ** 2, dim=-1)


def robustness_coefficient(fut: ClimArray, ref: ClimArray) -> ClimArray:
    """Knutti & Sedláček (2013) robustness coefficient R = 1 − A1/A2
    (xclim:ensembles/_robustness.py:430-506).

    A1 integrates the squared difference between the pooled-ensemble CDF
    and the CDF of the ensemble-mean series; A2 the same between the
    reference CDF and the ensemble-mean CDF. Cells go through in chunks
    whose dense comparisons stay under ``_COEF_CHUNK_ELEMS`` elements.
    """
    rest = tuple(d for d in fut.dims if d not in ("realization", "time"))
    f = fut.transpose("realization", "time", *rest).data  # (R, T, ...)
    r = ref.transpose("time", *[d for d in rest if d in ref.dims]).data
    R_, T = f.shape[0], f.shape[1]
    fc = f.reshape(R_, T, -1).permute(2, 0, 1)          # (C, R, T)
    C = fc.shape[0]
    rc = torch.broadcast_to(r.reshape(r.shape[0], -1),
                            (r.shape[0], C)).transpose(0, 1)  # (C, Tr)
    n = R_ * T + R_
    chunk = max(1, _COEF_CHUNK_ELEMS // (n * n))
    outs = []
    for c0 in range(0, C, chunk):
        fcell = fc[c0:c0 + chunk]
        pooled = fcell.reshape(fcell.shape[0], -1)      # (c, R*T)
        # "multimodel mean": each member's TIME mean — one value per
        # realization (xclim:_robustness.py:485, future.mean(axis=-1))
        favg = fcell.mean(dim=2)                        # (c, R)
        a1 = _diff_cdf_sq_area_int(pooled, favg)
        a2 = _diff_cdf_sq_area_int(rc[c0:c0 + chunk], favg)
        outs.append(1.0 - a1 / torch.where(a2 == 0, torch.nan, a2))
    Rcoef = torch.cat(outs)
    Rcoef = Rcoef.reshape(f.shape[2:]) if rest else Rcoef[0]
    coords = {c: v for c, v in fut.coords.items() if c in rest}
    return ClimArray(Rcoef, rest, coords, {"units": "", "long_name":
                                           "Ensemble robustness coefficient"}, "R")
