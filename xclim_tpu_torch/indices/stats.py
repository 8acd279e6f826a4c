"""Statistical distribution fitting & frequency analysis
(reference: xclim:src/xclim/indices/stats.py, 1197 LoC).

Moment, L-moment and approximate-ML estimators and cdf/ppf/pdf evaluation
run on the data's device as closed forms (``torch.special`` gamma and
normal functions; gamma ppf via Wilson-Hilferty + Newton). The maximum
likelihood fits of ``genextreme`` and ``weibull_min`` refine their closed-form
start by a BFGS over all cells at once (:func:`_ml_refine`). Exact scipy MLE
stays available on the host (method='ML_scipy').
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray, _nanmin
from xclim_tpu_torch.ops.quantile import _nanstd, _nanvar

__all__ = [
    "DIST_PARAMS",
    "dist_method",
    "fa",
    "fit",
    "frequency_analysis",
    "get_dist",
    "parametric_cdf",
    "parametric_pdf",
    "parametric_quantile",
    "preprocess_standardized_index",
    "standardized_index",
    "standardized_index_fit_params",
]

_EULER = 0.5772156649015329
# float32 quotients of float32 constants, rounded where the reference's
# jnp.log(2.0) / jnp.log(3.0) and jnp.pi / jnp.sqrt(6.0) round them
_LOG2_LOG3 = float(np.float32(np.log(np.float32(2.0)))
                   / np.float32(np.log(np.float32(3.0))))
_PI_SQRT6 = float(np.float32(np.pi) / np.float32(np.sqrt(np.float32(6.0))))

DIST_PARAMS = {
    "norm": ["loc", "scale"],
    "expon": ["loc", "scale"],
    "gamma": ["a", "loc", "scale"],
    "lognorm": ["s", "loc", "scale"],
    "gumbel_r": ["loc", "scale"],
    "genextreme": ["c", "loc", "scale"],
    "fisk": ["c", "loc", "scale"],
    "weibull_min": ["c", "loc", "scale"],
}


def get_dist(dist: str):
    """scipy distribution object by name (xclim:indices/stats.py:551)."""
    import scipy.stats as spstats

    if isinstance(dist, str):
        return getattr(spstats, dist)
    return dist


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a float32 tensor on ``like``'s device (a tensor
    passes through)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# L-moments (sample, unbiased) — the PWM workhorse
# ---------------------------------------------------------------------------


def _lmoments(x: torch.Tensor, axis: int = -1):
    """First three sample L-moments along axis (NaN-aware): (l1, l2, l3, n)."""
    xs = torch.sort(x, dim=axis).values.movedim(axis, -1)   # NaNs last
    n_tot = xs.shape[-1]
    valid = ~torch.isnan(xs)
    n = valid.sum(dim=-1, keepdim=True).to(torch.float32)
    i = torch.arange(n_tot, dtype=torch.float32, device=x.device)
    x0 = torch.where(valid, xs, 0.0)
    nn = n[..., 0]
    b0 = x0.sum(-1) / torch.clamp(nn, min=1)
    w1 = i / torch.clamp(n - 1, min=1)
    b1 = (x0 * w1).sum(-1) / torch.clamp(nn, min=1)
    w2 = i * (i - 1) / torch.clamp((n - 1) * (n - 2), min=1)
    b2 = (x0 * w2).sum(-1) / torch.clamp(nn, min=1)
    l1 = b0
    l2 = 2 * b1 - b0
    l3 = 6 * b2 - 6 * b1 + b0
    return l1, l2, l3, nn


def _gammaf(x):
    return torch.exp(torch.special.gammaln(x))


def _gammainc(a, x):
    """Regularized lower incomplete gamma with the reference's edge values
    (XLA's igamma): 0 at x = 0, 1 at x = inf, NaN for x < 0, a < 0, a = x =
    0 or a NaN operand."""
    x = _f32(x, a)
    out = torch.special.gammainc(a, x)
    out = torch.where(x == 0, 0.0, out)
    out = torch.where(x == torch.inf, 1.0, out)
    bad = ((x < 0) | (a < 0) | ((a == 0) & (x == 0)) | torch.isnan(a)
           | torch.isnan(x))
    return torch.where(bad, torch.nan, out)


def _nan_if_zero(v):
    return torch.where(v == 0, torch.nan, v)


# ---------------------------------------------------------------------------
# per-distribution estimators and cdf/ppf/pdf
# ---------------------------------------------------------------------------


def _fit_norm(x, axis, method):
    return (torch.nanmean(x, dim=axis), _nanstd(x, axis))


def _fit_expon(x, axis, method):
    mn = _nanmin(x, axis)
    return (mn, torch.nanmean(x, dim=axis) - mn)


def _fit_gamma(x, axis, method):
    """Gamma(a, loc=0, scale): Thom/Greenwood-Durand approximate ML
    (the reference's SPI "APP" path) or PWM."""
    if method == "PWM":
        l1, l2, _, _ = _lmoments(x, axis)
        t = l2 / _nan_if_zero(l1)
        z1 = math.pi * t ** 2
        a_lo = (1 - 0.3080 * z1) / (z1 - 0.05812 * z1 ** 2 + 0.01765 * z1 ** 3)
        z2 = 1 - t
        a_hi = (0.7213 * z2 - 0.5947 * z2 ** 2) / (1 - 2.1817 * z2
                                                   + 1.2113 * z2 ** 2)
        a = torch.where(t < 0.5, a_lo, a_hi)
        scale = torch.nanmean(x, dim=axis) / a
    else:  # approximate ML (Thom 1958)
        xm = torch.where(x > 0, x, torch.nan)
        mean = torch.nanmean(xm, dim=axis)
        logmean = torch.nanmean(torch.log(xm), dim=axis)
        A = torch.log(mean) - logmean
        a = (1 + torch.sqrt(1 + 4 * A / 3)) / (4 * A)
        scale = mean / a
    return (a, torch.zeros_like(a), scale)


def _fit_lognorm(x, axis, method):
    lx = torch.log(torch.where(x > 0, x, torch.nan))
    mu = torch.nanmean(lx, dim=axis)
    return (_nanstd(lx, axis), torch.zeros_like(mu), torch.exp(mu))


def _fit_gumbel(x, axis, method):
    if method == "PWM":
        l1, l2, _, _ = _lmoments(x, axis)
        scale = l2 / math.log(2.0)
        loc = l1 - _EULER * scale
    else:
        scale = _nanstd(x, axis) * math.sqrt(6.0) / math.pi
        loc = torch.nanmean(x, dim=axis) - _EULER * scale
    return (loc, scale)


def _fit_genextreme(x, axis, method):
    """GEV by L-moments (Hosking et al. 1985); scipy's c = Hosking's k."""
    l1, l2, l3, _ = _lmoments(x, axis)
    t3 = l3 / _nan_if_zero(l2)
    z = 2.0 / (3.0 + t3) - _LOG2_LOG3
    c = 7.8590 * z + 2.9554 * z ** 2
    g1 = _gammaf(1 + c)
    scale = l2 * c / ((1 - torch.pow(2.0, -c)) * g1)
    loc = l1 - scale * (1 - g1) / c
    return (c, loc, scale)


def _fit_fisk(x, axis, method):
    """3-param log-logistic by PWM (Singh-Maddala; the SPEI standard)."""
    xs = torch.sort(x, dim=axis).values.movedim(axis, -1)
    n_tot = xs.shape[-1]
    valid = ~torch.isnan(xs)
    nn = valid.sum(-1).to(torch.float32)
    i = torch.arange(n_tot, dtype=torch.float32, device=x.device)
    x0 = torch.where(valid, xs, 0.0)
    n1 = torch.clamp(nn[..., None] - 1, min=1)
    w0 = x0.sum(-1) / torch.clamp(nn, min=1)
    w1 = (x0 * (n1 - i) / n1).sum(-1) / torch.clamp(nn, min=1) / 1.0
    w2 = (x0 * (n1 - i) * (n1 - i - 1) /
          (n1 * torch.clamp(n1 - 1, min=1))).sum(-1) / torch.clamp(nn, min=1)
    # Vicente-Serrano et al. (2010) PWM estimators
    beta = (2 * w1 - w0) / (6 * w1 - w0 - 6 * w2)
    g1g2 = _gammaf(1 + 1 / beta) * _gammaf(1 - 1 / beta)
    alpha = (w0 - 2 * w1) * beta / g1g2
    gamma = w0 - alpha * g1g2
    return (beta, gamma, alpha)  # (c, loc, scale)


def _fit_weibull(x, axis, method):
    """Weibull-min via moment matching on log (simple, loc=min-ish)."""
    mn = _nanmin(x, axis)
    lx = torch.log(x - mn.unsqueeze(axis) + 1e-9)
    c = math.pi / (_nanstd(lx, axis) * math.sqrt(6.0))
    scale = torch.exp(torch.nanmean(lx, dim=axis) + _EULER / c)
    return (c, mn, scale)


def _gev_nll(theta, x, valid):
    """Per-row negative log-likelihood of GEV in scipy's parameterization
    (c, loc, log_scale); invalid support → large penalty.
    theta (B, 3), x and valid (B, n) → (B,)."""
    c, loc, lsc = (theta[:, k:k + 1] for k in range(3))
    scale = torch.exp(lsc)
    z = (x - loc) / scale
    # scipy genextreme: support 1 - c z > 0
    t = 1.0 - c * z
    ok = valid & (t > 1e-10)
    ts = torch.where(ok, t, 1.0)
    # log pdf = -log scale + (1/c - 1) log t - t^(1/c)
    logpdf = -lsc + (1.0 / c - 1.0) * torch.log(ts) - ts ** (1.0 / c)
    pen = torch.where(valid & ~(t > 1e-10), 1e6, 0.0)
    return -(torch.where(ok, logpdf, 0.0) - pen).sum(-1)


def _weibull_nll(theta, x, valid):
    """Per-row NLL of weibull_min (log_c, loc, log_scale); x > loc required."""
    lc, loc, lsc = (theta[:, k:k + 1] for k in range(3))
    c = torch.exp(lc)
    scale = torch.exp(lsc)
    z = (x - loc) / scale
    ok = valid & (z > 1e-10)
    zs = torch.where(ok, z, 1.0)
    logpdf = lc - lsc + (c - 1.0) * torch.log(zs) - zs ** c
    pen = torch.where(valid & ~(z > 1e-10), 1e6, 0.0)
    return -(torch.where(ok, logpdf, 0.0) - pen).sum(-1)


# ---------------------------------------------------------------------------
# batched BFGS with a strong-Wolfe line search (Nocedal & Wright 1999,
# algorithms 6.1, 3.5 and 3.6, as jax.scipy.optimize.minimize runs them):
# every row is its own problem; a row that is done keeps its state while
# the others iterate, as under jax.vmap.
# ---------------------------------------------------------------------------


def _value_and_grad(nll, theta, x, valid):
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        f = nll(t, x, valid)
        (g,) = torch.autograd.grad(f.sum(), t)
    return f.detach(), g


def _sel(mask, new, old):
    """Rows of ``new`` where mask (B,), else ``old``."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d20 = fb - fa - C * db
    d21 = fc - fa - C * dc
    A = (dc ** 2 * d20 - db ** 2 * d21) / denom
    B = (-dc ** 3 * d20 + db ** 3 * d21) / denom
    radical = B * B - 3. * A * C
    return a + (-B + torch.sqrt(radical)) / (3. * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2. * B)


def _zoom(restricted, wolfe_one, wolfe_two, lo, hi, g_0, run):
    """Algorithm 3.6 on the rows where ``run``; lo and hi are
    (a, phi, dphi) triples. Returns (failed, a_star, phi_star, dphi_star,
    g_star) for every row."""
    a_lo, phi_lo, dphi_lo = lo
    a_hi, phi_hi, dphi_hi = hi
    a_rec = (a_lo + a_hi) / 2.
    phi_rec = (phi_lo + phi_hi) / 2.
    a_star = torch.ones_like(a_lo)
    phi_star, dphi_star, g_star = phi_lo, dphi_lo, g_0
    done = torch.zeros_like(run)
    failed = torch.zeros_like(run)
    j = 0
    while True:
        act = ~done & run & ~failed
        if not bool(act.any()):
            break
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = 0.2 * dalpha
        qchk = 0.1 * dalpha
        failed = torch.where(act, failed | (dalpha <= 1e-5), failed)
        a_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                            phi_rec)
        use_cubic = (j > 0) & (a_cubic > a + cchk) & (a_cubic < b - cchk)
        a_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = ~use_cubic & (a_quad > a + qchk) & (a_quad < b - qchk)
        use_bis = ~use_cubic & ~use_quad
        a_j = torch.where(use_cubic, a_cubic, a_rec)
        a_j = torch.where(use_quad, a_quad, a_j)
        a_j = torch.where(use_bis, (a_lo + a_hi) / 2., a_j)
        phi_j, dphi_j, g_j = restricted(a_j)

        hi_to_j = act & (wolfe_one(a_j, phi_j) | (phi_j >= phi_lo))
        star_to_j = act & wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = (act & (dphi_j * (a_hi - a_lo) >= 0.) & ~hi_to_j
                    & ~star_to_j)
        lo_to_j = act & ~hi_to_j & ~star_to_j
        a_rec = torch.where(hi_to_j | hi_to_lo, a_hi, a_rec)
        phi_rec = torch.where(hi_to_j | hi_to_lo, phi_hi, phi_rec)
        a_hi = torch.where(hi_to_j, a_j, a_hi)
        phi_hi = torch.where(hi_to_j, phi_j, phi_hi)
        dphi_hi = torch.where(hi_to_j, dphi_j, dphi_hi)
        done = done | star_to_j
        a_star = torch.where(star_to_j, a_j, a_star)
        phi_star = torch.where(star_to_j, phi_j, phi_star)
        dphi_star = torch.where(star_to_j, dphi_j, dphi_star)
        g_star = _sel(star_to_j, g_j, g_star)
        a_hi = torch.where(hi_to_lo, a_lo, a_hi)
        phi_hi = torch.where(hi_to_lo, phi_lo, phi_hi)
        dphi_hi = torch.where(hi_to_lo, dphi_lo, dphi_hi)
        keep_rec = lo_to_j & ~hi_to_lo
        a_rec = torch.where(keep_rec, a_lo, a_rec)
        phi_rec = torch.where(keep_rec, phi_lo, phi_rec)
        a_lo = torch.where(lo_to_j, a_j, a_lo)
        phi_lo = torch.where(lo_to_j, phi_j, phi_lo)
        dphi_lo = torch.where(lo_to_j, dphi_j, dphi_lo)
        j += 1
        if j >= 30:
            failed = failed | act
    return failed, a_star, phi_star, dphi_star, g_star


def _line_search(fg, xk, pk, old_fval, old_old_fval, gfk, run,
                 c1=1e-4, c2=0.9, maxiter=10):
    """Algorithm 3.5 (strong Wolfe) on the rows where ``run``: returns
    (failed, a_k, f_k, g_k)."""
    def restricted(t):
        phi, g = fg(xk + t[:, None] * pk)
        return phi, (g * pk).sum(-1), g

    phi_0 = old_fval
    dphi_0 = (gfk * pk).sum(-1)
    cand = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start = torch.where(cand > 1, 1.0, cand)

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -c2 * dphi_0

    done = torch.zeros_like(run)
    failed = torch.zeros_like(run)
    a_i1 = torch.zeros_like(phi_0)
    phi_i1, dphi_i1 = phi_0, dphi_0
    a_star = torch.zeros_like(phi_0)
    phi_star, dphi_star, g_star = phi_0, dphi_0, gfk
    for i in range(1, maxiter + 1):
        act = ~done & run & ~failed
        if not bool(act.any()):
            break
        a_i = start if i == 1 else a_i1 * 2.
        phi_i, dphi_i, g_i = restricted(a_i)
        to_zoom1 = act & (wolfe_one(a_i, phi_i) | ((phi_i >= phi_i1) & (i > 1)))
        to_i = act & wolfe_two(dphi_i) & ~to_zoom1
        to_zoom2 = act & (dphi_i >= 0.) & ~to_zoom1 & ~to_i
        zoom = to_zoom1 | to_zoom2
        if bool(zoom.any()):
            # zoom 1 brackets (a_{i-1}, a_i), zoom 2 (a_i, a_{i-1})
            prev = (a_i1, phi_i1, dphi_i1)
            cur = (a_i, phi_i, dphi_i)
            lo = tuple(torch.where(to_zoom1, p, c) for p, c in zip(prev, cur))
            hi = tuple(torch.where(to_zoom1, c, p) for p, c in zip(prev, cur))
            zf, za, zphi, zdphi, zg = _zoom(restricted, wolfe_one, wolfe_two,
                                            lo, hi, gfk, zoom)
            failed = failed | (zoom & zf)
            a_star = torch.where(zoom, za, a_star)
            phi_star = torch.where(zoom, zphi, phi_star)
            dphi_star = torch.where(zoom, zdphi, dphi_star)
            g_star = _sel(zoom, zg, g_star)
        a_star = torch.where(to_i, a_i, a_star)
        phi_star = torch.where(to_i, phi_i, phi_star)
        dphi_star = torch.where(to_i, dphi_i, dphi_star)
        g_star = _sel(to_i, g_i, g_star)
        done = done | to_zoom1 | to_i | to_zoom2
        a_i1 = torch.where(act, a_i, a_i1)
        phi_i1 = torch.where(act, phi_i, phi_i1)
        dphi_i1 = torch.where(act, dphi_i, dphi_i1)
    failed = failed | ~done
    # float32 steps: jax's floor on |a_k|
    a_k = torch.where(torch.abs(a_star) < 1e-8, torch.sign(a_star) * 1e-8,
                      a_star)
    return failed, a_k, phi_star, g_star


def _bfgs(fg, x0, maxiter: int, gtol: float = 1e-5):
    """Minimise each row's objective from x0 (B, d): (x, f)."""
    B, d = x0.shape
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    H = eye.expand(B, d, d).clone()
    x = x0
    f, g = fg(x)
    converged = torch.amax(torch.abs(g), dim=-1) < gtol
    failed = torch.zeros_like(converged)
    old_old = f + torch.linalg.vector_norm(g, dim=-1) / 2
    for _ in range(maxiter):
        run = ~converged & ~failed
        if not bool(run.any()):
            break
        p = -(H @ g[..., None])[..., 0]
        ls_failed, a_k, f_new, g_new = _line_search(fg, x, p, f, old_old, g,
                                                    run)
        s = a_k[:, None] * p
        y = g_new - g
        rho = 1.0 / (y * s).sum(-1)
        w = eye - rho[:, None, None] * s[:, :, None] * y[:, None, :]
        H_new = (w @ H @ w.transpose(1, 2)
                 + rho[:, None, None] * s[:, :, None] * s[:, None, :])
        H_new = _sel(torch.isfinite(rho), H_new, H)
        failed = torch.where(run, ls_failed, failed)
        converged = torch.where(
            run, torch.amax(torch.abs(g_new), dim=-1) < gtol, converged)
        old_old = torch.where(run, f, old_old)
        x = _sel(run, x + s, x)
        f = torch.where(run, f_new, f)
        g = _sel(run, g_new, g)
        H = _sel(run, H_new, H)
    return x, f


def _ml_refine(nll, theta0, x, valid, iters: int = 60):
    """Refine a parameter start by BFGS on each row's NLL (the analogue of
    the reference's scipy MLE seeded by ``_fit_start``,
    xclim:indices/stats.py:576-684). Keeps the start where the refinement
    diverges or does not improve the likelihood."""
    def fg(theta):
        return _value_and_grad(nll, theta, x, valid)

    th, fun = _bfgs(fg, theta0, iters)
    better = (fun < nll(theta0, x, valid)) & torch.isfinite(th).all(-1)
    return _sel(better, th, theta0)


def _fit_genextreme_ml(x, axis, method):
    """GEV: L-moment start + per-cell BFGS maximum likelihood."""
    c0, loc0, sc0 = _fit_genextreme(x, axis, method)
    xf = x.movedim(axis, -1)
    sh = tuple(xf.shape[:-1])
    rows = xf.reshape(-1, xf.shape[-1])
    valid = ~torch.isnan(rows)
    rows0 = torch.where(valid, rows, 0.0)
    theta0 = torch.stack([c0.reshape(-1), loc0.reshape(-1),
                          torch.log(torch.clamp(sc0.reshape(-1), min=1e-10))],
                         dim=-1)
    th = _ml_refine(_gev_nll, theta0, rows0, valid)
    return (th[:, 0].reshape(sh), th[:, 1].reshape(sh),
            torch.exp(th[:, 2]).reshape(sh))


def _fit_weibull_ml(x, axis, method):
    """weibull_min: Cooke-1979-style start + per-cell BFGS ML
    (the reference's _fit_start recipe, xclim:indices/stats.py:633-638)."""
    xf = x.movedim(axis, -1)
    sh = tuple(xf.shape[:-1])
    rows = xf.reshape(-1, xf.shape[-1])
    valid = ~torch.isnan(rows)
    sd = torch.sqrt(_nanvar(rows, -1))
    loc0 = _nanmin(rows, -1) - 0.01 * sd
    sl = torch.log(torch.where(valid, rows - loc0[:, None], 1.0))
    nn = torch.clamp(valid.sum(-1), min=1)
    mu_l = torch.where(valid, sl, 0.0).sum(-1) / nn
    var_l = (torch.where(valid, (sl - mu_l[:, None]) ** 2, 0.0).sum(-1)
             / torch.clamp(nn - 1, min=1))
    c0 = _PI_SQRT6 / torch.sqrt(torch.clamp(var_l, min=1e-12))
    pw = torch.where(valid, (rows - loc0[:, None]) ** c0[:, None], 0.0)
    sc0 = (pw.sum(-1) / nn) ** (1.0 / c0)
    theta0 = torch.stack([torch.log(torch.clamp(c0, min=1e-6)), loc0,
                          torch.log(torch.clamp(sc0, min=1e-10))], dim=-1)
    rows0 = torch.where(valid, rows, 0.0)
    th = _ml_refine(_weibull_nll, theta0, rows0, valid)
    return (torch.exp(th[:, 0]).reshape(sh), th[:, 1].reshape(sh),
            torch.exp(th[:, 2]).reshape(sh))


_FITTERS = {
    "norm": _fit_norm,
    "expon": _fit_expon,
    "gamma": _fit_gamma,
    "lognorm": _fit_lognorm,
    "gumbel_r": _fit_gumbel,
    "genextreme": _fit_genextreme,
    "fisk": _fit_fisk,
    "weibull_min": _fit_weibull,
}

# true maximum-likelihood variants seeded by the closed-form estimates
# (used when method='ML'; 'PWM'/'APP' keep the closed forms)
_ML_FITTERS = {
    "genextreme": _fit_genextreme_ml,
    "weibull_min": _fit_weibull_ml,
}


def _gamma_ppf(p, a):
    """Inverse regularized lower incomplete gamma via Wilson-Hilferty start +
    Newton (unit scale)."""
    z = torch.special.ndtri(torch.clamp(_f32(p, a), 1e-7, 1 - 1e-7))
    x = a * (1 - 1 / (9 * a) + z / (3 * torch.sqrt(a))) ** 3
    x = torch.clamp(x, min=1e-8)
    for _ in range(6):
        f = _gammainc(a, x) - p
        pdf = torch.exp((a - 1) * torch.log(x) - x - torch.special.gammaln(a))
        x = torch.clamp(x - f / torch.clamp(pdf, min=1e-30), min=1e-10)
    return x


def _cdf(dist, params, x):
    if dist == "norm":
        loc, scale = params
        return torch.special.ndtr((x - loc) / scale)
    if dist == "expon":
        loc, scale = params
        return 1 - torch.exp(-torch.clamp(x - loc, min=0) / scale)
    if dist == "gamma":
        a, loc, scale = params
        return _gammainc(a, torch.clamp(x - loc, min=0) / scale)
    if dist == "lognorm":
        s, loc, scale = params
        z = torch.log(torch.clamp(x - loc, min=1e-30) / scale) / s
        return torch.where(x > loc, torch.special.ndtr(z), 0.0)
    if dist == "gumbel_r":
        loc, scale = params
        return torch.exp(-torch.exp(-(x - loc) / scale))
    if dist == "genextreme":
        c, loc, scale = params
        t = (x - loc) / scale
        arg = 1 - c * t
        inner = torch.where(arg > 0, arg ** (1.0 / c), 0.0)
        out = torch.exp(-inner)
        # support handling: for c>0 x<loc+scale/c, etc.
        return torch.where(arg <= 0, torch.where(c > 0, 1.0, 0.0), out)
    if dist == "fisk":
        c, loc, scale = params
        t = torch.clamp(x - loc, min=1e-30) / scale
        return torch.where(x > loc, 1 / (1 + t ** (-c)), 0.0)
    if dist == "weibull_min":
        c, loc, scale = params
        t = torch.clamp(x - loc, min=0) / scale
        return 1 - torch.exp(-(t ** c))
    raise NotImplementedError(dist)


def _ppf(dist, params, q):
    like = params[0]
    if dist == "norm":
        loc, scale = params
        return loc + scale * torch.special.ndtri(_f32(q, like))
    if dist == "expon":
        loc, scale = params
        return loc - scale * torch.log1p(-_f32(q, like))
    if dist == "gamma":
        a, loc, scale = params
        return loc + scale * _gamma_ppf(q, a)
    if dist == "lognorm":
        s, loc, scale = params
        return loc + scale * torch.exp(s * torch.special.ndtri(_f32(q, like)))
    if dist == "gumbel_r":
        loc, scale = params
        return loc - scale * torch.log(-torch.log(_f32(q, like)))
    if dist == "genextreme":
        c, loc, scale = params
        return loc + scale * (1 - (-torch.log(_f32(q, like))) ** c) / c
    if dist == "fisk":
        c, loc, scale = params
        return loc + scale * (q / (1 - q)) ** (1 / c)
    if dist == "weibull_min":
        c, loc, scale = params
        return loc + scale * (-torch.log1p(-_f32(q, like))) ** (1 / c)
    raise NotImplementedError(dist)


def _pdf(dist, params, x):
    eps = 1e-6
    return (_cdf(dist, params, x + eps) - _cdf(dist, params, x - eps)) / (2 * eps)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fit(da: ClimArray, dist: str = "norm", method: str = "ML",
        dim: str = "time", **fitkwargs) -> ClimArray:
    """Fit distribution parameters along `dim` (xclim:indices/stats.py:115).

    method 'ML'/'APP' → the closed-form estimator of each distribution
    (BFGS maximum likelihood for genextreme and weibull_min under 'ML');
    'PWM' → L-moments; 'MM' → moments; 'ML_scipy' → exact scipy MLE on the
    host (a loop over cells).
    """
    ax = da.dims.index(dim)
    names = DIST_PARAMS[dist] if dist in DIST_PARAMS else None
    if method == "ML_scipy" or dist not in _FITTERS:
        sp = get_dist(dist)
        vals = np.moveaxis(np.asarray(da.values, dtype=np.float64), ax, -1)
        flat = vals.reshape(-1, vals.shape[-1])
        outs = []
        for row in flat:
            r = row[~np.isnan(row)]
            if len(r) < 2:
                outs.append([np.nan] * sp.numargs + [np.nan, np.nan])
            else:
                outs.append(list(sp.fit(r, **fitkwargs)))
        arr = np.asarray(outs, dtype=np.float32)
        nparams = arr.shape[1]
        params = torch.as_tensor(
            arr.T.reshape((nparams,) + vals.shape[:-1]).copy(),
            device=da.device)
        if names is None:
            names = ([chr(ord("a") + i) for i in range(nparams - 2)]
                     + ["loc", "scale"])
    else:
        fitter = _ML_FITTERS.get(dist) if method in ("ML", "MLE") else None
        ptuple = (fitter or _FITTERS[dist])(da.data, ax, method)
        params = torch.stack(list(ptuple), dim=0)
    out_dims = ("dparams",) + tuple(d for d in da.dims if d != dim)
    coords = {c: v for c, v in da.coords.items() if c != dim}
    coords["dparams"] = np.asarray(names)
    # human-readable estimator name (xclim:indices/stats.py:156-164,208)
    method_name = {
        "ML": "maximum likelihood", "MLE": "maximum likelihood",
        "MM": "method of moments",
        "MSE": "maximum product of spacings",
        "MPS": "maximum product of spacings",
        "PWM": "probability weighted moments",
        "APP": "approximative method",
    }
    return ClimArray(params, out_dims, coords,
                     {"units": "", "scipy_dist": dist,
                      "method": method,
                      "estimator": method_name.get(
                          method.upper(), method).capitalize(),
                      "original_units": da.attrs.get("units", "")}, "params")


def _param_tuple(p: ClimArray):
    dax = p.dims.index("dparams")
    return tuple(p.data.select(dax, i) for i in range(p.shape[dax]))


def _over_values(p: ClimArray, fn, values, name, attrs):
    """fn(params, v) for each host value v, stacked on a new leading
    ``name`` axis."""
    params = _param_tuple(p)
    data = torch.stack([fn(params, float(v)) for v in values], dim=0)
    out_dims = (name,) + tuple(d for d in p.dims if d != "dparams")
    coords = {c: v for c, v in p.coords.items() if c != "dparams"}
    coords[name] = values
    return ClimArray(data, out_dims, coords, attrs, name)


def parametric_quantile(p: ClimArray, q, dist: str | None = None) -> ClimArray:
    """Quantiles from fitted parameters (xclim:indices/stats.py:221)."""
    dist = dist or p.attrs["scipy_dist"]
    qa = np.atleast_1d(np.asarray(q, dtype=np.float32))
    return _over_values(p, lambda prm, v: _ppf(dist, prm, v), qa, "quantile",
                        {"units": p.attrs.get("original_units", "")})


def parametric_cdf(p: ClimArray, v) -> ClimArray:
    """CDF at values v from fitted parameters (xclim:indices/stats.py:297)."""
    dist = p.attrs["scipy_dist"]
    va = np.atleast_1d(np.asarray(v, dtype=np.float32))
    return _over_values(p, lambda prm, x: _cdf(dist, prm, x), va, "cdf",
                        {"units": ""})


def parametric_pdf(p: ClimArray, v) -> ClimArray:
    """PDF at values v from fitted parameters (xclim:indices/stats.py:363)."""
    dist = p.attrs["scipy_dist"]
    va = np.atleast_1d(np.asarray(v, dtype=np.float32))
    return _over_values(p, lambda prm, x: _pdf(dist, prm, x), va, "pdf",
                        {"units": ""})


def fa(da: ClimArray, t, dist: str = "genextreme", mode: str = "max",
       method: str = "PWM") -> ClimArray:
    """Return levels for return periods t (xclim:indices/stats.py:429)."""
    ta = np.atleast_1d(np.asarray(t, dtype=np.float32))
    q = 1.0 - 1.0 / ta if mode in ("max", "high") else 1.0 / ta
    p = fit(da, dist=dist, method=method)
    out = parametric_quantile(p, q, dist)
    out.coords["return_period"] = ta
    out.dims = ("return_period",) + out.dims[1:]
    out.coords.pop("quantile", None)
    out.attrs["units"] = da.attrs.get("units", "")
    return out


def frequency_analysis(da: ClimArray, mode: str, t, dist: str, window: int = 1,
                       freq: str | None = "YS", method: str = "PWM",
                       **indexer) -> ClimArray:
    """Block-extreme frequency analysis (xclim:indices/stats.py:485)."""
    from xclim_tpu_torch.ops.segments import rolling_reduce

    sel = da.select_time(**indexer)
    x = sel
    if window > 1:
        x = sel.copy(data=rolling_reduce(sel.data, window, "mean",
                                         axis=sel.time_axis))
    block = getattr(x.resample(freq or "YS"),
                    "max" if mode in ("max", "high") else "min")()
    block.attrs["units"] = da.attrs.get("units", "")
    return fa(block, t, dist=dist, mode=mode, method=method)


def dist_method(function: str, fit_params: ClimArray, arg=None, **kwargs):
    """Call a distribution method with fitted params (xclim:indices/stats.py:713)."""
    if function == "cdf":
        return parametric_cdf(fit_params, arg)
    if function == "ppf":
        return parametric_quantile(fit_params, arg)
    if function == "pdf":
        return parametric_pdf(fit_params, arg)
    raise NotImplementedError(function)


# ---------------------------------------------------------------------------
# standardized indices (SPI / SPEI / SSI / SGI machinery)
# (xclim:indices/stats.py:770-1197)
# ---------------------------------------------------------------------------


def preprocess_standardized_index(da: ClimArray, freq: str | None = "MS",
                                  window: int = 1) -> tuple[ClimArray, str]:
    """Resample to target freq and apply a rolling accumulation window
    (xclim:indices/stats.py:770)."""
    from xclim_tpu_torch.ops.segments import rolling_reduce

    group = "time.dayofyear" if freq in (None, "D") else "time.month"
    if freq is not None:
        da = da.resample(freq).mean()
        da.attrs["units"] = da.attrs.get("units", "")
    if window > 1:
        da = da.copy(data=rolling_reduce(da.data, window, "mean",
                                         axis=da.time_axis))
    return da, group


def standardized_index_fit_params(ref: ClimArray, freq: str | None, window: int,
                                  dist: str, method: str = "APP",
                                  zero_inflated: bool = True, **indexer) -> ClimArray:
    """Fit per-group distribution params for a standardized index
    (xclim:indices/stats.py:839)."""
    from xclim_tpu_torch.sdba.grouping import Grouper
    from xclim_tpu_torch.sdba.utils import gather_groups

    ref, group = preprocess_standardized_index(ref, freq, window)
    grouper = Grouper(group)
    xf = ref.data.movedim(ref.time_axis, 0)
    g = gather_groups(xf, grouper.device_train_table(ref.time, xf.device))
    # probability of zero (zero-inflated distributions, e.g. precipitation)
    nvalid = (~torch.isnan(g)).sum(dim=1)
    if zero_inflated:
        p_zero = (g == 0).sum(dim=1) / torch.clamp(nvalid, min=1)
        gpos = torch.where(g > 0, g, torch.nan)
    else:
        p_zero = torch.zeros(nvalid.shape, dtype=torch.float32,
                             device=g.device)
        gpos = g
    meth = {"ML": "ML", "APP": "ML", "PWM": "PWM", "MM": "MM"}.get(method,
                                                                   method)
    params = torch.stack(list(_FITTERS[dist](gpos, 1, meth)), dim=0)
    names = DIST_PARAMS[dist]
    out_dims = ("dparams", grouper.prop) + tuple(d for d in ref.dims
                                                 if d != "time")
    coords = {c: v for c, v in ref.coords.items() if c != "time"}
    coords["dparams"] = np.asarray(names + ["p_zero"])
    coords[grouper.prop] = np.arange(params.shape[1])
    full = torch.cat([params, p_zero[None].to(params.dtype)], dim=0)
    return ClimArray(full, out_dims, coords,
                     {"units": "", "scipy_dist": dist, "group": group,
                      "freq": freq or "", "window": window,
                      "zero_inflated": int(zero_inflated),
                      "estimator": method,
                      "original_units": ref.attrs.get("units", "")}, "params")


def standardized_index(da: ClimArray, params: ClimArray | None = None,
                       freq: str | None = "MS", window: int = 1,
                       dist: str = "gamma", method: str = "APP",
                       zero_inflated: bool = True, cal_start=None, cal_end=None,
                       **indexer) -> ClimArray:
    """Standardized index (SPI-style): probability-transform each value
    through its group's fitted CDF, then the standard normal PPF
    (xclim:indices/stats.py:971)."""
    from xclim_tpu_torch.sdba.grouping import Grouper

    if params is None:
        ref = da
        if cal_start is not None or cal_end is not None:
            years = da.time.year
            mask = np.ones(len(years), dtype=bool)
            if cal_start is not None:
                mask &= years >= int(str(cal_start)[:4])
            if cal_end is not None:
                mask &= years <= int(str(cal_end)[:4])
            ref = da.sel_time(mask=mask)
        params = standardized_index_fit_params(ref, freq, window, dist,
                                               method=method,
                                               zero_inflated=zero_inflated)
    dist = params.attrs["scipy_dist"]
    freq = params.attrs.get("freq") or None
    window = int(params.attrs.get("window", 1))
    zero_inflated = bool(params.attrs.get("zero_inflated", 1))
    da, group = preprocess_standardized_index(da, freq, window)
    grouper = Grouper(params.attrs.get("group", group))
    gid = grouper.group_of_step(da.time)
    dax = params.dims.index("dparams")
    gax = params.dims.index(grouper.prop)
    # per-step params: gather the group axis
    gid_clip = np.minimum(gid, params.shape[gax] - 1)
    psel = torch.index_select(
        params.data, gax,
        torch.as_tensor(gid_clip.astype(np.int64), device=params.device))
    psel = psel.movedim(dax, 0)                 # dparams × T × ...
    nparams = len(DIST_PARAMS[dist])
    ptuple = tuple(psel[i] for i in range(nparams))
    p_zero = psel[nparams]
    x = da.data.movedim(da.time_axis, 0)
    cdf = _cdf(dist, ptuple, x)
    if zero_inflated:
        prob = torch.where(x > 0, p_zero + (1 - p_zero) * cdf, p_zero / 2)
    else:
        prob = cdf
    prob = torch.clamp(prob, 5e-4, 1 - 5e-4)  # clamp like the reference (8.21 sigma)
    si = torch.special.ndtri(prob)
    si = torch.where(torch.isnan(x), torch.nan, si)
    out = da.copy(data=si.movedim(0, da.time_axis))
    out.attrs = {"units": "", "calibration_period": [
        params.attrs.get("cal_start", ""), params.attrs.get("cal_end", "")]}
    return out
