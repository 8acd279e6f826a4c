"""Bias-adjustment methods: EQM, DQM, QDM, Scaling, LOCI, ExtremeValues and
the N-dimensional pdf transfer (reference: the external xsdba package
re-exported as xclim.sdba — xclim:src/xclim/sdba.py:1-28; train/adjust
contract per xclim docs/sdba.rst:23-56).

Training is one static group-gather + batched quantile per input (the
windowed day-of-year quantile kernel for ``time.dayofyear``); adjustment is
a group gather, a rank or quantile lookup and a linear interpolation over
the quantile axis. Trained state is an explicit dict of tensors (``.ds``)
on the data's device, saved to and loaded from the reference's ``.npz``
layout.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import xclim_tpu_torch
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, str2pint
from xclim_tpu_torch.indices.stats import _lmoments
from xclim_tpu_torch.ops import eqmadjust, qdmadjust
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.sdba.grouping import Grouper
from xclim_tpu_torch.sdba.utils import (
    equally_spaced_nodes,
    gather_groups,
    generator_or_default,
    grouped_rank,
    interp_hat_nodes,
    interp_on_quantiles,
    windowed_doy_mean,
    windowed_doy_quantile,
)
from xclim_tpu_torch.utils.profiling import span

__all__ = ["EmpiricalQuantileMapping", "DetrendedQuantileMapping",
           "QuantileDeltaMapping", "Scaling", "LOCI", "ExtremeValues",
           "npdf_transform", "random_rotation_matrices",
           "from_reference_state"]


def _spacify(*arrays):
    """Flatten all trailing space dims into one lane axis.

    (G, K, *S) → (G, K, prod(S)); 1-D series (G, K) → (G, K, 1). Returns the
    original space shape so callers can reshape back with
    ``a.reshape(a.shape[:2] + sshape)``."""
    sshape = tuple(arrays[0].shape[2:])
    out = [a.reshape(tuple(a.shape[:2]) + (-1,)) if a.ndim > 2 else a[..., None]
           for a in arrays]
    return out, sshape


def _apply_kind(x, factor, kind):
    return x + factor if kind == "+" else x * factor


def _inv_kind(a, b, kind):
    """Adjustment factor between a and b: a - b or a / b."""
    if kind == "+":
        return a - b
    return a / torch.where(b == 0, torch.nan, b)


def _grouped_quantile_tf(xf, table, q, alpha=1.0, beta=1.0):
    """(G, nq, ...) quantiles of a time-first tensor under a gather table."""
    g = gather_groups(xf, table)
    out = nan_quantile(g, q, axis=1, alpha=alpha, beta=beta)  # (nq, G, ...)
    return out.movedim(0, 1)


def _grouped_mean_tf(xf, table):
    g = gather_groups(xf, table)
    ok = ~torch.isnan(g)
    s = torch.where(ok, g, 0.0).sum(dim=1)
    n = ok.sum(dim=1)
    return torch.where(n > 0, s / torch.clamp(n, min=1), torch.nan)  # (G, ...)


def _qm_train_core(xref, xhist, tref, thist, q, *, kind):
    ref_q = _grouped_quantile_tf(xref, tref, q)
    hist_q = _grouped_quantile_tf(xhist, thist, q)
    return _inv_kind(ref_q, hist_q, kind), hist_q


def _qm_train_core_doy(xref, xhist, dtref, dthist, *, q, kind, window):
    """Day-of-year windowed trainer on the winquantile op (the kernel on the
    card, its twin on the CPU): no windowed gather in device memory."""
    q = np.asarray(q, dtype=np.float32)
    ref_q = windowed_doy_quantile(xref, dtref, window, q)
    hist_q = windowed_doy_quantile(xhist, dthist, window, q)
    return _inv_kind(ref_q, hist_q, kind), hist_q


def _dqm_train_core(xref, xhist, tref, thist, gid_hist, q, *, kind):
    with span("sdba.scaling"):
        scaling = _inv_kind(_grouped_mean_tf(xref, tref),
                            _grouped_mean_tf(xhist, thist), kind)  # (G, ...)
        xh_sc = _apply_kind(xhist, scaling[gid_hist], kind)
    ref_q = _grouped_quantile_tf(xref, tref, q)
    hist_q = _grouped_quantile_tf(xh_sc, thist, q)
    return _inv_kind(ref_q, hist_q, kind), hist_q, scaling


def _dqm_train_core_doy(xref, xhist, dtref, dthist, gid_hist, *, q, kind,
                        window):
    """DQM's day-of-year trainer: windowed means for the scaling, then the
    winquantile op on ref and on the scaled hist."""
    q = np.asarray(q, dtype=np.float32)
    with span("sdba.scaling"):
        scaling = _inv_kind(windowed_doy_mean(xref, dtref, window),
                            windowed_doy_mean(xhist, dthist, window), kind)
        xh_sc = _apply_kind(xhist, scaling[gid_hist], kind)
    ref_q = windowed_doy_quantile(xref, dtref, window, q)
    hist_q = windowed_doy_quantile(xh_sc, dthist, window, q)
    return _inv_kind(ref_q, hist_q, kind), hist_q, scaling


@span("sdba.eqm")
def _eqm_adjust_body(xf, table, flat_pos, hist_q, af, *, kind, interp,
                     extrapolation):
    """EQM adjust on a time-first tensor; returns the time-first result.

    Runs the eqmadjust op (the kernel on the card, its twin on the CPU):
    one pass over the series, each group's steps read and written through
    ``table`` (``flat_pos`` is not needed)."""
    sshape = tuple(xf.shape[1:])
    xf2 = xf.reshape(xf.shape[0], -1)
    hq2 = hist_q.reshape(tuple(hist_q.shape[:2]) + (-1,))
    af2 = af.reshape(tuple(af.shape[:2]) + (-1,))
    out = eqmadjust.eqm_adjust_series(xf2, table, hq2, af2, kind=kind,
                                      extrapolation=extrapolation)
    return out.reshape((out.shape[0],) + sshape)


def _qdm_adjust_core(xf, table, flat_pos, af, q, *, kind, interp,
                     extrapolation):
    g = gather_groups(xf, table)
    (g, af), sshape = _spacify(g, af)
    nvalid = (~torch.isnan(g)).sum(dim=1)
    tau = grouped_rank(g, nvalid)  # (G, ms, C)
    if interp == "linear" and extrapolation == "constant":
        af_v = interp_hat_nodes(tau, q, af)
    else:
        qx = q.reshape((1, -1) + (1,) * (af.ndim - 2)).expand(af.shape)
        af_v = interp_on_quantiles(tau, qx, af, method=interp,
                                   extrapolation=extrapolation)
    adj = _apply_kind(g, af_v, kind)
    adj = adj.reshape(tuple(adj.shape[:2]) + sshape)
    flat = adj.reshape((-1,) + tuple(adj.shape[2:]))
    return flat[flat_pos]


def _qdm_adjust_core_doy(xf, table, af, *, q, kind):
    """QDM adjust on the qdmadjust op (the kernel on the card, its twin on
    the CPU): one pass over the time-first series, each group's steps read
    and written through ``table``."""
    sshape = tuple(xf.shape[1:])
    xf2 = xf.reshape(xf.shape[0], -1)
    af2 = af.reshape(tuple(af.shape[:2]) + (-1,))
    out = qdmadjust.qdm_adjust_series(xf2, table, af2, q, kind=kind)
    return out.reshape((out.shape[0],) + sshape)


def _dqm_adjust_core(xf, V, gid, table, flat_pos, hist_q, af, scaling, *,
                     kind, interp, extrapolation):
    """Scale → detrend → EQM → retrend, in the spans ``sdba.scaling``,
    ``sdba.detrend`` (the fit, its solve, the re-centred trend; again for
    the retrend) and ``sdba.eqm``. xf time-first; V is the centered/scaled
    Vandermonde (T, deg+1)."""
    with span("sdba.scaling"):
        x_sc = _apply_kind(xf, scaling[gid], kind)
    with span("sdba.detrend"):
        T = x_sc.shape[0]
        flat = x_sc.reshape(T, -1)
        valid = ~torch.isnan(flat)
        f0 = torch.where(valid, flat, 0.0)
        VtV = torch.einsum("ti,tj,tc->cij", V, V, valid.to(torch.float32))
        Vty = torch.einsum("ti,tc->ci", V, f0)
        eye = torch.eye(V.shape[1], dtype=V.dtype, device=V.device)
        coef = torch.linalg.solve(VtV + 1e-8 * eye[None],
                                  Vty[..., None])[..., 0]
        trend = torch.einsum("ti,ci->tc", V, coef).reshape(x_sc.shape)
        # per-cell re-centering (a global scalar saturates the quantile
        # lookup off-table on spatially heterogeneous grids)
        tmean = torch.nanmean(trend, dim=0, keepdim=True)
        if kind == "+":
            detrended = x_sc - trend + tmean
        else:
            detrended = x_sc / torch.where(trend == 0, torch.nan,
                                           trend) * tmean
    out = _eqm_adjust_body(detrended, table, flat_pos, hist_q, af, kind=kind,
                           interp=interp, extrapolation=extrapolation)
    with span("sdba.detrend"):
        if kind == "+":
            return out + (trend - tmean)
        return out * trend / tmean


class TrainAdjust:
    """Train-once, adjust-many base class (xsdba.TrainAdjust)."""

    _allow_diff_calendars = True

    def __init__(self, ds: dict, **params):
        self.ds = ds
        for k, v in params.items():
            setattr(self, k, v)

    @classmethod
    def train(cls, ref: ClimArray, hist: ClimArray, **kwargs):
        with span("sdba.train"):
            with span("sdba.units"):
                hist = convert_units_to(hist, ref, context="infer")
            group = Grouper(kwargs.pop("group", "time"), kwargs.pop("window", 1)) \
                if not isinstance(kwargs.get("group"), Grouper) else kwargs.pop("group")
            obj = cls._train(ref, hist, group=group, **kwargs)
            obj.train_units = ref.attrs.get("units", "")
            return obj

    def adjust(self, sim: ClimArray, **kwargs):
        with span("sdba.adjust"):
            with span("sdba.units"):
                sim = convert_units_to(sim, self.train_units, context="infer")
            out = self._adjust(sim, **kwargs)
            with span("sdba.attrs"):
                out.attrs = dict(sim.attrs)
                out.attrs["units"] = self.train_units
                out.attrs["history"] = (
                    sim.attrs.get("history", "")
                    + f"\nBias-adjusted with {type(self).__name__}"
                    f"(group={self.group.group}, kind={self.kind}).")
                out.name = sim.name
            return out


class EmpiricalQuantileMapping(TrainAdjust):
    """EQM: adjustment factors between ref and hist quantiles per group
    (xsdba.EmpiricalQuantileMapping; xclim docs/sdba.rst).

    train: af(q) = ref_q(q) ∘ hist_q(q)⁻¹; adjust: sim + af(F_hist(sim)).
    """

    @classmethod
    def _train(cls, ref, hist, *, group: Grouper, nquantiles: int = 20,
               kind: str = "+"):
        q = equally_spaced_nodes(nquantiles) if np.isscalar(nquantiles) \
            else np.asarray(nquantiles)
        xref = ref.data.movedim(ref.time_axis, 0)
        xhist = hist.data.movedim(hist.time_axis, 0)
        dev = xref.device
        if group.group == "time.dayofyear":
            af, hist_q = _qm_train_core_doy(
                xref, xhist, group.device_doy_table(ref.time, dev),
                group.device_doy_table(hist.time, dev), q=q, kind=kind,
                window=group.window)
        else:
            af, hist_q = _qm_train_core(
                xref, xhist, group.device_train_table(ref.time, dev),
                group.device_train_table(hist.time, dev),
                torch.as_tensor(q, dtype=torch.float32, device=dev),
                kind=kind)
        return cls({"af": af, "hist_q": hist_q, "quantiles": np.asarray(q)},
                   group=group, kind=kind)

    def _adjust(self, sim: ClimArray, interp: str = "linear",
                extrapolation: str = "constant"):
        ax = sim.time_axis
        xf = sim.data.movedim(ax, 0)
        table, gid, flat_pos = self.group.device_adjust_table(sim.time,
                                                              xf.device)
        out = _eqm_adjust_body(xf, table, flat_pos, self.ds["hist_q"],
                               self.ds["af"], kind=self.kind, interp=interp,
                               extrapolation=extrapolation)
        return sim.copy(data=out.movedim(0, ax))


class DetrendedQuantileMapping(TrainAdjust):
    """DQM: mean-scaling + EQM on scaled data + linear detrend of sim
    (xsdba.DetrendedQuantileMapping)."""

    @classmethod
    def _train(cls, ref, hist, *, group: Grouper, nquantiles: int = 20,
               kind: str = "+"):
        q = equally_spaced_nodes(nquantiles) if np.isscalar(nquantiles) \
            else np.asarray(nquantiles)
        xref = ref.data.movedim(ref.time_axis, 0)
        xhist = hist.data.movedim(hist.time_axis, 0)
        dev = xref.device
        gid_hist = group.device_group_of_step(hist.time, dev)
        if group.group == "time.dayofyear":
            af, hist_q, scaling = _dqm_train_core_doy(
                xref, xhist, group.device_doy_table(ref.time, dev),
                group.device_doy_table(hist.time, dev), gid_hist, q=q,
                kind=kind, window=group.window)
        else:
            af, hist_q, scaling = _dqm_train_core(
                xref, xhist, group.device_train_table(ref.time, dev),
                group.device_train_table(hist.time, dev), gid_hist,
                torch.as_tensor(q, dtype=torch.float32, device=dev),
                kind=kind)
        return cls({"af": af, "hist_q": hist_q, "scaling": scaling,
                    "quantiles": np.asarray(q)}, group=group, kind=kind)

    def _adjust(self, sim: ClimArray, interp: str = "linear",
                extrapolation: str = "constant", detrend: int = 1):
        # scale by training factors, polynomial-detrend over decimal years
        # (multiplicative series detrend as a ratio around the trend, xsdba
        # PolyDetrend kind), EQM with the trained factors, retrend
        ax = sim.time_axis
        xf = sim.data.movedim(ax, 0)
        dev = xf.device
        table, gid, flat_pos = self.group.device_adjust_table(sim.time, dev)
        t_np = sim.time.decimal_year.astype(np.float64)
        t_np = t_np - t_np.mean()
        scale = np.abs(t_np).max()
        if scale > 0:
            t_np = t_np / scale
        V = torch.as_tensor(np.stack([t_np ** k for k in range(detrend + 1)],
                                     axis=1).astype(np.float32), device=dev)
        out = _dqm_adjust_core(xf, V, gid, table, flat_pos, self.ds["hist_q"],
                               self.ds["af"], self.ds["scaling"],
                               kind=self.kind, interp=interp,
                               extrapolation=extrapolation)
        return sim.copy(data=out.movedim(0, ax))


class QuantileDeltaMapping(TrainAdjust):
    """QDM: af at the simulation's own empirical rank — preserves sim deltas
    (xsdba.QuantileDeltaMapping, Cannon et al. 2015)."""

    _train = EmpiricalQuantileMapping.__dict__["_train"]

    def _adjust(self, sim: ClimArray, interp: str = "linear",
                extrapolation: str = "constant"):
        ax = sim.time_axis
        xf = sim.data.movedim(ax, 0)
        table, gid, flat_pos = self.group.device_adjust_table(sim.time,
                                                              xf.device)
        qn = np.asarray(self.ds["quantiles"], dtype=np.float32)
        # the reference's shape rule for its fused kernel
        if (interp == "linear" and extrapolation == "constant"
                and self.kind in ("+", "*")
                and table.shape[1] <= qdmadjust.MAX_Y
                and xf.dtype == torch.float32):
            out = _qdm_adjust_core_doy(xf, table, self.ds["af"], q=qn,
                                       kind=self.kind)
        else:
            out = _qdm_adjust_core(xf, table, flat_pos, self.ds["af"],
                                   torch.as_tensor(qn, device=xf.device),
                                   kind=self.kind, interp=interp,
                                   extrapolation=extrapolation)
        return sim.copy(data=out.movedim(0, ax))


class Scaling(TrainAdjust):
    """Simple per-group mean scaling (xsdba.Scaling)."""

    @classmethod
    def _train(cls, ref, hist, *, group: Grouper, kind: str = "+"):
        scaling = _inv_kind(_grouped_mean(ref, group),
                            _grouped_mean(hist, group), kind)
        return cls({"af": scaling}, group=group, kind=kind)

    def _adjust(self, sim: ClimArray, interp: str = "nearest"):
        return _apply_scaled(sim, self.ds["af"], self.group, self.kind)


def _loci_train_core(xref, xhist, tref, thist, *, th):
    """Per-group exceedance matching + scaling factors."""
    gr = gather_groups(xref, tref)
    gh = gather_groups(xhist, thist)
    # exceedance probability of thresh in ref, per group
    wet = torch.where(torch.isnan(gr), torch.nan, (gr >= th).to(torch.float32))
    frac = torch.nanmean(wet, dim=1)  # (G, ...)
    # hist threshold at the same exceedance probability
    q = torch.clamp(1.0 - frac, 0.0, 1.0)
    gh_qfirst = gh.movedim(1, 0)  # (maxlen, G, ...)
    s = torch.sort(gh_qfirst, dim=0).values
    nvalid = (~torch.isnan(gh_qfirst)).sum(dim=0)
    # Hyndman-Fan type-7 on the valid prefix, vectorized over groups
    h = q * (nvalid - 1)
    lo = torch.clamp(torch.floor(h).to(torch.int64), 0, s.shape[0] - 1)
    hi = torch.clamp(lo + 1, 0, s.shape[0] - 1)
    w = h - lo
    top = torch.minimum(hi, torch.clamp(nvalid - 1, min=0))
    s_thresh = (s.gather(0, lo[None])[0] * (1 - w)
                + s.gather(0, top[None])[0] * w)
    s_thresh = torch.where(nvalid > 0, s_thresh, torch.nan)
    # mean exceedance ratio
    mr = torch.nanmean(torch.where(gr >= th, gr, torch.nan), dim=1) - th
    mh = torch.nanmean(torch.where(gh >= s_thresh[:, None], gh, torch.nan),
                       dim=1) - s_thresh
    af = mr / torch.where(mh == 0, torch.nan, mh)
    return af, s_thresh


class LOCI(TrainAdjust):
    """Local intensity scaling (Schmidli et al. 2006; xsdba.LOCI).

    train: per group, find the hist threshold with the same exceedance
    probability as `thresh` in ref, then the scaling factor equating mean
    exceedances. adjust: ``max(af * (sim - s_thresh) + thresh, 0)``.
    Designed for precipitation (wet-day intensity matching).
    """

    @classmethod
    def _train(cls, ref, hist, *, group: Grouper, thresh: str = "1 mm/d"):
        th = convert_units_to(str2pint(thresh), ref, context="infer") \
            if isinstance(thresh, str) else float(thresh)
        xref = ref.data.movedim(ref.time_axis, 0)
        xhist = hist.data.movedim(hist.time_axis, 0)
        dev = xref.device
        af, s_thresh = _loci_train_core(
            xref, xhist, group.device_train_table(ref.time, dev),
            group.device_train_table(hist.time, dev), th=float(th))
        return cls({"af": af, "hist_thresh": s_thresh}, group=group,
                   kind="*", thresh=th)

    def _adjust(self, sim: ClimArray, interp: str = "linear"):
        ax = sim.time_axis
        xf = sim.data.movedim(ax, 0)
        gid = self.group.device_group_of_step(sim.time, xf.device)
        out = torch.clamp(self.ds["af"][gid] * (xf - self.ds["hist_thresh"][gid])
                          + float(self.thresh), min=0.0)
        return sim.copy(data=out.movedim(0, ax))


def _grouped_mean(da: ClimArray, grouper: Grouper) -> torch.Tensor:
    """(G, ...) NaN-mean of each group of da's time steps."""
    xf = da.data.movedim(da.time_axis, 0)
    return _grouped_mean_tf(xf, grouper.device_train_table(da.time, xf.device))


def _apply_scaled(da: ClimArray, scaling, grouper: Grouper,
                  kind: str) -> ClimArray:
    ax = da.time_axis
    gid = grouper.device_group_of_step(da.time, da.data.device)
    sc = scaling[gid].movedim(0, ax)  # (T, ...) -> time at ax
    return da.copy(data=_apply_kind(da.data, sc, kind))


# ---------------------------------------------------------------------------
# ExtremeValues: GPD-based second-pass correction of the far tail
# ---------------------------------------------------------------------------


def _gpd_fit_lmom(y, axis):
    """Generalized-Pareto (location 0) L-moment fit of exceedances.

    Hosking parameterization F(y) = 1 − (1 − k·y/σ)^(1/k); k = λ1/λ2 − 2,
    σ = λ1(1+k). NaN-aware along `axis`."""
    l1, l2, _, n = _lmoments(y, axis)
    k = l1 / torch.where(l2 == 0, torch.nan, l2) - 2.0
    return k, l1 * (1 + k), n


def _gpd_cdf(y, k, sigma):
    s = torch.where(sigma <= 0, torch.nan, sigma)
    z = y / s
    small = torch.abs(k) < 1e-6
    arg = torch.clamp(1 - k * z, min=1e-12)
    gen = 1 - arg ** (1 / torch.where(small, 1.0, k))
    expo = 1 - torch.exp(-z)
    out = torch.where(small, expo, gen)
    return torch.clamp(torch.where(y <= 0, 0.0, out), 0.0, 1.0)


def _gpd_ppf(p, k, sigma):
    s = torch.where(sigma <= 0, torch.nan, sigma)
    small = torch.abs(k) < 1e-6
    pc = torch.clamp(p, 1e-9, 1 - 1e-9)
    gen = s / torch.where(small, 1.0, k) * (1 - (1 - pc) ** k)
    expo = -s * torch.log(1 - pc)
    return torch.where(small, expo, gen)


def _cluster_maxima(xf, u):
    """Per-lane maxima of runs of ``x > u``.

    xf: (T, C) time-major; returns (C, E) cluster maxima, NaN padded
    (E = T//2 + 1, the worst case of alternating exceedances), reduced by
    ``scatter_reduce("amax")`` into ``C * E + 1`` slots that start at -inf."""
    T, C = xf.shape
    E = T // 2 + 1
    above = xf > u
    prev = torch.cat([torch.zeros_like(above[:1]), above[:-1]], dim=0)
    starts = above & ~prev
    eid = torch.cumsum(starts.to(torch.int64), dim=0) - 1
    cell = torch.arange(C, dtype=torch.int64, device=xf.device)[None, :]
    ids = torch.where(above & (eid < E), cell * E + torch.clamp(eid, 0, E - 1),
                      C * E).reshape(-1)
    vals = torch.where(above, xf, -torch.inf).reshape(-1)
    mx = torch.full((C * E + 1,), -torch.inf, dtype=xf.dtype, device=xf.device)
    mx.scatter_reduce_(0, ids, vals, "amax", include_self=False)
    mx = mx[:-1].reshape(C, E)
    return torch.where(torch.isinf(mx), torch.nan, mx)


def _ev_train_core(xf2, *, u, q_thresh):
    """Declustered POT + L-moment GPD fit."""
    cm = _cluster_maxima(xf2, u)  # (C, E)
    th = nan_quantile(cm.T, [q_thresh], axis=0)[0]  # (C,)
    exc = torch.where(cm > th[:, None], cm - th[:, None], torch.nan)
    k, s, n = _gpd_fit_lmom(exc, axis=-1)
    return k, s, n, th


def _ev_adjust_core(x, scen, th_h, th_r, k_h, s_h, k_r, s_r, *, frac, power):
    y = torch.clamp(x - th_h, min=0.0)
    ph = _gpd_cdf(y, k_h, s_h)
    transformed = th_r + _gpd_ppf(ph, k_r, s_r)
    # weight: 0 until the (1-frac) exceedance probability of the POT
    # level, ramping to 1 for the most extreme values
    w = torch.clamp((ph - (1 - frac)) / frac, 0.0, 1.0) ** power
    w = torch.where(x > th_h, w, 0.0)
    valid = ~torch.isnan(transformed)
    return torch.where(valid, (1 - w) * scen + w * transformed, scen)


class ExtremeValues(TrainAdjust):
    """Second-order adjustment of extreme values via Generalized-Pareto
    transfer (xsdba.ExtremeValues; Roy et al. 2023 method family).

    train: cluster maxima (one max per run of consecutive exceedances of
    ``cluster_thresh`` — the declustering step), a per-cell peaks-over-
    threshold level at the ``q_thresh`` quantile of those maxima, then
    L-moment GPD fits of the exceedances over that level.
    adjust(scen, sim, frac, power): sim extremes above hist's POT level map
    through ``thresh_ref + GPD_ref⁻¹(GPD_hist(sim − thresh_hist))`` with
    weight = (clip(F_hist − (1 − frac), 0, frac)/frac)^power.
    """

    @classmethod
    def _train(cls, ref, hist, *, cluster_thresh="1 mm/d",
               q_thresh: float = 0.95, group="time"):
        u = convert_units_to(str2pint(cluster_thresh), ref) \
            if isinstance(cluster_thresh, str) else float(cluster_thresh)
        gr = group if isinstance(group, Grouper) else Grouper(group)

        def fit_one(da):
            xf = da.data.movedim(da.time_axis, 0)
            shp = tuple(xf.shape[1:])
            k, s, n, th = _ev_train_core(xf.reshape(xf.shape[0], -1),
                                         u=float(u), q_thresh=float(q_thresh))
            rs = (lambda a: a.reshape(shp)) if shp else (lambda a: a[0])
            return rs(k), rs(s), rs(n), rs(th)

        kr, sr, nr, thr = fit_one(ref)
        kh, sh, nh, thh = fit_one(hist)
        return cls({"k_ref": kr, "s_ref": sr, "k_hist": kh, "s_hist": sh,
                    "n_ref": nr, "n_hist": nh,
                    "thresh_ref": thr, "thresh_hist": thh},
                   group=gr, kind="+", cluster_thresh=u)

    def _adjust(self, sim: ClimArray, scen: ClimArray = None,
                frac: float = 0.25, power: float = 1.0):
        if scen is None:
            scen = sim
        out = _ev_adjust_core(sim.data, scen.data, self.ds["thresh_hist"],
                              self.ds["thresh_ref"], self.ds["k_hist"],
                              self.ds["s_hist"], self.ds["k_ref"],
                              self.ds["s_ref"], frac=float(frac),
                              power=float(power))
        res = scen.copy(data=out)
        res.attrs = dict(scen.attrs)
        return res

    def adjust(self, scen: ClimArray, sim: ClimArray, frac: float = 0.25,
               power: float = 1.0):
        """Blend a first-pass scen with GPD-transferred sim extremes
        (signature per the reference: adjust(scen, sim, frac, power))."""
        sim = convert_units_to(sim, self.train_units, context="infer")
        scen = convert_units_to(scen, self.train_units, context="infer")
        out = self._adjust(sim, scen=scen, frac=frac, power=power)
        out.attrs["units"] = self.train_units
        out.attrs["history"] = (
            scen.attrs.get("history", "")
            + "\nExtreme values adjusted with ExtremeValues "
            f"(cluster_thresh={self.cluster_thresh}, frac={frac}, "
            f"power={power}).")
        return out


# ---------------------------------------------------------------------------
# N-dimensional pdf transfer (MBCn core; Cannon 2018)
# ---------------------------------------------------------------------------


def random_rotation_matrices(generator: torch.Generator, n_iter: int,
                             nvar: int) -> torch.Tensor:
    """(n_iter, nvar, nvar) uniform random orthogonal matrices via QR of
    gaussians drawn from ``generator``, on its device (xsdba
    utils.rand_rot_matrix)."""
    a = torch.randn((n_iter, nvar, nvar), generator=generator,
                    device=generator.device)
    qm, r = torch.linalg.qr(a)
    # sign-correct for a proper Haar draw
    return qm * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]


def npdf_transform(ref: ClimArray, hist: ClimArray, sim: ClimArray = None,
                   *, n_iter: int = 20, nquantiles: int = 50, generator=None,
                   rotations=None, base=None, return_escores: bool = False):
    """N-dimensional pdf transfer: iterative random rotations + 1-D quantile
    mapping (the core of MBCn, Cannon 2018; xsdba.NpdfTransform).

    ref, hist, sim: stacked ``(multivar, time)`` ClimArrays (see
    :func:`xclim_tpu_torch.sdba.processing.stack_variables`); inputs should
    be standardized (the algorithm works in an additive space). Each
    iteration takes an orthogonal rotation, quantile-maps every rotated
    coordinate of hist (and sim) onto rotated ref with the `base` method
    (default QDM, additive), and rotates back. The rotations are
    ``rotations`` ((n_iter, nvar, nvar), e.g. the reference's own draw)
    or drawn from ``generator`` (:func:`random_rotation_matrices`; a
    generator seeded with 0 on ref's device when None). Returns
    (hist_adj, sim_adj[, escores]).
    """
    from xclim_tpu_torch.sdba.processing import escore as _escore

    if base is None:
        base = QuantileDeltaMapping
    nvar = ref.shape[0]
    dev = ref.data.device
    if rotations is None:
        rots = random_rotation_matrices(generator_or_default(generator, dev),
                                        n_iter, nvar)
    else:
        rots = torch.as_tensor(np.asarray(rotations, dtype=np.float32),
                               device=dev)
        n_iter = rots.shape[0]

    hdat = hist.data
    sdat = sim.data if sim is not None else None
    escores = []

    def _mat(mat, time):
        # (nvar, T) -> one (T, nvar) array: every rotated coordinate is a
        # lane of the same quantile-mapping call
        return ClimArray(mat.T, ("time", "multivar"), {"time": time},
                         {"units": ""}, "v")

    for i in range(n_iter):
        R = rots[i]
        r_r = R @ ref.data
        h_r = R @ hdat
        adj = base.train(_mat(r_r, ref.time), _mat(h_r, hist.time),
                         group="time", nquantiles=nquantiles, kind="+")
        hdat = R.T @ adj.adjust(_mat(h_r, hist.time)).data.T
        if sdat is not None:
            sdat = R.T @ adj.adjust(_mat(R @ sdat, sim.time)).data.T
        if return_escores:
            escores.append(_escore(ref, hist.copy(data=hdat), N=500))

    hist_adj = hist.copy(data=hdat)
    sim_adj = sim.copy(data=sdat) if sim is not None else None
    if return_escores:
        return hist_adj, sim_adj, escores
    return hist_adj, sim_adj


# ---------------------------------------------------------------------------
# trained-state persistence: the reference's .npz layout, so that either
# package loads the other's checkpoints
# ---------------------------------------------------------------------------


def _save_trained(obj: TrainAdjust, path):
    """Serialize a trained adjustment object to ``.npz``.

    Metadata travels as a JSON string in a unicode array — never pickled —
    so checkpoints load with ``allow_pickle=False``."""
    meta = {"__class__": type(obj).__name__,
            "__group__": obj.group.group,
            "__window__": obj.group.window,
            "__kind__": getattr(obj, "kind", "+"),
            "__train_units__": getattr(obj, "train_units", "")}
    extra = {f"__{attr}__": np.float64(getattr(obj, attr))
             for attr in ("thresh", "cluster_thresh") if hasattr(obj, attr)}
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in obj.ds.items()}
    np.savez(path, __meta__=np.array(json.dumps(meta)), **extra, **arrays)


def _load_trained(path, device=None):
    """Load a trained adjustment object saved with ``.save()`` by either
    package; its tensors go to ``device`` (default: ``default_device()``)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"][()]))
    cls = {c.__name__: c for c in
           (EmpiricalQuantileMapping, DetrendedQuantileMapping,
            QuantileDeltaMapping, Scaling, LOCI,
            ExtremeValues)}[meta["__class__"]]
    if device is None:
        device = xclim_tpu_torch.default_device()
    ds = {}
    params = {"group": Grouper(meta["__group__"], meta["__window__"]),
              "kind": meta["__kind__"]}
    for k in data.files:
        if k == "__meta__":
            continue
        if k.startswith("__") and k.endswith("__"):
            params[k.strip("_")] = float(data[k])
        elif k == "quantiles":
            ds[k] = np.asarray(data[k])
        else:
            ds[k] = torch.as_tensor(data[k], device=device)
    obj = cls(ds, **params)
    obj.train_units = meta["__train_units__"]
    return obj


TrainAdjust.save = _save_trained
TrainAdjust.load = classmethod(
    lambda cls, path, device=None: _load_trained(path, device))


def from_reference_state(cls, ds: dict, *, group, kind: str,
                         train_units: str, device, **params) -> TrainAdjust:
    """An adjustment object of the port from the JAX package's trained state.

    ds: the reference object's ``.ds`` as numpy arrays (EQM/QDM: ``af``,
    ``hist_q``, ``quantiles``; DQM adds ``scaling``; Scaling: ``af``; LOCI:
    ``af``, ``hist_thresh``; ExtremeValues: ``k_ref``, ``s_ref``,
    ``k_hist``, ``s_hist``, ``n_ref``, ``n_hist``, ``thresh_ref``,
    ``thresh_hist``); group: a :class:`Grouper` or its group string;
    params: the object's scalars (LOCI's ``thresh``, ExtremeValues'
    ``cluster_thresh``). The arrays move to ``device`` as float32 tensors;
    the quantile nodes stay a host array, as the trainers keep them.
    """
    state = {k: (np.asarray(v) if k == "quantiles" else
                 torch.tensor(np.asarray(v, dtype=np.float32),
                              device=device))
             for k, v in ds.items()}
    grp = group if isinstance(group, Grouper) else Grouper(group)
    obj = cls(state, group=grp, kind=kind, **params)
    obj.train_units = train_units
    return obj
