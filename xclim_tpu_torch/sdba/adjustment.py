"""Bias-adjustment methods: EQM and QDM
(reference: the external xsdba package re-exported as xclim.sdba —
xclim:src/xclim/sdba.py:1-28; train/adjust contract per xclim docs/sdba.rst:23-56).

Training is one static group-gather + batched quantile per input (the
windowed day-of-year quantile kernel for ``time.dayofyear``); adjustment is
a group gather, a rank or quantile lookup and a linear interpolation over
the quantile axis. Trained state is an explicit dict of tensors (``.ds``)
on the data's device.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to
from xclim_tpu_torch.ops import qdmadjust
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.sdba.grouping import Grouper
from xclim_tpu_torch.sdba.utils import (
    equally_spaced_nodes,
    gather_groups,
    grouped_rank,
    interp_hat_nodes,
    interp_on_quantiles,
    windowed_doy_quantile,
)

__all__ = ["EmpiricalQuantileMapping", "QuantileDeltaMapping",
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


def _eqm_adjust_body(xf, table, flat_pos, hist_q, af, *, kind, interp,
                     extrapolation):
    """EQM adjust on a time-first tensor; returns the time-first result."""
    g = gather_groups(xf, table)
    (g, hist_q, af), sshape = _spacify(g, hist_q, af)
    af_v = interp_on_quantiles(g, hist_q, af, method=interp,
                               extrapolation=extrapolation)  # (G, ms, C)
    adj = _apply_kind(g, af_v, kind)
    adj = adj.reshape(tuple(adj.shape[:2]) + sshape)
    flat = adj.reshape((-1,) + tuple(adj.shape[2:]))
    return flat[flat_pos]


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


class TrainAdjust:
    """Train-once, adjust-many base class (xsdba.TrainAdjust)."""

    _allow_diff_calendars = True

    def __init__(self, ds: dict, **params):
        self.ds = ds
        for k, v in params.items():
            setattr(self, k, v)

    @classmethod
    def train(cls, ref: ClimArray, hist: ClimArray, **kwargs):
        hist = convert_units_to(hist, ref, context="infer")
        group = Grouper(kwargs.pop("group", "time"), kwargs.pop("window", 1)) \
            if not isinstance(kwargs.get("group"), Grouper) else kwargs.pop("group")
        obj = cls._train(ref, hist, group=group, **kwargs)
        obj.train_units = ref.attrs.get("units", "")
        return obj

    def adjust(self, sim: ClimArray, **kwargs):
        sim = convert_units_to(sim, self.train_units, context="infer")
        out = self._adjust(sim, **kwargs)
        out.attrs = dict(sim.attrs)
        out.attrs["units"] = self.train_units
        out.attrs["history"] = (sim.attrs.get("history", "") +
                                f"\nBias-adjusted with {type(self).__name__}"
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


def from_reference_state(cls, ds: dict, *, group, kind: str,
                         train_units: str, device) -> TrainAdjust:
    """An adjustment object of the port from the JAX package's trained state.

    ds: the reference object's ``.ds`` as numpy arrays (``af``, ``hist_q``,
    ``quantiles``); group: a :class:`Grouper` or its group string. The
    factors move to ``device`` as float32 tensors; the quantile nodes stay a
    host array, as :meth:`EmpiricalQuantileMapping._train` keeps them.
    """
    state = {k: (np.asarray(v) if k == "quantiles" else
                 torch.tensor(np.asarray(v, dtype=np.float32),
                              device=device))
             for k, v in ds.items()}
    grp = group if isinstance(group, Grouper) else Grouper(group)
    obj = cls(state, group=grp, kind=kind)
    obj.train_units = train_units
    return obj
