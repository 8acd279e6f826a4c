"""Fused EQM adjust: each value's bracket among its group's quantile nodes,
the interpolated factor and its application.

EQM's adjust step (reference: xsdba.EmpiricalQuantileMapping.adjust; DQM
runs it on the detrended series) places every simulated value among its
group's trained ``hist_q`` nodes and interpolates the trained factors
``af`` there. :func:`eqm_adjust_series` runs it on the (T, C) series
itself, with the group table of
:meth:`~xclim_tpu_torch.sdba.grouping.Grouper.adjust_table`: each value is
read and its result written at its own time step, so neither the group
gather nor the un-gather makes a pass of its own.

On a CUDA tensor it launches the hand-written kernel ``csrc/eqmadjust.cu``
(a thread a cell, a group and a span of its slots a block, the nodes
counted against a chunk of values held in registers) and raises if the
launch fails. The kernel stages the block's node tiles in shared memory
when they fit (:func:`tables_in_shared`: up to 454 nodes) and reads the
nodes from global memory otherwise; both routes are the kernel, counted
apart in ``shared_launches`` and ``global_launches``. Each launch counts
one ``eqm_node_passes``: one pass over the values. On a CPU tensor it runs
the plain twin :func:`eqm_adjust_series_plain` (:func:`gather_groups`,
:func:`interp_on_quantiles`, the kind and the scatter), whose bracketing
counts one ``eqm_node_passes`` a node. sdba's adjustments use
:func:`interp_on_quantiles` too (``xclim_tpu_torch.sdba.utils`` exports
it).

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.ops.qdmadjust import _take_nodes, gather_groups
from xclim_tpu_torch.utils.profiling import count, span

__all__ = ["eqm_adjust_series", "eqm_adjust_series_plain",
           "interp_on_quantiles", "tables_in_shared"]

#: calls of eqm_adjust_series that ran on the card
launches = 0
#: of those, the calls whose node tiles the kernel staged in shared memory
shared_launches = 0
#: and those whose nodes it read from global memory
global_launches = 0
#: calls served with the plain twin (CPU tensors)
twin_calls = 0

#: cells of one block of the kernel (a thread each)
CELLS = 64
#: shared memory a block may use after the opt-in (bytes)
SMEM_BYTES = 227 * 1024


def tables_in_shared(nq: int) -> bool:
    """Whether the kernel stages the block's (nq, cells) tiles of hist_q
    and af in shared memory."""
    return 2 * nq * CELLS * 4 <= SMEM_BYTES


def eqm_adjust_series(xf2: torch.Tensor, table: torch.Tensor,
                      hist_q: torch.Tensor, af: torch.Tensor, kind: str = "+",
                      extrapolation: str = "constant") -> torch.Tensor:
    """Adjusted values of a (T, C) series, grouped by ``table``.

    xf2: (T, C) sim; table: (G, S) integer time indices, -1 where a group
    has no step, holding every step 0..T-1 exactly once (the first table of
    :meth:`Grouper.adjust_table
    <xclim_tpu_torch.sdba.grouping.Grouper.adjust_table>`); hist_q, af: (G,
    nq, C) trained nodes and factors, sorted along nq. Returns (T, C) on
    xf2's device: af interpolated at each value's place among its group's
    hist_q (linear; the weight clamped into [0, 1] for ``extrapolation``
    "constant") and applied with ``kind``; NaN where xf2 is. A step the
    table does not hold is left unwritten. Any float dtype on the CPU;
    the card takes float32.
    """
    global twin_calls
    with span("op.eqmadjust"):
        if kind not in ("+", "*"):
            raise ValueError(f"kind must be '+' or '*', got {kind!r}")
        if xf2.ndim != 2 or table.ndim != 2:
            raise ValueError("xf2 must be (T, C) and table (G, S)")
        if table.dtype.is_floating_point or table.dtype == torch.bool:
            raise TypeError(f"table must hold integers, got {table.dtype}")
        G = table.shape[0]
        T, C = xf2.shape
        for name, t in (("hist_q", hist_q), ("af", af)):
            if t.ndim != 3 or t.shape[0] != G or t.shape[2] != C:
                raise ValueError(f"{name} shape {tuple(t.shape)} does not "
                                 f"match (G, nq, C) = ({G}, nq, {C})")
        if hist_q.shape != af.shape:
            raise ValueError(f"hist_q {tuple(hist_q.shape)} and af "
                             f"{tuple(af.shape)} differ")
        nq = hist_q.shape[1]
        if nq < 2:
            raise ValueError("at least two quantile nodes are needed")
        for t in (table, hist_q, af):
            if t.device != xf2.device:
                raise ValueError(f"xf2 on {xf2.device} but an argument on "
                                 f"{t.device}")
        if not all(t.dtype.is_floating_point for t in (xf2, hist_q, af)):
            raise TypeError(f"xf2, hist_q and af must be floating point, got "
                            f"{xf2.dtype}, {hist_q.dtype}, {af.dtype}")
        if xf2.device.type == "cpu":
            twin_calls += 1
            return eqm_adjust_series_plain(xf2, table, hist_q, af, kind,
                                           extrapolation)
        if not all(t.dtype == torch.float32 for t in (xf2, hist_q, af)):
            raise TypeError(f"the card takes float32, got {xf2.dtype}, "
                            f"{hist_q.dtype}, {af.dtype}")
        x = xf2.contiguous()
        out = torch.empty_like(x)
        _launch(x, table.to(torch.int32).contiguous(), hist_q.contiguous(),
                af.contiguous(), out, kind, extrapolation)
        return out


def _launch(x, rows, hq, af, out, kind, extrapolation):
    global launches, shared_launches, global_launches
    if x.device.type != "cuda":
        raise ValueError(f"no eqmadjust kernel for device {x.device}")
    G, S = rows.shape
    nq = hq.shape[1]
    if out.numel() == 0 or G == 0 or S == 0:
        return
    shared = tables_in_shared(nq)
    _build.launch("eqmadjust", "xtt_eqmadjust", "pppppiiiiiii", x.device,
                  x.data_ptr(), rows.data_ptr(), hq.data_ptr(), af.data_ptr(),
                  out.data_ptr(), G, S, x.shape[1], nq, int(kind == "*"),
                  int(extrapolation == "constant"), int(shared))
    launches += 1
    if shared:
        shared_launches += 1
    else:
        global_launches += 1
    count("eqm_node_passes")


def eqm_adjust_series_plain(xf2: torch.Tensor, table: torch.Tensor,
                            hist_q: torch.Tensor, af: torch.Tensor,
                            kind: str = "+",
                            extrapolation: str = "constant") -> torch.Tensor:
    """Plain PyTorch twin of :func:`eqm_adjust_series`, on xf2's device:
    the group gather, :func:`interp_on_quantiles`, the kind, and the
    scatter of each result to its own time step."""
    g = gather_groups(xf2, table)
    af_v = interp_on_quantiles(g, hist_q, af, extrapolation=extrapolation)
    adj = g + af_v if kind == "+" else g * af_v
    ok = table >= 0
    out = torch.empty_like(xf2)
    out[table[ok]] = adj[ok]
    return out


def interp_on_quantiles(x: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor,
                        method: str = "linear",
                        extrapolation: str = "constant") -> torch.Tensor:
    """y(x) by piecewise-linear interp of (xq → yq) along the quantile axis.

    x: (..., ms, C); xq, yq: (..., nq, C) sorted along -2. Constant
    extrapolation clamps to the edge values (xsdba default
    ``extrapolation='constant'``). The bracketing index is a comparison
    count over the nodes (NaN nodes compare False, i.e. count as greater),
    one pass over ``x`` a node, each counted as ``eqm_node_passes``.
    """
    nq = xq.shape[-2]
    # the narrowest count that holds nq: the loop reads and writes it once
    # a node
    cnt = torch.zeros(x.shape, device=x.device,
                      dtype=torch.int16 if nq < 2**15 else torch.int64)
    for k in range(nq):
        cnt += xq[..., k:k + 1, :] <= x
        count("eqm_node_passes")
    hi = torch.clamp(cnt, 1, nq - 1).to(torch.int64)
    lo = hi - 1
    x0 = _take_nodes(xq, lo)
    x1 = _take_nodes(xq, hi)
    y0 = _take_nodes(yq, lo)
    y1 = _take_nodes(yq, hi)
    denom = x1 - x0
    w = torch.where(denom != 0,
                    (x - x0) / torch.where(denom == 0, 1.0, denom), 0.0)
    if extrapolation == "constant":
        w = torch.clamp(w, 0.0, 1.0)
    y = y0 + w * (y1 - y0)
    return torch.where(torch.isnan(x), torch.nan, y)
