"""Fused QDM adjust: per-doy rank + adjustment-factor interpolation.

QDM's adjust step (reference: xsdba.QuantileDeltaMapping.adjust, Cannon et
al. 2015) ranks every simulated value within its (windowless) day-of-year
group and interpolates the trained adjustment factors at that empirical
rank. Two entries run it:

* :func:`qdm_adjust_doy` on the (n_doy, Y, C) doy slices;
* :func:`qdm_adjust_series` on the (T, C) series itself, with the group
  table of :meth:`~xclim_tpu_torch.sdba.grouping.Grouper.adjust_table`:
  the kernel reads each group's steps through the table and writes each
  result to its own time step, so neither the group gather nor the scatter
  back to the time axis makes a pass of its own (QDM's adjust path).

On a CUDA tensor each launches the hand-written kernel
``csrc/qdmadjust.cu`` (a thread per doy and cell, the ranks in registers,
each (n_valid, rank)'s bracket and weight from :func:`bracket_table`) and
raises if the launch fails. The kernel stages the block's factor tile
in shared memory when it fits (:func:`af_in_shared`: up to 95 nodes, or
382 above 32 slots) and reads the factors from global memory otherwise;
both routes are the kernel, counted apart in ``af_shared_launches`` and
``af_global_launches``. On a CPU tensor each
runs its plain PyTorch twin: :func:`qdm_adjust_doy_plain`
(:func:`grouped_rank` plus :func:`interp_hat_nodes`), and
:func:`qdm_adjust_series_plain` (:func:`gather_groups`, that, and the
scatter). sdba's adjustments use those three helpers too
(``xclim_tpu_torch.sdba.utils`` exports them).

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.utils.profiling import span

__all__ = ["qdm_adjust_doy", "qdm_adjust_doy_plain", "qdm_adjust_series",
           "qdm_adjust_series_plain", "af_in_shared", "bracket_table",
           "gather_groups", "grouped_rank", "interp_hat_nodes", "MAX_Y"]

#: calls of qdm_adjust_doy and qdm_adjust_series that ran on the card
launches = 0
#: of those, the calls whose factor tile the kernel staged in shared memory
af_shared_launches = 0
#: and those whose factors it read from global memory
af_global_launches = 0
#: calls served with a plain twin (CPU tensors)
twin_calls = 0

#: most year slots per doy group the kernel ranks (its registers)
MAX_Y = 64
#: threads of one block of the kernel
THREADS = 128
#: shared memory a block may use without an opt-in (bytes)
SMEM_BYTES = 48 * 1024


def af_in_shared(nq: int, Y: int) -> bool:
    """Whether the kernel stages the block's (nq, cells) factor tile in
    shared memory, beside the Y row indices: a block takes THREADS cells,
    or a quarter of that above 32 slots (four threads a cell)."""
    cells = THREADS // 4 if Y > 32 else THREADS
    return (nq * cells + Y) * 4 <= SMEM_BYTES


def bracket_table(q: np.ndarray, Y: int) -> np.ndarray:
    """(Y + 1, Y + 1, 2) int32: entry [n_valid, cnt] holds the bracket hi
    and the bits of the float32 weight w of rank cnt among n_valid values,

        tau = cnt / max(n_valid, 1);  tc = clip(tau, q[0], q[-1])
        hi = clip(#(q <= tc), 1, nq - 1)
        w = clip((tc - q[hi-1]) / (q[hi] - q[hi-1] or 1), 0, 1)

    each op one float32 rounding, as the twin's interp_hat_nodes does them
    (q non-decreasing, so the count is a right-sided search)."""
    q = np.asarray(q, dtype=np.float32)
    one = np.float32(1.0)
    nv = np.arange(Y + 1, dtype=np.float32)[:, None]
    cnt = np.arange(Y + 1, dtype=np.float32)[None, :]
    tau = cnt / np.maximum(nv, one)
    tc = np.minimum(np.maximum(tau, q[0]), q[-1])
    hi = np.clip(np.searchsorted(q, tc, side="right"), 1, len(q) - 1)
    x0 = q[hi - 1]
    denom = q[hi] - x0
    w = (tc - x0) / np.where(denom == 0, one, denom)
    w = np.minimum(np.maximum(w, np.float32(0.0)), one).astype(np.float32)
    return np.stack([hi.astype(np.int32), w.view(np.int32)], axis=-1)


def _check_q(q, kind: str) -> np.ndarray:
    q = np.asarray(q, dtype=np.float32).reshape(-1)
    if len(q) < 2:
        raise ValueError("at least two quantile nodes are needed")
    if not (np.diff(q) >= 0).all():
        raise ValueError("the quantile nodes must be non-decreasing")
    if kind not in ("+", "*"):
        raise ValueError(f"kind must be '+' or '*', got {kind!r}")
    return q


def _check_af(x: torch.Tensor, af: torch.Tensor, n_doy: int, nq: int, C: int):
    if x.dtype != torch.float32 or af.dtype != torch.float32:
        raise TypeError(f"x and af must be float32, got {x.dtype}, {af.dtype}")
    if af.ndim != 3 or tuple(af.shape) != (n_doy, nq, C):
        raise ValueError(f"af shape {tuple(af.shape)} does not match "
                         f"{(n_doy, nq, C)}")
    if af.device != x.device:
        raise ValueError(f"x on {x.device} but af on {af.device}")


def qdm_adjust_doy(xd: torch.Tensor, af: torch.Tensor, q,
                   kind: str = "+") -> torch.Tensor:
    """Adjusted values for doy-sliced sim data.

    xd: (n_doy, Y, C) float32 sim gathered to per-doy year slots (NaN
    padded); af: (n_doy, nq, C) trained adjustment factors; q: (nq,)
    non-decreasing nodes. Returns (n_doy, Y, C) on xd's device: af
    interpolated at each value's empirical within-group rank (linear,
    constant extrapolation) and applied with ``kind``; NaN where xd is.
    """
    global twin_calls
    with span("op.qdmadjust"):
        q = _check_q(q, kind)
        if xd.ndim != 3:
            raise ValueError("xd must be (n_doy, Y, C) and af (n_doy, nq, C)")
        n_doy, Y, C = xd.shape
        _check_af(xd, af, n_doy, len(q), C)
        if xd.device.type == "cpu":
            twin_calls += 1
            return qdm_adjust_doy_plain(xd, af, q, kind)
        x = xd.contiguous()
        out = torch.empty_like(x)
        _launch(x, None, af, q, kind, out, n_doy, Y, C)
        return out


def qdm_adjust_series(xf2: torch.Tensor, table: torch.Tensor, af: torch.Tensor,
                      q, kind: str = "+") -> torch.Tensor:
    """Adjusted values of a (T, C) series, grouped by ``table``.

    xf2: (T, C) float32 sim; table: (n_doy, Y) integer time indices, -1
    where a group has no step, holding every step 0..T-1 exactly once (the
    first table of :meth:`Grouper.adjust_table
    <xclim_tpu_torch.sdba.grouping.Grouper.adjust_table>`); af: (n_doy, nq,
    C); q: (nq,) non-decreasing nodes. Returns (T, C) on xf2's device:
    :func:`qdm_adjust_doy` of the gathered groups, each value written back
    to its own step. A step the table does not hold is left unwritten.
    """
    global twin_calls
    with span("op.qdmadjust"):
        q = _check_q(q, kind)
        if xf2.ndim != 2 or table.ndim != 2:
            raise ValueError("xf2 must be (T, C) and table (n_doy, Y)")
        if table.dtype.is_floating_point or table.dtype == torch.bool:
            raise TypeError(f"table must hold integers, got {table.dtype}")
        if table.device != xf2.device:
            raise ValueError(f"xf2 on {xf2.device} but table on {table.device}")
        n_doy, Y = table.shape
        T, C = xf2.shape
        _check_af(xf2, af, n_doy, len(q), C)
        if xf2.device.type == "cpu":
            twin_calls += 1
            return qdm_adjust_series_plain(xf2, table, af, q, kind)
        x = xf2.contiguous()
        out = torch.empty_like(x)
        _launch(x, table.to(torch.int32).contiguous(), af, q, kind, out, n_doy,
                Y, C)
        return out


def _launch(x, rows, af, q, kind, out, n_doy, Y, C):
    global launches, af_shared_launches, af_global_launches
    if x.device.type != "cuda":
        raise ValueError(f"no qdmadjust kernel for device {x.device}")
    if Y > MAX_Y:
        raise ValueError(f"too many year slots for the adjust kernel: {Y}")
    if out.numel() == 0 or n_doy == 0 or Y == 0:
        return
    a = af.contiguous()
    brk = _device_brackets(q.tobytes(), Y, x.device)
    shared = af_in_shared(len(q), Y)
    _build.launch("qdmadjust", "xtt_qdmadjust", "pppppiiiiii", x.device,
                  x.data_ptr(), 0 if rows is None else rows.data_ptr(),
                  a.data_ptr(), brk.data_ptr(), out.data_ptr(), n_doy, Y, C,
                  len(q), int(kind == "*"), int(shared))
    launches += 1
    if shared:
        af_shared_launches += 1
    else:
        af_global_launches += 1


@functools.lru_cache(maxsize=64)
def _device_brackets(q: bytes, Y: int, device: torch.device) -> torch.Tensor:
    """bracket_table on the device, built once per node set and Y."""
    table = bracket_table(np.frombuffer(q, dtype=np.float32), Y)
    return _build.device_copy(table.tobytes(), torch.int32, device)


def qdm_adjust_doy_plain(xd: torch.Tensor, af: torch.Tensor, q,
                         kind: str = "+") -> torch.Tensor:
    """Plain PyTorch twin: grouped_rank + interp_hat_nodes, on xd's device."""
    nvalid = (~torch.isnan(xd)).sum(dim=1)
    tau = grouped_rank(xd, nvalid)
    af_v = interp_hat_nodes(tau, q, af)
    return xd + af_v if kind == "+" else xd * af_v


def qdm_adjust_series_plain(xf2: torch.Tensor, table: torch.Tensor,
                            af: torch.Tensor, q,
                            kind: str = "+") -> torch.Tensor:
    """Plain PyTorch twin of :func:`qdm_adjust_series`, on xf2's device:
    the group gather, :func:`qdm_adjust_doy_plain`, and the scatter of each
    result to its own time step."""
    res = qdm_adjust_doy_plain(gather_groups(xf2, table), af, q, kind)
    ok = table >= 0
    out = torch.empty_like(xf2)
    out[table[ok]] = res[ok]
    return out


def gather_groups(xf: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Group-gather a time-first tensor with an integer table, NaN-padding
    the -1 slots. xf: (T, ...); table: (G, ms) → (G, ms, ...)."""
    g = xf[table.clamp(min=0)]
    ok = (table >= 0).reshape(tuple(table.shape) + (1,) * (g.ndim - 2))
    return torch.where(ok, g, torch.nan)


def grouped_rank(sim_g: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Empirical pct rank of each sample within its group (xsdba.utils.rank).

    sim_g: (G, ms, C) group-gathered values (NaN padded). Returns same-shape
    ranks in (0, 1]: rank = #(group ≤ v) / n_valid (max rank 1.0).

    Two formulations sharing the same tie semantics (upper count):

    * small groups (ms <= 128, the windowless adjust tables): a
      compare-count #(group <= v), accumulated one group member at a time;
    * large groups: one stable sort yields the permutation; the tie-run
      upper bound comes from a flipped cummin over the run ends; a scatter
      through the permutation un-sorts the counts.
    """
    ms = sim_g.shape[-2]
    n = torch.clamp(nvalid.unsqueeze(-2), min=1).to(torch.float32)
    if ms <= 128:
        cnt = torch.zeros(sim_g.shape, dtype=torch.int32, device=sim_g.device)
        for j in range(ms):
            cnt += sim_g[..., j:j + 1, :] <= sim_g
        return cnt.to(torch.float32) / n
    # NaNs sort last and never equal anything → their counts are inert
    S, perm = torch.sort(sim_g, dim=-2, stable=True)
    nxt_same = torch.cat([S[..., 1:, :] == S[..., :-1, :],
                          torch.zeros_like(S[..., :1, :], dtype=torch.bool)],
                         dim=-2)
    # #(group ≤ S[j]) = end of j's tie run + 1: the nearest run end at or
    # after j, by a reverse cummin over the run-end positions
    pos = torch.arange(1, ms + 1, dtype=torch.int64,
                       device=sim_g.device)[:, None]
    base = torch.where(nxt_same, torch.iinfo(torch.int64).max, pos)
    u = torch.flip(torch.cummin(torch.flip(base, dims=(-2,)), dim=-2).values,
                   dims=(-2,))
    cnt = torch.empty_like(u).scatter_(-2, perm, u)
    return cnt.to(torch.float32) / n


def _take_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes (..., nq, C) at per-element node index idx (..., ms, C)."""
    shape = torch.broadcast_shapes(tuple(nodes.shape[:-2]),
                                   tuple(idx.shape[:-2]))
    nodes = nodes.expand(shape + tuple(nodes.shape[-2:]))
    idx = idx.expand(shape + tuple(idx.shape[-2:]))
    return nodes.gather(-2, idx)


def interp_hat_nodes(tau: torch.Tensor, q, yq: torch.Tensor) -> torch.Tensor:
    """y(tau) by piecewise-linear interpolation on the SHARED sorted 1-D node
    vector ``q`` (not necessarily uniform):

        y = Σ_k φ_k(tau) · yq[k],   φ_k the hat on [q_{k-1}, q_k, q_{k+1}]

    tau: (G, ms, C); q: (nq,) strictly increasing; yq: (G, nq, C).
    Constant extrapolation (clamp into [q₀, q_{nq−1}]). The bracketing node
    is a comparison count over q; the two bracketing nodes and factors are
    gathered.
    """
    q = torch.as_tensor(q, dtype=torch.float32, device=tau.device)
    nq = q.shape[0]
    tc = torch.minimum(torch.maximum(tau, q[0]), q[-1])
    cnt = torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    for k in range(nq):
        cnt += q[k] <= tc
    hi = torch.clamp(cnt, 1, nq - 1)
    lo = hi - 1
    x0 = q[lo]
    x1 = q[hi]
    y0 = _take_nodes(yq, lo)
    y1 = _take_nodes(yq, hi)
    denom = x1 - x0
    w = (tc - x0) / torch.where(denom == 0, 1.0, denom)
    w = torch.clamp(w, 0.0, 1.0)
    out = y0 + w * (y1 - y0)
    return torch.where(torch.isnan(tau), torch.nan, out)
