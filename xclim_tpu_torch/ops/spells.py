"""Spell statistics over contiguous time segments: the spells kernel.

One pass over the time axis gives, per segment (a resample period) and grid
cell, four float32 counts: the days where the condition holds (``cnt``),
the days inside runs of at least ``window`` such days (``wrc``), the number
of those runs (``wre``) and the longest run (``lng``). Runs reset at each
segment start (resample-before-run-length) and NaN counts as False, as in
the reference's ``fused_spell_stats`` (xclim_tpu/ops/pallas/spells.py).

:func:`spell_stats` takes a float32 series with ``op``/``thresh`` (``x op
thresh``) or a bool condition, with time on any axis:

* on a CUDA tensor it launches the hand-written kernel ``csrc/spells.cu``
  (one thread per batch, segment and group of 4 or 1 neighbouring cells,
  as the input allows; few long segments cut into parts in time and
  joined by a second kernel) and raises if the launch fails. The tensor
  is read in place as (B, T, C) in its own memory order: a condition
  whose batch axis lies outside the time axis in memory, as the
  bootstrap's (replacement, time, cells) condition does, is passed with
  its batch stride and not copied;
* on a CPU tensor it runs :func:`spell_stats_plain`, the plain PyTorch twin:
  run lengths from a running maximum of break positions, then segment sums
  and maxima by gather.

``launches`` counts the calls that ran on the card (one call is one
kernel launch, or two when segments are cut in time); ``twin_calls`` the
calls the twin served.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.utils.profiling import span

__all__ = ["OPS", "spell_stats", "spell_stats_plain", "time_parts"]

#: calls of spell_stats that ran on the card
launches = 0
#: calls spell_stats served with the plain twin (CPU tensors)
twin_calls = 0

#: comparison codes of csrc/spells.cu; 4 reads a bool condition
OPS = {">": 0, ">=": 1, "<": 2, "<=": 3}
_MASK = 4
_CMP = {">": torch.greater, ">=": torch.greater_equal, "<": torch.less,
        "<=": torch.less_equal}
#: threads below which the kernel cuts each segment into parts in time
#: (132 SMs x 16 warps), and the fewest days a part keeps
SPLIT_THREADS = 132 * 16 * 32
SPLIT_DAYS = 64
#: elements (cells x time) of one chunk of the twin's temporaries
_TWIN_CHUNK = 1 << 25


def _check(x: torch.Tensor, starts, counts, window: int, op, thresh,
           axis: int):
    """(starts, counts) as int64 host arrays, after checking every input."""
    if x.dtype == torch.bool:
        if op is not None or thresh is not None:
            raise ValueError("a bool condition takes no op or thresh")
    elif x.dtype == torch.float32:
        if op not in OPS or thresh is None:
            raise ValueError(f"float32 input needs op in {sorted(OPS)} and a "
                             f"thresh, got op={op!r}, thresh={thresh!r}")
    else:
        raise TypeError(f"x must be float32 or bool, got {x.dtype}")
    if x.ndim == 0 or not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for shape {tuple(x.shape)}")
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    s = np.asarray(starts, dtype=np.int64)
    n = np.asarray(counts, dtype=np.int64)
    if s.shape != n.shape or s.ndim != 1:
        raise ValueError("starts and counts must be 1-D of one length")
    T = x.shape[axis]
    if len(s) and (s.min() < 0 or n.min() < 0 or (s + n).max() > T
                   or np.any(s[1:] < s[:-1] + n[:-1])):
        raise ValueError(f"segments must be ordered, disjoint and inside "
                         f"the time axis of {T}")
    return s, n


def _btc_view(x: torch.Tensor, axis: int):
    """x as a contiguous (B, T, C) view of its own memory (a copy only when
    x is not dense, e.g. broadcast), and the function that puts a (B, nseg,
    C) result back as x's shape with the time axis replaced by nseg."""
    xt = x.movedim(axis, 0)
    T = xt.shape[0]
    order = sorted(range(xt.ndim), key=lambda d: -xt.stride(d))
    xp = xt.permute(order)
    if not xp.is_contiguous():
        xp = xp.contiguous()
    k = order.index(0)
    outer, inner = tuple(xp.shape[:k]), tuple(xp.shape[k + 1:])
    view = xp.reshape(math.prod(outer), T, math.prod(inner))
    inverse = [order.index(d) for d in range(xt.ndim)]

    def restore(out: torch.Tensor) -> torch.Tensor:
        nseg = out.shape[1]
        return out.reshape(outer + (nseg,) + inner).permute(inverse).movedim(
            0, axis)

    return view, restore


def spell_stats(x: torch.Tensor, starts, counts, window: int, op=None,
                thresh=None, axis: int = 0):
    """(cnt, wrc, wre, lng) over the segments ``[starts[s], starts[s] +
    counts[s])`` of the time axis ``axis``.

    ``x`` is float32 with ``op`` in ``> >= < <=`` and ``thresh`` (the day is
    True where ``x op thresh``; NaN is False), or a bool condition with
    neither. ``starts``/``counts`` are host integer sequences (a
    SegmentSpec's), ordered and disjoint. Each output is float32, x's shape
    with the time axis replaced by the segment axis, on x's device.
    """
    global launches, twin_calls
    with span("op.spells"):
        starts, counts = _check(x, starts, counts, window, op, thresh, axis)
        if x.device.type == "cpu":
            twin_calls += 1
            return spell_stats_plain(x, starts, counts, window, op, thresh, axis)
        if x.device.type != "cuda":
            raise ValueError(f"no spells kernel for device {x.device}")
        v, restore = _btc_view(x, axis)
        if v.dtype == torch.bool:
            v = v.view(torch.uint8)
        B, T, C = v.shape
        nseg = len(starts)
        outs = [torch.empty((B, nseg, C), dtype=torch.float32, device=v.device)
                for _ in range(4)]
        if B * nseg * C == 0:
            return tuple(restore(o.zero_()) for o in outs)
        st, ct = (_build.device_copy(a.astype(np.int32).tobytes(),
                                     torch.int32, v.device)
                  for a in (starts, counts))
        code = _MASK if op is None else OPS[op]
        nparts = time_parts(B, nseg, C, counts)
        scratch = torch.empty((6 * B * nseg * nparts * C if nparts > 1 else 0,),
                              dtype=torch.int32, device=v.device)
        _build.launch("spells", "xtt_spells_parts", "pifippppppqiiiip",
                      v.device, v.data_ptr(), code, float(thresh or 0.0),
                      int(window), st.data_ptr(), ct.data_ptr(),
                      *(o.data_ptr() for o in outs), B, T, nseg, C, nparts,
                      scratch.data_ptr() if nparts > 1 else None)
        launches += 1
        return tuple(restore(o) for o in outs)


def time_parts(B: int, nseg: int, C: int, counts) -> int:
    """Parts the kernel cuts each segment into in time: 1 while B * nseg *
    C threads reach SPLIT_THREADS, else enough parts to reach it, each of
    at least SPLIT_DAYS days of the longest segment."""
    rows = B * nseg * C
    if rows >= SPLIT_THREADS or rows == 0:
        return 1
    longest = int(np.max(counts)) if len(counts) else 0
    return max(1, min(-(-SPLIT_THREADS // rows), longest // SPLIT_DAYS))


def spell_stats_plain(x: torch.Tensor, starts, counts, window: int, op=None,
                      thresh=None, axis: int = 0):
    """Plain PyTorch twin of the kernel, on x's device.

    Cells go first, time last (scans along the contiguous axis). The run
    length at day t is t minus the last day before it that broke the run (a
    False day, or the day before a segment start): a running maximum of
    those break positions. The length of each run sits on its last day;
    one gather of the segment table (padded with a day past the end, which
    holds no run) then gives per segment the True days, the days and the
    number of runs of at least ``window``, and the longest run. The cells
    go in chunks so the temporaries stay bounded.
    """
    starts, counts = _check(x, starts, counts, window, op, thresh, axis)
    b = x if op is None else _CMP[op](x, thresh)
    bt = b.movedim(axis, 0)
    T, rest = bt.shape[0], tuple(bt.shape[1:])
    bc = bt.reshape(T, -1).T                                # (C, T)
    C, nseg, dev = bc.shape[0], len(starts), x.device
    maxlen = int(counts.max()) if nseg else 0
    tbl = np.full((nseg, maxlen), T, dtype=np.int64)
    for s, (a, n) in enumerate(zip(starts.tolist(), counts.tolist())):
        tbl[s, :n] = np.arange(a, a + n)
    gidx = torch.as_tensor(tbl.reshape(-1), device=dev)
    # first[t]: t starts a segment; cut[t]: a run cannot go on past t (the
    # next day starts a segment, t ends one, or t is the last day)
    first = np.zeros(T + 1, dtype=bool)
    first[starts] = True
    cut = first[1:].copy()
    cut[(starts + counts - 1)[counts > 0]] = True
    cut[T - 1] = True
    first = torch.as_tensor(first[:T], device=dev)
    cut = torch.as_tensor(cut, device=dev)
    t = torch.arange(T, dtype=torch.int32, device=dev)
    outs = [torch.zeros((nseg, C), dtype=torch.float32, device=dev)
            for _ in range(4)]
    step = max(1, _TWIN_CHUNK // max(T, 1))
    for c0 in range(0, C, step):
        on = bc[c0:c0 + step].contiguous()
        breaks = torch.where(on, torch.where(first, t - 1, -1), t)
        run = torch.where(on, t - torch.cummax(breaks, dim=1).values, 0)
        nxt = torch.cat([on[:, 1:], torch.zeros_like(on[:, :1])], dim=1)
        ends = on & (~nxt | cut)
        pad = torch.zeros_like(run[:, :1])
        length = torch.cat([torch.where(ends, run, 0), pad], dim=1)[:, gidx]
        length = length.reshape(-1, nseg, maxlen)
        onday = torch.cat([on, pad.bool()], dim=1)[:, gidx].reshape(
            -1, nseg, maxlen)
        hit = length >= window
        sl = slice(c0, c0 + step)
        outs[0][:, sl] = onday.sum(2, dtype=torch.int32).T.float()
        outs[1][:, sl] = torch.where(hit, length, 0).sum(
            2, dtype=torch.int32).T.float()
        outs[2][:, sl] = hit.sum(2, dtype=torch.int32).T.float()
        if maxlen:
            outs[3][:, sl] = length.amax(2).T.float()
    return tuple(o.reshape((nseg,) + rest).movedim(0, axis) for o in outs)
