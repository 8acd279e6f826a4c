"""What a traced run records: the benchmark's own spans, the device time
and bound of each call of a wrapped op entry, and a torch.profiler trace of
the calls profiled before the window, read from the profiler's raw events in
memory (no trace file is written).

A roofline metric's reader names an op entry of the program (``ENTRY``,
``"module:function"``) and how to count its work (``work(args, kwargs,
out) -> (bytes, operations)``). The entry is wrapped for the traced window
only, by setting the module attribute that callers reach it through, and
each call's device time is taken by CUDA events around it.
"""

from __future__ import annotations

import importlib
from collections import defaultdict

from perfbench import roofline

#: a device operation's name is cut to this length in the breakdown (a
#: templated kernel's full name runs to thousands of characters)
NAME_CHARS = 160


class EntryTimer:
    """Wraps op entries for the life of a ``with`` block; ``records[entry]``
    holds one {"start", "stop", "bound_ms", "bound_by"} a call."""

    def __init__(self, entries: dict):
        self.entries = entries          # "module:function" -> work function
        self.records = defaultdict(list)
        self._saved = []

    def __enter__(self):
        import torch

        for entry, work in self.entries.items():
            modname, attr = entry.split(":")
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)

            def timed(*args, _fn=fn, _entry=entry, _work=work, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kwargs)
                stop.record()
                nbytes, ops = _work(args, kwargs, out)
                self.records[_entry].append(
                    {"start": start, "stop": stop,
                     **roofline.bound(nbytes, ops)})
                return out

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def calls(self) -> dict:
        """entry -> [{"ms", "bound_ms", "bound_by"}] (after a synchronize)."""
        return {entry: [{"ms": r["start"].elapsed_time(r["stop"]),
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                        for r in recs]
                for entry, recs in self.records.items()}


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(events, times):
    """For each time (ascending), the name of the innermost event of the
    well-nested ``events`` [(start, end, name)] that covers it, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def read_profile(kineto_events, spans: set, calls: int, top: int = 10) -> dict:
    """Device busy time, kernel launches and the breakdown of a profiled
    stretch of ``calls`` calls, each wrapped in a ``call`` annotation and
    its stages in annotations named ``spans``.

    Returns {"window_s", "busy_s", "kernels", "calls", "device_ops",
    "idle_gaps"} (empty dict when the trace holds no ``call``). The window
    runs from the first call's start to the last call's end; busy is the
    union of the device's operations (kernels, copies, sets) in it; the
    idle gaps are labelled ``<span> / <host op>`` by the benchmark's span
    and the innermost host operation open when the gap began.
    """
    from torch.autograd import DeviceType

    call_iv, span_iv, host_ops, device = [], [], [], []
    for e in kineto_events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            # the annotations' own device-side ranges are no operation
            if name != "call" and name not in spans:
                device.append((s, t, name))
        elif name == "call":
            call_iv.append((s, t))
        elif name in spans:
            span_iv.append((s, t, name))
        else:
            host_ops.append((s, t, name))
    if not call_iv:
        return {}
    w0 = min(s for s, _ in call_iv)
    w1 = max(t for _, t in call_iv)
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device
              if t > w0 and s < w1]
    busy = _union((s, t) for s, t, _ in device)
    busy_ns = sum(t - s for s, t in busy)
    kernels = sum(1 for _, _, n in device
                  if not n.startswith(("Memcpy", "Memset")))
    by_op = defaultdict(int)
    for s, t, n in device:
        by_op[n] += t - s
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    starts = [g[0] for g in gaps]
    span_at = _innermost(span_iv, starts)
    op_at = _innermost(host_ops, starts)
    by_gap = defaultdict(int)
    for (s, t), sp, op in zip(gaps, span_at, op_at):
        by_gap[f"{sp or 'between calls'} / {op or 'python'}"] += t - s
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    ranked = [(n[:NAME_CHARS], v) for n, v in ranked]
    ranked_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernels": kernels, "calls": calls,
            "device_ops": [[n, v / 1e9] for n, v in ranked],
            "idle_gaps": [[n, v / 1e9] for n, v in ranked_gaps]}
