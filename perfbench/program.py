"""The program's own spans and host-sync counter in a traced run.

A traced run profiles about two seconds of calls before its window with the
program's tracing off; that stretch alone feeds ``device.idle_pct``,
``device.launches_per_call`` and the rooflines. The readers of the metrics
below ask :func:`stretch` for a second stretch of the same rule (about two
seconds, at least one call, each call in the benchmark's ``call`` and stage
annotations and followed by the same check of its outputs), made once a run
after the window on the run's own state, inside the program's
``xclim_tpu_torch.utils.profiling.tracing()`` and ``torch.profiler``:

- each device operation is given the program's spans (``xtt:`` ranges) and
  the benchmark's stage open when the runtime call that launched it began,
  through its correlation id; device milliseconds by span are sums of the
  durations of the operations launched inside it;
- each idle gap of the device is labelled ``<benchmark stage> / <innermost
  program span> / <host op>`` at its start, and counted to every program
  span open then;
- ``host_syncs``: the syncs the program's spans counted (torch's sync debug
  mode), beside the synchronizing runtime calls (``cudaStreamSynchronize``,
  ``cudaMemcpy``) the profiler saw start inside an ``xtt:`` range.

Nothing is read where the program has no ``tracing()`` (the stretch is then
not made). The whole reading is printed once as a ``program {json}`` line on
standard error, with the per-call seconds of both stretches (the cost of
tracing). The stretch reaches the run's state through the frame of
:func:`perfbench.run.run_cell`, which hands readers only its ``run``.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from collections import defaultdict

from perfbench import run as harness
from perfbench.trace import NAME_CHARS, _union

#: the program's span ranges in a profiler trace
PREFIX = "xtt:"
#: runtime calls that wait for the device (torch's sync debug mode warns
#: on each; a synchronous copy waits like a stream synchronize)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpy")
#: kineto activity types of the host's CUDA API calls
RUNTIME = ("cuda_runtime", "cuda_driver")


def _run_cell_frame():
    code = harness.run_cell.__code__
    f = sys._getframe(1)
    while f is not None and f.f_code is not code:
        f = f.f_back
    return f


def stretch(run):
    """The second stretch's reading (:func:`read_events`), made on the first
    call for ``run`` and kept on it as ``run.program``; None where the
    program has no tracing or the run's frame is not found."""
    if hasattr(run, "program"):
        return run.program
    run.program = None
    profiling = importlib.import_module("xclim_tpu_torch.utils.profiling")
    frame = _run_cell_frame()
    if not hasattr(profiling, "tracing") or frame is None:
        return None
    env = frame.f_locals
    call_spans, fingerprint = env["call_spans"], env["fingerprint"]
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if env["device"].type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    n = 0
    with torch.profiler.profile(activities=activities) as prof, \
            profiling.tracing() as trace:
        t0 = time.perf_counter()
        while not n or time.perf_counter() - t0 < harness.PROFILE_SECONDS:
            with torch.profiler.record_function("call"):
                call_spans(False)
            fingerprint()
            n += 1
    out = read_events(prof.profiler.kineto_results.events(), set(env["spans"]),
                      n, trace)
    del prof
    first = run.profile or {}
    if first.get("calls"):
        out["per_call_s_untraced"] = first["window_s"] / first["calls"]
    print("program " + json.dumps(out), file=sys.stderr, flush=True)
    run.program = out
    return out


def _covering(events, times):
    """For each time (ascending), the names of the well-nested ``events``
    [(start, end, name)] that cover it, outermost first."""
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
        out.append(tuple(e[2] for e in stack if e[1] > t))
    return out


def _annotation(e, name, spans) -> bool:
    """A device-side range of an annotation (the benchmark's or the
    program's), by its flag or, where the trace does not flag it, by name."""
    flagged = getattr(e, "is_user_annotation", None)
    return ((flagged is not None and flagged()) or name == "call"
            or name in spans or name.startswith(PREFIX))


def _runtime(e, name) -> bool:
    """A host's CUDA API call, by its kineto activity type where
    the event has one (torch 2.11's events do not: by its name there)."""
    kind = getattr(e, "activity_type", None)
    return kind() in RUNTIME if kind is not None else name.startswith("cu")


def read_events(kineto_events, spans: set, calls: int, trace,
                top: int = 10) -> dict:
    """The program's reading of a profiled stretch of ``calls`` calls, each
    in a ``call`` annotation and its stages in annotations named ``spans``,
    with the program's ``xtt:`` ranges and ``trace`` (the
    ``profiling.Trace`` of the same block).

    Returns {"calls", "window_s", "busy_s", "per_call_s", "kernels",
    "span_counts", "program_ms", "stage_ms", "unattributed_ms",
    "program_idle_ms", "idle_gaps", "host_syncs", "host_syncs_by_span",
    "host_syncs_total", "sync_calls_in_spans"} (empty when the trace holds
    no ``call``): the program's ranges by name, device milliseconds by
    program span and by benchmark stage, idle milliseconds by program span,
    syncs by the innermost span they were made in (all over the stretch,
    not a call), the top labelled gaps in seconds.
    """
    from torch.autograd import DeviceType

    call_iv, stage_iv, prog_iv, host_ops, device = [], [], [], [], []
    launch = {}
    for e in kineto_events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e, name, spans):
                # its own correlation id is CUPTI's, shared with the runtime
                # call that launched it; else try the linked one
                device.append((s, t, name, (e.correlation_id(),
                                            e.linked_correlation_id())))
        elif name == "call":
            call_iv.append((s, t))
        elif name in spans:
            stage_iv.append((s, t, name))
        elif name.startswith(PREFIX):
            prog_iv.append((s, t, name[len(PREFIX):]))
        else:
            if _runtime(e, name) and e.correlation_id():
                launch[e.correlation_id()] = s
            host_ops.append((s, t, name))
    if not call_iv:
        return {}
    w0 = min(s for s, _ in call_iv)
    w1 = max(t for _, t in call_iv)
    device = [(max(s, w0), min(t, w1), n, c) for s, t, n, c in device
              if t > w0 and s < w1]

    # device time by the spans open at each operation's launch
    program_ns, stage_ns = defaultdict(int), defaultdict(int)
    launched, unattributed = [], 0
    for s, t, _, ids in device:
        at = next((launch[c] for c in ids if c in launch), None)
        if at is None:
            unattributed += t - s
        else:
            launched.append((at, t - s))
    launched.sort()
    at = [x for x, _ in launched]
    for (_, ns), names, stages in zip(launched, _covering(prog_iv, at),
                                      _covering(stage_iv, at)):
        for name in set(names):
            program_ns[name] += ns
        if stages:
            stage_ns[stages[-1]] += ns

    # idle gaps, labelled and counted to the program spans open at their start
    busy = _union((s, t) for s, t, _, _ in device)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    starts = [g[0] for g in gaps]
    idle_ns, by_gap = defaultdict(int), defaultdict(int)
    for (s, t), names, stages, ops in zip(gaps, _covering(prog_iv, starts),
                                          _covering(stage_iv, starts),
                                          _covering(host_ops, starts)):
        for name in set(names):
            idle_ns[name] += t - s
        label = ([stages[-1] if stages else "between calls"] + list(names[-1:])
                 + [ops[-1] if ops else "python"])
        by_gap[" / ".join(label)] += t - s

    # synchronizing runtime calls that began inside a program span
    sync_at = sorted(s for s, _, n in host_ops if n in SYNC_CALLS)
    in_spans = sum(1 for names in _covering(prog_iv, sync_at) if names)

    ranked = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    busy_ns = sum(t - s for s, t in busy)
    counts, syncs = defaultdict(int), defaultdict(int)
    for s, t, name in prog_iv:
        if w0 <= s < w1:
            counts[name] += 1
    for r in trace.spans:
        syncs[r["name"]] += r["host_syncs"]
    return {
        "calls": calls, "window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
        "per_call_s": (w1 - w0) / 1e9 / calls,
        "kernels": sum(1 for _, _, n, _ in device
                       if not n.startswith(("Memcpy", "Memset"))),
        "span_counts": dict(sorted(counts.items())),
        "program_ms": {k: v / 1e6 for k, v in sorted(program_ns.items())},
        "stage_ms": {k: v / 1e6 for k, v in sorted(stage_ns.items())},
        "unattributed_ms": unattributed / 1e6,
        "program_idle_ms": {k: v / 1e6 for k, v in sorted(idle_ns.items())},
        "idle_gaps": [[n[:NAME_CHARS], v / 1e9] for n, v in ranked],
        "host_syncs": sum(syncs.values()),
        "host_syncs_by_span": {k: v for k, v in sorted(syncs.items()) if v},
        "host_syncs_total": trace.counters["host_syncs"],
        "sync_calls_in_spans": in_spans,
    }


def span_ms_per_call(run, names) -> float | None:
    """Device ms a call of the operations launched inside the program's
    spans ``names``; None where none of them ran."""
    p = stretch(run)
    if not p or not any(n in p["program_ms"] for n in names):
        return None
    return sum(p["program_ms"].get(n, 0.0) for n in names) / p["calls"]


def idle_ms_per_call(run, names) -> float | None:
    """Device idle ms a call in gaps that began inside the program's spans
    ``names``; None where none of them ran."""
    p = stretch(run)
    if not p or not any(n in p["program_ms"] or n in p["program_idle_ms"]
                        for n in names):
        return None
    return sum(p["program_idle_ms"].get(n, 0.0) for n in names) / p["calls"]
