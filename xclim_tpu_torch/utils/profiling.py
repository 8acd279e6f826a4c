"""Profiling and tracing around ``torch.profiler``.

The reference's observability is the dask dashboard (xclim:cli.py:471-474);
here the equivalents are profiler traces in the Chrome trace format
(viewable in Perfetto or ``chrome://tracing``), the program's own spans, and
wall-clock timing that waits for the card.

Spans. The program opens :func:`span` at its stages (``indicator.call`` and
its checks, compute, units, missing and attrs; the run statistics
``runlength.runs``, the season parts and date-constrained runs
``runlength.season``, ``rolling.reduce``; the bootstrap's plain
compute, tables and in-base years; ``percentiles.doy``; ``sdba.train`` and
``sdba.adjust`` with their units, tables, quantiles and attrs, DQM's
scaling and detrend, and the EQM adjust of EQM and DQM;
``ensembles.percentiles`` and ``ensembles.robustness`` with its moments
and ``ensembles.betainc``, around ``op.betainc``; the op entries
``op.*``). Outside
:func:`tracing` a span costs one check of a module-level flag and returns
its name's shared no-op. Inside it, each span
keeps a record (name, id, parent id, the id of the outermost span it sits
in, host start and end from ``time.perf_counter_ns()``, the counts made
while it was the innermost span) and opens
``torch.profiler.record_function("xtt:" + name)``, so that a profiler
running at the same time holds the span on its own clock, around the
operations and kernels launched inside it. While tracing is on,
``torch.cuda.set_sync_debug_mode("warn")`` makes every synchronizing CUDA
call warn; the warnings are counted (``host_syncs``) and not shown.

Counters. Beside ``host_syncs``, the program counts with :func:`count`,
under any name, how it took a path that depends on its input (the
callers name their own counters; ``betainc_terms``, for one, is one a
kernel launch on the card and one a step of the CPU twin's continued
fraction; ``indicator_calls`` is one an ``Indicator.__call__``). A count
adds an amount: 1, any int, or a tensor of int64 counts that a kernel
wrote on the device (one a name), kept as it is and summed into plain ints
once, when the :func:`tracing` block exits: after the sync debug mode is
restored, so that reading it is no ``host_sync`` of the block. Each count
goes to the block's total and to the innermost open span's record, as a
sync does, and is one empty ``xtt:<name>`` range a call (of the first
name where it counts several) on a profiler's clock, so that a trace
holds it too. A counter never counted reads 0.

Kernels that count. While a block is tracing (:func:`active`), the kernels
with a counting build (``ops/_build.py`` ``COUNTING``: winquantile and
betainc, compiled again with ``-DXTT_COUNT``) launch it instead of the
shipped build, with a zeroed int64 buffer that they fill and hand to
:func:`count`. On entering the outermost block on a machine with CUDA,
the counting builds of the kernels the process has loaded are built and
bound, so that no call inside the block pays for nvcc.

Operator use::

    with profile("traces"):              # a Chrome trace with the spans
        atmos.tx90p(tasmax, tasmax_per=per, bootstrap=True)

    with tracing() as tr:                # the records in memory
        atmos.tx90p(tasmax, tasmax_per=per, bootstrap=True)
    tr.spans, tr.counters["host_syncs"], tr.counters["bootstrap_sliced"]
    last_trace().counters                # the counters of the block just run

    with timed("tx90p", sync=lambda: out) as t:   # prints the seconds
        out = atmos.tx90p(tasmax, tasmax_per=per)

Spans, and the sync counter, assume one host thread calls the program.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import tempfile
import time
import warnings

__all__ = ["Trace", "active", "count", "last_trace", "profile", "span",
           "timed", "tracing"]

#: what a range of the program's spans is named by in a profiler trace
PREFIX = "xtt:"
#: the start of the warning torch gives for a synchronizing CUDA call
SYNC_WARNING = "called a synchronizing CUDA operation"

#: the Trace collecting while :func:`tracing` is on, else None
_trace = None
#: the Trace of the last :func:`tracing` block that exited
_last = None
#: a name's shared no-op span (built on the name's first use)
_off: dict = {}


class Trace:
    """What one :func:`tracing` block collected.

    ``spans``: one record a span, in the order they opened: {"name", "id",
    "parent" (None at the outermost), "root" (the outermost span's id, shared
    by the spans of one public call), "start_ns", "end_ns", "host_syncs",
    and each counter counted while it was the innermost span}.
    ``counters``: each counter over the block, inside a span or not. Both
    read 0 for a counter never counted. Amounts given as tensors are in
    both once the block has exited.
    """

    def __init__(self):
        self.spans: list[dict] = []
        self.counters = _counts()
        self._open: list[dict] = []
        #: (names, device tensor, innermost span's record or None)
        self._pending: list[tuple] = []

    def _count(self, name: str, amount: int = 1) -> None:
        self.counters[name] += amount
        if self._open:
            self._open[-1][name] += amount

    def _defer(self, names: tuple, amount) -> None:
        rec = self._open[-1] if self._open else None
        for name in names:
            self.counters[name] += 0
            if rec is not None:
                rec[name] += 0
        self._pending.append((names, amount, rec))

    def _resolve(self) -> None:
        """Adds the tensor amounts as ints: one copy to the host a device."""
        import torch

        by_device: dict = {}
        for entry in self._pending:
            by_device.setdefault(entry[1].device, []).append(entry)
        self._pending = []
        for entries in by_device.values():
            flat = torch.cat([a.reshape(-1, len(names)).sum(0, dtype=torch.int64)
                              for names, a, _ in entries]).tolist()
            i = 0
            for names, _, rec in entries:
                for name in names:
                    self.counters[name] += flat[i]
                    if rec is not None:
                        rec[name] += flat[i]
                    i += 1


def _counts(**fields) -> collections.defaultdict:
    """``fields`` and counters that read 0 until counted, ``host_syncs``
    always present."""
    return collections.defaultdict(int, host_syncs=0, **fields)


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


class _Off:
    """A span while tracing is off: enters and exits doing nothing; as a
    decorator, the function opens its span on each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _Span(_Off):
    __slots__ = ("trace", "record", "_range")

    def __init__(self, trace: Trace, name: str):
        super().__init__(name)
        self.trace = trace

    def __enter__(self):
        import torch

        t = self.trace
        parent = t._open[-1] if t._open else None
        sid = len(t.spans) + 1
        self.record = rec = _counts(
            name=self.name, id=sid,
            parent=parent["id"] if parent else None,
            root=parent["root"] if parent else sid,
            start_ns=time.perf_counter_ns(), end_ns=None)
        t.spans.append(rec)
        t._open.append(rec)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        return None

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.record["end_ns"] = time.perf_counter_ns()
        self.trace._open.pop()          # spans exit innermost first
        return False


def span(name: str):
    """The program's span ``name``: a context manager, or a decorator
    (``@span("op.x")``) that opens it around each call. Records only inside
    :func:`tracing`."""
    if _trace is None:
        off = _off.get(name)
        return off if off is not None else _off.setdefault(name, _Off(name))
    return _Span(_trace, name)


def count(name, amount=1) -> None:
    """Add ``amount`` to the program's counter ``name`` (any name) inside
    :func:`tracing`: to the block's total and to the innermost open span's
    record, and as an empty ``xtt:<name>`` range to a profiler running
    then. ``amount``: an int, or a tensor of int64 counts on any device,
    read when the block exits (no sync here); with a tuple of names, a
    tensor of one count a name, in their order, or of rows of them (k x
    len(names), summed when read), and one range, named by the first (a
    range costs the host microseconds while a profiler runs). Does
    nothing outside :func:`tracing`."""
    if _trace is None:
        return
    import torch

    names = (name,) if isinstance(name, str) else tuple(name)
    given = (amount.shape[-1] if isinstance(amount, torch.Tensor)
             and amount.ndim else 1)
    if given != len(names):
        raise ValueError(f"{given} counts for {len(names)} names")
    if isinstance(amount, torch.Tensor):
        _trace._defer(names, amount)
    else:
        _trace._count(names[0], int(amount))
    with torch.profiler.record_function(PREFIX + names[0]):
        pass


def active() -> bool:
    """Whether a :func:`tracing` block is collecting (the kernels that count
    launch their counting build then)."""
    return _trace is not None


def last_trace() -> Trace | None:
    """The :class:`Trace` of the last :func:`tracing` block that exited,
    its tensor amounts added (None before the first)."""
    return _last


@contextlib.contextmanager
def tracing():
    """Collect the program's spans, host syncs and counters for the block;
    yields the :class:`Trace` (in memory; nothing is written). Inside a
    block already tracing, yields that block's Trace. With CUDA, first
    builds and binds the counting builds of the kernels loaded so far. On
    exit the sync debug mode and the warning filters are as before; then
    the counts given as tensors are read, and the Trace becomes
    :func:`last_trace`."""
    global _trace, _last
    if _trace is not None:
        yield _trace
        return
    import torch

    trace = Trace()
    cuda = torch.cuda.is_available()
    if cuda:
        from xclim_tpu_torch.ops import _build

        _build.prepare_counting()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if str(message).startswith(SYNC_WARNING):
                trace._count("host_syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = showwarning
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _trace = trace
        try:
            yield trace
        finally:
            _trace = None
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
    trace._resolve()
    _last = trace


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block (the host,
    and the card's kernels where CUDA is available), with the program's
    spans on as ``xtt:`` ranges (and so the kernels' counting builds
    launched), and write it as a Chrome trace
    ``trace-<ns>.json`` under `logdir` (default: ``xclim_tpu_torch_trace``
    in the temporary directory). Yields `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity

    logdir = logdir or os.path.join(tempfile.gettempdir(), "xclim_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, tracing():
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{time.time_ns()}.json"))


def _sync(out) -> None:
    """Wait for the card to finish the tensors in `out` (a tensor, a
    ClimArray, or a list, tuple or dict of them)."""
    import torch

    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            _sync(o)
        return
    data = getattr(out, "data", out)
    if isinstance(data, torch.Tensor) and data.is_cuda:
        torch.cuda.synchronize(data.device)


@contextlib.contextmanager
def timed(label: str = "block", sync=None):
    """Wall-clock timing that waits, before it stops the clock, for the card
    to finish `sync` (a tensor or ClimArray, a collection of them, or a
    callable returning one; set ``holder["sync"]`` inside the block to give
    it there): ``torch.cuda.synchronize`` on CUDA data, so that
    asynchronous launches do not fake speed. The seconds are in
    ``holder["seconds"]``. Inside :func:`tracing` the block is also the
    span `label`."""
    t0 = time.perf_counter()
    holder = {}
    with span(label):
        try:
            yield holder
        finally:
            out = holder.get("sync", sync)
            if callable(out):
                out = out()
            if out is not None:
                _sync(out)
            holder["seconds"] = time.perf_counter() - t0
            print(f"[xclim_tpu_torch] {label}: {holder['seconds']:.3f}s")
