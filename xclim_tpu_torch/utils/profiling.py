"""Profiling helpers around ``torch.profiler``.

The reference's observability is the dask dashboard (xclim:cli.py:471-474);
here the equivalents are profiler traces in the Chrome trace format
(viewable in Perfetto or ``chrome://tracing``) and wall-clock timing that
waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

__all__ = ["profile", "timed"]


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block (the host,
    and the card's kernels where CUDA is available) and write it as a
    Chrome trace ``trace-<ns>.json`` under `logdir` (default:
    ``xclim_tpu_torch_trace`` in the temporary directory). Yields `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity

    logdir = logdir or os.path.join(tempfile.gettempdir(), "xclim_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
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
    ``holder["seconds"]``."""
    t0 = time.perf_counter()
    holder = {}
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
