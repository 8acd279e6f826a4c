"""Stage profile of the winquantile kernel on the card.

The kernel (``csrc/winquantile.cu``) is built with its stage as a template
parameter and reached through ``xtt_winquantile_stages``, so the profile
times the shipped code:

* ``load_presort``: the per-doy loads of the window's slices with the
  running valid count, and the presort of every doy slice where the
  instance has one (not the warp instance, ``window * Y`` <= 1024);
* ``slide``: + the chunk-start sort and the slides of the sorted window
  (in the warp instance, each slice sorted as it enters and leaves);
* ``full``: + node selection (the kernel ``doy_window_quantiles`` runs).

The differences between neighbouring stages say where the time goes: sort
and loads, slide, or selection. Each stage writes a small result that
:func:`~xclim_tpu_torch.ops.winquantile.stage_plain` also gives.

Beside them, :func:`counted` launches the kernel's counting build (the
one the program runs while tracing) and reads its counters (the stages
and the walk of the sampled blocks, one in ``SAMPLE_EVERY``): each stage's
share of the warps' cycles (the chunk-start sort, the slices' loads and
sorts, the searches and walk, node selection), the cycles and the walk's
steps a slide, the steps at which some lane inserts or removes (branch
steps) a step, the share of lanes with an event at those steps, and the
counting build's milliseconds (what counting costs).

    python -m xclim_tpu_torch.tools.prof_winquantile [--cells 16384 65536]

runs them at QDM's shape (365 doys x 30 years, window 31, 50 nodes of
``equally_spaced_nodes(50)``) on random slices, one JSON line a number of
cells: each stage's milliseconds, the device time of each kernel of one
full launch (torch.profiler): the warp instance's one kernel, or the
presort pass and the sliding kernel; and the counters.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from xclim_tpu_torch.ops import winquantile
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes
from xclim_tpu_torch.utils import profiling

__all__ = ["stage_times", "kernel_split", "counted", "main"]

#: the stages of the counting build's cycle counters
CYCLE_STAGES = ("sort", "slices", "walk", "nodes")


def stage_times(xg: torch.Tensor, q, window: int, reps: int = 3) -> dict:
    """Milliseconds of each stage (a mean over ``reps`` launches after a
    warm-up, by CUDA events) on the CUDA tensor ``xg`` (n_doy, Y, C)."""
    if xg.device.type != "cuda":
        raise ValueError("the stage profile times the CUDA kernel: xg must "
                         "be a CUDA tensor")
    out = {}
    for stage, name in enumerate(winquantile.STAGES):
        winquantile.doy_window_stage(xg, q, window, stage)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            winquantile.doy_window_stage(xg, q, window, stage)
        stop.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(stop) / reps
    return out


def kernel_split(xg: torch.Tensor, q, window: int) -> dict:
    """Device milliseconds of each kernel in one full launch (the warp
    instance's kernel, or the presort pass and the sliding kernel), from
    torch.profiler's trace (None where the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    winquantile.doy_window_quantiles(xg, q, window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        winquantile.doy_window_quantiles(xg, q, window)
        torch.cuda.synchronize()
    out = {"warp_kernel": None, "presort_kernel": None, "slide_kernel": None}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for name in out:
            if name in e.key:
                out[name] = (out[name] or 0.0) + us / 1e3
    return out


def counted(xg: torch.Tensor, q, window: int, reps: int = 3) -> dict:
    """The counting build's counters of one launch on the CUDA tensor
    ``xg`` and what they say: the share of slides the sampled blocks ran,
    the values entering and leaving a window a slide (every slide), each
    stage's share of the cycles, cycles and walk steps a slide, branch
    steps a walk step, the lanes' share at those steps (%), and the build's
    milliseconds (a mean over ``reps`` launches after a warm-up, by CUDA
    events)."""
    if xg.device.type != "cuda":
        raise ValueError("the counters exist on the card: xg must be a CUDA "
                         "tensor")
    with profiling.tracing():
        winquantile.doy_window_quantiles(xg, q, window)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            winquantile.doy_window_quantiles(xg, q, window)
        stop.record()
        torch.cuda.synchronize()
    with profiling.tracing() as tr:
        winquantile.doy_window_quantiles(xg, q, window)
    c = {k: tr.counters[k] for k in winquantile.COUNTERS}
    cycles = {s: c[f"winquantile_cycles_{s}"] for s in CYCLE_STAGES}
    total = sum(cycles.values())
    slides = c["winquantile_sampled_slides"]    # the warps that timed
    steps = c["winquantile_walk_branch_steps"]
    every = c["winquantile_slides"]
    return {
        "counters": c,
        "sampled_share": slides / every if every else None,
        "events_per_slide": ((c["winquantile_inserted"]
                              + c["winquantile_removed"]) / every
                             if every else None),
        "cycle_share": {s: v / total for s, v in cycles.items()} if total
        else None,
        "cycles_per_slide": total / slides if slides else None,
        "walk_steps_per_slide": (c["winquantile_walk_steps"] / slides
                                 if slides else None),
        "branch_steps_per_step": (steps / c["winquantile_walk_steps"]
                                  if slides else None),
        "lane_pct": (100.0 * c["winquantile_walk_branch_lanes"] / (32 * steps)
                     if steps else None),
        "count_ms": start.elapsed_time(stop) / reps,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, nargs="+", default=[16384, 65536])
    ap.add_argument("--years", type=int, default=30)
    ap.add_argument("--window", type=int, default=31)
    ap.add_argument("--seed", type=int, default=1981)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_winquantile: no CUDA device")
    q = equally_spaced_nodes(50).astype(np.float32)
    for cells in args.cells:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        xg = torch.randn((365, args.years, cells), generator=gen,
                         device="cuda") * 5.0 + 285.0
        print(json.dumps({"shape": list(xg.shape), "window": args.window,
                          "device": torch.cuda.get_device_name(0),
                          "stage_ms": stage_times(xg, q, args.window),
                          "kernel_ms": kernel_split(xg, q, args.window),
                          "counted": counted(xg, q, args.window)}),
              flush=True)
        del xg
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
