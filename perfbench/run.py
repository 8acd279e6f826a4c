"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is a closed loop with one caller: its call (the traffic mix's
``call`` stages of the configuration's caller) runs back to back, each call
waiting for the device, until the first call that completes after
``--seconds``. A run

1. sets up: imports the program, makes the inputs on the card from the
   seed, runs the mix's ``setup`` stages and one warm-up call (which builds
   the kernels on the first run in a checkout);
2. runs the window;
3. frees the program's state and compares the last call's outputs, at
   cells drawn from the seed, with the plain reference under
   ``perfbench/reference/``, and what every call made at a few of those
   cells with what the last call made;
4. prints each number compared beside its limit as the last lines on
   standard error, and one JSON line as the last line of standard output.

With ``--trace 1`` calls first run under torch.profiler for about two
seconds (at least one call), before the window; in the window the stages
are timed by spans (host clock, each ended by a synchronize); the op
entries that roofline metrics name are wrapped throughout. The line then
carries the per-layer metrics, the profiled stretch's device busy and
window seconds and a breakdown. With ``--trace 0`` it carries the
end-to-end metrics. Every metric is read by ``perfbench/metrics/<name>.py``.

The run needs a CUDA device and never falls back to the CPU; it fails if
the JAX package (or JAX itself) was loaded, or if a kernel's plain twin ran.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from perfbench import spec
from perfbench.trace import EntryTimer, read_profile

#: top-level module names that may not be loaded when the result is printed
BANNED = ("jax", "jaxlib", "flax", "xclim_tpu")
#: the program's op modules whose twin_calls must stay 0 on the card
OPS = ("winquantile", "qdmadjust", "segred", "spells", "axisquantile")
#: seconds of calls that a traced run profiles before its window
PROFILE_SECONDS = 2.0
#: of the cells compared, how many every call's outputs are checked at
CALL_CELLS = 64
#: the gap where shapes or missing values differ (JSON has no infinity)
MISMATCH = 1e308


def metric_reader(name: str):
    """``perfbench/metrics/<name>.py``, loaded as a module."""
    path = spec.PKG / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def twin_calls() -> dict:
    mods = {n: importlib.import_module(f"xclim_tpu_torch.ops.{n}") for n in OPS}
    return {n: m.twin_calls for n, m in mods.items()}


def build_seconds() -> float:
    from xclim_tpu_torch.ops import _build

    return sum(info["seconds"] for info in _build.build_info.values())


def gaps(got: dict, want: dict, units: dict, intervals=()) -> dict:
    """The numbers compared, by output. ``<output>_max_abs_<unit>``: the
    largest gap between the program's output and the reference's where both
    have a value; :data:`MISMATCH` where their shapes or their missing
    values differ. For an output in ``intervals`` the reference gives the (2,
    ...) ends of the values it allows, and ``<output>_outside_<unit>`` is
    how far the program's value lies beyond them."""
    import torch

    out = {}
    for name, w in want.items():
        g = got[name].double().cpu()
        w = w.double().cpu()
        if name in intervals:
            key = f"{name}_outside_{units[name]}"
            if g.shape != w.shape[1:] or bool(torch.isnan(g).any()):
                out[key] = MISMATCH
                continue
            d = torch.maximum(w[0] - g, g - w[1]).clamp(min=0.0)
            out[key] = float(d.max()) if d.numel() else 0.0
            continue
        key = f"{name}_max_abs_{units[name]}"
        if g.shape != w.shape or not torch.equal(torch.isnan(g),
                                                 torch.isnan(w)):
            out[key] = MISMATCH
            continue
        d = (g - w).abs()[~torch.isnan(w)]
        out[key] = float(d.max()) if d.numel() else 0.0
    return out


def sample_cells(n_cells: int, count: int, seed: int) -> np.ndarray:
    """``count`` distinct cells drawn from the seed, in ascending order."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_cells, size=min(count, n_cells),
                              replace=False))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.splitlines()[0])
    except (IndexError, ValueError):
        return None


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, config: dict | None = None):
    """One run of cell ``name`` on ``device``: (result dict, the check
    lines). ``config`` replaces the cell's configuration file (the tests
    run tiny ones on the CPU)."""
    import torch

    cell = spec.cell(bench, name)
    config = config or spec.config_of(bench, cell)
    mix = spec.traffic_of(cell)
    caller = importlib.import_module(f"perfbench.callers.{config['caller']}")
    reference = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    parts = {}
    for mod in caller.IMPORTS:
        importlib.import_module(mod)
    parts["import_s"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    state = caller.setup(config, seed, device)
    state.update(config=config, mix=mix)
    sync()
    parts["inputs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for stage in mix["setup"]:
        caller.STAGES[stage](state)
    sync()
    parts["prepare_s"] = time.perf_counter() - t0
    stages = [(caller.SPANS[s], caller.STAGES[s]) for s in mix["call"]]
    t0 = time.perf_counter()
    for _, fn in stages:
        fn(state)
    sync()
    warm_s = time.perf_counter() - t0
    parts["warmup_s"] = warm_s
    if cuda:
        parts["build_s"] = build_seconds()
    setup_s = time.perf_counter() - t_start

    n_cells = state["raw"][next(iter(state["raw"]))][0].numel()
    cells = sample_cells(n_cells, config["check"]["cells"], seed)
    call_idx = torch.as_tensor(cells[:CALL_CELLS], device=device)

    made = [o for s in mix["call"] for o in caller.PRODUCES[s]]

    def fingerprint():
        """Sums of what the call made at a few of the drawn cells."""
        outs = caller.outputs(state)
        return torch.stack([outs[o].index_select(1, call_idx)
                            .sum(dtype=torch.float64) for o in made])

    listed = spec.metrics_of(bench, name, "per_layer" if trace else "end_to_end")
    readers = {m["name"]: metric_reader(m["name"]) for m in listed}
    entries = {r.ENTRY: r.work for r in readers.values() if hasattr(r, "ENTRY")}
    spans = {s: [] for s, _ in stages}
    latencies, prints = [], []
    profile = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def call_plain():
        for _, fn in stages:
            fn(state)
        sync()

    def call_spans(keep: bool):
        for span, fn in stages:
            s0 = time.perf_counter()
            with torch.profiler.record_function(span):
                fn(state)
                sync()
            if keep:
                spans[span].append(time.perf_counter() - s0)

    with EntryTimer(entries if trace and cuda else {}) as timer:
        if trace:
            # the profiled calls come before the timed window: starting the
            # profiler and reading its trace take seconds
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            n_prof = 0
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                while not n_prof or time.perf_counter() - t0 < PROFILE_SECONDS:
                    with torch.profiler.record_function("call"):
                        call_spans(keep=False)
                    prints.append(fingerprint())
                    n_prof += 1
            profile = read_profile(prof.profiler.kineto_results.events(),
                                   set(spans), n_prof)
            del prof
            if cuda and not profile.get("kernels"):
                raise RuntimeError("the profiler's trace holds no kernel")
        t_begin = time.perf_counter()
        deadline = t_begin + seconds
        while True:
            t0 = time.perf_counter()
            if trace:
                call_spans(keep=True)
            else:
                call_plain()
            latencies.append(time.perf_counter() - t0)
            prints.append(fingerprint())
            if t0 + latencies[-1] >= deadline:
                break
        sync()
        t_end = time.perf_counter()
        calls = timer.calls()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    run = SimpleNamespace(
        calls=len(latencies), window_s=t_end - t_begin, latencies_s=latencies,
        cell_days=caller.cell_days(state), peak_bytes=peak, setup_s=setup_s,
        spans=spans, entries=calls, profile=profile)
    metrics = {}
    lines = []
    for m in listed:
        value = readers[m["name"]].read(run)
        if value is None:
            lines.append(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison: the program's outputs at the drawn cells, then its
    # state freed before the reference runs on the same device
    idx = torch.as_tensor(cells, device=device)
    got = {k: v[:, idx].float() for k, v in caller.outputs(state).items()}
    inputs = {k: v[:, idx] for k, v in caller.inputs(state).items()}
    prints = torch.stack(prints).cpu()
    twins = twin_calls() if cuda else {}
    del state, calls, timer
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference.reference(inputs, config, mix)
    sync()
    reference_s = time.perf_counter() - t0
    checks = gaps(got, want, reference.UNITS,
                  getattr(reference, "INTERVALS", ()))
    last = prints[-1]
    same = (prints == last) | (torch.isnan(prints) & torch.isnan(last))
    checks["calls_differing"] = int((~same.all(dim=1)).sum())
    limits = {**config["limits"], "calls_differing": 0}
    correct = all(checks[k] <= limits[k] for k in checks)
    if any(twins.values()):
        raise RuntimeError(f"a plain twin ran on the card: {twins}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(device) if cuda else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    if trace:
        dev["busy_s"] = profile.get("busy_s", 0.0)
        dev["window_s"] = profile.get("window_s", 0.0)
    result = {"correct": bool(correct), "attempted": run.calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and profile:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["setup_parts"] = parts
    result["reference_s"] = reference_s
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    lines += [f"setup {json.dumps(parts)} reference_s {reference_s:.3f}"]
    lines += [f"check {k} {v!r} limit {limits[k]!r}" for k, v in checks.items()]
    return result, lines


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="python3 -m perfbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # one caller, one host thread: torch's pool of CPU threads takes cores
    # from the calling thread on a shared host and spread the host-bound
    # cells' runs (tx90p4k.plain: 1.44-1.62e9 cell-days/s with 8 threads,
    # 1.59-1.66e9 with 1, H100, 700 W)
    torch.set_num_threads(1)
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), device, t_start)
    found = banned_modules()
    if found:
        print(f"perfbench: the JAX package or JAX was loaded: {found}: no "
              f"result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
