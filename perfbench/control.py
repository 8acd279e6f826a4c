"""The lower-precision control of a cell's comparison.

    python3 -m perfbench.control --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs on the card as a run does, draws
the same cells, computes the plain reference in float32 (the precision the
configuration states) and again in bfloat16 (the next precision below it
for work without matrix products), and puts the bfloat16 result in the
program's place: the numbers a run compares, each beside its limit. The
control has to fail at least one of them. Benchmark runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from perfbench import generate, spec
from perfbench.run import gaps, sample_cells


def control(bench: dict, name: str, seed: int, device,
            config: dict | None = None) -> dict:
    """{"checks": number -> {"value", "limit"}, "fails": bool} of the
    bfloat16 reference against the float32 one at a run's drawn cells."""
    import torch

    cell = spec.cell(bench, name)
    config = config or spec.config_of(bench, cell)
    mix = spec.traffic_of(cell)
    reference = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    raw = generate.make(config["data"], seed, device)
    flat = {k: v.reshape(v.shape[0], -1) for k, v in raw.items()}
    n_cells = next(iter(flat.values())).shape[1]
    idx = torch.as_tensor(sample_cells(n_cells, config["check"]["cells"],
                                       seed), device=device)
    inputs = {k: v[:, idx].clone() for k, v in flat.items()}
    del raw, flat
    want = reference.reference(inputs, config, mix, torch.float32)
    lower = reference.reference(inputs, config, mix, torch.bfloat16)
    intervals = getattr(reference, "INTERVALS", ())
    lower = {k: v[0] if k in intervals else v for k, v in lower.items()}
    numbers = gaps(lower, want, reference.UNITS, intervals)
    limits = config["limits"]
    return {"checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in numbers.items()},
            "fails": any(v > limits[k] for k, v in numbers.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load()
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        out = control(bench, args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
