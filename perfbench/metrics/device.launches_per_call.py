"""device.launches_per_call: the CUDA kernels (not copies or sets) that ran
in the profiled calls, over those calls, from torch.profiler's raw
events. Nothing to read when the trace holds no kernel."""


def read(run):
    p = run.profile
    if not p or p["kernels"] <= 0:
        return None
    return p["kernels"] / p["calls"]
