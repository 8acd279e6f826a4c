"""device.idle_pct: the share of the profiled calls' wall time (the first
calls of the traced window, from the first call's start to the last one's
end) in which no operation ran on the device, from torch.profiler's raw
events. Nothing to read when the trace holds no device operation."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
