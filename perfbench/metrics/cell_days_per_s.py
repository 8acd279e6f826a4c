"""cell_days_per_s: all the cell-days the window's calls produced over all
the window's seconds (host clock; each call ends in a synchronize)."""


def read(run):
    return run.calls * run.cell_days / run.window_s
