"""winquantile.walk_lane_pct: the share of a warp's lanes that insert or
remove at the walk's steps where any lane does, in winquantile's warp
instance (the warp runs that path for all 32 lanes), in the traced run's
second stretch (``perfbench/program.py``): 100 x
``winquantile_walk_branch_lanes`` / (32 x
``winquantile_walk_branch_steps``), counted by the kernel's counting build
while the program traces (``ops/winquantile.py`` ``COUNTERS``; in one
block of ``SAMPLE_EVERY``). Read by
``perfbench/counters.py``; nothing to read where the program has no such
counter."""

from perfbench.counters import stretch_counters


def read(run):
    counters = stretch_counters(run)
    steps = counters.get("winquantile_walk_branch_steps", 0)
    if not steps:
        return None
    return 100.0 * counters.get("winquantile_walk_branch_lanes", 0) \
        / (32 * steps)
