"""winquantile.walk_cycles_per_slide: the warp cycles a (cell, doy) slide
that winquantile's warp instance spends in ``merge_slices`` (the searches
in the two sorted slices, the tie scan and the walk over the window), in
the traced run's second stretch (``perfbench/program.py``):
``winquantile_cycles_walk`` over ``winquantile_sampled_slides``, counted
by the kernel's counting build while the program traces
(``ops/winquantile.py`` ``COUNTERS``; in one block of ``SAMPLE_EVERY``). Read by ``perfbench/counters.py``; nothing to read where
the program has no such counter."""

from perfbench.counters import stretch_counters


def read(run):
    counters = stretch_counters(run)
    slides = counters.get("winquantile_sampled_slides", 0)
    if not slides:
        return None
    return counters.get("winquantile_cycles_walk", 0) / slides
