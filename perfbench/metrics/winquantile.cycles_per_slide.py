"""winquantile.cycles_per_slide: the warp cycles of winquantile's warp
instance a (cell, doy) slide, in the traced run's second stretch
(``perfbench/program.py``): the four ``winquantile_cycles_*`` counters
summed (the chunk-start sort, the slices' loads and sorts, the searches
and the walk, node selection with its write-out) over
``winquantile_sampled_slides``, the slides of the warps that timed them.
The program counts them in the kernel's counting build, which it launches
only while tracing (``ops/winquantile.py`` ``COUNTERS``; one block in
``SAMPLE_EVERY`` times its stages): clock64 cycles while each warp was
resident, not issue slots. Read by ``perfbench/counters.py``; nothing to read where the
program has no such counter."""

from perfbench.counters import stretch_counters

STAGES = ("sort", "slices", "walk", "nodes")


def read(run):
    counters = stretch_counters(run)
    slides = counters.get("winquantile_sampled_slides", 0)
    if not slides:
        return None
    return sum(counters.get(f"winquantile_cycles_{s}", 0)
               for s in STAGES) / slides
