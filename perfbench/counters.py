"""The program's counters in a traced run's second stretch.

The readers of the kernels' counters ask :func:`program.stretch
<perfbench.program.stretch>` for the stretch (made once a run), then read
the counters of its ``tracing()`` block from
``xclim_tpu_torch.utils.profiling.last_trace()``, where the amounts the
kernels' counting builds wrote on the device are ints once the block has
exited. A program without ``last_trace`` (or without tracing) gives an
empty reading.
"""

import importlib

from perfbench import program


def stretch_counters(run) -> dict:
    """The counters of the second stretch's ``tracing()`` block; {} where
    the program has none."""
    if not program.stretch(run):
        return {}
    profiling = importlib.import_module("xclim_tpu_torch.utils.profiling")
    last = getattr(profiling, "last_trace", lambda: None)()
    return dict(last.counters) if last is not None else {}
