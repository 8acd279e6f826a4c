"""indicator.missing_ms: the device milliseconds a call of the operations
launched inside the program's ``indicator.missing`` spans (``core/
indicator.py`` ``Indicator.__call__``'s missing-value masks: each input's
valid-value count per period and the mask of the outputs), summed over
their durations, in the traced run's second stretch
(``perfbench/program.py``). Nothing to read where the program has no such
span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("indicator.missing",))
