"""sdba.scaling_ms: the device milliseconds a call of the operations
launched inside the program's ``sdba.scaling`` spans (``sdba/adjustment.py``:
DQM's train, the two windowed day-of-year means, their difference and the
scaled hist; its adjust, the scaling of sim), summed over their durations,
in the traced run's second stretch (``perfbench/program.py``). Nothing to
read where the program has no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("sdba.scaling",))
