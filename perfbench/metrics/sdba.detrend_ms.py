"""sdba.detrend_ms: the device milliseconds a call of the operations
launched inside the program's ``sdba.detrend`` spans (``sdba/adjustment.py``
``_dqm_adjust_core``: DQM's least-squares line a cell, its batched solve,
the re-centred trend and the retrend), summed over their durations, in the
traced run's second stretch (``perfbench/program.py``). Nothing to read
where the program has no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("sdba.detrend",))
