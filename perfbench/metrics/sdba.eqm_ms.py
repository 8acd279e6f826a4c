"""sdba.eqm_ms: the device milliseconds a call of the operations launched
inside the program's ``sdba.eqm`` span (``sdba/adjustment.py``
``_eqm_adjust_body``: EQM's adjust of DQM's detrended series, the group
gather, the bracketing among the quantile nodes, the interpolation and the
un-gather), summed over their durations, in the traced run's second
stretch (``perfbench/program.py``). Nothing to read where the program has
no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("sdba.eqm",))
