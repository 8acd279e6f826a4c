"""ensembles.betainc_ms: the device milliseconds a call of the operations
launched inside the program's ``ensembles.betainc`` span
(``ensembles/_robustness.py`` ``_betainc``: the t-test's regularized
incomplete beta function, its continued fraction evaluated step by step
until every element has converged), summed over their durations, in the
traced run's second stretch (``perfbench/program.py``). Nothing to read
where the program has no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("ensembles.betainc",))
