"""ensembles.idle_ms: the device's idle milliseconds a call in the gaps that
begin while a program ``ensembles.percentiles`` or ``ensembles.robustness``
span (``ensemble_percentiles``' work on one array, ``robustness_fractions``)
is open, in the traced run's second stretch (``perfbench/program.py``): the
program's own host work and waits, apart from the harness's between and
around its calls. Nothing to read where the program has no such span."""

from perfbench import program


def read(run):
    return program.idle_ms_per_call(
        run, ("ensembles.percentiles", "ensembles.robustness"))
