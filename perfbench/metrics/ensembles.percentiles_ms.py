"""ensembles.percentiles_ms: the device milliseconds a call of the operations
launched inside the program's ``ensembles.percentiles`` span
(``ensembles/_base.py`` ``ensemble_percentiles``' work on one array: the
quantiles over the members, on the card one axisquantile launch, and the
split into one array a percentile), summed over their durations, in the
traced run's second stretch (``perfbench/program.py``). Nothing to read
where the program has no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("ensembles.percentiles",))
