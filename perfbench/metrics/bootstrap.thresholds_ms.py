"""bootstrap.thresholds_ms: the device milliseconds a call of the operations
launched inside the program's ``bootstrap.thresholds`` spans (each in-base
year's replaced-year thresholds, ``core/bootstrapping.py``), summed over
their durations, in the traced run's second stretch (``perfbench/program.py``).
Nothing to read where the program has no such span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("bootstrap.thresholds",))
