"""indicator.idle_ms: the device's idle milliseconds a call in the gaps that
begin while a program ``indicator.call`` span (``Indicator.__call__``) is
open, in the traced run's second stretch (``perfbench/program.py``).
Nothing to read where the program has no such span."""

from perfbench import program


def read(run):
    return program.idle_ms_per_call(run, ("indicator.call",))
