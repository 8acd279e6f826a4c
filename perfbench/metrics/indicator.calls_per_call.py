"""indicator.calls_per_call: the indicator calls a call makes (the
program's ``indicator_calls`` counter, one an ``Indicator.__call__`` in
``core/indicator.py``, an empty ``xtt:indicator_calls`` range each),
counted in the traced run's second stretch (``perfbench/program.py``'s
``span_counts``) over its calls: a guard that the suite runs whole.
Nothing to read where the program has no such counter."""

from perfbench import program


def read(run):
    p = program.stretch(run)
    if not p or "indicator_calls" not in p["span_counts"]:
        return None
    return p["span_counts"]["indicator_calls"] / p["calls"]
