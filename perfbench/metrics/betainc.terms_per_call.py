"""betainc.terms_per_call: the continued-fraction steps a call that the
t-test's incomplete beta function evaluates (the program's
``betainc_terms`` counter, ``ensembles/_robustness.py`` ``_betainc``: one a
loop step, each ending in a host sync, an empty ``xtt:betainc_terms`` range
each), counted in the traced run's second stretch
(``perfbench/program.py``'s ``span_counts``) over its calls. Nothing to
read where the program has no such counter."""

from perfbench import program


def read(run):
    p = program.stretch(run)
    if not p or "betainc_terms" not in p["span_counts"]:
        return None
    return p["span_counts"]["betainc_terms"] / p["calls"]
