"""eqm.node_passes_per_call: the passes a call over the gathered values
that EQM's bracketing among the quantile nodes makes (the program's
``eqm_node_passes`` counter, ``sdba/utils.py`` ``interp_on_quantiles``: one
a node, an empty ``xtt:eqm_node_passes`` range each), counted in the traced
run's second stretch (``perfbench/program.py``'s ``span_counts``) over its
calls. Nothing to read where the program has no such counter."""

from perfbench import program


def read(run):
    p = program.stretch(run)
    if not p or "eqm_node_passes" not in p["span_counts"]:
        return None
    return p["span_counts"]["eqm_node_passes"] / p["calls"]
