"""betainc.terms_per_element: the continued-fraction terms an element of
the incomplete beta function evaluates (the term at which it converged,
199 where it never did, 0 for a special case), in the traced run's second
stretch (``perfbench/program.py``): ``betainc_element_terms`` over
``betainc_elements``, counted by the kernel's counting build while the
program traces (``ops/betainc.py`` ``COUNTERS``: the elements of one block
in ``SAMPLE_EVERY``; by the twin on the CPU).
Read by ``perfbench/counters.py``; nothing to read where the program has
no such counter."""

from perfbench.counters import stretch_counters


def read(run):
    counters = stretch_counters(run)
    elements = counters.get("betainc_elements", 0)
    if not elements:
        return None
    return counters.get("betainc_element_terms", 0) / elements
