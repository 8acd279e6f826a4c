"""indices.runlength_ms: the device milliseconds a call of the operations
launched inside the program's ``runlength.runs`` spans (``ops/
runlength.py``'s run statistics: the longest runs of CSU, CFD, CDD and
CWD, on the card through the spells kernel) and ``runlength.season`` spans
(``indices/run_length.py``'s season parts: GSL's first runs before and
after 1 July), summed over their durations, in the traced run's second
stretch (``perfbench/program.py``). The program opens neither span inside
the other, nor inside one of its own name, so no operation counts twice.
Nothing to read where the program has neither span."""

from perfbench import program


def read(run):
    return program.span_ms_per_call(run, ("runlength.runs",
                                          "runlength.season"))
