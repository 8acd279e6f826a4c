"""setup_s: from the start of the process to the start of the window:
imports and the indicator registry, kernel builds (first run in a checkout
only) or loads, inputs from the seed, the mix's set-up stages and the
warm-up call."""


def read(run):
    return run.setup_s
