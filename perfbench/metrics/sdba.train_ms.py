"""sdba.train_ms: the median milliseconds, over the traced window's calls, of
the benchmark's span ``sdba.train`` around the configured sdba method's
``.train(ref, hist)`` (host clock, ended by a synchronize)."""

import statistics

SPAN = "sdba.train"


def read(run):
    times = run.spans.get(SPAN)
    return statistics.median(times) * 1e3 if times else None
