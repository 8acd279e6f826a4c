"""sdba.adjust_ms: the median milliseconds, over the traced window's calls, of
the benchmark's span ``sdba.adjust`` around the trained adjuster's
``.adjust(sim)`` (host clock, ended by a synchronize)."""

import statistics

SPAN = "sdba.adjust"


def read(run):
    times = run.spans.get(SPAN)
    return statistics.median(times) * 1e3 if times else None
