"""percentiles.doy_ms: the median milliseconds, over the traced window's
calls, of the benchmark's span ``percentiles.doy`` around
``core.percentiles.percentile_doy`` of the base period's slice (host clock,
ended by a synchronize)."""

import statistics

SPAN = "percentiles.doy"


def read(run):
    times = run.spans.get(SPAN)
    return statistics.median(times) * 1e3 if times else None
