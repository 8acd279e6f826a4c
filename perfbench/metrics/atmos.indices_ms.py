"""atmos.indices_ms: the median milliseconds, over the traced window's calls,
of the benchmark's span ``atmos.indices`` around ``atmos.tx90p`` and
``atmos.warm_spell_duration_index`` together (host clock, ended by a
synchronize)."""

import statistics

SPAN = "atmos.indices"


def read(run):
    times = run.spans.get(SPAN)
    return statistics.median(times) * 1e3 if times else None
