"""The 90th percentile of the intervals between consecutive step ends
(CUDA events, no synchronize between), over every step of the window."""

import statistics


def read(rec):
    v = rec['intervals_ms']
    if len(v) < 10:
        return None
    return statistics.quantiles(v, n=10, method='inclusive')[-1]
