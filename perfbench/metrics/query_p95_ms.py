"""The whole query: the 95th percentile of every query's latency, in ms,
every session's, over the traced run's queries that the profile did not
cover (``latency_p95_ms``'s arithmetic on a traced run's untraced rest).
It stands per layer in the cells whose tail moves too far between runs to
carry ``latency_p95_ms``'s bound."""

import numpy as np


def read(run):
    lat = [r.latency for r in run.untraced]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
