"""Client and server: what the statement protocol adds to a query, in ms,
the mean over the traced run's queries that the profile did not cover of
the client's latency less the coordinator's own wall (the client's poll
sleeps, the HTTP round trips and the JSON both ways)."""

import statistics


def read(run):
    rest = [r.latency - r.numbers["server_wall_s"] for r in run.untraced
            if r.numbers and r.numbers.get("server_wall_s") is not None]
    return 1e3 * statistics.fmean(rest) if rest else None
