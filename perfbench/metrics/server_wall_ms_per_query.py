"""Client and server: the coordinator's own wall of a statement
(``stats.wall_s`` on its FINISHED page: ``QueryManager._run``, the
statement, the decode and the JSON rows), in ms, the mean over the traced
run's queries that the profile did not cover."""

import statistics


def read(run):
    walls = [r.numbers["server_wall_s"] for r in run.untraced
             if r.numbers and r.numbers.get("server_wall_s") is not None]
    return 1e3 * statistics.fmean(walls) if walls else None
