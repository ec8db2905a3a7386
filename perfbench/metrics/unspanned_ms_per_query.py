"""Frontend: host ms a replayed statement spends in none of the program's
root spans (``statement``, ``to_host``), per query, over the program's
traced replay (``_program_trace.py``).  Where the replay sends each text
through ``Engine.execute_statement``, as the coordinator's query manager
does (the ``protocol`` driver), this is above all that method's parse of
the text before ``Engine.sql``, which a plan-cache hit does not skip."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["unspanned_ms_per_query"]
