"""Frontend and planner: the self ms of the ``parse``, ``plan`` and
``optimize`` spans a statement opens inside ``Engine.sql``, per query, over
the program's traced replay of the traced queries
(``_program_trace.py``)."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["parse_plan_ms"]
