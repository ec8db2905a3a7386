"""Executor: the self ms of the ``statement`` span, per query: what
``Engine.sql`` does around the work of its child spans (events, the metrics
registry, the plan-cache lookup, access checks, the batch's assembly), over
the program's traced replay (``_program_trace.py``)."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["statement_self_ms"]
