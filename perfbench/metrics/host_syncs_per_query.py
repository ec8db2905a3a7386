"""Executor: the statement's ``wait`` spans, per query: host reads of a
device value, ``to_pylist``'s column copies among them, counted by site,
over the program's traced replay (``_program_trace.py``)."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["host_syncs_per_query"]
