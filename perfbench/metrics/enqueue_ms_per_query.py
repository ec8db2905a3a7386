"""Executor: the self ms of the ``run``, ``fragment``, ``execute`` and
``op:*`` spans, per query: the host's enqueue of the device work, the waits
for the device left out, over the program's traced replay
(``_program_trace.py``)."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["enqueue_ms_per_query"]
