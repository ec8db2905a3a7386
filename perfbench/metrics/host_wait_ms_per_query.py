"""Executor: the host-clock ms inside ``wait`` spans, per query: the host
reading device values back, waiting for the device to reach them and
turning the copies into host arrays, over the program's traced replay
(``_program_trace.py``).  Uploads are not waits: a synchronizing
host-to-device copy falls in the span that makes it."""

from . import _program_trace


def read(run):
    found = _program_trace.of(run)
    return None if found is None else found["host_wait_ms_per_query"]
