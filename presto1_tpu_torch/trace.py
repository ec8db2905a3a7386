"""Statement traces: one statement's host timeline.

A ``QueryTrace`` is kept with tracing on (``Engine(trace=True)``): spans
where the work happens (``Engine.sql``, the frontend, each compiled
fragment, each operator, every host read of a device value, ``to_pylist``).
Spans read ``time.perf_counter_ns``, the clock a profiler's trace is set onto
by its caller, so a device timeline and a statement's spans share one clock.

Sites find the statement through one ``ContextVar`` (``TRACE``), None when
tracing is off; each reads it once and does nothing more then.  This module
imports nothing of the package, so the data, operator and executor layers
all record into it.
"""

from __future__ import annotations

import time
from contextvars import ContextVar
from typing import Dict, List, Optional

import torch

# the clock of every span (a module attribute, so a test can count its calls)
clock_ns = time.perf_counter_ns


class QueryTrace:
    """One statement's spans.

    ``spans``: ``[name, start_ns, end_ns, parent, detail]`` in the order
    they began; ``parent`` is the index of the span open when it began
    (None at a root), ``detail`` a fragment's root path, a wait's bytes,
    an operator's plan node id (``node_ids``), a graph replay's
    operator counts (``operator_counts``) or a readback's rows, columns
    and columns converted in bulk (``RecordBatch.to_pylist``).
    Spans of one trace are opened and closed by one thread, so they nest:
    a child lies inside its parent, and siblings do not overlap.  A
    statement has two roots, ``statement`` and, once its batch is read,
    ``to_host``."""

    __slots__ = ("query_id", "spans", "_open", "node_ids", "subtrees")

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.spans: List[list] = []
        self._open: Optional[int] = None
        # the statement's plan node ids: id(node) -> (node, id), one id
        # for every subtree of one structure (``subtrees``: a node's own
        # fields and its children's ids -> id), so two executions of equal
        # subtrees share it
        self.node_ids: Dict[int, tuple] = {}
        self.subtrees: Dict[str, int] = {}

    def begin(self, name: str, detail=None) -> int:
        i = len(self.spans)
        self.spans.append([name, clock_ns(), None, self._open, detail])
        self._open = i
        return i

    def end(self, i: int) -> None:
        span = self.spans[i]
        span[2] = clock_ns()
        self._open = span[3]

    def span(self, name: str, detail=None) -> "_Span":
        return _Span(self, name, detail)

    def wait(self, read, x, nbytes: int):
        """``read(x)``, a host read of a device value, as a ``wait`` span
        with its bytes."""
        i = self.begin("wait", nbytes)
        try:
            return read(x)
        finally:
            self.end(i)

    def self_ns(self) -> Dict[str, int]:
        """ns by span name, each span's duration less its children's (they
        nest inside it without overlapping)."""
        own = [s[2] - s[1] for s in self.spans]
        for s in self.spans:
            if s[3] is not None:
                own[s[3]] -= s[2] - s[1]
        out: Dict[str, int] = {}
        for s, ns in zip(self.spans, own):
            out[s[0]] = out.get(s[0], 0) + ns
        return out

    def to_dict(self) -> dict:
        keys = ("name", "start_ns", "end_ns", "parent", "detail")
        return {"query_id": self.query_id,
                "spans": [dict(zip(keys, s)) for s in self.spans]}


def operator_counts(spans) -> Dict[str, int]:
    """Among ``spans``, the operator executions (``op:`` spans but a graph
    replay's) and the reruns: executions of a plan node id that an
    earlier one executed, a subtree the statement had computed already."""
    seen, ops, reruns = set(), 0, 0
    for s in spans:
        if s[0].startswith("op:") and s[0] != "op:GraphReplay":
            ops += 1
            reruns += s[4] in seen
            seen.add(s[4])
    return {"operators": ops, "reruns": reruns}


class _Span:
    __slots__ = ("trace", "name", "detail", "i")

    def __init__(self, trace: QueryTrace, name: str, detail):
        self.trace, self.name, self.detail = trace, name, detail

    def __enter__(self):
        self.i = self.trace.begin(self.name, self.detail)
        return self

    def __exit__(self, *exc):
        self.trace.end(self.i)
        return False


class _Entered(_Span):
    """A root span during which ``trace`` is the one traced on this
    thread."""

    __slots__ = ("token",)

    def __enter__(self):
        self.token = TRACE.set(self.trace)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__()
        TRACE.reset(self.token)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()

# the statement being traced on this thread; None when tracing is off
TRACE: ContextVar[Optional[QueryTrace]] = ContextVar("query_trace",
                                                     default=None)


def span(name: str, detail=None):
    """A span of the statement traced on this thread, or nothing."""
    trace = TRACE.get()
    return _NO_SPAN if trace is None else _Span(trace, name, detail)


def enter(trace: Optional[QueryTrace], name: str, detail=None):
    """Span ``name`` of ``trace``, traced on this thread meanwhile (a
    statement's batch read after ``Engine.sql`` returned), or nothing."""
    return _NO_SPAN if trace is None else _Entered(trace, name, detail)


def host_read(x, read=int):
    """``read(x)`` where ``x`` may be a tensor: the one way the statement
    path reads a device value on the host.  A tensor's read is a ``wait``
    of the statement traced on this thread (an empty one copies nothing)."""
    if not isinstance(x, torch.Tensor):
        return read(x)
    trace = TRACE.get()
    if trace is None or x.numel() == 0:
        return read(x)
    return trace.wait(read, x, x.numel() * x.element_size())
