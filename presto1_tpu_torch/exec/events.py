"""Query event pipeline.

The analog of the reference's EventListener SPI + QueryMonitor
(``spi/eventlistener/EventListener.java``, ``event/QueryMonitor.java``):
structured query-lifecycle events dispatched to registered listeners; a
JSONL file listener ships in-box.  ``system.runtime.queries`` is one
listener (``exec/system_catalog.py::QueryHistory``).

A statement run with tracing on (``Engine(trace=True)``) ends in an event
that carries its ``QueryTrace`` (``trace.py``).  To write every traced
statement's spans to a file::

    engine.events.register(jsonl_listener("traces.jsonl"))
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field, fields
from typing import Callable, List, Optional


@dataclass
class QueryEvent:
    kind: str  # 'created' | 'completed' | 'failed'
    query_id: str
    sql: str
    user: str
    ts: float = field(default_factory=time.time)
    wall_s: Optional[float] = None
    rows: Optional[int] = None
    error: Optional[str] = None
    trace: Optional[object] = None  # trace.py QueryTrace


class EventBus:
    def __init__(self):
        self._listeners: List[Callable[[QueryEvent], None]] = []

    def register(self, listener: Callable[[QueryEvent], None]) -> None:
        self._listeners.append(listener)

    def emit(self, event: QueryEvent) -> None:
        for fn in self._listeners:
            try:
                fn(event)
            except Exception:
                pass  # listeners must not break queries


def jsonl_listener(path: str):
    """A listener that appends each event to ``path`` as one JSON line, a
    trace as its spans as they are when the event is emitted
    (a completed statement's ``to_host`` span comes later)."""
    def listen(event: QueryEvent) -> None:
        row = {f.name: getattr(event, f.name) for f in fields(event)}
        if event.trace is not None:
            row["trace"] = event.trace.to_dict()
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    return listen
