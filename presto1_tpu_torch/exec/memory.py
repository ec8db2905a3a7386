"""Device-memory accounting: per-query contexts + a shared pool.

The reference tracks memory in a 3-level hierarchy (operator -> task ->
query pools; ``lib/trino-memory-context``, ``memory/MemoryPool.java``),
blocks or kills queries on pool exhaustion
(``memory/TotalReservationOnBlockedNodesLowMemoryKiller.java``), and
enforces per-query limits.  Every operator output here is a padded device
buffer whose size is known without a device sync (capacity x row width), so
the accounting is exact on the host.

* :class:`QueryMemoryContext` -- per-query tree of operator reservations
  keyed by plan path; a parent's completion frees its consumed children
  (post-order execution means child buffers die when the parent
  materialises).  Enforces ``query_max_memory``.
* :class:`MemoryPool` -- process-wide byte budget shared by concurrent
  queries; exhaustion triggers the low-memory killer (largest reservation
  dies, the reference's TotalReservation strategy).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

Path = Tuple[int, ...]


class ExceededMemoryLimitError(Exception):
    pass


class QueryKilledError(Exception):
    pass


def batch_bytes(batch) -> int:
    """Device bytes of a RecordBatch: ``numel() * element_size()`` of every
    column's data, validity and lengths (the JAX package's count for flat
    columns; a nested column's ``[n, W]`` element matrix counts whole)."""
    total = 0
    for c in batch.columns.values():
        for t in (c.data, c.validity, c.lengths):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


class QueryMemoryContext:
    """Per-query operator-level accounting (AggregatedMemoryContext analog)."""

    def __init__(self, query_id: str = "",
                 max_bytes: Optional[int] = None,
                 pool: Optional["MemoryPool"] = None):
        self.query_id = query_id
        self.max_bytes = max_bytes
        self.pool = pool
        self.entries: Dict[Path, int] = {}
        self.current = 0
        self.peak = 0
        self.killed: Optional[str] = None
        self._lock = threading.Lock()

    def set_bytes(self, path: Path, nbytes: int) -> None:
        with self._lock:
            if self.killed:
                raise QueryKilledError(self.killed)
            # the node at `path` just materialised: its children's outputs
            # are consumed and their buffers dead
            before = self.current
            for p in [p for p in self.entries
                      if len(p) > len(path) and p[:len(path)] == path]:
                self.current -= self.entries.pop(p)
            self.current += nbytes - self.entries.get(path, 0)
            self.entries[path] = nbytes
            self.peak = max(self.peak, self.current)
            delta = self.current - before
        if self.max_bytes is not None and self.current > self.max_bytes:
            raise ExceededMemoryLimitError(
                f"query exceeded per-query memory limit: "
                f"{self.current} > {self.max_bytes} bytes")
        # the pool holds what the query holds: freed children go back to
        # it (the JAX package reserves every growth and returns only the
        # query's last bytes, so its pool leaks: ROADMAP C8)
        if self.pool is not None and delta > 0:
            self.pool.reserve(self, delta)
        elif self.pool is not None and delta < 0:
            self.pool.free(-delta)

    def release_all(self) -> None:
        with self._lock:
            freed = self.current
            self.entries.clear()
            self.current = 0
        if self.pool is not None and freed > 0:
            self.pool.free(freed)

    def kill(self, reason: str) -> None:
        self.killed = reason


class MemoryPool:
    """Shared byte budget with a low-memory killer.

    ``reserve`` never blocks (an operator cannot yield mid-launch to be
    resumed later): on exhaustion it kills the largest consumer -- the
    requesting query itself if it is the largest."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.reserved = 0
        self.queries: Dict[str, QueryMemoryContext] = {}
        self._lock = threading.Lock()

    def register(self, ctx: QueryMemoryContext) -> None:
        with self._lock:
            self.queries[ctx.query_id] = ctx

    def unregister(self, ctx: QueryMemoryContext) -> None:
        with self._lock:
            self.queries.pop(ctx.query_id, None)

    def reserve(self, ctx: QueryMemoryContext, nbytes: int) -> None:
        with self._lock:
            if self.reserved + nbytes > self.capacity:
                victim = max(self.queries.values(),
                             key=lambda q: q.current, default=None)
                if victim is not None:
                    victim.kill(
                        "killed by the cluster low-memory killer "
                        f"(largest reservation: {victim.current} bytes)")
                if victim is ctx or victim is None:
                    raise ExceededMemoryLimitError(
                        f"memory pool exhausted: {self.reserved} + {nbytes} "
                        f"> {self.capacity} bytes")
            self.reserved += nbytes

    def free(self, nbytes: int) -> None:
        with self._lock:
            self.reserved = max(self.reserved - nbytes, 0)

    def info(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "reserved": self.reserved,
                "queries": {q: c.current for q, c in self.queries.items()},
            }
