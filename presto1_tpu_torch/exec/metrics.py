"""Per-component counters and rate/distribution stats.

The analog of airlift's ``CounterStat``/``DistributionStat`` gauges that the
reference hangs on every hot component (``operator/ExchangeClientStatus``,
``execution/SqlTaskIoStats``, ``executor/TaskExecutor`` JMX ``@Managed``
getters — SURVEY §5.5).  A process-global registry; components bump named
counters/distributions, and ``system.runtime.metrics`` exposes them through
SQL the way plugin/trino-jmx exposes MBeans.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Tuple


class CounterStat:
    """Monotonic counter with 1-minute rate (airlift CounterStat analog:
    total + decayed one-minute window, simplified to a ring of 60s)."""

    __slots__ = ("total", "_events", "_lock")

    def __init__(self):
        self.total = 0
        self._events: Deque[Tuple[float, int]] = deque()
        self._lock = threading.Lock()

    def update(self, n: int = 1) -> None:
        now = time.time()
        with self._lock:
            self.total += n
            self._events.append((now, n))
            cutoff = now - 60.0
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    def one_minute_count(self) -> int:
        cutoff = time.time() - 60.0
        with self._lock:
            return sum(n for t, n in self._events if t >= cutoff)


class DistributionStat:
    """Streaming min/max/sum/count (+avg) of observed values."""

    __slots__ = ("count", "total", "min", "max", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, CounterStat] = {}
        self._dists: Dict[str, DistributionStat] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> CounterStat:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, CounterStat())
        return c

    def distribution(self, name: str) -> DistributionStat:
        d = self._dists.get(name)
        if d is None:
            with self._lock:
                d = self._dists.setdefault(name, DistributionStat())
        return d

    def snapshot(self) -> List[dict]:
        out = []
        with self._lock:
            counters = dict(self._counters)
            dists = dict(self._dists)
        for name, c in sorted(counters.items()):
            out.append({"name": name, "kind": "counter",
                        "total": float(c.total),
                        "one_minute": float(c.one_minute_count()),
                        "min": 0.0, "max": 0.0, "avg": 0.0})
        for name, d in sorted(dists.items()):
            out.append({"name": name, "kind": "distribution",
                        "total": d.total, "one_minute": 0.0,
                        "min": d.min if d.count else 0.0,
                        "max": d.max if d.count else 0.0,
                        "avg": d.avg()})
        return out


# process-global registry (the JMX MBean server analog)
REGISTRY = MetricsRegistry()
