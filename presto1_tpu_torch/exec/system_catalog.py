"""System tables: engine/runtime state queryable through SQL.

The analog of the reference's system connector + JMX plugin surface
(``system.runtime.queries`` / ``system.runtime.nodes`` via
``server/QueryStateInfoResource`` data, ``plugin/trino-jmx`` for internal
counters): each table rebuilds from a live provider on every scan, so
``SELECT * FROM system.runtime.queries`` always reflects current state.

The tables describe the engine's own device: ``system.runtime.nodes``
names it (``device``: ``cuda:0 <card name>`` or ``cpu``), and on a CUDA
engine ``system.runtime.memory`` adds a row for the card's memory from
``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, encode_dictionary, to_device
from ..types import BIGINT, DOUBLE, SqlType, VARCHAR
from .catalog import Catalog, Table
from .events import QueryEvent
from .memory_catalog import MemoryTable


class DynamicTable(Table):
    """A table whose rows come from a provider on every scan (no caching)."""

    def __init__(self, name: str, schema: List[Tuple[str, SqlType]],
                 provider: Callable[[], Dict[str, np.ndarray]],
                 device="cuda"):
        super().__init__(name, schema, device=device)
        self.provider = provider

    @property
    def num_rows(self) -> int:
        data = self.provider()
        first = next(iter(data.values()), np.empty(0))
        return int(len(first))

    def column(self, name: str, device=None) -> Column:
        # rebuild every time -- system state is live
        data = self.provider()
        return self._column_from(name, data, self._rows(data), device)

    def batch(self, columns=None, device=None) -> RecordBatch:
        cols = columns if columns is not None else self.column_order
        data = self.provider()
        n = self._rows(data)
        return RecordBatch(
            {c: self._column_from(c, data, n, device) for c in cols}, n)

    def host_column(self, name: str) -> Column:
        data = self.provider()
        return self._column_from(name, data, self._rows(data), "cpu")

    @staticmethod
    def _rows(data: Dict[str, np.ndarray]) -> int:
        return int(len(next(iter(data.values()), np.empty(0))))

    def _column_from(self, name: str, data: Dict[str, np.ndarray], n: int,
                     device) -> Column:
        device = self.device if device is None else torch.device(device)
        t = self.schema[name]
        vals = data[name]
        if t.is_string:
            arr = np.asarray(vals, dtype="U") if n else np.empty(0, "U1")
            dictionary, codes = encode_dictionary(arr)
            if len(codes) == 0:
                codes = np.zeros(1, np.int32)
            return Column(to_device(codes, device), t, dictionary=dictionary)
        arr = np.asarray(vals, dtype=t.np_dtype) if n else \
            np.zeros(1, dtype=t.np_dtype)
        return Column(to_device(arr, device), t)


class QueryHistory:
    """EventBus listener retaining recent query lifecycle state: the last
    ``limit`` statements, each also found by its id until it leaves."""

    def __init__(self, limit: int = 1000):
        self.entries: deque = deque(maxlen=limit)
        self.by_id: Dict[str, dict] = {}

    def __call__(self, event: QueryEvent) -> None:
        e = self.by_id.get(event.query_id)
        if e is None or event.kind == "created":
            e = {"query_id": event.query_id, "user": event.user,
                 "query": event.sql, "state": "RUNNING",
                 "created": event.ts, "wall_s": 0.0, "rows": 0}
            if len(self.entries) == self.entries.maxlen:
                gone = self.entries[0]
                if self.by_id.get(gone["query_id"]) is gone:
                    del self.by_id[gone["query_id"]]
            self.by_id[event.query_id] = e
            self.entries.append(e)
        if event.kind == "completed":
            e["state"] = "FINISHED"
            e["wall_s"] = event.wall_s or 0.0
            e["rows"] = event.rows or 0
        elif event.kind == "failed":
            e["state"] = "FAILED"
            e["wall_s"] = event.wall_s or 0.0


def device_name(device: torch.device) -> str:
    """``cuda:<i> <card name>`` for a CUDA device, else the device's type."""
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return f"cuda:{index} {torch.cuda.get_device_name(index)}"
    return device.type


def attach_system_tables(catalog: Catalog, engine) -> None:
    """Register system.runtime.* tables backed by live engine state."""
    history = QueryHistory()
    engine.events.register(history)
    started = time.time()
    device = torch.device(engine.device)

    def queries() -> Dict[str, np.ndarray]:
        rows = list(history.entries)
        return {
            "query_id": np.array([r["query_id"] for r in rows], object),
            "state": np.array([r["state"] for r in rows], object),
            "user": np.array([r["user"] for r in rows], object),
            "query": np.array([r["query"] for r in rows], object),
            "wall_s": np.array([r["wall_s"] for r in rows], np.float64),
            "rows": np.array([r["rows"] for r in rows], np.int64),
        }

    def nodes() -> Dict[str, np.ndarray]:
        registry = getattr(engine, "registry", None)
        if registry is not None:
            ns = registry.all_nodes()
            return {
                "node_id": np.array([n.node_id for n in ns], object),
                "http_uri": np.array([n.uri for n in ns], object),
                "state": np.array(
                    ["shutting_down" if n.shutting_down else "active"
                     for n in ns], object),
                "success_rate": np.array([n.success_rate for n in ns],
                                         np.float64),
                "device": np.array([device_name(device)] * len(ns), object),
            }
        return {
            "node_id": np.array(["local"], object),
            "http_uri": np.array(["local://"], object),
            "state": np.array(["active"], object),
            "success_rate": np.array([1.0], np.float64),
            "device": np.array([device_name(device)], object),
        }

    def memory() -> Dict[str, np.ndarray]:
        pool = getattr(engine, "memory_pool", None)
        names, capacity, reserved = ["general"], [0], [0]
        if pool is not None:
            info = pool.info()
            capacity, reserved = [info["capacity"]], [info["reserved"]]
        if device.type == "cuda":
            free, total = torch.cuda.mem_get_info(device)
            names.append(device_name(device))
            capacity.append(total)
            reserved.append(total - free)
        return {"pool": np.array(names, object),
                "capacity_bytes": np.array(capacity, np.int64),
                "reserved_bytes": np.array(reserved, np.int64)}

    def uptime() -> Dict[str, np.ndarray]:
        return {"uptime_s": np.array([time.time() - started], np.float64)}

    def metrics() -> Dict[str, np.ndarray]:
        from .metrics import REGISTRY

        rows = REGISTRY.snapshot()
        return {
            "name": np.array([r["name"] for r in rows], object),
            "kind": np.array([r["kind"] for r in rows], object),
            "total": np.array([r["total"] for r in rows], np.float64),
            "one_minute": np.array([r["one_minute"] for r in rows],
                                   np.float64),
            "min": np.array([r["min"] for r in rows], np.float64),
            "max": np.array([r["max"] for r in rows], np.float64),
            "avg": np.array([r["avg"] for r in rows], np.float64),
        }

    def table(name, schema, provider):
        catalog.tables[name] = DynamicTable(name, schema, provider,
                                            device=device)

    table("system.runtime.queries",
          [("query_id", VARCHAR), ("state", VARCHAR), ("user", VARCHAR),
           ("query", VARCHAR), ("wall_s", DOUBLE), ("rows", BIGINT)],
          queries)
    table("system.runtime.nodes",
          [("node_id", VARCHAR), ("http_uri", VARCHAR), ("state", VARCHAR),
           ("success_rate", DOUBLE), ("device", VARCHAR)], nodes)
    table("system.runtime.metrics",
          [("name", VARCHAR), ("kind", VARCHAR), ("total", DOUBLE),
           ("one_minute", DOUBLE), ("min", DOUBLE), ("max", DOUBLE),
           ("avg", DOUBLE)], metrics)
    table("system.runtime.memory",
          [("pool", VARCHAR), ("capacity_bytes", BIGINT),
           ("reserved_bytes", BIGINT)], memory)
    table("system.runtime.uptime", [("uptime_s", DOUBLE)], uptime)


class BlackholeTable(MemoryTable):
    """trino-blackhole analog: swallow writes, optionally emit synthetic
    rows with a configurable per-scan latency (scheduler/perf tests)."""

    def __init__(self, name: str, schema: List[Tuple[str, SqlType]],
                 rows_per_scan: int = 0, latency_s: float = 0.0,
                 device="cuda"):
        super().__init__(name, schema, device=device)
        self.rows_per_scan = rows_per_scan
        self.latency_s = latency_s

    def append(self, batch) -> int:
        n = batch.num_rows if isinstance(batch.num_rows, int) \
            else int(batch.num_rows)
        return n  # swallowed

    @property
    def num_rows(self) -> int:
        return self.rows_per_scan

    def host_column(self, column: str) -> Column:
        t = self.schema[column]
        n = max(self.rows_per_scan, 1)
        if t.is_string:
            dictionary, _ = encode_dictionary(np.array(["x"], "U"))
            return Column(np.zeros(n, np.int32), t, dictionary=dictionary)
        return Column(np.zeros(n, dtype=t.np_dtype), t)

    def _load(self, column: str, device) -> Column:
        if self.latency_s:
            time.sleep(self.latency_s)
        c = self.host_column(column)
        return Column(to_device(c.data, device), c.type,
                      dictionary=c.dictionary)
