"""Engine facade: SQL in, decoded results out.

The single-node analog of the reference's LocalQueryRunner
(``core/trino-main/.../testing/LocalQueryRunner.java``): wires parser ->
planner -> optimizer -> executor over a catalog with no server in between,
plus the query-lifecycle plumbing (sessions, events).

This slice of the port carries ``plan``, ``explain``, ``sql``,
``sql_pandas`` and ``compile``.  System tables (``attach_system_tables``)
and the statement surface beyond queries wait for ROADMAP A10, access
control and memory accounting for A9/A12, ``explain_analyze`` and sampled
discovery for A8.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..sql import parser as sql_parser
from ..sql.logical import LogicalNode, plan_tree
from ..sql.optimizer import optimize
from ..sql.planner import Planner
from .catalog import Catalog
from .events import EventBus, QueryEvent
from .executor import Executor
from .session import Session
from .stats import QueryStats


class Engine:
    def __init__(self, catalog: Catalog, session: Optional[Session] = None,
                 events: Optional[EventBus] = None, device="cuda"):
        self.catalog = catalog
        self.session = session or Session()
        self.events = events or EventBus()
        # where every query of this engine runs; nothing looks for another
        # device when this one is missing
        self.device = torch.device(device)
        self._compiled_cache: dict = {}

    def scan_tables(self, plan: LogicalNode) -> list:
        from ..sql.logical import Scan

        out, stack = [], [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, Scan):
                out.append(node.table)
            stack.extend(node.children)
        return out

    def _plan_ast(self, q, user: Optional[str] = None) -> LogicalNode:
        return optimize(Planner(self.catalog).plan(q), self.catalog)

    def plan(self, sql: str, user: Optional[str] = None) -> LogicalNode:
        return self._plan_ast(sql_parser.parse(sql), user)

    def explain(self, sql: str) -> str:
        return plan_tree(self.plan(sql))

    def sql(self, sql: str, stats: Optional[QueryStats] = None,
            user: Optional[str] = None):
        """Execute; returns the Output RecordBatch (display-named columns).

        A fresh Executor per statement: capacity/range records are
        plan-specific (sharing them across different plans would corrupt
        shapes)."""
        self.events.emit(QueryEvent("created", self.session.query_id, sql,
                                    self.session.user))
        t0 = time.time()
        try:
            if self.session.get("compile_queries") and stats is None:
                # plan-cache path (the reference caches plans per query
                # shape; here the cached artifact is the compiled fragments)
                cq = self._compiled_cache.get(sql)
                if cq is None:
                    cq = self.compile(sql, user=user)
                    self._compiled_cache[sql] = cq
                out = cq()
            else:
                plan = self.plan(sql, user=user)
                ex = Executor(self.catalog, stats=stats, device=self.device,
                              dynamic_filtering=self.session.get(
                                  "enable_dynamic_filtering"))
                out = ex.execute(plan)
                # eager-mode guards (wide-decimal sum overflow): the
                # compiled path ANDs these into its one readback
                for chk in ex.overflow_checks:
                    if not bool(chk):
                        raise ArithmeticError(
                            "aggregate overflow: a decimal sum "
                            "exceeded the 18-digit device decimal "
                            "(reference raises on decimal(38) "
                            "overflow too) -- cast to double or "
                            "reduce the scale")
            rows = out.num_rows if isinstance(out.num_rows, int) \
                else int(out.num_rows)
        except Exception as e:
            from .metrics import REGISTRY

            REGISTRY.counter("engine.queries_failed").update()
            self.events.emit(QueryEvent(
                "failed", self.session.query_id, sql, self.session.user,
                wall_s=time.time() - t0, error=str(e)))
            raise
        from .metrics import REGISTRY

        REGISTRY.counter("engine.queries_completed").update()
        REGISTRY.counter("engine.output_rows").update(rows)
        REGISTRY.distribution("engine.query_wall_s").add(time.time() - t0)
        self.events.emit(QueryEvent(
            "completed", self.session.query_id, sql, self.session.user,
            wall_s=time.time() - t0, rows=rows))
        if stats is not None:
            stats.wall_s = time.time() - t0
        return out

    def sql_pandas(self, sql: str):
        return self.sql(sql).to_pandas()

    def compile(self, sql: str, user: Optional[str] = None,
                sample: object = "auto"):
        """Fix the whole query pipeline into fragment callables over
        static shapes (runs one eager discovery pass, on this engine's
        device, to fix buffer capacities).

        ``sample`` is accepted for the reference's signature; sampled
        discovery is not in this slice of the port (ROADMAP A8), so
        discovery always runs on the full data."""
        from .executor import CompiledQuery

        plan = self.plan(sql, user=user)
        cq = CompiledQuery(self.catalog, plan, device=self.device)
        cq.scan_tables = self.scan_tables(plan)
        return cq
