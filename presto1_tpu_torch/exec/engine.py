"""Engine facade: SQL in, decoded results out.

The single-node analog of the reference's LocalQueryRunner
(``core/trino-main/.../testing/LocalQueryRunner.java``): wires parser ->
planner -> optimizer -> executor over a catalog with no server in between,
plus the query-lifecycle plumbing (sessions, events).

The port carries ``plan``, ``explain``, ``explain_analyze``, ``sql`` (with
per-query memory accounting and spilling), ``sql_pandas``, ``compile`` (with
sampled discovery), ``compile_grouped`` and ``execute_statement``: EXPLAIN
[ANALYZE], CREATE TABLE [AS], INSERT (a query or VALUES), DROP TABLE and
SHOW / DESCRIBE over writable memory tables (``exec/memory_catalog.py``),
with the system tables (``exec/system_catalog.py``) attached to the catalog
and plan-time access control (``server/security.py``).  The query of a
CREATE TABLE AS or an INSERT runs under the same memory limit and spill
threshold as ``sql`` (the JAX package runs it unbounded: ROADMAP C10), and
VALUES decimals are parsed from their text exactly (C9).
``sql_distributed`` runs every eligible heavy stage over a mesh of logical
shards (``parallel/``), by default all on the engine's device.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import torch

from ..sql import parser as sql_parser
from ..sql.logical import LogicalNode, plan_tree
from ..sql.optimizer import optimize
from ..sql.planner import Planner
from ..trace import TRACE, QueryTrace, host_read, span
from .catalog import Catalog
from .events import EventBus, QueryEvent
from .executor import Executor
from .metrics import REGISTRY
from .session import Session
from .stats import QueryStats


class Engine:
    def __init__(self, catalog: Catalog, session: Optional[Session] = None,
                 events: Optional[EventBus] = None, memory_pool=None,
                 access_control=None, device="cuda", trace: bool = False):
        self.catalog = catalog
        self.session = session or Session()
        self.events = events or EventBus()
        self.memory_pool = memory_pool  # shared MemoryPool (optional)
        self.access_control = access_control  # server/security.AccessControl
        # where every query of this engine runs, and where the tables it
        # creates live; nothing looks for another device when this one is
        # missing
        self.device = torch.device(device)
        # with tracing on, each statement of ``sql`` keeps a QueryTrace
        # (``trace.py``), carried by its last event and its batch
        self.trace = trace
        self._statements = itertools.count(1)
        self._compiled_cache: dict = {}
        from .system_catalog import attach_system_tables

        attach_system_tables(self.catalog, self)

    def _statement_id(self) -> str:
        """A statement's own id: the session's and a sequence number."""
        return f"{self.session.query_id}.{next(self._statements)}"

    def _memory_context(self, query_id: str):
        """Per-query accounting when a limit or shared pool is configured."""
        limit = self.session.get("query_max_memory")
        if not limit and self.memory_pool is None:
            return None
        from .memory import QueryMemoryContext

        ctx = QueryMemoryContext(query_id,
                                 max_bytes=limit or None,
                                 pool=self.memory_pool)
        if self.memory_pool is not None:
            self.memory_pool.register(ctx)
        return ctx

    def _enforce_access(self, plan: LogicalNode, user: Optional[str]) -> None:
        """Plan-time access control on resolved Scan nodes, fail-closed.

        The reference checks table privileges during semantic analysis on
        resolved table handles (``security/AccessControlManager``,
        ``sql/analyzer/StatementAnalyzer``); checking the optimized plan's
        Scan set covers every reference -- FROM clauses, subqueries in any
        clause, CTEs -- because all of them lower to Scans."""
        acl = self.access_control
        if acl is None:
            return
        for table in self.scan_tables(plan):
            acl.check_can_select(user or self.session.user,
                                 self.session.catalog, table)

    @staticmethod
    def scan_tables(plan: LogicalNode) -> list:
        from ..sql.logical import Scan

        out, stack = [], [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, Scan):
                out.append(node.table)
            stack.extend(node.children)
        return out

    def _plan_ast(self, q, user: Optional[str] = None) -> LogicalNode:
        with span("plan"):
            plan = Planner(self.catalog).plan(q)
        # traced, the span's detail is the join search's counts
        detail = None if TRACE.get() is None else {}
        with span("optimize", detail):
            plan = optimize(plan, self.catalog, detail)
        self._enforce_access(plan, user)
        return plan

    def plan(self, sql: str, user: Optional[str] = None) -> LogicalNode:
        with span("parse"):
            q = sql_parser.parse(sql)
        return self._plan_ast(q, user)

    def explain(self, sql: str) -> str:
        return plan_tree(self.plan(sql))

    def sql(self, sql: str, stats: Optional[QueryStats] = None,
            user: Optional[str] = None):
        """Execute; returns the Output RecordBatch (display-named columns).

        A fresh Executor per statement: capacity/range records are
        plan-specific (sharing them across different plans would corrupt
        shapes).  With ``trace`` on, the statement's QueryTrace rides on its
        completed (or failed) event and on the batch, whose ``to_pylist`` /
        ``to_pandas`` add their ``to_host`` span to it."""
        query_id = self._statement_id()
        if not self.trace:
            return self._sql(sql, stats, user, query_id, None)
        trace = QueryTrace(query_id)
        token = TRACE.set(trace)
        try:
            return self._sql(sql, stats, user, query_id, trace)
        finally:
            TRACE.reset(token)

    def _sql(self, sql: str, stats: Optional[QueryStats],
             user: Optional[str], query_id: str,
             trace: Optional[QueryTrace]):
        if trace is not None:
            root = trace.begin("statement")
        self.events.emit(QueryEvent("created", query_id, sql,
                                    self.session.user))
        t0 = time.perf_counter()
        try:
            if self.session.get("compile_queries") and stats is None:
                # plan-cache path (the reference caches plans per query
                # shape; here the cached artifact is the compiled fragments)
                cq = self._compiled_cache.get(sql)
                if cq is None:
                    with span("compile"):
                        cq = self.compile(sql, user=user)
                    self._compiled_cache[sql] = cq
                if self.access_control is not None:
                    # re-check per call: the cache is shared across users
                    for t in cq.scan_tables:
                        self.access_control.check_can_select(
                            user or self.session.user,
                            self.session.catalog, t)
                out = cq()
            else:
                plan = self.plan(sql, user=user)
                with span("execute"):
                    out = self._execute(plan, stats, query_id)
            rows = host_read(out.num_rows)
        except Exception as e:
            wall = time.perf_counter() - t0
            REGISTRY.counter("engine.queries_failed").update()
            if trace is not None:
                trace.end(root)
            self.events.emit(QueryEvent(
                "failed", query_id, sql, self.session.user, wall_s=wall,
                error=str(e), trace=trace))
            raise
        wall = time.perf_counter() - t0
        REGISTRY.counter("engine.queries_completed").update()
        REGISTRY.counter("engine.output_rows").update(rows)
        REGISTRY.distribution("engine.query_wall_s").add(wall)
        if trace is not None:
            trace.end(root)
            out.trace = trace
        self.events.emit(QueryEvent(
            "completed", query_id, sql, self.session.user, wall_s=wall,
            rows=rows, trace=trace))
        if stats is not None:
            stats.wall_s = wall
        return out

    def _execute(self, plan: LogicalNode,
                 stats: Optional[QueryStats] = None,
                 query_id: Optional[str] = None):
        """Run a plan eagerly under the session's memory limit and spill
        threshold (``query_max_memory``, ``spill_threshold``)."""
        mem = self._memory_context(query_id or self._statement_id())
        try:
            ex = Executor(
                self.catalog, stats=stats, device=self.device, memory=mem,
                dynamic_filtering=self.session.get(
                    "enable_dynamic_filtering"),
                spill_threshold=(
                    self.session.get("spill_threshold")
                    if self.session.get("spill_enabled") else 0))
            out = ex.execute(plan)
            # eager-mode guards (wide-decimal sum overflow): the compiled
            # path ANDs these into its one readback
            for chk in ex.overflow_checks:
                if not host_read(chk, bool):
                    raise ArithmeticError(
                        "aggregate overflow: a decimal sum exceeded the "
                        "18-digit device decimal (reference raises on "
                        "decimal(38) overflow too) -- cast to double or "
                        "reduce the scale")
            return out
        finally:
            if mem is not None:
                mem.release_all()
                if self.memory_pool is not None:
                    self.memory_pool.unregister(mem)

    def sql_pandas(self, sql: str):
        return self.sql(sql).to_pandas()

    def execute_statement(self, sql: str, user: Optional[str] = None,
                          stats: Optional[QueryStats] = None):
        """Full statement surface: queries plus CREATE TABLE [AS] /
        INSERT INTO (query or VALUES) / DROP TABLE against writable
        in-memory tables on this engine's device (the trino-memory
        connector analog), EXPLAIN [ANALYZE] and SHOW / DESCRIBE.

        ``stats`` collects per-operator attribution for a query, and for
        the query of a CREATE TABLE AS or an INSERT, on the eager path (the
        compiled path ignores it -- its attribution lives in
        ``CompiledQuery.profile``)."""
        from ..sql import ast
        from ..sql.parser import parse_statement
        from ..sql.planner import parse_type
        from .memory_catalog import MemoryTable

        stmt = parse_statement(sql)
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                inner = sql[sql.lower().index("analyze") + len("analyze"):]
                text = self.explain_analyze(inner, user=user)
            else:
                inner = sql[sql.lower().index("explain") + len("explain"):]
                text = plan_tree(self.plan(inner, user=user))
            return self._strings({"plan": text.split("\n")}, width="U")
        if isinstance(stmt, ast.Query):
            return self.sql(sql, stats=stats, user=user)
        if isinstance(stmt, ast.CreateTable):
            if stmt.name in self.catalog:
                raise ValueError(f"table {stmt.name} already exists")
            if stmt.columns is not None:
                schema = [(c, parse_type(t)) for c, t in stmt.columns]
                self.catalog.tables[stmt.name] = MemoryTable(
                    stmt.name, schema, device=self.device)
                return self._dml_result(0)
            out = self._execute(self._plan_ast(stmt.as_query, user), stats)
            schema = [(n, c.type) for n, c in out.columns.items()]
            table = MemoryTable(stmt.name, schema, device=self.device)
            n = table.append(out)
            self.catalog.tables[stmt.name] = table
            return self._dml_result(n)
        if isinstance(stmt, ast.DropTable):
            if stmt.name not in self.catalog:
                raise ValueError(f"table {stmt.name} not found")
            del self.catalog.tables[stmt.name]
            return self._dml_result(0)
        if isinstance(stmt, ast.InsertInto):
            # write through the connector page sink (ConnectorPageSink):
            # rows buffer invisibly and commit atomically at finish() --
            # a failing INSERT ... SELECT leaves the table untouched
            table = self.catalog.table(stmt.name)
            if not hasattr(table, "page_sink"):
                raise ValueError(f"table {stmt.name} is not writable")
            sink = table.page_sink()
            try:
                if stmt.query is not None:
                    out = self._execute(self._plan_ast(stmt.query, user),
                                        stats)
                else:
                    out = self._values_batch(stmt.values, table)
                sink.append(out)
            except Exception:
                sink.abort()
                raise
            return self._dml_result(sink.finish())
        if isinstance(stmt, ast.Show):
            return self._show(stmt)
        raise ValueError(f"unsupported statement {type(stmt).__name__}")

    def _strings(self, cols: dict, width: str = "U64"):
        """A batch of varchar columns on this engine's device (``width``:
        the numpy string dtype the values pass through)."""
        import numpy as np

        from ..batch import from_numpy
        from ..types import VARCHAR

        arrays = {k: np.asarray(v, dtype=width) for k, v in cols.items()}
        return from_numpy(arrays, {k: VARCHAR for k in cols},
                          device=self.device)

    def _show(self, stmt):
        """SHOW TABLES/COLUMNS/SCHEMAS/CATALOGS/SESSION/FUNCTIONS +
        DESCRIBE (reference: metadata-backed SHOW rewrites in
        StatementRewrite / information_schema)."""
        def strings(**cols):
            return self._strings(cols)

        if stmt.what == "tables":
            return strings(table=sorted(self.catalog.tables))
        if stmt.what == "columns":
            t = self.catalog.table(stmt.target)
            return strings(column=list(t.schema.keys()),
                           type=[str(tt) for tt in t.schema.values()])
        if stmt.what == "schemas":
            return strings(schema=[self.session.schema])
        if stmt.what == "catalogs":
            return strings(catalog=[self.session.catalog])
        if stmt.what == "session":
            from .session import SYSTEM_SESSION_PROPERTIES as P

            names = sorted(P)
            return strings(name=names,
                           value=[str(self.session.get(n)) for n in names],
                           description=[P[n][2] for n in names])
        if stmt.what == "functions":
            from ..sql.planner import AGG_FNS, ExprConverter

            scalars = sorted(ExprConverter.SCALAR_FNS) + [
                "year", "month", "day", "quarter", "week", "day_of_week",
                "date_trunc", "date_add", "date_diff", "current_date",
                "extract", "substring", "like", "cast", "between",
            ]
            wins = ["row_number", "rank", "dense_rank", "ntile", "lag",
                    "lead", "first_value", "last_value", "nth_value"]
            names = ([(f, "scalar") for f in scalars]
                     + [(f, "aggregate") for f in sorted(AGG_FNS)]
                     + [(f, "window") for f in wins])
            return strings(function=[n for n, _ in names],
                           kind=[k for _, k in names])
        raise ValueError(f"SHOW {stmt.what} unsupported")

    def _dml_result(self, rows: int):
        from ..batch import Column, RecordBatch
        from ..types import BIGINT

        return RecordBatch(
            {"rows": Column(torch.full((1,), rows, dtype=torch.int64,
                                       device=self.device), BIGINT)}, 1)

    def _values_batch(self, rows, table):
        """The literal rows of ``INSERT ... VALUES`` as a batch of the
        table's types.  A decimal literal is scaled from its text exactly
        (``1234567890123456.78`` is the unscaled 123456789012345678;
        the JAX package goes through a float64: ROADMAP C9), rounding half
        away from zero past the column's scale."""
        from decimal import ROUND_HALF_UP, Decimal

        import numpy as np

        from ..batch import from_numpy
        from ..sql import ast

        cols = {c: [] for c in table.column_order}
        for row in rows:
            if len(row) != len(table.column_order):
                raise ValueError("VALUES arity mismatch")
            for cname, e in zip(table.column_order, row):
                t = table.schema[cname]
                neg = False
                while isinstance(e, ast.UnaryOp) and e.op == "-":
                    neg = not neg
                    e = e.operand
                if isinstance(e, ast.NumberLit):
                    if t.kind == "decimal":
                        v = int((Decimal(e.text).scaleb(t.scale)).quantize(
                            Decimal(1), rounding=ROUND_HALF_UP))
                    else:
                        v = float(e.text) if "." in e.text else int(e.text)
                elif isinstance(e, ast.StringLit):
                    v = e.value
                elif isinstance(e, ast.DateLit):
                    v = np.datetime64(e.value, "D")
                elif isinstance(e, ast.TimestampLit):
                    v = np.datetime64(e.value.replace(" ", "T", 1), "us")
                else:
                    raise ValueError("VALUES must be literals")
                if neg:
                    v = -v
                cols[cname].append(v)
        arrays = {}
        for cname in table.column_order:
            t = table.schema[cname]
            vals = cols[cname]
            if t.is_string:
                arrays[cname] = np.asarray(vals, dtype=object)
            elif t.kind == "decimal":
                arrays[cname] = np.asarray(vals, dtype=np.int64)
            elif t.kind == "date":
                arrays[cname] = (
                    np.asarray(vals, dtype="datetime64[D]")
                    - np.datetime64("1970-01-01", "D")).astype(np.int32)
            elif t.kind == "timestamp":
                arrays[cname] = (
                    np.asarray(vals, dtype="datetime64[us]")
                    - np.datetime64("1970-01-01T00:00:00", "us")
                ).astype(np.int64)
            else:
                arrays[cname] = np.asarray(vals).astype(t.np_dtype)
        return from_numpy(arrays, dict(table.schema), device=self.device)

    def explain_analyze(self, sql: str, user: Optional[str] = None) -> str:
        """EXPLAIN ANALYZE: per-operator timings.

        With ``compile_queries`` on, the numbers come from the compiled
        path -- per-fragment steady-state walls, rows and bytes from
        ``CompiledQuery.profile()`` (CUDA events on a CUDA device),
        annotated onto the fragment-root plan nodes.  Eager sessions keep
        the per-operator tree of ``QueryStats`` (host clock around each
        operator, which ends in its row count's readback)."""
        if self.session.get("compile_queries"):
            cq = self._compiled_cache.get(sql)
            if cq is None:
                cq = self.compile(sql, user=user)
                self._compiled_cache[sql] = cq
            t0 = time.time()
            frags = cq.profile()
            stats = QueryStats()
            stats.wall_s = sum(w for _, w, _r, _b in frags)
            for root, wall, rows, nbytes in frags:
                stats.record(root, "Fragment", "", wall, rows, 0)
                stats.operators[root].detail = f"{nbytes / 1e6:.1f} MB out"
            text = stats.render(cq.plan)
            return text + (
                f"\n(compiled path: {len(frags)} fragments, per-fragment "
                f"steady-state walls over 5 reps; profile wall "
                f"{(time.time() - t0):.2f} s)")
        stats = QueryStats()
        plan = self.plan(sql, user=user)
        t0 = time.time()
        Executor(self.catalog, stats=stats, device=self.device).execute(plan)
        stats.wall_s = time.time() - t0
        return stats.render(plan)

    def compile(self, sql: str, user: Optional[str] = None,
                sample: object = "auto"):
        """Fix the whole query pipeline into fragment callables over
        static shapes (runs one eager discovery pass, on this engine's
        device, to fix buffer capacities).

        ``sample``: ``"auto"`` (default) prefix-samples the dominant table
        during discovery when it is large enough to matter
        (``exec/sampling.py``, sublinear discovery); ``None``/``False``
        forces full-data discovery; an explicit ``{table: k}`` dict samples
        those tables at 1/k.  Disable globally with
        ``P1_DISCOVERY_SAMPLE=0``."""
        import os

        from .executor import CompiledQuery

        plan = self.plan(sql, user=user)
        if sample == "auto":
            if os.environ.get("P1_DISCOVERY_SAMPLE", "auto") in ("0", "off"):
                sample = None
            else:
                from .sampling import choose_sample

                sample = choose_sample(self.catalog, plan)
        cq = CompiledQuery(self.catalog, plan, sample=sample or None,
                           device=self.device)
        cq.scan_tables = self.scan_tables(plan)
        return cq

    def compile_grouped(self, sql: str, n_groups: int = 4,
                        user: Optional[str] = None):
        """Compile with grouped execution: the dominant table is
        row-sharded into ``n_groups`` splits processed one at a time
        (the compiled path's spill / Lifespan analog, ``exec/grouped.py``),
        bounding peak device memory to ~2/n_groups of the scan working
        set.  Raises ValueError for a plan a shard would answer wrongly."""
        from .grouped import GroupedCompiledQuery

        return GroupedCompiledQuery(self, self.plan(sql, user=user),
                                    n_groups)

    def sql_distributed(self, sql: str, n_devices: int = 0,
                        info: Optional[dict] = None,
                        skew_threshold: float = 4.0):
        """Execute with every eligible heavy stage sharded over a mesh of
        ``n_devices`` logical shards on this engine's device -- the SPMD
        analog of the reference's PlanFragmenter + AddExchanges +
        SqlQueryScheduler pipeline (``sql/planner/PlanFragmenter.java:106``,
        ``optimizations/AddExchanges.java:115``).  ``n_devices=0`` takes
        the number of devices of the engine's type
        (``torch.cuda.device_count()`` on a CUDA engine, 1 on the CPU).

        The fragmenter walks the optimized plan bottom-up.  Every
        equi-join (any key arity or type, inner/left/semi/anti, residual
        conditions) and every decomposable aggregation (grouped or global)
        becomes a mesh stage; the distribution type is chosen per join --
        broadcast when the build side is small
        (``DetermineJoinDistributionType.java:56``), hash repartition
        otherwise.  Stages compose bottom-up via fragment stubs;
        genuinely single-device work (sorts over final outputs, window
        functions, distinct aggregates) runs locally between stages.

        ``info``, if given, is filled with stage accounting:
        ``mesh_stages`` (total) and per-kind counts -- tests assert on it.
        """
        from ..batch import RecordBatch, round_capacity
        from ..expr.eval import bind_string_ops, eval_expr
        from ..ops.common import key_ranges
        from ..ops.filter import filter_mask
        from ..ops.hashagg import AggSpec
        from ..parallel.dist_agg import (distributed_global_aggregate,
                                         distributed_group_aggregate)
        from ..parallel.dist_join import (JoinCapacityError,
                                          broadcast_hash_join,
                                          distributed_hash_join,
                                          exchange_quota, prep_shard_rows,
                                          route_word)
        from ..parallel.distributed import distributed_topn, make_mesh
        from ..parallel.skew import detect_hot_keys, skew_aware_join
        from ..sql.logical import (Aggregate, Filter as LFilter, Join,
                                   Sort as LSort)

        plan = self.plan(sql)
        if not n_devices:
            n_devices = torch.cuda.device_count() \
                if self.device.type == "cuda" else 1
        n_dev = n_devices
        mesh = make_mesh(n_dev, device=self.device)
        stubs: dict = {}
        stages = {"mesh_stages": 0, "repartition_joins": 0,
                  "broadcast_joins": 0, "group_aggs": 0, "global_aggs": 0,
                  "skew_joins": 0, "topn_sorts": 0}

        DECOMPOSABLE = ("sum", "count", "count_star", "min", "max", "avg")

        def executor(stubs):
            return Executor(self.catalog, stubs=stubs, device=self.device)

        def heavy_free(node, path):
            """True when no un-stubbed Join/Aggregate remains below --
            projections/filters/sorts over stubs run locally for free."""
            if path in stubs:
                return True
            if isinstance(node, (Join, Aggregate)):
                return False
            return all(heavy_free(c, path + (i,))
                       for i, c in enumerate(node.children))

        def join_eligible(node):
            if not node.equis:
                return False
            if node.kind in ("inner", "semi", "anti"):
                return True
            if node.kind == "left":
                # per-shard LEFT needs the local fast paths: no residual
                # (ops/join.py raises) -- width re-checked after discovery
                return node.residual is None
            return False  # full outer repartition per-shard TBD

        def agg_eligible(node):
            return all(a.fn in DECOMPOSABLE and not a.distinct
                       for a in node.aggs)

        def sort_eligible(node):
            # distributed TopN: bounded candidate set per shard; a full
            # unbounded ORDER BY stays local on the mesh plane (the
            # multi-host plane's k-way merge covers that shape --
            # exec/merge.py)
            return (node.limit is not None
                    and node.limit + node.offset <= 1 << 20)

        def find(node, path=()):
            """Deepest eligible distributable stage not yet stubbed."""
            for i, c in enumerate(node.children):
                r = find(c, path + (i,))
                if r:
                    return r
            if path in stubs:
                return None
            if (isinstance(node, Join) and join_eligible(node)
                    and heavy_free(node.left, path + (0,))
                    and heavy_free(node.right, path + (1,))):
                return "join", path, node
            if (isinstance(node, Aggregate) and agg_eligible(node)
                    and (heavy_free(node.child, path + (0,))
                         or (isinstance(node.child, LFilter)
                             and heavy_free(node.child.child,
                                            path + (0, 0))))):
                return "agg", path, node
            if (isinstance(node, LSort) and sort_eligible(node)
                    and heavy_free(node.child, path + (0,))):
                return "sort", path, node
            return None

        def dicts_of(batch):
            return {n: c.dictionary for n, c in batch.columns.items()
                    if c.dictionary is not None}

        def materialize_keys(batch, exprs, prefix):
            """Key expressions become temp columns (the executor's
            _x_Join pattern) so the mesh join sees plain columns."""
            names = []
            cols = dict(batch.columns)
            for i, e in enumerate(exprs):
                name = f"{prefix}{i}"
                cols[name] = eval_expr(
                    bind_string_ops(e, dicts_of(batch)), batch)
                names.append(name)
            return RecordBatch(cols, batch.num_rows), names

        def drop_temp(batch, prefixes=("__lk", "__rk")):
            cols = {n: c for n, c in batch.columns.items()
                    if not n.startswith(prefixes)}
            return RecordBatch(cols, batch.num_rows)

        def run_join(node, path, ex):
            lb = ex.execute(node.left, path + (0,))
            rb = ex.execute(node.right, path + (1,))
            lb, lkeys = materialize_keys(lb, [a for a, _ in node.equis],
                                         "__lk")
            rb, rkeys = materialize_keys(rb, [b for _, b in node.equis],
                                         "__rk")
            lr = key_ranges([lb[k] for k in lkeys], lb.num_rows)
            rr = key_ranges([rb[k] for k in rkeys], rb.num_rows)
            ranges = [(min(a[0], b[0]), max(a[1], b[1]))
                      for a, b in zip(lr, rr)]
            widths = sum(max(int(hi - lo + 2).bit_length(), 1)
                         for lo, hi in ranges)
            if node.kind == "left" and widths > 63:
                return None  # local LEFT raises on wide keys
            residual = None
            if node.residual is not None:
                merged = RecordBatch({**lb.columns, **rb.columns}, 0)
                residual = bind_string_ops(node.residual, dicts_of(merged))
            fanout = 1 if (node.build_unique
                           or node.kind in ("semi", "anti")) else 4

            b_rows = int(rb.num_rows)
            p_rows = int(lb.num_rows)
            # distribution choice (DetermineJoinDistributionType): small
            # build sides replicate -- no exchange moves the big side
            broadcast = (node.kind != "full"
                         and b_rows * max(n_dev, 1) <= max(p_rows, 1) * 2)
            if broadcast:
                p_shard = -(-max(lb.capacity(), n_dev * 128)
                            // (n_dev * 128)) * 128
                local_cap = round_capacity(max(p_shard * fanout, 128))
                while True:
                    try:
                        out = broadcast_hash_join(
                            mesh, lb, rb, lkeys, rkeys, node.kind, ranges,
                            local_cap, residual=residual,
                            build_unique=node.build_unique)
                        break
                    except JoinCapacityError as e:
                        local_cap = round_capacity(e.needed)
                stages["broadcast_joins"] += 1
            else:
                p_shard = prep_shard_rows(lb.capacity(), n_dev)
                b_shard = prep_shard_rows(rb.capacity(), n_dev)
                lw = route_word(lb, lkeys, ranges, lb.num_rows).cpu().numpy()
                rw = route_word(rb, rkeys, ranges, rb.num_rows).cpu().numpy()
                # skew handling IN the shuffle (the reference has none --
                # SURVEY §2.8): the same histogram that sizes the exchange
                # quota flags hot keys, and the join splits into a
                # repartitioned cold half + a hot half where probe rows
                # stay put and the few hot build rows broadcast.
                # Detection runs on the packed ROUTE WORD, so multi-key
                # joins and residual conditions are covered
                if node.kind == "inner" and p_rows > 0:
                    hot = detect_hot_keys(lw, p_rows, n_dev,
                                          threshold=skew_threshold)
                    if hot.size:
                        out = skew_aware_join(
                            mesh, lb, rb, lkeys, rkeys, ranges, hot,
                            lw, rw, residual=residual,
                            build_unique=node.build_unique)
                        stages["skew_joins"] += 1
                        return drop_temp(
                            RecordBatch(out.columns, int(out.num_rows)))
                pq = exchange_quota(lw, p_rows, n_dev, p_shard)
                bq = exchange_quota(rw, b_rows, n_dev, b_shard)
                pq_r = round_capacity(max(pq, 128))
                bq_r = round_capacity(max(bq, 128))
                local_cap = round_capacity(max(n_dev * pq_r * fanout, 128))
                while True:
                    try:
                        out = distributed_hash_join(
                            mesh, lb, rb, lkeys, rkeys, node.kind, ranges,
                            (pq_r, bq_r), local_cap, residual=residual,
                            build_unique=node.build_unique)
                        break
                    except JoinCapacityError as e:
                        local_cap = round_capacity(e.needed)
                stages["repartition_joins"] += 1
            return drop_temp(RecordBatch(out.columns, int(out.num_rows)))

        def run_agg(node, path, ex):
            filt = None
            child_node = node.child
            child_path = path + (0,)
            if isinstance(child_node, LFilter) and child_path not in stubs:
                filt = child_node
                child_node = child_node.child
                child_path = path + (0, 0)
            below = ex.execute(child_node, child_path)
            mask = None
            if filt is not None:
                mask = filter_mask(
                    bind_string_ops(filt.predicate, dicts_of(below)),
                    below)
            specs = [
                AggSpec(a.fn,
                        None if a.arg is None else eval_expr(
                            bind_string_ops(a.arg, dicts_of(below)),
                            below),
                        a.symbol)
                for a in node.aggs
            ]
            if not node.group:
                if int(below.num_rows) == 0:
                    return None  # empty-input global agg: single-row NULL
                    # semantics stay on the local operator
                out = distributed_global_aggregate(
                    mesh, specs, below.num_rows, mask=mask)
                if int(out.num_rows) == 0:
                    # every row masked out: SQL still wants ONE row of
                    # NULL/0 -- the local operator implements that edge
                    return None
                stages["global_aggs"] += 1
                return RecordBatch(out.columns, int(out.num_rows))
            primary = node.primary or node.group
            carry = [s for s in node.group if s not in primary]
            ranges = key_ranges([below[s] for s in primary],
                                below.num_rows)
            span = 1
            for lo, hi in ranges:
                span *= (hi - lo + 2)
                if span > below.num_rows:
                    break
            max_groups = round_capacity(min(max(int(below.num_rows), 1),
                                            span))
            out = distributed_group_aggregate(
                mesh, primary, {s: below[s] for s in node.group},
                specs, below.num_rows, ranges, max_groups, mask=mask,
                carry_names=carry)
            stages["group_aggs"] += 1
            return RecordBatch(out.columns, int(out.num_rows))

        def run_sort(node, path, ex):
            below = ex.execute(node.child, path + (0,))
            if int(below.num_rows) == 0:
                return None  # empty input: local sort handles the edge
            below2, knames = materialize_keys(
                below, [e for e, _, _ in node.keys], "__sk")
            out = distributed_topn(
                mesh, below2, knames,
                [(asc, nf) for _, asc, nf in node.keys],
                node.limit + node.offset)
            # the per-shard candidates (<= n_dev * k rows) feed the
            # ORIGINAL Sort node locally: final order + offset/limit
            cand = drop_temp(RecordBatch(out.columns, int(out.num_rows)),
                             ("__sk",))
            fin = executor({path + (0,): cand}).execute(node, path)
            stages["topn_sorts"] += 1
            return RecordBatch(fin.columns, int(fin.num_rows))

        while True:
            found = find(plan)
            if not found:
                break
            kind, path, node = found
            ex = executor(stubs)
            out = run_join(node, path, ex) if kind == "join" \
                else run_agg(node, path, ex) if kind == "agg" \
                else run_sort(node, path, ex)
            if out is None:
                # ineligible after discovery (wide LEFT keys, empty global
                # agg): run the stage locally so the scan moves past it
                stubs[path] = ex.execute(node, path)
                continue
            stubs[path] = out
            stages["mesh_stages"] += 1

        if info is not None:
            info.update(stages)
        if not stubs:
            return self.sql(sql)
        return executor(stubs).execute(plan)
