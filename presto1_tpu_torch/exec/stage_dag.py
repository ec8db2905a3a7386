"""Recursive stage-DAG fragmenter for the multi-host plane.

The generalization of round-2's single ExchangeStage into the reference's
full model: ``PlanFragmenter.createSubPlans`` cuts the plan at exchange
boundaries into a tree of fragments (``sql/planner/PlanFragmenter.java:106``),
``AddExchanges`` decides where those boundaries go by tracking partitioning
properties bottom-up (``sql/planner/optimizations/AddExchanges.java:115``),
and ``DetermineJoinDistributionType`` picks broadcast vs repartition per
join (``iterative/rule/DetermineJoinDistributionType.java:56-80``).

Stage shapes (SystemPartitioningHandle analogs):

* ``source``  — one task per table shard (SOURCE_DISTRIBUTION); the scan
  chain plus everything provably co-located with it.
* ``hash``    — one task per hash partition (FIXED_HASH_DISTRIBUTION);
  consumes partitioned buffers of upstream stages.

Consumption modes per remote source:

* ``partition`` — task p pulls buffer p of every upstream task (the
  FIXED_HASH wire of ``PartitionedOutputBuffer``).
* ``broadcast`` — every task pulls buffer 0 of every upstream task, i.e.
  the full upstream output replicated (``BroadcastOutputBuffer``).
* ``gather``    — the coordinator (or a single consumer) pulls everything.

Partitioning calculus: an open fragment carries ``hash_keys_alts`` — the
symbol lists its rows are currently co-partitioned by.  A join whose left
keys match an alternative continues IN the same stage (only the right side
repartitions); an aggregation whose group keys contain an alternative runs
grouped in-stage with no exchange at all.  This is how multi-join pipelines
(Q3/Q5/Q9 shapes) become chains of worker stages with the coordinator
seeing only final results.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..expr import ir
from ..sql import logical as L
from ..sql.stats import derive

Path = Tuple[int, ...]


@dataclass
class RemoteSource:
    """One stub inside a stage plan fed by an upstream stage over HTTP."""
    stub_path: Path
    stage: int
    mode: str  # 'partition' | 'broadcast'


@dataclass
class Stage:
    sid: int
    plan: L.LogicalNode
    distribution: str                    # 'source' | 'hash'
    table: Optional[str]                 # sharded split source ('source')
    partition_keys: Optional[List[str]]  # FIXED_HASH output keys; None =
    #                                      single buffer (gather/broadcast)
    sources: List[RemoteSource] = field(default_factory=list)
    # worker-side build-key [min,max] collection for dynamic filtering
    collect_domains: Optional[List[str]] = None
    # (probe_stage, build_stage, probe_keys, build_keys) — scheduler runs
    # the build stage first and pushes merged domains into the probe stage
    df: Optional[Tuple[int, int, List[str], List[str]]] = None
    # output of every task is locally sorted by these (expr, asc,
    # nulls_first) keys — the coordinator merges instead of re-sorting
    sorted_by: Optional[list] = None
    # (probe_stage, build_stage) of an in-stage repartition join eligible
    # for skew handling: the scheduler runs the probe stage first, unions
    # the per-task hot-hash reports, and tells the build stage to
    # replicate hot rows into every buffer (north-star differentiator —
    # the reference has no skew path, SURVEY §2.8)
    skew: Optional[Tuple[int, int]] = None
    # runtime fields filled by the scheduler before task creation
    collect_hot: Optional[float] = None   # threshold for probe tasks
    hot_hashes: Optional[list] = None     # merged hot set for build tasks


class _Open:
    """A fragment still being built bottom-up on the worker side."""

    def __init__(self, plan: L.LogicalNode, dist: str,
                 table: Optional[str] = None,
                 hash_keys_alts: Optional[List[List[str]]] = None,
                 sources: Optional[List[RemoteSource]] = None):
        self.plan = plan
        self.dist = dist
        self.table = table
        self.hash_keys_alts = hash_keys_alts or []
        self.sources = sources or []
        self.df: Optional[Tuple[int, int, List[str], List[str]]] = None
        # (probe_sid, build_sid) while this fragment's root join is still
        # skew-reroutable; cleared the moment anything in-stage EXPLOITS
        # co-partitioning (continuation join, co-grouped aggregate,
        # MarkDistinct), since skew rerouting scatters hot keys
        self.skew: Optional[Tuple[int, int]] = None

    def append(self, parent: L.LogicalNode, child_index: int = 0,
               extra_sources: Optional[List[RemoteSource]] = None):
        """Put ``parent`` on top of this fragment (fragment becomes child
        ``child_index``); stub paths shift accordingly."""
        children = list(parent.children)
        children[child_index] = self.plan
        self.plan = parent.with_children(children)
        self.sources = [
            RemoteSource((child_index,) + s.stub_path, s.stage, s.mode)
            for s in self.sources
        ] + list(extra_sources or [])
        # partitioning keys survive only while their symbols do
        schema = self.plan.schema
        self.hash_keys_alts = [alt for alt in self.hash_keys_alts
                               if all(k in schema for k in alt)]
        return self

    def partitioned_on(self, keys: List[str]) -> bool:
        return any(alt == list(keys) for alt in self.hash_keys_alts)

    def co_grouped(self, group: List[str]) -> bool:
        gs = set(group)
        return any(alt and set(alt) <= gs for alt in self.hash_keys_alts)


class _Local:
    """A plan (sub)tree that executes on the coordinator; ``sources`` maps
    stub paths inside it to producing stage ids (always gathered)."""

    def __init__(self, plan: L.LogicalNode,
                 sources: Optional[Dict[Path, int]] = None):
        self.plan = plan
        self.sources = sources or {}

    def wrap(self, parent: L.LogicalNode, child_index: int = 0):
        children = list(parent.children)
        children[child_index] = self.plan
        self.plan = parent.with_children(children)
        self.sources = {(child_index,) + p: sid
                        for p, sid in self.sources.items()}
        return self


def _plain_symbols(equis) -> Optional[Tuple[List[str], List[str]]]:
    lks, rks = [], []
    for a, b in equis:
        if not (isinstance(a, ir.ColumnRef) and isinstance(b, ir.ColumnRef)):
            return None
        lks.append(a.name)
        rks.append(b.name)
    return lks, rks


# join kinds whose BUILD (right) side may be replicated to every probe
# task: each matched/unmatched probe row is emitted by exactly one task,
# and unmatched build rows are never emitted
_BROADCASTABLE = ("inner", "left", "semi", "anti", "cross")
# join kinds that repartition correctly: co-partitioned slices emit every
# row (matched or outer-unmatched) exactly once
_PARTITIONABLE = ("inner", "left", "right", "full", "semi", "anti")


class StageDagBuilder:
    def __init__(self, catalog, broadcast_threshold: int = 100_000,
                 dynamic_filtering: bool = True, skew: bool = True):
        self.catalog = catalog
        self.broadcast_threshold = broadcast_threshold
        self.dynamic_filtering = dynamic_filtering
        # mark repartition joins skew-reroutable; splittable aggregates
        # above them then take the partial/final split (placement-
        # agnostic) instead of the exact co-grouped continuation
        self.skew = skew
        self.stages: List[Stage] = []

    # ------------------------------------------------------------ stages

    def _close(self, open_: _Open, partition_keys: Optional[List[str]],
               collect_domains: Optional[List[str]] = None,
               sorted_by: Optional[list] = None) -> int:
        sid = len(self.stages)
        self.stages.append(Stage(
            sid, open_.plan, open_.dist, open_.table, partition_keys,
            open_.sources, collect_domains=collect_domains,
            df=open_.df, sorted_by=sorted_by, skew=open_.skew))
        return sid

    def _to_local(self, res, sorted_by: Optional[list] = None) -> _Local:
        if isinstance(res, _Local):
            return res
        sid = self._close(res, None, sorted_by=sorted_by)
        return _Local(res.plan, {(): sid})

    # ------------------------------------------------------------- build

    def build(self, plan: L.LogicalNode) -> Tuple[L.LogicalNode,
                                                  Dict[Path, int],
                                                  List[Stage]]:
        res = self._to_local(self._build(plan))
        return res.plan, res.sources, self.stages

    def _build(self, node: L.LogicalNode):
        if isinstance(node, L.Scan):
            return _Open(node, "source", table=node.table)
        if isinstance(node, (L.Filter, L.Project, L.Unnest)):
            # row-local operators extend the open fragment (Unnest expands
            # rows but stays partition-preserving for the PARENT's keys)
            r = self._build(node.children[0])
            return r.append(node) if isinstance(r, _Open) else r.wrap(node)
        if isinstance(node, L.Join):
            return self._join(node)
        if isinstance(node, L.Aggregate):
            return self._aggregate(node)
        if isinstance(node, L.MarkDistinct):
            return self._mark_distinct(node)
        if isinstance(node, L.Sort):
            return self._sort(node)
        if isinstance(node, L.Union):
            return self._union(node)
        # everything else (Window, Limit, Output, SingleRow, DML nodes...)
        # runs on the coordinator; children close as gather stages
        children = node.children
        if not children:
            return _Local(node)
        locals_ = [self._to_local(self._build(c)) for c in children]
        new_children = [lc.plan for lc in locals_]
        sources: Dict[Path, int] = {}
        for i, lc in enumerate(locals_):
            for p, sid in lc.sources.items():
                sources[(i,) + p] = sid
        return _Local(node.with_children(new_children), sources)

    # -------------------------------------------------------------- join

    def _join(self, node: L.Join):
        lr = self._build(node.left)
        rr = self._build(node.right)
        plain = _plain_symbols(node.equis) if node.equis else None

        if not (isinstance(lr, _Open) and isinstance(rr, _Open)):
            return self._join_local(node, lr, rr)

        # ---- broadcast: small build side replicated to every probe task
        if (node.kind in _BROADCASTABLE
                and derive(node.right, self.catalog).rows
                <= self.broadcast_threshold):
            rid = self._close(rr, None)  # single buffer per task
            return lr.append(
                node, child_index=0,
                extra_sources=[RemoteSource((1,), rid, "broadcast")])

        if plain is None or node.kind not in _PARTITIONABLE:
            return self._join_local(node, lr, rr)
        lks, rks = plain

        # ---- co-partitioned continuation: probe side already hashed on
        # the join keys — join joins the open stage, only build moves
        if lr.dist == "hash" and lr.partitioned_on(lks):
            lr.skew = None  # continuation RELIES on exact co-partitioning
            rid = self._close(rr, partition_keys=rks)
            lr.append(node, child_index=0,
                      extra_sources=[RemoteSource((1,), rid, "partition")])
            if node.kind == "inner":
                lr.hash_keys_alts.append(list(rks))
            elif node.kind == "full":
                # unmatched build rows carry NULL left keys but physically
                # sit in hash(rks) partitions — the output is partitioned
                # on NOTHING a downstream consumer could rely on
                lr.hash_keys_alts = []
            return lr
        if (rr.dist == "hash" and rr.partitioned_on(rks)
                and node.kind == "inner"):
            rr.skew = None  # continuation RELIES on exact co-partitioning
            lid = self._close(lr, partition_keys=lks)
            rr.append(node, child_index=1,
                      extra_sources=[RemoteSource((0,), lid, "partition")])
            rr.hash_keys_alts.append(list(lks))
            return rr

        # ---- full repartition on the join keys
        df_ok = (self.dynamic_filtering and node.kind in ("inner", "semi")
                 and lr.dist == "source")
        lid = self._close(lr, partition_keys=lks)
        rid = self._close(rr, partition_keys=rks,
                          collect_domains=rks if df_ok else None)
        # Only join kinds whose output cannot contain NULL-extended keys on
        # a side may register that side's keys as a partitioning
        # alternative: a FULL join's unmatched build rows have NULL left
        # keys yet physically sit in hash(rks) partitions, so a downstream
        # co_grouped aggregate on lks would split the NULL group across
        # tasks (right joins are normalized to left in the planner).
        if node.kind == "full":
            alts = []
        elif node.kind == "right":
            alts = [list(rks)]
        else:  # inner / left / semi / anti: left keys are never NULL-padded
            alts = [list(lks)]
        if node.kind == "inner":
            alts.append(list(rks))
        out = _Open(
            L.Join(self.stages[lid].plan, self.stages[rid].plan, node.kind,
                   node.equis, node.residual, node.build_unique),
            "hash", hash_keys_alts=alts,
            sources=[RemoteSource((0,), lid, "partition"),
                     RemoteSource((1,), rid, "partition")])
        if df_ok:
            out.df = (lid, rid, lks, rks)
        if self.skew and node.kind in ("inner", "left", "semi", "anti"):
            # skew-reroutable: probe rows land exactly once wherever they
            # go, and broadcast hot build rows reach every task — matched
            # and probe-unmatched rows emit exactly once.  FULL/right are
            # excluded (broadcast build rows would duplicate the
            # null-extended anti part).
            out.skew = (lid, rid)
        return out

    def _join_local(self, node: L.Join, lr, rr) -> _Local:
        lr, rr = self._to_local(lr), self._to_local(rr)
        sources = {(0,) + p: sid for p, sid in lr.sources.items()}
        sources.update({(1,) + p: sid for p, sid in rr.sources.items()})
        return _Local(node.with_children([lr.plan, rr.plan]), sources)

    # --------------------------------------------------------- aggregate

    def _aggregate(self, node: L.Aggregate):
        from .dist_engine import split_aggregate

        r = self._build(node.child)
        if isinstance(r, _Local):
            return r.wrap(node)
        group = list(node.group)

        split = split_aggregate(node)
        # groups provably co-located: the whole aggregate runs in-stage —
        # UNLESS the stage still carries a skew-reroutable join and the
        # aggregate splits: a partial aggregate is placement-agnostic, so
        # taking the partial/final split keeps the skew path available
        # (hot groups then weigh one partial row per task, not millions)
        if r.dist == "hash" and group and r.co_grouped(group) \
                and (split is None or r.skew is None):
            r.skew = None  # exact grouping RELIES on co-partitioning
            return r.append(node)
        if split is None:
            # distinct aggregates don't split partial/final — but a
            # repartition on the group keys co-locates each group wholly,
            # after which ANY aggregate (distinct included) is exact
            if group:
                sid = self._close(r, partition_keys=group)
                return _Open(
                    node.with_children([self.stages[sid].plan]), "hash",
                    hash_keys_alts=[group],
                    sources=[RemoteSource((0,), sid, "partition")])
            lc = self._to_local(r)
            return lc.wrap(node)

        partial, final, project = split
        r.append(partial.with_children([r.plan]))
        if group:
            # grouped final aggregation partitioned ACROSS WORKERS (the
            # PushPartialAggregationThroughExchange + FIXED_HASH final
            # stage of the reference) — not on the coordinator
            sid = self._close(r, partition_keys=group)
            out = _Open(final.with_children([self.stages[sid].plan]),
                        "hash", hash_keys_alts=[group],
                        sources=[RemoteSource((0,), sid, "partition")])
            if project is not None:
                out.append(project)
            return out
        # global aggregation: partials gathered, final on the coordinator
        sid = self._close(r, None)
        local_plan = final.with_children([r.plan])
        path: Path = (0,)
        if project is not None:
            local_plan = project.with_children([local_plan])
            path = (0, 0)
        return _Local(local_plan, {path: sid})

    # ----------------------------------------------------- mark distinct

    def _mark_distinct(self, node: L.MarkDistinct):
        """Markers are a GLOBAL first-occurrence property per (group,
        value) combo, so every row of a combo must land on one task:
        repartitioning on the group keys suffices (the aggregate above
        groups on exactly those keys, so it then runs in-stage too —
        the reference schedules MarkDistinctNode the same way, inside
        the FIXED_HASH aggregation fragment)."""
        r = self._build(node.child)
        if isinstance(r, _Local):
            return r.wrap(node)
        if r.dist == "hash" and node.group and r.co_grouped(node.group):
            r.skew = None  # markers RELY on co-partitioning
            return r.append(node)
        if node.group:
            sid = self._close(r, partition_keys=list(node.group))
            return _Open(node.with_children([self.stages[sid].plan]),
                         "hash", hash_keys_alts=[list(node.group)],
                         sources=[RemoteSource((0,), sid, "partition")])
        # global distinct (no group keys): a single marker's key exprs
        # still co-locate every value combo — repartition on them instead
        # of shipping the whole table to the coordinator (the reference
        # keeps MarkDistinctNode in a hash-partitioned fragment on the
        # distinct symbols; round-4 ADVICE scalability cliff).  Multiple
        # markers with different keysets keep the local fallback (one
        # exchange cannot co-locate them all).
        if len(node.markers) == 1:
            keys = [e.name for e in node.markers[0][1]
                    if isinstance(e, ir.ColumnRef)]
            if keys and len(keys) == len(node.markers[0][1]):
                sid = self._close(r, partition_keys=keys)
                return _Open(node.with_children([self.stages[sid].plan]),
                             "hash", hash_keys_alts=[keys],
                             sources=[RemoteSource((0,), sid, "partition")])
        return self._to_local(r).wrap(node)

    # -------------------------------------------------------------- sort

    def _sort(self, node: L.Sort):
        """Distributed sort/TopN (``operator/MergeOperator.java:44``,
        ``docs/.../dist-sort.rst:1-17``): every task sorts (and truncates,
        for TopN) its partition locally; the stage is marked ``sorted_by``,
        the coordinator's page pull runs a k-way merge of the per-task
        sorted runs (``exec/merge.py``), and the coordinator plan keeps
        only a MergeSorted node applying offset/limit — never a re-sort."""
        r = self._build(node.children[0])
        if isinstance(r, _Local):
            return r.wrap(node)
        if node.limit is not None:
            # per-task TopN keeps limit+offset rows — a superset of the
            # global TopN — then the coordinator merges and truncates
            per_task = L.Sort(r.plan, node.keys,
                              limit=node.limit + node.offset, offset=0)
            r.append(per_task)
        else:
            r.append(L.Sort(r.plan, node.keys))
        lc = self._to_local(r, sorted_by=node.keys)
        return lc.wrap(L.MergeSorted(node.child, node.keys, node.limit,
                                     node.offset))

    # ------------------------------------------------------------- union

    def _union(self, node: L.Union):
        results = [self._to_local(self._build(c)) for c in node.inputs]
        sources: Dict[Path, int] = {}
        for i, lc in enumerate(results):
            for p, sid in lc.sources.items():
                sources[(i,) + p] = sid
        return _Local(node.with_children([lc.plan for lc in results]),
                      sources)


def build_stage_dag(plan: L.LogicalNode, catalog,
                    broadcast_threshold: int = 100_000,
                    dynamic_filtering: bool = True, skew: bool = True):
    """Plan → (coordinator plan, {stub path: stage id}, stages).

    Stages are topologically ordered by construction (a stage's sources
    always have smaller ids)."""
    return StageDagBuilder(catalog, broadcast_threshold,
                           dynamic_filtering, skew).build(plan)
