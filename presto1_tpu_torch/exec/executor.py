"""Logical plan execution over device batches -- eager and compiled modes.

The stand-in for the reference's whole worker data plane
(LocalExecutionPlanner -> operator chain,
``sql/planner/LocalExecutionPlanner.java:390``): each logical node maps to
one vectorized operator call on tensors of one device.

Two modes share the same operator code:

* **eager (discovery)** -- operator-at-a-time with host row-count syncs, so
  buffer capacities stay tight.  Every data-dependent decision (key ranges,
  capacities, group counts) is recorded per plan-node path.
* **compiled** -- the recorded capacities make every shape static, so each
  fragment is one Python callable that enqueues its ops without ever
  waiting for the device: row counts and overflow flags stay device
  tensors, and ``CompiledQuery`` reads them back once, at the end of a run.

Filter->Aggregate is fused the way the reference fuses ScanFilterAndProject
(``operator/ScanFilterAndProjectOperator.java:64``): the filter never
materialises, it becomes the aggregation mask.  When the fragment has the
exact shape of a range filter over a product sum (TPC-H Q6), predicate,
product and limb sums run as one hand-written kernel
(``ops/kernels/filter_sum.py``) instead of a dozen eager passes; the choice
is made from the plan's shape before anything is launched.

Grouped aggregation takes the dense kernel
(``ops/kernels/dense_group_agg.py``) for a small key domain and the sort +
prefix-sum path otherwise; its row moves and compactions, like Sort's and
Join's, go through the gather and scatter kernels.  UNION ALL and FULL
OUTER JOIN copy every part's live prefix to its running offset in the
dynamic-copy kernel (``ops/kernels/dyncopy.py``), with the part counts on
the device.

The port executes every plan node of the reference's single-device
executor: Output, SingleRow, Scan, Filter, Project, Limit, Aggregate
(grouped or not), Sort, MergeSorted, Join (every kind), Union, WindowNode
(``ops/window.py``), Unnest and MarkDistinct.  Unnest compacts its live
lanes with the compaction kernel and repeats its parent rows through one
gather launch; MarkDistinct's first-occurrence flags return to row order
through the scatter kernel.  In eager mode a grouped Aggregate or an
equi-Join whose inputs exceed ``spill_threshold`` bytes runs partitioned
through host RAM
(``exec/spill.py``: ``_spilled_aggregate``, ``_grace_join``), and a
``QueryMemoryContext`` (``exec/memory.py``) accounts every operator's
output.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import (
    Column, RecordBatch, device_counts, gather_columns, merge_dictionaries,
    round_capacity, take_clamped, torch_dtype,
)
from ..expr import ir
from ..expr.eval import (
    _common_pair, bind_string_ops, eval_expr, host_tables_read,
    lookups_on_device,
)
from ..ops import AggSpec, filter_batch, global_aggregate, group_aggregate
from ..ops.filter import filter_mask
from ..ops.common import INT64_MAX, iota, key_ranges
from ..ops.hashagg import _guard_limb_total
from ..ops.join import cross_join, hash_join, merge_join_applicable
from ..ops.kernels.dyncopy import concat_rows
from ..ops.kernels.gather import gather_rows
from ..ops.kernels.scatter import scatter_distinct
from ..ops.segments import compact_indices
from ..ops.sort import SortKey, limit_batch, sort_batch
from ..ops.kernels.filter_sum import range_filter_limb_sums
from ..sql.logical import (
    Aggregate, Filter, Join, Limit, LogicalNode, MarkDistinct, Output,
    Project, Scan, SingleRow, Sort, Union, Unnest, WindowNode,
)
from ..trace import TRACE, QueryTrace, host_read, operator_counts, span
from .cuda_graph import StatementGraph

Path = Tuple[int, ...]

_LOG = logging.getLogger(__name__)


class ExecError(Exception):
    pass


# the keys of plan_to_json that hold a node's children
_CHILD_KEYS = ("child", "left", "right", "inputs")


def plan_node_id(trace, node: LogicalNode) -> int:
    """``node``'s id within the statement ``trace`` records: subtrees of
    one structure (their serialised form) share an id, whichever object
    and path execute them."""
    got = trace.node_ids.get(id(node))
    if got is None:
        from ..sql.serde import plan_to_json

        try:
            tree = plan_to_json(node)
        except TypeError:  # a node or expression with no serialised form
            tree = None
        return _number_subtrees(trace, node, tree)
    return got[1]


def _number_subtrees(trace, node: LogicalNode, tree) -> int:
    """Give ``node`` and every subtree below it that ``trace`` has not
    numbered yet its id, and return ``node``'s: the id of its own fields
    (``tree``, its ``plan_to_json`` form) and its children's ids."""
    got = trace.node_ids.get(id(node))
    if got is not None:
        return got[1]
    kids = node.children
    if tree is None:
        local, parts = repr(node), [None] * len(kids)
    else:  # the children's forms, in ``children``'s order
        local = {k: v for k, v in tree.items() if k not in _CHILD_KEYS}
        parts = [tree[k] for k in _CHILD_KEYS[:3] if k in tree] \
            + list(tree.get("inputs", []))
    key = json.dumps([type(node).__name__, local,
                      [_number_subtrees(trace, c, p)
                       for c, p in zip(kids, parts)]],
                     sort_keys=True, default=str)
    sid = trace.subtrees.setdefault(key, len(trace.subtrees))
    trace.node_ids[id(node)] = (node, sid)
    return sid


class Executor:
    def __init__(self, catalog, compiled: bool = False,
                 record: Optional[Dict[Path, dict]] = None,
                 scan_arrays: Optional[Dict[str, torch.Tensor]] = None,
                 stats=None, stubs: Optional[Dict[Path, RecordBatch]] = None,
                 device="cuda", route_kernels: bool = True,
                 dynamic_filtering: bool = True, memory=None,
                 spill_threshold: int = 0, guard_ranges: bool = False):
        self.catalog = catalog
        self.compiled = compiled
        # compiled fragments whose recorded values were extrapolated
        # (sampled discovery) must guard every data-derived recorded value:
        # key ranges clamp out-of-range keys silently (distinct groups
        # would collide), so device-side in-range checks join the
        # fragment's overflow flags instead
        self.guard_ranges = guard_ranges
        self.memory = memory  # QueryMemoryContext (eager mode accounting)
        # spill: inputs above this byte count run partitioned through host
        # RAM (eager mode only; 0 = disabled)
        self.spill_threshold = spill_threshold
        self.dynamic_filtering = dynamic_filtering
        self.device = torch.device(device)
        # False keeps every fragment on the generic operators (tests and
        # the on-card comparison hold the kernel path against it)
        self.route_kernels = route_kernels
        self.record: Dict[Path, dict] = record if record is not None else {}
        self.scan_arrays = scan_arrays
        self.stats = stats
        self.stubs = stubs or {}
        self.capture_paths: set = set()
        self.captured: Dict[Path, RecordBatch] = {}
        self.overflow_checks: List[torch.Tensor] = []
        # physical sort-order chains per executed path (exec/ordering.py);
        # derived in eager mode, where they drive the clustered-aggregation
        # and sorted-build decisions recorded for compiled replay
        self.chains: Dict[Path, Optional[list]] = {}

    def _check_capacity(self, total, capacity: int):
        """Compiled mode: record a device-side guard that the data still
        fits the discovery-time capacity (silent truncation otherwise); a
        total already on the host is checked at once."""
        if not self.compiled:
            return
        if not isinstance(total, int):
            self.overflow_checks.append(total <= capacity)
        elif total > capacity:
            raise ExecError(f"compiled-plan buffer overflow: {total} rows "
                            f"outgrew the discovered capacity {capacity}")

    # ---- helpers

    def _rec(self, path: Path) -> dict:
        return self.record.setdefault(path, {})

    def _dicts(self, batch: RecordBatch) -> Dict[str, np.ndarray]:
        return {
            n: c.dictionary for n, c in batch.columns.items()
            if c.dictionary is not None
        }

    def _bind(self, e: ir.Expr, batch: RecordBatch, path: Path,
              slot: str) -> ir.Expr:
        """``e`` with its string subtrees folded into DictLookups over the
        batch's dictionaries, their tables on the device: bound once per
        plan and kept in the record, so a compiled run uploads nothing."""
        rec = self._rec(path)
        key = ("bound", slot)
        if key not in rec:
            rec[key] = lookups_on_device(
                bind_string_ops(e, self._dicts(batch)), self.device)
        return rec[key]

    def _shrink(self, batch: RecordBatch) -> RecordBatch:
        """Sync the row count to host and re-bucket capacity (eager only)."""
        if self.compiled:
            return batch
        n = host_read(batch.num_rows)
        cap = round_capacity(n)
        if cap < batch.capacity():
            cols = {
                name: c.with_data(
                    c.data[:cap],
                    c.validity[:cap] if c.validity is not None else None)
                for name, c in batch.columns.items()
            }
            return RecordBatch(cols, n)
        return RecordBatch(batch.columns, n)

    def _ranges(self, path: Path, key: str, cols, num_rows):
        """Key ranges: computed+recorded in eager mode, replayed compiled."""
        rec = self._rec(path)
        if self.compiled:
            r = rec[key]
            if self.guard_ranges:
                self._guard_range_cols(cols, num_rows, r)
            return r
        r = key_ranges(cols, num_rows)
        if key in rec:  # widen across runs
            r = [(min(a[0], b[0]), max(a[1], b[1]))
                 for a, b in zip(r, rec[key])]
        rec[key] = r
        return r

    def _guard_range_cols(self, cols, num_rows, ranges):
        """Device-side checks that live key values fall inside recorded
        ranges (out-of-range keys would clamp in pack_key_words and
        collide); they join the fragment's overflow flags."""
        for c, (lo, hi) in zip(cols, ranges):
            live = iota(len(c), c.data.device) < num_rows
            if c.validity is not None:
                live = live & c.validity
            d = c.data.to(torch.int64)
            amin = torch.amin(torch.where(live, d, INT64_MAX))
            amax = torch.amax(torch.where(live, d, -INT64_MAX))
            self.overflow_checks.append(
                ~torch.any(live) | ((amin >= lo) & (amax <= hi)))

    # ---- dispatch

    def execute(self, node: LogicalNode, path: Path = ()) -> RecordBatch:
        if path in self.stubs:  # fragment input boundary
            return self.stubs[path]
        trace = TRACE.get()
        if trace is None:
            return self._operator(node, path)
        with trace.span("op:" + type(node).__name__,
                        plan_node_id(trace, node)):
            return self._operator(node, path)

    def _operator(self, node: LogicalNode, path: Path) -> RecordBatch:
        kind = type(node).__name__
        m = getattr(self, f"_x_{kind}", None)
        if m is None:
            raise NotImplementedError(f"plan node {kind}")
        if self.stats is None or self.compiled:
            out = m(node, path)
        else:
            import time as _time

            t0 = _time.time()
            out = m(node, path)
            rows = host_read(out.num_rows)
            # cumulative wall time (includes children) -- rendered as such
            self.stats.record(path, kind, "",
                              _time.time() - t0, rows, out.capacity(),
                              spill=self.record.get(path, {}).get("spill"))
        if self.memory is not None and not self.compiled:
            from .memory import batch_bytes

            self.memory.set_bytes(path, batch_bytes(out))
        if not self.compiled:
            self.chains[path] = self._derive_chain(node, path)
        if path in self.capture_paths:
            self.captured[path] = out
        return out

    def _derive_chain(self, node: LogicalNode, path: Path):
        """Physical sort order of this node's output (None = unknown).
        Children's chains are already derived (post-order)."""
        from . import ordering as O

        rec = self.record.get(path) or {}
        if rec.get("spilled"):
            return None  # spill partitioning destroyed the input order

        def ch(i: int):
            return self.chains.get(path + (i,))

        if isinstance(node, Scan):
            return O.chain_from_table(self._scan_table(node), node.symbols)
        if isinstance(node, (Filter, Limit)):
            return ch(0)  # stable compaction / prefix keep
        if isinstance(node, MarkDistinct):
            return ch(0)  # markers route back to input order
        if isinstance(node, Unnest):
            return O.restrict_chain(ch(0), node.schema)
        if isinstance(node, Project):
            return O.project_chain(ch(0), node.outputs)
        if isinstance(node, Join):
            # hash-join output is ordered by probe row (prefix-sum
            # expansion / stable compaction); FULL appends the anti part
            if node.kind == "full":
                return None
            c = ch(0)
            if c is None and isinstance(node.left, Filter):
                # probe Filter fused into the join mask: the Filter node
                # never executed, but order flows through unchanged
                c = self.chains.get(path + (0, 0))
            if rec.get("merge_join"):
                # the merge join emits rows in JOIN-KEY order
                # (lexicographic over the packed key columns), with probe
                # order within equal-key runs -- a downstream aggregation
                # on the key takes the clustered, sort-free path
                front = []
                for a, b in node.equis:
                    pos = set()
                    if isinstance(a, ir.ColumnRef):
                        pos.add(a.name)
                    if node.kind == "inner" and isinstance(b, ir.ColumnRef):
                        pos.add(b.name)
                    if not pos:
                        front = None
                        break
                    front.append(pos)
                c = None if front is None else front + (c or [])
                return O.restrict_chain(c, node.schema)
            if node.kind == "inner" and node.equis:
                c = O.add_equivalences(c, node.equis)
            return O.restrict_chain(c, node.schema)
        if isinstance(node, Aggregate):
            primary = node.primary or node.group
            if not primary:
                return []
            if rec.get("clustered"):
                base = self.chains.get(path + (0,))
                if base is None:
                    base = self.chains.get(path + (0, 0))
                k = O.covers_prefix_k(base, primary)
                return O.restrict_chain(
                    None if not k else base[:k], node.schema)
            # sorted/dense grouping emits groups in lexicographic primary
            # order (the first key is packed most significant)
            return [{s} for s in primary]
        if isinstance(node, Sort):
            out = []
            for e, asc, _nf in node.keys:
                if not (isinstance(e, ir.ColumnRef) and asc):
                    break
                out.append({e.name})
            return out
        if isinstance(node, SingleRow):
            return []
        return None  # Union, MergeSorted, WindowNode

    def _x_Output(self, node: Output, path: Path) -> RecordBatch:
        b = self.execute(node.child, path + (0,))
        cols = {}
        for name, sym in node.names:
            c = b[sym]
            key = name
            i = 1
            while key in cols:
                key = f"{name}_{i}"
                i += 1
            cols[key] = c
        return RecordBatch(cols, b.num_rows)

    def _x_SingleRow(self, node: SingleRow, path: Path) -> RecordBatch:
        from ..types import BIGINT

        return RecordBatch(
            {"__row__": Column(torch.zeros((128,), dtype=torch.int64,
                                           device=self.device), BIGINT)}, 1)

    def _scan_table(self, node: Scan):
        """Resolve the (possibly domain-pruned) table for a scan.  Both
        eager discovery and compiled input collection go through here so
        recorded capacities always match the pruned shapes."""
        table = self.catalog.table(node.table)
        dom = getattr(node, "domain", None)
        if dom is not None and not dom.is_all():
            view = table.pruned(dom)
            if view is not None:
                return view
        return table

    def _x_Scan(self, node: Scan, path: Path) -> RecordBatch:
        table = self._scan_table(node)
        rec = self._rec(path)
        if self.compiled:
            # types and dictionaries as discovery saw them: a compiled run
            # never touches the catalog's device columns (a grouped query
            # frees each shard's upload after its run)
            cols = {}
            for sym, (t, dictionary) in rec["columns"].items():
                # a nullable column keeps its validity (the JAX package's
                # compiled scan drops it: ROADMAP C)
                cols[sym] = Column(self.scan_arrays[sym], t,
                                   validity=self.scan_arrays.get(
                                       _validity_key(sym)),
                                   dictionary=dictionary)
            return RecordBatch(cols, table.num_rows)
        b = table.batch(list(node.symbols.keys()), self.device)
        cols = {node.symbols[c]: col for c, col in b.columns.items()}
        rec["columns"] = {sym: (c.type, c.dictionary)
                          for sym, c in cols.items()}
        return RecordBatch(cols, b.num_rows)

    def scan_inputs(self, node: LogicalNode,
                    path: Path = ()) -> Dict[str, torch.Tensor]:
        """Collect {symbol: device tensor} for every scan column in the plan
        (the compiled program's inputs), and the validity of every nullable
        one under ``_validity_key(symbol)``.  Nothing under a stub path is
        read: a fragment's remote inputs arrive as stubs, and the tables of
        the stages that feed them are never uploaded here."""
        out: Dict[str, torch.Tensor] = {}
        if path in self.stubs:
            return out
        if isinstance(node, Scan):
            table = self._scan_table(node)
            for c, sym in node.symbols.items():
                col = table.column(c, self.device)
                out[sym] = col.data
                if col.validity is not None:
                    out[_validity_key(sym)] = col.validity
        for i, child in enumerate(node.children):
            out.update(self.scan_inputs(child, path + (i,)))
        return out

    def _x_Filter(self, node: Filter, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        pred = self._bind(node.predicate, child, path, "predicate")
        rec = self._rec(path)
        if self.compiled:
            cap = rec["capacity"]
        else:
            cap = child.capacity()
        out = filter_batch(pred, child, capacity=cap)
        self._check_capacity(out.num_rows, cap)
        out = self._shrink(out)
        if not self.compiled:
            rec["capacity"] = max(out.capacity(), rec.get("capacity", 0))
        return out

    def _x_Unnest(self, node: Unnest, path: Path) -> RecordBatch:
        """Array/map expansion (reference ``operator/unnest/``): each
        input row emits one output row per element.  The live lanes of the
        ``[n, W]`` element matrix (lane < length AND parent row live)
        compact in the compaction kernel; the element columns are then read
        at those flat lanes and the parent columns at lane // W, each in
        one launch of the gather kernel.  Rows come out in (parent row,
        lane) order, as the reference's flatten-and-compact gives them."""
        child = self.execute(node.child, path + (0,))
        arr = eval_expr(self._bind(node.array, child, path, "array"), child)
        n = child.capacity()
        # a zero-width element matrix (``array[]``) has no live lane: it
        # reads as one lane of length 0
        w = max(int(arr.data.shape[1]), 1)
        dev = arr.lengths.device
        lanes = (torch.arange(w, dtype=torch.int32, device=dev)[None, :]
                 < arr.lengths[:, None])
        row_live = iota(n, dev)[:, None] < child.num_rows
        if arr.validity is not None:
            row_live = row_live & arr.validity[:, None]
        mask = (lanes & row_live).reshape(n * w)
        rec = self._rec(path)
        # eager: the reference's compact-then-shrink capacity, sized from
        # the live lane count (one sync) without moving n * W rows
        cap = rec["capacity"] if self.compiled \
            else min(n * w, round_capacity(host_read(torch.sum(mask))))
        idx, count = compact_indices(mask, cap)
        t = node.array.type
        cols = gather_columns(child.columns,
                              torch.div(idx, w, rounding_mode="floor"))
        elems = [arr.data]
        if t.kind == "map" and node.value_symbol:
            elems.append(arr.map_values)
        if arr.data.shape[1] == 0:
            elems = [e.new_zeros((n, 1)) for e in elems]
        moved = gather_rows([e.reshape(n * w).contiguous() for e in elems],
                            idx)
        et = t.key if t.kind == "map" else t.element
        cols[node.symbol] = Column(moved[0], et, dictionary=arr.dictionary)
        if len(moved) > 1:
            cols[node.value_symbol] = Column(moved[1], t.value,
                                             dictionary=arr.dictionary)
        out = RecordBatch(cols, count)
        self._check_capacity(count, cap)
        out = self._shrink(out)
        if not self.compiled:
            rec["capacity"] = max(out.capacity(), rec.get("capacity", 0))
        return out

    def _x_MarkDistinct(self, node: MarkDistinct, path: Path) -> RecordBatch:
        """First-occurrence markers per (group keys, marker keys) combo
        (reference ``operator/MarkDistinctOperator.java``): pack the combo
        into int64 words, sort the rows stably by the words, flag word
        boundaries, and scatter the flags back to row order through the
        permutation (the scatter kernel; the JAX package sorts a second
        time by row index instead).  Dead rows pack to the INT64_MAX
        sentinel, so they sort past every live row and can never take a
        first occurrence from one."""
        from ..ops.common import pack_key_words, sort_permutation
        from ..types import BOOLEAN

        child = self.execute(node.child, path + (0,))
        n = child.capacity()
        cols = dict(child.columns)
        gcols = [child[s] for s in node.group]
        for mi, (msym, keys) in enumerate(node.markers):
            kcols = gcols + [
                eval_expr(self._bind(e, child, path, f"marker{mi}:{j}"),
                          child)
                for j, e in enumerate(keys)]
            ranges = self._ranges(path, f"ranges{mi}", kcols,
                                  child.num_rows)
            words = pack_key_words(kcols, ranges, child.num_rows)
            perm = sort_permutation(words)
            first = None
            for wd in gather_rows(words, perm):
                d = torch.ones_like(wd, dtype=torch.bool)
                d[1:] = wd[1:] != wd[:-1]
                first = d if first is None else (first | d)
            flags = scatter_distinct(perm, first.to(torch.int32), n)
            cols[msym] = Column(flags.to(torch.bool), BOOLEAN)
        return RecordBatch(cols, child.num_rows)

    def _x_Project(self, node: Project, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        cols: Dict[str, Column] = {}
        for sym, e in node.outputs:
            if isinstance(e, ir.ColumnRef):
                cols[sym] = child[e.name]
            else:
                cols[sym] = eval_expr(self._bind(e, child, path, f"out:{sym}"),
                                      child)
        return RecordBatch(cols, child.num_rows)

    def _x_Aggregate(self, node: Aggregate, path: Path) -> RecordBatch:
        # fuse an immediate child Filter into the aggregation mask
        # (but never through a fragment-input stub: the stubbed batch is the
        # filter's OUTPUT, its predicate already applied remotely)
        mask = None
        child_node = node.child
        if isinstance(child_node, Filter) and path + (0,) not in self.stubs:
            below = self.execute(child_node.child, path + (0, 0))
            if self.route_kernels and not node.group:
                # matched on the host during discovery, replayed compiled
                rec = self._rec(path)
                if not self.compiled:
                    rec["range_sum"] = match_range_product_sum(node, below)
                m = rec.get("range_sum")
                if m is not None:
                    return self._range_product_sum(node, path, below, m)
            pred = self._bind(child_node.predicate, below, path, "filter")
            mask = filter_mask(pred, below)
            child = below
        else:
            child = self.execute(child_node, path + (0,))

        if not self.compiled and self.spill_threshold and node.group:
            from .memory import batch_bytes

            if batch_bytes(child) > self.spill_threshold:
                # the partition loop takes the only reference to its input,
                # so the input's device memory is freed once partitioned
                held, child, below = [child], None, None
                return self._spilled_aggregate(node, path, held, mask)

        aggs = [
            AggSpec(
                a.fn,
                None if a.arg is None
                else eval_expr(self._bind(a.arg, child, path,
                                          f"agg:{a.symbol}"),
                               child),
                a.symbol, param=a.param,
            )
            for a in node.aggs
        ]
        if not node.group:
            return global_aggregate(aggs, child.num_rows, child.capacity(),
                                    checks=self.overflow_checks,
                                    mask=mask, device=self.device)
        primary = node.primary or node.group
        keys = [(s, child[s]) for s in primary]
        carry = [(s, child[s]) for s in node.group if s not in primary]
        ranges = self._ranges(path, "ranges", [c for _, c in keys],
                              child.num_rows)
        rec = self._rec(path)
        if not self.compiled:
            # clustered grouping: equal keys already adjacent in the input
            # (proved from connector sort metadata via the order chains) --
            # the grouping sort is elided (StreamingAggregation analog).
            # Sticky-false across eager reruns so compiled replay matches.
            from . import ordering as O

            base = self.chains.get(path + (0,))
            if base is None:
                base = self.chains.get(path + (0, 0))
            cl = (mask is None and O.covers_prefix(base, primary))
            rec["clustered"] = rec.get("clustered", True) and cl
        if self.compiled:
            max_groups = rec["max_groups"]
        else:
            max_groups = _group_bound(ranges, child.num_rows)
        out = group_aggregate(keys, aggs, child.num_rows, ranges, max_groups,
                              mask=mask, carry=carry,
                              checks=self.overflow_checks,
                              clustered=rec.get("clustered", False))
        if self.compiled:
            # compiled replays size every [max_groups] buffer by the
            # DISCOVERED group count, far below the span bound for sparse
            # keys; guard against growth
            self._check_capacity(out.num_rows, max_groups)
        else:
            rec["max_groups"] = max(round_capacity(host_read(out.num_rows)),
                                    rec.get("max_groups", 0))
        return self._shrink(out)

    def _spilled_aggregate(self, node: Aggregate, path: Path,
                           held: List[RecordBatch], mask) -> RecordBatch:
        """Partitioned aggregation through host RAM (the
        SpillableHashAggregationBuilder analog; partitions double as the
        grouped-execution Lifespan loop -- each group-key partition is
        aggregated end-to-end independently, outputs are disjoint).  A
        partition whose key domain is small takes the dense kernel, as an
        unspilled aggregation would."""
        from ..ops.filter import compact
        from .memory import batch_bytes
        from .spill import choose_partitions, spill_partitions

        rec = self._rec(path)
        rec["spilled"] = True
        child = held.pop()
        if mask is not None:  # materialise the fused filter before split
            child = self._shrink(compact(child, mask))
        primary = node.primary or node.group
        ranges = key_ranges([child[s] for s in primary], child.num_rows)
        n_parts = choose_partitions(batch_bytes(child), self.spill_threshold)
        rec["spill_partitions"] = n_parts
        parts = spill_partitions(child, primary, ranges, n_parts)
        del child
        moved = {"to_host_bytes": sum(sp.nbytes() for sp in parts),
                 "from_host_bytes": 0}
        outs = []
        for p, part in enumerate(parts):
            if p > 0 and part.num_rows == 0:
                continue
            d = self._unspill(part, moved)
            aggs = [
                AggSpec(a.fn,
                        None if a.arg is None
                        else eval_expr(self._bind(a.arg, d, path,
                                                  f"agg:{a.symbol}"), d),
                        a.symbol, param=a.param)
                for a in node.aggs
            ]
            keys = [(s, d[s]) for s in primary]
            carry = [(s, d[s]) for s in node.group if s not in primary]
            pr = key_ranges([c for _, c in keys], d.num_rows)
            out = group_aggregate(keys, aggs, d.num_rows, pr,
                                  _group_bound(pr, d.num_rows), carry=carry,
                                  checks=self.overflow_checks)
            outs.append(self._spill(self._shrink(out), moved))
        return self._spill_done(rec, outs, moved)

    # ---- spill plumbing: what a spilled operator moves over PCIe is kept
    # in its record ("spill"), and QueryStats shows it per operator

    def _unspill(self, sp, moved: dict) -> RecordBatch:
        from .spill import unspill

        moved["from_host_bytes"] += sp.nbytes()
        return unspill(sp, device=self.device)

    @staticmethod
    def _spill(batch: RecordBatch, moved: dict):
        from .spill import spill

        sp = spill(batch)
        moved["to_host_bytes"] += sp.nbytes()
        return sp

    def _spill_done(self, rec: dict, outs, moved: dict) -> RecordBatch:
        """The partition outputs back on the device as one batch."""
        from .spill import concat_spilled

        out = self._shrink(self._unspill(concat_spilled(outs), moved))
        rec["spill"] = {"partitions": rec["spill_partitions"], **moved}
        return out

    def _range_product_sum(self, node: Aggregate, path: Path,
                           below: RecordBatch, m: "RangeProductSum"
                           ) -> RecordBatch:
        """Filter + sum(a*b) through the fused kernel; the output column is
        built exactly as ``global_aggregate`` builds it."""
        rec = self._rec(path)
        key = ("range_sum_bounds", str(self.device))
        bounds = rec.get(key)
        if bounds is None:  # uploaded once, reused by every compiled run
            bounds = rec[key] = torch.tensor(
                m.bounds, dtype=torch.int64).to(self.device)
        n = below.num_rows
        ship, disc, qty, price = (below[s].data[:n] for s in m.columns)
        slo, shi, cnt = range_filter_limb_sums(ship, disc, qty, price,
                                               bounds)
        a = node.aggs[0]
        # the product column is decimal(38, s) or bigint: never provably
        # safe at 18 digits, so the guard is appended as the generic path
        # appends it
        total = _guard_limb_total(slo, shi, self.overflow_checks)
        # output_type() reads only the input column's SQL type
        out_t = AggSpec(a.fn, Column(None, a.arg.type), a.symbol
                        ).output_type()
        return RecordBatch(
            {a.symbol: Column(total[None], out_t,
                              validity=(cnt > 0)[None])}, 1)

    # ---- joins

    def _dynamic_filter(self, lb: RecordBatch, rb: RecordBatch,
                        lkeys, rkeys, probe_mask):
        """Build-side [min, max] key-domain mask over the probe, ANDed
        into the join's probe mask (``server/DynamicFilterService.java:95``
        min/max push-down analog).  Always a MASK, never a standalone
        compaction: masked rows pack to the key sentinel and fall out of
        the compaction the join already pays, so applying the domain
        costs two reductions and a compare.  An empty build side masks
        every probe row."""
        eligible = [(lk, rk) for lk, rk in zip(lkeys, rkeys)
                    if not lb[lk].type.is_string]
        if not eligible or not self.dynamic_filtering:
            return probe_mask
        dev = lb[lkeys[0]].data.device
        mask = iota(lb.capacity(), dev) < lb.num_rows
        if rb.capacity() == 0:  # an empty domain (and nothing to reduce)
            mask = torch.zeros_like(mask)
            eligible = []
        blive_base = iota(rb.capacity(), dev) < rb.num_rows
        for lk, rk in eligible:
            pc, bc = lb[lk], rb[rk]
            blive = blive_base
            if bc.validity is not None:
                blive = blive & bc.validity
            d = bc.data
            if d.is_floating_point():
                big = float("inf")
                p = pc.data
            else:
                d = d.to(torch.int64)
                big = INT64_MAX
                p = pc.data.to(torch.int64)
            lo = torch.amin(torch.where(blive, d, big))
            hi = torch.amax(torch.where(blive, d, -big))
            pm = (p >= lo) & (p <= hi)
            if pc.validity is not None:
                pm = pm & pc.validity
            mask = mask & pm
        return mask if probe_mask is None else (probe_mask & mask)

    def _x_Join(self, node: Join, path: Path) -> RecordBatch:
        # fuse an immediate probe-side Filter into a join mask (same
        # pattern as Aggregate): the mask packs dead rows to the key
        # sentinel, so the standalone filter compaction and its full
        # payload move disappear -- the join's own compaction drops them.
        # inner/semi/anti only (LEFT/FULL emit non-matching probe rows, so
        # rows a below-join filter removed would wrongly resurface).
        probe_mask = None
        if (isinstance(node.left, Filter) and path + (0,) not in self.stubs
                and node.kind in ("inner", "semi", "anti") and node.equis):
            below = self.execute(node.left.child, path + (0, 0))
            probe_mask = filter_mask(
                self._bind(node.left.predicate, below, path, "filter"), below)
            left = below
        else:
            left = self.execute(node.left, path + (0,))
        right = self.execute(node.right, path + (1,))
        rec = self._rec(path)

        if (not self.compiled and self.spill_threshold
                and node.kind != "cross" and node.equis):
            from .memory import batch_bytes

            if batch_bytes(left) + batch_bytes(right) > self.spill_threshold:
                if probe_mask is not None:
                    from ..ops.filter import compact

                    left = self._shrink(compact(left, probe_mask))
                    probe_mask = None
                # the partition loop takes the only references to its
                # inputs (see _x_Aggregate)
                held, left, right, below = [left, right], None, None, None
                return self._grace_join(node, path, held)

        if node.kind == "cross":
            if not self.compiled:
                rec["scalar_build"] = host_read(right.num_rows) == 1
            if rec.get("scalar_build"):
                rn = right.num_rows
                if self.compiled and self.guard_ranges \
                        and not isinstance(rn, int):
                    self.overflow_checks.append(rn == 1)
                right1 = RecordBatch(
                    {n: c.with_data(
                        c.data[:1],
                        c.validity[:1] if c.validity is not None else None)
                     for n, c in right.columns.items()}, 1)
                return cross_join(left, right1, left.capacity())
            if self.compiled:
                cap = rec["capacity"]
            else:
                cap = round_capacity(
                    max(host_read(left.num_rows)
                        * host_read(right.num_rows), 1))
                rec["capacity"] = max(cap, rec.get("capacity", 0))
            out = cross_join(left, right, cap)
            self._check_capacity(out.num_rows, cap)
            return self._shrink(out)

        lb, rb, lkeys, rkeys = self._join_keys(node, path, left, right)
        if not lkeys:
            raise ExecError(f"join without equi keys: {node.kind}")

        # dynamic filtering (inner/semi only -- left/anti keep non-matching
        # probe rows): the build side's key bounds mask the probe before
        # the join sees it, as device values, so compiled replays keep the
        # same shapes
        if node.kind in ("inner", "semi"):
            probe_mask = self._dynamic_filter(lb, rb, lkeys, rkeys,
                                              probe_mask)

        if self.compiled:
            ranges = rec["ranges"]
            if self.guard_ranges:
                self._guard_range_cols([lb[k] for k in lkeys], lb.num_rows,
                                       ranges)
                self._guard_range_cols([rb[k] for k in rkeys], rb.num_rows,
                                       ranges)
        else:
            lr = key_ranges([lb[k] for k in lkeys], lb.num_rows)
            rr = key_ranges([rb[k] for k in rkeys], rb.num_rows)
            ranges = [(min(a[0], b[0]), max(a[1], b[1]))
                      for a, b in zip(lr, rr)]
            if "ranges" in rec:
                ranges = [(min(a[0], b[0]), max(a[1], b[1]))
                          for a, b in zip(ranges, rec["ranges"])]
            rec["ranges"] = ranges

        if not self.compiled:
            # build side already sorted by the join key columns in key
            # order (order chains): the build sort in _probe_ranges is an
            # identity -- skip it.  NULLs would break it (null_high packs
            # them to the top), so every build key must be non-nullable.
            from . import ordering as O

            rchain = self.chains.get(path + (1,))
            bs = rchain is not None and len(rchain) >= len(node.equis)
            for i, (_, b) in enumerate(node.equis):
                bs = bs and isinstance(b, ir.ColumnRef) \
                    and rb[rkeys[i]].validity is None \
                    and bool(rchain) and i < len(rchain) \
                    and b.name in rchain[i]
            rec["build_sorted"] = rec.get("build_sorted", True) and bs
        build_sorted = rec.get("build_sorted", False)

        residual = None
        if node.residual is not None:
            merged = RecordBatch({**lb.columns, **rb.columns}, 0)
            residual = self._bind(node.residual, merged, path, "residual")

        if not self.compiled:
            rec["merge_join"] = merge_join_applicable(
                node.kind, ranges, residual,
                node.build_unique if node.kind == "inner" else False)
            # eager capacity guesses start from the FUSED-mask row count:
            # the probe batch itself is unfiltered when a Filter fused in
            rec["probe_rows"] = host_read(torch.sum(probe_mask)) \
                if probe_mask is not None else host_read(lb.num_rows)
        probe_rows = rec.get("probe_rows", 0)

        if node.kind in ("semi", "anti"):
            cap = round_capacity(max(probe_rows, 1)) \
                if not self.compiled else rec["capacity"]
            if residual is not None:
                if self.compiled:
                    out = hash_join(lb, rb, lkeys, rkeys, node.kind, ranges,
                                    rec["pairs_capacity"], residual=residual,
                                    build_sorted=build_sorted,
                                    probe_mask=probe_mask)
                else:
                    cap_pairs = round_capacity(max(probe_rows * 4, 128))
                    while True:
                        stats: Dict[str, object] = {}
                        out = hash_join(lb, rb, lkeys, rkeys, node.kind,
                                        ranges, cap_pairs, residual=residual,
                                        stats=stats,
                                        build_sorted=build_sorted,
                                        probe_mask=probe_mask)
                        pairs_total = host_read(stats["pairs_total"])
                        if pairs_total <= cap_pairs:
                            break
                        cap_pairs = round_capacity(pairs_total)
                    rec["pairs_capacity"] = max(
                        cap_pairs, rec.get("pairs_capacity", 0))
            else:
                out = hash_join(lb, rb, lkeys, rkeys, node.kind, ranges, cap,
                                build_sorted=build_sorted,
                                probe_mask=probe_mask)
            if not self.compiled:
                # the merge path's payload moves by GATHER at [capacity]:
                # record the TIGHT discovered output count, not the
                # probe-sized upper bound; growth trips the device guard
                tight = round_capacity(max(host_read(out.num_rows), 1)) \
                    if rec.get("merge_join") else cap
                rec["capacity"] = max(tight, rec.get("capacity", 0))
            self._check_capacity(out.num_rows, cap)
            out = self._drop_temp(out)
            return self._shrink(out)

        if node.kind == "full":
            return self._full_join(node, lb, rb, lkeys, rkeys, ranges,
                                   residual, rec)

        # inner / left
        if self.compiled:
            cap = rec["capacity"]
            stats = {}
            out = hash_join(lb, rb, lkeys, rkeys, node.kind, ranges, cap,
                            residual=residual, stats=stats,
                            build_unique=node.build_unique,
                            build_sorted=build_sorted,
                            probe_mask=probe_mask)
            self._check_capacity(out.num_rows, cap)
            if residual is not None and "pairs_total" in stats:
                # a residual join compacts AFTER expansion: the pair buffer
                # itself must not have overflowed or rows were dropped
                self._check_capacity(stats["pairs_total"], cap)
        else:
            if node.build_unique:
                cap = round_capacity(max(probe_rows, 1))
            else:
                cap = round_capacity(max(probe_rows * 2, 128))
            while True:
                stats = {}
                out = hash_join(lb, rb, lkeys, rkeys, node.kind, ranges, cap,
                                residual=residual, stats=stats,
                                build_unique=node.build_unique,
                                build_sorted=build_sorted,
                                probe_mask=probe_mask)
                total = host_read(out.num_rows)
                if "pairs_total" in stats:
                    total = max(total, host_read(stats["pairs_total"]))
                if total <= cap:
                    break
                cap = round_capacity(total)
            # merge-path inner joins gather payload at [capacity]: record
            # the tight output count; the classic paths keep the
            # pair-buffer-sized capacity
            tight = round_capacity(max(host_read(out.num_rows), 1)) \
                if rec.get("merge_join") else cap
            rec["capacity"] = max(tight, rec.get("capacity", 0))
        out = self._drop_temp(out)
        return self._shrink(out)

    def _join_keys(self, node: Join, path: Path, left: RecordBatch,
                   right: RecordBatch):
        """Both sides with their key expressions materialised as temp
        columns (``__lk{i}`` / ``__rk{i}``), and those columns' names."""
        lkeys, rkeys = [], []
        lb, rb = left, right
        for i, (a, b) in enumerate(node.equis):
            ln, rn = f"__lk{i}", f"__rk{i}"
            lb = RecordBatch(
                {**lb.columns, ln: eval_expr(self._bind(a, left, path, ln),
                                             left)},
                lb.num_rows)
            rb = RecordBatch(
                {**rb.columns, rn: eval_expr(self._bind(b, right, path, rn),
                                             right)},
                rb.num_rows)
            lkeys.append(ln)
            rkeys.append(rn)
        return lb, rb, lkeys, rkeys

    def _full_join(self, node, lb, rb, lkeys, rkeys, ranges, residual, rec):
        """FULL OUTER = left-join pairs ++ right rows with no match
        (null-extended on the left side), concatenated by the dynamic-copy
        kernel."""
        from ..batch import concat_batches
        from ..sql.optimizer import _refs, _split_ir_conjuncts
        from ..sql.planner import ir_conjoin

        cross_residual = None
        if residual is not None:
            # single-side ON conjuncts fold into key validity: ineligible
            # rows never match but still emit null-extended (FULL
            # semantics).  cross-side conjuncts stay a residual on both
            # directed passes.
            l_schema, r_schema = set(lb.columns), set(rb.columns)
            lo_parts, ro_parts, x_parts = [], [], []
            for c in _split_ir_conjuncts(residual):
                refs = _refs(c)
                if refs <= l_schema and not (refs & r_schema):
                    lo_parts.append(c)
                elif refs <= r_schema:
                    ro_parts.append(c)
                else:
                    x_parts.append(c)
            if x_parts:
                cross_residual = ir_conjoin(x_parts)

            def mask_keys(batch, parts, key_names):
                if not parts:
                    return batch
                # the parts of the bound residual: their lookups are bound
                m = filter_mask(ir_conjoin(parts), batch)
                cols = dict(batch.columns)
                for kname in key_names:
                    c = cols[kname]
                    v = m if c.validity is None else (c.validity & m)
                    cols[kname] = Column(c.data, c.type, validity=v,
                                         dictionary=c.dictionary)
                return RecordBatch(cols, batch.num_rows)

            lb = mask_keys(lb, lo_parts, lkeys)
            rb = mask_keys(rb, ro_parts, rkeys)
        if self.compiled:
            cap_l = rec["capacity"]
            cap_a = rec["anti_capacity"]
            cap_f = rec["full_capacity"]
        else:
            cap_l = round_capacity(max(host_read(lb.num_rows) * 2, 128))
            cap_a = round_capacity(max(host_read(rb.num_rows), 1))
        while True:
            stats: Dict[str, object] = {}
            pairs = hash_join(lb, rb, lkeys, rkeys, "left", ranges, cap_l,
                              residual=cross_residual, stats=stats)
            if self.compiled:
                self._check_capacity(stats["pairs_total"], cap_l)
                break
            total = max(host_read(pairs.num_rows),
                        host_read(stats["pairs_total"]))
            if total <= cap_l:
                break
            cap_l = round_capacity(total)
        if cross_residual is None:
            anti = hash_join(rb, lb, rkeys, lkeys, "anti", ranges, cap_a)
            self._check_capacity(anti.num_rows, cap_a)
        else:
            # anti with residual expands candidate pairs internally: its
            # buffer must hold the expansion, not just rb's rows
            if self.compiled:
                cap_ap = rec["anti_pairs_capacity"]
                astats: Dict[str, object] = {}
                anti = hash_join(rb, lb, rkeys, lkeys, "anti", ranges,
                                 cap_ap, residual=cross_residual,
                                 stats=astats)
                self._check_capacity(astats["pairs_total"], cap_ap)
            else:
                cap_ap = round_capacity(max(host_read(rb.num_rows) * 2, 128))
                while True:
                    astats = {}
                    anti = hash_join(rb, lb, rkeys, lkeys, "anti", ranges,
                                     cap_ap, residual=cross_residual,
                                     stats=astats)
                    if host_read(astats["pairs_total"]) <= cap_ap:
                        break
                    cap_ap = round_capacity(host_read(astats["pairs_total"]))
                rec["anti_pairs_capacity"] = max(
                    cap_ap, rec.get("anti_pairs_capacity", 0))
        # null-extend the left-side columns on the anti part
        ext = dict(anti.columns)
        n_a = anti.capacity()
        for name, c in lb.columns.items():
            if name not in ext:
                ext[name] = Column(
                    torch.zeros((n_a,) + tuple(c.data.shape[1:]),
                                dtype=c.data.dtype, device=c.data.device),
                    c.type, validity=torch.zeros(
                        (n_a,), dtype=torch.bool, device=c.data.device),
                    dictionary=c.dictionary)
        anti_full = RecordBatch({k: ext[k] for k in pairs.columns},
                                anti.num_rows)
        if not self.compiled:
            cap_f = round_capacity(
                max(host_read(pairs.num_rows) + host_read(anti.num_rows), 1))
            rec["capacity"] = max(cap_l, rec.get("capacity", 0))
            rec["anti_capacity"] = max(cap_a, rec.get("anti_capacity", 0))
            rec["full_capacity"] = max(cap_f, rec.get("full_capacity", 0))
        out = concat_batches(pairs, anti_full, cap_f)
        self._check_capacity(out.num_rows, cap_f)
        return self._shrink(self._drop_temp(out))

    def _grace_join(self, node: Join, path: Path,
                    held: List[RecordBatch]) -> RecordBatch:
        """Grace hash join through host RAM (the HashBuilderOperator
        SPILLING_INPUT path, ``operator/HashBuilderOperator.java:155``;
        spill medium = host RAM over PCIe).

        Both sides hash-partition on the join keys; each partition pair
        joins independently on the device through the join entry points
        (``hash_join``, which takes ``merge_join`` where it applies, and
        ``_full_join``), with inputs and results parked in host RAM,
        bounding peak device memory to ~1/P of the working set.  Eager
        (discovery) mode only -- the compiled path assumes resident
        inputs."""
        from ..ops.filter import compact
        from .memory import batch_bytes
        from .spill import choose_partitions, spill_partitions

        rec = self._rec(path)
        rec["spilled"] = True
        left, right = held
        held.clear()
        lb, rb, lkeys, rkeys = self._join_keys(node, path, left, right)
        if node.kind in ("inner", "semi"):
            # spill mode: apply the domain as a compaction (memory is the
            # constraint here, and compaction shrinks the partitions)
            m = self._dynamic_filter(lb, rb, lkeys, rkeys, None)
            if m is not None and host_read(torch.sum(m)) < 0.75 * max(
                    host_read(lb.num_rows), 1):
                lb = self._shrink(compact(lb, m))
        lr = key_ranges([lb[k] for k in lkeys], lb.num_rows)
        rr = key_ranges([rb[k] for k in rkeys], rb.num_rows)
        ranges = [(min(a[0], b[0]), max(a[1], b[1]))
                  for a, b in zip(lr, rr)]
        residual = None
        if node.residual is not None:
            merged = RecordBatch({**lb.columns, **rb.columns}, 0)
            residual = self._bind(node.residual, merged, path, "residual")
        total = batch_bytes(lb) + batch_bytes(rb)
        n_parts = choose_partitions(total, self.spill_threshold)
        rec["spill_partitions"] = n_parts
        lparts = spill_partitions(lb, lkeys, ranges, n_parts)
        rparts = spill_partitions(rb, rkeys, ranges, n_parts)
        del lb, rb, left, right  # free device inputs before the loop
        moved = {"to_host_bytes": sum(sp.nbytes() for sp in lparts + rparts),
                 "from_host_bytes": 0}
        outs = []
        for p, (lp, rp) in enumerate(zip(lparts, rparts)):
            if p > 0:  # partition 0 always runs so the schema exists
                if node.kind == "full":
                    if lp.num_rows == 0 and rp.num_rows == 0:
                        continue
                elif lp.num_rows == 0:
                    continue
                elif rp.num_rows == 0 and node.kind in ("inner", "semi"):
                    continue
            ld, rd = self._unspill(lp, moved), self._unspill(rp, moved)
            if node.kind == "full":
                out = self._full_join(node, ld, rd, lkeys, rkeys, ranges,
                                      residual, {})
            elif node.kind in ("semi", "anti"):
                cap = round_capacity(max(host_read(ld.num_rows), 1))
                if residual is not None:
                    cap_pairs = round_capacity(
                        max(host_read(ld.num_rows) * 4, 128))
                    while True:
                        st: Dict[str, object] = {}
                        out = hash_join(ld, rd, lkeys, rkeys, node.kind,
                                        ranges, cap_pairs, residual=residual,
                                        stats=st)
                        if host_read(st["pairs_total"]) <= cap_pairs:
                            break
                        cap_pairs = round_capacity(
                            host_read(st["pairs_total"]))
                else:
                    out = hash_join(ld, rd, lkeys, rkeys, node.kind, ranges,
                                    cap)
                out = self._drop_temp(out)
            else:  # inner / left
                factor = 1 if node.build_unique else 2
                cap = round_capacity(max(host_read(ld.num_rows) * factor, 128))
                while True:
                    st = {}
                    out = hash_join(ld, rd, lkeys, rkeys, node.kind, ranges,
                                    cap, residual=residual, stats=st,
                                    build_unique=node.build_unique)
                    # as in _x_Join: a residual join compacts after its
                    # expansion, so the pair buffer must have held every pair
                    need = max(host_read(out.num_rows),
                               host_read(st.get("pairs_total", 0)))
                    if need <= cap:
                        break
                    cap = round_capacity(need)
                out = self._drop_temp(out)
            outs.append(self._spill(self._shrink(out), moved))
        return self._spill_done(rec, outs, moved)

    def _drop_temp(self, b: RecordBatch) -> RecordBatch:
        cols = {n: c for n, c in b.columns.items() if not n.startswith("__")}
        return RecordBatch(cols, b.num_rows)

    # ---- set operations

    def _union_dictionaries(self, node: Union, parts) -> dict:
        """{symbol: (merged dictionary, per-part code remaps on the
        device)} for the varchar outputs: computed on the host once per
        plan, as the JAX package computes them; a part without a
        dictionary (a NULL column) has no remap."""
        return {sym: merge_dictionaries(
                    [parts[k][srcs[k]].dictionary
                     for k in range(len(parts))], self.device)
                for sym, t, srcs in node.outputs if t.is_string}

    def _x_WindowNode(self, node: WindowNode, path: Path) -> RecordBatch:
        from ..ops.window import WindowCall, window

        child = self.execute(node.child, path + (0,))

        def ev(e, slot):
            return eval_expr(self._bind(e, child, path, slot), child)

        pcols = [ev(e, f"part{i}") for i, e in enumerate(node.partition_by)]
        ranges = self._ranges(path, "ranges", pcols, child.num_rows) \
            if pcols else []
        okeys = [SortKey(ev(e, f"order{i}"), asc, nf)
                 for i, (e, asc, nf) in enumerate(node.order_by)]
        calls = [
            WindowCall(c.fn, None if c.arg is None else ev(c.arg, f"arg{j}"),
                       c.symbol, c.type, frame=c.frame,
                       default=None if c.default is None
                       else ev(c.default, f"default{j}"),
                       param=c.param)
            for j, c in enumerate(node.calls)
        ]
        return window(child, pcols, ranges, okeys, calls)

    def _x_Union(self, node: Union, path: Path) -> RecordBatch:
        parts = [self.execute(c, path + (i,))
                 for i, c in enumerate(node.inputs)]
        rec = self._rec(path)
        counts = [p.num_rows for p in parts]
        if self.compiled:
            cap = rec["capacity"]
        else:
            cap = round_capacity(max(sum(host_read(c) for c in counts), 1))
            rec["capacity"] = max(cap, rec.get("capacity", 0))
        total = counts[0]
        for c in counts[1:]:
            total = total + c
        key = ("dictionaries", str(self.device))
        dicts = rec.get(key)
        if dicts is None:  # once per plan; compiled runs reuse the uploads
            dicts = rec[key] = self._union_dictionaries(node, parts)
        columns, slots = [], []
        for sym, t, srcs in node.outputs:
            remaps = dicts[sym][1] if sym in dicts else [None] * len(parts)
            want = torch_dtype(t)
            data, valid = [], []
            for k, p in enumerate(parts):
                c = p[srcs[k]]
                d = c.data
                if remaps[k] is not None:
                    d = take_clamped(remaps[k], d)
                data.append(d.to(want).contiguous())
                valid.append(None if c.validity is None
                             else c.validity.contiguous())
            columns.append(data)
            slots.append((sym, "data"))
            if any(v is not None for v in valid):
                columns.append(valid)
                slots.append((sym, "validity"))
        moved = dict(zip(slots, concat_rows(
            columns, device_counts(counts, self.device), cap)))
        cols: Dict[str, Column] = {}
        for sym, t, _ in node.outputs:
            cols[sym] = Column(moved[(sym, "data")], t,
                               validity=moved.get((sym, "validity")),
                               dictionary=dicts[sym][0] if sym in dicts
                               else None)
        self._check_capacity(total, cap)
        return self._shrink(RecordBatch(cols, total))

    def _x_MergeSorted(self, node, path: Path) -> RecordBatch:
        """Input already globally ordered (an exchange merged per-task
        sorted runs); only offset/limit apply here."""
        child = self.execute(node.child, path + (0,))
        if node.offset:
            child = _skip_rows(child, node.offset)
        if node.limit is not None:
            child = limit_batch(child, node.limit)
        return self._shrink(child)

    def _x_Limit(self, node: Limit, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        if node.offset:
            child = _skip_rows(child, node.offset)
        if node.n is None:
            return self._shrink(child)
        return self._shrink(limit_batch(child, node.n))

    def _x_Sort(self, node: Sort, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        keys = [
            SortKey(eval_expr(self._bind(e, child, path, f"key{i}"), child),
                    asc, nf)
            for i, (e, asc, nf) in enumerate(node.keys)
        ]
        lim = None if node.limit is None else node.limit + node.offset
        out = sort_batch(child, keys, limit=lim)
        if node.offset:
            out = _skip_rows(out, node.offset)
        return self._shrink(out)


def _group_bound(ranges, num_rows: int) -> int:
    """Output slots of an eager grouped aggregation: the group count can
    never exceed the product of the key ranges' spans (tight for enum keys:
    Q1's 3x2 flags -> 128 slots, not 6M) nor the row count."""
    span_product = 1
    for lo, hi in ranges:
        span_product *= (hi - lo + 2)
        if span_product > num_rows:
            break
    return round_capacity(min(num_rows, span_product))


def _validity_key(sym: str) -> str:
    return f"{sym}|validity"


def _nested_key(sym: str, part: str) -> str:
    """Where a compiled fragment's output keeps a nested column's
    ``lengths`` / ``map_values`` (the JAX package's compiled fragments
    drop them: ROADMAP C13)."""
    return f"{sym}|{part}"


def _skip_rows(batch: RecordBatch, offset: int) -> RecordBatch:
    """Drop the first ``offset`` live rows (live rows are a prefix)."""
    cap = batch.capacity()
    off = min(offset, max(cap - 1, 0))  # keep >= 1 slot (num_rows masks)
    cols = {
        name: c.with_data(c.data[off:],
                          c.validity[off:] if c.validity is not None
                          else None)
        for name, c in batch.columns.items()
    }
    n = batch.num_rows
    n = max(n - offset, 0) if isinstance(n, int) \
        else torch.clamp(n - offset, min=0)
    return RecordBatch(cols, n)


# ------------------------------------------------ kernel routing (matcher)


class RangeProductSum:
    """A fragment the fused kernel computes: column symbols in the kernel's
    order (ship, disc, qty, price) and its five integer bounds
    [ship_lo, ship_hi_excl, disc_lo, disc_hi, qty_hi_excl]."""

    __slots__ = ("columns", "bounds")

    def __init__(self, columns, bounds):
        self.columns = tuple(columns)
        self.bounds = tuple(int(b) for b in bounds)


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}


def _conjuncts(e: ir.Expr):
    if isinstance(e, ir.Call) and e.fn == "and":
        for a in e.args:
            yield from _conjuncts(a)
    else:
        yield e


def _is_constant(e: ir.Expr) -> bool:
    return not any(isinstance(x, (ir.ColumnRef, ir.DictLookup, ir.Lambda))
                   for x in ir.walk(e))


def _integer_bound(col: ir.ColumnRef, const: ir.Expr, dtype) -> Optional[int]:
    """The constant as an integer in the column's stored units, by the
    evaluator's own coercion rule; None when comparing would rescale the
    column side or leave the integers."""
    probe = RecordBatch(
        {col.name: Column(torch.ones((1,), dtype=dtype), col.type)}, 1)
    try:
        a, b, va, vb, _ = _common_pair(col, const, probe)
    except (TypeError, NotImplementedError):
        return None
    if va is not None or vb is not None:
        return None
    if a.dtype not in (torch.int32, torch.int64) or \
            b.dtype not in (torch.int32, torch.int64):
        return None
    if int(a[0]) != 1:  # the column side was rescaled
        return None
    return int(b.reshape(-1)[0])


def match_range_product_sum(node: Aggregate, below: RecordBatch
                            ) -> Optional[RangeProductSum]:
    """Does ``Aggregate(Filter(below))`` have the fused kernel's shape?

    One ungrouped ``sum(a * b)`` over two columns, under a conjunction of
    column-vs-constant comparisons that normalises to ``lo <= x < hi`` on
    one column, ``lo <= b <= hi`` on a factor of the product and ``c < hi``
    on a third, all non-nullable int32/int64 columns without dictionary
    over a host-known row count.  Decided from the plan and the columns'
    storage alone, on the host, before anything is launched."""
    if node.group or len(node.aggs) != 1:
        return None
    agg = node.aggs[0]
    arg = agg.arg
    if agg.fn != "sum" or agg.distinct or not isinstance(arg, ir.Call) \
            or arg.fn != "*" or len(arg.args) != 2:
        return None
    fa, fb = arg.args
    if not (isinstance(fa, ir.ColumnRef) and isinstance(fb, ir.ColumnRef)):
        return None
    # the generic path multiplies in int64 only for a decimal product or
    # two bigints
    if not (arg.type.kind == "decimal"
            or (arg.type.kind == "bigint" and fa.type.kind == "bigint"
                and fb.type.kind == "bigint")):
        return None
    if fa.type.kind not in ("decimal", "bigint", "integer") or \
            fb.type.kind not in ("decimal", "bigint", "integer"):
        return None
    if not isinstance(below.num_rows, int):
        return None

    def storage_ok(name: str) -> bool:
        c = below.columns.get(name)
        return (c is not None and c.validity is None
                and c.dictionary is None and not c.is_nested
                and c.data.dtype in (torch.int32, torch.int64)
                and c.data.dim() == 1)

    if not (storage_ok(fa.name) and storage_ok(fb.name)):
        return None

    # per column: [lo inclusive or None, hi exclusive or None]
    ranges: Dict[str, list] = {}
    for conj in _conjuncts(node.child.predicate):
        if not isinstance(conj, ir.Call) or conj.fn not in _FLIP \
                or len(conj.args) != 2:
            return None
        x, y = conj.args
        fn = conj.fn
        if isinstance(y, ir.ColumnRef) and _is_constant(x):
            x, y, fn = y, x, _FLIP[fn]
        if not (isinstance(x, ir.ColumnRef) and _is_constant(y)):
            return None
        if not storage_ok(x.name):
            return None
        v = _integer_bound(x, y, below[x.name].data.dtype)
        if v is None:
            return None
        lo, hi = {">=": (v, None), ">": (v + 1, None), "<": (None, v),
                  "<=": (None, v + 1), "=": (v, v + 1)}[fn]
        r = ranges.setdefault(x.name, [None, None])
        if lo is not None:
            r[0] = lo if r[0] is None else max(r[0], lo)
        if hi is not None:
            r[1] = hi if r[1] is None else min(r[1], hi)

    if len(ranges) != 3:
        return None
    factors = [f.name for f in (fa, fb) if f.name in ranges]
    if len(factors) != 1 or fa.name == fb.name:
        return None
    disc = factors[0]
    price = fb.name if disc == fa.name else fa.name
    others = [n for n in ranges if n != disc]
    both = [n for n in others if None not in ranges[n]]
    upper = [n for n in others if ranges[n][0] is None
             and ranges[n][1] is not None]
    if None in ranges[disc] or len(both) != 1 or len(upper) != 1:
        return None
    ship, qty = both[0], upper[0]
    bounds = (ranges[ship][0], ranges[ship][1], ranges[disc][0],
              ranges[disc][1] - 1, ranges[qty][1])
    i64 = np.iinfo(np.int64)
    if any(not (i64.min <= b <= i64.max) for b in bounds):
        return None
    return RangeProductSum((ship, disc, qty, price), bounds)


# ------------------------------------------------------- compiled queries


def _fragment_roots(node: LogicalNode, path: Path = ()) -> List[Path]:
    """Fragment boundaries: every heavy operator roots its own compiled
    program (the PlanFragmenter analog -- reference
    ``sql/planner/PlanFragmenter.java:106`` cuts at exchanges; we cut at
    the heavy operators)."""
    out = [path] if (path == ()
                     or isinstance(node, (Aggregate, Join, Sort, WindowNode,
                                          Union))) \
        else []
    for i, c in enumerate(node.children):
        out += _fragment_roots(c, path + (i,))
    return out


def _node_at(plan: LogicalNode, path: Path) -> LogicalNode:
    node = plan
    for i in path:
        node = node.children[i]
    return node


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _k(path: Path, name: str, kind: str) -> str:
    return f"{'/'.join(map(str, path))}|{name}|{kind}"


class CompiledQuery:
    """A query pipeline fixed into a handful of fragment callables.

    The plan is cut into fragments at heavy-operator boundaries
    (_fragment_roots).  One eager discovery pass on the same device records
    every capacity, so each fragment is a Python callable over
    static-shape tensors that enqueues its work without waiting for the
    device; fragments chain on-device (counts and ``ok`` flags stay device
    tensors, no host syncs inside or between them), and the one readback
    happens at the end of ``__call__`` / ``block_run``.

    On a CUDA device a statement's second call captures every fragment
    into one CUDA graph (``exec/cuda_graph.py``), and later calls replay
    it: one launch a run in place of hundreds (``_execute`` says when).
    ``graph_state`` and ``graph_reason`` say whether it replays, and why
    not where it runs eagerly.
    """

    def __init__(self, catalog, plan: LogicalNode,
                 stubs: Optional[Dict[Path, RecordBatch]] = None,
                 sample: Optional[Dict[str, int]] = None,
                 sample_margin: Optional[float] = None,
                 device="cuda", route_kernels: bool = True):
        """``sample`` ({table: k}) runs discovery on a 1/k PREFIX of the
        named tables and extrapolates the recorded capacities and ranges
        (``exec/sampling.py``): sublinear discovery.  Sampled programs run
        with every range guarded: growth past any extrapolated value raises
        ExecError at the readback instead of silently truncating.

        ``stubs`` makes this a compiled FRAGMENT: the given paths are
        external inputs (a worker's remote sources) whose batches are
        supplied per run through ``__call__(stubs=...)``.  Discovery runs
        on these batches and takes its capacities from them, and every
        recorded key range is guarded in each run.  A later batch with
        other columns, types, dictionaries or capacity than the discovery
        batch raises ``ExecError`` before anything runs; one whose rows
        outgrow a recorded capacity or range raises ``ExecError`` at the
        readback.  Either way the caller discovers again (the worker
        counts it); nothing is truncated."""
        self.catalog = catalog
        self.external = dict(stubs or {})
        self.plan = plan
        self.device = torch.device(device)
        self.route_kernels = route_kernels
        self.sample = dict(sample) if sample else None
        # every recorded range checked on the device in each run: on for
        # extrapolated records (sampled here; grouped execution sets it)
        # and for fragments whose external inputs change from run to run
        self.guard_ranges = bool(self.sample) or bool(self.external)

        roots = sorted(set(_fragment_roots(plan)), key=len, reverse=True)
        # external stub paths are extra fragment boundaries: they never
        # run, their data arrives with each call
        roots = [r for r in roots
                 if not any(r[:len(p)] == p for p in self.external)]
        # discovery (capacity/range recording): the recorded values are
        # data-dependent, and the eager pass runs where the data lives
        disc_catalog = catalog
        if self.sample:
            from .sampling import sampled_catalog_view

            disc_catalog = sampled_catalog_view(catalog, self.sample)
        discoverer = Executor(disc_catalog, device=self.device,
                              route_kernels=route_kernels,
                              stubs=self.external)
        discoverer.capture_paths = set(roots)
        discoverer.execute(plan)
        self.record = discoverer.record
        # scan inputs stay resident on the device across runs (uploaded
        # before the record is extrapolated: the range resolver reads the
        # same cached columns)
        self._inputs = Executor(catalog, device=self.device,
                                stubs=self.external).scan_inputs(plan)
        self._inputs_replaced = False
        # fragment-boundary capacities from discovery: a selective
        # operator's compiled output otherwise keeps its INPUT-sized
        # buffers (no _shrink when compiled), and every downstream fragment
        # pays the oversize
        self._caps = {r: discoverer.captured[r].capacity() for r in roots}
        if self.sample:
            from .sampling import (DEFAULT_MARGIN, rewrite_record,
                                   scaled_boundary_caps)

            margin = sample_margin or DEFAULT_MARGIN
            rewrite_record(plan, self.record, self.sample, catalog,
                           margin=margin)
            self._caps = scaled_boundary_caps(plan, self._caps, self.sample,
                                              margin=margin)
        self._meta: Dict[Path, list] = {}
        for r in roots:
            b = discoverer.captured[r]
            self._meta[r] = [
                (n, c.type, c.dictionary, c.validity is not None)
                for n, c in b.columns.items()
            ]
        # an external input's columns, and its capacity, as discovery saw
        # them: a later call's batch must match (``_external_results``)
        self._ext_caps: Dict[Path, int] = {}
        for p, b in self.external.items():
            self._meta[p] = [
                (n, c.type, c.dictionary, c.validity is not None)
                for n, c in b.columns.items()
            ]
            self._ext_caps[p] = b.capacity()

        # child fragments of each root = roots (or external inputs) whose
        # longest proper prefix root is this one
        def parent_root(r: Path):
            for plen in range(len(r) - 1, -1, -1):
                if r[:plen] in self._meta and r[:plen] != r \
                        and r[:plen] not in self.external:
                    return r[:plen]
            return None

        children: Dict[Path, List[Path]] = {r: [] for r in roots}
        for r in list(roots) + list(self.external):
            p = parent_root(r)
            if p is not None:
                children[p].append(r)

        self._stages = []
        for root in roots:  # deepest-first (sorted by len desc)
            self._stages.append(
                (root, children[root],
                 self._make_fn(root, _node_at(plan, root), children[root])))

        # CUDA-graph replay (``_execute``): "pending" until the call after
        # an eager warm-up captures, then "captured"; "eager" for good
        # where no capture can serve the statement.  ``graph_reason`` says
        # why the latest call ran eagerly (None after a replay).
        self.graph_state, self.graph_reason = "pending", None
        self._graph_never: Optional[str] = None
        self._graph: Optional[StatementGraph] = None
        self._graph_lock = threading.Lock()
        self._warmed = False
        # what one replay executes, counted at capture: operator
        # executions and the reruns among them (``trace.operator_counts``)
        self.operators: Optional[Dict[str, int]] = None
        self._compiled_ptrs = self._input_ptrs()
        self._reasons_logged: set = set()
        if self.external:
            self._no_graph("the statement has external inputs (stubs): "
                           "each call brings its own batches")
        elif self.device.type != "cuda":
            self._no_graph(f"the device is {self.device.type}: a CUDA "
                           f"graph needs a CUDA device")

    @property
    def inputs(self) -> Optional[Dict[str, torch.Tensor]]:
        """{symbol: device tensor} of every scan column the fragments read
        (``Executor.scan_inputs``), resident across runs.  Replacing them
        (grouped execution swaps in each shard's) ends CUDA-graph replay
        for this statement."""
        return self._inputs

    @inputs.setter
    def inputs(self, value) -> None:
        self._inputs = value
        self._inputs_replaced = True

    def _make_fn(self, root: Path, node: LogicalNode,
                 child_roots: List[Path]):
        meta = self._meta

        def fn(scan_arrays, frag_inputs):
            stubs = {}
            for cr in child_roots:
                cols = {}
                for (nm, t, dic, has_v) in meta[cr]:
                    cols[nm] = Column(
                        frag_inputs[_k(cr, nm, "d")], t,
                        validity=frag_inputs.get(_k(cr, nm, "v")),
                        dictionary=dic,
                        lengths=frag_inputs.get(_k(cr, nm, "l")),
                        map_values=frag_inputs.get(_k(cr, nm, "m")))
                stubs[cr] = RecordBatch(
                    cols, frag_inputs[_k(cr, "", "n")])
            ex = Executor(self.catalog, compiled=True,
                          record=self.record,
                          scan_arrays=scan_arrays, stubs=stubs,
                          device=self.device,
                          route_kernels=self.route_kernels,
                          guard_ranges=self.guard_ranges)
            out = ex.execute(node, path=root)
            # fragment-boundary shrink to the discovered capacity
            # (live rows are a prefix); growth past it trips the
            # overflow guard instead of silently truncating
            cap = self._caps[root]
            if cap < out.capacity():
                if not isinstance(out.num_rows, int):
                    ex.overflow_checks.append(out.num_rows <= cap)
                elif out.num_rows > cap:
                    raise ExecError(
                        f"fragment {root} outgrew its discovered capacity")
                cols = {
                    n: c.with_data(
                        c.data[:cap],
                        c.validity[:cap]
                        if c.validity is not None else None)
                    for n, c in out.columns.items()
                }
                for n, c in out.columns.items():
                    if c.lengths is not None:
                        cols[n] = replace(
                            cols[n], lengths=c.lengths[:cap],
                            map_values=None if c.map_values is None
                            else c.map_values[:cap])
                out = RecordBatch(cols, out.num_rows)
            # a nested column's lengths and map values ride beside its
            # element matrix (``_nested_key``)
            data = {n: c.data for n, c in out.columns.items()}
            for n, c in out.columns.items():
                for part in ("lengths", "map_values"):
                    if getattr(c, part) is not None:
                        data[_nested_key(n, part)] = getattr(c, part)
            validity = {n: c.validity
                        for n, c in out.columns.items()
                        if c.validity is not None}
            ok = None
            for chk in ex.overflow_checks:
                ok = chk if ok is None else (ok & chk)
            return data, validity, out.num_rows, ok

        return fn

    def _wire(self, results: Dict[Path, tuple], child_roots,
              consume: bool) -> dict:
        """A fragment's inputs from its child fragments' results; with
        ``consume`` the results are dropped once wired in (each fragment
        output has exactly one consumer, so its device buffers are freed
        as soon as that consumer holds them)."""
        frag_inputs = {}
        for cr in child_roots:
            data, validity, n, _ = results[cr]
            for nm, _, _, _ in self._meta[cr]:
                frag_inputs[_k(cr, nm, "d")] = data[nm]
                if nm in validity:
                    frag_inputs[_k(cr, nm, "v")] = validity[nm]
                for part, kind in (("lengths", "l"), ("map_values", "m")):
                    if _nested_key(nm, part) in data:
                        frag_inputs[_k(cr, nm, kind)] = \
                            data[_nested_key(nm, part)]
            frag_inputs[_k(cr, "", "n")] = n
            if consume:
                del results[cr]
        return frag_inputs

    def _external_results(self, stubs: Optional[Dict[Path, RecordBatch]]
                          ) -> Dict[Path, tuple]:
        """A call's external batches (the discovery batches where ``stubs``
        names none) as fragment results ``(data, validity, n, ok)``.  Each
        must have the discovery batch's columns, types, dictionaries,
        nesting and capacity; anything else raises ``ExecError``, so the
        caller discovers again instead of running a program recorded for
        other data."""
        out: Dict[Path, tuple] = {}
        for p, meta in ((p, self._meta[p]) for p in self.external):
            b = (stubs or {}).get(p, self.external[p])
            cap = self._ext_caps[p]
            if b.capacity() != cap:
                raise ExecError(
                    f"external input {p}: capacity {b.capacity()}, "
                    f"discovered {cap}")
            if list(b.columns) != [m[0] for m in meta]:
                raise ExecError(f"external input {p}: columns {b.names} "
                                f"differ from discovery's")
            data, validity = {}, {}
            for nm, t, dic, has_v in meta:
                c = b.columns[nm]
                same_dict = c.dictionary is dic or (
                    c.dictionary is not None and dic is not None
                    and np.array_equal(c.dictionary, dic))
                if c.type != t or (c.validity is not None) != has_v \
                        or not same_dict:
                    raise ExecError(
                        f"external input {p}: column {nm} differs from "
                        f"discovery's in type, nullability or dictionary")
                data[nm] = c.data
                if c.validity is not None:
                    validity[nm] = c.validity
                for part in ("lengths", "map_values"):
                    if getattr(c, part) is not None:
                        data[_nested_key(nm, part)] = getattr(c, part)
            out[p] = (data, validity, b.num_rows, None)
        return out

    def _run(self, stubs: Optional[Dict[Path, RecordBatch]] = None):
        results: Dict[Path, tuple] = self._external_results(stubs) \
            if self.external else {}
        oks = []
        trace = TRACE.get()
        for root, child_roots, fn in self._stages:
            frag_inputs = self._wire(results, child_roots, consume=True)
            if trace is None:
                out = fn(self.inputs, frag_inputs)
            else:
                with trace.span("fragment", "/".join(map(str, root))):
                    out = fn(self.inputs, frag_inputs)
            del frag_inputs
            results[root] = out
            if out[3] is not None:
                oks.append(out[3])
        data, validity, num_rows, _ = results[()]
        return data, validity, num_rows, oks

    def _pair(self, num_rows, oks):
        """What the readback reads of one run: the row count where it is
        a number and no overflow flag was raised, else an int64 device
        tensor ``[count, ok]``, ``ok`` the AND of every overflow flag."""
        if isinstance(num_rows, int) and not oks:
            return num_rows
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for o in oks:
            ok = ok & o
        n = num_rows if not isinstance(num_rows, int) else torch.full(
            (), num_rows, dtype=torch.int64, device=self.device)
        return torch.stack([n.to(torch.int64), ok.to(torch.int64)])

    def _read(self, pairs: list) -> int:
        """The single device->host transfer of one or more runs (a
        ``_pair`` each): the last run's row count.  Raises ExecError
        unless every run's overflow flags hold."""
        flags = [p for p in pairs if isinstance(p, torch.Tensor)]
        if not flags:
            # the run's one wait for the device, traced on any device (a
            # trace records waits by site)
            trace = TRACE.get()
            if trace is None:
                _synchronize(self.device)
            else:
                trace.wait(_synchronize, self.device, 0)
            return pairs[-1]
        got = host_read(flags[0] if len(flags) == 1 else torch.stack(flags),
                        torch.Tensor.tolist)
        rows = [got] if len(flags) == 1 else got
        if not all(ok for _, ok in rows):
            raise ExecError(
                "compiled-plan buffer overflow: data outgrew the "
                "discovery-time capacities -- re-run Engine.compile()")
        return pairs[-1] if isinstance(pairs[-1], int) else int(rows[-1][0])

    def _eager(self, stubs):
        data, validity, num_rows, oks = self._run(stubs)
        return data, validity, self._pair(num_rows, oks)

    def _execute(self, stubs: Optional[Dict[Path, RecordBatch]]):
        """One run, ``(data, validity, pair)`` (``_pair``): one replay of
        the statement's CUDA graph where a graph can serve this call, else
        the fragments run eagerly and ``graph_reason`` says why.

        The first call that could replay runs eagerly (the kernels load,
        and the libraries make their first-call set-up, outside a capture);
        the next one captures every fragment, in stage order, into one
        graph and replays it.  A call replays only on a CUDA device,
        without external inputs, with the scan inputs the statement was
        compiled with, and while no other thread replays the same graph."""
        why = self._graph_blocker()
        if why is None and not self._graph_lock.acquire(blocking=False):
            why = "another thread is replaying this statement's graph"
        if why is None:
            try:
                if not self._warmed:
                    out = self._eager(stubs)
                    self._warmed = True
                    self._eager_because(
                        "warm-up: the first call runs eagerly, the next one "
                        "captures the statement's CUDA graph")
                    return out
                out = self._replay()
                if out is not None:
                    return out
                why = self.graph_reason
            finally:
                self._graph_lock.release()
        self._eager_because(why)
        return self._eager(stubs)

    def _input_ptrs(self):
        return None if self.inputs is None else [
            (k, t.data_ptr()) for k, t in self.inputs.items()]

    def _graph_blocker(self) -> Optional[str]:
        """Why this call cannot replay a graph; None when it may."""
        if self._inputs_replaced or self._input_ptrs() != self._compiled_ptrs:
            return ("its scan inputs are not the ones it was compiled with "
                    "(grouped execution swaps in each shard's)")
        return self._graph_never

    def _no_graph(self, why: str) -> None:
        """No capture will serve this statement, for ``why``."""
        self._graph_never = why
        self.graph_state = "eager"
        self._eager_because(why)

    def _eager_because(self, why: str) -> None:
        self.graph_reason = why
        if why not in self._reasons_logged:
            self._reasons_logged.add(why)
            _LOG.info("compiled statement runs eagerly: %s", why)

    def _replay(self):
        """Capture the graph on its first use, then replay it; None when
        the capture failed (the statement runs eagerly from then on)."""
        if self._graph is None:
            # the capture's operator spans, in the statement's trace or in
            # one of its own, count what each replay executes
            outer = TRACE.get()
            counted = outer if outer is not None else QueryTrace("capture")
            first = len(counted.spans)
            token = None if outer is not None else TRACE.set(counted)
            try:
                with host_tables_read() as tables:
                    graph = StatementGraph.capture(
                        lambda: self._eager(None), self.device)
            except Exception as e:  # the statement still runs, eagerly
                _LOG.warning("CUDA graph capture failed; the statement "
                             "runs eagerly", exc_info=True)
                self._no_graph(f"the capture failed: {type(e).__name__}: "
                               f"{e}")
                return None
            finally:
                if token is not None:
                    TRACE.reset(token)
            self.operators = operator_counts(counted.spans[first:])
            # what the graph reads, held for its life: the scan inputs,
            # and the dictionary tables its run looked up (a cache that
            # evicts)
            graph.keep = list(self.inputs.values()) + tables
            self._graph, self.graph_state = graph, "captured"
        with span("op:GraphReplay", self.operators):
            out = self._graph.replay()
        self.graph_reason = None
        return out

    def __call__(self, stubs: Optional[Dict[Path, RecordBatch]] = None
                 ) -> RecordBatch:
        with span("run"):
            data, validity, pair = self._execute(stubs)
            n = self._read([pair])
        cols = {
            nm: Column(data[nm], t, validity=validity.get(nm), dictionary=dic,
                       lengths=data.get(_nested_key(nm, "lengths")),
                       map_values=data.get(_nested_key(nm, "map_values")))
            for (nm, t, dic, _) in self._meta[()]
        }
        return RecordBatch(cols, n)

    def profile(self, reps: int = 5):
        """Per-fragment operator attribution on the compiled path (the
        OperatorStats analog, ``operator/OperatorStats.java``): each
        fragment runs once, then ``reps`` more times between two CUDA
        events, so the reported wall is that fragment's steady-state time
        on the device's timeline (on the CPU, where every op finishes
        before the next starts, the host clock).  Returns
        ``[(root_path, wall_s, rows, out_bytes), ...]`` in execution
        order.  Holds every fragment output alive for the walk -- a
        profiling call, not a production run."""
        import time as _time

        results: Dict[Path, tuple] = self._external_results(None) \
            if self.external else {}
        out_stats = []
        for root, child_roots, fn in self._stages:
            frag_inputs = self._wire(results, child_roots, consume=False)
            out = fn(self.inputs, frag_inputs)
            if self.device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(reps):
                    out = fn(self.inputs, frag_inputs)
                e1.record()
                e1.synchronize()
                wall = e0.elapsed_time(e1) / 1e3 / reps
            else:
                t0 = _time.perf_counter()
                for _ in range(reps):
                    out = fn(self.inputs, frag_inputs)
                wall = (_time.perf_counter() - t0) / reps
            rows = int(out[2])
            nbytes = sum(a.numel() * a.element_size()
                         for a in out[0].values())
            out_stats.append((root, wall, rows, nbytes))
            results[root] = out
        return out_stats

    def block_run(self, reps: int = 1,
                  stubs: Optional[Dict[Path, RecordBatch]] = None):
        """Execute ``reps`` times and block until complete (benchmarking).

        The runs are enqueued back-to-back without waiting for the device;
        the one readback of the last run's row count and of every run's
        overflow flags closes the batch, so the wall time around this call
        is steady-state throughput."""
        return self._read([self._execute(stubs)[2] for _ in range(reps)])
