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
prefix-sum path otherwise; its row moves and compactions, like Sort's, go
through the gather and scatter kernels.

The port executes Output, SingleRow, Scan, Filter, Project, Limit,
Aggregate (grouped or not; spilling is ROADMAP A9) and Sort; the other plan
nodes raise ``NotImplementedError`` naming the ROADMAP item that brings
them (``_LATER_NODES``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, round_capacity
from ..expr import ir
from ..expr.eval import _common_pair, bind_string_ops, eval_expr
from ..ops import AggSpec, filter_batch, global_aggregate, group_aggregate
from ..ops.filter import filter_mask
from ..ops.common import key_ranges
from ..ops.hashagg import _guard_limb_total
from ..ops.sort import SortKey, limit_batch, sort_batch
from ..ops.kernels.filter_sum import range_filter_limb_sums
from ..sql.logical import (
    Aggregate, Filter, Join, Limit, LogicalNode, Output, Project, Scan,
    SingleRow, Sort, Union, WindowNode,
)

Path = Tuple[int, ...]


class ExecError(Exception):
    pass


# plan nodes later slices bring, by ROADMAP item
_LATER_NODES = {
    "Join": "ROADMAP A6", "Union": "ROADMAP A7",
    "WindowNode": "ROADMAP A9", "Unnest": "ROADMAP A9",
    "MarkDistinct": "ROADMAP A9", "MergeSorted": "ROADMAP A9",
}


class Executor:
    def __init__(self, catalog, compiled: bool = False,
                 record: Optional[Dict[Path, dict]] = None,
                 scan_arrays: Optional[Dict[str, torch.Tensor]] = None,
                 stats=None, stubs: Optional[Dict[Path, RecordBatch]] = None,
                 device="cuda", route_kernels: bool = True):
        self.catalog = catalog
        self.compiled = compiled
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
        fits the discovery-time capacity (silent truncation otherwise)."""
        if self.compiled and not isinstance(total, int):
            self.overflow_checks.append(total <= capacity)

    # ---- helpers

    def _rec(self, path: Path) -> dict:
        return self.record.setdefault(path, {})

    def _dicts(self, batch: RecordBatch) -> Dict[str, np.ndarray]:
        return {
            n: c.dictionary for n, c in batch.columns.items()
            if c.dictionary is not None
        }

    def _bind(self, e: ir.Expr, batch: RecordBatch) -> ir.Expr:
        return bind_string_ops(e, self._dicts(batch))

    def _shrink(self, batch: RecordBatch) -> RecordBatch:
        """Sync the row count to host and re-bucket capacity (eager only)."""
        if self.compiled:
            return batch
        n = int(batch.num_rows) if not isinstance(batch.num_rows, int) else batch.num_rows
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
            return rec[key]
        r = key_ranges(cols, num_rows)
        if key in rec:  # widen across runs
            r = [(min(a[0], b[0]), max(a[1], b[1]))
                 for a, b in zip(r, rec[key])]
        rec[key] = r
        return r

    # ---- dispatch

    def execute(self, node: LogicalNode, path: Path = ()) -> RecordBatch:
        if path in self.stubs:  # fragment input boundary
            return self.stubs[path]
        kind = type(node).__name__
        m = getattr(self, f"_x_{kind}", None)
        if m is None:
            raise NotImplementedError(
                f"plan node {kind} is not in this slice of the port "
                f"({_LATER_NODES.get(kind, 'ROADMAP A9')})")
        if self.stats is None or self.compiled:
            out = m(node, path)
        else:
            import time as _time

            t0 = _time.time()
            out = m(node, path)
            rows = out.num_rows if isinstance(out.num_rows, int) else int(out.num_rows)
            # cumulative wall time (includes children) -- rendered as such
            self.stats.record(path, kind, "",
                              _time.time() - t0, rows, out.capacity())
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

        def ch(i: int):
            return self.chains.get(path + (i,))

        if isinstance(node, Scan):
            return O.chain_from_table(self._scan_table(node), node.symbols)
        if isinstance(node, (Filter, Limit)):
            return ch(0)  # stable compaction / prefix keep
        if isinstance(node, Project):
            return O.project_chain(ch(0), node.outputs)
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
        return None  # nodes this slice does not execute

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
        if self.compiled:
            cols = {}
            for c, sym in node.symbols.items():
                src = table.column(c, self.device)
                cols[sym] = Column(self.scan_arrays[sym], src.type,
                                   dictionary=src.dictionary)
            return RecordBatch(cols, table.num_rows)
        b = table.batch(list(node.symbols.keys()), self.device)
        cols = {node.symbols[c]: col for c, col in b.columns.items()}
        return RecordBatch(cols, b.num_rows)

    def scan_inputs(self, node: LogicalNode) -> Dict[str, torch.Tensor]:
        """Collect {symbol: device tensor} for every scan column in the plan
        (the compiled program's inputs)."""
        out: Dict[str, torch.Tensor] = {}
        if isinstance(node, Scan):
            table = self._scan_table(node)
            for c, sym in node.symbols.items():
                out[sym] = table.column(c, self.device).data
        for child in node.children:
            out.update(self.scan_inputs(child))
        return out

    def _x_Filter(self, node: Filter, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        pred = self._bind(node.predicate, child)
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

    def _x_Project(self, node: Project, path: Path) -> RecordBatch:
        child = self.execute(node.child, path + (0,))
        cols: Dict[str, Column] = {}
        for sym, e in node.outputs:
            if isinstance(e, ir.ColumnRef):
                cols[sym] = child[e.name]
            else:
                cols[sym] = eval_expr(self._bind(e, child), child)
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
            pred = self._bind(child_node.predicate, below)
            mask = filter_mask(pred, below)
            child = below
        else:
            child = self.execute(child_node, path + (0,))

        aggs = [
            AggSpec(
                a.fn,
                None if a.arg is None
                else eval_expr(self._bind(a.arg, child), child),
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
            # group count can never exceed the product of key-range spans
            # (tight for enum keys: Q1's 3x2 flags -> 128 slots, not 6M)
            span_product = 1
            for lo, hi in ranges:
                span_product *= (hi - lo + 2)
                if span_product > child.num_rows:
                    break
            max_groups = round_capacity(min(child.num_rows, span_product))
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
            rec["max_groups"] = max(round_capacity(int(out.num_rows)),
                                    rec.get("max_groups", 0))
        return self._shrink(out)

    def _spilled_aggregate(self, node, path, child, mask):
        raise NotImplementedError(
            "spilled aggregation is not in this slice of the port "
            "(ROADMAP A9)")

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
            SortKey(eval_expr(self._bind(e, child), child), asc, nf)
            for e, asc, nf in node.keys
        ]
        lim = None if node.limit is None else node.limit + node.offset
        out = sort_batch(child, keys, limit=lim)
        if node.offset:
            out = _skip_rows(out, node.offset)
        return self._shrink(out)


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
    granularity='single' runs the whole pipeline as one fragment.
    """

    def __init__(self, catalog, plan: LogicalNode,
                 granularity: str = "fragment",
                 stubs: Optional[Dict[Path, RecordBatch]] = None,
                 sample: Optional[Dict[str, int]] = None,
                 sample_margin: Optional[float] = None,
                 device="cuda", route_kernels: bool = True):
        """External fragment inputs (``stubs``) and sampled discovery
        (``sample``) are not in this slice of the port (ROADMAP A8):
        ``stubs`` raises, ``sample`` is accepted and discovery runs on the
        full data."""
        if stubs:
            raise NotImplementedError(
                "external fragment inputs are not in this slice of the "
                "port (ROADMAP A8)")
        self.catalog = catalog
        self.plan = plan
        self.device = torch.device(device)
        self.route_kernels = route_kernels

        roots = sorted(set(_fragment_roots(plan)), key=len, reverse=True) \
            if granularity == "fragment" else [()]
        # discovery (capacity/range recording): the recorded values are
        # data-dependent, and the eager pass runs where the data lives
        discoverer = Executor(catalog, device=self.device,
                              route_kernels=route_kernels)
        discoverer.capture_paths = set(roots)
        discoverer.execute(plan)
        self.record = discoverer.record
        # fragment-boundary capacities from discovery: a selective
        # operator's compiled output otherwise keeps its INPUT-sized
        # buffers (no _shrink when compiled), and every downstream fragment
        # pays the oversize
        self._caps = {r: discoverer.captured[r].capacity() for r in roots}
        # scan inputs stay resident on the device across runs
        self.inputs = Executor(catalog, device=self.device).scan_inputs(plan)
        self._meta: Dict[Path, list] = {}
        for r in roots:
            b = discoverer.captured[r]
            self._meta[r] = [
                (n, c.type, c.dictionary, c.validity is not None)
                for n, c in b.columns.items()
            ]

        # child fragments of each root = roots whose longest proper prefix
        # root is this one
        def parent_root(r: Path):
            for plen in range(len(r) - 1, -1, -1):
                if r[:plen] in self._meta and r[:plen] != r:
                    return r[:plen]
            return None

        children: Dict[Path, List[Path]] = {r: [] for r in roots}
        for r in roots:
            p = parent_root(r)
            if p is not None:
                children[p].append(r)

        self._stages = []
        for root in roots:  # deepest-first (sorted by len desc)
            self._stages.append(
                (root, children[root],
                 self._make_fn(root, _node_at(plan, root), children[root])))

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
                        dictionary=dic)
                stubs[cr] = RecordBatch(
                    cols, frag_inputs[_k(cr, "", "n")])
            ex = Executor(self.catalog, compiled=True,
                          record=self.record,
                          scan_arrays=scan_arrays, stubs=stubs,
                          device=self.device,
                          route_kernels=self.route_kernels)
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
                out = RecordBatch(cols, out.num_rows)
            data = {n: c.data for n, c in out.columns.items()}
            validity = {n: c.validity
                        for n, c in out.columns.items()
                        if c.validity is not None}
            ok = None
            for chk in ex.overflow_checks:
                ok = chk if ok is None else (ok & chk)
            return data, validity, out.num_rows, ok

        return fn

    def precompile(self, max_workers: Optional[int] = None) -> None:
        """No-op.  The reference lowers and compiles its fragment programs
        up front on a thread pool because its ahead-of-time compiler
        charges a large cost per program; here a fragment is a Python
        callable over eager tensor ops and there is nothing to compile.
        (CUDA-graph capture of a fragment would hang here: ROADMAP A8.)"""

    def _run(self):
        results: Dict[Path, tuple] = {}
        oks = []
        for root, child_roots, fn in self._stages:
            frag_inputs = {}
            for cr in child_roots:
                data, validity, n, _ = results[cr]
                for nm, _, _, _ in self._meta[cr]:
                    frag_inputs[_k(cr, nm, "d")] = data[nm]
                    if nm in validity:
                        frag_inputs[_k(cr, nm, "v")] = validity[nm]
                frag_inputs[_k(cr, "", "n")] = n
                # each fragment output has exactly one consumer -- free the
                # device buffers as soon as they are wired in
                del results[cr]
            out = fn(self.inputs, frag_inputs)
            del frag_inputs
            results[root] = out
            if out[3] is not None:
                oks.append(out[3])
        data, validity, num_rows, _ = results[()]
        return data, validity, num_rows, oks

    def _readback(self, num_rows, oks) -> int:
        """The run's single device->host transfer: the row count and the
        AND of every overflow flag, in one tensor."""
        if isinstance(num_rows, int) and not oks:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            return num_rows
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for o in oks:
            ok = ok & o
        n = num_rows if not isinstance(num_rows, int) else torch.full(
            (), num_rows, dtype=torch.int64, device=self.device)
        n_host, ok_host = torch.stack(
            [n.to(torch.int64), ok.to(torch.int64)]).tolist()
        if not ok_host:
            raise ExecError(
                "compiled-plan buffer overflow: data outgrew the "
                "discovery-time capacities -- re-run Engine.compile()")
        return int(n_host)

    def __call__(self) -> RecordBatch:
        data, validity, num_rows, oks = self._run()
        n = self._readback(num_rows, oks)
        cols = {
            nm: Column(data[nm], t, validity=validity.get(nm), dictionary=dic)
            for (nm, t, dic, _) in self._meta[()]
        }
        return RecordBatch(cols, n)

    def block_run(self, reps: int = 1):
        """Execute ``reps`` times and block until complete (benchmarking).

        The runs are enqueued back-to-back without waiting for the device;
        the one readback of the last run's row count and of every run's
        overflow flags closes the batch, so the wall time around this call
        is steady-state throughput."""
        all_oks = []
        for _ in range(reps):
            data, validity, num_rows, oks = self._run()
            all_oks += oks
        return self._readback(num_rows, all_oks)
