"""Grouped execution on the compiled path -- the device-memory bound for
big scans.

The reference bounds working sets two ways: spilling revocable memory to
disk (``operator/HashBuilderOperator.java:155``) and grouped (lifespan)
execution that processes co-partitioned buckets one at a time
(``execution/Lifespan.java:26``, ``StageExecutionDescriptor.java:25-38``).
The eager engine has both (``exec/spill.py``); this module is the compiled
path's analog.

The plan's dominant table is row-sharded into K splits and the
partial-aggregation fragment is compiled once per distinct shard shape (row
counts differ by at most 1 across splits, so at most two programs exist).
The program runs K times, one split resident in device memory at a time,
and a final aggregation combines the partials.  Peak device memory is about
two shards' scan bytes (the running one and the next one's upload) plus the
partial outputs.

* The dominant table's host columns are made once per grouped query and
  kept page-locked; shard k+1 is uploaded on a side stream while shard k
  runs, and the compute stream waits on the upload's event.  A shard's
  upload is freed after its run (no catalog cache holds it).
* Only the dominant table's scan is sharded; build sides stay whole, so
  every probe split joins against the complete build.  Plans where a shard
  would change the answer are refused (``_check_shardable``): the dominant
  table must be scanned exactly once under the split aggregate, and the
  path down to that scan may pass only through Filter, Project and the
  probe side of inner or N:1 LEFT joins.  (The JAX package shards every
  scan of the dominant table, so a HAVING under a semi-join build sees
  per-shard partial sums: TPC-H Q18 answers 3 rows there where
  ``Engine.sql`` answers 1.  ROADMAP C6.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import Column, RecordBatch, concat_batches, round_capacity
from ..sql import logical as L
from .catalog import Catalog, ShardedTable, Table
from .executor import _node_at

Path = Tuple[int, ...]


class TableShardedCatalog(Catalog):
    """Catalog view sharding ONE table (the grouped-execution split
    source); every other table stays whole so join build sides are
    complete in each group."""

    def __init__(self, base: Catalog, table_name: str, index: int,
                 count: int):
        super().__init__()
        for name, t in base.tables.items():
            self.tables[name] = (ShardedTable(t, index, count)
                                 if name == table_name else t)


class _HostColumns(Table):
    """A table's columns made once on the host and kept there (page-locked
    when they go to a CUDA device); never uploaded whole."""

    def __init__(self, base: Table, pinned: bool):
        super().__init__(base.name, list(base.schema.items()),
                         device=base.device)
        self.base = base
        self.pinned = pinned
        self.unique_keys = list(base.unique_keys)
        self.sort_columns = list(base.sort_columns)
        self._host: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor],
                                    Column]] = {}

    @property
    def num_rows(self) -> int:
        return self.base.num_rows

    def _tensor(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.pinned else t

    def tensors(self, name: str):
        """(data, validity or None) as host tensors, and the column."""
        if name not in self._host:
            c = self.base.host_column(name)
            data = self._tensor(c.data)
            valid = None if c.validity is None else self._tensor(c.validity)
            self._host[name] = (data, valid, Column(
                data.numpy(), c.type,
                validity=None if valid is None else valid.numpy(),
                dictionary=c.dictionary))
        return self._host[name]

    def host_column(self, name: str) -> Column:
        return self.tensors(name)[2]

    def _load(self, column: str, device) -> Column:
        raise RuntimeError("a grouped query never uploads its dominant "
                           "table whole")


def _find_agg(node: L.LogicalNode, path: Path = ()) -> Optional[Path]:
    """Topmost Aggregate (first in preorder)."""
    if isinstance(node, L.Aggregate):
        return path
    for i, c in enumerate(node.children):
        got = _find_agg(c, path + (i,))
        if got is not None:
            return got
    return None


def _replace_at(plan: L.LogicalNode, path: Path,
                new: L.LogicalNode) -> L.LogicalNode:
    if not path:
        return new
    children = list(plan.children)
    children[path[0]] = _replace_at(children[path[0]], path[1:], new)
    return plan.with_children(children)


def _scan_paths(node: L.LogicalNode, path: Path = ()
                ) -> List[Tuple[str, Path]]:
    out = []
    if isinstance(node, L.Scan):
        out.append((node.table, path))
    for i, c in enumerate(node.children):
        out += _scan_paths(c, path + (i,))
    return out


def _check_shardable(below: L.LogicalNode, table: str) -> Path:
    """The path (from ``below``, the split aggregate's child) to the one
    scan of ``table``; ValueError unless sharding that scan leaves the
    aggregate's input the union of the shards' inputs."""
    scans = [p for t, p in _scan_paths(below) if t == table]
    if len(scans) != 1:
        raise ValueError(
            f"grouped execution needs exactly one scan of {table} under the "
            f"aggregation; the plan has {len(scans)}")
    node = below
    for i in scans[0]:
        if isinstance(node, (L.Filter, L.Project)):
            pass
        elif isinstance(node, L.Join) and i == 0 and (
                node.kind == "inner"
                or (node.kind == "left" and node.build_unique)):
            pass
        else:
            side = f" (child {i})" if isinstance(node, L.Join) else ""
            raise ValueError(
                f"grouped execution cannot shard {table} through "
                f"{type(node).__name__}"
                f"{' ' + node.kind if isinstance(node, L.Join) else ''}"
                f"{side}: only Filter, Project and the probe side of inner "
                f"or N:1 LEFT joins keep a shard's rows independent")
        node = node.children[i]
    return scans[0]


class GroupedCompiledQuery:
    """Compiled query executed in K row-shard groups of its dominant
    table.  ``info`` reports the grouping decisions for tests/EXPLAIN."""

    def __init__(self, engine, plan: L.LogicalNode, n_groups: int):
        from .dist_engine import split_aggregate

        self.engine = engine
        self.catalog = engine.catalog
        self.device = engine.device
        self.n_groups = n_groups

        agg_path = _find_agg(plan)
        if agg_path is None:
            raise ValueError("grouped compilation needs an aggregation")
        agg = _node_at(plan, agg_path)
        split = split_aggregate(agg)
        if split is None:
            raise ValueError(
                "aggregate is not partial/final splittable (distinct aggs)")
        partial, final, project = split
        self.partial_plan = partial.with_children([agg.child])
        tables = [t for t, _ in _scan_paths(self.partial_plan)]
        if not tables:
            raise ValueError("no scans under the aggregation")
        self.table = max(tables,
                         key=lambda t: self.catalog.table(t).num_rows)
        scan = _node_at(agg.child, _check_shardable(agg.child, self.table))
        self._scan_symbols = dict(scan.symbols)
        self._other_scans = [_node_at(self.partial_plan, p)
                             for t, p in _scan_paths(self.partial_plan)
                             if t != self.table]

        # coordinator-side remainder: original plan with the Aggregate
        # replaced by final(+assemble); the merged partials arrive as a
        # stub at the final's child path
        local = final.with_children([self.partial_plan])
        self.stub_path: Path = agg_path + (0,)
        if project is not None:
            local = project.with_children([local])
            self.stub_path = agg_path + (0, 0)
        self.coord_plan = _replace_at(plan, agg_path, local)

        self._host = _HostColumns(self.catalog.table(self.table),
                                  pinned=self.device.type == "cuda")
        self._hosted = Catalog()
        self._hosted.tables = dict(self.catalog.tables)
        self._hosted.tables[self.table] = self._host
        # at most two distinct shard shapes exist (row counts differ by
        # <= 1): one program per shape, made lazily
        self._programs: Dict[int, object] = {}
        self.info = {"shards": n_groups, "table": self.table,
                     "programs": 0, "runs": 0}

    def _shard(self, k: int) -> TableShardedCatalog:
        return TableShardedCatalog(self._hosted, self.table, k,
                                   self.n_groups)

    def _compile(self, cat: TableShardedCatalog):
        """Discovery on this shard, then its device copies dropped: a
        program's runs take their inputs from ``_upload``.  Key ranges
        widen to the whole table's, and every range is guarded: another
        shard's keys outside them raise ExecError (then that shard is
        discovered anew) instead of colliding."""
        from .executor import CompiledQuery
        from .sampling import widen_ranges

        cq = CompiledQuery(cat, self.partial_plan, device=self.device)
        widen_ranges(self.partial_plan, cq.record, self._hosted)
        cq.guard_ranges = True
        cq.inputs = None
        cat.table(self.table)._cache.clear()
        self._programs[cat.table(self.table).num_rows] = cq
        self.info["programs"] = len(self._programs)
        return cq

    def _program_for(self, k: int):
        cat = self._shard(k)
        cq = self._programs.get(cat.table(self.table).num_rows)
        return (cq or self._compile(cat)), cat

    def _upload(self, k: int, stream):
        """Shard k's scan inputs: the dominant table's rows copied from the
        page-locked host columns on ``stream`` (its event returned), every
        other scan's columns from the catalog (resident)."""
        from .executor import Executor, _validity_key

        shard = ShardedTable(self._host, k, self.n_groups)
        ex = Executor(self.catalog, device=self.device)
        inputs = {}
        for node in self._other_scans:
            inputs.update(ex.scan_inputs(node))
        if stream is None:  # host tensors: the shard is a view
            for col, sym in self._scan_symbols.items():
                data, valid, _ = self._host.tensors(col)
                inputs[sym] = data[shard.lo:shard.hi]
                if valid is not None:
                    inputs[_validity_key(sym)] = valid[shard.lo:shard.hi]
            return inputs, None
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            for col, sym in self._scan_symbols.items():
                data, valid, _ = self._host.tensors(col)
                for key, t in ((sym, data), (_validity_key(sym), valid)):
                    if t is None:
                        continue
                    dev = torch.empty((shard.hi - shard.lo,), dtype=t.dtype,
                                      device=self.device)
                    dev.copy_(t[shard.lo:shard.hi], non_blocking=True)
                    # allocated on the side stream, read on the main one:
                    # its memory is not reused before the main stream's
                    # reads are done
                    dev.record_stream(main)
                    inputs[key] = dev
            ready = torch.cuda.Event()
            ready.record(stream)
        return inputs, ready

    def __call__(self) -> RecordBatch:
        from .executor import ExecError, Executor

        side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        parts = []
        pending = self._upload(0, side)
        for k in range(self.n_groups):
            cq, cat = self._program_for(k)
            inputs, ready = pending
            # the next shard's upload overlaps this shard's run
            pending = self._upload(k + 1, side) \
                if k + 1 < self.n_groups else None
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            cq.inputs = inputs
            try:
                out = cq()
            except ExecError:
                # this shard outgrew the discovery shard's capacities:
                # re-discover on it (fresh capacities) and retry once
                cq.inputs = None
                cq = self._compile(cat)
                cq.inputs = inputs
                out = cq()
            cq.inputs = None
            del inputs
            self.info["runs"] += 1
            parts.append(out)

        total = sum(int(p.num_rows) for p in parts)
        cap = round_capacity(max(total, 1))
        merged = parts[0]
        for p in parts[1:]:
            merged = concat_batches(merged, p, cap)
        merged = RecordBatch(merged.columns, total)
        return Executor(self.catalog, stubs={self.stub_path: merged},
                        device=self.device).execute(self.coord_plan)

    def to_pandas(self):
        return self().to_pandas()
