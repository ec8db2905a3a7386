"""Sampled discovery -- sublinear capacity/range recording for compiled
queries.

The compiled path fixes every buffer shape from an eager *discovery* pass
(``exec/executor.py`` CompiledQuery), which replays the full data once
before the first compiled run: the time to a first answer grows with the
data.  The reference has no such pass because its per-task planning and
bytecode generation are data-independent
(``sql/planner/LocalExecutionPlanner.java:390``,
``sql/gen/ExpressionCompiler.java``).

Design: run discovery on a PREFIX sample of the dominant table(s) and
extrapolate the recorded values.

* **Prefix sampling keeps the recorded *structure* honest.**  Tables are
  stored sorted by primary key (connector sort metadata), so a row-prefix
  is a complete prefix of the key domain: groups clustered by the sort key
  stay *complete* (per-group sums/averages are exact, so HAVING-style
  selectivities survive -- q18's ``sum(l_quantity) > 300``), order chains
  (clustered aggregation, sorted builds) are preserved, and joins between
  prefix-aligned tables keep their true match rate.
* **Only the dominant table is sampled** (by default).  Sampling a
  dimension table would break foreign keys that are uniform over the full
  dimension domain (a fact-prefix join dim-prefix matches only f of the
  true rate -- an f-times capacity under-estimate).  With dimensions left
  whole, every join that touches the sampled fact scales linearly in f.
* **Capacities extrapolate by k*margin** on exactly the plan paths whose
  subtree scans a sampled table; untouched paths keep their exact values.
* **Key ranges widen to full-table min/max** resolved through symbol
  provenance (scan symbol maps + projection aliases).  Ranges guard key
  packing (out-of-range keys would clamp and collide), so a sampled range
  is never trusted: unresolvable keys keep their sampled range and rely on
  the device-side in-range guards (``Executor.guard_ranges``) that every
  sampled compiled program enables -- growth past any extrapolated value
  raises at the readback instead of silently truncating.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..batch import round_capacity
from ..expr import ir
from ..sql.logical import (
    Aggregate, Join, LogicalNode, MarkDistinct, Project, Scan,
)

Path = Tuple[int, ...]

# record keys holding row capacities (see exec/executor.py recording sites)
CAP_KEYS = (
    "capacity", "pairs_capacity", "anti_capacity", "anti_pairs_capacity",
    "full_capacity", "df_capacity", "max_groups",
)
# extrapolated capacities get head-room: sampled selectivities wobble
DEFAULT_MARGIN = 1.3
# never extrapolate below this many rows -- absorbs near-zero sampled
# counts (a selective HAVING can pass a handful of sampled groups)
CAP_FLOOR = 8192


def choose_sample(catalog, plan: LogicalNode,
                  threshold: int = 8_000_000,
                  target: int = 2_000_000) -> Optional[Dict[str, int]]:
    """Auto policy: prefix-sample the LARGEST scanned table when it
    exceeds ``threshold`` rows, down to ~``target`` rows.  Returns
    {table: k} (keep 1/k of the rows) or None when sampling isn't worth
    it."""
    best, best_n = None, 0
    for t in sorted(_subtree_tables(plan)):
        n = catalog.table(t).num_rows
        if n > best_n:
            best, best_n = t, n
    if best is None or best_n < threshold:
        return None
    k = max(2, math.ceil(best_n / target))
    return {best: k}


def sampled_catalog_view(catalog, sample: Dict[str, int]):
    """Catalog view where each sampled table is its leading 1/k prefix
    (``ShardedTable(t, 0, k)`` -- a contiguous slice, so sort metadata and
    dictionaries carry through unchanged; a view of the column where the
    table already holds it on the device)."""
    from .catalog import ShardedTable

    class _View:
        def __init__(self):
            self._tables: Dict[str, object] = {}

        def table(self, name: str):
            if name not in self._tables:
                t = catalog.table(name)
                self._tables[name] = (
                    ShardedTable(t, 0, sample[name])
                    if name in sample else t)
            return self._tables[name]

        def __contains__(self, name):
            return name in catalog

    return _View()


def _subtree_tables(node: LogicalNode) -> set:
    if isinstance(node, Scan):
        return {node.table}
    out: set = set()
    for c in node.children:
        out |= _subtree_tables(c)
    return out


def _symbol_origins(plan: LogicalNode) -> Dict[str, Tuple[str, str]]:
    """symbol -> (table, column) provenance through scans and pass-through
    projections."""
    origins: Dict[str, Tuple[str, str]] = {}
    aliases: Dict[str, str] = {}

    def walk(node: LogicalNode):
        if isinstance(node, Scan):
            for col, sym in node.symbols.items():
                origins[sym] = (node.table, col)
        elif isinstance(node, Project):
            for sym, e in node.outputs:
                if isinstance(e, ir.ColumnRef) and sym != e.name:
                    aliases[sym] = e.name
        for c in node.children:
            walk(c)

    walk(plan)
    resolved: Dict[str, Tuple[str, str]] = dict(origins)
    for sym in list(aliases):
        s, seen = sym, set()
        while s in aliases and s not in seen:
            seen.add(s)
            s = aliases[s]
        if s in origins:
            resolved[sym] = origins[s]
    return resolved


class _RangeResolver:
    """Full-data (min, max) per (table, column) from the real catalog
    (exact -- the stored encoding, unlike spec-derived stats), cached.
    Read from the table's column where it is resident on the device (a
    compiled query uploads every scanned column before its record is
    extrapolated: one reduction and one readback a key column, no
    generation), else from its host column."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._cache: Dict[Tuple[str, str], Optional[Tuple[int, int]]] = {}

    def range_of(self, table: str, column: str) -> Optional[Tuple[int, int]]:
        key = (table, column)
        if key not in self._cache:
            self._cache[key] = self._compute(table, column)
        return self._cache[key]

    def _compute(self, table, column):
        try:
            t = self.catalog.table(table)
            c = t.cached(column, t.device)
            if c is None:
                c = t.host_column(column)
        except (KeyError, NotImplementedError):  # no such column: guarded
            return None
        if c.dictionary is not None:
            return (0, max(len(c.dictionary) - 1, 0))
        data = torch.as_tensor(c.data)
        if c.validity is not None:
            data = data[torch.as_tensor(c.validity)]
        if data.numel() == 0 or data.is_floating_point():
            return None  # float keys never feed pack_key_words ranges
        d = data.to(torch.int64)
        lo, hi = torch.stack([d.min(), d.max()]).tolist()
        return (int(lo), int(hi))


def _key_exprs_for(node: LogicalNode, key: str) -> Optional[List[list]]:
    """The key expressions behind a recorded range list: one candidate
    list per range entry (every candidate must widen -- a join range spans
    both sides).  Entries are ir exprs or bare symbol-name strings."""
    if isinstance(node, Join) and key == "ranges":
        return [[a, b] for a, b in node.equis]
    if isinstance(node, Aggregate) and key == "ranges":
        primary = node.primary or node.group
        return [[s] for s in primary]
    if isinstance(node, MarkDistinct) and key.startswith("ranges"):
        try:
            mi = int(key[len("ranges"):])
        except ValueError:
            return None
        if mi >= len(node.markers):
            return None
        _, keys = node.markers[mi]
        return [[s] for s in node.group] + [[e] for e in keys]
    return None


def _sym_name(e) -> Optional[str]:
    if isinstance(e, str):
        return e
    if isinstance(e, ir.ColumnRef):
        return e.name
    return None


def rewrite_record(plan: LogicalNode, record: Dict[Path, dict],
                   sample: Dict[str, int], catalog,
                   margin: float = DEFAULT_MARGIN) -> None:
    """Extrapolate a sampled-discovery record in place: scale capacities
    on affected paths by k*margin, widen resolvable key ranges to exact
    full-table bounds."""
    from .executor import _node_at

    k = max(sample.values())
    for path, rec in record.items():
        try:
            node = _node_at(plan, path)
        except (IndexError, AttributeError):
            continue
        if _subtree_tables(node) & set(sample):
            for ck in CAP_KEYS:
                if isinstance(rec.get(ck), int):
                    rec[ck] = round_capacity(
                        max(int(rec[ck] * k * margin), CAP_FLOOR))
    widen_ranges(plan, record, catalog)


def widen_ranges(plan: LogicalNode, record: Dict[Path, dict],
                 catalog) -> None:
    """Widen every recorded key range whose key resolves to a scanned
    column to that column's full-table (min, max), in place (also used by
    grouped execution, whose discovery sees one shard)."""
    from .executor import _node_at

    origins = _symbol_origins(plan)
    resolver = _RangeResolver(catalog)
    for path, rec in record.items():
        try:
            node = _node_at(plan, path)
        except (IndexError, AttributeError):
            continue
        # the record also holds per-plan device objects under tuple keys
        for rkey in [x for x in rec
                     if isinstance(x, str) and x.startswith("ranges")]:
            ranges = rec[rkey]
            if not isinstance(ranges, list):
                continue
            exprs = _key_exprs_for(node, rkey)
            if exprs is None or len(exprs) != len(ranges):
                continue
            widened = []
            for (lo, hi), cands in zip(ranges, exprs):
                for e in cands:
                    name = _sym_name(e)
                    if name is None:
                        continue
                    org = origins.get(name)
                    if org is None:
                        continue
                    fr = resolver.range_of(*org)
                    if fr is not None:
                        lo, hi = min(lo, fr[0]), max(hi, fr[1])
                widened.append((lo, hi))
            rec[rkey] = widened


def scaled_boundary_caps(plan: LogicalNode, caps: Dict[Path, int],
                         sample: Dict[str, int],
                         margin: float = DEFAULT_MARGIN) -> Dict[Path, int]:
    """Fragment-boundary capacities from sampled discovery, extrapolated
    the same way as the in-record capacities."""
    from .executor import _node_at

    k = max(sample.values())
    out = {}
    for path, cap in caps.items():
        try:
            node = _node_at(plan, path)
            affected = bool(_subtree_tables(node) & set(sample))
        except (IndexError, AttributeError):
            affected = True  # unknown: be conservative
        out[path] = (round_capacity(max(int(cap * k * margin), CAP_FLOOR))
                     if affected else cap)
    return out
