"""Plan statistics derivation: NDV / min-max / selectivity propagation.

The analog of the reference's ``cost/`` package: ``FilterStatsCalculator``
(range + equality selectivity over column stats), ``JoinStatsRule``
(equi-join output = |L||R| / max(NDV)), ``AggregationStatsRule`` (group
NDV product), fed by connector-reported column statistics
(``spi/statistics/``; ``plugin/trino-tpch/.../statistics/``).  Estimates
drive join ordering, broadcast-vs-repartition distribution, and exchange
sizing; every rule falls back to the previous fixed coefficients when a
column has no statistics, so stat-less catalogs keep their old plans.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Set

from ..expr import ir
from . import logical as L

# fixed coefficients for stat-less inputs (the pre-stats heuristics)
UNKNOWN_FILTER_SEL = 0.25
UNKNOWN_AGG_RATIO = 0.1


@dataclass(frozen=True)
class ColStats:
    """Connector/derived statistics for one column.

    ``lo``/``hi`` are in the column's STORED unit (scaled ints for
    decimals, days for dates) so they compare directly against literal
    values in predicates."""

    ndv: Optional[float] = None  # None = unknown cardinality
    lo: Optional[float] = None
    hi: Optional[float] = None
    null_frac: float = 0.0


@dataclass
class PlanStats:
    rows: float
    cols: Dict[str, ColStats]  # by output symbol

    def col(self, sym: str) -> Optional[ColStats]:
        return self.cols.get(sym)


def _lit_num(e: ir.Expr) -> Optional[float]:
    if isinstance(e, ir.Literal) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return float(e.value)
    return None


def _conjuncts(e: Optional[ir.Expr]):
    if e is None:
        return []
    if isinstance(e, ir.Call) and e.fn == "and":
        out = []
        for a in e.args:
            out += _conjuncts(a)
        return out
    return [e]


def _clamp_ndv(cols: Dict[str, ColStats], rows: float) -> Dict[str, ColStats]:
    return {s: (replace(c, ndv=min(c.ndv, max(rows, 1.0)))
                if c.ndv is not None and c.ndv > rows else c)
            for s, c in cols.items()}


def _selectivity(pred: ir.Expr, stats: PlanStats):
    """(selectivity, refined column stats or None) for one conjunct."""
    if isinstance(pred, ir.Call) and pred.fn in ("=", "<", "<=", ">", ">=",
                                                 "<>"):
        a, b = pred.args
        # normalize to (column, literal)
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        if isinstance(b, ir.ColumnRef) and _lit_num(a) is not None:
            a, b = b, a
            if pred.fn in flip:
                pred = ir.Call(flip[pred.fn], (a, b), pred.type)
        if isinstance(a, ir.ColumnRef) and _lit_num(b) is not None:
            cs = stats.col(a.name)
            if cs is None:
                return UNKNOWN_FILTER_SEL, None
            v = _lit_num(b)
            if pred.fn == "=":
                if cs.ndv is None:
                    return UNKNOWN_FILTER_SEL, None
                return 1.0 / max(cs.ndv, 1.0), (a.name, replace(
                    cs, ndv=1.0, lo=v, hi=v))
            if pred.fn == "<>":
                if cs.ndv is None:
                    return 1.0 - UNKNOWN_FILTER_SEL, None
                return 1.0 - 1.0 / max(cs.ndv, 1.0), None
            if cs.lo is None or cs.hi is None or cs.hi <= cs.lo:
                return UNKNOWN_FILTER_SEL, None
            width = cs.hi - cs.lo
            if pred.fn in ("<", "<="):
                frac = (v - cs.lo) / width
                refined = replace(cs, hi=min(cs.hi, v))
            else:
                frac = (cs.hi - v) / width
                refined = replace(cs, lo=max(cs.lo, v))
            frac = min(max(frac, 0.0), 1.0)
            ndv = None if cs.ndv is None else max(cs.ndv * frac, 1.0)
            return frac, (a.name, replace(refined, ndv=ndv))
    if isinstance(pred, ir.Call) and pred.fn == "in" :
        a = pred.args[0]
        if isinstance(a, ir.ColumnRef):
            cs = stats.col(a.name)
            k = len(pred.args) - 1
            if cs is not None and cs.ndv is not None and k:
                return min(k / max(cs.ndv, 1.0), 1.0), (a.name, replace(
                    cs, ndv=float(k)))
    if isinstance(pred, ir.Call) and pred.fn == "between" and len(
            pred.args) == 3:
        a, lo_e, hi_e = pred.args
        lo_v, hi_v = _lit_num(lo_e), _lit_num(hi_e)
        if isinstance(a, ir.ColumnRef) and lo_v is not None \
                and hi_v is not None:
            cs = stats.col(a.name)
            if cs is not None and cs.lo is not None and cs.hi is not None \
                    and cs.hi > cs.lo:
                frac = min(max((hi_v - lo_v) / (cs.hi - cs.lo), 0.0), 1.0)
                ndv = None if cs.ndv is None else max(cs.ndv * frac, 1.0)
                return frac, (a.name, replace(
                    cs, lo=max(cs.lo, lo_v), hi=min(cs.hi, hi_v), ndv=ndv))
    return UNKNOWN_FILTER_SEL, None


def derive(node: L.LogicalNode, catalog,
           memo: Optional[dict] = None) -> PlanStats:
    """Bottom-up statistics for a plan subtree, memoised in ``memo`` by
    node id.  The memo holds each node beside its statistics, so no id it
    keys is recycled onto another node while the memo lives."""
    if memo is None:
        memo = {}
    hit = memo.get(id(node))
    if hit is not None:
        return hit[1]
    out = _derive(node, catalog, memo)
    memo[id(node)] = (node, out)
    return out


class StatementStats:
    """The statistics one ``optimize`` call reads, and its join search's
    counts.

    It stands in for the catalog in the optimizer's passes: ``table(name)``
    gives a view whose ``num_rows`` and ``column_stats(column)`` read the
    catalog once each (Trino's ``CachingStatsProvider``), and ``rows(node)``
    derives through one memo for the whole call.  Of a table's columns it
    reads only those ``_looked_up`` finds in ``plan``, the plan whose
    joins the call orders: a derivation over that plan's nodes and
    expressions reads the statistics of no other column.  Each ``optimize``
    call makes its own and drops it on return: nothing outlives the
    statement, so a write between two statements is seen by the next
    one."""

    def __init__(self, catalog, plan: L.LogicalNode):
        self.catalog = catalog
        self.memo: dict = {}
        self._plan = plan
        self._columns: Optional[Dict[str, Set[str]]] = None
        self._tables: Dict[str, "_TableStats"] = {}
        # the optimize span's detail: the largest join cluster's relations,
        # the join splits visited, the candidates whose statistics were
        # derived, and the catalog's num_rows / column_stats reads
        self.relations = self.splits = self.costed = self.reads = 0

    def table(self, name: str) -> "_TableStats":
        view = self._tables.get(name)
        if view is None:
            view = self._tables[name] = _TableStats(
                self.catalog.table(name), self, name)
        return view

    def columns(self, table: str) -> Set[str]:
        """The columns of ``table`` whose statistics this call reads."""
        if self._columns is None:
            self._columns = _looked_up(self._plan)
        return self._columns.get(table, set())

    def rows(self, node: L.LogicalNode) -> float:
        return derive(node, self, self.memo).rows

    def detail(self) -> dict:
        return {"relations": self.relations, "splits": self.splits,
                "costed": self.costed, "stats_reads": self.reads}


def _looked_up(plan: L.LogicalNode) -> Dict[str, Set[str]]:
    """By table, the scanned columns whose symbol a filter, a join
    condition or a projection of ``plan`` names, or an aggregate groups
    by: ``_derive`` looks up the statistics of no other symbol, in this
    plan or in one rebuilt from its nodes and expressions."""
    symbols: Set[str] = set()
    scans = []
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, L.Scan):
            scans.append(node)
        elif isinstance(node, L.Filter):
            symbols |= ir.referenced_columns(node.predicate)
        elif isinstance(node, L.Project):
            for _, e in node.outputs:
                symbols |= ir.referenced_columns(e)
        elif isinstance(node, L.Join):
            for a, b in node.equis:
                symbols |= ir.referenced_columns(a)
                symbols |= ir.referenced_columns(b)
            if node.residual is not None:  # a Filter once reordered
                symbols |= ir.referenced_columns(node.residual)
        elif isinstance(node, L.Aggregate):
            symbols.update(node.group)
        stack.extend(node.children)
    out: Dict[str, Set[str]] = {}
    for scan in scans:
        out.setdefault(scan.table, set()).update(
            c for c, sym in scan.symbols.items() if sym in symbols)
    return out


_UNREAD = object()


class _TableStats:
    """A table as one ``StatementStats`` reads it: each statistic from the
    catalog once, none for a column outside its ``columns``, every other
    attribute the table's own."""

    def __init__(self, table, owner: StatementStats, name: str):
        self._table, self._owner, self._name = table, owner, name
        self._rows = _UNREAD
        self._cols: dict = {}

    @property
    def num_rows(self):
        if self._rows is _UNREAD:
            self._rows = self._table.num_rows
            self._owner.reads += 1
        return self._rows

    def column_stats(self, column: str):
        cs = self._cols.get(column, _UNREAD)
        if cs is _UNREAD:
            if column not in self._owner.columns(self._name):
                return None
            getter = getattr(self._table, "column_stats", None)
            if getter is None:
                return None
            cs = self._cols[column] = getter(column)
            self._owner.reads += 1
        return cs

    def __getattr__(self, name):
        return getattr(self._table, name)


def unique_keysets(node: L.LogicalNode, catalog) -> Set[frozenset]:
    """Sets of symbols known unique in this relation's output.  Scan
    uniqueness comes from connector statistics (Table.unique_keys — the
    TpchMetadata/statistics analog), so TPC-DS and file/memory tables get
    the same N:1 plans TPC-H does."""
    if isinstance(node, L.Scan):
        out = set()
        try:
            keys = getattr(catalog.table(node.table), "unique_keys", [])
        except Exception:
            keys = []
        for key in keys:
            if all(c in node.symbols for c in key):
                out.add(frozenset(node.symbols[c] for c in key))
        return out
    if isinstance(node, (L.Filter, L.Sort, L.Limit)):
        return unique_keysets(node.children[0], catalog)
    if isinstance(node, L.Project):
        child = unique_keysets(node.child, catalog)
        passthrough = {s for s, e in node.outputs
                       if isinstance(e, ir.ColumnRef)}
        return {k for k in child if k <= passthrough}
    if isinstance(node, L.Aggregate):
        return {frozenset(node.group)} if node.group else set()
    if isinstance(node, L.Join):
        if node.kind in ("semi", "anti"):
            return unique_keysets(node.left, catalog)
        if node.kind in ("inner", "left") and node.build_unique:
            # N:1 join: output rows are a subset of (left) probe rows, so
            # the probe side's unique keysets survive — this is what lets
            # lineitem ⋈ (orders ⋈ customer) keep o_orderkey unique and
            # take the expansion-free N:1 fast path (Q3/Q4/Q10 shape)
            return unique_keysets(node.left, catalog)
        return set()
    return set()


def _scan_stats(node: L.Scan, catalog) -> PlanStats:
    try:
        table = catalog.table(node.table)
    except Exception:  # unknown table (stub schema)
        return PlanStats(1000.0, {})
    rows = float(table.num_rows)
    cols: Dict[str, ColStats] = {}
    getter = getattr(table, "column_stats", None)
    for col, sym in node.symbols.items():
        cs = getter(col) if getter is not None else None
        if cs is not None:
            cols[sym] = cs
    return PlanStats(rows, cols)


def _derive(node: L.LogicalNode, catalog, memo) -> PlanStats:
    if isinstance(node, L.Scan):
        return _scan_stats(node, catalog)
    if isinstance(node, L.Filter):
        child = derive(node.child, catalog, memo)
        rows = child.rows
        cols = dict(child.cols)
        for conj in _conjuncts(node.predicate):
            sel, refined = _selectivity(conj, PlanStats(rows, cols))
            rows *= sel
            if refined is not None:
                cols[refined[0]] = refined[1]
        rows = max(rows, 1.0)
        return PlanStats(rows, _clamp_ndv(cols, rows))
    if isinstance(node, L.Project):
        child = derive(node.child, catalog, memo)
        cols = {}
        for sym, e in node.outputs:
            base = e
            while isinstance(base, ir.Call) and base.fn == "cast":
                base = base.args[0]
            if isinstance(base, ir.ColumnRef) and base.name in child.cols:
                cols[sym] = child.cols[base.name]
        return PlanStats(child.rows, cols)
    if isinstance(node, L.Join):
        lt = derive(node.left, catalog, memo)
        rt = derive(node.right, catalog, memo)
        if node.kind == "cross" or not node.equis:
            rows = lt.rows * rt.rows if node.kind == "cross" \
                else max(lt.rows, rt.rows)
        else:
            # |J| = |L||R| / max(composite-NDV_L, composite-NDV_R).  The
            # per-side composite NDV is the product of column NDVs CAPPED
            # by that side's row count — multi-key joins on correlated
            # columns (Q9's (suppkey, partkey) vs partsupp's PK) otherwise
            # over-divide by orders of magnitude (JoinStatsRule caps the
            # same way via row counts).
            prod_l = prod_r = 1.0
            known = False
            for a, b in node.equis:
                la = lt.col(a.name) if isinstance(a, ir.ColumnRef) else None
                rb = rt.col(b.name) if isinstance(b, ir.ColumnRef) else None
                if la is not None and la.ndv is not None:
                    prod_l *= max(la.ndv, 1.0)
                    known = True
                if rb is not None and rb.ndv is not None:
                    prod_r *= max(rb.ndv, 1.0)
                    known = True
            # a build side UNIQUE on its join keys makes the join N:1 —
            # each probe row matches at most once, and the match fraction
            # is |R| / NDV_R(keys) (1.0 when R is the unfiltered key
            # domain).  The generic max(NDV_L, NDV_R) formula instead
            # divides by the probe side's composite-NDV estimate, which
            # the row-count cap OVERSTATES on correlated FK composites
            # (q9's (l_suppkey, l_partkey): capped at |lineitem|, truth
            # ~|partsupp|) — underestimating N:1 joins 8x and misordering
            # them ahead of genuinely selective ones.
            unique = node.build_unique
            if not unique:
                build_syms = frozenset(
                    b.name for _, b in node.equis
                    if isinstance(b, ir.ColumnRef))
                if build_syms:
                    unique = any(k <= build_syms
                                 for k in unique_keysets(node.right,
                                                         catalog))
            if unique:
                # match fraction = surviving share of the build's key
                # domain; keys are unique, so the pre-filter relation's
                # row count IS the domain size
                base = node.right
                while isinstance(base, (L.Filter, L.Project, L.Limit)):
                    base = base.children[0]
                base_rows = derive(base, catalog, memo).rows
                rows = lt.rows * min(
                    1.0, rt.rows / max(base_rows, rt.rows, 1.0))
            elif known:
                denom = max(min(prod_l, max(lt.rows, 1.0)),
                            min(prod_r, max(rt.rows, 1.0)), 1.0)
                rows = lt.rows * rt.rows / denom
            else:
                rows = max(lt.rows, rt.rows)
            if node.kind == "semi":
                rows = min(rows, lt.rows)
            elif node.kind == "anti":
                rows = max(lt.rows - rows, 1.0)
            elif node.kind == "left":
                rows = max(rows, lt.rows)
            elif node.kind == "full":
                rows = max(rows, lt.rows, rt.rows)
        if node.residual is not None:
            rows *= UNKNOWN_FILTER_SEL
        rows = max(rows, 1.0)
        cols = dict(lt.cols)
        if node.kind in ("inner", "left", "cross", "full"):
            cols.update(rt.cols)
        return PlanStats(rows, _clamp_ndv(cols, rows))
    if isinstance(node, L.Aggregate):
        child = derive(node.child, catalog, memo)
        if not node.group:
            return PlanStats(1.0, {})
        ndv_prod = 1.0
        known = True
        for g in node.group:
            cs = child.col(g)
            if cs is None or cs.ndv is None:
                known = False
                break
            ndv_prod *= max(cs.ndv, 1.0)
        rows = min(ndv_prod, child.rows) if known \
            else max(child.rows * UNKNOWN_AGG_RATIO, 1.0)
        cols = {g: child.cols[g] for g in node.group if g in child.cols}
        return PlanStats(max(rows, 1.0), _clamp_ndv(cols, rows))
    if isinstance(node, L.Union):
        parts = [derive(c, catalog, memo) for c in node.inputs]
        return PlanStats(sum(p.rows for p in parts), {})
    if isinstance(node, (L.Sort, L.Limit)):
        child = derive(node.children[0], catalog, memo)
        n = getattr(node, "limit", None) if isinstance(node, L.Sort) \
            else node.n
        rows = min(child.rows, float(n)) if n else child.rows
        return PlanStats(rows, child.cols)
    if node.children:
        child = derive(node.children[0], catalog, memo)
        return PlanStats(child.rows, child.cols)
    return PlanStats(1.0, {})
