"""The port's join ordering (``sql/optimizer.py``) against a plain copy of
its earlier form, and the statistics one optimisation reads.

The reference below is the join search as it was before each statement
read its statistics once: every candidate split costed, every estimate
derived afresh from the catalog (``_estimate`` without a shared memo,
``_orient`` re-deriving both sides), edges matched by walking their
expressions.  ``optimize`` runs twice on each plan, once with the port's
``_reorder`` and once with the reference's, and the two plans' serde JSON
must be equal: over every TPC-H query 1-22 and every TPC-DS query of
``tpcds/queries.py`` (their catalogs' statistics at SF 0.01 and SF 1), and
over seeded random join graphs with synthetic row counts and NDVs, ties in
cost included.  Then: one statement reads each table's row count and each
column's statistics at most once, a write between two statements is seen
by the next, and the traced ``optimize`` span carries the search's counts.
"""

import collections
import random

import pytest
import torch

import presto1_tpu_torch.sql.optimizer as opt
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.session import Session
from presto1_tpu_torch.expr import ir
from presto1_tpu_torch.sql import logical as L
from presto1_tpu_torch.sql import parser
from presto1_tpu_torch.sql.planner import Planner
from presto1_tpu_torch.sql.serde import plan_to_json
from presto1_tpu_torch.sql.stats import ColStats, derive
from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog
from presto1_tpu_torch.tpcds.queries import QUERIES as TPCDS
from presto1_tpu_torch.tpch.queries import QUERIES as TPCH
from presto1_tpu_torch.types import BIGINT, BOOLEAN

torch.set_num_threads(1)


# ------------------------------------------------ the reference join search


def _ref_estimate(node, catalog, memo=None):
    return derive(node, catalog, memo).rows


def _ref_unique_keysets(node, catalog):
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
        return _ref_unique_keysets(node.children[0], catalog)
    if isinstance(node, L.Project):
        child = _ref_unique_keysets(node.child, catalog)
        passthrough = {s for s, e in node.outputs
                       if isinstance(e, ir.ColumnRef)}
        return {k for k in child if k <= passthrough}
    if isinstance(node, L.Aggregate):
        return {frozenset(node.group)} if node.group else set()
    if isinstance(node, L.Join):
        if node.kind in ("semi", "anti"):
            return _ref_unique_keysets(node.left, catalog)
        if node.kind in ("inner", "left") and node.build_unique:
            return _ref_unique_keysets(node.left, catalog)
        return set()
    return set()


def _ref_edges_between(edges, sa, sb):
    eq = []
    for a, b in edges:
        ra, rb = ir.referenced_columns(a), ir.referenced_columns(b)
        if ra <= sa and rb <= sb:
            eq.append((a, b))
        elif rb <= sa and ra <= sb:
            eq.append((b, a))
    return eq


def _ref_reorder(node, catalog):
    if isinstance(node, L.Join) and node.kind in ("inner", "cross"):
        rels, edges, residuals = [], [], []
        opt._flatten_inner(node, rels, edges, residuals)
        if len(rels) > 2:
            rels = [_ref_reorder(r, catalog) for r in rels]
            if len(rels) <= opt.DP_JOIN_MAX:
                tree = _ref_dp_join(rels, edges, catalog)
            else:
                tree = _ref_greedy_join(rels, edges, catalog)
            tree = _ref_orient_tree(tree, catalog)
            return opt._wrap(tree, residuals)
    return _ref_orient(node.with_children(
        [_ref_reorder(c, catalog) for c in node.children]), catalog)


def _ref_dp_join(rels, edges, catalog):
    n = len(rels)
    memo, keep_alive = {}, []
    schemas = [set(r.schema) for r in rels]
    best = {}
    for i, r in enumerate(rels):
        best[1 << i] = (0.0, _ref_estimate(r, catalog, memo), r, schemas[i])
    full = (1 << n) - 1
    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0 or mask in best:
            continue
        chosen = None
        low = mask & -mask
        sub = (mask - 1) & mask
        while sub:
            s1, s2 = sub, mask ^ sub
            if (s1 & low) and s1 in best and s2 in best:
                c1, r1, t1, sch1 = best[s1]
                c2, r2, t2, sch2 = best[s2]
                eq = _ref_edges_between(edges, sch1, sch2)
                kind = "inner" if eq else "cross"
                cand = L.Join(t1, t2, kind, eq, None)
                keep_alive.append(cand)
                rows = _ref_estimate(cand, catalog, memo)
                cost = c1 + c2 + rows
                if not eq:
                    cost += rows * 1e6
                if chosen is None or cost < chosen[0]:
                    chosen = (cost, rows, cand, sch1 | sch2)
            sub = (sub - 1) & mask
        best[mask] = chosen
    return best[full][2]


def _ref_greedy_join(rels, edges, catalog):
    comps = [(r, set(r.schema)) for r in rels]
    memo, keep_alive = {}, []
    while len(comps) > 1:
        best = None
        for i in range(len(comps)):
            for j in range(i + 1, len(comps)):
                eq = _ref_edges_between(edges, comps[i][1], comps[j][1])
                kind = "inner" if eq else "cross"
                cand = L.Join(comps[i][0], comps[j][0], kind, eq, None)
                keep_alive.append(cand)
                score = (0 if eq else 1, _ref_estimate(cand, catalog, memo))
                if best is None or score < best[0]:
                    best = (score, i, j, eq)
        _, i, j, eq = best
        tree = L.Join(comps[i][0], comps[j][0], "inner" if eq else "cross",
                      eq, None)
        schema = comps[i][1] | comps[j][1]
        comps = [c for k, c in enumerate(comps) if k not in (i, j)]
        comps.append((tree, schema))
    return comps[0][0]


def _ref_orient_tree(node, catalog):
    if isinstance(node, L.Join):
        node = L.Join(_ref_orient_tree(node.left, catalog),
                      _ref_orient_tree(node.right, catalog),
                      node.kind, node.equis, node.residual, node.build_unique)
        return _ref_orient(node, catalog)
    return node


def _ref_orient(node, catalog):
    if not isinstance(node, L.Join):
        return node
    j = node

    def unique_as_build(side):
        uniq = _ref_unique_keysets(side, catalog)
        syms = frozenset(
            (b if side is j.right else a).name for a, b in j.equis
            if isinstance((b if side is j.right else a), ir.ColumnRef))
        return any(k <= syms for k in uniq)

    if j.kind == "inner" and j.equis:
        le, re = _ref_estimate(j.left, catalog), _ref_estimate(j.right,
                                                                catalog)
        u_right, u_left = unique_as_build(j.right), unique_as_build(j.left)
        cost_keep = re + (le if u_right else 2 * le + re)
        cost_flip = le + (re if u_left else 2 * re + le)
        if cost_flip < cost_keep:
            j = L.Join(j.right, j.left, "inner",
                       [(b, a) for a, b in j.equis], j.residual,
                       j.build_unique)
    if j.kind in ("inner", "left", "semi", "anti") and j.equis:
        uniq = _ref_unique_keysets(j.right, catalog)
        build_syms = frozenset(
            b.name for _, b in j.equis if isinstance(b, ir.ColumnRef))
        unique = any(k <= build_syms for k in uniq)
        j = L.Join(j.left, j.right, j.kind, j.equis, j.residual,
                   j.build_unique or unique)
    return j


def _both(plan, catalog, monkeypatch):
    """(the port's optimized plan, the reference's) as serde JSON."""
    mine = plan_to_json(opt.optimize(plan, catalog))
    with monkeypatch.context() as m:
        m.setattr(opt, "_reorder",
                  lambda node, stats: _ref_reorder(node, stats.catalog))
        ref = plan_to_json(opt.optimize(plan, catalog))
    return mine, ref


# ------------------------------------------------------ the plans compared

_CATALOGS = {}


def _catalog(suite, sf):
    key = (suite, sf)
    if key not in _CATALOGS:
        _CATALOGS[key] = (TpchCatalog(sf=sf, device="cpu") if suite == "tpch"
                          else TpcdsCatalog(sf=sf, device="cpu"))
    return _CATALOGS[key]


class _Table:
    def __init__(self, rows, stats, unique_keys):
        self.num_rows = rows
        self._stats = stats
        self.unique_keys = unique_keys

    def column_stats(self, column):
        return self._stats.get(column)


class _Catalog:
    def __init__(self, tables):
        self.tables = tables

    def table(self, name):
        return self.tables[name]


# graph shapes: the edges among n relations
SHAPES = {
    "chain": lambda n: [(i, i + 1) for i in range(n - 1)],
    "star": lambda n: [(0, i) for i in range(1, n)],
    "clique": lambda n: [(i, j) for i in range(n) for j in range(i + 1, n)],
    # two chains with no edge between them: the search must cross them
    "two": lambda n: [(i, i + 1) for i in range(n // 2 - 1)]
    + [(i, i + 1) for i in range(n // 2, n - 1)],
}


def _random_graph(shape, n, seed, ties):
    """A join of n scans in a random order, joined along ``shape``'s edges
    (a cross join where none reaches the tree), some scans filtered, over
    a catalog of synthetic row counts, NDVs and primary keys.  ``ties``
    draws from so few values that many candidates cost the same."""
    rng = random.Random(seed)
    edges = SHAPES[shape](n)
    tables, scans = {}, []
    for i in range(n):
        cols = [f"k{j}" for j in range(n)] + ["v"]
        rows = rng.choice([100, 100, 1000] if ties
                          else [5, 20, 100, 1000, 5000, 60000])
        stats, keys = {}, []
        for c in cols:
            if ties:
                ndv = rng.choice([10, 100])
            else:
                ndv = rng.choice([1, 3, 10, 25, rows // 2 or 1, rows])
            stats[c] = ColStats(ndv=float(ndv), lo=0.0, hi=float(rows))
            if ndv == rows and rng.random() < 0.5:
                keys.append((c,))
        tables[f"t{i}"] = _Table(rows, stats, keys)
        symbols = {c: f"t{i}_{c}" for c in cols}
        node = L.Scan(f"t{i}", symbols, {s: BIGINT for s in symbols.values()})
        if rng.random() < 0.4:
            node = L.Filter(node, ir.call(
                "<", ir.ColumnRef(f"t{i}_v", BIGINT),
                ir.Literal(rng.choice([10, 50, 400]), BIGINT), type=BOOLEAN))
        scans.append(node)
    order = list(range(n))
    rng.shuffle(order)
    tree, joined = scans[order[0]], {order[0]}
    for i in order[1:]:
        eq = [(ir.ColumnRef(f"t{a}_k{b}", BIGINT),
               ir.ColumnRef(f"t{b}_k{a}", BIGINT))
              for a, b in edges if a in joined and b == i]
        eq += [(ir.ColumnRef(f"t{b}_k{a}", BIGINT),
                ir.ColumnRef(f"t{a}_k{b}", BIGINT))
               for a, b in edges if b in joined and a == i]
        tree = L.Join(tree, scans[i], "inner" if eq else "cross", eq, None)
        joined.add(i)
    names = [(f"v{i}", f"t{i}_v") for i in range(n)]
    return L.Output(tree, names), _Catalog(tables)


CASES = (
    [f"tpch-sf{sf}-q{q}" for sf in ("0.01", "1") for q in sorted(TPCH)]
    + [f"tpcds-sf{sf}-q{q}" for sf in ("0.01", "1") for q in sorted(TPCDS)]
    + [f"random-{shape}-{n}-{seed}{'-ties' if ties else ''}"
       for shape in SHAPES for n, seed in ((3, 1), (4, 2), (5, 3), (6, 4),
                                           (7, 5), (8, 6))
       for ties in (False, True)]
    # wider than DP_JOIN_MAX: the greedy search
    + [f"random-{shape}-{n}-{seed}" for shape, n, seed in
       (("chain", 9, 7), ("clique", 10, 8), ("two", 10, 9))]
)


def _case(case):
    kind, *rest = case.split("-")
    if kind in ("tpch", "tpcds"):
        sf, q = float(rest[0][2:]), int(rest[1][1:])
        catalog = _catalog(kind, sf)
        sql = (TPCH if kind == "tpch" else TPCDS)[q]
        return Planner(catalog).plan(parser.parse(sql)), catalog
    shape, n, seed = rest[0], int(rest[1]), int(rest[2])
    return _random_graph(shape, n, seed, ties=len(rest) == 4)


@pytest.mark.parametrize("case", CASES)
def test_plans_equal_the_reference(case, monkeypatch):
    plan, catalog = _case(case)
    mine, ref = _both(plan, catalog, monkeypatch)
    assert mine == ref


# ------------------------------------------------- statistics of a statement


class _Counting:
    """A catalog that counts the statistics read from it and keeps the
    row counts it gave."""

    def __init__(self, catalog):
        self.catalog = catalog
        self.reads = collections.Counter()
        self.rows_given = []

    def table(self, name):
        return _CountingTable(self.catalog.table(name), self)

    def __contains__(self, name):
        return name in self.catalog

    def __getattr__(self, name):
        return getattr(self.catalog, name)


class _CountingTable:
    def __init__(self, table, owner):
        self._table, self._owner = table, owner

    @property
    def num_rows(self):
        self._owner.reads[self._table.name] += 1
        n = self._table.num_rows
        self._owner.rows_given.append((self._table.name, n))
        return n

    def column_stats(self, column):
        self._owner.reads[(self._table.name, column)] += 1
        return self._table.column_stats(column)

    def __getattr__(self, name):
        return getattr(self._table, name)


def _optimize(sql, catalog, detail=None):
    return opt.optimize(Planner(catalog).plan(parser.parse(sql)), catalog,
                        detail)


@pytest.mark.parametrize("q", [3, 7])
def test_each_statistic_read_once_a_statement(q):
    counting = _Counting(_catalog("tpch", 0.01))
    _optimize(TPCH[q], counting)
    assert counting.reads, "nothing read"
    assert max(counting.reads.values()) == 1, counting.reads
    # every table the statement joins had its row count read
    assert {"lineitem", "orders", "customer"} <= set(counting.reads)


def test_a_write_is_seen_by_the_next_statement():
    engine = Engine(TpchCatalog(sf=0.01, device="cpu"), device="cpu")
    engine.execute_statement("create table t (k bigint)")
    engine.execute_statement("insert into t values (1), (2)")
    sql = "select count(*) from t, nation, region " \
          "where k = n_nationkey and n_regionkey = r_regionkey"
    counting = _Counting(engine.catalog)
    _optimize(sql, counting)
    assert [n for t, n in counting.rows_given if t == "t"] == [2]
    engine.execute_statement("insert into t values (3), (4), (5)")
    counting = _Counting(engine.catalog)
    _optimize(sql, counting)
    assert [n for t, n in counting.rows_given if t == "t"] == [5]


def _scanned(plan):
    """(table, column) pairs and tables the plan's scans name."""
    pairs, stack = set(), [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, L.Scan):
            pairs |= {(node.table, c) for c in node.symbols}
        stack.extend(node.children)
    return pairs, {t for t, _ in pairs}


def test_optimize_span_counts_the_search():
    catalog = _catalog("tpch", 0.01)
    session = Session()
    session.set("compile_queries", False)
    engine = Engine(catalog, session=session, device="cpu", trace=True)
    out = engine.sql(TPCH[7])
    spans = [s for s in out.trace.spans if s[0] == "optimize"]
    assert len(spans) == 1
    detail = spans[0][4]
    pairs, tables = _scanned(Planner(catalog).plan(parser.parse(TPCH[7])))
    assert detail["relations"] == 6
    assert 0 < detail["costed"] < detail["splits"]
    assert 0 < detail["stats_reads"] <= len(pairs) + len(tables)
    # what a direct call counts is what the span carried
    direct = {}
    _optimize(TPCH[7], catalog, direct)
    assert direct == detail
    # with tracing off the statement keeps no trace
    engine.trace = False
    assert engine.sql(TPCH[7]).trace is None
