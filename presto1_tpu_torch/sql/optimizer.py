"""Logical-plan optimizer.

A small, deterministic pass pipeline standing in for the reference's
179-rule IterativeOptimizer + visitor passes (``sql/planner/iterative/``,
``optimizations/PredicatePushDown``, ``iterative/rule/ReorderJoins``):

1. equi-extraction   — pull `a = b` cross-side conjuncts out of join
                       conditions into explicit equi key pairs
2. predicate pushdown — move filters to the lowest node that can evaluate
                       them (through projections by inlining)
3. join reordering   — flatten inner/cross clusters and greedily rebuild
                       smallest-cardinality-first along equi edges
                       (DetermineJoinDistributionType/ReorderJoins analog,
                       driven by catalog row counts)
4. distinct-agg rewrite — count(distinct x) → two-level aggregation
5. column pruning    — scans materialise only referenced columns
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from ..expr import ir
from .logical import (
    AggCall, Aggregate, Filter, Join, Limit, LogicalNode, Output, Project,
    Scan, Sort, Union, WindowNode,
)
from .planner import ir_conjoin
from .stats import StatementStats, unique_keysets


def optimize(plan: LogicalNode, catalog,
             detail: Optional[dict] = None) -> LogicalNode:
    """The optimized plan.  Its passes read the catalog's statistics
    through one ``StatementStats``, made here and dropped on return;
    ``detail``, where given (the ``optimize`` span's, with tracing on),
    receives its counts."""
    plan = _extract_equis(plan)
    plan = _pushdown(plan, [])
    stats = StatementStats(catalog, plan)
    plan = _reorder(plan, stats)
    plan = _rewrite_approx_distinct(plan)
    plan = _rewrite_distinct(plan)
    plan = _reduce_group_keys(plan, stats)
    from .matching import CLEANUP_RULES, apply_rules

    plan = apply_rules(plan, CLEANUP_RULES)
    plan = _prune(plan, set(_needed_at_top(plan)))
    if detail is not None:
        detail.update(stats.detail())
    return plan


def _needed_at_top(plan):
    if isinstance(plan, Output):
        return [s for _, s in plan.names]
    return list(plan.schema.keys())


# ------------------------------------------------------------ equi extract


def _refs(e: ir.Expr) -> Set[str]:
    return ir.referenced_columns(e)


def _split_ir_conjuncts(e: Optional[ir.Expr]) -> List[ir.Expr]:
    if e is None:
        return []
    if isinstance(e, ir.Call) and e.fn == "and":
        return _split_ir_conjuncts(e.args[0]) + _split_ir_conjuncts(e.args[1])
    return [e]


def _extract_equis(node: LogicalNode) -> LogicalNode:
    node = node.with_children([_extract_equis(c) for c in node.children])
    if not isinstance(node, Join) or node.residual is None:
        return node
    ls, rs = node.left.schema, node.right.schema
    equis = list(node.equis)
    keep: List[ir.Expr] = []
    right_only: List[ir.Expr] = []
    for c in _split_ir_conjuncts(node.residual):
        r = _refs(c)
        if (isinstance(c, ir.Call) and c.fn == "=" and len(c.args) == 2
                and not (r <= set(ls)) and not (r <= set(rs))):
            a, b = c.args
            ra, rb = _refs(a), _refs(b)
            if ra <= set(ls) and rb <= set(rs):
                equis.append((a, b))
                continue
            if rb <= set(ls) and ra <= set(rs):
                equis.append((b, a))
                continue
        if r <= set(rs) and node.kind != "full":
            right_only.append(c)
            continue
        if r <= set(ls) and node.kind in ("inner", "cross"):
            keep.append(c)  # handled by pushdown later
            continue
        keep.append(c)
    right = node.right
    if right_only:
        right = Filter(right, ir_conjoin(right_only))
    kind = "inner" if node.kind == "cross" and equis else node.kind
    return Join(node.left, right, kind, equis, ir_conjoin(keep),
                node.build_unique)


# ---------------------------------------------------------------- pushdown


def _subst(e: ir.Expr, mapping: Dict[str, ir.Expr]) -> ir.Expr:
    if isinstance(e, ir.ColumnRef):
        return mapping.get(e.name, e)
    if isinstance(e, ir.Call):
        return ir.Call(e.fn, tuple(_subst(a, mapping) for a in e.args), e.type)
    if isinstance(e, ir.DictLookup):
        inner = mapping.get(e.column.name, e.column)
        assert isinstance(inner, ir.ColumnRef)
        return ir.DictLookup(inner, e.table, e.type, e.label, e.dictionary)
    return e


def _flatten_or(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Call) and e.fn == "or":
        return _flatten_or(e.args[0]) + _flatten_or(e.args[1])
    return [e]


def _hoist(c: ir.Expr) -> List[ir.Expr]:
    """(a∧x) ∨ (a∧y) → a ∧ (x∨y): lets the shared equi conjunct become a
    join key (Q19's OR-of-blocks shape; the reference gets this from
    ExtractCommonPredicatesExpressionRewrite)."""
    branches = _flatten_or(c)
    if len(branches) < 2:
        return [c]
    sets = [_split_ir_conjuncts(b) for b in branches]
    common = set(sets[0])
    for s in sets[1:]:
        common &= set(s)
    if not common:
        return [c]
    rests = [[x for x in s if x not in common] for s in sets]
    out = list(common)
    if all(rests):
        ors = None
        for r in rests:
            conj = ir_conjoin(r)
            ors = conj if ors is None else ir.call("or", ors, conj)
        out.append(ors)
    return out


def _pushdown(node: LogicalNode, conjuncts: List[ir.Expr]) -> LogicalNode:
    conjuncts = [h for c in conjuncts for h in _hoist(c)]
    if isinstance(node, Filter):
        return _pushdown(node.child, conjuncts + _split_ir_conjuncts(node.predicate))

    if isinstance(node, Project):
        mapping = dict(node.outputs)
        pushable, keep = [], []
        for c in conjuncts:
            if _refs(c) <= set(mapping):
                pushable.append(_subst(c, mapping))
            else:
                keep.append(c)
        child = _pushdown(node.child, pushable)
        out: LogicalNode = Project(child, node.outputs)
        return _wrap(out, keep)

    if isinstance(node, Join):
        ls, rs = set(node.left.schema), set(node.right.schema)
        to_left, to_right, keep = [], [], []
        equis = list(node.equis)
        kind = node.kind
        for c in conjuncts:
            r = _refs(c)
            if r <= ls:
                to_left.append(c)
                continue
            if r <= rs and kind in ("inner", "cross"):
                to_right.append(c)
                continue
            # cross-side equi conjunct -> join key (turns cross into inner)
            if (kind in ("inner", "cross") and isinstance(c, ir.Call)
                    and c.fn == "=" and len(c.args) == 2):
                a, b = c.args
                ra, rb = _refs(a), _refs(b)
                if ra <= ls and rb <= rs:
                    equis.append((a, b))
                    kind = "inner"
                    continue
                if rb <= ls and ra <= rs:
                    equis.append((b, a))
                    kind = "inner"
                    continue
            keep.append(c)
        left = _pushdown(node.left, to_left)
        right = _pushdown(node.right, to_right)
        out = Join(left, right, kind, equis, node.residual,
                   node.build_unique)
        return _wrap(out, keep)

    if isinstance(node, Aggregate):
        gset = set(node.group)
        pushable = [c for c in conjuncts if _refs(c) <= gset]
        keep = [c for c in conjuncts if not (_refs(c) <= gset)]
        child = _pushdown(node.child, pushable)
        return _wrap(Aggregate(child, node.group, node.aggs), keep)

    if isinstance(node, (Sort, Limit, Output)):
        child = _pushdown(node.children[0], conjuncts)
        return node.with_children([child])

    # Scan and anything else: stop here
    if isinstance(node, Scan) and conjuncts:
        # record the TupleDomain the pushed conjuncts imply so connectors
        # can prune row groups / splits (AddExchanges' pushdown of
        # TupleDomain into ConnectorTableHandle); conjuncts all stay —
        # pruning is an over-approximation, never the filter itself
        from .domain import domains_from_conjuncts

        inv = {sym: col for col, sym in node.symbols.items()}
        td = domains_from_conjuncts(conjuncts).rename(inv)
        if not td.is_all():
            prev = node.domain
            node = Scan(node.table, node.symbols, node.schema,
                        td if prev is None else prev.intersect(td))
    node = node.with_children([_pushdown(c, []) for c in node.children])
    return _wrap(node, conjuncts)


def _wrap(node: LogicalNode, conjuncts: List[ir.Expr]) -> LogicalNode:
    if conjuncts:
        return Filter(node, ir_conjoin(conjuncts))
    return node


# ---------------------------------------------------------------- reorder


#: exact (bushy, C_out-cost) join enumeration up to this many relations;
#: wider FROM lists fall back to GOO.  8 relations = 255 subsets and a
#: few thousand candidate splits.
DP_JOIN_MAX = 8


def _reorder(node: LogicalNode, stats: StatementStats) -> LogicalNode:
    if isinstance(node, Join) and node.kind in ("inner", "cross"):
        rels, edges, residuals = [], [], []
        _flatten_inner(node, rels, edges, residuals)
        stats.relations = max(stats.relations, len(rels))
        if len(rels) > 2:
            rels = [_reorder(r, stats) for r in rels]
            if len(rels) <= DP_JOIN_MAX:
                tree = _dp_join(rels, edges, stats)
            else:
                tree = _greedy_join(rels, edges, stats)
            tree = _orient_tree(tree, stats)
            return _wrap(tree, residuals)
    return _orient(node.with_children(
        [_reorder(c, stats) for c in node.children]), stats)


class _Edges:
    """A join cluster's equi edges over relation bitmasks.

    Each side of an edge is held as the relations its columns lie in,
    computed once: ``need``, the relations of the columns that lie in one,
    and ``alternatives``, a mask for each column that lies in several.  A
    side's columns lie in the union of the schemas of a set of relations
    ``s`` exactly when ``s`` holds ``need`` and meets every alternative, so
    ``between(s1, s2)``, the edges joining the two sets in edge order and
    oriented ``s1`` side first, is a few mask tests an edge."""

    def __init__(self, rels, edges):
        owners: Dict[str, int] = {}
        for i, r in enumerate(rels):
            for sym in r.schema:
                owners[sym] = owners.get(sym, 0) | 1 << i
        self.edges = []
        for a, b in edges:
            sa, sb = _side(_refs(a), owners), _side(_refs(b), owners)
            if sa is not None and sb is not None:  # else it joins no sets
                self.edges.append((a, b) + sa + sb)

    def between(self, s1: int, s2: int) -> List[Tuple[ir.Expr, ir.Expr]]:
        eq = []
        for a, b, na, xa, nb, xb in self.edges:
            if not (na & ~s1 or nb & ~s2) and _meets(xa, s1, xb, s2):
                eq.append((a, b))
            elif not (nb & ~s1 or na & ~s2) and _meets(xb, s1, xa, s2):
                eq.append((b, a))
        return eq


def _side(cols: Set[str], owners: Dict[str, int]):
    """``(need, alternatives)`` of an edge side's columns (``_Edges``), or
    None where a column lies in no relation."""
    need, alternatives = 0, []
    for c in cols:
        m = owners.get(c, 0)
        if not m:
            return None
        if m & (m - 1):
            alternatives.append(m)
        else:
            need |= m
    return need, tuple(alternatives)


def _meets(x1, s1: int, x2, s2: int) -> bool:
    """Whether ``s1`` meets every alternative of ``x1``, and ``s2`` of
    ``x2``."""
    return not (x1 or x2) or (all(m & s1 for m in x1)
                              and all(m & s2 for m in x2))


def _dp_join(rels, edges, stats: StatementStats) -> LogicalNode:
    """Exact join enumeration over subsets (memo-lite — the bounded
    analog of the reference's Memo + ReorderJoins exploration,
    ``iterative/Memo.java:64``, ``iterative/rule/ReorderJoins.java``).

    Dynamic program over relation subsets: ``best[S]`` is the cheapest
    bushy tree joining subset ``S`` under the C_out metric (sum of
    intermediate result cardinalities — the standard exploration
    objective; build/probe orientation and physical costs are applied
    afterwards by ``_orient_tree``).  Cross joins are admitted with a
    large penalty so disconnected FROM lists still plan, but never beat
    a connected order.  The splits of ``S`` are tried in one fixed order
    and a later one wins only if it costs strictly less, so ``best[S]`` is
    the first split of least cost.

    A candidate costs ``c1 + c2 + rows`` with ``rows >= 1``, so a split
    whose children's costs ``c1 + c2`` (its ``lower``) are already at the
    best so far cannot win, nor can one whose ``lower`` exceeds the cost of
    some candidate (``bound``: the connected split of least ``lower``,
    costed first); either is passed over before any derivation.  A cross
    candidate's rows are ``max(r1 * r2, 1)``, known without one."""
    between = _Edges(rels, edges).between
    # best[mask] = (cost, rows, tree or, for a cross join, its two sides)
    best: dict = {}
    for i, r in enumerate(rels):
        best[1 << i] = (0.0, stats.rows(r), r)

    full = (1 << len(rels)) - 1
    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0:
            continue
        # proper sub-splits (lower, S1) in their fixed order; canonical:
        # S1 contains the lowest set bit so each unordered partition is
        # tried once
        low = mask & -mask
        splits = []
        sub = (mask - 1) & mask
        while sub:
            if sub & low:
                splits.append((best[sub][0] + best[mask ^ sub][0], sub))
            sub = (sub - 1) & mask
        stats.splits += len(splits)
        bound, probed = math.inf, {}
        for lower, s1 in sorted(splits):
            eq = between(s1, mask ^ s1)
            probed[s1] = _candidate(best, s1, mask ^ s1, eq, stats)
            if eq:
                bound = probed[s1][0]
                break
        chosen = None
        for lower, s1 in splits:
            if lower > bound or chosen is not None and lower >= chosen[0]:
                continue
            cand = probed.get(s1)
            if cand is None:
                cand = _candidate(best, s1, mask ^ s1, between(s1, mask ^ s1),
                                  stats)
            if chosen is None or cand[0] < chosen[0]:
                chosen = cand
        if isinstance(chosen[2], tuple):
            chosen = (chosen[0], chosen[1],
                      Join(*chosen[2], "cross", [], None))
        best[mask] = chosen
    return best[full][2]


def _candidate(best, s1: int, s2: int, eq, stats: StatementStats):
    """``(cost, rows, tree)`` of joining ``best[s1]`` to ``best[s2]`` on
    ``eq``; for a cross join (no ``eq``) the tree's two sides, its rows
    computed as its derivation would."""
    c1, r1, t1 = best[s1]
    c2, r2, t2 = best[s2]
    if eq:
        cand = Join(t1, t2, "inner", eq, None)
        stats.costed += 1
        rows = stats.rows(cand)
        return c1 + c2 + rows, rows, cand
    rows = max(r1 * r2, 1.0)
    cost = c1 + c2 + rows
    cost += rows * 1e6  # cross-join penalty
    return cost, rows, (t1, t2)


def _orient_tree(node: LogicalNode, stats: StatementStats) -> LogicalNode:
    if isinstance(node, Join):
        node = Join(_orient_tree(node.left, stats),
                    _orient_tree(node.right, stats),
                    node.kind, node.equis, node.residual, node.build_unique)
        return _orient(node, stats)
    return node


def _orient(node: LogicalNode, stats: StatementStats) -> LogicalNode:
    """Choose the build (right) side; mark unique builds.

    A provably-unique (PK) build side enables the expansion-free probe
    path — measured >10x on Q3's join fragment (BASELINE.md) — so a
    unique build wins over a merely-smaller one unless it is far larger
    (the CostComparator trade of build size vs probe fan-out)."""
    if not isinstance(node, Join):
        return node
    j = node

    def _unique_as_build(side) -> bool:
        uniq = unique_keysets(side, stats)
        syms = frozenset(
            (b if side is j.right else a).name for a, b in j.equis
            if isinstance((b if side is j.right else a), ir.ColumnRef))
        return any(k <= syms for k in uniq)

    if j.kind == "inner" and j.equis:
        le, re = stats.rows(j.left), stats.rows(j.right)
        u_right = _unique_as_build(j.right)
        u_left = _unique_as_build(j.left)
        # physical cost per orientation: build-side sort + probe work.
        # A unique (PK) build probes expansion-free (one searchsorted);
        # a non-unique build pays pair expansion + compaction on top
        # (~2x the probe volume) — the CostComparator trade measured on
        # Q3/Q12 fragments (BASELINE.md join-path findings).
        cost_keep = re + (le if u_right else 2 * le + re)
        cost_flip = le + (re if u_left else 2 * re + le)
        if cost_flip < cost_keep:
            j = Join(j.right, j.left, "inner",
                     [(b, a) for a, b in j.equis], j.residual, j.build_unique)
    if j.kind in ("inner", "left", "semi", "anti") and j.equis:
        uniq = unique_keysets(j.right, stats)
        build_syms = frozenset(
            b.name for _, b in j.equis if isinstance(b, ir.ColumnRef))
        unique = any(k <= build_syms for k in uniq)
        j = Join(j.left, j.right, j.kind, j.equis, j.residual,
                 j.build_unique or unique)
    return j


def _flatten_inner(node: LogicalNode, rels, edges, residuals):
    # cross joins flatten too: a FROM-list pair without a direct predicate
    # (Q2's part x supplier) must not act as a reorder barrier — the greedy
    # rebuild connects both through their shared fact table instead
    if isinstance(node, Join) and node.kind in ("inner", "cross"):
        if node.residual is not None:
            residuals.extend(_split_ir_conjuncts(node.residual))
        _flatten_inner(node.left, rels, edges, residuals)
        _flatten_inner(node.right, rels, edges, residuals)
        for a, b in node.equis:
            edges.append((a, b))
    else:
        rels.append(node)


def _greedy_join(rels, edges, stats: StatementStats) -> LogicalNode:
    """Greedy Operand Ordering (GOO): repeatedly merge the PAIR of
    components whose join result is smallest (connected pairs first).
    Unlike the previous single-chain greedy — which started from the
    smallest relation and could only grow through its neighbors, forcing
    q9 into nation→supplier→lineitem before any selective join — GOO
    builds bushy trees, so lineitem⋈(filtered part) fires first and the
    whole downstream pipeline shrinks.  The exploration-free core of
    ``iterative/rule/ReorderJoins.java``.  A cross pair's rows are
    ``max(r1 * r2, 1)``, known without a derivation, and it cannot win
    once a connected pair has been seen."""
    between = _Edges(rels, edges).between
    comps = [(r, 1 << i) for i, r in enumerate(rels)]
    while len(comps) > 1:
        best = None
        for i in range(len(comps)):
            for j in range(i + 1, len(comps)):
                stats.splits += 1
                eq = between(comps[i][1], comps[j][1])
                if eq:
                    cand = Join(comps[i][0], comps[j][0], "inner", eq, None)
                    stats.costed += 1
                    score = (0, stats.rows(cand))
                elif best is not None and best[0][0] == 0:
                    continue
                else:
                    score = (1, max(stats.rows(comps[i][0])
                                    * stats.rows(comps[j][0]), 1.0))
                if best is None or score < best[0]:
                    best = (score, i, j, eq)
        _, i, j, eq = best
        kind = "inner" if eq else "cross"
        tree = Join(comps[i][0], comps[j][0], kind, eq, None)
        mask = comps[i][1] | comps[j][1]
        comps = [c for k, c in enumerate(comps) if k not in (i, j)]
        comps.append((tree, mask))
    return comps[0][0]


# ------------------------------------------------ group-key FD reduction


def _fds(node: LogicalNode, catalog) -> List[Tuple[frozenset, Set[str]]]:
    """Functional dependencies (lhs symbols -> rhs symbols) provable from
    primary keys and unique-build joins."""
    if isinstance(node, Scan):
        out = []
        try:
            keys = getattr(catalog.table(node.table), "unique_keys", [])
        except Exception:
            keys = []
        for key in keys:
            if all(c in node.symbols for c in key):
                out.append((frozenset(node.symbols[c] for c in key),
                            set(node.symbols.values())))
        return out
    if isinstance(node, (Filter, Sort, Limit, Output)):
        return _fds(node.children[0], catalog)
    if isinstance(node, Project):
        fds = list(_fds(node.child, catalog))
        for s, e in node.outputs:
            if not isinstance(e, ir.ColumnRef):
                fds.append((frozenset(_refs(e)), {s}))
        return fds
    if isinstance(node, Aggregate):
        return _fds(node.child, catalog) + [(frozenset(node.group),
                                             set(node.schema.keys()))]
    if isinstance(node, Join):
        if node.kind in ("semi", "anti"):
            return _fds(node.left, catalog)
        fds = _fds(node.left, catalog) + _fds(node.right, catalog)
        if node.build_unique and node.equis:
            lhs = set()
            ok = True
            for a, _ in node.equis:
                if isinstance(a, ir.ColumnRef):
                    lhs.add(a.name)
                else:
                    ok = False
            if ok:
                fds.append((frozenset(lhs), set(node.right.schema.keys())))
        return fds
    return []


def _closure(symbols: Set[str], fds) -> Set[str]:
    out = set(symbols)
    changed = True
    while changed:
        changed = False
        for lhs, rhs in fds:
            if lhs <= out and not (rhs <= out):
                out |= rhs
                changed = True
    return out


def _reduce_group_keys(node: LogicalNode, catalog) -> LogicalNode:
    node = node.with_children(
        [_reduce_group_keys(c, catalog) for c in node.children])
    if not isinstance(node, Aggregate) or len(node.group) <= 1:
        return node
    fds = _fds(node.child, catalog)
    primary = list(node.group)
    for g in list(node.group):
        if len(primary) == 1:
            break
        rest = [p for p in primary if p != g]
        if g in _closure(set(rest), fds):
            primary = rest
    if len(primary) < len(node.group):
        return Aggregate(node.child, node.group, node.aggs, primary)
    return node


# ------------------------------------------------------- distinct rewrite


def _rewrite_approx_distinct(node: LogicalNode) -> LogicalNode:
    """approx_distinct(x) -> HyperLogLog over a two-level aggregation.

    The sketch is the canonical HLL with m = 2^11 registers: the inner
    aggregate groups by (group keys, register index) and keeps max(rho)
    — that max IS the mergeable sketch state, so every partial/final
    split and repartition path merges registers correctly with no new
    operator machinery.  The outer aggregate computes the raw estimator
    αm·m²/Σ2^-M with the linear-counting small-range correction.
    Reference: ``operator/aggregation/ApproximateCountDistinctAggregations``
    (airlift HyperLogLog, default standard error 2.3%).

    Other aggregates in the same SELECT are recombined exactly the way
    ``_rewrite_distinct`` recombines them (sum→sum, count→sum, min/max,
    avg→sum/count) — they see each (group, register) subgroup once.
    """
    node = node.with_children(
        [_rewrite_approx_distinct(c) for c in node.children])
    if not isinstance(node, Aggregate) \
            or not any(a.fn == "approx_distinct" for a in node.aggs):
        return node
    approx = [a for a in node.aggs if a.fn == "approx_distinct"]
    plain = [a for a in node.aggs
             if a.fn != "approx_distinct" and not a.distinct]
    if len(approx) > 1 or any(a.distinct for a in node.aggs):
        # several sketches (or mixed with exact distinct aggregates): the
        # register columns of independent HLLs can't share one inner
        # grouping — fall back to EXACT counts through the MarkDistinct
        # path (an exact answer satisfies the approximation contract;
        # the reference's OptimizeMixedDistinctAggregations does the same
        # collapse for the mixed case)
        from ..types import BIGINT

        aggs = [AggCall(a.symbol, "count", a.arg, True, BIGINT)
                if a.fn == "approx_distinct" else a for a in node.aggs]
        return Aggregate(node.child, node.group, aggs, node.primary)
    a = approx[0]
    from ..expr.eval import HLL_M
    from ..types import BIGINT, DOUBLE, BOOLEAN

    child = node.child
    h = ir.call("__hll_hash", a.arg, type=BIGINT)
    reg_sym = f"{a.symbol}_reg"
    passthrough = [(s, ir.ColumnRef(s, t)) for s, t in child.schema.items()]
    child = Project(child, passthrough +
                    [(reg_sym, ir.call("__hll_reg", h, type=BIGINT))])
    rho_sym = f"{a.symbol}_rho"
    inner_aggs = [AggCall(rho_sym, "max",
                          ir.call("__hll_rho", h, type=BIGINT), False,
                          BIGINT)]
    ssym, csym = f"{a.symbol}_s", f"{a.symbol}_c"

    def dref(s):
        return ir.ColumnRef(s, DOUBLE)

    def lit(v):
        return ir.Literal(float(v), DOUBLE)

    # Σ 2^-M over OCCUPIED registers, and the occupied count
    pow_term = ir.call(
        "power", lit(2.0),
        ir.call("neg", ir.call("cast", ir.ColumnRef(rho_sym, BIGINT),
                               type=DOUBLE), type=DOUBLE),
        type=DOUBLE)
    outer_aggs = [
        AggCall(ssym, "sum", pow_term, False, DOUBLE),
        AggCall(csym, "count", ir.ColumnRef(rho_sym, BIGINT), False,
                BIGINT),
    ]
    post: List[Tuple[str, ir.Expr]] = []
    inner_extra, outer_extra, plain_post = _split_plain_aggs(plain)
    inner_aggs += inner_extra
    outer_aggs += outer_extra
    post += plain_post

    inner = Aggregate(child, node.group + [reg_sym], inner_aggs)
    outer = Aggregate(inner, node.group, outer_aggs)

    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    cnt = ir.call("cast", ir.ColumnRef(csym, BIGINT), type=DOUBLE)
    v_zero = ir.call("-", lit(m), cnt, type=DOUBLE)  # empty registers
    s_tot = ir.call("+", dref(ssym), v_zero, type=DOUBLE)
    raw = ir.call("/", lit(alpha * m * m), s_tot, type=DOUBLE)
    lc = ir.call("*", lit(m),
                 ir.call("ln", ir.call("/", lit(m), v_zero, type=DOUBLE),
                         type=DOUBLE), type=DOUBLE)
    small = ir.call("and",
                    ir.call("<=", raw, lit(2.5 * m), type=BOOLEAN),
                    ir.call(">", v_zero, lit(0.0), type=BOOLEAN),
                    type=BOOLEAN)
    est = ir.call("case", small, lc, raw, type=DOUBLE)
    est = ir.call("cast", ir.call("round", est, type=DOUBLE), type=BIGINT)

    outs = [(g, ir.ColumnRef(g, outer.schema[g])) for g in node.group]
    outs.append((a.symbol, est))
    outs.extend(post)
    return Project(outer, outs)


def _split_plain_aggs(plain):
    """Partial/final/post decomposition of plain aggregates riding along a
    two-level rewrite (shared by approx_distinct; mirrors the inline logic
    of ``_rewrite_distinct``)."""
    from ..types import BIGINT, DOUBLE

    inner_aggs, outer_aggs, post = [], [], []
    for p in plain:
        if p.fn in ("min", "max", "sum"):
            inner_aggs.append(AggCall(p.symbol, p.fn, p.arg, False, p.type))
            outer_aggs.append(AggCall(
                p.symbol, p.fn, ir.ColumnRef(p.symbol, p.type), False,
                p.type))
            post.append((p.symbol, ir.ColumnRef(p.symbol, p.type)))
        elif p.fn in ("count", "count_star"):
            psym = f"{p.symbol}_p"
            inner_aggs.append(AggCall(psym, p.fn, p.arg, False, BIGINT))
            outer_aggs.append(AggCall(
                p.symbol, "sum", ir.ColumnRef(psym, BIGINT), False, BIGINT))
            post.append((p.symbol, ir.ColumnRef(p.symbol, BIGINT)))
        elif p.fn == "avg":
            t = p.arg.type
            if t.kind == "decimal":
                from ..types import DecimalType
                st = DecimalType(38, t.scale) if t.scale <= 4 else DOUBLE
            elif t.kind == "integer":
                st = BIGINT
            else:
                st = t
            ssym, csym = f"{p.symbol}_s", f"{p.symbol}_c"
            inner_aggs.append(AggCall(ssym, "sum", p.arg, False, st))
            inner_aggs.append(AggCall(csym, "count", p.arg, False, BIGINT))
            outer_aggs.append(AggCall(
                ssym, "sum", ir.ColumnRef(ssym, st), False, st))
            outer_aggs.append(AggCall(
                csym, "sum", ir.ColumnRef(csym, BIGINT), False, BIGINT))
            num = ir.call("cast", ir.ColumnRef(ssym, st), type=DOUBLE)
            den = ir.call("cast", ir.ColumnRef(csym, BIGINT), type=DOUBLE)
            post.append((p.symbol, ir.call("/", num, den, type=DOUBLE)))
        else:
            raise NotImplementedError(
                f"{p.fn} mixed with approx_distinct")
    return inner_aggs, outer_aggs, post


def _rewrite_distinct(node: LogicalNode) -> LogicalNode:
    """count(DISTINCT x) [+ other aggregates] -> two-level aggregation.

    The inner aggregate groups by (group keys, x), deduplicating x per
    group; the distinct count is then a plain count in the outer
    aggregate.  Non-distinct aggregates ride along as partials computed
    per (group, x) subgroup and recombined in the outer level (sum->sum,
    count->sum, min/max->min/max, avg->sum/count + a division projection)
    — the single-pass analog of the reference's MarkDistinct plan
    (``sql/planner/plan/MarkDistinctNode.java``) that stays NULL-group
    safe with no self-join.
    """
    node = node.with_children([_rewrite_distinct(c) for c in node.children])
    if not isinstance(node, Aggregate) or not any(a.distinct for a in node.aggs):
        return node
    dist = [a for a in node.aggs if a.distinct]
    plain = [a for a in node.aggs if not a.distinct]
    if len(dist) > 1 or any(a.fn != "count" for a in dist):
        # multiple distinct aggregates (or sum/avg/... DISTINCT): the
        # MarkDistinct rewrite — one first-occurrence marker per distinct
        # argument set, each distinct aggregate consumes only marked rows
        # (``iterative/rule/MultipleDistinctAggregationToMarkDistinct``)
        return _rewrite_markdistinct(node)
    a = dist[0]
    child = node.child
    extra: List[Tuple[str, ir.Expr]] = []
    if isinstance(a.arg, ir.ColumnRef):
        arg_sym = a.arg.name
    else:
        arg_sym = f"{a.symbol}_arg"
        extra.append((arg_sym, a.arg))
    # partial (inner) aggregates for the non-distinct calls
    from ..types import BIGINT, DOUBLE

    inner_aggs: List[AggCall] = []
    outer_aggs: List[AggCall] = [None]  # placeholder for the distinct count
    post: List[Tuple[str, ir.Expr]] = []  # avg divisions (if any)
    need_post = False
    for i, p in enumerate(plain):
        if p.fn in ("min", "max", "sum"):
            inner_aggs.append(AggCall(p.symbol, p.fn, p.arg, False, p.type))
            outer_aggs.append(AggCall(
                p.symbol, p.fn, ir.ColumnRef(p.symbol, p.type), False,
                p.type))
            post.append((p.symbol, ir.ColumnRef(p.symbol, p.type)))
        elif p.fn in ("count", "count_star"):
            psym = f"{p.symbol}_p"
            inner_aggs.append(AggCall(psym, p.fn, p.arg, False, BIGINT))
            outer_aggs.append(AggCall(
                p.symbol, "sum", ir.ColumnRef(psym, BIGINT), False, BIGINT))
            post.append((p.symbol, ir.ColumnRef(p.symbol, BIGINT)))
        elif p.fn == "avg":
            t = p.arg.type
            if t.kind == "decimal":
                from ..types import DecimalType
                st = DecimalType(38, t.scale) if t.scale <= 4 else DOUBLE
            elif t.kind == "integer":
                st = BIGINT
            else:
                st = t
            ssym, csym = f"{p.symbol}_s", f"{p.symbol}_c"
            inner_aggs.append(AggCall(ssym, "sum", p.arg, False, st))
            inner_aggs.append(AggCall(csym, "count", p.arg, False, BIGINT))
            outer_aggs.append(AggCall(
                ssym, "sum", ir.ColumnRef(ssym, st), False, st))
            outer_aggs.append(AggCall(
                csym, "sum", ir.ColumnRef(csym, BIGINT), False, BIGINT))
            num = ir.call("cast", ir.ColumnRef(ssym, st), type=DOUBLE)
            den = ir.call("cast", ir.ColumnRef(csym, BIGINT), type=DOUBLE)
            post.append((p.symbol, ir.call("/", num, den, type=DOUBLE)))
            need_post = True
        else:
            raise NotImplementedError(
                f"{p.fn} mixed with a distinct aggregate")
    if extra:
        passthrough = [(s, ir.ColumnRef(s, t))
                       for s, t in child.schema.items()]
        child = Project(child, passthrough + extra)
    inner = Aggregate(child, node.group + [arg_sym], inner_aggs)
    arg_t = inner.schema[arg_sym]
    outer_aggs[0] = AggCall(a.symbol, "count",
                            ir.ColumnRef(arg_sym, arg_t), False, a.type)
    outer = Aggregate(inner, node.group, outer_aggs)
    if not need_post:
        return outer
    outs = [(g, ir.ColumnRef(g, outer.schema[g])) for g in node.group]
    outs.append((a.symbol, ir.ColumnRef(a.symbol, a.type)))
    outs.extend(post)
    return Project(outer, outs)


def _rewrite_markdistinct(node: Aggregate) -> LogicalNode:
    """N distinct aggregates → MarkDistinct(child) + masked plain aggs.

    Each distinct argument set gets a boolean first-occurrence marker per
    group; ``fn(DISTINCT x)`` becomes ``fn(__mask(x, marker))`` — the mask
    nullifies duplicates, and every aggregate skips NULL inputs, so all
    aggregates (distinct and plain, any mix) run in ONE grouping pass.
    NULL-group safe: markers are computed per (group, value) combo with
    NULL as an ordinary key code.  Reference:
    ``operator/MarkDistinctOperator.java``,
    ``MultipleDistinctAggregationToMarkDistinct.java``."""
    from ..types import BOOLEAN
    from .logical import MarkDistinct

    markers: Dict[str, str] = {}  # arg fingerprint -> marker symbol
    marker_defs: List[Tuple[str, List[ir.Expr]]] = []
    new_aggs: List[AggCall] = []
    for a in node.aggs:
        if not a.distinct:
            new_aggs.append(a)
            continue
        key = repr(a.arg)
        if key not in markers:
            msym = f"__mark{len(markers)}"
            markers[key] = msym
            marker_defs.append((msym, [a.arg]))
        masked = ir.call("__mask", a.arg,
                         ir.ColumnRef(markers[key], BOOLEAN),
                         type=a.arg.type)
        new_aggs.append(AggCall(a.symbol, a.fn, masked, False, a.type,
                                param=a.param))
    md = MarkDistinct(node.child, list(node.group), marker_defs)
    return Aggregate(md, node.group, new_aggs, node.primary)


# ---------------------------------------------------------------- pruning


def _prune(node: LogicalNode, needed: Set[str]) -> LogicalNode:
    if isinstance(node, Output):
        return Output(_prune(node.child, {s for _, s in node.names}), node.names)
    if isinstance(node, Scan):
        symbols = {c: s for c, s in node.symbols.items() if s in needed}
        if not symbols:  # keep one column for row count
            c, s = next(iter(node.symbols.items()))
            symbols = {c: s}
        schema = {s: node.schema[s] for s in symbols.values()}
        return Scan(node.table, symbols, schema, node.domain)
    if isinstance(node, Filter):
        return Filter(_prune(node.child, needed | _refs(node.predicate)),
                      node.predicate)
    if isinstance(node, Project):
        outputs = [(s, e) for s, e in node.outputs if s in needed]
        if not outputs:
            outputs = node.outputs[:1]
        child_needed = set()
        for _, e in outputs:
            child_needed |= _refs(e)
        return Project(_prune(node.child, child_needed), outputs)
    if isinstance(node, Aggregate):
        aggs = [a for a in node.aggs if a.symbol in needed] or node.aggs[:1] \
            if node.aggs else []
        child_needed = set(node.group)
        for a in aggs:
            if a.arg is not None:
                child_needed |= _refs(a.arg)
        return Aggregate(_prune(node.child, child_needed), node.group, aggs,
                         node.primary)
    if isinstance(node, Join):
        child_needed = set(needed)
        for a, b in node.equis:
            child_needed |= _refs(a) | _refs(b)
        if node.residual is not None:
            child_needed |= _refs(node.residual)
        left = _prune(node.left, child_needed & set(node.left.schema)
                      | {s for s in child_needed if s in node.left.schema})
        right = _prune(node.right, {s for s in child_needed
                                    if s in node.right.schema})
        return Join(left, right, node.kind, node.equis, node.residual,
                    node.build_unique)
    if isinstance(node, Sort):
        child_needed = set(needed)
        for e, _, _ in node.keys:
            child_needed |= _refs(e)
        return Sort(_prune(node.child, child_needed), node.keys,
                    node.limit, node.offset)
    if isinstance(node, Union):
        keep = [o for o in node.outputs if o[0] in needed] or node.outputs[:1]
        new_inputs = []
        for i, child in enumerate(node.inputs):
            cn = {srcs[i] for _, _, srcs in keep}
            new_inputs.append(_prune(child, cn))
        return Union(new_inputs, keep)
    if isinstance(node, WindowNode):
        child_needed = set(needed) - {c.symbol for c in node.calls}
        for e in node.partition_by:
            child_needed |= _refs(e)
        for e, _, _ in node.order_by:
            child_needed |= _refs(e)
        for c in node.calls:
            for arg in (c.arg, c.default):
                if arg is not None:
                    child_needed |= _refs(arg)
        return WindowNode(_prune(node.child, child_needed),
                          node.partition_by, node.order_by, node.calls)
    if isinstance(node, Limit):
        return Limit(_prune(node.child, needed), node.n, node.offset)
    from .logical import MarkDistinct

    if isinstance(node, MarkDistinct):
        child_needed = (needed - {m for m, _ in node.markers}) \
            | set(node.group)
        for _, keys in node.markers:
            for e in keys:
                child_needed |= _refs(e)
        return MarkDistinct(_prune(node.child, child_needed), node.group,
                            node.markers)
    from .logical import Unnest

    if isinstance(node, Unnest):
        # the array expression's columns are needed below the expansion
        # even when nothing above reads them (the JAX package prunes them
        # away: ROADMAP C11)
        child_needed = (needed - {node.symbol, node.value_symbol}) \
            | _refs(node.array)
        return node.with_children([_prune(node.child, child_needed)])
    return node.with_children([_prune(c, needed) for c in node.children])
