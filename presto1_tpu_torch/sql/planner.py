"""AST → logical plan: scoping, typing, aggregate extraction, and subquery
decorrelation.

Covers the reference's Analyzer + RelationPlanner/QueryPlanner
(``sql/analyzer/StatementAnalyzer.java``, ``sql/planner/QueryPlanner.java``)
in one pass: identifiers resolve through a scope chain (outer scopes mark
correlation), EXISTS/IN subqueries become semi/anti joins, and correlated
scalar-aggregate subqueries decorrelate into grouped aggregates joined on
the correlation keys (the reference reaches the same shapes through its
``TransformCorrelated*`` iterative rules).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..expr import ir
from ..types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, DecimalType, INTEGER, SqlType, VARCHAR,
)
from . import ast
from .logical import (
    AggCall, Aggregate, Filter, Join, Limit, LogicalNode, Output, Project,
    Scan, SingleRow, Sort, Union, Unnest, WinCall, WindowNode,
)

EPOCH = np.datetime64("1970-01-01", "D")


class PlanError(Exception):
    pass


@dataclass
class FieldRef:
    qualifier: Optional[str]
    name: str
    symbol: str
    type: SqlType


class Scope:
    def __init__(self, fields: List[FieldRef], parent: Optional["Scope"] = None):
        self.fields = fields
        self.parent = parent

    def resolve(self, qualifier: Optional[str], name: str):
        """-> (FieldRef, depth) where depth>0 means an outer (correlated) ref."""
        matches = [
            f for f in self.fields
            if f.name == name and (qualifier is None or f.qualifier == qualifier)
        ]
        if len(matches) == 1:
            return matches[0], 0
        if len(matches) > 1:
            raise PlanError(f"ambiguous column {qualifier or ''}.{name}")
        if self.parent is not None:
            f, d = self.parent.resolve(qualifier, name)
            return f, d + 1
        raise PlanError(f"column not found: {(qualifier + '.') if qualifier else ''}{name}")


class _TwoLevelScope(Scope):
    """ORDER BY scope: select aliases shadow input-relation columns."""

    def __init__(self, primary: Scope, secondary: Scope,
                 parent: Optional[Scope] = None):
        super().__init__(primary.fields, parent)
        self.secondary = secondary

    def resolve(self, qualifier, name):
        try:
            f, d = Scope(self.fields).resolve(qualifier, name)
            return f, d
        except PlanError:
            pass
        try:
            return self.secondary.resolve(qualifier, name)
        except PlanError:
            if self.parent is not None:
                f, d = self.parent.resolve(qualifier, name)
                return f, d + 1
            raise


@dataclass
class RowExpr:
    """A row-typed expression bundle (planner-internal, never reaches the
    executor): the device-first decomposition of ``spi/type/RowType`` values
    into per-field expressions.  Field access selects a member; a
    row-valued select item materialises one column per field; anything
    else (arithmetic, predicates, grouping) rejects with a PlanError."""

    fields: List[Tuple[str, ir.Expr]]

    @property
    def type(self):
        from ..types import RowType

        return RowType([(n, e.type) for n, e in self.fields])

    def field(self, name: str) -> ir.Expr:
        for n, e in self.fields:
            if n == name:
                return e
        raise PlanError(f"row has no field {name!r} "
                        f"(fields: {[n for n, _ in self.fields]})")


@dataclass
class RelationPlan:
    node: LogicalNode
    scope: Scope


def split_conjuncts(e: Optional[ast.Expr]) -> List[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def ir_conjoin(parts: List[ir.Expr]) -> Optional[ir.Expr]:
    out = None
    for p in parts:
        out = p if out is None else ir.call("and", out, p)
    return out


def _days(iso: str) -> int:
    return int((np.datetime64(iso, "D") - EPOCH) / np.timedelta64(1, "D"))


def _micros(text: str) -> int:
    """TIMESTAMP literal text -> int64 micros since epoch (timestamp(6)
    storage; reference parses to a long the same way,
    ``spi/type/TimestampType.java``)."""
    t = text.strip().replace(" ", "T", 1)
    return int((np.datetime64(t, "us")
                - np.datetime64("1970-01-01T00:00:00", "us"))
               / np.timedelta64(1, "us"))


def parse_type(name: str) -> SqlType:
    from ..types import parse_type_str

    try:
        return parse_type_str(name)
    except ValueError as e:
        raise PlanError(str(e))


AGG_FNS = {"sum", "avg", "min", "max", "count"}

# aggregates rewritten into sum/count moments at plan time (reference:
# operator/aggregation/ Variance/Covariance/Corr state classes;
# decomposition reuses every execution path — compiled, spilled,
# distributed partial/final — with no new operator state)
REWRITTEN_AGGS = {
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp",
    "stddev_pop", "covar_samp", "covar_pop", "corr", "regr_slope",
    "regr_intercept", "approx_distinct", "bool_and", "bool_or", "every",
    "arbitrary", "any_value", "geometric_mean",
}
PERCENTILE_AGGS = {"approx_percentile", "median"}
AGG_FNS = AGG_FNS | REWRITTEN_AGGS | PERCENTILE_AGGS


def agg_output_type(fn: str, arg_type: Optional[SqlType]) -> SqlType:
    if fn in ("count", "count_star"):
        return BIGINT
    if fn == "avg":
        return DOUBLE
    if fn == "sum":
        if arg_type.kind == "decimal":
            s = arg_type.scale  # type: ignore[attr-defined]
            return DecimalType(38, s) if s <= 4 else DOUBLE
        if arg_type.kind == "integer":
            return BIGINT
        return arg_type
    return arg_type


class Planner:
    def __init__(self, catalog):
        self.catalog = catalog
        self._counter = 0
        # row symbol -> [(field name, field symbol, field type)] — the
        # struct-of-arrays registry behind every row-typed scope field
        self.row_bindings: Dict[str, list] = {}

    def symbol(self, base: str) -> str:
        self._counter += 1
        return f"{base}#{self._counter}"

    def _plan_windows(self, window_calls, node, scope, agg_map,
                      inner_agg_map) -> "LogicalNode":
        """Plan window calls over ``node``; results registered in agg_map.

        ``inner_agg_map`` maps aggregate ast nodes already planned (for
        windows over aggregates, e.g. sum(sum(x)) over (...)).
        """
        wconv = ExprConverter(scope, self, agg_map=inner_agg_map)
        for w in window_calls:
            part_irs = [wconv.convert(p) for p in w.partition_by]
            order_irs = [(wconv.convert(o.expr), o.ascending,
                          o.nulls_first) for o in w.order_by]
            arg_ir = None
            default_ir = None
            param = None
            fn = w.name
            frame = w.frame
            if frame is not None:
                unit, sk, sv, ek, ev = frame
                if unit in ("range", "groups") and ("p" in (sk, ek)
                                                    or "f" in (sk, ek)):
                    raise PlanError(
                        f"{unit.upper()} frames with numeric offsets are "
                        "not supported (use ROWS)")
                order_i = ["up", "p", "c", "f", "uf"]
                if order_i.index(sk) > order_i.index(ek) and not (
                        sk == ek and sk in ("p", "f")):
                    raise PlanError("window frame start after frame end")

            def const_int(e, what):
                if not isinstance(e, ast.NumberLit) \
                        or not e.text.lstrip("-").isdigit():
                    raise PlanError(
                        f"{fn}: {what} must be an integer constant")
                return int(e.text)

            if w.is_star and fn == "count":
                arg_ir = None
            elif fn == "ntile":
                param = const_int(w.args[0], "bucket count")
            elif fn in ("lag", "lead"):
                arg_ir = wconv.convert(w.args[0])
                param = (const_int(w.args[1], "offset")
                         if len(w.args) > 1 else 1)
                if len(w.args) > 2:
                    default_ir = wconv.convert(w.args[2])
                    if default_ir.type != arg_ir.type:
                        default_ir = ir.call("cast", default_ir,
                                             type=arg_ir.type)
            elif fn == "nth_value":
                arg_ir = wconv.convert(w.args[0])
                param = const_int(w.args[1], "n")
            elif w.args:
                arg_ir = wconv.convert(w.args[0])
            if fn in ("row_number", "rank", "dense_rank", "count",
                      "ntile"):
                t = BIGINT
            elif fn in ("avg", "percent_rank", "cume_dist"):
                t = DOUBLE
            elif fn == "sum":
                t = agg_output_type("sum", arg_ir.type)
            elif fn in ("min", "max", "lag", "lead", "first_value",
                        "last_value", "nth_value"):
                t = arg_ir.type
            else:
                raise PlanError(f"unsupported window function {fn}")
            sym = self.symbol(fn)
            node = WindowNode(node, part_irs, order_irs,
                              [WinCall(sym, fn, arg_ir, t, frame=frame,
                                       default=default_ir, param=param)])
            agg_map[id(w)] = ir.ColumnRef(sym, t)
        if wconv.used_outer:
            raise PlanError("correlated window expression")
        return node

    # ------------------------------------------- rewritten aggregates

    def _sum_of(self, aggcalls, expr: ir.Expr) -> ir.Expr:
        sym = self.symbol("psum")
        aggcalls.append(AggCall(sym, "sum", expr, False, DOUBLE))
        return ir.ColumnRef(sym, DOUBLE)

    def _count_of(self, aggcalls, expr: ir.Expr) -> ir.Expr:
        sym = self.symbol("pcnt")
        aggcalls.append(AggCall(sym, "count", expr, False, BIGINT))
        return ir.call("cast", ir.ColumnRef(sym, BIGINT), type=DOUBLE)

    def _grouping_symbol(self, arg: ast.Expr, conv, group_by, group_syms,
                         aliases) -> str:
        """The group symbol of the column a grouping() argument names (the
        GROUP BY expression itself, or a column it groups by); a PlanError
        naming the argument where it is no grouping column."""
        for j, g in enumerate(group_by):
            if arg == g or (isinstance(g, ast.Identifier)
                            and g.qualifier is None
                            and aliases.get(g.name) == arg):
                return group_syms[j]
        try:
            e = conv.convert(arg)
        except PlanError:
            e = None
        if isinstance(e, ir.ColumnRef) and \
                e.name in group_syms[:len(group_by)]:
            return e.name
        text = ".".join(arg.parts) if isinstance(arg, ast.Identifier) \
            else repr(arg)
        raise PlanError(f"grouping() argument {text} is not a grouping "
                        f"column")

    def _rewrite_agg(self, a: ast.FuncCall, fn: str, conv, aggcalls) -> ir.Expr:
        """Decompose statistical aggregates into sum/count moments.

        Reference: the bytecode-compiled accumulator states in
        ``operator/aggregation/`` (VarianceState, CovarianceState,
        CorrelationState, ...).  Here each becomes a closed-form expression
        over plain sums, so the dense/sorted/distributed/spilled
        aggregation paths all support them with no new operator state.
        """
        def dbl(e_ast):
            e = conv.convert(e_ast)
            return e if e.type.kind == "double" \
                else ir.call("cast", e, type=DOUBLE)

        def lit(v):
            return ir.Literal(v, DOUBLE)

        def guarded(cond, value):  # CASE WHEN cond THEN value ELSE NULL END
            return ir.call("case", cond, value, ir.Literal(None, DOUBLE),
                           type=DOUBLE)

        def mul(x, y):
            return ir.call("*", x, y, type=DOUBLE)

        def sub(x, y):
            return ir.call("-", x, y, type=DOUBLE)

        def div(x, y):
            return ir.call("/", x, y, type=DOUBLE)

        def gt(x, v):
            return ir.call(">", x, lit(v), type=BOOLEAN)

        def clamp0(x):  # fp cancellation can push moments slightly negative
            return ir.call("max2", x, lit(0.0), type=DOUBLE)

        if fn == "approx_distinct":
            # HyperLogLog sketch (reference:
            # ApproximateCountDistinctAggregations, default σ≈2.3%).  The
            # optimizer rewrites this marker into a two-level aggregation
            # over 2048 registers — max(rho) per register IS the mergeable
            # sketch, so it distributes through every partial/final and
            # repartition path with no new operator state.
            arg = conv.convert(a.args[0])
            sym = self.symbol(fn)
            aggcalls.append(AggCall(sym, "approx_distinct", arg, False,
                                    BIGINT))
            return ir.ColumnRef(sym, BIGINT)
        if fn in ("arbitrary", "any_value"):
            arg = conv.convert(a.args[0])
            sym = self.symbol(fn)
            aggcalls.append(AggCall(sym, "min", arg, False, arg.type))
            return ir.ColumnRef(sym, arg.type)
        if fn in ("bool_and", "bool_or", "every"):
            arg = ir.call("cast", conv.convert(a.args[0]), type=INTEGER)
            mfn = "max" if fn == "bool_or" else "min"
            sym = self.symbol(fn)
            aggcalls.append(AggCall(sym, mfn, arg, False, INTEGER))
            return ir.call("=", ir.ColumnRef(sym, INTEGER),
                           ir.Literal(1, INTEGER), type=BOOLEAN)
        if fn == "geometric_mean":
            x = dbl(a.args[0])
            lnx = ir.call("ln", x, type=DOUBLE)
            n = self._count_of(aggcalls, lnx)
            s = self._sum_of(aggcalls, lnx)
            return guarded(gt(n, 0.0),
                           ir.call("exp", div(s, n), type=DOUBLE))
        if fn in ("variance", "var_samp", "var_pop",
                  "stddev", "stddev_samp", "stddev_pop"):
            x = dbl(a.args[0])
            n = self._count_of(aggcalls, x)
            sx = self._sum_of(aggcalls, x)
            sxx = self._sum_of(aggcalls, mul(x, x))
            m2 = clamp0(sub(sxx, div(mul(sx, sx), n)))
            pop = fn.endswith("_pop")
            denom = n if pop else sub(n, lit(1.0))
            v = div(m2, denom)
            if fn.startswith("stddev"):
                v = ir.call("sqrt", v, type=DOUBLE)
            return guarded(gt(n, 0.0 if pop else 1.0), v)
        # two-argument moments; SQL regr_* take (dependent y, independent x)
        e0, e1 = dbl(a.args[0]), dbl(a.args[1])
        if fn in ("regr_slope", "regr_intercept"):
            y, x = e0, e1
        else:
            x, y = e0, e1
        # pairwise-null masking: x + 0*y is NULL whenever either is NULL
        xp = ir.call("+", x, mul(lit(0.0), y), type=DOUBLE)
        yp = ir.call("+", y, mul(lit(0.0), x), type=DOUBLE)
        xy = mul(x, y)
        n = self._count_of(aggcalls, xy)
        sx = self._sum_of(aggcalls, xp)
        sy = self._sum_of(aggcalls, yp)
        sxy = self._sum_of(aggcalls, xy)
        if fn == "covar_samp":
            return guarded(gt(n, 1.0),
                           div(sub(sxy, div(mul(sx, sy), n)),
                               sub(n, lit(1.0))))
        if fn == "covar_pop":
            return guarded(gt(n, 0.0),
                           div(sub(sxy, div(mul(sx, sy), n)), n))
        sxx = self._sum_of(aggcalls, mul(xp, xp))
        num = sub(mul(n, sxy), mul(sx, sy))
        dxx = clamp0(sub(mul(n, sxx), mul(sx, sx)))
        if fn == "regr_slope":
            return guarded(gt(dxx, 0.0), div(num, dxx))
        if fn == "regr_intercept":
            slope = div(num, dxx)
            return guarded(gt(dxx, 0.0),
                           div(sub(sy, mul(slope, sx)), n))
        # corr
        syy = self._sum_of(aggcalls, mul(yp, yp))
        dyy = clamp0(sub(mul(n, syy), mul(sy, sy)))
        denom = ir.call("sqrt", mul(dxx, dyy), type=DOUBLE)
        return guarded(gt(denom, 0.0), div(num, denom))

    # ------------------------------------------------------------- entry

    def plan(self, query: ast.Query) -> LogicalNode:
        from ..types import RowType

        rel = self.plan_query(query, outer=None, ctes={})
        names = []
        for f in rel.scope.fields:
            if isinstance(f.type, RowType):
                # a top-level row flattens to one column per field
                # (struct-of-arrays all the way to the client)
                for fn, fs, _ in self.row_bindings[f.symbol]:
                    names.append((f"{f.name}.{fn}", fs))
            else:
                names.append((f.name, f.symbol))
        return Output(rel.node, names)

    def plan_query(self, query: ast.Query, outer: Optional[Scope],
                   ctes: Dict[str, ast.Query],
                   corr_sink: Optional[List[ir.Expr]] = None) -> RelationPlan:
        local_ctes = dict(ctes)
        for name, q in query.ctes:
            local_ctes[name] = q
        if isinstance(query.select, ast.SetOp):
            if corr_sink is not None:
                raise PlanError("correlated set operations unsupported")
            return self.plan_setop(query.select, outer, local_ctes)
        return self.plan_select(query.select, outer, local_ctes, corr_sink)

    def plan_setop(self, op: ast.SetOp, outer, ctes) -> RelationPlan:
        def plan_side(side):
            if isinstance(side, ast.SetOp):
                return self.plan_setop(side, None, ctes)
            return self.plan_select(side, None, ctes)

        left = plan_side(op.left)
        right = plan_side(op.right)
        lf, rf = left.scope.fields, right.scope.fields
        if len(lf) != len(rf):
            raise PlanError("UNION inputs have different column counts")
        from ..types import common_supertype

        outputs = []
        for a, b in zip(lf, rf):
            t = a.type if a.type == b.type else common_supertype(a.type, b.type)
            outputs.append((self.symbol(a.name), t, [a.symbol, b.symbol]))
        fields = [FieldRef(None, a.name, s, t)
                  for a, (s, t, _) in zip(lf, outputs)]
        if op.op in ("intersect", "except"):
            # tagged-union rewrite (NULL-safe, dictionary-safe): tag each
            # side 0/1, group by all columns, keep groups by min/max of the
            # tag (INTERSECT: both sides present; EXCEPT: left only).
            # Analog of the reference's SetOperationNodeTranslator
            # (sql/planner/optimizations/TransformCorrelated.../
            #  iterative/rule/ImplementIntersectAsUnion.java).
            if op.all:
                raise PlanError(f"{op.op.upper()} ALL is not supported")
            sl, sr = self.symbol("side"), self.symbol("side")
            lproj = Project(left.node,
                            [(a.symbol, ir.ColumnRef(a.symbol, a.type))
                             for a in lf] + [(sl, ir.Literal(0, INTEGER))])
            rproj = Project(right.node,
                            [(b.symbol, ir.ColumnRef(b.symbol, b.type))
                             for b in rf] + [(sr, ir.Literal(1, INTEGER))])
            side_sym = self.symbol("side")
            u = Union([lproj, rproj],
                      outputs + [(side_sym, INTEGER, [sl, sr])])
            smin, smax = self.symbol("smin"), self.symbol("smax")
            agg = Aggregate(u, [s for s, _, _ in outputs], [
                AggCall(smin, "min", ir.ColumnRef(side_sym, INTEGER),
                        False, INTEGER),
                AggCall(smax, "max", ir.ColumnRef(side_sym, INTEGER),
                        False, INTEGER)])
            zero = ir.Literal(0, INTEGER)
            one = ir.Literal(1, INTEGER)
            if op.op == "intersect":
                pred = ir.call(
                    "and",
                    ir.call("=", ir.ColumnRef(smin, INTEGER), zero,
                            type=BOOLEAN),
                    ir.call("=", ir.ColumnRef(smax, INTEGER), one,
                            type=BOOLEAN), type=BOOLEAN)
            else:
                pred = ir.call("=", ir.ColumnRef(smax, INTEGER), zero,
                               type=BOOLEAN)
            node = Filter(agg, pred)
        else:
            node = Union([left.node, right.node], outputs)
            if not op.all:
                node = Aggregate(node, [s for s, _, _ in outputs], [])
        scope = Scope(fields, outer)
        if op.order_by:
            conv = ExprConverter(Scope(fields), self)

            def conv_key(e):
                if isinstance(e, ast.NumberLit) and e.text.isdigit():
                    k = int(e.text)
                    if not 1 <= k <= len(fields):
                        raise PlanError(
                            f"ORDER BY position {k} is not in the "
                            "select list")
                    f = fields[k - 1]
                    return ir.ColumnRef(f.symbol, f.type)
                return conv.convert(e)

            keys = [(conv_key(o.expr), o.ascending, o.nulls_first)
                    for o in op.order_by]
            node = Sort(node, keys, limit=op.limit, offset=op.offset)
        elif op.limit is not None or op.offset:
            node = Limit(node, op.limit, offset=op.offset)
        return RelationPlan(node, scope)

    # ------------------------------------------------------------- FROM

    def plan_from(self, item: Optional[ast.FromItem], outer: Optional[Scope],
                  ctes) -> RelationPlan:
        if item is None:  # FROM-less SELECT: one anonymous row
            return RelationPlan(SingleRow(), Scope([], outer))
        if isinstance(item, ast.TableRef):
            qualifier = item.alias or item.name
            if item.name in ctes:
                sub = self.plan_query(ctes[item.name], None, ctes)
                fields = [FieldRef(qualifier, f.name, f.symbol, f.type)
                          for f in sub.scope.fields]
                return RelationPlan(sub.node, Scope(fields, outer))
            if item.name not in self.catalog:
                raise PlanError(f"table not found: {item.name}")
            table = self.catalog.table(item.name)
            symbols, fields, schema = {}, [], {}
            for col, t in table.schema.items():
                s = self.symbol(col)
                symbols[col] = s
                schema[s] = t
                fields.append(FieldRef(qualifier, col, s, t))
            return RelationPlan(Scan(item.name, symbols, schema),
                                Scope(fields, outer))
        if isinstance(item, ast.SubqueryRef):
            sub = self.plan_query(item.query, None, ctes)
            fields = [FieldRef(item.alias, f.name, f.symbol, f.type)
                      for f in sub.scope.fields]
            return RelationPlan(sub.node, Scope(fields, outer))
        if isinstance(item, ast.UnnestRef):
            base = RelationPlan(SingleRow(), Scope([], outer))
            return self._plan_unnest(item, base, outer)
        if isinstance(item, ast.JoinItem):
            left = self.plan_from(item.left, outer, ctes)
            if isinstance(item.right, ast.UnnestRef):
                if item.kind != "cross":
                    raise PlanError("UNNEST joins must be CROSS JOIN")
                return self._plan_unnest(item.right, left, outer)
            right = self.plan_from(item.right, outer, ctes)
            kind = item.kind
            if kind == "right":
                left, right = right, left
                kind = "left"
            merged = Scope(left.scope.fields + right.scope.fields, outer)
            if kind == "cross":
                node = Join(left.node, right.node, "cross", [], None)
                return RelationPlan(node, merged)
            conv = ExprConverter(merged, self)
            cond = conv.convert(item.on) if item.on is not None else None
            if conv.used_outer:
                raise PlanError("correlated join condition not supported")
            node = Join(left.node, right.node, kind, [], cond)
            return RelationPlan(node, merged)
        raise PlanError(f"unsupported FROM item {item}")

    def _plan_unnest(self, item: "ast.UnnestRef", base: RelationPlan,
                     outer) -> RelationPlan:
        conv = ExprConverter(base.scope, self)
        arr = conv.convert(item.expr)
        if arr.type.kind not in ("array", "map"):
            raise PlanError("UNNEST argument must be an array or map")
        qualifier = item.alias
        if arr.type.kind == "map":
            names = item.columns or ["key", "value"]
            if len(names) != 2:
                raise PlanError("UNNEST of a map produces two columns")
            ks, vs = self.symbol(names[0]), self.symbol(names[1])
            node = Unnest(base.node, arr, ks, vs)
            fields = base.scope.fields + [
                FieldRef(qualifier, names[0], ks, arr.type.key),
                FieldRef(qualifier, names[1], vs, arr.type.value)]
        else:
            names = item.columns or ["col"]
            if len(names) != 1:
                raise PlanError("UNNEST of an array produces one column")
            s = self.symbol(names[0])
            node = Unnest(base.node, arr, s)
            fields = base.scope.fields + [
                FieldRef(qualifier, names[0], s, arr.type.element)]
        return RelationPlan(node, Scope(fields, outer))

    # ------------------------------------------------------------- SELECT

    def plan_select(self, sel: ast.Select, outer, ctes,
                    corr_sink=None) -> RelationPlan:
        # ORDER BY / GROUP BY ordinals resolve to select-list positions
        # (SQL; reference StatementAnalyzer ordinal handling)
        def _ordinal(e, what):
            if isinstance(e, ast.NumberLit) and e.text.isdigit():
                k = int(e.text)
                if not 1 <= k <= len(sel.items):
                    raise PlanError(
                        f"{what} position {k} is not in the select list")
                it = sel.items[k - 1]
                if it.expr is None:
                    raise PlanError(f"{what} position {k} references *")
                return it.expr
            return e

        if any(isinstance(o.expr, ast.NumberLit) for o in sel.order_by) or \
                any(isinstance(g, ast.NumberLit) for g in sel.group_by):
            from dataclasses import replace as _rp

            sel = _rp(sel,
                      order_by=[_rp(o, expr=_ordinal(o.expr, "ORDER BY"))
                                for o in sel.order_by],
                      group_by=[_ordinal(g, "GROUP BY")
                                for g in sel.group_by])
        rel = self.plan_from(sel.from_, outer, ctes)
        scope = rel.scope
        node = rel.node

        # WHERE (subquery conjuncts become joins; correlated equi conjuncts
        # are set aside into corr_sink for the caller to turn into a join)
        corr_conjuncts: List[ir.Expr] = []
        node = self._plan_predicate(
            split_conjuncts(sel.where), node, scope, ctes, corr_conjuncts,
            allow_correlation=corr_sink is not None)
        if corr_sink is not None:
            corr_sink.extend(corr_conjuncts)

        # window functions (evaluated over the post-WHERE relation)
        agg_map: Dict[int, ir.Expr] = {}
        window_calls: List[ast.WindowCall] = []
        for i in sel.items:
            if i.expr is not None:
                _collect_windows(i.expr, window_calls)
        for o in sel.order_by:
            _collect_windows(o.expr, window_calls)
        def _win_has_agg(w):
            tmp: List[ast.FuncCall] = []
            for x in (list(w.args) + list(w.partition_by)
                      + [o.expr for o in w.order_by]):
                _collect_aggs(x, tmp)
            return bool(tmp)

        # windows whose arguments contain aggregates (sum(sum(x)) over ...)
        # evaluate over the grouped relation and are planned after the
        # Aggregate node (SQL logical order: GROUP BY -> HAVING -> window)
        post_windows = [w for w in window_calls if _win_has_agg(w)]
        pre_windows = [w for w in window_calls if not _win_has_agg(w)]
        if pre_windows:
            node = self._plan_windows(pre_windows, node, scope, agg_map, {})

        # aggregate extraction
        agg_asts = []
        for e in ([i.expr for i in sel.items if i.expr is not None]
                  + ([sel.having] if sel.having else [])
                  + [o.expr for o in sel.order_by]):
            _collect_aggs(e, agg_asts)
        has_agg = bool(agg_asts) or bool(sel.group_by)
        grouping_calls: List[ast.FuncCall] = []
        for e in ([i.expr for i in sel.items if i.expr is not None]
                  + ([sel.having] if sel.having else [])
                  + [o.expr for o in sel.order_by]):
            _collect_grouping(e, grouping_calls)
        if grouping_calls and not sel.group_by:
            raise PlanError("grouping() needs a GROUP BY")

        select_alias_map: Dict[str, ast.Expr] = {}
        for i in sel.items:
            if i.alias and i.expr is not None:
                select_alias_map[i.alias] = i.expr

        group_ast_map: List[Tuple[ast.Expr, ir.Expr]] = []
        if has_agg:
            conv = ExprConverter(scope, self)
            group_syms: List[str] = []
            pre_extra: List[Tuple[str, ir.Expr]] = []
            group_field_map: List[FieldRef] = []
            for g in sel.group_by:
                gast = g
                if (isinstance(g, ast.Identifier) and g.qualifier is None
                        and g.name in select_alias_map):
                    gast = select_alias_map[g.name]
                    alias = g.name
                else:
                    alias = g.name if isinstance(g, ast.Identifier) else None
                gi = conv.convert(gast)
                if isinstance(gi, ir.ColumnRef):
                    sym = gi.name
                else:
                    sym = self.symbol(alias or "expr")
                    pre_extra.append((sym, gi))
                    group_ast_map.append(
                        (gast, ir.ColumnRef(sym, gi.type)))
                group_syms.append(sym)
                fr = _field_for(scope, gi, sym, alias)
                group_field_map.append(fr)

            # correlated scalar-agg decorrelation: group by the inner
            # correlation columns as well
            if corr_sink is not None and corr_conjuncts:
                for c in corr_conjuncts:
                    inner_sym = _inner_equi_symbol(c, node.schema)
                    if inner_sym and inner_sym not in group_syms:
                        group_syms.append(inner_sym)
                        t = node.schema[inner_sym]
                        group_field_map.append(
                            FieldRef(None, inner_sym, inner_sym, t))

            aggcalls: List[AggCall] = []
            for a in agg_asts:
                fn = a.name if not a.is_star else "count_star"
                if fn in REWRITTEN_AGGS:
                    agg_map[id(a)] = self._rewrite_agg(a, fn, conv, aggcalls)
                    continue
                if fn in PERCENTILE_AGGS:
                    arg_ir = conv.convert(a.args[0])
                    param = 0.5
                    if fn == "approx_percentile":
                        if len(a.args) < 2:
                            raise PlanError(
                                "approx_percentile needs a percentile")
                        pe = conv.convert(a.args[1])
                        if not isinstance(pe, ir.Literal):
                            raise PlanError(
                                "percentile must be a numeric constant")
                        if pe.type.kind == "decimal":
                            param = pe.value / (10 ** pe.type.scale)  # type: ignore[attr-defined]
                        else:
                            param = float(pe.value)
                    if not 0.0 <= param <= 1.0:
                        raise PlanError("percentile must be in [0, 1]")
                    t = arg_ir.type
                    sym = self.symbol(fn)
                    aggcalls.append(AggCall(sym, fn, arg_ir, False, t,
                                            param=param))
                    agg_map[id(a)] = ir.ColumnRef(sym, t)
                    continue
                if a.is_star:
                    arg_ir = None
                    fn = "count_star"
                else:
                    arg_ir = conv.convert(a.args[0])
                t = agg_output_type(fn, arg_ir.type if arg_ir else None)
                sym = self.symbol(fn)
                aggcalls.append(AggCall(sym, fn, arg_ir, a.distinct, t))
                agg_map[id(a)] = ir.ColumnRef(sym, t)
            if conv.used_outer:
                raise PlanError("correlated reference in aggregate arguments")

            # grouping(c1, ..., cn): the group symbol of each argument
            grouping_args = [
                [self._grouping_symbol(a, conv, sel.group_by, group_syms,
                                       select_alias_map) for a in g.args]
                for g in grouping_calls]
            if pre_extra:
                passthrough = [(s, ir.ColumnRef(s, t))
                               for s, t in node.schema.items()]
                node = Project(node, passthrough + pre_extra)
            if sel.grouping_sets is None:
                node = Aggregate(node, group_syms, aggcalls)
                # one grouping set holding every group column: all bits 0
                for g in grouping_calls:
                    agg_map[id(g)] = ir.Literal(0, BIGINT)
            else:
                # GROUPING SETS/ROLLUP/CUBE: one Aggregate per set over the
                # shared child, absent group columns projected as typed
                # NULLs, branches combined by UNION ALL (the analog of the
                # reference's GroupIdNode + repeated-aggregation rewrite).
                child = node
                n_explicit = len(sel.group_by)
                grouping_syms = [self.symbol("grouping")
                                 for _ in grouping_calls]
                extra_syms = group_syms[n_explicit:]  # decorrelation keys
                types = {s: child.schema[s] for s in group_syms}
                branches = []
                for st in sel.grouping_sets:
                    present: List[str] = []
                    seen = set()
                    for j in st:
                        sym = group_syms[j]
                        if sym not in seen:
                            seen.add(sym)
                            present.append(sym)
                    for sym in extra_syms:
                        if sym not in seen:
                            seen.add(sym)
                            present.append(sym)
                    agg_n = Aggregate(child, present, aggcalls)
                    outs: List[Tuple[str, ir.Expr]] = []
                    for sym in group_syms:
                        if sym in seen:
                            outs.append((sym, ir.ColumnRef(sym, types[sym])))
                        else:
                            outs.append((sym, ir.Literal(None, types[sym])))
                    for a in aggcalls:
                        outs.append((a.symbol, ir.ColumnRef(a.symbol, a.type)))
                    # grouping(): Trino's bitmask, bit n-i set where the
                    # i-th argument is not in this branch's set
                    for sym, args in zip(grouping_syms, grouping_args):
                        mask = sum(1 << (len(args) - 1 - i)
                                   for i, a in enumerate(args)
                                   if a not in seen)
                        outs.append((sym, ir.Literal(mask, BIGINT)))
                    branches.append(Project(agg_n, outs))
                seen_u = set()
                u_outputs = []
                for sym in group_syms:
                    if sym not in seen_u:
                        seen_u.add(sym)
                        u_outputs.append(
                            (sym, types[sym], [sym] * len(branches)))
                for a in aggcalls:
                    u_outputs.append(
                        (a.symbol, a.type, [a.symbol] * len(branches)))
                for g, sym in zip(grouping_calls, grouping_syms):
                    u_outputs.append((sym, BIGINT, [sym] * len(branches)))
                    agg_map[id(g)] = ir.ColumnRef(sym, BIGINT)
                node = Union(branches, u_outputs)
            scope = Scope(group_field_map, outer)

        # HAVING (may contain uncorrelated scalar subqueries, e.g. Q11)
        if sel.having is not None:
            node = self._plan_predicate(
                split_conjuncts(sel.having), node, scope, ctes, [],
                allow_correlation=False, agg_map=agg_map)

        # windows over aggregates (evaluated over the grouped relation)
        if post_windows:
            node = self._plan_windows(post_windows, node, scope, agg_map,
                                      agg_map)

        # SELECT projections
        conv = ExprConverter(scope, self, agg_map=agg_map,
                             by_value=group_ast_map)
        outputs: List[Tuple[str, ir.Expr]] = []
        out_fields: List[FieldRef] = []
        from ..types import RowType

        for i in sel.items:
            if i.expr is None:  # star
                for f in scope.fields:
                    if i.star_qualifier and f.qualifier != i.star_qualifier:
                        continue
                    if isinstance(f.type, RowType):
                        # rows flatten through * (struct-of-arrays view)
                        for fn, fs, ft in self.row_bindings[f.symbol]:
                            outputs.append((fs, ir.ColumnRef(fs, ft)))
                            out_fields.append(
                                FieldRef(None, f"{f.name}.{fn}", fs, ft))
                        continue
                    outputs.append((f.symbol, ir.ColumnRef(f.symbol, f.type)))
                    out_fields.append(FieldRef(None, f.name, f.symbol, f.type))
                continue
            e = conv.convert(i.expr)
            name = i.alias or (i.expr.name if isinstance(i.expr, ast.Identifier)
                               else self.symbol("col").replace("#", "_"))
            if isinstance(e, RowExpr):
                # a row-valued select item materialises per-field columns;
                # the row itself stays a logical binding over them
                binding = []
                for fn, fe in e.fields:
                    fsym = self.symbol(f"{name}${fn}")
                    outputs.append((fsym, fe))
                    binding.append((fn, fsym, fe.type))
                rowsym = self.symbol(name)
                self.row_bindings[rowsym] = binding
                out_fields.append(FieldRef(None, name, rowsym, e.type))
                continue
            sym = e.name if isinstance(e, ir.ColumnRef) else self.symbol(name)
            if not isinstance(e, ir.ColumnRef):
                outputs.append((sym, e))
            else:
                outputs.append((sym, e))
            out_fields.append(FieldRef(None, name, sym, e.type))
        # correlated subqueries must also surface their correlation columns
        # so the caller can join on them (hidden outputs)
        if corr_sink is not None and corr_conjuncts:
            out_syms = {s for s, _ in outputs}
            pre_schema = node.schema
            for c in corr_conjuncts:
                for r in ir.walk(c):
                    if (isinstance(r, ir.ColumnRef) and r.name in pre_schema
                            and r.name not in out_syms):
                        outputs.append((r.name, r))
                        out_syms.add(r.name)
        node = Project(node, outputs)
        out_scope = Scope(out_fields, outer)

        if sel.distinct:
            node = Aggregate(node, [s for s, _ in outputs], [])

        # ORDER BY / LIMIT
        if sel.order_by:
            # resolve against select outputs first, then the input relation
            # (SQL ORDER BY scoping; reference StatementAnalyzer order-by scope)
            sort_scope = _TwoLevelScope(Scope(out_fields), Scope(scope.fields),
                                        outer)
            sconv = ExprConverter(sort_scope, self, agg_map=agg_map,
                                  by_value=group_ast_map)
            keys = []
            hidden: List[Tuple[str, ir.Expr]] = []
            for o in sel.order_by:
                e = sconv.convert(o.expr)
                if isinstance(e, RowExpr):
                    raise PlanError(
                        "row values cannot appear in ORDER BY "
                        "(sort by a field instead, e.g. r.f0)")
                # ensure referenced symbols exist in projection output
                for r in ir.walk(e):
                    if isinstance(r, ir.ColumnRef) and r.name not in node.schema:
                        hidden.append((r.name, r))
                keys.append((e, o.ascending, o.nulls_first))
            if hidden:
                assert isinstance(node, Project)
                node = Project(node.child, node.outputs + hidden)
            node = Sort(node, keys, limit=sel.limit, offset=sel.offset)
        elif sel.limit is not None or sel.offset:
            node = Limit(node, sel.limit, offset=sel.offset)
        return RelationPlan(node, out_scope)

    # --------------------------------------------------- WHERE machinery

    def _plan_predicate(self, conjuncts: List[ast.Expr], node, scope, ctes,
                        corr_out: List[ir.Expr], allow_correlation: bool,
                        agg_map=None) -> LogicalNode:
        plain: List[ir.Expr] = []
        for c in conjuncts:
            neg = False
            inner = c
            while isinstance(inner, ast.UnaryOp) and inner.op == "not":
                neg = not neg
                inner = inner.operand
            if isinstance(inner, ast.Exists):
                node = self._plan_exists(inner.query, node, scope, ctes,
                                         negated=neg != inner.negated)
                continue
            if isinstance(inner, ast.InSubquery):
                node = self._plan_in_subquery(inner, node, scope, ctes,
                                              negated=neg != inner.negated)
                continue
            # scalar subqueries inside the conjunct
            subqs: List[ast.ScalarSubquery] = []
            _collect_scalar_subqueries(c, subqs)
            replace: Dict[int, ir.Expr] = {}
            for sq in subqs:
                node, ref = self._plan_scalar_subquery(sq.query, node, scope, ctes)
                replace[id(sq)] = ref
            conv = ExprConverter(scope, self, agg_map=agg_map, replace=replace)
            e = conv.convert(c)
            if conv.used_outer:
                if not allow_correlation:
                    raise PlanError("correlated predicate not supported here")
                corr_out.append(e)
            else:
                plain.append(e)
        if plain:
            node = Filter(node, ir_conjoin(plain))
        return node

    def _plan_exists(self, query: ast.Query, node, scope, ctes, negated):
        sink: List[ir.Expr] = []
        sub = self.plan_query(query, scope, ctes, corr_sink=sink)
        equis, residual = _split_join_condition(sink, node.schema,
                                               sub.node.schema)
        return Join(node, sub.node, "anti" if negated else "semi",
                    equis, residual)

    def _plan_in_subquery(self, e: ast.InSubquery, node, scope, ctes, negated):
        sink: List[ir.Expr] = []
        sub = self.plan_query(e.query, scope, ctes, corr_sink=sink)
        if len(sub.scope.fields) != 1:
            raise PlanError("IN subquery must produce one column")
        f = sub.scope.fields[0]
        conv = ExprConverter(scope, self)
        val = conv.convert(e.expr)
        equis = [(val, ir.ColumnRef(f.symbol, f.type))]
        more, residual = _split_join_condition(sink, node.schema,
                                              sub.node.schema)
        return Join(node, sub.node, "anti" if negated else "semi",
                    equis + more, residual)

    def _plan_scalar_subquery(self, query: ast.Query, node, scope, ctes):
        sink: List[ir.Expr] = []
        sub = self.plan_query(query, scope, ctes, corr_sink=sink)
        if len(sub.scope.fields) != 1:
            raise PlanError("scalar subquery must produce one column")
        f = sub.scope.fields[0]
        ref = ir.ColumnRef(f.symbol, f.type)
        if not sink:
            return Join(node, sub.node, "cross", [], None,
                        build_unique=True), ref
        equis, residual = _split_join_condition(sink, node.schema,
                                               sub.node.schema)
        if residual is not None:
            raise PlanError("non-equi correlation in scalar subquery")
        # the decorrelated subquery groups by its correlation columns, so
        # each outer row matches at most one group → LEFT join is exact
        return Join(node, sub.node, "left", equis, None,
                    build_unique=True), ref


def _field_for(scope: Scope, e: ir.Expr, sym: str, alias: Optional[str]):
    if isinstance(e, ir.ColumnRef):
        for f in scope.fields:
            if f.symbol == e.name:
                return FieldRef(f.qualifier, alias or f.name, f.symbol, f.type)
    return FieldRef(None, alias or sym, sym, e.type)


def _inner_equi_symbol(c: ir.Expr, inner_schema) -> Optional[str]:
    if isinstance(c, ir.Call) and c.fn == "=" and len(c.args) == 2:
        a, b = c.args
        if isinstance(a, ir.ColumnRef) and isinstance(b, ir.ColumnRef):
            if a.name in inner_schema:
                return a.name
            if b.name in inner_schema:
                return b.name
    return None


def _split_join_condition(conjuncts: List[ir.Expr], left_schema, right_schema):
    """Partition correlated conjuncts into equi pairs (left, right) and a
    residual expression."""
    equis, residual = [], []
    for c in conjuncts:
        ok = False
        if isinstance(c, ir.Call) and c.fn == "=" and len(c.args) == 2:
            a, b = c.args
            if isinstance(a, ir.ColumnRef) and isinstance(b, ir.ColumnRef):
                if a.name in left_schema and b.name in right_schema:
                    equis.append((a, b))
                    ok = True
                elif b.name in left_schema and a.name in right_schema:
                    equis.append((b, a))
                    ok = True
        if not ok:
            residual.append(c)
    return equis, ir_conjoin(residual)


def _collect_aggs(e: ast.Expr, out: List[ast.FuncCall]):
    if isinstance(e, ast.FuncCall) and (e.name in AGG_FNS or e.is_star):
        out.append(e)
        return  # no nested aggregates
    for child in _ast_children(e):
        _collect_aggs(child, out)


def _collect_grouping(e: ast.Expr, out: List[ast.FuncCall]):
    if isinstance(e, ast.FuncCall) and e.name == "grouping":
        out.append(e)
        return
    for child in _ast_children(e):
        _collect_grouping(child, out)


def _collect_windows(e: ast.Expr, out: List[ast.WindowCall]):
    if isinstance(e, ast.WindowCall):
        out.append(e)
        return
    for child in _ast_children(e):
        _collect_windows(child, out)


def _collect_scalar_subqueries(e: ast.Expr, out: List[ast.ScalarSubquery]):
    if isinstance(e, ast.ScalarSubquery):
        out.append(e)
        return
    for child in _ast_children(e):
        _collect_scalar_subqueries(child, out)


def _ast_children(e: ast.Expr):
    if isinstance(e, ast.BinaryOp):
        return [e.left, e.right]
    if isinstance(e, ast.UnaryOp):
        return [e.operand]
    if isinstance(e, ast.FuncCall):
        return e.args
    if isinstance(e, ast.Case):
        out = [c for w in e.whens for c in w]
        if e.else_ is not None:
            out.append(e.else_)
        if e.operand is not None:
            out.append(e.operand)
        return out
    if isinstance(e, ast.Cast):
        return [e.expr]
    if isinstance(e, ast.Between):
        return [e.expr, e.low, e.high]
    if isinstance(e, ast.InList):
        return [e.expr] + e.items
    if isinstance(e, ast.Like):
        return [e.expr, e.pattern]
    if isinstance(e, ast.IsNull):
        return [e.expr]
    if isinstance(e, ast.Extract):
        return [e.expr]
    if isinstance(e, ast.Substring):
        return [e.expr, e.start] + ([e.length] if e.length else [])
    if isinstance(e, ast.WindowCall):
        return (list(e.args) + list(e.partition_by)
                + [o.expr for o in e.order_by])
    return []


class ExprConverter:
    """AST expression → typed IR over a scope (the ExpressionAnalyzer)."""

    def __init__(self, scope: Scope, planner: Planner, agg_map=None,
                 replace=None, by_value=None):
        self.scope = scope
        self.planner = planner
        self.agg_map = agg_map or {}
        self.replace = replace or {}
        # structural (AST-equality) replacements: GROUP BY expressions
        # repeated in SELECT/HAVING/ORDER BY resolve to their grouped
        # symbol (reference: StatementAnalyzer's canonicalized group-expr
        # matching) — AST nodes are dataclasses, so == is structural
        self.by_value = by_value or []
        self.used_outer: Set[str] = set()
        self.lambda_params: Dict[str, ir.Expr] = {}

    def convert(self, e: ast.Expr) -> ir.Expr:
        if id(e) in self.replace:
            return self.replace[id(e)]
        if id(e) in self.agg_map:
            return self.agg_map[id(e)]
        for gast, gir in self.by_value:
            if e == gast:
                return gir
        m = getattr(self, f"_c_{type(e).__name__}", None)
        if m is None:
            raise PlanError(f"cannot convert {type(e).__name__}")
        return m(e)

    def _row_expand(self, f: "FieldRef") -> RowExpr:
        binding = self.planner.row_bindings.get(f.symbol)
        if binding is None:
            raise PlanError(f"row value {f.name} is not accessible here")
        return RowExpr([(fn, ir.ColumnRef(fs, ft))
                        for fn, fs, ft in binding])

    def _c_Identifier(self, e: ast.Identifier) -> ir.Expr:
        from ..types import RowType

        if e.qualifier is None and e.name in self.lambda_params:
            return self.lambda_params[e.name]
        try:
            f, depth = self.scope.resolve(e.qualifier, e.name)
        except PlanError:
            if e.qualifier is None and e.name == "current_date":
                import time as _time

                return ir.Literal(int(_time.time() // 86400), DATE)
            if e.qualifier is None and e.name in (
                    "current_timestamp", "localtimestamp"):
                # niladic SQL specials (parenless in the grammar)
                from . import ast as _ast

                return self._c_FuncCall(_ast.FuncCall(e.name, []))
            # row field access: r.a / t.r.a — the prefix names a
            # row-typed field, the last part selects its member
            if len(e.parts) >= 2:
                rq = e.parts[-3] if len(e.parts) >= 3 else None
                try:
                    rf, rdepth = self.scope.resolve(rq, e.parts[-2])
                except PlanError:
                    raise
                if isinstance(rf.type, RowType):
                    if rdepth > 0:
                        raise PlanError("correlated row references "
                                        "unsupported")
                    return self._row_expand(rf).field(e.parts[-1])
            raise
        if depth > 0:
            self.used_outer.add(f.symbol)
        if isinstance(f.type, RowType):
            if depth > 0:
                raise PlanError("correlated row references unsupported")
            return self._row_expand(f)
        return ir.ColumnRef(f.symbol, f.type)

    def _c_NumberLit(self, e: ast.NumberLit) -> ir.Expr:
        if "e" in e.text or "E" in e.text:  # scientific notation -> double
            return ir.Literal(float(e.text), DOUBLE)
        if "." in e.text:
            intpart, frac = e.text.split(".")
            scale = len(frac)
            v = int(intpart or "0") * 10 ** scale + int(frac or "0")
            return ir.Literal(v, DecimalType(18, scale))
        return ir.Literal(int(e.text), BIGINT)

    def _c_StringLit(self, e: ast.StringLit) -> ir.Expr:
        return ir.Literal(e.value, VARCHAR)

    def _c_BinaryLit(self, e: ast.BinaryLit) -> ir.Expr:
        from ..types import VARBINARY

        try:
            raw = bytes.fromhex(e.value)
        except ValueError:
            raise PlanError(f"invalid binary literal X'{e.value}'")
        # physical value = latin-1 image of the bytes (order-preserving)
        return ir.Literal(raw.decode("latin-1"), VARBINARY)

    def _c_DateLit(self, e: ast.DateLit) -> ir.Expr:
        return ir.Literal(_days(e.value), DATE)

    def _c_TimestampLit(self, e: ast.TimestampLit) -> ir.Expr:
        import re as _re

        from ..types import TIMESTAMP, TimestampTzType, parse_zone_offset

        # trailing zone => TIMESTAMP WITH TIME ZONE literal
        # ('2020-01-01 10:00:00 +05:30' / '... UTC')
        m = _re.match(r"^(.*?)\s*(Z|UTC|GMT|[+-]\d{1,2}(?::\d{2})?)$",
                      e.value.strip(), _re.IGNORECASE)
        if m and not m.group(1).strip().endswith("-"):
            try:
                offset = parse_zone_offset(m.group(2))
            except ValueError:
                offset = None
            if offset is not None and _re.search(r"\d{2}:\d{2}",
                                                 m.group(1)):
                local = _micros(m.group(1).strip())
                return ir.Literal(local - offset * 60_000_000,
                                  TimestampTzType(3, offset))
        return ir.Literal(_micros(e.value), TIMESTAMP)

    def _c_AtTimeZone(self, e) -> ir.Expr:
        from ..types import TimestampTzType, parse_zone_offset

        inner = self.convert(e.expr)
        try:
            offset = parse_zone_offset(e.zone)
        except ValueError as ex:
            raise PlanError(str(ex))
        t = inner.type
        if t.kind not in ("timestamp", "timestamptz", "date"):
            raise PlanError(f"AT TIME ZONE over {t} (need a timestamp)")
        prec = getattr(t, "precision", 3)
        target = TimestampTzType(prec, offset)
        # instant-preserving: naive values are session-zone (UTC)
        # instants, tz values stay the same instant — only the display
        # zone changes (a pure type rewrite; zero device work)
        return ir.call("cast", inner, type=target)

    def _c_BinaryOp(self, e: ast.BinaryOp) -> ir.Expr:
        # date/timestamp ± interval: constant-fold on date literals,
        # lower to the vectorized date_add on anything else (runtime
        # column arithmetic — ``DateTimeOperators`` analog)
        if e.op in ("+", "-") and isinstance(e.right, ast.IntervalLit):
            left = self.convert(e.left)
            sign = 1 if e.op == "+" else -1
            unit = e.right.unit
            if isinstance(left, ir.Literal) and left.type == DATE:
                return ir.Literal(
                    _fold_date(left.value, e.right.value, unit, sign),
                    DATE)
            if left.type.kind in ("date", "timestamp"):
                if left.type.kind == "date" and unit in (
                        "hour", "minute", "second"):
                    raise PlanError(
                        f"date ± sub-day interval ({unit}): cast to "
                        "timestamp first")
                return ir.Call(
                    "date_add",
                    (ir.Literal(unit, VARCHAR),
                     ir.Literal(sign * e.right.value, BIGINT), left),
                    left.type)
            raise PlanError("interval arithmetic needs a date/timestamp "
                            "left operand")
        left = self.convert(e.left)
        right = self.convert(e.right)
        if isinstance(left, RowExpr) or isinstance(right, RowExpr):
            raise PlanError("row values only support field access and "
                            "CAST (comparisons/arithmetic excluded)")
        if e.op == "||" and left.type.kind == "array":
            return ir.Call("array_concat", (left, right), left.type)
        op = {"%": "mod"}.get(e.op, e.op)
        return ir.call(op, left, right)

    def _c_UnaryOp(self, e: ast.UnaryOp) -> ir.Expr:
        child = self.convert(e.operand)
        if e.op == "not":
            return ir.call("not", child)
        if isinstance(child, ir.Literal):
            return ir.Literal(-child.value, child.type)
        return ir.call("neg", child)

    SCALAR_FNS = {
        "abs", "floor", "ceil", "round", "sqrt", "power", "pow", "mod",
        "nullif", "greatest", "least", "length", "upper", "lower", "trim",
        "concat", "coalesce", "ln", "exp", "log2", "log10",
        # math breadth (operator/scalar/MathFunctions.java)
        "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
        "cosh", "tanh", "cbrt", "degrees", "radians", "sign", "truncate",
        "log", "is_nan", "is_finite", "is_infinite",
        # string breadth (operator/scalar/StringFunctions.java)
        "replace", "reverse", "ltrim", "rtrim", "lpad", "rpad", "strpos",
        "starts_with", "split_part", "codepoint", "levenshtein_distance",
        # binary breadth (operator/scalar/VarbinaryFunctions.java)
        "to_hex", "md5", "sha256", "sha1", "sha512", "crc32",
        "to_utf8", "from_utf8", "from_hex", "to_base64", "from_base64",
        # regex (operator/scalar/JoniRegexpFunctions.java)
        "regexp_like", "regexp_extract", "regexp_replace", "regexp_count",
        # json (operator/scalar/JsonFunctions.java)
        "json_extract", "json_extract_scalar", "json_array_length",
        "json_size", "json_format",
        # url (operator/scalar/UrlFunctions.java)
        "url_extract_host", "url_extract_path", "url_extract_protocol",
        "url_extract_query", "url_extract_fragment", "url_extract_port",
        "url_encode", "url_decode",
    }

    ARRAY_LAMBDA_FNS = {"transform", "filter", "any_match", "all_match",
                        "none_match"}
    ARRAY_FNS = {"cardinality", "element_at", "contains", "array_position",
                 "array_min", "array_max", "map", "map_keys", "map_values",
                 "array_concat"}

    def _c_ArrayLit(self, e) -> ir.Expr:
        # common_supertype imported here too: the JAX package's planner
        # names it without importing it, so mixed element types raise
        # NameError there (ROADMAP C12)
        from ..types import ArrayType, common_supertype

        items = [self.convert(i) for i in e.items]
        t = items[0].type if items else BIGINT
        for it in items[1:]:
            if it.type != t:
                t = common_supertype(t, it.type)
        items = [i if i.type == t else ir.call("cast", i, type=t)
                 for i in items]
        return ir.Call("array_ctor", tuple(items), ArrayType(t))

    def _c_Lambda(self, e) -> ir.Expr:
        raise PlanError("lambda outside an array function argument")

    def _c_array_fn(self, name: str, e: ast.FuncCall) -> ir.Expr:
        from ..types import ArrayType, MapType

        if name in self.ARRAY_LAMBDA_FNS:
            arr = self.convert(e.args[0])
            if arr.type.kind != "array":
                raise PlanError(f"{name}: first argument must be an array")
            lam = e.args[1]
            if not isinstance(lam, ast.Lambda) or len(lam.params) != 1:
                raise PlanError(f"{name}: second argument must be a "
                                "single-parameter lambda")
            pname = lam.params[0]
            psym = f"__lam${pname}"
            saved = self.lambda_params.get(pname)
            self.lambda_params[pname] = ir.ColumnRef(psym,
                                                     arr.type.element)
            try:
                body = self.convert(lam.body)
            finally:
                if saved is None:
                    self.lambda_params.pop(pname, None)
                else:
                    self.lambda_params[pname] = saved
            lam_ir = ir.Lambda((psym,), body, body.type)
            if name == "transform":
                t = ArrayType(body.type)
            elif name == "filter":
                t = arr.type
            else:
                t = BOOLEAN
            return ir.Call(name, (arr, lam_ir), t)
        args = [self.convert(a) for a in e.args]
        a0 = args[0]
        if name == "cardinality":
            if a0.type.kind not in ("array", "map"):
                raise PlanError("cardinality over non-collection")
            return ir.Call(name, tuple(args), BIGINT)
        if name == "element_at":
            if a0.type.kind == "map":
                return ir.Call(name, tuple(args), a0.type.value)
            if a0.type.kind == "array":
                return ir.Call(name, tuple(args), a0.type.element)
            raise PlanError("element_at over non-collection")
        if name == "contains":
            return ir.Call(name, tuple(args), BOOLEAN)
        if name == "array_position":
            return ir.Call(name, tuple(args), BIGINT)
        if name in ("array_min", "array_max"):
            return ir.Call(name, tuple(args), a0.type.element)
        if name == "map":
            if len(args) != 2 or args[0].type.kind != "array" \
                    or args[1].type.kind != "array":
                raise PlanError("map(keys_array, values_array)")
            return ir.Call(name, tuple(args),
                           MapType(args[0].type.element,
                                   args[1].type.element))
        if name == "map_keys":
            return ir.Call(name, tuple(args), ArrayType(a0.type.key))
        if name == "map_values":
            return ir.Call(name, tuple(args), ArrayType(a0.type.value))
        if name == "array_concat":
            return ir.Call(name, tuple(args), a0.type)
        raise PlanError(f"unknown array function {name}")

    def _c_FuncCall(self, e: ast.FuncCall) -> ir.Expr:
        name = {"pow": "power", "position": "strpos"}.get(e.name, e.name)
        if name == "row":
            fields = []
            for i, a in enumerate(e.args):
                v = self.convert(a)
                if isinstance(v, RowExpr):
                    raise PlanError("nested ROW construction unsupported")
                fields.append((f"f{i}", v))
            return RowExpr(fields)
        if name == "element_at" and len(e.args) == 2:
            base = self.convert(e.args[0])
            if isinstance(base, RowExpr):
                idx = self.convert(e.args[1])
                if not isinstance(idx, ir.Literal):
                    raise PlanError("row subscript must be a constant")
                i = int(idx.value)
                if not 1 <= i <= len(base.fields):
                    raise PlanError(f"row subscript {i} out of range "
                                    f"(1..{len(base.fields)})")
                return base.fields[i - 1][1]
        if name in self.ARRAY_LAMBDA_FNS or name in self.ARRAY_FNS:
            return self._c_array_fn(name, e)
        if name == "substr" and len(e.args) >= 2:
            return self.convert(ast.Substring(
                e.args[0], e.args[1],
                e.args[2] if len(e.args) > 2 else None))
        if not e.args and name in ("pi", "e", "nan", "infinity"):
            import math

            val = {"pi": math.pi, "e": math.e, "nan": float("nan"),
                   "infinity": float("inf")}[name]
            return ir.Literal(val, DOUBLE)
        if name in self.SCALAR_FNS:
            args = [self.convert(a) for a in e.args]
            if name == "coalesce":
                return ir.call("coalesce", *args, type=args[0].type)
            if name == "concat":
                out = args[0]
                for a in args[1:]:
                    out = ir.call("||", out, a)
                return out
            if name in ("ln", "exp", "log2", "log10"):
                return ir.call(name, args[0], type=DOUBLE)
            return ir.call(name, *args)
        if name in ("year", "month", "day", "quarter", "week",
                    "day_of_week", "dow", "day_of_year", "doy",
                    "hour", "minute", "second", "millisecond"):
            return ir.call(f"extract_{name}", self.convert(e.args[0]),
                           type=BIGINT)
        if name in ("date_trunc", "date_add", "date_diff"):
            unit = e.args[0]
            if not isinstance(unit, ast.StringLit):
                raise PlanError(f"{name}: unit must be a string literal")
            args = [ir.Literal(unit.value, VARCHAR)] + [
                self.convert(a) for a in e.args[1:]]
            t = BIGINT if name == "date_diff" else args[-1].type
            return ir.call(name, *args, type=t)
        if name == "current_date":
            import time as _time

            days = int(_time.time() // 86400)
            return ir.Literal(days, DATE)
        if name in ("current_timestamp", "now", "localtimestamp"):
            import time as _time

            from ..types import TIMESTAMP, TimestampTzType

            # current_timestamp/now are zoned (session zone = UTC, the
            # reference's CURRENT_TIMESTAMP returns timestamp with tz);
            # localtimestamp stays naive
            t = (TIMESTAMP if name == "localtimestamp"
                 else TimestampTzType(3, 0))
            return ir.Literal(int(_time.time() * 1_000_000), t)
        raise PlanError(
            f"aggregate {e.name} in invalid context (or unknown function)")

    def _c_Case(self, e: ast.Case) -> ir.Expr:
        args: List[ir.Expr] = []
        for cond, val in e.whens:
            if e.operand is not None:
                cond = ast.BinaryOp("=", e.operand, cond)
            args.append(self.convert(cond))
            args.append(self.convert(val))
        if e.else_ is not None:
            args.append(self.convert(e.else_))
        else:
            # SQL: CASE without ELSE yields NULL
            args.append(ir.Literal(None, args[1].type))
        return ir.call("case", *args)

    def _c_Cast(self, e: ast.Cast) -> ir.Expr:
        from ..types import RowType

        t = parse_type(e.type_name)
        inner = self.convert(e.expr)
        if isinstance(t, RowType):
            if not isinstance(inner, RowExpr):
                raise PlanError("cast to row requires a row value")
            if len(t.fields) != len(inner.fields):
                raise PlanError("row cast field count mismatch")
            fields = []
            for (fname, ft), (_, fe) in zip(t.fields, inner.fields):
                fields.append((fname, fe if fe.type == ft
                               else ir.call("cast", fe, type=ft)))
            return RowExpr(fields)
        if isinstance(inner, RowExpr):
            raise PlanError(f"cannot cast a row value to {t}")
        return ir.call("cast", inner, type=t)

    def _c_Between(self, e: ast.Between) -> ir.Expr:
        v = self.convert(e.expr)
        lo = self.convert(e.low)
        hi = self.convert(e.high)
        out = ir.call("and", ir.call(">=", v, lo), ir.call("<=", v, hi))
        return ir.call("not", out) if e.negated else out

    def _c_InList(self, e: ast.InList) -> ir.Expr:
        out = ir.call("in", self.convert(e.expr),
                      *[self.convert(i) for i in e.items])
        return ir.call("not", out) if e.negated else out

    def _c_Like(self, e: ast.Like) -> ir.Expr:
        out = ir.call("like", self.convert(e.expr), self.convert(e.pattern))
        return ir.call("not", out) if e.negated else out

    def _c_IsNull(self, e: ast.IsNull) -> ir.Expr:
        out = ir.call("is_null", self.convert(e.expr))
        return ir.call("not", out) if e.negated else out

    EXTRACT_FIELDS = ("year", "month", "day", "quarter", "dow",
                      "day_of_week", "doy", "day_of_year", "week",
                      "week_of_year", "hour", "minute", "second",
                      "millisecond")

    def _c_Extract(self, e: ast.Extract) -> ir.Expr:
        if e.field not in self.EXTRACT_FIELDS:
            raise PlanError(f"extract({e.field}) unsupported")
        return ir.call(f"extract_{e.field}", self.convert(e.expr),
                       type=BIGINT)

    def _c_Substring(self, e: ast.Substring) -> ir.Expr:
        args = [self.convert(e.expr), self.convert(e.start)]
        if e.length is not None:
            args.append(self.convert(e.length))
        return ir.Call("substring", tuple(args), VARCHAR)

    def _c_ScalarSubquery(self, e):
        raise PlanError("scalar subquery in unsupported position")

    def _c_Exists(self, e):
        raise PlanError("EXISTS outside WHERE conjunct is unsupported")

    def _c_InSubquery(self, e):
        raise PlanError("IN (subquery) outside WHERE conjunct is unsupported")

    def _c_IntervalLit(self, e):
        """First-class interval VALUE (``SqlIntervalDayTime`` /
        ``SqlIntervalYearMonth``): day-second intervals are int64 micros,
        year-month intervals int32 months; comparisons and +/- between
        same-kind intervals ride the generic integer operators."""
        from ..types import INTERVAL_DS, INTERVAL_YM

        unit = e.unit
        if unit in ("year", "month"):
            months = e.value * (12 if unit == "year" else 1)
            return ir.Literal(months, INTERVAL_YM)
        micros = {"day": 86_400_000_000, "hour": 3_600_000_000,
                  "minute": 60_000_000, "second": 1_000_000}[unit] * e.value
        return ir.Literal(micros, INTERVAL_DS)


def _fold_date(days: int, n: int, unit: str, sign: int) -> int:
    d = EPOCH + days
    if unit == "day":
        return days + sign * n
    m = d.astype("datetime64[M]")
    day_of_month = int((d - m.astype("datetime64[D]")) / np.timedelta64(1, "D"))
    m2 = m + sign * n * (12 if unit == "year" else 1)
    out = m2.astype("datetime64[D]") + day_of_month
    return int((out - EPOCH) / np.timedelta64(1, "D"))
