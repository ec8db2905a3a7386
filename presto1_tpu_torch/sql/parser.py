"""SQL lexer + recursive-descent parser.

Replaces the reference's ANTLR4 grammar + AstBuilder
(``core/trino-parser/src/main/antlr4/io/trino/sql/parser/SqlBase.g4``,
``sql/parser/AstBuilder.java``) with a hand-written parser for the
SELECT dialect the engine executes.  Precedence follows the grammar:
OR < AND < NOT < predicate (comparison/IN/LIKE/BETWEEN/IS) < + - < * / < unary.
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<number>(?:\d+\.\d+|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||->|[(),.;*/%+\-<>=\[\]])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "case", "when", "then", "else", "end", "cast", "date",
    "interval", "extract", "substring", "join", "inner", "left", "right",
    "full", "outer", "cross", "on", "distinct", "asc", "desc", "with",
    "union", "intersect", "except", "all", "nulls", "first", "last",
    "true", "false", "for",
    "create", "table", "insert", "into", "values", "drop",
    "over", "partition", "explain", "analyze",
    "rows", "range", "groups", "unbounded", "preceding", "following",
    "current", "row", "offset",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind  # 'number','string','ident','op','kw'
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"lex error at {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("ident", low, m.start()))
        elif kind == "qident":
            out.append(Token("ident", text[1:-1].replace('""', '"'), m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"), m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SyntaxError(f"expected {value or kind}, got {got.kind}:{got.value!r}")
        return t

    def kw(self, word: str) -> Optional[Token]:
        return self.accept("kw", word)

    # -- entry

    def parse_query(self) -> ast.Query:
        q = self._query()
        self.accept("op", ";")
        self.expect("eof")
        return q

    def parse_statement(self):
        t = self.peek()
        if t.kind == "ident" and t.value in ("show", "describe", "desc"):
            self.next()
            if t.value in ("describe", "desc"):
                name = self.expect("ident").value
                return self._finish(ast.Show("columns", name))
            w = self.expect("ident").value
            if w == "columns":
                self.expect("kw", "from")
                return self._finish(ast.Show("columns",
                                             self.expect("ident").value))
            if w in ("tables", "schemas", "catalogs", "session",
                     "functions"):
                return self._finish(ast.Show(w))
            raise SyntaxError(f"SHOW {w} is not supported")
        if t.kind == "kw" and t.value == "explain":
            self.next()
            analyze = bool(self.kw("analyze"))
            q = self._query()
            self.accept("op", ";")
            self.expect("eof")
            return ast.Explain(q, analyze)
        if t.kind == "kw" and t.value == "create":
            self.next()
            self.expect("kw", "table")
            name = self.expect("ident").value
            if self.kw("as"):
                return self._finish(ast.CreateTable(name, as_query=self._query()))
            self.expect("op", "(")
            cols = []
            while True:
                cname = self.expect("ident").value
                parts = [self.next().value]
                while self.peek().kind in ("ident", "kw") or self.peek().value == "(":
                    nt = self.peek()
                    if nt.value == "(":
                        self.next()
                        inner = []
                        while self.peek().value != ")":
                            inner.append(self.next().value)
                        self.next()
                        parts[-1] += "(" + "".join(inner) + ")"
                        break
                    if nt.kind == "op":
                        break
                    parts.append(self.next().value)
                cols.append((cname, " ".join(parts)))
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            return self._finish(ast.CreateTable(name, columns=cols))
        if t.kind == "kw" and t.value == "insert":
            self.next()
            self.expect("kw", "into")
            name = self.expect("ident").value
            if self.kw("values"):
                rows = []
                while True:
                    self.expect("op", "(")
                    row = [self._expr()]
                    while self.accept("op", ","):
                        row.append(self._expr())
                    self.expect("op", ")")
                    rows.append(row)
                    if not self.accept("op", ","):
                        break
                return self._finish(ast.InsertInto(name, values=rows))
            return self._finish(ast.InsertInto(name, query=self._query()))
        if t.kind == "kw" and t.value == "drop":
            self.next()
            self.expect("kw", "table")
            name = self.expect("ident").value
            return self._finish(ast.DropTable(name))
        return self.parse_query()

    def _finish(self, stmt):
        self.accept("op", ";")
        self.expect("eof")
        return stmt

    def _query(self) -> ast.Query:
        ctes = []
        if self.kw("with"):
            while True:
                name = self.expect("ident").value
                self.expect("kw", "as")
                self.expect("op", "(")
                ctes.append((name, self._query()))
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        sel = self._select_term()
        while True:  # INTERSECT binds tighter (handled in _select_term)
            if self.kw("union"):
                setop = "union"
            elif self.kw("except"):
                setop = "except"
            else:
                break
            all_ = bool(self.kw("all"))
            self.kw("distinct")
            right = self._select_term()
            sel = ast.SetOp(sel, right, all_, op=setop)
        if isinstance(sel, ast.SetOp):
            # a trailing ORDER BY/LIMIT/OFFSET binds to the whole set
            # operation
            last = sel.right
            sel.order_by, last.order_by = last.order_by, []
            sel.limit, last.limit = last.limit, None
            sel.offset, last.offset = last.offset, 0
        return ast.Query(ctes, sel)

    def _select_term(self):
        """select (INTERSECT select)* — INTERSECT binds tighter than
        UNION/EXCEPT (SQL precedence)."""
        sel = self._select()
        while self.kw("intersect"):
            all_ = bool(self.kw("all"))
            self.kw("distinct")
            right = self._select()
            sel = ast.SetOp(sel, right, all_, op="intersect")
        return sel

    def _select(self) -> ast.Select:
        self.expect("kw", "select")
        distinct = bool(self.kw("distinct"))
        self.kw("all")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        from_ = None
        if self.kw("from"):
            from_ = self._from_relation()
        where = self._expr() if self.kw("where") else None
        group_by = []
        grouping_sets = None
        if self.kw("group"):
            self.expect("kw", "by")
            # each element is a "factor": a list of index-sets into group_by;
            # plain exprs are the single-set factor [[i]]; the final sets are
            # the cross-product of all factors (SQL grouping-set semantics)
            factors = [self._group_element(group_by)]
            while self.accept("op", ","):
                factors.append(self._group_element(group_by))
            if any(len(f) != 1 or len(f[0]) != 1 for f in factors):
                sets = [[]]
                for f in factors:
                    sets = [g + s for g in sets for s in f]
                grouping_sets = sets
        having = self._expr() if self.kw("having") else None
        order_by = []
        if self.kw("order"):
            self.expect("kw", "by")
            order_by.append(self._order_item())
            while self.accept("op", ","):
                order_by.append(self._order_item())
        limit = None
        offset = 0
        if self.kw("offset"):  # Trino order: OFFSET m LIMIT n
            offset = int(self.expect("number").value)
            self.kw("rows") or self.kw("row")
        if self.kw("limit"):
            limit = int(self.expect("number").value)
        if offset == 0 and self.kw("offset"):  # postgres order
            offset = int(self.expect("number").value)
            self.kw("rows") or self.kw("row")
        return ast.Select(items, from_, where, group_by, having, order_by,
                          limit, distinct, grouping_sets=grouping_sets,
                          offset=offset)

    def _group_add(self, group_by, e):
        """Append a grouping expr, deduplicating structurally equal ones."""
        for i, g in enumerate(group_by):
            if g == e:
                return i
        group_by.append(e)
        return len(group_by) - 1

    def _group_element(self, group_by):
        """One GROUP BY element -> a factor: a list of index-sets.

        Plain expr -> [[i]]; ROLLUP(a,b) -> [[a,b],[a],[]];
        CUBE(a,b) -> all subsets; GROUPING SETS (...) -> listed sets.
        """
        t = self.peek()
        word = t.value.lower() if t.kind == "ident" else None
        if word in ("rollup", "cube") and self.peek(1).value == "(":
            self.next()
            self.next()
            cols = [self._expr()]
            while self.accept("op", ","):
                cols.append(self._expr())
            self.expect("op", ")")
            idxs = [self._group_add(group_by, c) for c in cols]
            if word == "rollup":
                return [idxs[:k] for k in range(len(idxs), -1, -1)]
            return [[idxs[j] for j in range(len(idxs)) if m >> j & 1]
                    for m in range(1 << len(idxs))]
        if word == "grouping" and self.peek(1).kind == "ident" \
                and self.peek(1).value.lower() == "sets":
            self.next()
            self.next()
            self.expect("op", "(")
            sets = [self._grouping_set(group_by)]
            while self.accept("op", ","):
                sets.append(self._grouping_set(group_by))
            self.expect("op", ")")
            return sets
        return [[self._group_add(group_by, self._expr())]]

    def _grouping_set(self, group_by):
        if self.accept("op", "("):
            cols = []
            if self.peek().value != ")":
                cols.append(self._expr())
                while self.accept("op", ","):
                    cols.append(self._expr())
            self.expect("op", ")")
        else:
            cols = [self._expr()]
        return [self._group_add(group_by, c) for c in cols]

    def _select_item(self) -> ast.SelectItem:
        if self.accept("op", "*"):
            return ast.SelectItem(None)
        # t.* form
        if (self.peek().kind == "ident" and self.peek(1).value == "."
                and self.peek(2).value == "*"):
            q = self.next().value
            self.next()
            self.next()
            return ast.SelectItem(None, star_qualifier=q)
        e = self._expr()
        alias = None
        if self.kw("as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def _order_item(self) -> ast.OrderItem:
        e = self._expr()
        asc = True
        if self.kw("asc"):
            asc = True
        elif self.kw("desc"):
            asc = False
        nulls_first = None
        if self.kw("nulls"):
            if self.kw("first"):
                nulls_first = True
            else:
                self.expect("kw", "last")
                nulls_first = False
        return ast.OrderItem(e, asc, nulls_first)

    # -- FROM clause

    def _from_relation(self) -> ast.FromItem:
        left = self._join_unit()
        while True:
            if self.accept("op", ","):
                right = self._join_unit()
                left = ast.JoinItem(left, right, "cross")
                continue
            kind = None
            if self.kw("cross"):
                self.expect("kw", "join")
                left = ast.JoinItem(left, self._join_unit(), "cross")
                continue
            if self.kw("inner"):
                kind = "inner"
            elif self.kw("left"):
                self.kw("outer")
                kind = "left"
            elif self.kw("right"):
                self.kw("outer")
                kind = "right"
            elif self.kw("full"):
                self.kw("outer")
                kind = "full"
            elif self.peek().kind == "kw" and self.peek().value == "join":
                kind = "inner"
            if kind is None:
                return left
            self.expect("kw", "join")
            right = self._join_unit()
            self.expect("kw", "on")
            cond = self._expr()
            left = ast.JoinItem(left, right, kind, cond)

    def _join_unit(self) -> ast.FromItem:
        if self.accept("op", "("):
            if self.peek().value in ("select", "with"):
                q = self._query()
                self.expect("op", ")")
                self.kw("as")
                alias = self.expect("ident").value
                return ast.SubqueryRef(q, alias)
            rel = self._from_relation()
            self.expect("op", ")")
            return rel
        if self.peek().kind == "ident" and \
                self.peek().value.lower() == "unnest" and \
                self.peek(1).kind == "op" and self.peek(1).value == "(":
            self.next()
            self.next()  # (
            expr = self._expr()
            self.expect("op", ")")
            alias, columns = None, None
            if self.kw("as"):
                alias = self.expect("ident").value
                if self.accept("op", "("):
                    columns = [self.expect("ident").value]
                    while self.accept("op", ","):
                        columns.append(self.expect("ident").value)
                    self.expect("op", ")")
            return ast.UnnestRef(expr, alias, columns)
        name = self.expect("ident").value
        # catalog.schema qualifiers: the system catalog resolves by full
        # dotted name (system.runtime.queries); others keep the last part
        parts = [name]
        while self.accept("op", "."):
            parts.append(self.expect("ident").value)
        name = ".".join(parts) if parts[0] == "system" else parts[-1]
        alias = None
        if self.kw("as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.TableRef(name, alias)

    # -- expressions (precedence climbing)

    def _expr(self) -> ast.Expr:
        return self._or_expr()

    def _or_expr(self) -> ast.Expr:
        left = self._and_expr()
        while self.kw("or"):
            left = ast.BinaryOp("or", left, self._and_expr())
        return left

    def _and_expr(self) -> ast.Expr:
        left = self._not_expr()
        while self.kw("and"):
            left = ast.BinaryOp("and", left, self._not_expr())
        return left

    def _not_expr(self) -> ast.Expr:
        if self.kw("not"):
            return ast.UnaryOp("not", self._not_expr())
        return self._predicate()

    def _predicate(self) -> ast.Expr:
        left = self._additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = "<>" if t.value == "!=" else t.value
                right = self._additive()
                left = ast.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.kw("not"):
                negated = True
            if self.kw("between"):
                lo = self._additive()
                self.expect("kw", "and")
                hi = self._additive()
                left = ast.Between(left, lo, hi, negated)
                continue
            if self.kw("in"):
                self.expect("op", "(")
                if self.peek().value in ("select", "with"):
                    q = self._query()
                    self.expect("op", ")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = [self._expr()]
                    while self.accept("op", ","):
                        items.append(self._expr())
                    self.expect("op", ")")
                    left = ast.InList(left, items, negated)
                continue
            if self.kw("like"):
                pat = self._additive()
                left = ast.Like(left, pat, negated)
                continue
            if negated:
                self.i = save
                break
            if self.kw("is"):
                neg = bool(self.kw("not"))
                self.expect("kw", "null")
                left = ast.IsNull(left, neg)
                continue
            break
        return left

    def _additive(self) -> ast.Expr:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = ast.BinaryOp(t.value, left, self._multiplicative())
            elif t.kind == "op" and t.value == "||":
                self.next()
                left = ast.BinaryOp("||", left, self._multiplicative())
            elif (t.kind == "ident" and t.value == "at"
                  and self.peek(1).kind == "ident"
                  and self.peek(1).value == "time"
                  and self.peek(2).kind == "ident"
                  and self.peek(2).value == "zone"):
                # AT TIME ZONE applies to the whole additive expression
                # before it: ts + interval '1' hour AT TIME ZONE z is
                # AtTimeZone(ts + interval)
                self.next(), self.next(), self.next()
                zone = self.expect("string").value
                left = ast.AtTimeZone(left, zone)
            else:
                return left

    def _multiplicative(self) -> ast.Expr:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = ast.BinaryOp(t.value, left, self._unary())
            else:
                return left

    def _unary(self) -> ast.Expr:
        if self.accept("op", "-"):
            return ast.UnaryOp("-", self._unary())
        if self.accept("op", "+"):
            return self._unary()
        e = self._primary()
        # postfix subscript: a[i] == element_at(a, i) (1-based, NULL when
        # out of range — Trino semantics for [] differ by raising; we keep
        # the total element_at behavior, documented)
        while self.peek().kind == "op" and self.peek().value == "[":
            self.next()
            idx = self._expr()
            self.expect("op", "]")
            e = ast.FuncCall("element_at", [e, idx])
        return e

    def _primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ast.NumberLit(t.value)
        if t.kind == "string":
            self.next()
            return ast.StringLit(t.value)
        # X'AB01' varbinary literal (SqlBase.g4 BINARY_LITERAL)
        if t.kind == "ident" and t.value == "x" \
                and self.peek(1).kind == "string":
            self.next()
            hexstr = self.next().value.replace(" ", "")
            return ast.BinaryLit(hexstr)
        if t.kind == "kw":
            if t.value == "date":
                self.next()
                s = self.expect("string")
                return ast.DateLit(s.value)
            if t.value == "interval":
                self.next()
                v = self.expect("string").value
                unit_tok = self.next()  # day/month/year (ident or kw)
                unit = unit_tok.value.rstrip("s")
                return ast.IntervalLit(int(v), unit)
            if t.value == "case":
                return self._case()
            # ROW(e1, e2, ...) constructor — 'row' is a keyword (window
            # frames) but doubles as the row-type constructor
            if t.value == "row" and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                self.next()
                self.next()  # (
                args = [self._expr()]
                while self.accept("op", ","):
                    args.append(self._expr())
                self.expect("op", ")")
                return ast.FuncCall("row", args)
            if t.value == "cast":
                self.next()
                self.expect("op", "(")
                e = self._expr()
                self.expect("kw", "as")
                parts = [self.next().value]
                while self.peek().kind in ("ident", "kw") or self.peek().value == "(":
                    nt = self.peek()
                    if nt.value == "(":
                        self.next()
                        parts.append("(")
                        while self.peek().value != ")":
                            parts.append(self.next().value)
                        self.next()
                        parts.append(")")
                        break
                    if nt.kind == "op":
                        break
                    parts.append(self.next().value)
                self.expect("op", ")")
                return ast.Cast(e, " ".join(parts))
            if t.value == "extract":
                self.next()
                self.expect("op", "(")
                field = self.next().value
                self.expect("kw", "from")
                e = self._expr()
                self.expect("op", ")")
                return ast.Extract(field, e)
            if t.value == "substring":
                self.next()
                self.expect("op", "(")
                e = self._expr()
                if self.kw("from"):
                    start = self._expr()
                    length = self._expr() if self.kw("for") else None
                else:
                    self.expect("op", ",")
                    start = self._expr()
                    length = self._expr() if self.accept("op", ",") else None
                self.expect("op", ")")
                return ast.Substring(e, start, length)
            if t.value == "exists":
                self.next()
                self.expect("op", "(")
                q = self._query()
                self.expect("op", ")")
                return ast.Exists(q)
            if t.value == "not":
                self.next()
                return ast.UnaryOp("not", self._not_expr())
            if t.value in ("true", "false"):
                self.next()
                return ast.NumberLit("1" if t.value == "true" else "0")
            if t.value == "null":
                self.next()
                return ast.Identifier(["null"])  # handled by planner as NULL literal
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().value in ("select", "with"):
                q = self._query()
                self.expect("op", ")")
                return ast.ScalarSubquery(q)
            e = self._expr()
            self.expect("op", ")")
            return e
        if t.kind == "ident":
            # ARRAY[e1, e2, ...] literal
            if t.value.lower() == "array" and self.peek(1).kind == "op" \
                    and self.peek(1).value == "[":
                self.next()
                self.next()  # [
                items = []
                if not (self.peek().kind == "op"
                        and self.peek().value == "]"):
                    items.append(self._expr())
                    while self.accept("op", ","):
                        items.append(self._expr())
                self.expect("op", "]")
                return ast.ArrayLit(items)
            # single-parameter lambda: x -> expr (function-argument only)
            if self.peek(1).kind == "op" and self.peek(1).value == "->":
                param = self.next().value
                self.next()  # ->
                return ast.Lambda([param], self._expr())
            # typed literal: TIMESTAMP '...' (TIMESTAMP stays an ident so
            # columns may use the name)
            if t.value.lower() == "timestamp" and self.peek(1).kind == "string":
                self.next()
                s = self.expect("string")
                return ast.TimestampLit(s.value)
            # function call?
            if self.peek(1).kind == "op" and self.peek(1).value == "(":
                name = self.next().value
                self.next()  # (
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    return self._maybe_window(ast.FuncCall(name, [], is_star=True))
                distinct = bool(self.kw("distinct"))
                args = []
                if self.peek().value != ")":
                    args.append(self._expr())
                    while self.accept("op", ","):
                        args.append(self._expr())
                self.expect("op", ")")
                fc = ast.FuncCall(name, args, distinct=distinct)
                return self._maybe_window(fc)
            parts = [self.next().value]
            while self.accept("op", "."):
                parts.append(self.expect("ident").value)
            return ast.Identifier(parts)
        raise SyntaxError(f"unexpected token {t.kind}:{t.value!r}")

    def _maybe_window(self, fc: ast.FuncCall) -> ast.Expr:
        if not self.kw("over"):
            return fc
        self.expect("op", "(")
        partition = []
        if self.kw("partition"):
            self.expect("kw", "by")
            partition.append(self._expr())
            while self.accept("op", ","):
                partition.append(self._expr())
        order = []
        if self.kw("order"):
            self.expect("kw", "by")
            order.append(self._order_item())
            while self.accept("op", ","):
                order.append(self._order_item())
        frame = None
        unit = None
        for u in ("rows", "range", "groups"):
            if self.kw(u):
                unit = u
                break
        if unit is not None:
            if self.kw("between"):
                s_kind, s_val = self._frame_bound()
                self.expect("kw", "and")
                e_kind, e_val = self._frame_bound()
            else:
                s_kind, s_val = self._frame_bound()
                e_kind, e_val = "c", None
            frame = (unit, s_kind, s_val, e_kind, e_val)
        self.expect("op", ")")
        return ast.WindowCall(fc.name, fc.args, partition, order,
                              is_star=fc.is_star, frame=frame)

    def _frame_bound(self):
        """UNBOUNDED PRECEDING|FOLLOWING / CURRENT ROW / <n> PRECEDING|FOLLOWING"""
        if self.kw("unbounded"):
            if self.kw("preceding"):
                return "up", None
            self.expect("kw", "following")
            return "uf", None
        if self.kw("current"):
            self.expect("kw", "row")
            return "c", None
        t = self.expect("number")
        v = int(t.value)
        if self.kw("preceding"):
            return "p", v
        self.expect("kw", "following")
        return "f", v

    def _case(self) -> ast.Expr:
        self.expect("kw", "case")
        operand = None
        if self.peek().value != "when":
            operand = self._expr()
        whens = []
        while self.kw("when"):
            c = self._expr()
            self.expect("kw", "then")
            v = self._expr()
            whens.append((c, v))
        else_ = self._expr() if self.kw("else") else None
        self.expect("kw", "end")
        return ast.Case(whens, else_, operand)


def parse(sql: str) -> ast.Query:
    return Parser(sql).parse_query()


def parse_statement(sql: str):
    return Parser(sql).parse_statement()
