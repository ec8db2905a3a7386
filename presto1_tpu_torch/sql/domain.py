"""Column value domains — the TupleDomain analog.

The reference models pushable predicates as ``spi/predicate/TupleDomain``
(per-column ``Domain`` = ``SortedRangeSet``/``EquatableValueSet`` +
null-allowed flag) and threads them into connectors for split/row-group
pruning and into the dynamic-filter service.  Here the same contract is a
small frozen value object extracted from conjunct IR:

* ``Domain``: one inclusive range [lo, hi] (either end open) OR a discrete
  IN-set, plus ``null_allowed``.  A single range (vs the reference's full
  multi-range SortedRangeSet) covers every pruning consumer in this
  engine; OR-of-ranges simply widens to the hull, which is always sound
  for pruning (may-match can only over-approximate).
* ``TupleDomain``: {column -> Domain} with intersection; ``NONE`` marks a
  provably-empty relation.
* ``domains_from_conjuncts``: extracts domains from filter conjuncts
  (``col <op> literal``, BETWEEN-lowered pairs, IN lists, IS [NOT] NULL),
  used by the optimizer to annotate scans and by distributed dynamic
  filtering to describe build-side key sets.

Values are the engine's literal representations (ints, floats, strings,
DATE as epoch days); consumers that meet other stat encodings normalise
before comparing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..expr import ir

_CMP_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}


@dataclass(frozen=True)
class Domain:
    lo: Optional[object] = None       # inclusive lower bound
    hi: Optional[object] = None       # inclusive upper bound
    values: Optional[frozenset] = None  # discrete set (None = use range)
    null_allowed: bool = False
    empty: bool = False

    @staticmethod
    def all() -> "Domain":
        return Domain(null_allowed=True)

    @staticmethod
    def none() -> "Domain":
        return Domain(empty=True)

    def is_all(self) -> bool:
        return (not self.empty and self.lo is None and self.hi is None
                and self.values is None and self.null_allowed)

    def intersect(self, other: "Domain") -> "Domain":
        if self.empty or other.empty:
            return Domain.none()
        na = self.null_allowed and other.null_allowed
        a, b = self, other
        if a.values is not None or b.values is not None:
            if a.values is not None and b.values is not None:
                vs = a.values & b.values
            else:
                vs, rng = (a.values, b) if a.values is not None else (b.values, a)
                vs = frozenset(v for v in vs if rng._range_contains(v))
            if not vs and not na:
                return Domain.none()
            return Domain(values=vs, null_allowed=na)
        lo = a.lo if b.lo is None else (b.lo if a.lo is None else max(a.lo, b.lo))
        hi = a.hi if b.hi is None else (b.hi if a.hi is None else min(a.hi, b.hi))
        if lo is not None and hi is not None and lo > hi:
            return Domain.none() if not na else Domain(
                values=frozenset(), null_allowed=True)
        return Domain(lo=lo, hi=hi, null_allowed=na)

    def _range_contains(self, v) -> bool:
        if self.lo is not None and v < self.lo:
            return False
        if self.hi is not None and v > self.hi:
            return False
        return True

    def may_match(self, stat_min, stat_max, has_nulls: bool) -> bool:
        """Could ANY row summarised by [stat_min, stat_max] (+nulls) satisfy
        this domain?  The row-group pruning predicate — must never return a
        false negative; unknown stats (None) always may-match."""
        if self.empty:
            return has_nulls and self.null_allowed
        if has_nulls and self.null_allowed:
            return True
        if stat_min is None or stat_max is None:
            return True
        if self.values is not None:
            return any(stat_min <= v <= stat_max for v in self.values)
        if self.lo is not None and stat_max < self.lo:
            return False
        if self.hi is not None and stat_min > self.hi:
            return False
        return True

    def hull(self) -> Tuple[Optional[object], Optional[object]]:
        """(lo, hi) over-approximation (for wire transport of DF domains)."""
        if self.values is not None:
            if not self.values:
                return (None, None)
            return (min(self.values), max(self.values))
        return (self.lo, self.hi)


class TupleDomain:
    """{column -> Domain}; absence of a column means Domain.all()."""

    def __init__(self, domains: Optional[Dict[str, Domain]] = None,
                 none: bool = False):
        self.domains: Dict[str, Domain] = dict(domains or {})
        self.none = none

    @staticmethod
    def all() -> "TupleDomain":
        return TupleDomain()

    def is_all(self) -> bool:
        return not self.none and not self.domains

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        if self.none or other.none:
            return TupleDomain(none=True)
        out = dict(self.domains)
        for c, d in other.domains.items():
            nd = out[c].intersect(d) if c in out else d
            if nd.empty and not nd.null_allowed:
                return TupleDomain(none=True)
            out[c] = nd
        return TupleDomain(out)

    def get(self, column: str) -> Domain:
        return self.domains.get(column, Domain.all())

    def rename(self, mapping: Dict[str, str]) -> "TupleDomain":
        return TupleDomain(
            {mapping[c]: d for c, d in self.domains.items() if c in mapping},
            none=self.none)

    def fingerprint(self):
        """Hashable identity (cache key for pruned-scan views)."""
        return (self.none, tuple(sorted(
            (c, repr(d.lo), repr(d.hi),
             None if d.values is None else tuple(sorted(map(repr, d.values))),
             d.null_allowed, d.empty)
            for c, d in self.domains.items())))

    def __eq__(self, other):
        return isinstance(other, TupleDomain) \
            and self.fingerprint() == other.fingerprint()

    def __hash__(self):
        return hash(self.fingerprint())

    def __repr__(self):
        if self.none:
            return "TupleDomain(NONE)"
        return f"TupleDomain({self.domains!r})"

    def to_json(self):
        return {"none": self.none, "domains": {
            c: {"lo": d.lo, "hi": d.hi,
                "values": None if d.values is None else sorted(d.values),
                "null_allowed": d.null_allowed, "empty": d.empty}
            for c, d in self.domains.items()}}

    @staticmethod
    def from_json(j) -> "TupleDomain":
        return TupleDomain(
            {c: Domain(lo=d["lo"], hi=d["hi"],
                       values=None if d["values"] is None
                       else frozenset(d["values"]),
                       null_allowed=d["null_allowed"], empty=d["empty"])
             for c, d in j["domains"].items()},
            none=j["none"])


_NUMERIC = ("bigint", "integer", "smallint", "tinyint", "double", "real")


def _literal_value(e: ir.Expr, column: Optional[ir.ColumnRef] = None):
    """A literal's value in the unit ``column`` stores, which its
    statistics report too: a decimal column's unscaled integer at its own
    scale, a decimal literal against any other numeric column as the number
    it means.  The JAX package keeps the literal's own unit, so a double
    column's ``between 0.05 and 0.07`` prunes every row group whose values
    lie outside [5, 7] (ROADMAP C28)."""
    if not isinstance(e, ir.Literal):
        return None
    v = e.value
    if v is None or column is None:
        return v
    lt, ct = e.type, column.type
    if lt.kind == "decimal" and ct.kind == "decimal":
        shift = ct.scale - lt.scale
        return v * 10 ** shift if shift >= 0 else v / 10 ** -shift
    if lt.kind == "decimal" and ct.kind in _NUMERIC:
        return v / 10 ** lt.scale
    if ct.kind == "decimal" and lt.kind in _NUMERIC:
        return v * 10 ** ct.scale
    return v


def domain_from_conjunct(c: ir.Expr) -> Optional[Tuple[str, Domain]]:
    """(column, Domain) if the conjunct constrains exactly one column by
    literals; None otherwise (conjunct stays a residual filter)."""
    if not isinstance(c, ir.Call):
        return None
    fn, args = c.fn, c.args
    if fn == "is_null" and isinstance(args[0], ir.ColumnRef):
        return args[0].name, Domain(values=frozenset(), null_allowed=True)
    if fn == "not" and isinstance(args[0], ir.Call) \
            and args[0].fn == "is_null" \
            and isinstance(args[0].args[0], ir.ColumnRef):
        return args[0].args[0].name, Domain(null_allowed=False)
    if fn == "in" and isinstance(args[0], ir.ColumnRef):
        vals = [_literal_value(a, args[0]) for a in args[1:]]
        if any(v is None for v in vals):
            return None
        return args[0].name, Domain(values=frozenset(vals))
    if fn in _CMP_FLIP:
        a, b = args
        if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
            a, b = b, a
            fn = _CMP_FLIP[fn]
        if not (isinstance(a, ir.ColumnRef) and isinstance(b, ir.Literal)):
            return None
        v = _literal_value(b, a)
        if v is None:
            return a.name, Domain.none()
        if fn == "=":
            return a.name, Domain(lo=v, hi=v)
        if fn == "<":
            return a.name, Domain(hi=v)   # hull: open bound widened
        if fn == "<=":
            return a.name, Domain(hi=v)
        if fn == ">":
            return a.name, Domain(lo=v)
        if fn == ">=":
            return a.name, Domain(lo=v)
    return None


def domains_from_conjuncts(conjuncts: List[ir.Expr]) -> TupleDomain:
    """Extract the TupleDomain implied by AND-ed conjuncts over symbol
    names.  Conservative: conjuncts it cannot model contribute nothing
    (pruning stays sound because every conjunct is still evaluated)."""
    td = TupleDomain.all()
    for c in conjuncts:
        got = domain_from_conjunct(c)
        if got is None:
            continue
        col, d = got
        td = td.intersect(TupleDomain({col: d}))
    return td
