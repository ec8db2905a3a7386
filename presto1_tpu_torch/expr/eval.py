"""Expression evaluation: eager torch ops with SQL three-valued logic.

This module is the engine's "codegen": where the reference compiles
RowExpressions to JVM bytecode per query (``sql/gen/PageFunctionCompiler.java``,
``sql/gen/ExpressionCompiler.java``), the IR is evaluated with tensor ops on
the batch's device.  Eager execution fuses nothing, so a fragment whose whole
shape is known (range filter + product sum) is routed past this evaluator to a
hand-written kernel by the executor; everything else runs here one op at a
time.

Null handling follows SQL 3VL (Kleene AND/OR), mirroring the reference's
null-propagation conventions.  Invalid lanes are normalised to zero so
garbage never leaks into downstream arithmetic.

String expressions never reach the device: `bind_string_ops` folds any
subtree over a single varchar column into a DictLookup -- a host-evaluated
table over the column's sorted dictionary, gathered on device.  This is the
replacement for Trino's per-row Slice operations
(``spi/block/VariableWidthBlock.java``).

Values inside the evaluator are tensors on the batch's device; a literal is
a 0-d tensor there.  A 0-d tensor does not take part in torch's type
promotion the way a dimensioned one does, so every place that combines two
values casts both sides to one dtype explicitly first.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..batch import Column, RecordBatch, take_clamped, to_device, torch_dtype
from ..types import DecimalType, SqlType, VARCHAR
from .ir import Call, ColumnRef, DictLookup, Expr, Lambda, Literal, walk

# ------------------------------------------------------------------ values

# Internal value: (data: tensor (0-d for constants), validity: tensor | None)



def _device_of(batch: RecordBatch):
    for c in batch.columns.values():
        return c.data.device
    return torch.device("cpu")


def _same_dtype(a, b):
    """Both values in their common dtype (0-d values count in full)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a, b


def _where(cond, a, b):
    a, b = _same_dtype(a, b)
    return torch.where(cond, a, b)


def _norm(data, validity):
    """Zero out invalid lanes so they can't poison later arithmetic."""
    if validity is None:
        return data
    if data.dtype == torch.bool:
        return data & validity
    return torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))


def _and_validity(va, vb):
    if va is None:
        return vb
    if vb is None:
        return va
    return va & vb


def _scale_of(t: SqlType) -> int:
    return t.scale if t.kind == "decimal" else 0  # type: ignore[attr-defined]


# HyperLogLog precision for approx_distinct: m = 2^11 = 2048 registers,
# standard error 1.04/sqrt(m) ~ 2.3% -- Trino's default
# (operator/aggregation/ApproximateCountDistinctAggregations.java).
HLL_P = 11
HLL_M = 1 << HLL_P


# the splitmix64 multipliers as the int64 values of their bits: an int64
# product wraps exactly as the uint64 one does
_MIX1 = int(np.uint64(0xBF58476D1CE4E5B9).astype(np.int64))
_MIX2 = int(np.uint64(0x94D049BB133111EB).astype(np.int64))


def _lsr(x, k: int):
    """Logical right shift of int64 ``x`` by ``0 < k < 64`` (torch's ``>>``
    on int64 is arithmetic: the sign bits are masked off)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix63(bits):
    """splitmix64 finalizer over int64 bits, masked to 63 bits (nonneg)."""
    x = bits.to(torch.int64)
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    x = x ^ _lsr(x, 31)
    return x & ((1 << 63) - 1)


def _clz64(x):
    """Leading zero bits of int64 ``x`` read as unsigned (64 for 0): a
    binary search over 32 / 16 / 8 / 4 / 2 / 1-bit steps in integer
    shifts.  (A float64 ``log2`` rounds ``2**k - 1`` up to ``k`` for large
    ``k``.)"""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = _lsr(x, 64 - s) == 0
        n = n + top_zero.to(torch.int64) * s
        x = torch.where(top_zero, x << s, x)
    return n + (x == 0).to(torch.int64)


def _splitmix63_host(bits: "np.ndarray") -> "np.ndarray":
    with np.errstate(over="ignore"):
        x = bits.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        return (x & np.uint64((1 << 63) - 1)).astype(np.int64)



def _rescale(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    # Round half away from zero, matching the reference's decimal rescale.
    f = 10 ** (from_scale - to_scale)
    return torch.div(data + torch.sign(data) * (f // 2), f,
                     rounding_mode="floor")


def _to_double(data, t: SqlType):
    if t.kind == "decimal":
        return data.to(torch.float64) / (10 ** _scale_of(t))
    return data.to(torch.float64)


# ------------------------------------------------------------------ eval


class _Nested:
    """Array/map value inside the evaluator: [n, W] element matrix +
    per-row lengths (+ aligned value matrix for maps)."""

    __slots__ = ("data", "lengths", "map_values")

    def __init__(self, data, lengths, map_values=None):
        self.data = data
        self.lengths = lengths
        self.map_values = map_values


def eval_expr(expr: Expr, batch: RecordBatch) -> Column:
    data, validity, dictionary = _eval(expr, batch)
    if isinstance(data, _Nested):
        return Column(data.data, expr.type, validity=validity,
                      dictionary=dictionary, lengths=data.lengths,
                      map_values=data.map_values)
    n = batch.capacity()
    if data.dim() == 0:
        data = data.to(torch_dtype(expr.type)).expand(n).contiguous()
    return Column(data, expr.type, validity=validity, dictionary=dictionary)


def eval_predicate(expr: Expr, batch: RecordBatch) -> torch.Tensor:
    """WHERE semantics: NULL counts as false."""
    c = eval_expr(expr, batch)
    mask = c.data
    if c.validity is not None:
        mask = mask & c.validity
    return mask


def _eval(expr: Expr, batch: RecordBatch):
    if isinstance(expr, Literal):
        dev = _device_of(batch)
        if expr.value is None:  # typed NULL (grouping sets, defaults)
            n = batch.capacity()
            t = expr.type
            dt = torch.int64 if t.kind == "decimal" else torch_dtype(t)
            dic = np.empty(0, dtype="U1") if t.is_string else None
            return (torch.zeros((n,), dtype=dt, device=dev),
                    torch.zeros((n,), dtype=torch.bool, device=dev), dic)
        if expr.type.is_string and isinstance(expr.value, str):
            # constant varchar: a one-entry dictionary, code 0 everywhere
            return (torch.zeros((), dtype=torch.int32, device=dev), None,
                    np.asarray([expr.value]))
        return _literal_value(expr, dev), None, None
    if isinstance(expr, ColumnRef):
        c = batch[expr.name]
        if c.lengths is not None:
            return (_Nested(c.data, c.lengths, c.map_values), c.validity,
                    c.dictionary)
        return c.data, c.validity, c.dictionary
    if isinstance(expr, DictLookup):
        c = batch[expr.column.name]
        dev = c.data.device
        table = _on_device(expr.table, dev)
        overflow = len(expr.table) - 1
        codes = torch.where((c.data >= 0) & (c.data < overflow), c.data,
                            torch.full((), overflow, dtype=c.data.dtype,
                                       device=dev))
        data = take_clamped(table, codes)
        validity = c.validity
        if expr.valid_table is not None:  # NULL-bearing fold
            ve = take_clamped(_on_device(expr.valid_table, dev), codes)
            validity = ve if validity is None else (validity & ve)
        return _norm(data, validity), validity, expr.dictionary
    if isinstance(expr, Call):
        return _eval_call(expr, batch)
    raise TypeError(f"cannot evaluate {expr}")


def _on_device(table, device) -> torch.Tensor:
    """A DictLookup table as a tensor on ``device`` (a host table is
    uploaded; `lookups_on_device` does that once per plan)."""
    if isinstance(table, torch.Tensor):
        return table.to(device)
    return to_device(table, device)


def _literal_value(expr: Literal, device):
    t = expr.type
    if t.kind == "decimal":
        return torch.full((), int(expr.value), dtype=torch.int64,
                          device=device)
    if t.is_string:
        raise TypeError(
            "string literal reached device evaluation -- bind_string_ops "
            f"should have folded it ({expr.value!r})"
        )
    return torch.full((), expr.value, dtype=torch_dtype(t), device=device)


def _eval_call(expr: Call, batch: RecordBatch):
    fn = expr.fn

    if fn in ("and", "or"):
        a, va, _ = _eval(expr.args[0], batch)
        b, vb, _ = _eval(expr.args[1], batch)
        if fn == "and":
            data = a & b
            if va is None and vb is None:
                return data, None, None
            ta = a if va is None else (a & va)
            tb = b if vb is None else (b & vb)
            fa = (~a) if va is None else ((~a) & va)
            fb = (~b) if vb is None else ((~b) & vb)
            validity = (ta & tb) | fa | fb  # known unless an unknown survives
            return _norm(data, validity), validity, None
        else:
            data = a | b
            if va is None and vb is None:
                return data, None, None
            ta = a if va is None else (a & va)
            tb = b if vb is None else (b & vb)
            fa = (~a) if va is None else ((~a) & va)
            fb = (~b) if vb is None else ((~b) & vb)
            validity = (fa & fb) | ta | tb
            return _norm(data, validity), validity, None

    if fn == "not":
        a, va, _ = _eval(expr.args[0], batch)
        return _norm(~a, va), va, None

    if fn == "is_null":
        _, va, _ = _eval(expr.args[0], batch)
        n = batch.capacity()
        if va is None:
            return (torch.zeros((n,), dtype=torch.bool,
                                device=_device_of(batch)), None, None)
        return ~va, None, None

    if fn == "__mask":
        # __mask(value, cond): value with validity &= cond -- the aggregate
        # mask carrier for MarkDistinct rewrites (NULL rows don't count)
        data, va, d = _eval(expr.args[0], batch)
        cond, vc, _ = _eval(expr.args[1], batch)
        keep = cond if vc is None else (cond & vc)
        validity = keep if va is None else (va & keep)
        return _norm(data, validity), validity, d

    if fn == "coalesce":
        data, validity, d = _eval(expr.args[0], batch)
        for a in expr.args[1:]:
            if validity is None:
                break
            db, vb, _ = _eval(a, batch)
            data = _where(validity, data, db)
            validity = validity | (torch.ones_like(validity) if vb is None else vb)
        return _norm(data, validity), validity, d

    if fn == "case":
        # args = [c1, v1, c2, v2, ..., else]
        args = expr.args
        out_t = expr.type
        data, validity, _ = _eval_coerced(args[-1], batch, out_t)
        n = batch.capacity()
        dev = _device_of(batch)
        if validity is None:
            validity = torch.ones((n,), dtype=torch.bool, device=dev)
        for i in range(len(args) - 3, -1, -2):
            cond, vc, _ = _eval(args[i], batch)
            val, vv, _ = _eval_coerced(args[i + 1], batch, out_t)
            take = cond if vc is None else (cond & vc)
            data = _where(take, val, data)
            vv_arr = (torch.ones((n,), dtype=torch.bool, device=dev)
                      if vv is None else vv)
            validity = torch.where(take, vv_arr, validity)
        return _norm(data, validity), validity, None

    if fn == "in":
        child, vc, _ = _eval(expr.args[0], batch)
        t = expr.args[0].type
        hits = None
        for a in expr.args[1:]:
            av, _, _ = _eval_coerced(a, batch, t)
            h = torch.eq(*_same_dtype(child, av))
            hits = h if hits is None else (hits | h)
        return _norm(hits, vc), vc, None

    if fn == "cast":
        return _eval_cast(expr, batch)

    if fn in ("=", "<>", "<", "<=", ">", ">="):
        return _eval_compare(expr, batch)

    if fn in ("+", "-", "*", "/", "min2", "max2"):
        return _eval_arith(expr, batch)

    if fn == "neg":
        a, va, _ = _eval(expr.args[0], batch)
        return _norm(-a, va), va, None

    if fn == "abs":
        a, va, _ = _eval(expr.args[0], batch)
        return _norm(torch.abs(a), va), va, None

    if fn.startswith("extract_") or fn in ("date_trunc", "date_add",
                                          "date_diff"):
        return _eval_datetime(expr, batch)

    if fn in _NUMERIC_FNS:
        return _eval_numeric(expr, batch)

    if fn in _ARRAY_FNS:
        return _eval_array_fn(expr, batch)

    if fn == "__hll_hash":
        # 63-bit avalanche hash of the value's int64 bits (splitmix64) --
        # the register/rho source for approx_distinct's HLL sketch.
        # Strings never reach here: they fold through the dictionary
        # (host hash_strings_host), so the hash is value-based.
        a, va, _ = _eval(expr.args[0], batch)
        if expr.args[0].type.kind in ("double", "real"):
            bits = a.to(torch.float64).view(torch.int64)
        else:
            bits = a.to(torch.int64)
        return _norm(_splitmix63(bits), va), va, None

    if fn == "__hll_reg":  # low HLL_P bits -> register index
        a, va, _ = _eval(expr.args[0], batch)
        return _norm(a & (HLL_M - 1), va), va, None

    if fn == "__hll_rho":  # leading-zero run of the remaining bits, +1
        a, va, _ = _eval(expr.args[0], batch)
        w = a.to(torch.int64) >> HLL_P  # 63-HLL_P significant bits
        return _norm(_clz64(w) - HLL_P, va), va, None

    if fn in ("like", "substring", "||"):
        raise TypeError(
            f"string op '{fn}' reached device evaluation -- run bind_string_ops first"
        )
    raise NotImplementedError(f"function {fn}")


_ARRAY_FNS = frozenset((
    "array_ctor", "cardinality", "element_at", "contains", "array_position",
    "array_min", "array_max", "transform", "filter", "any_match",
    "all_match", "none_match", "map", "map_keys", "map_values",
    "array_concat"))

_MICROS = {"millisecond": 1_000, "second": 1_000_000,
           "minute": 60_000_000, "hour": 3_600_000_000}


def _fdiv(a, b):
    """Floor division (Python's ``//``), also for negative day numbers."""
    return torch.div(a, b, rounding_mode="floor")


def _eval_datetime(expr: Call, batch: RecordBatch):
    """``extract_*``, ``date_trunc``, ``date_add`` and ``date_diff`` over
    dates (int32 days) and timestamps (int64 micros; a timestamptz column
    reads its civil fields in its zone).  Every value is widened to int64
    before the civil arithmetic."""
    from ..types import MICROS_PER_DAY

    fn = expr.fn
    if fn.startswith("extract_"):
        raw, va, _ = _eval(expr.args[0], batch)
        raw = raw.to(torch.int64)
        kind = expr.args[0].type.kind
        if kind == "timestamptz":  # civil fields read in the zone
            raw = raw + expr.args[0].type.offset_micros
        if kind in ("timestamp", "timestamptz"):
            days = _fdiv(raw, MICROS_PER_DAY)
            tod = raw - days * MICROS_PER_DAY  # micros within the day
        else:
            days, tod = raw, None
        field = fn[len("extract_"):]
        if field in ("hour", "minute", "second", "millisecond"):
            if tod is None:
                tod = torch.zeros_like(days)
            if field == "hour":
                out = _fdiv(tod, 3_600_000_000)
            elif field == "minute":
                out = torch.remainder(_fdiv(tod, 60_000_000), 60)
            elif field == "second":
                out = torch.remainder(_fdiv(tod, 1_000_000), 60)
            else:
                out = torch.remainder(_fdiv(tod, 1_000), 1000)
            return _norm(out, va), va, None
        y, m, dom = _civil_full(days)
        if field == "year":
            out = y
        elif field == "month":
            out = m
        elif field == "day":
            out = dom
        elif field == "quarter":
            out = _fdiv(m - 1, 3) + 1
        elif field in ("dow", "day_of_week"):  # ISO: 1=Monday..7=Sunday
            out = torch.remainder(days + 3, 7) + 1
        elif field in ("doy", "day_of_year", "week", "week_of_year"):
            one = torch.ones_like(m)
            doy = days - _days_from_civil(y, one, one) + 1
            if field in ("doy", "day_of_year"):
                out = doy
            else:  # ISO week number
                dow = torch.remainder(days + 3, 7) + 1
                wk = _fdiv(doy - dow + 10, 7)
                out = torch.where(wk < 1, _weeks_in(y - 1),
                                  torch.where(wk > _weeks_in(y), 1, wk))
        else:
            raise NotImplementedError(f"extract({field})")
        return _norm(out.to(torch.int64), va), va, None

    unit = expr.args[0].value  # a constant varchar
    if fn == "date_trunc":
        raw, va, _ = _eval(expr.args[1], batch)
        raw = raw.to(torch.int64)
        tkind = expr.args[1].type.kind
        is_ts = tkind in ("timestamp", "timestamptz")
        # truncate in the zone's civil frame, then shift back to UTC
        off = (expr.args[1].type.offset_micros
               if tkind == "timestamptz" else 0)
        raw = raw + off
        if is_ts and unit in _MICROS:
            step = _MICROS[unit]
            return _norm(_fdiv(raw, step) * step - off, va), va, None
        days = _fdiv(raw, MICROS_PER_DAY) if is_ts else raw
        y, m, _ = _civil_full(days)
        one = torch.ones_like(m)
        if unit == "day":
            out = days
        elif unit == "week":  # Monday
            out = days - torch.remainder(days + 3, 7)
        elif unit == "month":
            out = _days_from_civil(y, m, one)
        elif unit == "quarter":
            out = _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif unit == "year":
            out = _days_from_civil(y, one, one)
        else:
            raise NotImplementedError(f"date_trunc({unit})")
        if is_ts:
            return _norm(out * MICROS_PER_DAY - off, va), va, None
        return _norm(out.to(torch.int32), va), va, None

    if fn == "date_add":
        n, vn, _ = _eval(expr.args[1], batch)
        raw, va, _ = _eval(expr.args[2], batch)
        raw = raw.to(torch.int64)
        n = n.to(torch.int64)
        is_ts = expr.args[2].type.kind == "timestamp"
        v = _and_validity(vn, va)
        if is_ts and unit in _MICROS:
            return _norm(raw + n * _MICROS[unit], v), v, None
        if is_ts:
            days = _fdiv(raw, MICROS_PER_DAY)
            tod = raw - days * MICROS_PER_DAY
        else:
            days, tod = raw, None
        if unit == "day":
            out = days + n
        elif unit == "week":
            out = days + 7 * n
        elif unit in ("month", "year"):
            y, m, dom = _civil_full(days)
            months = y * 12 + (m - 1) + (n if unit == "month" else 12 * n)
            y2 = _fdiv(months, 12)
            m2 = months - y2 * 12 + 1
            # clamp the day to the target month's length
            last = _days_from_civil(
                torch.where(m2 == 12, y2 + 1, y2),
                torch.where(m2 == 12, 1, m2 + 1),
                torch.ones_like(m2)) - 1
            out = torch.minimum(_days_from_civil(y2, m2, dom), last)
        else:
            raise NotImplementedError(f"date_add({unit})")
        if is_ts:
            return _norm(out * MICROS_PER_DAY + tod, v), v, None
        return _norm(out.to(torch.int32), v), v, None

    # date_diff
    a, va, _ = _eval(expr.args[1], batch)
    b, vb, _ = _eval(expr.args[2], batch)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    ta = expr.args[1].type.kind
    tb = expr.args[2].type.kind
    v = _and_validity(va, vb)
    if "timestamp" in (ta, tb):
        ua = a * MICROS_PER_DAY if ta == "date" else a
        ub = b * MICROS_PER_DAY if tb == "date" else b
        if unit in _MICROS:
            return _norm(_fdiv(ub - ua, _MICROS[unit]), v), v, None
        a = _fdiv(ua, MICROS_PER_DAY)
        b = _fdiv(ub, MICROS_PER_DAY)
    if unit == "day":
        out = b - a
    elif unit == "week":
        out = _fdiv(b - a, 7)
    elif unit in ("month", "year"):
        y1, m1, d1 = _civil_full(a)
        y2, m2, d2 = _civil_full(b)
        months = (y2 * 12 + m2) - (y1 * 12 + m1) - (d2 < d1).to(torch.int64)
        out = months if unit == "month" else _fdiv(months, 12)
    else:
        raise NotImplementedError(f"date_diff({unit})")
    return _norm(out.to(torch.int64), v), v, None


def _weeks_in(y):
    """ISO weeks (52 or 53) of year ``y``."""
    p = torch.remainder(y + _fdiv(y, 4) - _fdiv(y, 100) + _fdiv(y, 400), 7)
    py = y - 1
    pp = torch.remainder(py + _fdiv(py, 4) - _fdiv(py, 100)
                         + _fdiv(py, 400), 7)
    return 52 + ((p == 4) | (pp == 3)).to(torch.int64)


def _civil_full(days):
    """days-since-epoch -> (year, month, day-of-month), int64; Howard
    Hinnant's civil_from_days."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> days-since-epoch (Hinnant's days_from_civil)."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY_DOUBLE = {
    "sqrt": torch.sqrt, "ln": torch.log, "exp": torch.exp,
    "log2": torch.log2, "log10": torch.log10, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "cbrt": _cbrt,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "truncate": torch.trunc, "is_nan": torch.isnan,
    "is_finite": torch.isfinite, "is_infinite": torch.isinf,
}
_NUMERIC_FNS = set(_UNARY_DOUBLE) | {
    "floor", "ceil", "round", "power", "atan2", "log", "sign", "mod",
    "nullif", "greatest", "least"}


def _eval_numeric(expr: Call, batch: RecordBatch):
    """The numeric scalar functions.  Decimal inputs keep their scaled
    integers where the reference does (floor / ceil, round, sign, mod);
    the transcendental family reads them as doubles."""
    fn = expr.fn
    if fn in _UNARY_DOUBLE:
        a, va, _ = _eval(expr.args[0], batch)
        out = _UNARY_DOUBLE[fn](_to_double(a, expr.args[0].type))
        return _norm(out, va), va, None

    if fn in ("floor", "ceil"):
        a, va, _ = _eval(expr.args[0], batch)
        t = expr.args[0].type
        if t.kind == "decimal":
            s = 10 ** _scale_of(t)
            out = _fdiv(a, s) if fn == "floor" else -_fdiv(-a, s)
        elif t.kind == "double":
            out = torch.floor(a) if fn == "floor" else torch.ceil(a)
            out = out.to(torch.float64)
        else:
            out = a
        if expr.type.kind == "bigint":
            out = out.to(torch.int64)
        return _norm(out, va), va, None

    if fn == "round":
        a, va, _ = _eval(expr.args[0], batch)
        t = expr.args[0].type
        d = int(expr.args[1].value) if len(expr.args) > 1 else 0
        if t.kind == "decimal":
            out = _rescale(_rescale(a, _scale_of(t), d), d, _scale_of(t))
        else:
            if not a.dtype.is_floating_point:
                a = a.to(torch.float64)
            f = 10.0 ** d
            out = torch.round(a * f) / f
        return _norm(out, va), va, None

    if fn in ("power", "atan2", "log"):
        a, va, _ = _eval(expr.args[0], batch)
        b, vb, _ = _eval(expr.args[1], batch)
        v = _and_validity(va, vb)
        x = _to_double(a, expr.args[0].type)
        y = _to_double(b, expr.args[1].type)
        if fn == "power":
            out = torch.pow(x, y)
        elif fn == "atan2":
            out = torch.atan2(x, y)
        else:  # log(base, x): Trino argument order
            out = torch.log(y) / torch.log(x)
        return _norm(out, v), v, None

    if fn == "sign":
        a, va, _ = _eval(expr.args[0], batch)
        out = torch.sign(a)
        if a.dtype.is_floating_point:  # sign(NaN) is NaN
            out = torch.where(torch.isnan(a), a, out)
        if expr.type.kind == "bigint":
            out = out.to(torch.int64)
        return _norm(out, va), va, None

    if fn == "mod":
        a, b, va, vb, _ = _common_pair(expr.args[0], expr.args[1], batch)
        v = _and_validity(va, vb)
        if a.dtype.is_floating_point:
            out = torch.remainder(a, b)
        else:
            # x mod 0 is 0, as in the reference (NULL lanes hold 0);
            # torch raises on an integer remainder by zero
            zero = b == 0
            out = torch.where(zero, torch.zeros_like(a), torch.remainder(
                a, torch.where(zero, torch.ones_like(b), b)))
        return _norm(out, v), v, None

    if fn == "nullif":
        a, va, _ = _eval(expr.args[0], batch)
        b, vb, _ = _eval_coerced(expr.args[1], batch, expr.args[0].type)
        eq = torch.eq(*_same_dtype(a, b))
        validity = (~eq) if va is None else (va & ~eq)
        return _norm(a, validity), validity, None

    # greatest / least
    op = torch.maximum if fn == "greatest" else torch.minimum
    data, validity, _ = _eval_coerced(expr.args[0], batch, expr.type)
    for arg in expr.args[1:]:
        d2, v2, _ = _eval_coerced(arg, batch, expr.type)
        data = op(*_same_dtype(data, d2))
        validity = _and_validity(validity, v2)
    return _norm(data, validity), validity, None


def _eval_coerced(expr: Expr, batch: RecordBatch, target: SqlType):
    data, validity, d = _eval(expr, batch)
    t = expr.type
    if t == target:
        return data, validity, d
    if target.kind == "double":
        return _to_double(data, t), validity, d
    if target.kind == "decimal":
        if t.kind in ("bigint", "integer", "decimal"):
            return _rescale(
                data.to(torch.int64), _scale_of(t), _scale_of(target)
            ), validity, d
    if target.kind == "bigint":
        return data.to(torch.int64), validity, d
    if target.kind == "integer":
        return data.to(torch.int32), validity, d
    if target.kind == t.kind:
        return data, validity, d
    raise TypeError(f"cannot coerce {t} -> {target}")


def _common_pair(ea: Expr, eb: Expr, batch: RecordBatch):
    from ..types import common_supertype

    a, va, _ = _eval(ea, batch)
    b, vb, _ = _eval(eb, batch)
    ta, tb = ea.type, eb.type
    if ta.is_string or tb.is_string:
        raise TypeError("string comparison reached device evaluation")
    if ta == tb:
        a, b = _same_dtype(a, b)
        return a, b, va, vb, ta
    t = common_supertype(ta, tb)
    if t.kind == "double":
        return _to_double(a, ta), _to_double(b, tb), va, vb, t
    if t.kind == "decimal":
        s = max(_scale_of(ta), _scale_of(tb))
        t = DecimalType(38, s)
        return (
            _rescale(a.to(torch.int64), _scale_of(ta), s),
            _rescale(b.to(torch.int64), _scale_of(tb), s),
            va, vb, t,
        )
    if t.kind == "timestamp":
        # date -> timestamp coercion changes units (days -> micros)
        from ..types import MICROS_PER_DAY

        def to_us(x, tx):
            x = x.to(torch.int64)
            return x * MICROS_PER_DAY if tx.kind == "date" else x

        return to_us(a, ta), to_us(b, tb), va, vb, t
    dt = torch_dtype(t)
    return a.to(dt), b.to(dt), va, vb, t


def _eval_compare(expr: Call, batch: RecordBatch):
    ea, eb = expr.args[0], expr.args[1]
    if {ea.type.kind, eb.type.kind} == {"decimal", "double"}:
        # decimal CMP double: scale the DOUBLE side up by 10^s and compare
        # against the raw scaled int -- equivalent ordering with no f64
        # division over the (possibly join-expanded) decimal column.
        a, va, _ = _eval(ea, batch)
        b, vb, _ = _eval(eb, batch)
        if ea.type.kind == "decimal":
            a = a.to(torch.float64)
            b = b * (10.0 ** _scale_of(ea.type))
        else:
            a = a * (10.0 ** _scale_of(eb.type))
            b = b.to(torch.float64)
    else:
        a, b, va, vb, _ = _common_pair(ea, eb, batch)
    fn = expr.fn
    if fn == "=":
        out = a == b
    elif fn == "<>":
        out = a != b
    elif fn == "<":
        out = a < b
    elif fn == "<=":
        out = a <= b
    elif fn == ">":
        out = a > b
    else:
        out = a >= b
    v = _and_validity(va, vb)
    return _norm(out, v), v, None


def _eval_arith(expr: Call, batch: RecordBatch):
    fn = expr.fn
    ea, eb = expr.args[0], expr.args[1]
    ta, tb = ea.type, eb.type
    out_t = expr.type

    if fn == "*" and out_t.kind == "decimal":
        a, va, _ = _eval(ea, batch)
        b, vb, _ = _eval(eb, batch)
        a = a.to(torch.int64) if ta.kind != "double" else a
        b = b.to(torch.int64) if tb.kind != "double" else b
        v = _and_validity(va, vb)
        return _norm(a * b, v), v, None

    if fn == "/" and (ta.kind == "decimal" or tb.kind == "decimal") and out_t.kind == "double":
        a, va, _ = _eval(ea, batch)
        b, vb, _ = _eval(eb, batch)
        v = _and_validity(va, vb)
        out = _to_double(a, ta) / _to_double(b, tb)
        return _norm(out, v), v, None

    a, b, va, vb, t = _common_pair(ea, eb, batch)
    v = _and_validity(va, vb)
    if fn == "+":
        out = a + b
    elif fn == "-":
        out = a - b
    elif fn == "*":
        out = a * b
    elif fn == "min2":
        out = torch.minimum(a, b)
    elif fn == "max2":
        out = torch.maximum(a, b)
    else:  # '/'
        if t.kind == "real":
            out = a / b  # fp32 division (RealType semantics)
        elif t.kind == "double" or out_t.kind == "double":
            out = _to_double(a, t) / _to_double(b, t)
        else:
            out = torch.div(a, b, rounding_mode="floor")
    if out_t.kind == "double" and out.dtype != torch.float64:
        out = _to_double(out, t)
    return _norm(out, v), v, None


def _eval_cast(expr: Call, batch: RecordBatch):
    child = expr.args[0]
    data, validity, d = _eval(child, batch)
    t, target = child.type, expr.type
    if target.kind == "double":
        return _to_double(data, t), validity, None
    if target.kind == "decimal":
        if t.kind == "double":
            s = 10 ** _scale_of(target)
            return torch.round(data * s).to(torch.int64), validity, None
        return _rescale(data.to(torch.int64), _scale_of(t), _scale_of(target)), validity, None
    if target.kind == "bigint":
        if t.kind == "decimal":
            return _rescale(data, _scale_of(t), 0), validity, None
        return data.to(torch.int64), validity, None
    if target.kind == "integer":
        return data.to(torch.int32), validity, None
    if target.kind == "smallint":
        return data.to(torch.int16), validity, None
    if target.kind == "tinyint":
        return data.to(torch.int8), validity, None
    if target.kind == "real":
        return _to_double(data, t).to(torch.float32), validity, None
    if target.kind == "timestamp":
        from ..types import MICROS_PER_DAY

        if t.kind == "date":
            return (data.to(torch.int64) * MICROS_PER_DAY, validity, None)
        if t.kind == "timestamp":
            return data, validity, None
        if t.kind == "timestamptz":
            # the LOCAL civil timestamp in the column's zone
            return data + t.offset_micros, validity, None
    if target.kind == "timestamptz":
        from ..types import MICROS_PER_DAY

        # naive values are session-zone (= UTC) instants, so these casts
        # are instant-preserving; the target offset is display metadata
        if t.kind == "date":
            return (data.to(torch.int64) * MICROS_PER_DAY, validity,
                    None)
        if t.kind in ("timestamp", "timestamptz"):
            return data, validity, None
    if target.kind == "date" and t.kind in ("timestamp", "timestamptz"):
        from ..types import MICROS_PER_DAY

        local = data if t.kind == "timestamp" else data + t.offset_micros
        return (torch.div(local, MICROS_PER_DAY, rounding_mode="floor")
                .to(torch.int32), validity, None)
    if target.is_string and t.is_string:
        if (target.kind == "varbinary") == (t.kind == "varbinary"):
            return data, validity, d  # char <-> varchar share codes
        return _recode(data, validity, d, t, target)
    if target.kind == t.kind:
        return data, validity, d
    raise TypeError(f"cast {t} -> {target} unsupported on device")


def _recoded_strings(values, source: SqlType, target: SqlType) -> np.ndarray:
    """A string cast's dictionary entries: varchar / char -> varbinary
    encodes each as UTF-8 (as ``to_utf8``; a varbinary entry is the latin-1
    image of its bytes), varbinary -> varchar / char decodes each (as
    ``from_utf8``, an invalid sequence replaced), and char <-> varchar
    keeps them.  The JAX package keeps them in every case, so that
    ``cast('é' as varbinary)`` is ``b'\\xe9'`` there (ROADMAP C25)."""
    values = np.asarray(values, dtype=str)
    if target.kind == "varbinary" and source.kind != "varbinary":
        return np.array([v.encode("utf-8").decode("latin-1")
                         for v in values], dtype=str)
    if source.kind == "varbinary" and target.kind != "varbinary":
        return np.array([v.encode("latin-1").decode("utf-8",
                                                    errors="replace")
                         for v in values], dtype=str)
    return values


def _recode(data, validity, d, source: SqlType, target: SqlType):
    """A cast between varbinary and the text kinds on the device: the
    dictionary rewritten on the host (``_recoded_strings``), and the codes
    remapped where two entries became one string, so that equal strings
    keep one code."""
    if d is None:
        raise TypeError(f"cast {source} -> {target}: no dictionary")
    entries = _recoded_strings(d, source, target)
    new_dict, inverse = np.unique(entries, return_inverse=True)
    if len(new_dict) == len(entries) and np.array_equal(new_dict, entries):
        return data, validity, new_dict
    table = to_device(inverse.astype(np.int32), data.device)
    codes = take_clamped(table, data.reshape(-1).to(torch.int64))
    return codes.reshape(data.shape), validity, new_dict  # 0-d: a constant


# ------------------------------------------------------------ array/map fns


def _lane_mask(lengths, w: int):
    return (torch.arange(w, dtype=torch.int32, device=lengths.device)[None, :]
            < lengths[:, None])


def _full_rows(x, n: int):
    """A value as ``[n]``: a 0-d constant broadcast, a column as is."""
    return x.expand(n).contiguous() if x.dim() == 0 else x


def _take_lane(matrix, lane):
    """``matrix[i, lane[i]]`` for every row (lanes clamped), through the
    gather kernel's ``take_along_axis``; zeros for a zero-width matrix."""
    from ..ops.kernels.gather import take_along_axis

    if matrix.shape[1] == 0:
        return matrix.new_zeros((matrix.shape[0],))
    return take_along_axis(matrix.contiguous(),
                           lane.to(torch.int64)[:, None].contiguous(),
                           axis=1)[:, 0]


def _first_hit(hit):
    """(any lane hit, the first hit lane) per row of a bool ``[n, W]``."""
    found = torch.any(hit, dim=1)
    if hit.shape[1] == 0:
        return found, torch.zeros((hit.shape[0],), dtype=torch.int64,
                                  device=hit.device)
    return found, torch.argmax(hit.to(torch.int8), dim=1)


def _eval_array_fn(expr: Call, batch: RecordBatch):
    """Array/map function family over the padded [n, W] representation
    (reference: ``operator/scalar/Array*Function.java``, ``MapKeys``,
    ``ArrayTransformFunction`` -- lambda bodies re-enter the scalar
    evaluator over the flattened element space, the tensor analog of the
    reference's compiled lambda bytecode).  Lookups of one lane a row
    (``element_at``, subscripts, map lookups) read the element matrix
    through the gather kernel's ``take_along_axis``; a lambda's outer
    columns repeat through one ``gather_rows`` launch."""
    fn = expr.fn
    n = batch.capacity()
    dev = _device_of(batch)

    def nested(i):
        d, v, dic = _eval(expr.args[i], batch)
        assert isinstance(d, _Nested), f"{fn}: argument {i} is not nested"
        return d, v, dic

    if fn == "array_ctor":
        vals = []
        dic = None
        for a in expr.args:
            d, _, adic = _eval(a, batch)
            if adic is not None and dic is None:
                dic = adic
            vals.append(_full_rows(d, n))
        if vals:
            dt = vals[0].dtype
            for v in vals[1:]:
                dt = torch.promote_types(dt, v.dtype)
            data = torch.stack([v.to(dt) for v in vals], dim=1)
        else:
            data = torch.zeros((n, 0), dtype=torch.int64, device=dev)
        lengths = torch.full((n,), len(vals), dtype=torch.int32, device=dev)
        return _Nested(data, lengths), None, dic

    if fn == "map":
        kd, kv, kdic = nested(0)
        vd, vv, vdic = nested(1)
        return (_Nested(kd.data, kd.lengths, vd.data),
                _and_validity(kv, vv), kdic if kdic is not None else vdic)

    if fn == "map_keys":
        d, v, dic = nested(0)
        return _Nested(d.data, d.lengths), v, dic

    if fn == "map_values":
        d, v, dic = nested(0)
        return _Nested(d.map_values, d.lengths), v, dic

    if fn == "cardinality":
        d, v, _ = nested(0)
        return _norm(d.lengths.to(torch.int64), v), v, None

    if fn == "array_concat":
        a, va, adic = nested(0)
        b, vb, _ = nested(1)
        rows = a.data.shape[0]
        wa, wb = a.data.shape[1], b.data.shape[1]
        w = wa + wb
        j = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(
            rows, w)
        la = a.lengths[:, None].to(torch.int64)
        from ..ops.kernels.gather import take_along_axis

        dt = torch.promote_types(a.data.dtype, b.data.dtype)
        da = take_along_axis(a.data.to(dt).contiguous(),
                             j.clamp(0, max(wa - 1, 0)).contiguous(),
                             axis=1) if wa \
            else torch.zeros((rows, w), dtype=dt, device=dev)
        db = take_along_axis(b.data.to(dt).contiguous(),
                             (j - la).clamp(0, max(wb - 1, 0)).contiguous(),
                             axis=1) if wb \
            else torch.zeros((rows, w), dtype=dt, device=dev)
        data = torch.where(j < la, da, db)
        return (_Nested(data, a.lengths + b.lengths),
                _and_validity(va, vb), adic)

    if fn == "element_at":
        d, v, dic = nested(0)
        if expr.args[0].type.kind == "map":
            key, kv2, _ = _eval(expr.args[1], batch)
            key, keys = _same_dtype(_full_rows(key, n), d.data)
            hit = (keys == key[:, None]) & _lane_mask(d.lengths,
                                                     d.data.shape[1])
            found, lane = _first_hit(hit)
            out = _take_lane(d.map_values, lane)
            validity = _and_validity(_and_validity(v, kv2), found)
            return _norm(out, validity), validity, dic
        i, iv, _ = _eval(expr.args[1], batch)
        i = _full_rows(i, n).to(torch.int32)
        # 1-based; negative counts from the end (Trino element_at)
        idx = torch.where(i < 0, d.lengths + i, i - 1)
        ok = (idx >= 0) & (idx < d.lengths) & (i != 0)
        out = _take_lane(d.data, idx)
        validity = _and_validity(_and_validity(v, iv), ok)
        return _norm(out, validity), validity, dic

    if fn in ("contains", "array_position"):
        d, v, dic = nested(0)
        x, xv, xdic = _eval(expr.args[1], batch)
        x = _full_rows(x, n)
        valx = None
        if dic is not None and xdic is not None:
            # dictionary-coded elements: compare by value through a code
            # translation (both sides are sorted dictionaries)
            at = np.searchsorted(dic, xdic).clip(0, max(len(dic) - 1, 0))
            trans = to_device(at.astype(np.int64), dev)
            match = to_device(np.asarray(np.asarray(dic)[at]
                                         == np.asarray(xdic)), dev)
            x, valx = take_clamped(trans, x), take_clamped(match, x)
        x, elems = _same_dtype(x, d.data)
        hit = (elems == x[:, None]) & _lane_mask(d.lengths, d.data.shape[1])
        if valx is not None:
            hit = hit & valx[:, None]
        validity = _and_validity(v, xv)
        found, lane = _first_hit(hit)
        if fn == "contains":
            return _norm(found, validity), validity, None
        pos = torch.where(found, lane + 1, 0).to(torch.int64)
        return _norm(pos, validity), validity, None

    if fn in ("array_min", "array_max"):
        d, v, dic = nested(0)
        lanes = _lane_mask(d.lengths, d.data.shape[1])
        if d.data.is_floating_point():
            big = float("inf")
        else:
            big = torch.iinfo(d.data.dtype).max
        if fn == "array_min":
            out = torch.amin(torch.where(lanes, d.data, big), dim=1) \
                if d.data.shape[1] else d.data.new_zeros((n,))
        else:
            out = torch.amax(torch.where(lanes, d.data, -big), dim=1) \
                if d.data.shape[1] else d.data.new_zeros((n,))
        validity = _and_validity(v, d.lengths > 0)
        return _norm(out, validity), validity, dic

    # ---- lambda family: evaluate the body over the flattened elements
    d, v, dic = nested(0)
    lam = expr.args[1]
    assert isinstance(lam, Lambda)
    rows, w = d.data.shape[0], d.data.shape[1]
    if w == 0:
        # zero-width element matrix (e.g. ``array[]`` literals): every row
        # is empty -- there are no elements to carry through the body
        if fn == "transform":
            return _Nested(d.data, d.lengths), v, dic
        if fn == "filter":
            return _Nested(d.data, torch.zeros((rows,), dtype=torch.int32,
                                               device=dev)), v, dic
        out = (torch.ones if fn in ("all_match", "none_match")
               else torch.zeros)((rows,), dtype=torch.bool, device=dev)
        return _norm(out, v), v, None
    flat = d.data.reshape(rows * w)
    elem_t = expr.args[0].type.element
    cols = {lam.params[0]: Column(flat, elem_t, dictionary=dic)}
    # outer columns referenced by the body repeat element-wise: row i // W
    # of the batch, every column in one gather launch
    from .ir import referenced_columns

    outer = {name: batch[name]
             for name in sorted(referenced_columns(lam.body)
                                - set(lam.params))}
    if outer:
        from ..batch import gather_columns

        parent = torch.div(torch.arange(rows * w, dtype=torch.int64,
                                        device=dev), w, rounding_mode="floor")
        cols.update(gather_columns(outer, parent))
    body = eval_expr(lam.body, RecordBatch(cols, rows * w))
    bdata = body.data.reshape(rows, w)
    lanes = _lane_mask(d.lengths, w)

    if fn == "transform":
        return _Nested(bdata, d.lengths), v, body.dictionary
    mask = bdata.to(torch.bool) & lanes
    if body.validity is not None:
        mask = mask & body.validity.reshape(rows, w)
    if fn == "filter":
        # per-row lane compaction: the kept lanes first, in their order,
        # then the dropped ones in theirs -- what the reference's stable
        # sort along the lanes by the drop flag gives, from two prefix
        # sums along the lanes and one scatter of the lane numbers.  The
        # sums run over the [W, n] transpose: a scan along a short
        # innermost axis of n rows takes a block a row on CUDA (77 ms at
        # n = 6M, W = 3), one over the outer axis a thread a row
        from ..ops.kernels.gather import take_along_axis

        lanes_first = mask.t().contiguous()
        kept = torch.cumsum(lanes_first, dim=0).t()
        nkeep = kept[:, -1:]
        dest = torch.where(mask, kept - 1,
                           nkeep + torch.cumsum(~lanes_first, dim=0).t() - 1)
        order = torch.empty_like(dest).scatter_(
            1, dest, torch.arange(w, dtype=dest.dtype,
                                  device=dev).expand(rows, w))
        data2 = take_along_axis(d.data.contiguous(), order, axis=1)
        return (_Nested(data2, nkeep[:, 0].to(torch.int32)), v, dic)
    if fn == "any_match":
        out = torch.any(mask, dim=1)
    elif fn == "all_match":
        out = torch.all(torch.where(lanes, mask, True), dim=1)
    else:  # none_match
        out = ~torch.any(mask, dim=1)
    return _norm(out, v), v, None


# ------------------------------------------------- string-op binding (host)


def bind_string_ops(expr: Expr, dicts: Dict[str, np.ndarray]) -> Expr:
    """Fold every maximal single-varchar-column subtree into a DictLookup.

    ``dicts`` maps column name -> sorted dictionary (np str array).
    """
    if isinstance(expr, (Literal, ColumnRef, DictLookup)):
        return expr
    if isinstance(expr, Lambda):
        return Lambda(expr.params, bind_string_ops(expr.body, dicts),
                      expr.type)
    assert isinstance(expr, Call)
    if _foldable(expr, dicts):
        return _fold(expr, dicts)
    folded = _fold_const_string(expr)
    if folded is not None:
        return folded
    return Call(expr.fn, tuple(bind_string_ops(a, dicts) for a in expr.args), expr.type)


def lookups_on_device(expr: Expr, device) -> Expr:
    """``expr`` with every DictLookup table (and validity table) moved to
    ``device``, so evaluating it uploads nothing."""
    if isinstance(expr, DictLookup):
        return DictLookup(
            expr.column, _on_device(expr.table, device), expr.type,
            label=expr.label, dictionary=expr.dictionary,
            valid_table=None if expr.valid_table is None
            else _on_device(expr.valid_table, device))
    if isinstance(expr, Lambda):
        return Lambda(expr.params, lookups_on_device(expr.body, device),
                      expr.type)
    if isinstance(expr, Call):
        return Call(expr.fn,
                    tuple(lookups_on_device(a, device) for a in expr.args),
                    expr.type)
    return expr


def _fold_const_string(expr: Call):
    """Constant-fold a string-consuming subtree with NO column references
    (e.g. ``ltrim('  x ')``): substitute the first string literal as a
    one-row pseudo-column, run the host string evaluator, and return the
    result as a Literal."""
    nodes = list(walk(expr))
    if any(isinstance(e, (ColumnRef, DictLookup)) for e in nodes):
        return None
    lits = [e for e in nodes
            if isinstance(e, Literal) and e.type.is_string
            and isinstance(e.value, str)]
    if not lits:
        return None
    target = lits[0]
    ref = ColumnRef("__lit", VARCHAR)

    def sub(e):
        if e is target:
            return ref
        if isinstance(e, Call):
            return Call(e.fn, tuple(sub(a) for a in e.args), e.type)
        return e

    try:
        vals = _eval_strings(sub(expr), np.array([target.value]))
    except NotImplementedError:
        return None
    v = np.asarray(vals).reshape(-1)[0]
    if expr.type.is_string:
        return Literal(str(v), expr.type)
    if expr.type.kind == "boolean":
        return Literal(bool(v), expr.type)
    if expr.type.kind in ("double", "real"):
        return Literal(float(v), expr.type)
    return Literal(int(v), expr.type)


def _string_columns(expr: Expr):
    return {
        e.name for e in walk(expr)
        if isinstance(e, ColumnRef) and e.type.is_string
    }


def _foldable(expr: Call, dicts) -> bool:
    if expr.fn == "__mask":
        # a mask over a varchar value keeps its codes and dictionary on the
        # device (the JAX package folds it and raises at the host string
        # evaluator: ROADMAP C15)
        return False
    cols = _string_columns(expr)
    if len(cols) != 1 or next(iter(cols)) not in dicts:
        return False
    if expr.type.is_string:
        return True  # varchar-valued subtree (e.g. substring for group key)
    # predicate/numeric over strings: every leaf must be the one varchar
    # column or a literal (no mixed numeric columns in the folded subtree)
    for e in walk(expr):
        if isinstance(e, ColumnRef) and not e.type.is_string:
            return False
        if isinstance(e, DictLookup):
            return False
    # only fold nodes that actually consume strings
    return any(
        isinstance(e, (ColumnRef, Literal)) and e.type.is_string for e in walk(expr)
    )


def _fold(expr: Call, dicts) -> Expr:
    name = next(iter(_string_columns(expr)))
    dictionary = dicts[name]
    values = _eval_strings(expr, dictionary)
    colref = next(
        e for e in walk(expr) if isinstance(e, ColumnRef) and e.name == name
    )
    if expr.type.is_string:
        # NOT dictionary.dtype: derived strings can be longer than the
        # source column's fixed width (md5 of a U14 column is U32)
        new_dict, codes = np.unique(np.asarray(values, dtype=str),
                                    return_inverse=True)
        table = np.append(codes.astype(np.int32), np.int32(0))
        return DictLookup(colref, table, expr.type, label=_label(expr),
                          dictionary=new_dict)
    table = np.asarray(values)
    valid_table = None
    if table.dtype == object:  # NULL-bearing fold (CASE without ELSE)
        valid = np.array([v is not None for v in values], dtype=bool)
        dt = (np.int64 if expr.type.kind == "decimal"
              else np.dtype(expr.type.np_dtype))
        table = np.array([v if v is not None else 0 for v in values],
                         dtype=dt)
        valid_table = np.append(valid, np.zeros((1,), bool))
    table = np.append(table, np.zeros((1,), dtype=table.dtype))
    return DictLookup(colref, table, expr.type, label=_label(expr),
                      valid_table=valid_table)


def _label(expr: Expr) -> str:
    if isinstance(expr, Literal):
        return repr(expr.value)
    if isinstance(expr, ColumnRef):
        return expr.name
    if isinstance(expr, Call):
        return f"{expr.fn}({','.join(_label(a) for a in expr.args)})"
    return "?"


def _eval_strings(expr: Expr, values: np.ndarray):
    """Host evaluation of a string subtree over dictionary entries."""
    if isinstance(expr, ColumnRef):
        return values
    if isinstance(expr, Literal):
        if expr.type.kind == "decimal":
            return expr.value / (10 ** _scale_of(expr.type))
        return expr.value
    assert isinstance(expr, Call)
    fn = expr.fn
    args = [_eval_strings(a, values) for a in expr.args]
    if fn == "__hll_hash":
        # value-based (host) string hash — identical on every host, so
        # HLL registers merge correctly across the DCN plane
        from ..batch import hash_strings_host

        h = hash_strings_host(np.asarray(args[0], dtype="U"))
        return _splitmix63_host(h.view(np.int64))
    if fn == "__hll_reg":
        return np.asarray(args[0], dtype=np.int64) & (HLL_M - 1)
    if fn == "__hll_rho":
        w = np.asarray(args[0], dtype=np.int64) >> HLL_P
        nbits = 64 - HLL_P - 1
        rho = np.zeros(len(w), np.int64)
        wz = w.astype(np.uint64)
        # vectorized leading-zero count over the (63-HLL_P)-bit window
        lz = np.full(len(w), 64, np.int64)
        nz = wz != 0
        lz[nz] = 63 - np.floor(np.log2(wz[nz].astype(np.float64))).astype(
            np.int64)
        rho = np.minimum(lz - (HLL_P + 1) + 1, nbits + 1)
        return rho
    if fn == "like":
        return _like(args[0], expr.args[1].value)
    if fn == "substring":
        start, length = int(args[1]), (int(args[2]) if len(args) > 2 else None)
        s = start - 1
        e = None if length is None else s + length
        return np.array([v[s:e] for v in args[0]], dtype=values.dtype)
    if fn in ("||", "concat"):
        return np.char.add(np.asarray(args[0], dtype=str), np.asarray(args[1], dtype=str))
    if fn == "length":
        return np.char.str_len(np.asarray(args[0], dtype=str)).astype(np.int64)
    if fn == "upper":
        return np.char.upper(np.asarray(args[0], dtype=str))
    if fn == "lower":
        return np.char.lower(np.asarray(args[0], dtype=str))
    if fn == "trim":
        return np.char.strip(np.asarray(args[0], dtype=str))
    if fn == "ltrim":
        return np.char.lstrip(np.asarray(args[0], dtype=str))
    if fn == "rtrim":
        return np.char.rstrip(np.asarray(args[0], dtype=str))
    if fn == "reverse":
        return np.array([v[::-1] for v in np.asarray(args[0], dtype=str)],
                        dtype=str)
    if fn == "replace":
        frm = args[1] if len(args) > 1 else ""
        to = args[2] if len(args) > 2 else ""
        return np.array([v.replace(frm, to)
                         for v in np.asarray(args[0], dtype=str)], dtype=str)
    if fn in ("lpad", "rpad"):
        n, pad = int(args[1]), (args[2] if len(args) > 2 else " ")
        out = []
        for v in np.asarray(args[0], dtype=str):
            if len(v) >= n:
                out.append(v[:n])
            else:
                fill = (pad * n)[:n - len(v)]
                out.append(fill + v if fn == "lpad" else v + fill)
        return np.array(out, dtype=str)
    if fn == "strpos":
        sub = args[1]
        return np.array([v.find(sub) + 1
                         for v in np.asarray(args[0], dtype=str)],
                        dtype=np.int64)
    if fn == "starts_with":
        return np.array([v.startswith(args[1])
                         for v in np.asarray(args[0], dtype=str)], dtype=bool)
    if fn == "split_part":
        delim, idx = args[1], int(args[2])
        out = []
        for v in np.asarray(args[0], dtype=str):
            parts = v.split(delim)
            out.append(parts[idx - 1] if 0 < idx <= len(parts) else "")
        return np.array(out, dtype=str)
    if fn == "codepoint":
        return np.array([ord(v[0]) if v else 0
                         for v in np.asarray(args[0], dtype=str)],
                        dtype=np.int64)
    if fn == "levenshtein_distance":
        import difflib  # noqa: F401 — stdlib-only Levenshtein below

        def lev(a, b):
            if len(a) < len(b):
                a, b = b, a
            prev = list(range(len(b) + 1))
            for i, ca in enumerate(a, 1):
                cur = [i]
                for j, cb in enumerate(b, 1):
                    cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                                   prev[j - 1] + (ca != cb)))
                prev = cur
            return prev[-1]

        sub = args[1]
        return np.array([lev(v, sub)
                         for v in np.asarray(args[0], dtype=str)],
                        dtype=np.int64)
    # --- binary family (reference: operator/scalar/VarbinaryFunctions).
    # varbinary dictionary entries are latin-1 strings: byte k <-> code
    # point k, bijective and order-preserving, so the whole dictionary
    # machinery (sorting, comparisons, group-by on codes) is byte-exact.
    if fn in ("to_hex", "md5", "sha1", "sha256", "sha512", "crc32",
              "to_utf8", "from_utf8", "from_hex", "to_base64",
              "from_base64"):
        import base64
        import hashlib
        import zlib

        binary_in = expr.args[0].type.kind == "varbinary"

        def as_bytes(v: str) -> bytes:
            return v.encode("latin-1" if binary_in else "utf-8")

        vals = np.asarray(args[0], dtype=str)
        if fn == "to_hex":
            return np.array([as_bytes(v).hex().upper() for v in vals],
                            dtype=str)
        if fn == "from_hex":
            return np.array([bytes.fromhex(v).decode("latin-1")
                             for v in vals], dtype=str)
        if fn == "to_utf8":
            return np.array([v.encode("utf-8").decode("latin-1")
                             for v in vals], dtype=str)
        if fn == "from_utf8":
            return np.array(
                [v.encode("latin-1").decode("utf-8", errors="replace")
                 for v in vals], dtype=str)
        if fn == "to_base64":
            return np.array(
                [base64.b64encode(as_bytes(v)).decode() for v in vals],
                dtype=str)
        if fn == "from_base64":
            return np.array(
                [base64.b64decode(v).decode("latin-1") for v in vals],
                dtype=str)
        if fn == "crc32":
            return np.array([zlib.crc32(as_bytes(v)) for v in vals],
                            dtype=np.int64)
        digest = getattr(hashlib, fn)
        if binary_in:  # varbinary -> varbinary (reference signature)
            return np.array(
                [digest(as_bytes(v)).digest().decode("latin-1")
                 for v in vals], dtype=str)
        return np.array([digest(v.encode()).hexdigest() for v in vals],
                        dtype=str)
    # --- regex family (reference: operator/scalar/JoniRegexpFunctions) ---
    if fn == "regexp_like":
        pat = re.compile(args[1])
        return np.array([bool(pat.search(v))
                         for v in np.asarray(args[0], dtype=str)], dtype=bool)
    if fn == "regexp_extract":
        pat = re.compile(args[1])
        group = int(args[2]) if len(args) > 2 else 0
        out = []
        for v in np.asarray(args[0], dtype=str):
            m = pat.search(v)
            out.append(m.group(group) if m and group <= pat.groups else "")
        return np.array(out, dtype=str)
    if fn == "regexp_replace":
        pat = re.compile(args[1])
        repl = re.sub(r"\$(\d+)", r"\\\1", args[2]) if len(args) > 2 else ""
        return np.array([pat.sub(repl, v)
                         for v in np.asarray(args[0], dtype=str)], dtype=str)
    if fn == "regexp_count":
        pat = re.compile(args[1])
        return np.array([len(pat.findall(v))
                         for v in np.asarray(args[0], dtype=str)],
                        dtype=np.int64)
    # --- JSON family (reference: operator/scalar/JsonFunctions) ---
    if fn in ("json_extract", "json_extract_scalar", "json_array_length",
              "json_size", "json_format"):
        import json

        def parse(v):
            try:
                return json.loads(v)
            except Exception:  # noqa: BLE001 — malformed json -> NULL
                return None

        def jpath(doc, path):
            # $.a.b[0] subset of JsonPath (the common analytics usage)
            if doc is None or not path.startswith("$"):
                return None
            cur = doc
            for m in re.finditer(r"\.([A-Za-z_][\w]*)|\[(\d+)\]", path):
                if cur is None:
                    return None
                if m.group(1) is not None:
                    cur = cur.get(m.group(1)) if isinstance(cur, dict) else None
                else:
                    i = int(m.group(2))
                    cur = cur[i] if isinstance(cur, list) and i < len(cur) \
                        else None
            return cur

        docs = [parse(v) for v in np.asarray(args[0], dtype=str)]
        if fn == "json_format":
            return np.array([json.dumps(d) if d is not None else ""
                             for d in docs], dtype=str)
        if fn == "json_array_length":
            return np.array([len(d) if isinstance(d, list) else -1
                             for d in docs], dtype=np.int64)
        path = args[1]
        vals = [jpath(d, path) for d in docs]
        if fn == "json_size":
            return np.array([len(v) if isinstance(v, (dict, list)) else 0
                             for v in vals], dtype=np.int64)
        if fn == "json_extract":
            return np.array([json.dumps(v) if v is not None else ""
                             for v in vals], dtype=str)
        # json_extract_scalar: scalars only, as text
        return np.array(
            [("" if v is None or isinstance(v, (dict, list))
              else (json.dumps(v) if isinstance(v, bool) else str(v)))
             for v in vals], dtype=str)
    # --- URL family (reference: operator/scalar/UrlFunctions) ---
    if fn.startswith("url_"):
        from urllib.parse import quote, unquote, urlparse

        vals = np.asarray(args[0], dtype=str)
        if fn == "url_encode":
            return np.array([quote(v, safe="") for v in vals], dtype=str)
        if fn == "url_decode":
            return np.array([unquote(v) for v in vals], dtype=str)
        parts = [urlparse(v) for v in vals]
        if fn == "url_extract_host":
            return np.array([p.hostname or "" for p in parts], dtype=str)
        if fn == "url_extract_path":
            return np.array([p.path for p in parts], dtype=str)
        if fn == "url_extract_protocol":
            return np.array([p.scheme for p in parts], dtype=str)
        if fn == "url_extract_query":
            return np.array([p.query for p in parts], dtype=str)
        if fn == "url_extract_fragment":
            return np.array([p.fragment for p in parts], dtype=str)
        if fn == "url_extract_port":
            return np.array([p.port if p.port is not None else -1
                             for p in parts], dtype=np.int64)
    if fn == "=":
        return np.asarray(args[0]) == args[1] if np.ndim(args[0]) else args[0] == np.asarray(args[1])
    if fn == "<>":
        return np.asarray(args[0]) != args[1]
    if fn == "<":
        return np.asarray(args[0]) < args[1]
    if fn == "<=":
        return np.asarray(args[0]) <= args[1]
    if fn == ">":
        return np.asarray(args[0]) > args[1]
    if fn == ">=":
        return np.asarray(args[0]) >= args[1]
    if fn == "in":
        hay = np.asarray(args[0])
        return np.isin(hay, np.asarray(args[1:]))
    if fn == "not":
        return ~np.asarray(args[0])
    if fn == "and":
        return np.asarray(args[0]) & np.asarray(args[1])
    if fn == "or":
        return np.asarray(args[0]) | np.asarray(args[1])
    if fn == "case":
        # None branch values (CASE without ELSE) keep the table in object
        # dtype; _fold converts it to a typed table + validity mask
        has_null = any(a is None for a in args[1::2]) or args[-1] is None
        dt = object if has_null else None
        out = np.broadcast_to(np.asarray(args[-1], dtype=dt),
                              values.shape).copy()
        for i in range(len(args) - 3, -1, -2):
            cond = np.broadcast_to(np.asarray(args[i]), values.shape)
            val = np.broadcast_to(np.asarray(args[i + 1], dtype=dt),
                                  values.shape)
            out = np.where(cond, val, out)
        return out
    if fn == "cast":
        if expr.type.is_string:  # between string kinds
            return _recoded_strings(args[0], expr.args[0].type, expr.type)
        if expr.type.kind == "decimal":
            scale = _scale_of(expr.type)
            return np.array(
                [int(round(float(v) * 10 ** scale))
                 for v in np.asarray(args[0], dtype=str)], dtype=np.int64)
        if expr.type.kind == "date" and expr.args[0].type.is_string:
            epoch_d = np.datetime64("1970-01-01", "D")
            return np.array(
                [int((np.datetime64(str(v).strip(), "D") - epoch_d)
                     / np.timedelta64(1, "D"))
                 for v in np.asarray(args[0], dtype=str)], dtype=np.int32)
        if expr.type.kind in ("timestamp", "timestamptz") \
                and expr.args[0].type.is_string:
            epoch_us = np.datetime64("1970-01-01T00:00:00", "us")
            return np.array(
                [int((np.datetime64(str(v).strip().replace(" ", "T", 1),
                                    "us") - epoch_us)
                     / np.timedelta64(1, "us"))
                 for v in np.asarray(args[0], dtype=str)], dtype=np.int64)
        return np.asarray(args[0]).astype(expr.type.np_dtype)
    raise NotImplementedError(f"host string op {fn}")


@lru_cache(maxsize=512)
def _like_regex(pattern: str):
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def _like(values: np.ndarray, pattern: str) -> np.ndarray:
    # fast paths for the common shapes (prefix/suffix/contains of literals)
    body = pattern.strip("%")
    n_pct = pattern.count("%")
    if "_" not in pattern and "%" not in body:
        v = values.astype(str) if values.dtype.kind != "U" else values
        if n_pct == 0:
            return v == pattern
        if pattern.startswith("%") and pattern.endswith("%") and n_pct == 2:
            return np.char.find(v, body) >= 0
        if pattern.endswith("%") and n_pct == 1:
            return np.char.startswith(v, body)
        if pattern.startswith("%") and n_pct == 1:
            return np.char.endswith(v, body)
    rx = _like_regex(pattern)
    return np.fromiter(
        (rx.fullmatch(s) is not None for s in values), dtype=bool, count=len(values)
    )
