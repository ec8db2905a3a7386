"""SQL type system and its mapping onto device dtypes.

Replaces the reference type registry (``core/trino-spi/src/main/java/io/trino/
spi/type/`` — BigintType, DoubleType, VarcharType, DecimalType, DateType, …)
with a small set of fixed-width device representations:

| SQL type      | device repr                           |
|---------------|---------------------------------------|
| BIGINT        | int64                                 |
| INTEGER       | int32                                 |
| DOUBLE        | float64                               |
| BOOLEAN       | bool                                  |
| DATE          | int32 days since 1970-01-01           |
| DECIMAL(p,s)  | int64 scaled by 10**s (exact arith)   |
| VARCHAR/CHAR  | int32 dictionary codes (order-preserving sorted dictionary) |

DECIMAL-as-scaled-int64 is a deliberate choice carried over from the JAX
package: TPC-H money arithmetic is exact in scaled integers.  The reference
types TPC-H money columns as DOUBLE (``plugin/trino-tpch/.../TpchMetadata``);
we keep exact decimals internally and compare doubles within-ulp at the
output boundary (policy documented in SURVEY.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SqlType:
    kind: str  # bigint|integer|smallint|tinyint|double|real|boolean|date|
    #            timestamp|varchar|char|decimal

    @property
    def np_dtype(self):
        return _NP_DTYPES[self.kind]

    @property
    def is_string(self) -> bool:
        # varbinary rides the dictionary-coded (string) machinery: its
        # physical dictionary entries are latin-1 strings, a bijective
        # ORDER-PRESERVING image of the byte sequences (byte k <-> code
        # point k), so code comparisons == byte comparisons.  The
        # reference's VarbinaryType (spi/type/VarbinaryType.java) is a
        # variable-width block the same way VarcharType is.
        return self.kind in ("varchar", "char", "varbinary")

    @property
    def is_numeric(self) -> bool:
        return self.kind in ("bigint", "integer", "smallint", "tinyint",
                             "double", "real", "decimal")

    def __str__(self):
        return self.kind


@dataclass(frozen=True)
class DecimalType(SqlType):
    precision: int = 12
    scale: int = 2

    def __init__(self, precision: int = 12, scale: int = 2):
        object.__setattr__(self, "kind", "decimal")
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)

    def __str__(self):
        return f"decimal({self.precision},{self.scale})"


@dataclass(frozen=True)
class TimestampType(SqlType):
    """TIMESTAMP(p) — stored as int64 MICROseconds since the epoch
    regardless of declared precision (covers p <= 6; the reference stores
    p <= 6 in one long too, ``spi/type/TimestampType.java``).  Precision
    is display/rounding metadata."""

    precision: int = 3

    def __init__(self, precision: int = 3):
        object.__setattr__(self, "kind", "timestamp")
        object.__setattr__(self, "precision", min(int(precision), 6))

    def __str__(self):
        return f"timestamp({self.precision})"


@dataclass(frozen=True)
class TimestampTzType(SqlType):
    """TIMESTAMP(p) WITH TIME ZONE — re-designed device-first.

    The reference packs (epoch_millis << 12 | zoneKey) per VALUE
    (``spi/type/DateTimeEncoding.java``), unpacking for every comparison.
    Here the data array is plain UTC int64 microseconds (directly
    comparable/sortable — no unpacking anywhere on device) and the zone
    is COLUMN metadata: a fixed offset in minutes carried on the type.
    ``AT TIME ZONE`` is therefore free (it rewrites the type, not the
    data).  Scope: fixed-offset zones and UTC; named DST zones are
    rejected at parse time (documented deviation, PARITY.md)."""

    precision: int = 3
    offset_minutes: int = 0

    def __init__(self, precision: int = 3, offset_minutes: int = 0):
        object.__setattr__(self, "kind", "timestamptz")
        object.__setattr__(self, "precision", min(int(precision), 6))
        object.__setattr__(self, "offset_minutes", int(offset_minutes))

    @property
    def offset_micros(self) -> int:
        return self.offset_minutes * 60_000_000

    def __str__(self):
        return (f"timestamptz({self.precision},"
                f"{self.offset_minutes:+d})")


def parse_zone_offset(zone: str) -> int:
    """'+05:30' / '+0530' / '+05' / '-08:00' / 'UTC' / 'Z' -> minutes east
    of UTC.  A compact body is HHMM or HH; an offset beyond +-14:00 (the
    range of the reference's ZoneOffset) is refused."""
    z = zone.strip()
    if z.upper() in ("UTC", "Z", "+00:00", "-00:00", "GMT"):
        return 0
    sign = {"+": 1, "-": -1}.get(z[:1])
    body = z[1:]
    if ":" in body:
        hh, _, mm = body.partition(":")
    elif len(body) == 4:
        hh, mm = body[:2], body[2:]
    else:
        hh, mm = body, "00"
    if (sign and 1 <= len(hh) <= 2 and len(mm) == 2 and hh.isdigit()
            and mm.isdigit() and int(mm) < 60):
        minutes = int(hh) * 60 + int(mm)
        if minutes > 14 * 60:
            raise ValueError(
                f"time zone offset {zone!r} is beyond +-14:00")
        return sign * minutes
    raise ValueError(
        f"unsupported time zone {zone!r}: fixed offsets ('+05:30') and "
        "UTC only (named DST zones are out of scope, PARITY.md)")


@dataclass(frozen=True)
class CharType(SqlType):
    """CHAR(n) — dictionary-coded like varchar; comparisons ignore
    trailing pad spaces (values are stored stripped, the reference's
    comparison semantics for ``spi/type/CharType.java``)."""

    length: int = 1

    def __init__(self, length: int = 1):
        object.__setattr__(self, "kind", "char")
        object.__setattr__(self, "length", int(length))

    def __str__(self):
        return f"char({self.length})"


@dataclass(frozen=True)
class ArrayType(SqlType):
    """ARRAY(T) — device-first representation: a [n, W] device matrix of
    element values padded to the column's max width W plus an int32
    lengths vector (static shapes; the reference's variable-width
    ``spi/type/ArrayType.java`` / ArrayBlock offsets+values become
    pad+length, the same trade every operator in this engine makes)."""

    element: SqlType = None

    def __init__(self, element: SqlType):
        object.__setattr__(self, "kind", "array")
        object.__setattr__(self, "element", element)

    @property
    def np_dtype(self):
        return self.element.np_dtype

    def __str__(self):
        return f"array({self.element})"


@dataclass(frozen=True)
class MapType(SqlType):
    """MAP(K, V) — two aligned [n, W] matrices (keys ride Column.data,
    values ride Column.map_values) + lengths; the
    ``spi/type/MapType.java`` analog."""

    key: SqlType = None
    value: SqlType = None

    def __init__(self, key: SqlType, value: SqlType):
        object.__setattr__(self, "kind", "map")
        object.__setattr__(self, "key", key)
        object.__setattr__(self, "value", value)

    @property
    def np_dtype(self):
        return self.key.np_dtype

    def __str__(self):
        return f"map({self.key},{self.value})"


@dataclass(frozen=True)
class RowType(SqlType):
    """ROW(a bigint, b varchar) — the ``spi/type/RowType.java`` analog,
    re-designed device-first as a PURELY LOGICAL view: a row value never
    materialises as one device array.  The planner flattens every row
    into per-field columns (struct-of-arrays — the same decomposition
    RowBlock performs physically, done at plan time instead), field
    access selects the underlying column, and a row-valued select item
    outputs one column per field.  Rows are excluded from GROUP BY /
    ORDER BY / join keys (initial scope)."""

    fields: tuple = ()  # ((name, SqlType), ...)

    def __init__(self, fields):
        object.__setattr__(self, "kind", "row")
        object.__setattr__(self, "fields", tuple(tuple(f) for f in fields))

    @property
    def np_dtype(self):
        raise TypeError("row values are flattened to per-field columns "
                        "and never materialise as one array")

    def __str__(self):
        inner = ",".join(f"{n} {t}" for n, t in self.fields)
        return f"row({inner})"


MICROS_PER_DAY = 86_400_000_000

_NP_DTYPES = {
    # INTERVAL DAY TO SECOND: int64 microseconds; INTERVAL YEAR TO
    # MONTH: int32 months (``spi/type/SqlIntervalDayTime`` /
    # ``SqlIntervalYearMonth`` analogs — two fixed-width device ints)
    "interval_ds": np.dtype(np.int64),
    "interval_ym": np.dtype(np.int32),
    "bigint": np.dtype(np.int64),
    "integer": np.dtype(np.int32),
    "smallint": np.dtype(np.int16),
    "tinyint": np.dtype(np.int8),
    "double": np.dtype(np.float64),
    "real": np.dtype(np.float32),
    "boolean": np.dtype(np.bool_),
    "date": np.dtype(np.int32),
    "timestamp": np.dtype(np.int64),  # micros since epoch
    "timestamptz": np.dtype(np.int64),  # UTC micros (zone = type metadata)
    "decimal": np.dtype(np.int64),
    "varchar": np.dtype(np.int32),  # dictionary codes
    "char": np.dtype(np.int32),  # dictionary codes
    "varbinary": np.dtype(np.int32),  # dictionary codes (latin-1 entries)
}

BIGINT = SqlType("bigint")
INTEGER = SqlType("integer")
SMALLINT = SqlType("smallint")
TINYINT = SqlType("tinyint")
DOUBLE = SqlType("double")
REAL = SqlType("real")
BOOLEAN = SqlType("boolean")
DATE = SqlType("date")
TIMESTAMP = TimestampType(3)
VARCHAR = SqlType("varchar")
VARBINARY = SqlType("varbinary")
INTERVAL_DS = SqlType("interval_ds")
INTERVAL_YM = SqlType("interval_ym")


def _split_type_args(s: str):
    """Split 'a,b' at top-level commas (nested parens stay intact)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def parse_type_str(name: str) -> SqlType:
    """Inverse of ``str(SqlType)`` (used by the page wire format and DDL)."""
    n = name.strip().lower()

    def paren_args(default):
        if "(" not in n:
            return default
        return [x.strip() for x in n[n.find("(") + 1:n.find(")")].split(",")]

    if n.startswith("row(") or n.startswith("row ("):
        inner = n[n.find("(") + 1:n.rfind(")")]
        fields = []
        for i, part in enumerate(_split_type_args(inner)):
            toks = part.split(None, 1)
            if len(toks) == 2:
                fname, ft = toks
            else:  # anonymous field
                fname, ft = f"f{i}", toks[0]
            fields.append((fname, parse_type_str(ft)))
        return RowType(fields)
    if n.startswith("array"):
        inner = n[n.find("(") + 1:n.rfind(")")]
        return ArrayType(parse_type_str(inner))
    if n.startswith("map"):
        inner = n[n.find("(") + 1:n.rfind(")")]
        k, v = _split_type_args(inner)
        return MapType(parse_type_str(k), parse_type_str(v))

    if n in ("interval_ds", "interval_ym"):
        return SqlType(n)
    if n.startswith("interval"):
        return INTERVAL_YM if "year" in n or "month" in n else INTERVAL_DS
    if n.startswith("decimal"):
        p, s = (paren_args(["12", "2"]) + ["0"])[:2]
        return DecimalType(int(p), int(s))
    if n.startswith("timestamptz"):
        a = (paren_args(["3", "0"]) + ["0"])[:2]
        return TimestampTzType(int(a[0]), int(a[1]))
    if n.startswith("timestamp") and "with time zone" in n:
        return TimestampTzType(int(paren_args(["3"])[0]))
    if n.startswith("timestamp"):
        return TimestampType(int(paren_args(["3"])[0]))
    if n.startswith("char"):
        return CharType(int(paren_args(["1"])[0]))
    for prefix, t in (("double", DOUBLE), ("real", REAL), ("float", REAL),
                      ("bigint", BIGINT), ("smallint", SMALLINT),
                      ("tinyint", TINYINT), ("integer", INTEGER),
                      ("int", INTEGER), ("date", DATE),
                      ("varbinary", VARBINARY),
                      ("varchar", VARCHAR), ("boolean", BOOLEAN),
                      ("bool", BOOLEAN)):
        if n.startswith(prefix):
            return t
    raise ValueError(f"unknown type {name}")


_NUMERIC_ORDER = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3,
                  "date": 3, "decimal": 4, "real": 5, "double": 6}


def common_supertype(a: SqlType, b: SqlType) -> SqlType:
    """Result type of binary arithmetic/comparison coercion.

    Mirrors the reference's ``TypeCoercion`` lattice for the types we
    support: tinyint -> smallint -> integer -> bigint -> decimal -> real
    -> double; date -> timestamp; char -> varchar.
    """
    if a == b:
        return a
    if a.kind in _NUMERIC_ORDER and b.kind in _NUMERIC_ORDER:
        hi = a if _NUMERIC_ORDER[a.kind] >= _NUMERIC_ORDER[b.kind] else b
        lo = b if hi is a else a
        if hi.kind == "decimal" and lo.kind == "decimal":
            # widen to max scale
            return hi if hi.scale >= lo.scale else lo  # type: ignore[attr-defined]
        return hi
    if a.kind == "date" and b.kind == "date":
        return a
    if {a.kind, b.kind} == {"date", "timestamp"}:
        return a if a.kind == "timestamp" else b
    if a.kind == "timestamp" and b.kind == "timestamp":
        return a if a.precision >= b.precision else b  # type: ignore[attr-defined]
    if "timestamptz" in (a.kind, b.kind) and \
            {a.kind, b.kind} <= {"timestamptz", "timestamp", "date"}:
        # instants win; both sides are (or coerce to) UTC micros
        return a if a.kind == "timestamptz" else b
    if a.is_string and b.is_string:
        if ("varbinary" in (a.kind, b.kind)) and a.kind != b.kind:
            raise TypeError("no implicit coercion between varbinary and "
                            "character types (use to_utf8/from_utf8)")
        return a if a.kind == "varchar" else b
    raise TypeError(f"no common supertype for {a} and {b}")
