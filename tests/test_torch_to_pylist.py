"""``RecordBatch.to_pylist`` on the CPU, held against the per-row reading
it replaced (``_per_row`` below: every column through ``Column.decode``,
then each row's values indexed one at a time).  Every element must equal
the reference's and have the same ``type()``, every flat kind of the port
and arrays and maps, with no validity, validity all True and some NULLs,
at 0, 1 and 5,000 rows, in batches padded past their row count.  Also the
per-dictionary values ``to_pylist`` keeps (a freed dictionary's entry goes
with it), the host reads it makes, and the ``to_host`` span's detail."""

import gc
import math
import weakref

import numpy as np
import pytest
import torch

import presto1_tpu_torch.batch as batch_mod
from presto1_tpu_torch.batch import Column, RecordBatch, torch_dtype
from presto1_tpu_torch.trace import QueryTrace, enter
from presto1_tpu_torch.types import (ArrayType, CharType, DecimalType,
                                     MapType, SqlType, TimestampTzType,
                                     TimestampType)

torch.set_num_threads(1)

VARCHAR = SqlType("varchar")
BIGINT = SqlType("bigint")
TYPES = {
    "varchar": VARCHAR,
    "char": CharType(6),
    "varbinary": SqlType("varbinary"),
    "decimal": DecimalType(12, 2),
    "bigint": BIGINT,
    "integer": SqlType("integer"),
    "smallint": SqlType("smallint"),
    "tinyint": SqlType("tinyint"),
    "double": SqlType("double"),
    "real": SqlType("real"),
    "boolean": SqlType("boolean"),
    "date": SqlType("date"),
    "timestamp": TimestampType(3),
    "timestamptz": TimestampTzType(3, -330),
    "interval_ds": SqlType("interval_ds"),
    "interval_ym": SqlType("interval_ym"),
    "array": ArrayType(BIGINT),
    "array_varchar": ArrayType(VARCHAR),
    "map": MapType(VARCHAR, BIGINT),
}
NULLS = ("none", "all_valid", "some_null")
ROWS = (0, 1, 5000)
PAD = 37  # capacity past num_rows: the padded tail must not be read


def _per_row(batch: RecordBatch):
    """``to_pylist`` as it was: each column decoded to a numpy array, then
    every row's values indexed one at a time."""
    cols = {n: c.decode(batch.num_rows) for n, c in batch.columns.items()}
    return [tuple(cols[n][i] for n in batch.names)
            for i in range(batch.num_rows)]


def _same(a, b) -> bool:
    """Equal values of the same type, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (float, np.floating)) and math.isnan(a):
        return math.isnan(b)
    return bool(a == b)


def _assert_same_rows(got, want):
    assert type(got) is list and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g) is tuple and len(g) == len(w), i
        for j, (x, y) in enumerate(zip(g, w)):
            assert _same(x, y), (i, j, x, y, type(x), type(y))


def _dictionary(rng, size, form="U"):
    """A sorted dictionary of ``size`` distinct strings up to 40 long, as a
    'U' array or an object array of ``str``."""
    words = {f"w{rng.integers(0, 10 ** 9):09d}" + "x" * rng.integers(0, 30)
             for _ in range(size * 2)}
    d = np.array(sorted(words)[:size])
    return d.astype(object) if form == "object" else d


def _codes(rng, n, dictionary):
    """Codes into ``dictionary``, some out of range (clipped on read)."""
    k = max(len(dictionary), 1)
    return rng.integers(-3, k + 3, n).astype(np.int32)


def _flat_data(rng, t, n):
    kind = t.kind
    if kind in ("bigint", "timestamp", "timestamptz", "interval_ds"):
        hi = 10 ** 15 if kind != "bigint" else 2 ** 62
        return rng.integers(-hi, hi, n).astype(np.int64)
    if kind == "decimal":
        return rng.integers(-10 ** 12, 10 ** 12, n).astype(np.int64)
    if kind in ("integer", "interval_ym"):
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    if kind == "date":
        return rng.integers(-200_000, 200_000, n).astype(np.int32)
    if kind in ("smallint", "tinyint"):
        return rng.integers(-100, 100, n).astype(t.np_dtype)
    if kind in ("double", "real"):
        x = rng.standard_normal(n) * 1e6
        x[::97] = np.nan
        return x.astype(t.np_dtype)
    if kind == "boolean":
        return rng.random(n) < 0.5
    raise AssertionError(kind)


def _column(rng, name, n, nulls, capacity, dict_form="U"):
    """A column of kind ``name`` with ``capacity`` rows, its first ``n``
    read."""
    t = TYPES[name]
    dictionary = None
    lengths = map_values = None
    if t.kind in ("array", "map"):
        width = 4
        element = t.element if t.kind == "array" else t.key
        if element.is_string:
            dictionary = _dictionary(rng, 50)
            data = rng.integers(0, 50, (capacity, width)).astype(np.int32)
        else:
            data = rng.integers(-10 ** 6, 10 ** 6,
                                (capacity, width)).astype(np.int64)
        lengths = torch.from_numpy(
            rng.integers(0, width + 1, capacity).astype(np.int32))
        if t.kind == "map":
            map_values = torch.from_numpy(
                rng.integers(0, 10 ** 6, (capacity, width)).astype(np.int64))
        data = torch.from_numpy(data)
    elif t.is_string:
        if dict_form == "empty":
            dictionary = np.array([], dtype="U1")
        elif t.kind == "varbinary":
            dictionary = np.array(sorted({bytes(rng.integers(
                0, 256, rng.integers(0, 8)).astype(np.uint8)).decode(
                    "latin-1") for _ in range(300)}))
        else:
            dictionary = _dictionary(rng, 300, dict_form)
        data = torch.from_numpy(_codes(rng, capacity, dictionary))
    else:
        data = torch.from_numpy(_flat_data(rng, t, capacity)).to(
            torch_dtype(t))
    validity = None
    if nulls == "all_valid":
        validity = torch.ones(capacity, dtype=torch.bool)
    elif nulls == "some_null":
        validity = torch.from_numpy(rng.random(capacity) < 0.8)
        validity[:1] = False
    return Column(data, t, validity=validity, dictionary=dictionary,
                  lengths=lengths, map_values=map_values)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nulls", NULLS)
@pytest.mark.parametrize("kind", list(TYPES))
def test_to_pylist_matches_the_per_row_reading(kind, nulls, rows):
    rng = np.random.default_rng([rows, NULLS.index(nulls),
                                 list(TYPES).index(kind)])
    col = _column(rng, kind, rows, nulls, rows + PAD)
    b = RecordBatch({"c": col}, rows)
    want = _per_row(b)
    got = b.to_pylist()
    _assert_same_rows(got, want)
    # a second read (the per-dictionary values now kept) agrees as well
    _assert_same_rows(b.to_pylist(), want)


@pytest.mark.parametrize("nulls", NULLS)
@pytest.mark.parametrize("dict_form", ["U", "object", "empty"])
@pytest.mark.parametrize("kind", ["varchar", "char", "varbinary"])
def test_string_dictionaries_and_clipped_codes(kind, dict_form, nulls):
    rng = np.random.default_rng([7, len(kind), len(dict_form), len(nulls)])
    col = _column(rng, kind, 1000, nulls, 1100, dict_form)
    b = RecordBatch({"c": col}, 1000)
    _assert_same_rows(b.to_pylist(), _per_row(b))


def test_a_wide_batch_keeps_row_and_column_order():
    rng = np.random.default_rng(98)
    n = 5000
    cols = {f"{kind}_{nulls}": _column(rng, kind, n, nulls, n + PAD)
            for kind in TYPES for nulls in NULLS}
    b = RecordBatch(cols, n)
    got = b.to_pylist()
    _assert_same_rows(got, _per_row(b))
    assert len(got[0]) == len(cols)


def test_a_batch_without_columns_gives_empty_rows():
    b = RecordBatch({}, 3)
    assert b.to_pylist() == _per_row(b) == [(), (), ()]


def test_one_dictionary_in_a_nullable_and_a_non_null_column():
    rng = np.random.default_rng(5)
    d = _dictionary(rng, 200)
    codes = torch.from_numpy(_codes(rng, 400, d))
    b = RecordBatch({
        "plain": Column(codes, VARCHAR, dictionary=d),
        "nullable": Column(codes, VARCHAR, dictionary=d,
                           validity=torch.ones(400, dtype=torch.bool)),
    }, 400)
    got = b.to_pylist()
    _assert_same_rows(got, _per_row(b))
    assert {type(r[0]) for r in got} == {np.str_}
    assert {type(r[1]) for r in got} == {str}


def test_kept_values_fill_as_codes_ask_for_them():
    rng = np.random.default_rng(11)
    d = _dictionary(rng, 1000)
    for lo, hi in ((0, 10), (5, 500), (0, 1000), (990, 1003)):
        codes = torch.arange(lo, hi, dtype=torch.int32).flip(0)
        b = RecordBatch({"c": Column(codes, VARCHAR, dictionary=d)},
                        hi - lo)
        _assert_same_rows(b.to_pylist(), _per_row(b))


def test_a_freed_dictionary_takes_its_values_with_it():
    kept = batch_mod._DICTIONARY_VALUES
    before = len(kept)
    for k in range(50):
        # a new dictionary each time, of one size, so its id may repeat
        d = np.array([f"{k:03d}-{i:03d}" for i in range(100)])
        codes = torch.arange(100, dtype=torch.int32)
        b = RecordBatch({"c": Column(codes, VARCHAR, dictionary=d)}, 100)
        assert [r[0] for r in b.to_pylist()] == list(d)
        key = id(d)
        assert key in kept
        del b, d
        gc.collect()
        assert key not in kept
    assert len(kept) == before


def test_an_entry_of_another_object_is_never_read():
    # an entry left under the id of a dictionary that is not its own (as
    # if an old dictionary's id had been reused) is replaced, not read
    d = np.array(["a", "b", "c"])
    other = np.array(["x", "y", "z"])
    stale = np.array(["stale"] * 3, dtype=object)
    kept = batch_mod._DICTIONARY_VALUES
    kept[id(d)] = (weakref.ref(other),
                   {False: (stale, np.ones(3, dtype=bool))})
    try:
        b = RecordBatch({"c": Column(torch.tensor([2, 0, 1],
                                                  dtype=torch.int32),
                                     VARCHAR, dictionary=d)}, 3)
        assert b.to_pylist() == [("c",), ("a",), ("b",)]
        assert kept[id(d)][0]() is d
    finally:
        kept.pop(id(d), None)


def _traced(batch, read):
    """``read(batch)`` and the spans it left, traced as ``to_pylist`` is."""
    batch.trace = trace = QueryTrace("q")
    if read is _per_row:
        with enter(trace, "to_host"):
            rows = read(batch)
    else:
        rows = read(batch)
    return rows, trace.spans


def test_the_host_reads_are_the_per_row_readings():
    rng = np.random.default_rng(3)
    cols = {f"{kind}_{nulls}": _column(rng, kind, 300, nulls, 300 + PAD)
            for kind in TYPES for nulls in NULLS}
    rows, spans = _traced(RecordBatch(cols, 300),
                          RecordBatch.to_pylist)
    want, want_spans = _traced(RecordBatch(cols, 300), _per_row)
    _assert_same_rows(rows, want)
    waits = [s[4] for s in spans if s[0] == "wait"]
    assert waits == [s[4] for s in want_spans if s[0] == "wait"]
    assert all(spans[s[3]][0] == "to_host" for s in spans
               if s[0] == "wait")


@pytest.mark.parametrize("rows", [0, 5000])
def test_the_to_host_detail_counts_rows_columns_and_bulk(rows):
    rng = np.random.default_rng(rows + 1)
    kinds = ["varchar", "char", "decimal", "double", "varbinary", "map",
             "array_varchar", "timestamptz", "date"]
    cols = {k: _column(rng, k, rows, "some_null", rows + PAD)
            for k in kinds}
    b = RecordBatch(cols, rows)
    _, spans = _traced(b, RecordBatch.to_pylist)
    (to_host,) = [s for s in spans if s[0] == "to_host"]
    assert to_host[3] is None
    # ``bulk``: the VARCHAR and CHAR columns, read from their dictionaries'
    # kept values; every other kind goes through ``decode``
    assert to_host[4] == {"rows": rows, "columns": 9, "bulk": 2}
    # untraced, there is no span to carry it
    b.trace = None
    _assert_same_rows(b.to_pylist(), _per_row(b))
