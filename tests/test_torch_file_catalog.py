"""The port's Parquet / CSV catalog (``presto1_tpu_torch/exec/file_catalog.py``)
on the CPU: the cases of ``tests/test_file_catalog.py`` retargeted, each
statement run over the same files through the JAX package's catalog and
engine as well, and the two results held equal (integers, decimals, dates,
strings and validity exact; doubles to 1e-6 relative).  Then the host
columns of every Parquet type the catalog maps, bit for bit against the
reference's decoding, and its device and import contracts.
"""

import decimal
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu.exec.file_catalog import (FileCatalog as JFileCatalog,
                                           ParquetTable as JParquetTable)
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.file_catalog import (CsvTable, FileCatalog,
                                                 ParquetTable, write_parquet)

from torch_parity import same_answer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    df = pd.DataFrame({
        "id": np.arange(1000, dtype=np.int64),
        "grp": np.arange(1000) % 7,
        "val": np.arange(1000, dtype=np.float64) * 1.5,
        "name": [f"name_{i % 13}" for i in range(1000)],
        "d": pd.date_range("2020-01-01", periods=1000).values,
        "maybe": [None if i % 5 == 0 else float(i) for i in range(1000)],
    })
    df.to_parquet(d / "events.parquet")
    df2 = pd.DataFrame({"k": [1, 2, 3, 4], "s": ["a", "b", None, "d"],
                        "x": [0.5, None, 2.5, 3.5]})
    df2.to_csv(d / "lookup.csv", index=False)
    return str(d)


@pytest.fixture(scope="module")
def engine(root):
    return Engine(FileCatalog(root, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def reference(root):
    return JEngine(JFileCatalog(root))


def both(engine, reference, sql) -> pd.DataFrame:
    """The port's answer to ``sql``, held equal to the JAX package's."""
    return same_answer(engine, reference, sql)


# ------------------------------------- the reference file's cases, retargeted


def test_parquet_scan_agg(engine, reference):
    out = both(engine, reference,
               "select grp, count(*) c, sum(val) s, count(maybe) nn from "
               "events group by grp order by grp")
    assert len(out) == 7
    assert int(out.c.sum()) == 1000
    assert int(out.nn.sum()) == 800  # 1 in 5 is NULL
    exp = sum(i * 1.5 for i in range(1000))
    assert np.isclose(out.s.sum(), exp)


def test_parquet_strings_dates(engine, reference):
    out = both(engine, reference,
               "select name, min(d) lo, max(d) hi from events "
               "where name like 'name_1%' group by name order by name")
    assert list(out.name) == ["name_1", "name_10", "name_11", "name_12"]
    out2 = both(engine, reference,
                "select count(*) c from events where d >= date '2021-01-01'")
    assert int(out2.c[0]) == 1000 - 366


def test_csv_join(engine, reference):
    out = both(engine, reference,
               "select k, s, count(*) c from lookup join events on k = grp "
               "group by k, s order by k")
    assert len(out) == 4
    assert (out.c > 0).all()
    # CSV NULL survives the pipeline (pandas renders object-None as NaN)
    assert pd.isna(out.s[2])


def test_write_parquet_roundtrip(engine, reference, tmp_path):
    sql = "select grp, count(*) c from events group by grp"
    n = write_parquet(engine.sql(sql), str(tmp_path / "summary.parquet"))
    assert n == 7
    # the reference writes its own answer beside it: the two files read
    # back equal, through either catalog
    from presto1_tpu.exec.file_catalog import write_parquet as j_write

    j_write(reference.sql(sql), str(tmp_path / "jsummary.parquet"))
    e2 = Engine(FileCatalog(str(tmp_path), device="cpu"), device="cpu")
    r2 = JEngine(JFileCatalog(str(tmp_path)))
    for table in ("summary", "jsummary"):
        back = both(e2, r2, f"select sum(c) t from {table}")
        assert int(back.t[0]) == 1000
    both(e2, r2, "select grp, c from summary order by grp")


def test_parquet_decimal_exact_decode(tmp_path):
    """Decimal128 decodes via exact unscaled integers: values with >16
    significant digits survive (a float64 round-trip would corrupt them),
    as the reference's decoding gives them; a value beyond int64 raises in
    both."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    vals = [decimal.Decimal("123456789012345.67"),
            decimal.Decimal("-999999999999999.99"), None]
    path = str(tmp_path / "dec.parquet")
    pq.write_table(
        pa.table({"d": pa.array(vals, type=pa.decimal128(18, 2))}), path)
    c = ParquetTable("t", path, device="cpu").host_column("d")
    assert int(c.data[0]) == 12345678901234567
    assert int(c.data[1]) == -99999999999999999
    assert list(c.validity) == [True, True, False]
    ref = JParquetTable("t", path).host_column("d")
    np.testing.assert_array_equal(c.data, ref.data)
    np.testing.assert_array_equal(c.validity, ref.validity)
    big = [decimal.Decimal("1.00"), None,
           decimal.Decimal("92233720368547758.08")]
    path = str(tmp_path / "big.parquet")
    pq.write_table(
        pa.table({"d": pa.array(big, type=pa.decimal128(38, 2))}), path)
    with pytest.raises(OverflowError, match="92233720368547758.08"):
        ParquetTable("t", path, device="cpu").host_column("d")
    with pytest.raises(OverflowError, match="92233720368547758.08"):
        JParquetTable("t", path).host_column("d")


# ---------------------------------------------- the port's own contracts


def _typed_file(path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(12)
    n = 600
    nulls = rng.random(n) < 0.1
    dec = [None if z else decimal.Decimal(int(v)).scaleb(-2)
           for z, v in zip(nulls, rng.integers(-10**17, 10**17, n))]
    wide = [None if z else decimal.Decimal(int(v)).scaleb(-4)
            for z, v in zip(nulls, rng.integers(-2**62, 2**62, n))]
    pq.write_table(pa.table({
        "dec": pa.array(dec, type=pa.decimal128(18, 2)),
        "wide": pa.array(wide, type=pa.decimal128(38, 4)),
        "ts": pa.array(pd.date_range("1969-06-01", periods=n,
                                     freq="D").values),
        "day": pa.array([None if z else int(v) for z, v in
                         zip(nulls, rng.integers(-9000, 30000, n))],
                        type=pa.date32()),
        "s": pa.array([None if z else f"v{int(v)}" for z, v in
                       zip(nulls, rng.integers(0, 40, n))]),
        "b": pa.array([bytes([int(v), 97]) for v in
                       rng.integers(32, 127, n)]),
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "i64": pa.array([None if z else int(v) for z, v in
                         zip(nulls, rng.integers(-2**40, 2**40, n))]),
        "f": pa.array(rng.normal(size=n)),
        "flag": pa.array([None if z else bool(v) for z, v in
                          zip(nulls, rng.integers(0, 2, n))]),
    }), path, row_group_size=128)


def test_host_columns_equal_the_reference_bit_for_bit(tmp_path):
    """Every Parquet type the catalog maps (decimal128 at two widths,
    timestamps, date32, strings, binary, int32, int64, double, boolean, with
    NULLs), read whole and through a pruned view: data, dtype, validity,
    type and dictionary equal to the JAX package's decoding."""
    from presto1_tpu.sql.domain import Domain as JDomain, \
        TupleDomain as JTupleDomain
    from presto1_tpu_torch.sql.domain import Domain, TupleDomain

    path = str(tmp_path / "typed.parquet")
    _typed_file(path)
    port, ref = ParquetTable("t", path, device="cpu"), JParquetTable("t", path)
    hi = 300  # days past the first: keeps row groups 0-2 of 5
    vp = port.pruned(TupleDomain({"i32": Domain(lo=-1000, hi=1000),
                                  "ts": Domain(lo=-214, hi=-214 + hi)}))
    vr = ref.pruned(JTupleDomain({"i32": JDomain(lo=-1000, hi=1000),
                                  "ts": JDomain(lo=-214, hi=-214 + hi)}))
    assert vp is not None and vr is not None
    assert vp.num_rows == vr.num_rows < port.num_rows
    for a, b in ((port, ref), (vp, vr)):
        for c in port.column_order:
            x, y = a.host_column(c), b.host_column(c)
            assert str(x.type) == str(y.type), c
            assert np.asarray(x.data).dtype == np.asarray(y.data).dtype, c
            np.testing.assert_array_equal(x.data, y.data, err_msg=c)
            assert (x.validity is None) == (y.validity is None), c
            if x.validity is not None:
                np.testing.assert_array_equal(x.validity, y.validity)
            assert (x.dictionary is None) == (y.dictionary is None), c
            if x.dictionary is not None:
                np.testing.assert_array_equal(x.dictionary, y.dictionary)
        for c in port.column_order:
            x, y = a.column_stats(c), b.column_stats(c)
            assert (x is None) == (y is None), c
            if x is not None:
                assert vars(x) == vars(y), c


def test_columns_reach_the_catalog_device_and_cuda_is_the_default(root):
    """``FileCatalog`` places columns on ``cuda`` unless told otherwise;
    on the CPU its columns are CPU tensors, uploaded once."""
    import inspect

    assert inspect.signature(FileCatalog).parameters["device"].default \
        == "cuda"
    assert inspect.signature(CsvTable).parameters["device"].default == "cuda"
    assert inspect.signature(ParquetTable).parameters["device"].default \
        == "cuda"
    cat = FileCatalog(root, device="cpu")
    for name in ("events", "lookup"):
        t = cat.table(name)
        assert t.device == torch.device("cpu")
        for c in t.column_order:
            col = t.column(c)
            assert col.data.device.type == "cpu"
            assert t.column(c) is col  # cached
    assert cat.table("lookup").schema["s"].kind == "varchar"


def test_csv_types_are_what_pandas_infers(tmp_path):
    """A CSV column is what pandas infers, as the JAX package reads it: an
    ISO date stays VARCHAR, ``12.34`` is DOUBLE, a column with a gap is a
    nullable DOUBLE."""
    (tmp_path / "t.csv").write_text(
        "day,price,n,flag,gap\n1998-09-02,12.34,1,true,5\n"
        "1994-01-01,0.05,2,false,\n")
    port = FileCatalog(str(tmp_path), device="cpu").table("t")
    ref = JFileCatalog(str(tmp_path)).table("t")
    assert {c: str(t) for c, t in port.schema.items()} == \
        {c: str(t) for c, t in ref.schema.items()} == {
            "day": "varchar", "price": "double", "n": "bigint",
            "flag": "boolean", "gap": "double"}
    for c in port.column_order:
        x, y = port.host_column(c), ref.host_column(c)
        np.testing.assert_array_equal(x.data, y.data)
        assert (x.validity is None) == (y.validity is None)


def test_parquet_needs_pyarrow_and_nothing_stands_in(root, monkeypatch):
    """Without pyarrow a Parquet table raises ImportError naming it (the
    card's machine has none); a CSV-only directory needs only pandas."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "pyarrow"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pyarrow"):
        FileCatalog(root, device="cpu")
    with pytest.raises(ImportError, match="pyarrow"):
        write_parquet(None, "/nowhere.parquet")
    import os
    import shutil
    import tempfile

    d = tempfile.mkdtemp()
    try:
        shutil.copy(os.path.join(root, "lookup.csv"), d)
        e = Engine(FileCatalog(d, device="cpu"), device="cpu")
        assert e.sql("select count(*) c from lookup").to_pylist() == [(4,)]
    finally:
        shutil.rmtree(d)


@pytest.mark.parametrize("pred,want", [
    ("x = 0.07", 2), ("x <= 0.07", 4), ("x between 0.05 and 0.07", 4),
    ("0.07 >= x", 4), ("x < 0.07", 2), ("x <> 0.07", 2)])
def test_double_against_a_decimal_literal_c27(tmp_path, pred, want):
    """A DOUBLE column (as CSV decimals are read) against a decimal
    literal compares the literal as the double nearest its value, as
    pandas and Trino do.  The JAX package scales the double up by 10^s and
    compares with the unscaled integer, which rounds (0.07 * 100 =
    7.000000000000001): it finds no ``x = 0.07`` and drops those rows from
    ``x <= 0.07``."""
    (tmp_path / "t.csv").write_text("x\n0.05\n0.07\n0.06\n0.07\n")
    sql = f"select count(*) c from t where {pred}"
    e = Engine(FileCatalog(str(tmp_path), device="cpu"), device="cpu")
    x = pd.read_csv(tmp_path / "t.csv").x
    assert int({"x = 0.07": x == 0.07, "x <= 0.07": x <= 0.07,
                "x between 0.05 and 0.07": (x >= 0.05) & (x <= 0.07),
                "0.07 >= x": 0.07 >= x, "x < 0.07": x < 0.07,
                "x <> 0.07": x != 0.07}[pred].sum()) == want
    assert e.sql(sql).to_pylist() == [(want,)]
    assert e.compile(sql)().to_pylist() == [(want,)]
    ref = JEngine(JFileCatalog(str(tmp_path))).sql(sql).to_pylist()[0][0]
    assert ref == {"x = 0.07": 0, "x <= 0.07": 2,
                   "x between 0.05 and 0.07": 2, "0.07 >= x": 2,
                   "x < 0.07": 2, "x <> 0.07": 4}[pred]
