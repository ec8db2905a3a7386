"""TupleDomain and Parquet row-group pruning in the port: the cases of
``tests/test_domain.py`` retargeted to ``presto1_tpu_torch`` on the CPU.
The domain model's answers are held against the JAX package's
``sql/domain.py`` on the same conjuncts, and every statement over the
Parquet file against the JAX package's engine over the same file (counts
exact, doubles to 1e-6 relative).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import presto1_tpu.expr.ir as j_ir
import presto1_tpu.sql.domain as j_domain
import presto1_tpu.types as j_types
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.sql.domain as t_domain
import presto1_tpu_torch.types as t_types
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu.exec.file_catalog import FileCatalog as JFileCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.file_catalog import FileCatalog
from presto1_tpu_torch.sql.domain import (Domain, TupleDomain,
                                          domains_from_conjuncts)

torch.set_num_threads(1)


def both_domains(build):
    """``build(ir, types)`` through both packages: (port's TupleDomain,
    the JAX package's), held equal by their JSON."""
    got = build(t_ir, t_types, t_domain)
    want = build(j_ir, j_types, j_domain)
    assert got.to_json() == want.to_json()
    assert got.none == want.none
    return got


def _conj(*spec):
    def build(ir, types, domain):
        c = lambda n: ir.ColumnRef(n, types.BIGINT)  # noqa: E731
        lit = lambda v: ir.Literal(v, types.BIGINT)  # noqa: E731
        return domain.domains_from_conjuncts(
            [f(ir, c, lit) for f in spec])
    return build


def test_extract_range_conjuncts():
    td = both_domains(_conj(
        lambda ir, c, lit: ir.call(">=", c("x"), lit(10)),
        lambda ir, c, lit: ir.call("<", c("x"), lit(20)),
        lambda ir, c, lit: ir.call("=", c("y"), lit(5))))
    dx, dy = td.get("x"), td.get("y")
    assert (dx.lo, dx.hi) == (10, 20)  # strict < widened to hull, sound
    assert (dy.lo, dy.hi) == (5, 5)
    assert not dx.null_allowed


def test_extract_in_and_nulls():
    td = both_domains(_conj(
        lambda ir, c, lit: ir.call("in", c("k"), lit(3), lit(7), lit(9)),
        lambda ir, c, lit: ir.call("not", ir.call("is_null", c("z")))))
    assert td.get("k").values == frozenset([3, 7, 9])
    assert not td.get("z").null_allowed


def test_contradiction_is_none():
    td = both_domains(_conj(
        lambda ir, c, lit: ir.call(">", c("x"), lit(100)),
        lambda ir, c, lit: ir.call("<", c("x"), lit(10))))
    assert td.none


def test_intersect_values_with_range():
    d = Domain(values=frozenset([1, 5, 9])).intersect(Domain(lo=4, hi=10))
    r = j_domain.Domain(values=frozenset([1, 5, 9])).intersect(
        j_domain.Domain(lo=4, hi=10))
    assert d.values == r.values == frozenset([5, 9])


@pytest.mark.parametrize("stats", [
    (0, 49, False), (61, 99, False), (40, 55, False), (0, 9, True),
    (0, 9, False), (55, 55, True)])
def test_may_match(stats):
    """Each statistics triple against a range and an IS NULL domain: the
    port's answer is the reference's, and the reference file's expected
    answers hold."""
    expected = {(0, 49, False): (False, False), (61, 99, False):
                (False, False), (40, 55, False): (True, False),
                (0, 9, True): (False, True), (0, 9, False): (False, False),
                (55, 55, True): (True, True)}
    got = (Domain(lo=50, hi=60).may_match(*stats),
           Domain(values=frozenset(), null_allowed=True).may_match(*stats))
    want = (j_domain.Domain(lo=50, hi=60).may_match(*stats),
            j_domain.Domain(values=frozenset(),
                            null_allowed=True).may_match(*stats))
    assert got == want == expected[stats]


def test_json_roundtrip():
    td = TupleDomain({"a": Domain(lo=1, hi=9, null_allowed=False),
                      "b": Domain(values=frozenset(["x", "y"]))})
    assert TupleDomain.from_json(td.to_json()) == td
    # the JSON is the reference's: each package reads the other's
    ref = j_domain.TupleDomain.from_json(td.to_json())
    assert TupleDomain.from_json(ref.to_json()) == td


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("dom")
    n = 10000
    df = pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),            # sorted: prunable
        "grp": np.arange(n) % 7,
        "val": np.arange(n, dtype=np.float64) * 1.5,
        "d": pd.date_range("2020-01-01", periods=n).values,
    })
    pq.write_table(pa.Table.from_pandas(df), d / "facts.parquet",
                   row_group_size=1000)  # 10 row groups
    return str(d)


@pytest.fixture(scope="module")
def engine(root):
    return Engine(FileCatalog(root, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def reference(root):
    return JEngine(JFileCatalog(root))


def _scan(plan):
    """The first Scan of a plan of either package."""
    if type(plan).__name__ == "Scan":
        return plan
    for c in plan.children:
        got = _scan(c)
        if got is not None:
            return got
    return None


def _pruned_rows(engine, sql):
    scan = _scan(engine.plan(sql))
    assert scan is not None and scan.domain is not None
    table = engine.catalog.table(scan.table)
    view = table.pruned(scan.domain)
    assert view is not None, "expected row groups to be pruned"
    assert table.pruned(scan.domain) is view  # one view a domain
    return view.num_rows


def _same(got, want):
    got, want = got.to_pandas(), want.to_pandas()
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            assert list(g) == list(w), c
    return got


def test_parquet_rowgroup_pruning_range(engine, reference):
    sql = "select count(*) c, sum(val) s from facts where id between 2500 and 3499"
    # 10 groups of 1000 sorted ids -> only groups 2 and 3 survive
    assert _pruned_rows(engine, sql) == 2000 == _pruned_rows(reference, sql)
    out = _same(engine.sql(sql), reference.sql(sql))
    assert int(out.c[0]) == 1000
    assert out.s[0] == pytest.approx(np.arange(2500, 3500).sum() * 1.5)


def test_parquet_rowgroup_pruning_date(engine, reference):
    sql = ("select count(*) c from facts "
           "where d >= date '2020-01-01' and d < date '2020-01-11'")
    assert _pruned_rows(engine, sql) == 1000  # first group only
    out = _same(engine.sql(sql), reference.sql(sql))
    assert int(out.c[0]) == 10


def test_parquet_pruning_correct_on_unsorted_column(engine, reference):
    # grp cycles 0..6 in every group: nothing prunable, answer unchanged
    sql = "select count(*) c from facts where grp = 3"
    out = _same(engine.sql(sql), reference.sql(sql))
    assert int(out.c[0]) == len([i for i in range(10000) if i % 7 == 3])


def test_compiled_mode_consistent_with_pruning(engine, reference):
    sql = "select sum(val) s from facts where id >= 9000"
    a = engine.sql(sql).to_pandas().s[0]
    fn = engine.compile(sql)
    b = fn().to_pandas().s[0]
    assert a == pytest.approx(np.arange(9000, 10000).sum() * 1.5)
    assert b == pytest.approx(a)
    assert reference.compile(sql)().to_pandas().s[0] == pytest.approx(b)


@pytest.mark.parametrize("discovery", ["full", "sampled"])
def test_compiled_with_domain_full_and_sampled_discovery(root, reference,
                                                         discovery):
    """Twin of ``test_cpu_proxy_path_compiled_with_domain``.  That case
    forces the JAX package's accelerator-only discovery proxy
    (``_CpuCatalogProxy``), which the port does not have: the port
    discovers on the device it runs on.  Its counterpart here is the
    compiled statement with a domain pushed into a Parquet scan, discovered
    over the whole table and over a prefix sample of it
    (``exec/sampling.py``), equal to the reference's eager answer."""
    sql = ("select sum(val) s, count(*) c from facts "
           "where id >= 9000 and grp <> 6")
    eng = Engine(FileCatalog(root, device="cpu"), device="cpu")
    sample = None if discovery == "full" else {"facts": 4}
    cq = eng.compile(sql, sample=sample)
    assert (cq.sample is None) == (sample is None)
    out = cq().to_pandas()
    want = reference.sql(sql).to_pandas()
    exp = [(i, i * 1.5) for i in range(9000, 10000) if i % 7 != 6]
    assert int(out.c[0]) == int(want.c[0]) == len(exp)
    assert out.s[0] == pytest.approx(want.s[0], rel=1e-6)
    assert out.s[0] == pytest.approx(sum(v for _, v in exp))


def test_pruned_view_covers_the_table_surface(root):
    """Twin of ``test_cpu_table_proxy_covers_full_table_surface``, whose
    subject (``_CpuTableProxy``, JAX package only) the port does not have.
    The port's counterpart: a pruned Parquet view is a ``Table`` of its
    own, and every public attribute of the port's ``Table`` resolves on it,
    with the table's device, unique keys and columns."""
    from presto1_tpu_torch.exec.catalog import Table

    table = FileCatalog(root, device="cpu").table("facts")
    table.unique_keys = [("id",)]
    view = table.pruned(domains_from_conjuncts([
        t_ir.call(">=", t_ir.ColumnRef("id", t_types.BIGINT),
                  t_ir.Literal(9000, t_types.BIGINT))]))
    assert isinstance(view, Table) and view.num_rows == 1000
    for name in dir(Table):
        if not name.startswith("_"):
            getattr(view, name)  # must not raise
    assert view.device == table.device == torch.device("cpu")
    assert view.unique_keys == table.unique_keys
    assert view.column_order == table.column_order
    assert view.sort_columns == table.sort_columns
    assert view.schema == table.schema
    col = view.column("id")
    assert col.data.device.type == "cpu"
    assert col.data.tolist() == list(range(9000, 10000))
    assert view.column_range("id") == (9000, 9999)
    assert view.batch(["id", "grp"]).num_rows == 1000


@pytest.fixture(scope="module")
def mixed_root(tmp_path_factory):
    """A double, a decimal(12, 2) and a bigint column in 10 row groups."""
    import decimal

    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("mixed")
    n = 100
    pq.write_table(pa.table({
        "x": pa.array(np.linspace(0, 0.1, n)),
        "q": pa.array([decimal.Decimal(i) for i in range(1, n + 1)],
                      pa.decimal128(12, 2)),
        "i": pa.array(np.arange(n))}), d / "t.parquet", row_group_size=10)
    return str(d)


@pytest.mark.parametrize("pred", [
    "x between 0.05 and 0.07", "x > 0.095", "q < 24", "q = 50",
    "q > 90.5", "i < 24.5", "q in (3, 97)"])
def test_literal_bounds_in_the_column_unit_c28(mixed_root, pred):
    """A pushed-down bound is in the unit the column stores (a decimal
    column's unscaled integer, a double as itself), so row-group pruning
    keeps every group that holds an answer: the count equals pandas'.  The
    JAX package keeps the literal's unit (``x between 0.05 and 0.07`` as
    [5, 7], ``q < 24`` as 24 against unscaled statistics) and prunes the
    answers away: 0 rows for all but ``q > 90.5`` and ``i < 24.5``, whose
    bounds in the wrong unit only keep too many groups."""
    x = pd.read_parquet(f"{mixed_root}/t.parquet")
    q, i = x.q.astype(float), x.i
    x = x.x
    want = int({"x between 0.05 and 0.07": (x >= 0.05) & (x <= 0.07),
                "x > 0.095": x > 0.095, "q < 24": q < 24, "q = 50": q == 50,
                "q > 90.5": q > 90.5, "i < 24.5": i < 24.5,
                "q in (3, 97)": q.isin([3, 97])}[pred].sum())
    assert want > 0
    sql = f"select count(*) c from t where {pred}"
    e = Engine(FileCatalog(mixed_root, device="cpu"), device="cpu")
    assert e.sql(sql).to_pylist() == [(want,)]
    assert e.compile(sql)().to_pylist() == [(want,)]
    ref = JEngine(JFileCatalog(mixed_root)).sql(sql).to_pylist()[0][0]
    if pred not in ("q > 90.5", "i < 24.5"):
        assert ref == 0
    else:
        assert ref == want
