"""ROW types in the port: the cases of ``tests/test_row_type.py``
retargeted to ``presto1_tpu_torch`` on the CPU at SF 0.001.  Every
statement runs through the JAX package's engine as well and the two answers
are held equal (integers exact, doubles to 1e-6 relative); a statement the
reference refuses at planning the port refuses too.
"""

import numpy as np
import pytest
import torch

import presto1_tpu.types as j_types
import presto1_tpu_torch.types as t_types
from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu.sql.planner import PlanError as JPlanError
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.sql.planner import PlanError

from torch_parity import same_answer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu"),
            JEngine(JTpchCatalog(sf=0.001)))


def _li(engine, cols):
    return engine.catalog.table("lineitem").batch(cols).to_pandas()


def test_row_type_str_roundtrip():
    for types in (t_types, j_types):
        t = types.RowType([("a", types.BIGINT), ("b", types.VARCHAR),
                           ("c", types.DecimalType(10, 2))])
        assert str(t) == "row(a bigint,b varchar,c decimal(10,2))"
        rt = types.parse_type_str(str(t))
        assert rt == t
        anon = types.parse_type_str("row(bigint, varchar)")
        assert anon.fields[0] == ("f0", types.parse_type_str("bigint"))
        assert anon.fields[1] == ("f1", types.parse_type_str("varchar"))


def test_row_construct_and_flatten_output(engines):
    out = same_answer(*engines,
                      "select row(l_orderkey, l_quantity) r from lineitem "
                      "limit 3")
    # a bare row select item flattens to one column per field
    assert list(out.columns) == ["r.f0", "r.f1"]
    li = _li(engines[0], ["l_orderkey", "l_quantity"])
    assert list(out["r.f0"]) == list(li.l_orderkey[:3])


def test_row_field_access_through_subquery(engines):
    out = same_answer(*engines,
                      "select r.ok + 1 x, r.qty q from "
                      "(select cast(row(l_orderkey, l_quantity) as "
                      " row(ok bigint, qty double)) r from lineitem) t "
                      "limit 4")
    li = _li(engines[0], ["l_orderkey", "l_quantity"])
    assert list(out.x) == list(li.l_orderkey[:4] + 1)
    assert np.allclose(out.q, li.l_quantity[:4].astype(float))


def test_row_subscript(engines):
    out = same_answer(*engines,
                      "select row(l_orderkey, l_partkey)[2] p from lineitem "
                      "limit 3")
    li = _li(engines[0], ["l_partkey"])
    assert list(out.p) == list(li.l_partkey[:3])


def test_row_through_filter_and_where_on_field(engines):
    out = same_answer(*engines,
                      "select r.ok k from "
                      "(select cast(row(l_orderkey, l_quantity) as "
                      " row(ok bigint, qty double)) r from lineitem) t "
                      "where r.qty > 30 limit 5")
    li = _li(engines[0], ["l_orderkey", "l_quantity"])
    exp = li[li.l_quantity.astype(float) > 30].l_orderkey
    assert list(out.k) == list(exp[:5])


def test_row_star_flattens(engines):
    out = same_answer(*engines,
                      "select * from (select cast(row(l_orderkey, "
                      "l_linenumber) as row(a bigint, b integer)) r from "
                      "lineitem) t limit 2")
    assert list(out.columns) == ["r.a", "r.b"]


def test_row_aggregate_over_field(engines):
    out = same_answer(*engines,
                      "select sum(r.f0) s from "
                      "(select row(l_quantity) r from lineitem) t")
    li = _li(engines[0], ["l_quantity"])
    assert np.isclose(float(out.s[0]), float(li.l_quantity.sum()))


def _refused(engines, sql):
    engine, reference = engines
    with pytest.raises(JPlanError):
        reference.plan(sql)
    with pytest.raises(PlanError):
        engine.plan(sql)


def test_row_excluded_from_order_by(engines):
    _refused(engines, "select row(l_orderkey, l_partkey) r from lineitem "
                      "order by r")


def test_row_comparison_rejected(engines):
    _refused(engines, "select 1 from lineitem "
                      "where row(l_orderkey, 1) = row(l_orderkey, 2)")


def test_row_cast_mismatch_rejected(engines):
    _refused(engines,
             "select cast(row(1, 2) as row(a bigint)) from lineitem")


def test_row_field_not_found(engines):
    _refused(engines, "select r.nope from (select cast(row(1) as row(a "
                      "bigint)) r from lineitem) t")


def test_row_serde_through_pages():
    """Row field columns are plain columns on the wire; the TYPE string
    roundtrips through the page header, and reads the same in the JAX
    package."""
    t = t_types.parse_type_str("row(a bigint,b varchar)")
    assert t_types.parse_type_str(str(t)) == t
    assert str(j_types.parse_type_str(str(t))) == str(t)
