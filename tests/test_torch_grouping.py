"""grouping(c1, ..., cn) in the port: Trino's BIGINT bitmask, bit n-i set
where ci is not in the row's grouping set, over ROLLUP, CUBE, explicit
GROUPING SETS and a plain GROUP BY (where it is 0), in SELECT, HAVING and
ORDER BY, eager and compiled, against a pandas oracle at SF 0.01 and
hand answers; and the PlanError for an argument that is no grouping
column."""

import pytest
import torch

from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.session import Session
from presto1_tpu_torch.sql.planner import PlanError

torch.set_num_threads(1)

M, N = "c_mktsegment", "c_nationkey"
# (GROUP BY clause, its grouping sets, the grouping() calls' arguments)
CASES = {
    "rollup": (f"rollup({M}, {N})", [(M, N), (M,), ()], [[N], [M, N]]),
    "cube": (f"cube({M}, {N})", [(M, N), (M,), (N,), ()], [[N, M], [M]]),
    "sets": (f"grouping sets (({M}), ({N}), ())", [(M,), (N,), ()],
             [[M], [M, N], [N, M]]),
    "plain": (f"{M}, {N}", [(M, N)], [[M, N], [N]]),
}


@pytest.fixture(scope="module")
def catalog():
    return TpchCatalog("tiny", device="cpu")


@pytest.fixture(scope="module")
def customers(catalog):
    return catalog.table("customer").batch([M, N, "c_custkey"]).to_pandas()


def engine(catalog, compiled: bool) -> Engine:
    session = Session()
    session.set("compile_queries", compiled)
    return Engine(catalog, session=session, device="cpu")


def run(catalog, compiled: bool, sql: str) -> list:
    eng = engine(catalog, compiled)
    rows = eng.sql(sql).to_pylist()
    if compiled:  # the second call runs the compiled fragments
        rows = eng.sql(sql).to_pylist()
    return [tuple(None if v is None else (v if isinstance(v, str)
                                          else int(v)) for v in r)
            for r in rows]


def text(clause: str, calls) -> str:
    gs = ", ".join(f"grouping({', '.join(a)}) g{k}"
                   for k, a in enumerate(calls))
    return (f"select {M}, {N}, {gs}, count(*) c, sum(c_custkey) s "
            f"from customer group by {clause}")


def oracle(df, sets, calls) -> list:
    """Every grouping set's groups: the absent columns NULL, each call's
    bitmask, the count and the sum."""
    rows = []
    for st in sets:
        groups = df.groupby(list(st)) if st else [((), df)]
        for key, g in groups:
            key = key if isinstance(key, tuple) else (key,)
            val = dict(zip(st, key))
            masks = [sum(1 << (len(a) - 1 - i) for i, c in enumerate(a)
                         if c not in st) for a in calls]
            rows.append((val.get(M), None if N not in val else int(val[N]),
                         *masks, len(g), int(g.c_custkey.sum())))
    return rows


def order(rows) -> list:
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             else 0) for v in r))


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("case", list(CASES))
def test_grouping_in_select(catalog, customers, case, compiled):
    clause, sets, calls = CASES[case]
    got = run(catalog, compiled, text(clause, calls))
    assert order(got) == order(oracle(customers, sets, calls))


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("case", ["rollup", "cube", "sets"])
def test_grouping_in_having(catalog, customers, case, compiled):
    clause, sets, calls = CASES[case]
    sql = text(clause, calls) + f" having grouping({M}, {N}) = 1"
    # the oracle's last mask is grouping(M, N): HAVING keeps its 1s
    want = [r[:-3] + r[-2:] for r in oracle(customers, sets,
                                            calls + [[M, N]])
            if r[-3] == 1]
    assert want, "the case has rows at that level"
    assert order(run(catalog, compiled, sql)) == order(want)


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
def test_grouping_in_order_by(catalog, customers, compiled):
    clause, sets, calls = CASES["cube"]
    sql = (text(clause, calls) + f" order by grouping({M}, {N}) desc, "
           f"g0, {M}, {N} limit 12")
    rows = oracle(customers, sets, calls + [[M, N]])
    rows.sort(key=lambda r: (-r[-3], r[2], r[0] is None, r[0] or "",
                             r[1] is None, r[1] or 0))
    assert run(catalog, compiled, sql) == [r[:-3] + r[-2:]
                                           for r in rows[:12]]


def test_hand_answers(catalog):
    """The bitmask of one and two arguments, by hand: region 0's nations."""
    sql = ("select n_regionkey r, n_name n, grouping(n_regionkey, n_name) a, "
           "grouping(n_name, n_regionkey) b, grouping(n_regionkey) c, "
           "count(*) k from nation where n_regionkey = 0 group by "
           "rollup(n_regionkey, n_name) order by a, n")
    got = run(catalog, False, sql)
    assert got[:2] == [(0, "ALGERIA", 0, 0, 0, 1),
                       (0, "ETHIOPIA", 0, 0, 0, 1)]
    assert got[-2:] == [(0, None, 1, 2, 0, 5), (None, None, 3, 3, 1, 5)]
    assert len(got) == 7


@pytest.mark.parametrize("sql,arg", [
    (f"select {M}, grouping(c_name) from customer group by rollup({M})",
     "c_name"),
    (f"select {M}, grouping({M}, c_phone) from customer group by {M}",
     "c_phone"),
    ("select grouping(c_nationkey) from customer", "GROUP BY"),
])
def test_argument_that_is_no_grouping_column_is_a_plan_error(catalog, sql,
                                                              arg):
    with pytest.raises(PlanError, match=arg):
        engine(catalog, False).sql(sql)
