"""approx_distinct's device hashes in the port (``expr/eval.py``:
``_splitmix63``, ``__hll_hash`` / ``__hll_reg`` / ``__hll_rho``, the
leading-zero count ``_clz64``) against the JAX package on the CPU: the
four approx_distinct statements of ``tests/test_stat_aggs.py`` through both
engines at SF 0.001, eager and compiled (the registers are integers, so the
estimates agree to 1e-12 relative: here they are equal), and each function
on seeded values and on the edges: every power of two and its neighbours,
-0.0, NaN, infinities, INT64_MIN and INT64_MAX.
"""

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.expr.eval as j_eval
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.expr.eval as t_eval

from torch_parity import J, T, assert_columns_equal, both_batches, \
    no_host_sync

torch.set_num_threads(1)

STATEMENTS = {
    "hll_accuracy": "select approx_distinct(l_orderkey) d from lineitem",
    "small_linear_counting_flag":
        "select approx_distinct(l_returnflag) d from lineitem",
    "small_linear_counting_status":
        "select approx_distinct(l_linestatus) e from lineitem",
    "grouped_with_plain_aggs":
        "select l_returnflag f, approx_distinct(l_suppkey) d, count(*) c, "
        "sum(l_quantity) s from lineitem group by l_returnflag "
        "order by l_returnflag",
    "strings_match_value_semantics":
        "select approx_distinct(l_shipinstruct) d from lineitem",
    "double_column": "select approx_distinct(l_extendedprice * 1.5e0) d "
                     "from lineitem",
}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_approx_distinct_matches_reference(engines, name, mode,
                                           monkeypatch):
    je, te = engines
    sql = STATEMENTS[name]
    want = je.sql(sql).to_pylist()
    if mode == "sql":
        got = te.sql(sql).to_pylist()
    else:
        cq = te.compile(sql)
        got = cq().to_pylist()
        with monkeypatch.context() as m:
            no_host_sync(m)
            cq._run()
    assert got == want


def test_estimate_is_near_the_exact_count(engines):
    _, te = engines
    li = te.catalog.table("lineitem").batch(["l_orderkey"]).to_pandas()
    est = te.sql(STATEMENTS["hll_accuracy"]).to_pylist()[0][0]
    true = li.l_orderkey.nunique()
    assert abs(est - true) <= max(4 * 0.023 * true, 2)


def _powers_and_neighbours():
    vals = []
    for k in range(64):
        p = 1 << k
        vals += [p - 1, p, p + 1]
    vals = [v if v < (1 << 63) else v - (1 << 64) for v in vals]
    return np.array(sorted(set(vals)), dtype=np.int64)


def test_clz64_at_every_power_of_two():
    """The binary-search leading-zero count equals Python's bit_length at
    every power of two and its neighbours over the 64-bit range (a float64
    ``log2`` of ``2**k - 1`` rounds up to ``k`` for large ``k``)."""
    v = _powers_and_neighbours()
    got = t_eval._clz64(torch.from_numpy(v)).numpy()
    want = [64 - (int(x) % (1 << 64)).bit_length() for x in v]
    assert got.tolist() == want


def test_rho_at_every_power_of_two():
    """``__hll_rho`` of hashes whose window (bits 11..62) is a power of two
    or a neighbour, and of 0: equal to the JAX package's ``clz``."""
    w = _powers_and_neighbours()
    w = w[(w >= 0) & (w < (1 << 52))]
    h = np.concatenate([w << 11, (w << 11) | 2047, [0, 2047]])
    jb, tb = both_batches({"h": (h, None, "bigint")})
    e = lambda I: I.call("__hll_rho", I.col("h", I.BIGINT),  # noqa: E731
                         type=I.BIGINT)
    jout = j_eval.eval_expr(e(J), jb)
    tout = t_eval.eval_expr(e(T), tb)
    assert_columns_equal(jout, tout)
    assert tout.data.numpy()[-2:].tolist() == [53, 53]


_EDGE_DOUBLES = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5,
                          5e-324, 1.7976931348623157e308, 2.0 ** 52])
_EDGE_INTS = np.array([0, 1, -1, np.iinfo(np.int64).min,
                       np.iinfo(np.int64).max, 1 << 32, -(1 << 32)],
                      dtype=np.int64)


@pytest.mark.parametrize("tstr", ["bigint", "double", "decimal(12,2)",
                                  "integer", "real"])
def test_hll_functions_match_reference(tstr):
    rng = np.random.default_rng(len(tstr))
    if tstr == "double":
        v = np.concatenate([_EDGE_DOUBLES, rng.normal(0, 1e6, 200)])
    elif tstr == "real":
        with np.errstate(over="ignore"):  # the largest double is inf here
            edges = _EDGE_DOUBLES.astype(np.float32)
        v = np.concatenate([edges,
                            rng.normal(0, 1e3, 200).astype(np.float32)])
    elif tstr == "integer":
        v = rng.integers(-2**31, 2**31 - 1, 207).astype(np.int32)
    else:
        v = np.concatenate([_EDGE_INTS, rng.integers(-2**62, 2**62, 200)])
    valid = rng.random(len(v)) < 0.9
    jb, tb = both_batches({"v": (v, valid, tstr)})

    def exprs(I):
        t = jb["v"].type if I is J else tb["v"].type
        h = I.call("__hll_hash", I.col("v", t), type=I.BIGINT)
        return {"hash": h,
                "reg": I.call("__hll_reg", h, type=I.BIGINT),
                "rho": I.call("__hll_rho", h, type=I.BIGINT)}

    jx, tx = exprs(J), exprs(T)
    for name in jx:
        assert_columns_equal(j_eval.eval_expr(jx[name], jb),
                             t_eval.eval_expr(tx[name], tb),
                             what=f"{tstr} {name}")


def test_splitmix63_matches_the_host_version():
    v = np.concatenate([_EDGE_INTS, np.random.default_rng(3).integers(
        -2**63, 2**63 - 1, 1000, dtype=np.int64)])
    got = t_eval._splitmix63(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, t_eval._splitmix63_host(v))
    np.testing.assert_array_equal(got, j_eval._splitmix63_host(v))
    assert (got >= 0).all()
