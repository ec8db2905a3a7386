"""Arrays, maps and lambdas in the port (``expr/eval.py``: ``_Nested``,
``_eval_array_fn``; ``Executor._x_Unnest``) against the JAX package on the
CPU: the statements of ``tests/test_arrays.py`` through both engines at
SF 0.001, eager and compiled, and each array function on seeded ``[n, W]``
element matrices with lengths 0..W (W = 0 included) through both
evaluators.

Integers, dictionary codes, validity, lengths and every lane of the element
matrices exact (the lanes past a row's length too: they are the reference's
contract for ``filter`` and ``transform``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.expr.eval as j_eval
import presto1_tpu.expr.ir as j_ir
import presto1_tpu.types as j_types
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.expr.eval as t_eval
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.types as t_types
from presto1_tpu.batch import Column as JColumn, RecordBatch as JRecordBatch
from presto1_tpu_torch.batch import Column as TColumn, \
    RecordBatch as TRecordBatch

from torch_parity import assert_columns_equal, no_host_sync

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


def _one(expr):
    return f"select {expr} v from nation where n_nationkey = 0"


# the statements of tests/test_arrays.py, by the test that runs them
CASES = {
    "array_literal_and_cardinality": [
        _one("array[1, 2, 3]"), _one("cardinality(array[1, 2, 3])"),
        _one("cardinality(array[])")],
    "element_at_and_subscript": [
        _one("element_at(array[10, 20, 30], 2)"),
        _one("array[10, 20, 30][3]"), _one("element_at(array[10, 20], -1)"),
        _one("element_at(array[10, 20], 5)")],
    "contains_position_minmax": [
        _one("contains(array[1, 5, 9], 5)"),
        _one("contains(array[1, 5, 9], 4)"),
        _one("array_position(array[7, 8, 9], 9)"),
        _one("array_position(array[7, 8], 99)"),
        _one("array_min(array[5, 2, 8])"), _one("array_max(array[5, 2, 8])")],
    "array_concat": [_one("array[1, 2] || array[3]"),
                     _one("array_concat(array[1], array[2, 3])")],
    "lambdas": [
        _one("transform(array[1, 2, 3], x -> x * 10)"),
        _one("filter(array[5, 2, 8, 1], x -> x > 2)"),
        _one("any_match(array[1, 2], x -> x = 2)"),
        _one("all_match(array[1, 2], x -> x > 0)"),
        _one("none_match(array[1, 2], x -> x > 5)")],
    "lambda_with_outer_column": [
        "select n_nationkey k, transform(array[1, 2], x -> x + n_nationkey)"
        " v from nation where n_nationkey < 3 order by k"],
    "map_functions": [
        _one("cardinality(map(array[1, 2], array[10, 20]))"),
        _one("element_at(map(array[1, 2], array[10, 20]), 2)"),
        _one("element_at(map(array[1, 2], array[10, 20]), 9)"),
        _one("map_keys(map(array[1, 2], array[10, 20]))"),
        _one("map_values(map(array[1, 2], array[10, 20]))"),
        _one("map(array[1, 2], array[10, 20])")],
    "string_array_literal": [_one("cardinality(array['a', 'b'])")],
    "arrays_from_table_columns": [
        "select n_nationkey k, array[n_nationkey, n_regionkey] a "
        "from nation order by k limit 3"],
    "array_through_filter_and_sort": [
        "select n_nationkey k, transform(array[n_regionkey], x -> x * 2) a "
        "from nation where n_regionkey = 1 order by n_nationkey desc"],
    "unnest_standalone": [
        "select col from unnest(array[3, 1, 2]) as t(col) order by col"],
    "unnest_cross_join": [
        "select n_nationkey k, e from nation "
        "cross join unnest(array[n_nationkey, n_nationkey * 10]) as u(e) "
        "where n_nationkey < 3 order by k, e"],
    "unnest_map": [
        "select k, v from unnest(map(array[1, 2], array[10, 20])) "
        "as t(k, v) order by k"],
    "unnest_aggregate": [
        "select sum(e) s, count(*) c from nation "
        "cross join unnest(array[1, 2, 3]) as u(e)"],
    "lambda_empty_array": [
        _one("transform(array[], x -> x)"), _one("filter(array[], x -> x > 0)"),
        _one("any_match(array[], x -> x = 1)"),
        _one("all_match(array[], x -> x = 1)"),
        _one("none_match(array[], x -> x = 1)")],
    "unnest_empty_array": [
        "select n_nationkey k, e from nation "
        "cross join unnest(array[]) as u(e)"],
}


def assert_nested_equal(jcol, tcol, rows, what=""):
    """``assert_columns_equal`` plus a nested column's lengths and map
    values."""
    assert_columns_equal(jcol, tcol, rows=rows, what=what)
    assert (jcol.lengths is None) == (tcol.lengths is None), what
    if jcol.lengths is not None:
        np.testing.assert_array_equal(np.asarray(jcol.lengths)[:rows],
                                      tcol.lengths.numpy()[:rows],
                                      err_msg=what)
    assert (jcol.map_values is None) == (tcol.map_values is None), what
    if jcol.map_values is not None:
        np.testing.assert_array_equal(np.asarray(jcol.map_values)[:rows],
                                      tcol.map_values.numpy()[:rows],
                                      err_msg=what)


def assert_results_equal(jb, tb, what=""):
    assert list(jb.columns) == list(tb.columns), what
    n = int(jb.num_rows)
    assert n == int(tb.num_rows), (what, n, int(tb.num_rows))
    for name in jb.columns:
        assert_nested_equal(jb[name], tb[name], n, f"{what}:{name}")
    assert tb.to_pylist() == jb.to_pylist(), what


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_statements_of_test_arrays(engines, case, mode, monkeypatch):
    je, te = engines
    for sql in CASES[case]:
        want = je.sql(sql)
        if mode == "sql":
            got = te.sql(sql)
        else:
            cq = te.compile(sql)
            got = cq()
            # a compiled run waits for nothing between start and readback
            with monkeypatch.context() as m:
                no_host_sync(m)
                cq._run()
        assert_results_equal(want, got, f"{case}: {sql}")


def test_parse_type_roundtrip():
    for s in ["array(bigint)", "map(varchar,bigint)",
              "array(decimal(12,2))", "map(bigint,array(bigint))"]:
        assert str(t_types.parse_type_str(s)) == s == \
            str(j_types.parse_type_str(s))


def test_array_wire_roundtrip():
    """Array and map columns through the port's page serde, and the same
    bytes as the JAX package's."""
    from presto1_tpu.exec import pages as JP
    from presto1_tpu_torch.exec import pages as TP

    a = np.array([[1, 2, 0], [3, 0, 0]], np.int64)
    al = np.array([2, 1], np.int32)
    m, mv = np.array([[1, 2], [7, 0]]), np.array([[10, 20], [70, 0]])
    ml = np.array([2, 1], np.int32)
    at, mt = t_types.ArrayType(t_types.BIGINT), \
        t_types.MapType(t_types.BIGINT, t_types.BIGINT)
    tb = TRecordBatch({
        "a": TColumn(torch.from_numpy(a), at, lengths=torch.from_numpy(al)),
        "m": TColumn(torch.from_numpy(m), mt, lengths=torch.from_numpy(ml),
                     map_values=torch.from_numpy(mv))}, 2)
    jb = JRecordBatch({
        "a": JColumn(jnp.asarray(a), j_types.ArrayType(j_types.BIGINT),
                     lengths=jnp.asarray(al)),
        "m": JColumn(jnp.asarray(m), j_types.MapType(j_types.BIGINT,
                                                     j_types.BIGINT),
                     lengths=jnp.asarray(ml), map_values=jnp.asarray(mv))},
        2)
    page = TP.serialize_batch(tb)
    assert page == JP.serialize_batch(jb)
    rt = TP.deserialize_batch(page)
    assert rt["a"].decode(2).tolist() == [[1, 2], [3]]
    assert rt["m"].decode(2).tolist() == [{1: 10, 2: 20}, {7: 70}]


# ---- op level: each array function on seeded [n, W] element matrices


N = 37


def _nested_batch(width: int, seed: int, valid_share=0.8):
    """Both packages' batches of the same seeded numpy columns: ``a`` an
    array(bigint) of width ``width`` (lengths 0..W, some rows NULL), ``c``
    a second array of width ``width + 1``, ``k`` a map(bigint, bigint), and
    flat ``i`` (an index in -W-2..W+2) and ``b`` (a bigint)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-6, 7, (N, width)).astype(np.int64)
    al = rng.integers(0, width + 1, N).astype(np.int32)
    av = rng.random(N) < valid_share
    c = rng.integers(-6, 7, (N, width + 1)).astype(np.int64)
    cl = rng.integers(0, width + 2, N).astype(np.int32)
    # map keys distinct within a row: a permutation of 0..W-1 plus 1
    keys = np.argsort(rng.random((N, width)), axis=1).astype(np.int64) + 1
    vals = rng.integers(-50, 50, (N, width)).astype(np.int64)
    i = rng.integers(-width - 2, width + 3, N).astype(np.int32)
    b = rng.integers(-6, 7, N).astype(np.int64)
    spec = {"a": (a, al, av, "array(bigint)", None),
            "c": (c, cl, None, "array(bigint)", None),
            "k": (keys, al, None, "map(bigint,bigint)", vals),
            "i": (i, None, None, "integer", None),
            "b": (b, None, None, "bigint", None)}
    jcols, tcols = {}, {}
    for name, (data, lens, valid, tstr, mv) in spec.items():
        jcols[name] = JColumn(
            jnp.asarray(data), j_types.parse_type_str(tstr),
            validity=None if valid is None else jnp.asarray(valid),
            lengths=None if lens is None else jnp.asarray(lens),
            map_values=None if mv is None else jnp.asarray(mv))
        tcols[name] = TColumn(
            torch.from_numpy(data.copy()), t_types.parse_type_str(tstr),
            validity=None if valid is None else torch.from_numpy(valid),
            lengths=None if lens is None else torch.from_numpy(lens.copy()),
            map_values=None if mv is None else torch.from_numpy(mv.copy()))
    return JRecordBatch(jcols, N), TRecordBatch(tcols, N)


def _expr(I, ir, types, fn):
    """``fn`` over the nested batch's columns, built with one package's
    IR."""
    arr_t = types.ArrayType(types.BIGINT)
    map_t = types.MapType(types.BIGINT, types.BIGINT)
    a, c = ir.col("a", arr_t), ir.col("c", arr_t)
    k = ir.col("k", map_t)
    i, b = ir.col("i", types.INTEGER), ir.col("b", types.BIGINT)
    call, lit = ir.call, ir.lit
    BIGINT, BOOLEAN = types.BIGINT, types.BOOLEAN

    def lam(body, t=arr_t):
        return ir.Lambda(("x",), body, t)

    x = ir.col("x", BIGINT)
    return {
        "cardinality": lambda: call("cardinality", a, type=BIGINT),
        "element_at": lambda: call("element_at", a, i, type=BIGINT),
        "element_at_map": lambda: call("element_at", k, b, type=BIGINT),
        "contains": lambda: call("contains", a, b, type=BOOLEAN),
        "array_position": lambda: call("array_position", a, b, type=BIGINT),
        "array_min": lambda: call("array_min", a, type=BIGINT),
        "array_max": lambda: call("array_max", a, type=BIGINT),
        "array_concat": lambda: call("array_concat", a, c, type=arr_t),
        "map": lambda: call("map", a, c, type=map_t),
        "map_keys": lambda: call("map_keys", k, type=arr_t),
        "map_values": lambda: call("map_values", k, type=arr_t),
        "transform": lambda: call(
            "transform", a, lam(call("+", call("*", x, lit(2), type=BIGINT),
                                     b, type=BIGINT)), type=arr_t),
        "filter": lambda: call(
            "filter", a, lam(call(">", x, b, type=BOOLEAN)), type=arr_t),
        "any_match": lambda: call(
            "any_match", a, lam(call(">", x, b, type=BOOLEAN)), type=BOOLEAN),
        "all_match": lambda: call(
            "all_match", a, lam(call(">", x, lit(-3), type=BOOLEAN)),
            type=BOOLEAN),
        "none_match": lambda: call(
            "none_match", a, lam(call("=", x, b, type=BOOLEAN)),
            type=BOOLEAN),
    }[fn]()


FNS = ["cardinality", "element_at", "element_at_map", "contains",
       "array_position", "array_min", "array_max", "array_concat", "map",
       "map_keys", "map_values", "transform", "filter", "any_match",
       "all_match", "none_match"]
# over a zero-width matrix the JAX package's min / max / argmax have no
# identity and raise; the port answers what an empty array gives (NULL, and
# position 0)
_REFERENCE_RAISES = {("array_min", 0), ("array_max", 0),
                     ("array_position", 0), ("element_at_map", 0)}


@pytest.mark.parametrize("width", [0, 1, 3, 5])
@pytest.mark.parametrize("fn", FNS)
def test_array_function_matches_reference(fn, width):
    jb, tb = _nested_batch(width, seed=width * 31 + FNS.index(fn))
    te = _expr(None, t_ir, t_types, fn)
    tout = t_eval.eval_expr(te, tb)
    if (fn, width) in _REFERENCE_RAISES:
        with pytest.raises(ValueError):
            j_eval.eval_expr(_expr(None, j_ir, j_types, fn), jb)
        if fn == "array_position":
            assert not tout.data.any()
        else:
            assert not tout.validity.any()
        return
    jout = j_eval.eval_expr(_expr(None, j_ir, j_types, fn), jb)
    assert_nested_equal(jout, tout, N, f"{fn} W={width}")


def test_element_at_reads_through_take_along_axis(monkeypatch):
    """``element_at`` and subscripts read one lane a row through the gather
    kernel's ``take_along_axis``, lanes clamped by the wrapper."""
    from presto1_tpu_torch.ops.kernels import gather as G

    calls = []
    real = G.take_along_axis

    def spy(x, idx, axis):
        calls.append((tuple(x.shape), tuple(idx.shape), axis))
        return real(x, idx, axis)

    monkeypatch.setattr(G, "take_along_axis", spy)
    _, tb = _nested_batch(3, seed=5)
    t_eval.eval_expr(_expr(None, t_ir, t_types, "element_at"), tb)
    assert calls == [((N, 3), (N, 1), 1)]


def test_lambda_outer_columns_move_in_one_gather(monkeypatch):
    """A lambda's outer columns repeat over the element space through one
    ``gather_rows`` launch at ``i // W``."""
    from presto1_tpu_torch.ops.kernels import gather as G

    calls = []
    real = G.gather_rows

    def spy(sources, idx):
        calls.append((len(sources), idx.tolist()))
        return real(sources, idx)

    monkeypatch.setattr(G, "gather_rows", spy)
    _, tb = _nested_batch(3, seed=6)
    t_eval.eval_expr(_expr(None, t_ir, t_types, "transform"), tb)
    assert calls == [(1, [r // 3 for r in range(N * 3)])]


# ---- reference defects the port does not copy (ROADMAP C11-C13)


def test_unnest_keeps_the_array_columns_c11(engines):
    """The JAX package's column pruning drops the columns only the UNNEST
    expression reads (KeyError at execution); the port keeps them."""
    je, te = engines
    sql = ("select count(*), sum(e), max(e) from lineitem cross join "
           "unnest(filter(array[l_partkey, l_suppkey, l_orderkey], "
           "x -> x % 3 = 0)) as t(e)")
    with pytest.raises(KeyError, match="l_partkey"):
        je.sql(sql)
    li = te.catalog.table("lineitem").batch(
        ["l_partkey", "l_suppkey", "l_orderkey"]).to_pandas()
    v = np.concatenate([li[c].to_numpy() for c in li.columns])
    v = v[v % 3 == 0]
    want = [(len(v), int(v.sum()), int(v.max()))]
    assert te.sql(sql).to_pylist() == want
    assert te.compile(sql)().to_pylist() == want


def test_mixed_element_types_c12(engines):
    """An array literal of integer and bigint elements: the JAX package's
    planner names ``common_supertype`` without importing it (NameError);
    the port widens the elements to bigint."""
    je, te = engines
    sql = ("select array[n_regionkey, cast(n_nationkey as integer)] a "
           "from nation order by n_nationkey limit 3")
    with pytest.raises(NameError, match="common_supertype"):
        je.sql(sql)
    got = te.sql(sql)
    assert str(got["a"].type) == "array(bigint)"
    assert got.to_pylist() == [([0, 0],), ([1, 1],), ([1, 2],)]


def test_compiled_nested_output_keeps_its_lengths_c13(engines):
    """The JAX package's compiled fragments return a nested column without
    its lengths, so every lane reads as an element (``filter``'s dropped
    lanes too); the port's carry lengths and map values through."""
    je, te = engines
    sql = _one("filter(array[5, 2, 8, 1], x -> x > 2)")
    assert je.compile(sql)()["v"].lengths is None
    assert [list(r[0]) for r in je.compile(sql)().to_pylist()] == \
        [[5, 8, 2, 1]]
    got = te.compile(sql)()
    assert got.to_pylist() == je.sql(sql).to_pylist() == [([5, 8],)]
    m = te.compile(_one("map(array[1, 2], array[10, 20])"))()
    assert m.to_pylist() == [({1: 10, 2: 20},)]


# ---- C26: the lanes of one nested value from string columns with
# different dictionaries

_C26_FROM = ("from nation, region where n_regionkey = r_regionkey "
             "order by n_name limit 3")
C26_CASES = {
    "array_ctor": (f"select n_name, element_at(array[n_name, r_name], 2) b "
                   f"{_C26_FROM}", lambda df: df.r_name),
    "array_concat": ("select n_name, element_at(array[n_name, n_comment] "
                     f"|| array[r_name, r_comment], 3) b {_C26_FROM}",
                     lambda df: df.r_name),
    "map": ("select n_name, element_at(map(array[n_name, n_comment], "
            f"array[r_name, r_comment]), n_name) b {_C26_FROM}",
            lambda df: df.r_name),
    "array_position": ("select n_name, array_position(array[n_name, "
                       f"r_name], r_name) b {_C26_FROM}",
                       lambda df: [2] * len(df)),
}


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("case", sorted(C26_CASES))
def test_lanes_of_two_dictionaries_c26(engines, case, mode, monkeypatch):
    """An array (or a map, or two arrays concatenated) whose string lanes
    come from columns with different dictionaries: the JAX package reads
    every lane through the first one's dictionary, so ``element_at(array[
    n_name, r_name], 2)`` answers ALGERIA, ARGENTINA, ARGENTINA; the port
    merges the dictionaries and answers each row's region name, as pandas
    does over the same tables."""
    _, te = engines
    sql, want_b = C26_CASES[case]
    n = te.catalog.table("nation").batch(
        ["n_name", "n_regionkey"]).to_pandas()
    r = te.catalog.table("region").batch(
        ["r_name", "r_regionkey"]).to_pandas()
    df = n.merge(r, left_on="n_regionkey", right_on="r_regionkey") \
        .sort_values("n_name").head(3)
    want = list(zip(df.n_name, want_b(df)))
    if mode == "sql":
        got = te.sql(sql)
    else:
        cq = te.compile(sql)
        got = cq()
        with monkeypatch.context() as m:
            no_host_sync(m)  # the merged tables were made in discovery
            cq._run()
    assert [(str(a), b) for a, b in got.to_pylist()] == \
        [(str(a), b) for a, b in want]
