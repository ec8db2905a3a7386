"""The port's columnar core and expression evaluator against the JAX
package's, on the same numpy inputs, on the CPU.

Integers, decimals, dates, booleans and validity are compared exactly;
doubles to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import presto1_tpu.batch as j_batch
import presto1_tpu.expr.eval as j_eval
import presto1_tpu.expr.ir as j_ir
import presto1_tpu.types as j_types
import presto1_tpu_torch.batch as t_batch
import presto1_tpu_torch.expr.eval as t_eval
import presto1_tpu_torch.expr.ir as t_ir
import presto1_tpu_torch.types as t_types
from presto1_tpu_torch.testing.parity import (
    batch_from_numpy_parts, batch_to_numpy_parts, column_from_numpy_parts,
)

from torch_parity import (
    J, T, assert_columns_equal, both_batches, jax_parts,
)


# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)


def test_round_capacity_matches_reference():
    points = set(range(0, 3000)) | {2 ** k + d for k in range(7, 24)
                                    for d in (-1, 0, 1)}
    points |= {3 * 2 ** k + d for k in range(6, 22) for d in (-1, 0, 1)}
    rng = np.random.RandomState(0)
    points |= set(int(x) for x in rng.randint(0, 2 ** 23, 500))
    points = sorted(p for p in points if 0 <= p <= 2 ** 23)
    assert [t_batch.round_capacity(p) for p in points] == \
        [j_batch.round_capacity(p) for p in points]


TYPE_CASES = {
    "bigint": (np.array([1, -2, 2 ** 40, 0]), "bigint"),
    "integer": (np.array([1, -2, 3, 0], np.int32), "integer"),
    "double": (np.array([1.5, -2.25, 0.0, 1e300]), "double"),
    "boolean": (np.array([True, False, True, False]), "boolean"),
    "decimal": (np.array([12345, -1, 0, 99]), "decimal(12,2)"),
    "date_days": (np.array([8766, 0, -1, 19000], np.int32), "date"),
    "date_np": (np.array(["1994-01-01", "1970-01-01", "1969-12-31",
                          "2022-01-08"], "datetime64[D]"), "date"),
    "timestamp": (np.array(["1994-01-01T01:02:03", "1970-01-01T00:00:00",
                            "1969-12-31T23:59:59", "2022-01-08T12:00:00"],
                           "datetime64[us]"), "timestamp(6)"),
    "varchar": (np.array(["pear", "apple", "fig", "apple"]), "varchar"),
}


@pytest.mark.parametrize("case", sorted(TYPE_CASES))
def test_from_numpy_decode_round_trip(case):
    arr, tstr = TYPE_CASES[case]
    jb = j_batch.from_numpy({"c": arr}, {"c": j_types.parse_type_str(tstr)})
    tb = t_batch.from_numpy({"c": arr}, {"c": t_types.parse_type_str(tstr)},
                            device="cpu")
    assert_columns_equal(jb["c"], tb["c"], what=case)
    assert tb["c"].data.device.type == "cpu"
    jd, td = jb["c"].decode(), tb["c"].decode()
    assert list(jd) == list(td)
    assert jb.to_pylist() == tb.to_pylist()
    assert jb.to_pandas().equals(tb.to_pandas())


def test_decode_with_nulls_and_parity_round_trip():
    spec = {
        "d": (np.array([150, 275, 0, -5]), [True, False, True, True],
              "decimal(12,2)"),
        "s": (np.array([1, 0, 1, 0], np.int32), [True, True, False, True],
              "varchar", np.array(["a", "b"])),
        "x": (np.array([1.0, 2.0, 3.0, 4.0]), None, "double"),
    }
    jb, tb = both_batches(spec)
    assert jb.to_pylist() == tb.to_pylist()
    parts, n = batch_to_numpy_parts(tb)
    jparts, jn = jax_parts(jb)
    assert n == jn == 4
    for name in parts:
        for key in ("data", "validity"):
            a, b = parts[name][key], jparts[name][key]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert parts[name]["type"] == jparts[name]["type"]
    again = batch_from_numpy_parts(parts, n, device="cpu")
    assert again.to_pylist() == tb.to_pylist()


def test_encode_dictionary_and_hash_strings_host():
    vals = np.array(["pear", "apple", "fig", "apple", ""])
    jd, jc = j_batch.encode_dictionary(vals)
    td, tc = t_batch.encode_dictionary(vals)
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(j_batch.hash_strings_host(vals),
                                  t_batch.hash_strings_host(vals))


def test_gather_clamps_like_reference():
    """``jnp.take(mode="clip")`` clamps; so must the port's gather."""
    import jax.numpy as jnp

    spec = {"a": (np.arange(10, 20), [True] * 9 + [False], "bigint"),
            "b": (np.arange(5.0, 15.0), None, "double")}
    jb, tb = both_batches(spec)
    idx = np.array([0, 9, 10, 99, -1, -50, 3])
    valid = np.array([True, True, True, False, True, True, True])
    jg = jb.gather(jnp.asarray(idx), 7, jnp.asarray(valid))
    tg = tb.gather(torch.from_numpy(idx), 7, torch.from_numpy(valid))
    for name in spec:
        assert_columns_equal(jg[name], tg[name], what=name)
    jg2 = j_batch.gather_columns(jb.columns, jnp.asarray(idx))
    tg2 = t_batch.gather_columns(tb.columns, torch.from_numpy(idx))
    for name in spec:
        assert_columns_equal(jg2[name], tg2[name], what=name)
    empty = column_from_numpy_parts(np.zeros(0, np.int64), None, "bigint",
                                    device="cpu")
    assert empty.gather(torch.tensor([0, 5])).data.tolist() == [0, 0]


# ------------------------------------------------------------ expressions

_N = 9
_RNG = np.random.RandomState(5)
SPEC = {
    "a": (np.array([5, -7, 0, 3, -3, 8, 2 ** 33, -1, 7]),
          [True, True, False, True, True, True, True, False, True],
          "bigint"),
    "b": (np.array([2, 2, 5, -2, -2, 3, 7, 0, -7]), None, "bigint"),
    "i": (np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32), None, "integer"),
    "p": (np.array([100, 250, 199, 5, 0, -350, 12345, 1, 2400]),
          [True, True, True, False, True, True, True, True, True],
          "decimal(12,2)"),
    "q": (np.array([6, 5, 7, 10, 0, 3, 4, 9, 1]), None, "decimal(12,2)"),
    "r": (np.array([1234, -5678, 15, 25, -15, -25, 0, 5, 14]), None,
          "decimal(12,3)"),
    "x": (_RNG.uniform(-5, 5, _N), None, "double"),
    "y": (_RNG.uniform(-5, 5, _N),
          [True, False, True, True, True, False, True, True, True],
          "double"),
    "d": (np.array([8765, 8766, 9130, 9131, 0, 10000, 8766, 9000, 1],
                   np.int32), None, "date"),
    "t": (np.array([True, False, True, False, True, False, True, False,
                    True]),
          [True, True, True, True, False, False, True, True, False],
          "boolean"),
    "u": (np.array([True, True, False, False, True, False, False, True,
                    True]),
          [True, False, True, False, True, True, False, True, True],
          "boolean"),
    "w": (np.array([True, False, False, True, True, False, True, False,
                    False]), None, "boolean"),
}


def _c(I, name):
    tstr = SPEC[name][2]
    mod = j_types if I is J else t_types
    return I.col(name, mod.parse_type_str(tstr))


EXPRS = {
    # comparisons
    "cmp_bigint_lt": lambda I: I.call("<", _c(I, "a"), _c(I, "b")),
    "cmp_bigint_eq_lit": lambda I: I.call("=", _c(I, "b"), I.lit(2)),
    "cmp_int_vs_bigint": lambda I: I.call(">=", _c(I, "i"), _c(I, "b")),
    "cmp_date_ge_lit": lambda I: I.call(">=", _c(I, "d"),
                                        I.lit(8766, I.DATE)),
    "cmp_decimal_vs_bigint_lit": lambda I: I.call("<", _c(I, "p"),
                                                  I.lit(24)),
    "cmp_decimal_scales": lambda I: I.call("<=", _c(I, "q"), _c(I, "r")),
    "cmp_decimal_vs_double": lambda I: I.call(">", _c(I, "p"), _c(I, "x")),
    "cmp_double_vs_decimal": lambda I: I.call("<>", _c(I, "y"),
                                              _c(I, "q")),
    "cmp_decimal_unfolded_const": lambda I: I.call(
        ">=", _c(I, "q"),
        I.call("-", I.lit(6, I.DecimalType(18, 2)),
               I.lit(1, I.DecimalType(18, 2)))),
    # arithmetic
    "mul_decimal_decimal": lambda I: I.call("*", _c(I, "p"), _c(I, "q")),
    "mul_decimal_bigint": lambda I: I.call("*", _c(I, "p"), _c(I, "b")),
    "add_decimal_scales": lambda I: I.call("+", _c(I, "q"), _c(I, "r")),
    "sub_decimal_bigint": lambda I: I.call("-", _c(I, "p"), _c(I, "a")),
    "add_int_bigint": lambda I: I.call("+", _c(I, "i"), _c(I, "a")),
    "mul_int_int": lambda I: I.call("*", _c(I, "i"), _c(I, "i")),
    "div_bigint_floor_negative": lambda I: I.call("/", _c(I, "a"),
                                                  I.lit(2)),
    "div_bigint_by_negative": lambda I: I.call("/", _c(I, "a"),
                                               I.lit(-2)),
    "div_decimal_double": lambda I: I.call("/", _c(I, "p"), I.lit(7)),
    "div_double": lambda I: I.call("/", _c(I, "x"), _c(I, "y")),
    "add_double_bigint": lambda I: I.call("+", _c(I, "x"), _c(I, "b")),
    "min2_max2": lambda I: I.call("max2", I.call("min2", _c(I, "a"),
                                                 _c(I, "b")), I.lit(0)),
    "neg_abs": lambda I: I.call("abs", I.call("neg", _c(I, "p"))),
    "one_minus_discount": lambda I: I.call(
        "*", _c(I, "p"),
        I.call("-", I.lit(100, I.DecimalType(12, 2)), _c(I, "q"))),
    # three-valued logic
    "and_nulls": lambda I: I.call("and", _c(I, "t"), _c(I, "u")),
    "or_nulls": lambda I: I.call("or", _c(I, "t"), _c(I, "u")),
    "and_one_nullable": lambda I: I.call("and", _c(I, "w"), _c(I, "t")),
    "or_no_nulls": lambda I: I.call("or", _c(I, "w"), I.call(
        "<", _c(I, "b"), I.lit(0))),
    "not_null": lambda I: I.call("not", _c(I, "t")),
    "is_null": lambda I: I.call("is_null", _c(I, "a")),
    "is_null_not_nullable": lambda I: I.call("is_null", _c(I, "b")),
    "between_as_and": lambda I: I.call(
        "and", I.call(">=", _c(I, "a"), I.lit(-3)),
        I.call("<=", _c(I, "a"), I.lit(7))),
    "in_list": lambda I: I.call("in", _c(I, "a"), I.lit(5), I.lit(-3),
                                I.lit(8)),
    "in_decimal_vs_bigint": lambda I: I.call("in", _c(I, "p"), I.lit(1),
                                             I.lit(24)),
    "case_else": lambda I: I.call(
        "case", I.call(">", _c(I, "a"), I.lit(0)), _c(I, "b"),
        I.call("<", _c(I, "a"), I.lit(0)), I.lit(-1), I.lit(0)),
    "case_null_cond_and_value": lambda I: I.call(
        "case", _c(I, "t"), _c(I, "a"), _c(I, "b")),
    "case_decimal_coercion": lambda I: I.call(
        "case", _c(I, "w"), _c(I, "p"), I.lit(0, I.DecimalType(12, 2))),
    "coalesce": lambda I: I.call("coalesce", _c(I, "a"), _c(I, "b")),
    # casts
    "cast_decimal_double": lambda I: I.call("cast", _c(I, "p"),
                                            type=I.DOUBLE),
    "cast_bigint_double": lambda I: I.call("cast", _c(I, "a"),
                                           type=I.DOUBLE),
    "cast_double_decimal": lambda I: I.call("cast", _c(I, "x"),
                                            type=I.DecimalType(12, 2)),
    "cast_decimal_up": lambda I: I.call("cast", _c(I, "q"),
                                        type=I.DecimalType(18, 4)),
    "cast_decimal_down_half_away": lambda I: I.call(
        "cast", _c(I, "r"), type=I.DecimalType(12, 2)),
    "cast_decimal_bigint": lambda I: I.call("cast", _c(I, "r"),
                                            type=I.BIGINT),
    "cast_bigint_integer": lambda I: I.call("cast", _c(I, "b"),
                                            type=I.INTEGER),
    "cast_integer_bigint": lambda I: I.call("cast", _c(I, "i"),
                                            type=I.BIGINT),
    "cast_double_real": lambda I: I.call("cast", _c(I, "x"), type=I.REAL),
    "cast_date_timestamp": lambda I: I.call("cast", _c(I, "d"),
                                            type=I.TIMESTAMP),
    "cast_timestamp_date": lambda I: I.call(
        "cast", I.call("cast", _c(I, "d"), type=I.TIMESTAMP), type=I.DATE),
    "cmp_date_vs_timestamp": lambda I: I.call(
        "<", _c(I, "d"), I.call("cast", I.lit(9000, I.DATE),
                                type=I.TIMESTAMP)),
    # constants alone broadcast to the batch
    "literal_only": lambda I: I.lit(42),
    "literal_decimal": lambda I: I.lit(7, I.DecimalType(12, 2)),
    "typed_null": lambda I: I.Literal(None, I.BIGINT),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_eval_expr_matches_reference(name):
    jb, tb = both_batches(SPEC)
    je, te = EXPRS[name](J), EXPRS[name](T)
    assert str(je.type) == str(te.type)
    jout = j_eval.eval_expr(je, jb)
    tout = t_eval.eval_expr(te, tb)
    assert_columns_equal(jout, tout, what=name)
    if str(je.type) == "boolean":
        np.testing.assert_array_equal(
            np.asarray(j_eval.eval_predicate(je, jb)),
            t_eval.eval_predicate(te, tb).numpy())


def test_string_folding_and_dict_lookup():
    """String predicates fold to a DictLookup on the host and gather on
    the device, NULL-bearing folds included."""
    words = np.array(["AIR", "MAIL", "SHIP", "AIR", "RAIL", "MAIL"])
    dic, codes = np.unique(words, return_inverse=True)
    spec = {"s": (codes.astype(np.int32),
                  [True, True, False, True, True, True], "varchar", dic)}
    jb, tb = both_batches(spec)
    cases = {
        "eq": lambda I: I.call("=", I.col("s", I.VARCHAR),
                               I.lit("AIR", I.VARCHAR)),
        "like": lambda I: I.call("like", I.col("s", I.VARCHAR),
                                 I.lit("%AIL", I.VARCHAR)),
        "in": lambda I: I.call("in", I.col("s", I.VARCHAR),
                               I.lit("MAIL", I.VARCHAR),
                               I.lit("SHIP", I.VARCHAR)),
        "length": lambda I: I.call("length", I.col("s", I.VARCHAR)),
        "substring": lambda I: I.call(
            "substring", I.col("s", I.VARCHAR), I.lit(1), I.lit(2),
            type=I.VARCHAR),
    }
    for name, build in cases.items():
        je = j_eval.bind_string_ops(build(J), {"s": dic})
        te = t_eval.bind_string_ops(build(T), {"s": dic})
        assert type(je).__name__ == type(te).__name__ == "DictLookup"
        jout, tout = j_eval.eval_expr(je, jb), t_eval.eval_expr(te, tb)
        assert_columns_equal(jout, tout, what=name)
        assert list(jout.decode()) == list(tout.decode())


def _later_slice_expr(I, fn):
    """An expression of ``fn`` over SPEC's columns, built with ``I``."""
    from presto1_tpu.types import ArrayType as JArray
    from presto1_tpu_torch.types import ArrayType as TArray

    arr_t = (JArray if I is J else TArray)(I.BIGINT)
    arr = I.call("array_ctor", I.col("a", I.BIGINT), I.col("b", I.BIGINT),
                 type=arr_t)
    if fn == "cardinality":
        return I.call("cardinality", arr, type=I.BIGINT)
    if fn == "element_at":
        return I.call("element_at", arr, I.col("i", I.INTEGER),
                      type=I.BIGINT)
    if fn == "transform":
        ir = j_ir if I is J else t_ir
        body = I.call("+", I.col("x0", I.BIGINT), I.col("b", I.BIGINT),
                      type=I.BIGINT)
        return I.call("transform", arr, ir.Lambda(("x0",), body, arr_t),
                      type=arr_t)
    if fn == "__mask":
        return I.call("__mask", I.col("a", I.BIGINT),
                      I.call(">", I.col("b", I.BIGINT), I.lit(0),
                             type=I.BOOLEAN), type=I.BIGINT)
    return I.call("__hll_hash", I.col("a", I.BIGINT), type=I.BIGINT)


@pytest.mark.parametrize("fn", ["cardinality", "element_at", "transform",
                                "__mask", "__hll_hash"])
def test_functions_of_later_slices_raise(fn):
    """These functions raised in the port until the slice that ported them
    (arrays, MarkDistinct's mask, the HLL hashes); they now evaluate as the
    reference does, nested results included."""
    jb, tb = both_batches(SPEC)
    jout = j_eval.eval_expr(_later_slice_expr(J, fn), jb)
    tout = t_eval.eval_expr(_later_slice_expr(T, fn), tb)
    assert_columns_equal(jout, tout, what=fn)
    if fn == "transform":
        np.testing.assert_array_equal(np.asarray(jout.lengths),
                                      tout.lengths.numpy())


def test_hll_constant_matches():
    assert t_eval.HLL_M == j_eval.HLL_M
