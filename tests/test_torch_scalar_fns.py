"""The port's numeric scalar functions against the JAX package's, on the CPU.

The statements of ``tests/test_fn_breadth.py::test_math_functions`` and a
statement over a table go through both engines (the port eager and
compiled); every function is also evaluated at the operator level over
seeded double, decimal, bigint and integer columns with NULLs, NaN,
infinities, zeros and negative values.

Integers, decimals, booleans and validity are compared exactly; doubles to
1e-6 relative (NaN equals NaN).
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

from torch_parity import J, T, assert_batches_equal, assert_columns_equal, \
    both_batches

torch.set_num_threads(1)

# the expressions of tests/test_fn_breadth.py::test_math_functions
MATH = ["sin(1.0)", "cos(0.5)", "atan2(1.0, 2.0)", "tanh(0.3)",
        "cbrt(27.0)", "degrees(pi())", "radians(180.0)", "sign(-42)",
        "sign(7.5)", "truncate(-3.7)", "log(2.0, 8.0)", "is_nan(nan())",
        "is_finite(infinity())", "e()"]

TABLE_SQL = (
    "select o_orderkey, mod(o_orderkey, 7) m, nullif(o_shippriority, 0) nz, "
    "greatest(o_totalprice, 150000.0) g, least(o_custkey, o_orderkey, 900) l, "
    "floor(o_totalprice) f, ceil(o_totalprice) c, round(o_totalprice, 1) r1, "
    "round(o_totalprice, -3) r3, round(o_totalprice) r0, "
    "truncate(o_totalprice) t, sign(o_totalprice - 150000) s, "
    "sqrt(o_totalprice) q, power(o_totalprice, 0.5) p, ln(o_totalprice) ln, "
    "log10(o_totalprice) l10, log2(o_totalprice) l2, exp(o_totalprice / "
    "100000) ex, is_finite(o_totalprice) fin from orders "
    "where o_orderkey < 2000")


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("expr", MATH)
def test_math_statement_matches_reference(engines, expr, mode):
    je, te = engines
    sql = f"select {expr} x"
    got = te.sql(sql) if mode == "sql" else te.compile(sql)()
    assert_batches_equal(je.sql(sql), got, expr)


@pytest.mark.parametrize("mode", ["sql", "compiled"])
def test_table_statement_matches_reference(engines, mode):
    je, te = engines
    got = te.sql(TABLE_SQL) if mode == "sql" else te.compile(TABLE_SQL)()
    assert got.num_rows > 100
    assert_batches_equal(je.sql(TABLE_SQL), got, "table")


def _spec(n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n) * 10.0 ** rng.randint(-3, 4, n)
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5]
    y = rng.randn(n) * 3
    y[:8] = [2.0, np.nan, 0.0, -2.0, 1.0, np.inf, 0.5, -0.25]
    dec = rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int64)
    dec[:4] = [0, 5, -5, 150]      # 0.00, 0.05, -0.05, 1.50: ties of round
    dec2 = rng.randint(-999, 1000, n).astype(np.int64)
    dec2[:2] = [0, 0]
    i = rng.randint(-50, 51, n).astype(np.int64)
    i2 = rng.randint(-6, 7, n).astype(np.int64)
    i2[:3] = [0, 0, 0]
    j = rng.randint(-50, 51, n).astype(np.int32)
    return {
        "x": (x, rng.rand(n) > 0.1, "double"),
        "y": (y, None, "double"),
        "dec": (dec, rng.rand(n) > 0.1, "decimal(12,2)"),
        "dec2": (dec2, None, "decimal(12,2)"),
        "dec3": (dec2, None, "decimal(10,3)"),
        "i": (i, rng.rand(n) > 0.1, "bigint"),
        "i2": (i2, None, "bigint"),
        "j": (j, rng.rand(n) > 0.2, "integer"),
    }


@pytest.fixture(scope="module")
def batches():
    return both_batches(_spec())


TYPES = {"x": "DOUBLE", "y": "DOUBLE", "i": "BIGINT", "i2": "BIGINT",
         "j": "INTEGER"}
DECIMALS = {"dec": (12, 2), "dec2": (12, 2), "dec3": (10, 3)}


def _col(I, name):
    if name in DECIMALS:
        return I.col(name, I.DecimalType(*DECIMALS[name]))
    return I.col(name, getattr(I, TYPES[name]))


TINY = np.finfo(np.float64).tiny


def _flush_subnormals(col):
    """``col`` with subnormal doubles read as zero: XLA flushes them on the
    CPU, torch keeps them (``test_exp_keeps_subnormals``)."""
    if not col.data.dtype.is_floating_point:
        return col
    sub = (col.data != 0) & (col.data.abs() < TINY)
    return col.with_data(torch.where(sub, 0.0, col.data))


def _check(build, batches, what):
    jb, tb = batches
    jout = j_eval.eval_expr(build(J), jb)
    tout = t_eval.eval_expr(build(T), tb)
    assert_columns_equal(jout, _flush_subnormals(tout), what=what)


def test_exp_keeps_subnormals():
    """exp of -710 is a subnormal double in the port, as in numpy; the JAX
    package on the CPU flushes it to zero (ROADMAP C, deliberate
    differences)."""
    x = np.array([-710.0, -740.0, -700.0])
    got = t_eval._UNARY_DOUBLE["exp"](torch.from_numpy(x)).numpy()
    assert (got[:2] > 0).all() and (got[:2] < TINY).all()
    np.testing.assert_array_equal(got, np.exp(x))


UNARY_DOUBLE = ["sqrt", "ln", "exp", "log2", "log10", "sin", "cos", "tan",
                "asin", "acos", "atan", "sinh", "cosh", "tanh", "cbrt",
                "degrees", "radians", "truncate"]
PREDICATES = ["is_nan", "is_finite", "is_infinite"]


@pytest.mark.parametrize("col", ["x", "dec", "i", "j"])
@pytest.mark.parametrize("fn", UNARY_DOUBLE + PREDICATES)
def test_unary_function_matches_reference(batches, fn, col):
    def build(I):
        t = I.BOOLEAN if fn in PREDICATES else I.DOUBLE
        return I.call(fn, _col(I, col), type=t)
    _check(build, batches, f"{fn}({col})")


@pytest.mark.parametrize("col", ["x", "dec", "dec3", "i", "j"])
@pytest.mark.parametrize("fn", ["floor", "ceil", "sign"])
def test_integral_function_matches_reference(batches, fn, col):
    _check(lambda I: I.call(fn, _col(I, col)), batches, f"{fn}({col})")


@pytest.mark.parametrize("col", ["x", "dec", "dec3", "i", "j"])
@pytest.mark.parametrize("digits", [None, 0, 1, 2, 4, -1, -3])
def test_round_matches_reference(batches, col, digits):
    def build(I):
        args = (_col(I, col),) if digits is None else (
            _col(I, col), I.lit(digits, I.INTEGER))
        return I.call("round", *args)
    _check(build, batches, f"round({col}, {digits})")


@pytest.mark.parametrize("fn", ["power", "atan2", "log"])
@pytest.mark.parametrize("pair", [("x", "y"), ("y", "x"), ("dec", "x"),
                                  ("i", "dec2"), ("j", "i2")])
def test_binary_double_function_matches_reference(batches, fn, pair):
    a, b = pair
    _check(lambda I: I.call(fn, _col(I, a), _col(I, b), type=I.DOUBLE),
           batches, f"{fn}({a}, {b})")


@pytest.mark.parametrize("pair", [("i", "i2"), ("j", "i2"), ("i2", "j"),
                                  ("dec", "dec2"), ("dec", "dec3"),
                                  ("dec", "i2"), ("x", "y")])
def test_mod_matches_reference(batches, pair):
    a, b = pair
    _check(lambda I: I.call("mod", _col(I, a), _col(I, b)), batches,
           f"mod({a}, {b})")


@pytest.mark.parametrize("pair", [("i", "i2"), ("j", "i2"), ("x", "y"),
                                  ("dec", "dec2"), ("dec", "i2")])
def test_nullif_matches_reference(batches, pair):
    a, b = pair
    _check(lambda I: I.call("nullif", _col(I, a), _col(I, b)), batches,
           f"nullif({a}, {b})")


def test_nullif_with_a_literal_matches_reference(batches):
    _check(lambda I: I.call("nullif", _col(I, "i2"), I.lit(0)), batches,
           "nullif(i2, 0)")


@pytest.mark.parametrize("fn", ["greatest", "least"])
@pytest.mark.parametrize("cols", [("i", "i2"), ("i", "i2", "j"),
                                  ("x", "y"), ("x", "dec"),
                                  ("dec", "dec2", "dec3"), ("j", "dec")])
def test_greatest_least_match_reference(batches, fn, cols):
    _check(lambda I: I.call(fn, *[_col(I, c) for c in cols]), batches,
           f"{fn}{cols}")


@pytest.mark.parametrize("fn", ["sign", "truncate", "is_nan", "is_finite",
                                "is_infinite", "floor", "round"])
def test_function_of_a_null_literal_matches_reference(batches, fn):
    """A typed NULL argument: every lane NULL."""
    def build(I):
        t = I.BOOLEAN if fn.startswith("is_") else None
        arg = I.Literal(None, I.DOUBLE)
        return I.call(fn, arg, type=t) if t else I.call(fn, arg)
    _check(build, batches, f"{fn}(NULL)")
