"""The port's civil-date functions against the JAX package's, on the CPU.

* every statement of ``tests/test_datetime_fns.py`` and
  ``tests/test_timestamptz.py`` through both engines on
  ``TpchCatalog(sf=0.001)``, the port eager and compiled;
* the civil helpers over every day from 1900-01-01 to 2100-12-31;
* ``extract_*``, ``date_trunc``, ``date_add`` and ``date_diff`` at the
  operator level over those days and over seeded timestamps before and
  after 1970, zoned or not, with NULLs;
* the two repairs of the port's date/time front end: compact zone offsets
  (``'+0530'`` is 5 h 30 min; offsets beyond +-14:00 are refused) and the
  precedence of AT TIME ZONE (it applies to the additive expression before
  it).  The JAX package keeps both defects (ROADMAP C3, C4).

Dates, timestamps and integers are compared exactly.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.expr.eval as j_eval
import presto1_tpu.types as j_types
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.expr.eval as t_eval
import presto1_tpu_torch.types as t_types
from presto1_tpu_torch.sql import ast as t_ast
from presto1_tpu_torch.sql.parser import parse as t_parse
from presto1_tpu_torch.sql.planner import PlanError

from torch_parity import J, T, assert_batches_equal, assert_columns_equal, \
    both_batches

torch.set_num_threads(1)

# the statements of tests/test_datetime_fns.py and tests/test_timestamptz.py
STATEMENTS = {
    "extract_fields":
        "select o_orderdate d, extract(year from o_orderdate) y, "
        "extract(month from o_orderdate) m, extract(day from o_orderdate) dd, "
        "extract(quarter from o_orderdate) q, extract(dow from o_orderdate) dw, "
        "extract(doy from o_orderdate) dy, extract(week from o_orderdate) wk "
        "from orders",
    "scalar_aliases":
        "select o_orderdate d, year(o_orderdate) y, month(o_orderdate) m, "
        "day(o_orderdate) dd, quarter(o_orderdate) q, "
        "week(o_orderdate) w, day_of_week(o_orderdate) dw "
        "from orders limit 500",
    "date_trunc":
        "select o_orderdate d, date_trunc('month', o_orderdate) tm, "
        "date_trunc('quarter', o_orderdate) tq, "
        "date_trunc('year', o_orderdate) ty, "
        "date_trunc('week', o_orderdate) tw from orders",
    "date_add_diff":
        "select o_orderdate d, date_add('day', 45, o_orderdate) a45, "
        "date_add('month', 7, o_orderdate) am, "
        "date_add('year', -2, o_orderdate) ay, "
        "date_diff('day', o_orderdate, date '1998-12-31') dd, "
        "date_diff('month', o_orderdate, date '1998-12-31') dm "
        "from orders limit 1000",
    "month_end_clamping":
        "select date_add('month', 1, date '2000-01-31') a, "
        "date_add('month', 1, date '2000-01-29') b, "
        "date_add('year', 1, date '2000-02-29') c",
    "current_date": "select current_date cd",
    "interval_columns":
        "select o_orderdate + interval '3' day d3, "
        "o_orderdate - interval '1' month m1, "
        "o_orderdate + interval '2' year y2 "
        "from orders limit 3",
    "interval_values":
        "select interval '36' hour h, interval '14' month m from region "
        "limit 1",
    "interval_filter":
        "select count(*) c from orders "
        "where o_orderdate + interval '1' day > o_orderdate",
    "zoned_literal": "select timestamp '2020-03-01 10:30:00 +05:30' x",
    "at_time_zone_utc":
        "select timestamp '2020-03-01 10:30:00 +05:30' at time zone 'UTC' x",
    "at_time_zone_offset":
        "select timestamp '2020-03-01 05:00:00' at time zone '-08:00' x",
    "civil_hour": "select hour(timestamp '2020-03-01 10:30:00 +05:30') x",
    "civil_hour_utc":
        "select hour(timestamp '2020-03-01 10:30:00 +05:30' "
        "at time zone 'UTC') x",
    "civil_day_utc":
        "select day(timestamp '2020-03-01 01:30:00 +05:30' "
        "at time zone 'UTC') x",
    "date_trunc_zoned":
        "select date_trunc('day', timestamp '2020-03-01 01:30:00 +05:30') x",
    "cross_zone_equal":
        "select timestamp '2020-03-01 10:30:00 +05:30' = "
        "timestamp '2020-03-01 05:00:00 UTC' x",
    "naive_is_utc":
        "select timestamp '2020-03-01 10:30:00' < "
        "timestamp '2020-03-01 10:30:00 +05:30' x",
    "cast_to_naive":
        "select cast(timestamp '2020-03-01 10:30:00 +05:30' as timestamp) x",
    "string_to_date": "select cast('2020-01-01' as date) x",
    "string_to_timestamp":
        "select cast('2020-01-01 12:00:00' as timestamp) x",
}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_reference(engines, name, mode):
    je, te = engines
    sql = STATEMENTS[name]
    got = te.sql(sql) if mode == "sql" else te.compile(sql)()
    assert_batches_equal(je.sql(sql), got, name)


def test_current_timestamp_is_zoned(engines):
    """``current_timestamp`` is read at plan time, so the two engines see
    different instants: the port's is now, in UTC, typed as the
    reference's."""
    je, te = engines
    before = time.time()
    got = te.sql("select current_timestamp x")
    after = time.time()
    ref = je.sql("select current_timestamp x")
    assert str(got["x"].type) == str(ref["x"].type)
    assert str(got.to_pandas().x[0]).endswith("+00:00")
    us = int(got["x"].data[0])
    assert before * 1e6 - 1 <= us <= after * 1e6 + 1


def test_named_dst_zone_rejected(engines):
    _, te = engines
    with pytest.raises(Exception) as ei:
        te.sql("select timestamp '2020-01-01 00:00:00' "
               "at time zone 'America/New_York'")
    assert "time zone" in str(ei.value)


# ------------------------------------------------------ civil helpers

FIRST_DAY = int(np.datetime64("1900-01-01", "D").astype(np.int64))
LAST_DAY = int(np.datetime64("2100-12-31", "D").astype(np.int64))
DAYS = np.arange(FIRST_DAY, LAST_DAY + 1, dtype=np.int32)


def test_civil_helpers_match_reference_every_day():
    ty, tm, td = t_eval._civil_full(torch.from_numpy(DAYS))
    jy, jm, jd = j_eval._civil_full(jnp.asarray(DAYS))
    for t, j in ((ty, jy), (tm, jm), (td, jd)):
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # numpy's calendar agrees, and days_from_civil inverts civil_full
    civil = DAYS.astype("datetime64[D]").astype(str)
    assert [f"{y:04d}-{m:02d}-{d:02d}" for y, m, d in
            zip(ty.tolist(), tm.tolist(), td.tolist())] == list(civil)
    back = t_eval._days_from_civil(ty, tm, td)
    np.testing.assert_array_equal(back.numpy(), DAYS)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_eval._days_from_civil(jy, jm, jd)))


def _spec(seed=0):
    """Every day of 1900-2100 beside seeded timestamps of the same span (to
    the microsecond), a zoned copy, counts for date_add and NULLs."""
    rng = np.random.RandomState(seed)
    n = len(DAYS)
    lo, hi = FIRST_DAY * 86_400_000_000, (LAST_DAY + 1) * 86_400_000_000
    ts = rng.randint(lo, hi, n, dtype=np.int64)
    valid = rng.rand(n) > 0.1
    return {
        "d": (DAYS, None, "date"),
        "dn": (np.where(valid, DAYS, 0).astype(np.int32), valid, "date"),
        "ts": (ts, None, "timestamp(6)"),
        "tz": (ts, None, "timestamptz(6,+330)"),
        "tw": (ts[::-1].copy(), None, "timestamptz(6,-480)"),
        "k": (rng.randint(-40, 41, n).astype(np.int64), valid[::-1].copy(),
              "bigint"),
    }


@pytest.fixture(scope="module")
def days_batches():
    return both_batches(_spec())


def _type(I, s):
    mod = j_types if I is J else t_types
    return mod.parse_type_str(s)


def _check(build, batches, what):
    jb, tb = batches
    jout = j_eval.eval_expr(build(J), jb)
    tout = t_eval.eval_expr(build(T), tb)
    assert_columns_equal(jout, tout, what=what)


COLUMNS = {"d": "date", "dn": "date", "ts": "timestamp(6)",
           "tz": "timestamptz(6,+330)", "tw": "timestamptz(6,-480)"}
DATE_FIELDS = ["year", "month", "day", "quarter", "dow", "day_of_week",
               "doy", "day_of_year", "week", "week_of_year"]
TIME_FIELDS = ["hour", "minute", "second", "millisecond"]


@pytest.mark.parametrize("col", sorted(COLUMNS))
@pytest.mark.parametrize("field", DATE_FIELDS + TIME_FIELDS)
def test_extract_matches_reference(days_batches, field, col):
    _check(lambda I: I.call(f"extract_{field}",
                            I.col(col, _type(I, COLUMNS[col])),
                            type=I.BIGINT), days_batches, f"{field}({col})")


TIME_UNITS = ["hour", "minute", "second", "millisecond"]
DAY_UNITS = ["day", "week", "month", "year"]


def _cases(columns, units):
    """(unit, column) pairs, time units only where a timestamp is read."""
    return [(u, c) for c in columns for u in units
            if u not in TIME_UNITS or "timestamp" in COLUMNS[c]]


@pytest.mark.parametrize("unit,col", _cases(
    sorted(COLUMNS), DAY_UNITS + ["quarter"] + TIME_UNITS))
def test_date_trunc_matches_reference(days_batches, unit, col):
    def build(I):
        t = _type(I, COLUMNS[col])
        return I.call("date_trunc", I.lit(unit, I.VARCHAR), I.col(col, t),
                      type=t)
    _check(build, days_batches, f"date_trunc({unit}, {col})")


@pytest.mark.parametrize("unit,col", _cases(["d", "dn", "ts"],
                                            DAY_UNITS + TIME_UNITS))
@pytest.mark.parametrize("count", ["k", -13, 1, 25])
def test_date_add_matches_reference(days_batches, unit, col, count):
    def build(I):
        t = _type(I, COLUMNS[col])
        n = I.col("k", I.BIGINT) if count == "k" else I.lit(count, I.BIGINT)
        return I.call("date_add", I.lit(unit, I.VARCHAR), n, I.col(col, t),
                      type=t)
    _check(build, days_batches, f"date_add({unit}, {count}, {col})")


@pytest.mark.parametrize("unit,a,b", [
    (u, a, b) for a, b in (("d", "dn"), ("dn", "d"), ("d", "ts"),
                           ("ts", "d"), ("ts", "dn"))
    for u in DAY_UNITS + TIME_UNITS
    if u not in TIME_UNITS or "ts" in (a, b)])
def test_date_diff_matches_reference(days_batches, unit, a, b):
    def build(I):
        return I.call("date_diff", I.lit(unit, I.VARCHAR),
                      I.col(a, _type(I, COLUMNS[a])),
                      I.col(b, _type(I, COLUMNS[b])), type=I.BIGINT)
    _check(build, days_batches, f"date_diff({unit}, {a}, {b})")


# ------------------------------------------------------ repairs C3, C4

@pytest.mark.parametrize("zone,minutes", [
    ("+0530", 330), ("+05:30", 330), ("-0800", -480), ("-08:00", -480),
    ("+05", 300), ("+5", 300), ("+14:00", 840), ("-1400", -840),
    ("UTC", 0), ("Z", 0), ("+00:00", 0)])
def test_zone_offset_reads_compact_bodies(zone, minutes):
    assert t_types.parse_zone_offset(zone) == minutes


@pytest.mark.parametrize("zone", ["+99:00", "+14:01", "-1500", "+530",
                                  "+05:60", "05:30", "+ab",
                                  "America/New_York"])
def test_zone_offset_refuses_what_is_not_an_offset(zone):
    with pytest.raises(ValueError):
        t_types.parse_zone_offset(zone)


def test_compact_zone_offset_in_a_statement(engines):
    _, te = engines
    got = te.sql("select timestamp '2020-03-01 10:30:00' "
                 "at time zone '+0530' x").to_pandas().x[0]
    assert got == "2020-03-01 16:00:00.000000 +05:30"
    with pytest.raises(PlanError, match="14:00"):
        te.sql("select timestamp '2020-03-01 10:30:00' "
               "at time zone '+99:00' x")


def test_at_time_zone_applies_to_the_additive_expression(engines):
    q = t_parse("select ts + interval '1' hour at time zone '+02:00' from t")
    e = q.select.items[0].expr
    assert isinstance(e, t_ast.AtTimeZone) and e.zone == "+02:00"
    assert isinstance(e.expr, t_ast.BinaryOp) and e.expr.op == "+"
    assert isinstance(e.expr.right, t_ast.IntervalLit)
    _, te = engines
    got = te.sql("select timestamp '2020-03-01 10:30:00' + interval '1' hour "
                 "at time zone '+02:00' x").to_pandas().x[0]
    assert got == "2020-03-01 13:30:00.000000 +02:00"
