"""Frozen copy of presto1_tpu_torch/tpch/schema.py (types by name, data/types.py),
kept here so that the benchmark's data does not move with the program.

TPC-H schema: column names/types in table order.

Mirrors the reference's ``plugin/trino-tpch/.../TpchMetadata.java`` typing,
except money columns are DECIMAL(12,2) (exact scaled int64 on device)
instead of DOUBLE — see types.py for the policy.
"""

from .types import BIGINT, DATE, DecimalType, INTEGER, VARCHAR

MONEY = DecimalType(12, 2)

TABLES = {
    "region": [
        ("r_regionkey", BIGINT), ("r_name", VARCHAR), ("r_comment", VARCHAR),
    ],
    "nation": [
        ("n_nationkey", BIGINT), ("n_name", VARCHAR),
        ("n_regionkey", BIGINT), ("n_comment", VARCHAR),
    ],
    "supplier": [
        ("s_suppkey", BIGINT), ("s_name", VARCHAR), ("s_address", VARCHAR),
        ("s_nationkey", BIGINT), ("s_phone", VARCHAR), ("s_acctbal", MONEY),
        ("s_comment", VARCHAR),
    ],
    "customer": [
        ("c_custkey", BIGINT), ("c_name", VARCHAR), ("c_address", VARCHAR),
        ("c_nationkey", BIGINT), ("c_phone", VARCHAR), ("c_acctbal", MONEY),
        ("c_mktsegment", VARCHAR), ("c_comment", VARCHAR),
    ],
    "part": [
        ("p_partkey", BIGINT), ("p_name", VARCHAR), ("p_mfgr", VARCHAR),
        ("p_brand", VARCHAR), ("p_type", VARCHAR), ("p_size", INTEGER),
        ("p_container", VARCHAR), ("p_retailprice", MONEY),
        ("p_comment", VARCHAR),
    ],
    "partsupp": [
        ("ps_partkey", BIGINT), ("ps_suppkey", BIGINT),
        ("ps_availqty", INTEGER), ("ps_supplycost", MONEY),
        ("ps_comment", VARCHAR),
    ],
    "orders": [
        ("o_orderkey", BIGINT), ("o_custkey", BIGINT),
        ("o_orderstatus", VARCHAR), ("o_totalprice", MONEY),
        ("o_orderdate", DATE), ("o_orderpriority", VARCHAR),
        ("o_clerk", VARCHAR), ("o_shippriority", INTEGER),
        ("o_comment", VARCHAR),
    ],
    "lineitem": [
        ("l_orderkey", BIGINT), ("l_partkey", BIGINT), ("l_suppkey", BIGINT),
        ("l_linenumber", INTEGER), ("l_quantity", MONEY),
        ("l_extendedprice", MONEY), ("l_discount", MONEY), ("l_tax", MONEY),
        ("l_returnflag", VARCHAR), ("l_linestatus", VARCHAR),
        ("l_shipdate", DATE), ("l_commitdate", DATE), ("l_receiptdate", DATE),
        ("l_shipinstruct", VARCHAR), ("l_shipmode", VARCHAR),
        ("l_comment", VARCHAR),
    ],
}

# small closed vocabularies: encoded without a full np.unique pass
ENUM_VOCABS = {
    ("lineitem", "l_returnflag"): ["A", "N", "R"],
    ("lineitem", "l_linestatus"): ["F", "O"],
    ("orders", "o_orderstatus"): ["F", "O", "P"],
}

# primary keys per the TPC-H spec §1.4 (reference: the statistics the
# trino-tpch connector derives in plugin/trino-tpch/.../statistics/)
PRIMARY_KEYS = {
    "region": [("r_regionkey",)],
    "nation": [("n_nationkey",)],
    "supplier": [("s_suppkey",)],
    "customer": [("c_custkey",)],
    "part": [("p_partkey",)],
    "partsupp": [("ps_partkey", "ps_suppkey")],
    "orders": [("o_orderkey",)],
    "lineitem": [("l_orderkey", "l_linenumber")],
}


# ------------------------------------------------------------ column stats
# Analytic column statistics from the TPC-H specification, scaled by SF —
# the connector stats provider analog of
# plugin/trino-tpch/src/main/java/io/trino/plugin/tpch/statistics/ (the
# reference ships per-column stats for the CBO the same way).  Values are
# in STORED units: decimals as scaled ints (x100), dates as days since
# 1970-01-01.


def _days(y: int, m: int, d: int) -> int:
    from datetime import date

    return (date(y, m, d) - date(1970, 1, 1)).days


def column_stats(column: str, sf: float):
    """(ndv, lo, hi) for a TPC-H column at scale ``sf``; None if unknown.
    ndv/lo/hi may individually be None."""
    S = sf
    t = {
        "r_regionkey": (5, 0, 4), "r_name": (5, None, None),
        "n_nationkey": (25, 0, 24), "n_regionkey": (5, 0, 4),
        "n_name": (25, None, None),
        "s_suppkey": (10_000 * S, 1, 10_000 * S),
        "s_nationkey": (25, 0, 24),
        "s_acctbal": (9_000 * S, -99_999, 999_999),
        "s_name": (10_000 * S, None, None),
        "c_custkey": (150_000 * S, 1, 150_000 * S),
        "c_nationkey": (25, 0, 24),
        "c_acctbal": (140_000 * S, -99_999, 999_999),
        "c_mktsegment": (5, None, None),
        "c_name": (150_000 * S, None, None),
        "c_phone": (150_000 * S, None, None),
        "p_partkey": (200_000 * S, 1, 200_000 * S),
        "p_name": (200_000 * S, None, None),
        "p_mfgr": (5, None, None), "p_brand": (25, None, None),
        "p_type": (150, None, None), "p_size": (50, 1, 50),
        "p_container": (40, None, None),
        "p_retailprice": (20_000 * S, 90_100, 209_900),
        "ps_partkey": (200_000 * S, 1, 200_000 * S),
        "ps_suppkey": (10_000 * S, 1, 10_000 * S),
        "ps_availqty": (9_999, 1, 9_999),
        "ps_supplycost": (99_901, 100, 100_000),
        "o_orderkey": (1_500_000 * S, 1, 6_000_000 * S),
        "o_custkey": (100_000 * S, 1, 150_000 * S),
        "o_orderstatus": (3, None, None),
        "o_totalprice": (1_400_000 * S, 85_771, 55_528_516),
        "o_orderdate": (2406, _days(1992, 1, 1), _days(1998, 8, 2)),
        "o_orderpriority": (5, None, None),
        "o_clerk": (1_000 * S, None, None),
        "o_shippriority": (1, 0, 0),
        "l_orderkey": (1_500_000 * S, 1, 6_000_000 * S),
        "l_partkey": (200_000 * S, 1, 200_000 * S),
        "l_suppkey": (10_000 * S, 1, 10_000 * S),
        "l_linenumber": (7, 1, 7),
        "l_quantity": (50, 100, 5_000),
        "l_extendedprice": (1_000_000 * S, 90_090, 10_494_950),
        "l_discount": (11, 0, 10),
        "l_tax": (9, 0, 8),
        "l_returnflag": (3, None, None), "l_linestatus": (2, None, None),
        "l_shipdate": (2526, _days(1992, 1, 2), _days(1998, 12, 1)),
        "l_commitdate": (2466, _days(1992, 1, 31), _days(1998, 10, 31)),
        "l_receiptdate": (2555, _days(1992, 1, 3), _days(1998, 12, 31)),
        "l_shipmode": (7, None, None), "l_shipinstruct": (4, None, None),
    }.get(column)
    if t is None:
        return None
    ndv, lo, hi = t
    return (max(float(ndv), 1.0) if ndv is not None else None,
            None if lo is None else float(lo),
            None if hi is None else float(hi))
