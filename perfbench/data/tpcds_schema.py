"""The benchmark's TPC-DS star schema: the seven tables that TPC-DS Q27,
Q93 and Q98 read, each with the columns the generator makes, typed as
the port's ``tpcds/schema.py`` types them (surrogate keys BIGINT, money
DECIMAL(7,2), counts INTEGER, text VARCHAR).

The connector metadata, primary keys and column statistics, is that of
the port's ``TpcdsCatalog`` (``tpcds/catalog.py``) for these columns: no
sort columns, and statistics derived the same way from the row counts and
the sales window, so the optimizer sees the same numbers over either
catalog at scale factor 1.
"""

from __future__ import annotations

import numpy as np

from .types import BIGINT, DATE, DecimalType, INTEGER, VARCHAR

MONEY = DecimalType(7, 2)

TABLES = {
    "date_dim": [
        ("d_date_sk", BIGINT), ("d_date", DATE), ("d_year", INTEGER),
        ("d_moy", INTEGER), ("d_dom", INTEGER),
    ],
    "item": [
        ("i_item_sk", BIGINT), ("i_item_id", VARCHAR),
        ("i_item_desc", VARCHAR), ("i_current_price", MONEY),
        ("i_class_id", INTEGER), ("i_class", VARCHAR),
        ("i_category_id", INTEGER), ("i_category", VARCHAR),
    ],
    "customer_demographics": [
        ("cd_demo_sk", BIGINT), ("cd_gender", VARCHAR),
        ("cd_marital_status", VARCHAR), ("cd_education_status", VARCHAR),
        ("cd_purchase_estimate", INTEGER), ("cd_credit_rating", VARCHAR),
        ("cd_dep_count", INTEGER), ("cd_dep_employed_count", INTEGER),
        ("cd_dep_college_count", INTEGER),
    ],
    "store": [
        ("s_store_sk", BIGINT), ("s_store_id", VARCHAR),
        ("s_store_name", VARCHAR), ("s_state", VARCHAR),
    ],
    "reason": [
        ("r_reason_sk", BIGINT), ("r_reason_id", VARCHAR),
        ("r_reason_desc", VARCHAR),
    ],
    "store_sales": [
        ("ss_sold_date_sk", BIGINT), ("ss_item_sk", BIGINT),
        ("ss_customer_sk", BIGINT), ("ss_cdemo_sk", BIGINT),
        ("ss_store_sk", BIGINT), ("ss_ticket_number", BIGINT),
        ("ss_quantity", INTEGER), ("ss_wholesale_cost", MONEY),
        ("ss_list_price", MONEY), ("ss_sales_price", MONEY),
        ("ss_ext_sales_price", MONEY), ("ss_coupon_amt", MONEY),
    ],
    "store_returns": [
        ("sr_returned_date_sk", BIGINT), ("sr_item_sk", BIGINT),
        ("sr_customer_sk", BIGINT), ("sr_reason_sk", BIGINT),
        ("sr_ticket_number", BIGINT), ("sr_return_quantity", INTEGER),
        ("sr_return_amt", MONEY),
    ],
}

# rows at SF 1 (TPC-DS v3.2.0 clause 3.2), customer only as the target of
# ss_customer_sk: it is not generated
SF1_ROWS = {"store_sales": 2_880_404, "store_returns": 287_514,
            "item": 18_000, "customer": 100_000,
            "customer_demographics": 1_920_800, "date_dim": 73_049,
            "store": 12, "reason": 35}
# tables whose rows do not scale: the calendar and the demographics cross
# product at every scale factor, as dsdgen makes them, and the store and
# reason lists at their SF 1 rows below SF 1 (so that every template's
# substitutions find rows at the tests' small scale)
FIXED = {"date_dim", "customer_demographics", "store", "reason"}

PRIMARY_KEYS = {
    "date_dim": [("d_date_sk",)],
    "item": [("i_item_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "store": [("s_store_sk",)],
    "reason": [("r_reason_sk",)],
    "store_sales": [("ss_item_sk", "ss_ticket_number")],
    "store_returns": [("sr_item_sk", "sr_ticket_number")],
}

# d_date_sk 2415022 is 1900-01-02, the calendar's first day
D_SK_EPOCH = 2_415_022
EPOCH_DATE = np.datetime64("1900-01-02", "D")


def date_sk(iso: str) -> int:
    return D_SK_EPOCH + int((np.datetime64(iso, "D") - EPOCH_DATE)
                            .astype(np.int64))


# dsdgen's sales window: every sale is dated 1998-01-02 to 2003-01-02
SALES_SK_LO = date_sk("1998-01-02")
SALES_SK_HI = date_sk("2003-01-02")

# the table a foreign key names, by the key's suffix
FK_TARGETS = {"item_sk": "item", "customer_sk": "customer",
              "cdemo_sk": "customer_demographics", "store_sk": "store",
              "reason_sk": "reason"}


def num_rows(table: str, sf: float) -> int:
    if table in FIXED:
        return SF1_ROWS[table]
    return max(int(SF1_ROWS[table] * sf), 1)


def column_stats(table: str, column: str, sf: float):
    """(ndv, lo, hi) as the port's TpcdsTable.column_stats derives them
    for this column, or None."""
    n = num_rows(table, sf)
    if (column,) in PRIMARY_KEYS.get(table, []):
        if column == "d_date_sk":
            return float(n), float(D_SK_EPOCH), float(D_SK_EPOCH + n - 1)
        return float(n), 1.0, float(n)
    fixed = {"d_year": (float(max(n // 365, 1)), 1900.0, 1900.0 + n / 365.0),
             "d_moy": (12.0, 1.0, 12.0), "d_dom": (31.0, 1.0, 31.0)}
    if column in fixed:
        return fixed[column]
    if column.endswith("date_sk"):
        return (float(SALES_SK_HI - SALES_SK_LO + 1), float(SALES_SK_LO),
                float(SALES_SK_HI))
    for suffix, target in FK_TARGETS.items():
        if column.endswith(suffix) and table != target:
            t = float(num_rows(target, sf))
            return t, 1.0, t
    return None
