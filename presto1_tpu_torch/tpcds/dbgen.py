"""Deterministic vectorized TPC-DS data generator.

Hash-based (splitmix64 over row index, keyed by table/column), so any
column of any table materialises independently in one numpy pass —
the same lazy-column design as the TPC-H dbgen (tpch/dbgen.py).  Value
distributions are simplified relative to dsdgen (documented in
PARITY.md); row counts follow the spec at SF1 and scale linearly.
date_dim and time_dim are exact calendars (spec-shaped surrogate keys:
d_date_sk 2415022 == 1900-01-02).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

from .schema import FIXED, SF1_ROWS, TABLES

# spec epoch: d_date_sk 2415022 corresponds to 1900-01-02
D_SK_EPOCH = 2415022
_EPOCH_DATE = np.datetime64("1900-01-02", "D")
_DAYS_1970 = int((np.datetime64("1970-01-01", "D") - _EPOCH_DATE).astype(int))
# sales activity window: 1998-01-02 .. 2003-01-02 (5 years, spec)
SALES_SK_LO = D_SK_EPOCH + int(
    (np.datetime64("1998-01-02") - _EPOCH_DATE).astype(int))
SALES_SK_HI = D_SK_EPOCH + int(
    (np.datetime64("2003-01-02") - _EPOCH_DATE).astype(int))


def _mix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _seed(table: str, column: str, salt: int = 0) -> np.uint64:
    h = hashlib.sha256(f"tpcds/{table}/{column}/{salt}".encode()).digest()
    return np.uint64(int.from_bytes(h[:8], "little"))


def _u64(table: str, column: str, n: int, salt: int = 0) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return _mix(i + _seed(table, column, salt))


def _uniform_int(table, column, n, lo, hi, salt=0) -> np.ndarray:
    span = np.uint64(hi - lo + 1)
    off = (_u64(table, column, n, salt) % span).astype(np.int64)
    return np.int64(lo) + off


# enum vocabularies (subset of dsdgen's)
VOCABS: Dict[str, list] = {
    "cd_gender": ["F", "M"],
    "cd_marital_status": ["D", "M", "S", "U", "W"],
    "cd_education_status": ["2 yr Degree", "4 yr Degree", "Advanced Degree",
                            "College", "Primary", "Secondary", "Unknown"],
    "cd_credit_rating": ["Good", "High Risk", "Low Risk", "Unknown"],
    "hd_buy_potential": ["0-500", "1001-5000", "501-1000", "5001-10000",
                         ">10000", "Unknown"],
    "i_category": ["Books", "Children", "Electronics", "Home", "Jewelry",
                   "Men", "Music", "Shoes", "Sports", "Women"],
    "i_size": ["N/A", "economy", "extra large", "large", "medium", "petite",
               "small"],
    "i_color": ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
                "black", "blanched", "blue", "blush", "brown", "burlywood",
                "burnished", "chartreuse", "chiffon", "chocolate", "coral",
                "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
                "dim", "dodger", "drab", "firebrick", "floral", "forest",
                "frosted", "gainsboro", "ghost", "goldenrod", "green",
                "grey", "honeydew", "hot", "indian", "ivory", "khaki",
                "lace", "lavender", "lawn", "lemon", "light", "lime",
                "linen", "magenta", "maroon", "medium"],
    "i_units": ["Box", "Bunch", "Bundle", "Carton", "Case", "Cup", "Dozen",
                "Dram", "Each", "Gram", "Gross", "Lb", "N/A", "Ounce",
                "Oz", "Pallet", "Pound", "Tbl", "Ton", "Tsp", "Unknown"],
    "i_container": ["Unknown"],
    "ca_street_type": ["Ave", "Blvd", "Boulevard", "Circle", "Court", "Ct",
                       "Dr", "Drive", "Lane", "Ln", "Parkway", "Pkwy",
                       "RD", "Rd", "Road", "ST", "St", "Street", "Way"],
    "ca_city": ["Antioch", "Bethel", "Bridgeport", "Centerville", "Clifton",
                "Concord", "Fairview", "Five Points", "Georgetown",
                "Glendale", "Greenville", "Harmony", "Jamestown",
                "Lakeview", "Lebanon", "Liberty", "Marion", "Midway",
                "Mount Olive", "Mount Pleasant", "Oak Grove", "Oak Hill",
                "Oakland", "Pleasant Grove", "Pleasant Hill", "Riverside",
                "Salem", "Springdale", "Springfield", "Sulphur Springs",
                "Union", "Walnut Grove", "Wilson", "Woodland"],
    "ca_county": ["Barrow County", "Bronx County", "Daviess County",
                  "Fairfield County", "Franklin Parish", "Gage County",
                  "Gogebic County", "Huron County", "Jackson County",
                  "Luce County", "Mobile County", "Mesa County",
                  "Oglethorpe County", "Pennington County", "Perry County",
                  "Richland County", "San Miguel County", "Walker County",
                  "Williamson County", "Ziebach County"],
    "ca_state": ["AL", "AR", "AZ", "CA", "CO", "CT", "FL", "GA", "IA", "ID",
                 "IL", "IN", "KS", "KY", "LA", "MA", "MD", "MI", "MN", "MO",
                 "MS", "MT", "NC", "ND", "NE", "NJ", "NM", "NY", "OH", "OK",
                 "OR", "PA", "SC", "SD", "TN", "TX", "UT", "VA", "WA", "WI",
                 "WV", "WY"],
    "ca_country": ["United States"],
    "ca_location_type": ["apartment", "condo", "single family"],
    "c_salutation": ["Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir"],
    "c_first_name": ["Aaron", "Alice", "Amy", "Anna", "Barbara", "Betty",
                     "Brian", "Carol", "David", "Donna", "Dorothy",
                     "Edward", "Eric", "Frank", "George", "Helen", "James",
                     "Jason", "Jennifer", "John", "Jose", "Karen", "Kevin",
                     "Linda", "Lisa", "Margaret", "Maria", "Mark", "Mary",
                     "Michael", "Nancy", "Patricia", "Paul", "Robert",
                     "Ruth", "Sandra", "Sarah", "Scott", "Steven", "Susan",
                     "Thomas", "William"],
    "c_last_name": ["Adams", "Allen", "Anderson", "Baker", "Brown",
                    "Campbell", "Carter", "Clark", "Davis", "Edwards",
                    "Evans", "Garcia", "Gonzalez", "Green", "Hall",
                    "Harris", "Hernandez", "Hill", "Jackson", "Johnson",
                    "Jones", "King", "Lee", "Lewis", "Lopez", "Martin",
                    "Martinez", "Miller", "Mitchell", "Moore", "Nelson",
                    "Parker", "Perez", "Phillips", "Roberts", "Robinson",
                    "Rodriguez", "Scott", "Smith", "Taylor", "Thomas",
                    "Thompson", "Turner", "Walker", "White", "Williams",
                    "Wilson", "Wright", "Young"],
    "c_birth_country": ["BRAZIL", "CANADA", "CHINA", "FRANCE", "GERMANY",
                        "INDIA", "ITALY", "JAPAN", "MEXICO",
                        "UNITED KINGDOM", "UNITED STATES"],
    "s_hours": ["8AM-12AM", "8AM-4PM", "8AM-8AM"],
    "sm_type": ["EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT", "REGULAR",
                "TWO DAY"],
    "sm_code": ["AIR", "GROUND", "SEA", "SURFACE"],
    "sm_carrier": ["AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL",
                   "DIAMOND", "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF",
                   "LATVIAN", "MSC", "ORIENTAL", "PRIVATECARRIER", "RUPEKSA",
                   "TBS", "UPS", "USPS", "ZHOU", "ZOUROS"],
    "p_purpose": ["Unknown"],
    "p_channel_details": ["Unknown"],
    "cp_department": ["DEPARTMENT"],
    "cp_type": ["annual", "bi-annual", "quarterly"],
    "wp_type": ["ad", "dynamic", "feedback", "general", "order",
                "protected", "welcome"],
    "r_reason_desc": ["Did not fit", "Did not get it on time",
                      "Found a better extension", "Gift exchange",
                      "Lost my job", "No service location",
                      "Not the product that was ordred", "Package was damaged",
                      "Parts missing", "Stopped working", "Unauthoized purchase",
                      "Wrong size"],
    "t_am_pm": ["AM", "PM"],
    "t_shift": ["first", "second", "third"],
    "t_sub_shift": ["afternoon", "evening", "morning", "night"],
    "t_meal_time": ["breakfast", "dinner", "lunch"],
    "flag": ["N", "Y"],
    "day_name": ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                 "Friday", "Saturday"],
}

# foreign-key target table by column suffix/name
FK_TARGETS: Dict[str, str] = {
    "item_sk": "item", "customer_sk": "customer", "cdemo_sk":
    "customer_demographics", "hdemo_sk": "household_demographics",
    "addr_sk": "customer_address", "store_sk": "store", "promo_sk":
    "promotion", "warehouse_sk": "warehouse", "ship_mode_sk": "ship_mode",
    "call_center_sk": "call_center", "catalog_page_sk": "catalog_page",
    "web_page_sk": "web_page", "web_site_sk": "web_site", "reason_sk":
    "reason", "income_band_sk": "income_band",
}


# dimension-table surrogate primary keys (sequential 1..n)
PK_COLUMNS = {
    "i_item_sk", "c_customer_sk", "ca_address_sk", "cd_demo_sk",
    "hd_demo_sk", "ib_income_band_sk", "s_store_sk", "p_promo_sk",
    "w_warehouse_sk", "sm_ship_mode_sk", "r_reason_sk",
    "cc_call_center_sk", "cp_catalog_page_sk", "web_site_sk",
    "wp_web_page_sk",
}


class TpcdsGenerator:
    def __init__(self, sf: float = 1.0):
        self.sf = sf

    def num_rows(self, table: str) -> int:
        base = SF1_ROWS[table]
        if table in FIXED or self.sf >= 1.0:
            n = base if table in FIXED else int(base * self.sf)
        else:
            n = max(int(base * self.sf), 1)
        return max(n, 1)

    # ------------------------------------------------------------ dates

    def _date_dim_column(self, column: str, n: int) -> np.ndarray:
        days = np.arange(n)  # day 0 = 1900-01-02
        dates = _EPOCH_DATE + days
        if column == "d_date_sk":
            return (D_SK_EPOCH + days).astype(np.int64)
        if column == "d_date":
            return (days - _DAYS_1970).astype(np.int32)
        if column == "d_date_id":
            return np.char.add("D", np.char.zfill(
                days.astype("U8"), 8))
        y = dates.astype("datetime64[Y]").astype(int) + 1970
        m = dates.astype("datetime64[M]").astype(int) % 12 + 1
        dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
        if column == "d_year":
            return y.astype(np.int32)
        if column == "d_moy":
            return m.astype(np.int32)
        if column == "d_dom":
            return dom.astype(np.int32)
        if column == "d_dow":  # 0 = Sunday (spec)
            return ((days + 2) % 7).astype(np.int32)  # 1900-01-02 was Tuesday
        if column == "d_qoy":
            return ((m - 1) // 3 + 1).astype(np.int32)
        if column == "d_month_seq":
            return ((y - 1900) * 12 + m - 1).astype(np.int32)
        if column == "d_week_seq":
            return ((days + 2) // 7 + 1).astype(np.int32)
        if column in ("d_quarter_seq", "d_fy_quarter_seq"):
            return ((y - 1900) * 4 + (m - 1) // 3 + 1).astype(np.int32)
        if column == "d_fy_year":
            return y.astype(np.int32)
        if column == "d_fy_week_seq":
            return ((days + 2) // 7 + 1).astype(np.int32)
        if column == "d_day_name":
            return np.array(VOCABS["day_name"])[(days + 2) % 7]
        if column == "d_quarter_name":
            q = (m - 1) // 3 + 1
            return np.array([f"{yy}Q{qq}" for yy, qq in zip(y, q)])
        if column == "d_holiday":
            return np.where((m == 12) & (dom == 25), "Y", "N")
        if column == "d_weekend":
            dow = (days + 2) % 7
            return np.where((dow == 0) | (dow == 6), "Y", "N")
        if column == "d_following_holiday":
            hol = (m == 12) & (dom == 25)
            return np.where(np.roll(hol, 1), "Y", "N")
        if column == "d_first_dom":
            return (D_SK_EPOCH + days - (dom - 1)).astype(np.int32)
        if column == "d_last_dom":
            month_end = (dates.astype("datetime64[M]") + 1).astype(
                "datetime64[D]") - 1
            return (D_SK_EPOCH + (month_end - _EPOCH_DATE).astype(int)) \
                .astype(np.int32)
        if column == "d_same_day_ly":
            return (D_SK_EPOCH + days - 365).astype(np.int32)
        if column == "d_same_day_lq":
            return (D_SK_EPOCH + days - 91).astype(np.int32)
        if column in ("d_current_day", "d_current_week", "d_current_month",
                      "d_current_quarter", "d_current_year"):
            return np.full(n, "N")
        raise KeyError(column)

    def _time_dim_column(self, column: str, n: int) -> np.ndarray:
        t = np.arange(n)
        if column == "t_time_sk":
            return t.astype(np.int64)
        if column == "t_time":
            return t.astype(np.int32)
        if column == "t_time_id":
            return np.char.add("T", np.char.zfill(t.astype("U8"), 8))
        h, rem = t // 3600, t % 3600
        if column == "t_hour":
            return h.astype(np.int32)
        if column == "t_minute":
            return (rem // 60).astype(np.int32)
        if column == "t_second":
            return (rem % 60).astype(np.int32)
        if column == "t_am_pm":
            return np.where(h < 12, "AM", "PM")
        if column == "t_shift":
            return np.array(VOCABS["t_shift"])[np.minimum(h // 8, 2)]
        if column == "t_sub_shift":
            return np.array(VOCABS["t_sub_shift"])[np.minimum(h // 6, 3)]
        if column == "t_meal_time":
            return np.select([(h >= 6) & (h < 9), (h >= 11) & (h < 14),
                              (h >= 17) & (h < 21)],
                             ["breakfast", "lunch", "dinner"], "")
        raise KeyError(column)

    # ---------------------------------------------------------- generic

    def column(self, table: str, column: str) -> Tuple[
            np.ndarray, Optional[np.ndarray]]:
        """-> (values, validity|None); strings come back as numpy U arrays."""
        n = self.num_rows(table)
        if table == "date_dim":
            return self._date_dim_column(column, n), None
        if table == "time_dim":
            return self._time_dim_column(column, n), None
        if table == "dbgen_version":
            vals = {"dv_version": np.array(["3.2.0"]),
                    "dv_create_date": np.array([10000], np.int32),
                    "dv_create_time": np.array(["00:00:00"]),
                    "dv_cmdline_args": np.array(["presto1-tpu tpcds"])}
            return vals[column], None

        keys = np.arange(1, n + 1, dtype=np.int64)

        # dimension surrogate primary keys and fact sequence numbers
        if column in PK_COLUMNS or column.endswith(("_ticket_number",
                                                    "_order_number")):
            return keys, None
        # business-id columns: unique char id per row
        if column.endswith("_id") and dict(TABLES[table])[column].is_string:
            return np.char.add("AAAAAAAA",
                               np.char.zfill(keys.astype("U12"), 12)), None
        # income band bounds
        if column == "ib_lower_bound":
            return ((keys - 1) * 10000).astype(np.int64), None
        if column == "ib_upper_bound":
            return (keys * 10000).astype(np.int64), None
        # date surrogate keys on facts/dims: within the sales window
        if column.endswith("date_sk"):
            vals = _uniform_int(table, column, n, SALES_SK_LO, SALES_SK_HI)
            nulls = (_u64(table, column, n, 1) % np.uint64(100)) < 2
            if column in ("ss_sold_date_sk", "cs_sold_date_sk",
                          "ws_sold_date_sk", "inv_date_sk",
                          "sr_returned_date_sk", "cr_returned_date_sk",
                          "wr_returned_date_sk"):
                return vals, None
            return vals, ~nulls
        if column.endswith("time_sk"):
            vals = _uniform_int(table, column, n, 0, 86399)
            return vals, None
        # foreign keys
        for suffix, target in FK_TARGETS.items():
            if column.endswith(suffix) and table != target:
                hi = self.num_rows(target)
                vals = _uniform_int(table, column, n, 1, hi)
                nulls = (_u64(table, column, n, 1) % np.uint64(100)) < 2
                return vals, ~nulls
        # correlated item hierarchy (id ranges scale with table size so
        # point predicates still select rows at small scale factors)
        if table == "item":
            n_man = max(1, min(1000, n // 10))
            n_brand = max(1, min(1000, n // 10))
            if column == "i_manufact_id":
                return _uniform_int(table, "i_manufact_id", n, 1, n_man), None
            if column == "i_manufact":
                ids = _uniform_int(table, "i_manufact_id", n, 1, n_man)
                return np.char.add("able", ids.astype("U6")), None
            if column == "i_brand_id":
                return _uniform_int(table, "i_brand_id", n, 1, n_brand), None
            if column == "i_brand":
                ids = _uniform_int(table, "i_brand_id", n, 1, n_brand)
                return np.char.add("Brand#", ids.astype("U6")), None
            if column == "i_category_id":
                return (_uniform_int(table, "i_category_id", n, 0, 9) + 1,
                        None)
            if column == "i_category":
                ids = _uniform_int(table, "i_category_id", n, 0, 9)
                return np.array(VOCABS["i_category"])[ids], None
            if column == "i_class_id":
                return _uniform_int(table, "i_class_id", n, 1, 16), None
            if column == "i_class":
                ids = _uniform_int(table, "i_class_id", n, 1, 16)
                return np.char.add("class", ids.astype("U4")), None
            if column == "i_manager_id":
                return _uniform_int(
                    table, column, n, 1, max(1, min(100, n // 10))), None
            if column == "i_product_name":
                return np.char.add("product", keys.astype("U12")), None
            if column == "i_item_desc":
                return np.char.add("item description ",
                                   keys.astype("U12")), None
        if column in VOCABS:
            v = np.array(VOCABS[column])
            ids = _uniform_int(table, column, n, 0, len(v) - 1)
            return v[ids], None
        col_type = dict(TABLES[table])[column]
        if col_type.kind == "decimal":
            scale = 10 ** col_type.scale  # type: ignore[attr-defined]
            if column.endswith(("_gmt_offset",)):
                ids = _uniform_int(table, column, n, -8, -5)
                return (ids * scale).astype(np.int64), None
            if column.endswith(("_tax_percentage", "_tax_precentage")):
                return _uniform_int(table, column, n, 0, 11), None
            lo, hi = (0, 200 * scale)
            if column.endswith(("_list_price", "_sales_price",
                                "_current_price", "_wholesale_cost")):
                lo, hi = scale, 100 * scale
            return _uniform_int(table, column, n, lo, hi), None
        if col_type.kind == "date":
            # slowly-changing-dimension bounds: fixed spec dates
            if column.endswith("rec_start_date"):
                d = int((np.datetime64("1997-03-13") -
                         np.datetime64("1970-01-01")).astype(int))
                return np.full(n, d, np.int32), None
            if column.endswith("rec_end_date"):
                d = int((np.datetime64("2001-03-12") -
                         np.datetime64("1970-01-01")).astype(int))
                vals = np.full(n, d, np.int32)
                return vals, (keys % 2 == 0)
            return _uniform_int(table, column, n, 7000, 12000) \
                .astype(np.int32), None
        if col_type.is_string:
            # generic varchar: flags and small text
            if column.startswith(("p_channel_",)) or \
                    column.endswith(("_flag", "_holiday", "_weekend",
                                     "_discount_active", "_preferred_cust_flag")):
                v = np.array(VOCABS["flag"])
                ids = _uniform_int(table, column, n, 0, 1)
                return v[ids], None
            pool = np.array(["alpha", "beta", "gamma", "delta", "epsilon",
                             "zeta", "eta", "theta", "iota", "kappa"])
            ids = _uniform_int(table, column, n, 0, len(pool) - 1)
            return np.char.add(pool[ids], (keys % 97).astype("U3")), None
        # generic integers
        if column.endswith(("_quantity", "quantity_on_hand",
                            "_return_quantity")):
            return _uniform_int(table, column, n, 1, 100), None
        if column.endswith(("_dep_count", "_dep_employed_count",
                            "_dep_college_count", "_vehicle_count")):
            return _uniform_int(table, column, n, 0, 6), None
        if column == "cd_purchase_estimate":
            return _uniform_int(table, column, n, 1, 20) * 500, None
        if column == "c_birth_year":
            return _uniform_int(table, column, n, 1924, 1992), None
        if column == "c_birth_month":
            return _uniform_int(table, column, n, 1, 12), None
        if column == "c_birth_day":
            return _uniform_int(table, column, n, 1, 28), None
        return _uniform_int(table, column, n, 1, 1000), None
