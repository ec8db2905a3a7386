"""A counter-based NumPy generator of the benchmark's TPC-DS star schema,
shaped as dsdgen shapes the data that TPC-DS Q27, Q93 and Q98 depend on.

Every value is a hash of (stream, row): splitmix64 over the row number,
keyed by the stream's name, so any column is made in one vectorised pass
and the same scale factor always gives the same data.  It is not dsdgen:
its seeds and most of its distributions are not reproduced; the value
lists that do not come from the specification's text are listed in the
configuration's ``assumed``.

What the templates depend on follows dsdgen:

* ``customer_demographics`` is the whole cross product of its eight
  attributes (1,920,800 rows), ``cd_demo_sk`` counting through it with the
  gender fastest, so each (gender, marital status, education) triple of
  Q27 selects 1/70 of it;
* ``store_sales`` lines come in tickets of 8 to 16 lines with one date,
  customer, demographic and store a ticket and a distinct item on each
  line, so ``(ss_item_sk, ss_ticket_number)`` is unique;
* every foreign key of a fact row is NULL at ``NULL_RATE``, drawn apart
  for each column and row;
* ``ss_sold_date_sk`` is uniform over dsdgen's sales window, 1998-01-02
  to 2003-01-02, so every year Q27 draws and every month Q98 draws has
  sales;
* each ``store_returns`` row is one sold line: its item, ticket and
  customer, a quantity from 1 to the line's, and a reason from 1 to 35;
* ``s_state`` holds real state codes, ``r_reason_desc`` 35 distinct
  reasons and ``i_category`` the specification's 10 categories.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from math import gcd
from typing import Optional, Tuple

import numpy as np

from . import tpch_words as W
from .tpcds_schema import (
    D_SK_EPOCH, EPOCH_DATE, SALES_SK_HI, SALES_SK_LO, num_rows,
)

NULL_RATE = 0.04
LINES_PER_TICKET = (8, 16)

# the specification's categories (TPC-DS v3.2.0, the i_category domain)
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
# dsdgen's classes of each category, as recalled from its distributions
# (not in the specification's text): some names recur across categories
CLASSES = {
    "Books": ["arts", "business", "computers", "cooking", "entertainment",
              "fiction", "history", "home repair", "mystery", "parenting",
              "reference", "romance", "science", "self-help", "sports",
              "travel"],
    "Children": ["infants", "newborn", "school-uniforms", "toddlers"],
    "Electronics": ["audio", "automotive", "camcorders", "cameras",
                    "disk drives", "dvd/vcr players", "karoke", "memory",
                    "monitors", "musical", "personal", "portable",
                    "scanners", "stereo", "televisions", "wireless"],
    "Home": ["accent", "bathroom", "bedding", "blinds/shades",
             "curtains/drapes", "decor", "flatware", "furniture",
             "glassware", "kids", "lighting", "mattresses", "paint", "rugs",
             "tables", "wallpaper"],
    "Jewelry": ["birdal", "bracelets", "costume", "diamonds", "earings",
                "estate", "gold", "jewelry boxes", "loose stones",
                "mens watch", "pendants", "rings", "semi-precious",
                "womens watch"],
    "Men": ["accessories", "pants", "shirts", "sports-apparel"],
    "Music": ["classical", "country", "pop", "rock"],
    "Shoes": ["athletic", "kids", "mens", "womens"],
    "Sports": ["archery", "athletic shoes", "baseball", "basketball",
               "camping", "fishing", "fitness", "football", "golf", "guns",
               "hockey", "optics", "outdoor", "pools", "sailing", "tennis"],
    "Women": ["dresses", "fragrances", "maternity", "swimwear"],
}
# the demographics' domains, in cd_demo_sk's order (gender fastest)
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT = ["Good", "Low Risk", "High Risk", "Unknown"]
# the stores' states, store k in STORE_STATES[(k - 1) % 8]
STORE_STATES = ["TN", "GA", "AL", "SD", "KY", "OH", "MI", "IN"]
# dsdgen's return reasons, as recalled from its distributions
REASONS = [
    "Package was damaged", "Stopped working", "Did not get it on time",
    "Not the product that was ordred", "Parts missing",
    "Does not work with a product that I have", "Gift exchange",
    "Did not like the color", "Did not like the model",
    "Did not like the make", "Did not like the warranty",
    "No service location in my area", "Found a better price in a store",
    "Found a better extended warranty in a store", "Not working any more",
    "Did not fit", "Wrong size", "Lost my job", "unauthoized purchase",
    "duplicate purchase", "its is a boy", "it is a girl",
] + [f"reason {k}" for k in range(23, 36)]
# dsdgen's syllables for names made from a number's digits
SYLLABLES = ["bar", "ought", "able", "pri", "pres", "ese", "anti", "cally",
             "ation", "eing"]
_BKEY = np.array(list("ABCDEFGHIJKLMNOP"))
_PRIMES = [7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
           71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127]


def _mix(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _key(stream: str) -> np.uint64:
    h = hashlib.sha256(f"perfbench/tpcds/{stream}".encode()).digest()
    return np.uint64(int.from_bytes(h[:8], "little"))


def u64(stream: str, rows: np.ndarray) -> np.ndarray:
    """The stream's 64-bit draw for each row number."""
    with np.errstate(over="ignore"):
        return _mix(rows.astype(np.uint64) * np.uint64(0x2545F4914F6CDD1D)
                    + _key(stream))


def ints(stream: str, rows: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform whole numbers in [lo, hi], one a row."""
    span = np.uint64(hi - lo + 1)
    return (u64(stream, rows) % span).astype(np.int64) + lo


def nulls(stream: str, rows: np.ndarray) -> np.ndarray:
    """True where the column is NULL in the row (``NULL_RATE``)."""
    return u64(stream + ".null", rows) < np.uint64(
        int(NULL_RATE * 2.0 ** 64))


def bkey(keys: np.ndarray) -> np.ndarray:
    """dsdgen's 16-character business key: eight A's, then the key's low
    32 bits a nibble a character, lowest first, in the letters A-P."""
    nib = np.stack([(keys >> (4 * i)) & 15 for i in range(8)], axis=1)
    return np.array(["AAAAAAAA" + "".join(r) for r in _BKEY[nib]])


def syllable_names(keys: np.ndarray) -> np.ndarray:
    return np.array(["".join(SYLLABLES[int(d)] for d in str(int(k)))
                     for k in keys])


class TpcdsGenerator:
    def __init__(self, sf: float):
        self.sf = sf

    def num_rows(self, table: str) -> int:
        return num_rows(table, self.sf)

    def column(self, table: str, column: str) -> Tuple[
            np.ndarray, Optional[np.ndarray]]:
        """(values, validity or None); strings as numpy str arrays."""
        fn = getattr(self, f"_{table}", None)
        if fn is None:
            raise KeyError(f"{table}.{column}")
        return fn(column, np.arange(self.num_rows(table), dtype=np.int64))

    # ---------------------------------------------------- dimensions

    def _date_dim(self, column, rows):
        dates = EPOCH_DATE + rows
        if column == "d_date_sk":
            return D_SK_EPOCH + rows, None
        if column == "d_date":
            return (dates - np.datetime64("1970-01-01", "D")).astype(
                np.int32), None
        if column == "d_year":
            return (dates.astype("datetime64[Y]").astype(np.int64)
                    + 1970).astype(np.int32), None
        if column == "d_moy":
            return (dates.astype("datetime64[M]").astype(np.int64) % 12
                    + 1).astype(np.int32), None
        if column == "d_dom":
            return ((dates - dates.astype("datetime64[M]")).astype(np.int64)
                    + 1).astype(np.int32), None
        raise KeyError(f"date_dim.{column}")

    def _item(self, column, rows):
        sk = rows + 1
        cat = ints("item.category", rows, 0, len(CATEGORIES) - 1)
        sizes = np.array([len(CLASSES[c]) for c in CATEGORIES])
        pick = (u64("item.class", rows) % sizes[cat].astype(np.uint64)) \
            .astype(np.int64)
        if column == "i_item_sk":
            return sk, None
        if column == "i_item_id":
            return bkey(sk), None
        if column == "i_item_desc":
            words = [np.array(w) for w in (W.ADVERBS, W.ADJECTIVES,
                                           W.NOUNS, W.VERBS)]
            out = words[0][ints("item.desc0", rows, 0, len(words[0]) - 1)]
            for k, w in enumerate(words[1:], 1):
                out = np.char.add(np.char.add(out, " "), w[
                    ints(f"item.desc{k}", rows, 0, len(w) - 1)])
            return out, None
        if column == "i_current_price":
            return ints("item.price", rows, 9, 9999), None
        if column == "i_category_id":
            return (cat + 1).astype(np.int32), None
        if column == "i_category":
            return np.array(CATEGORIES)[cat], None
        if column == "i_class_id":
            return (pick + 1).astype(np.int32), None
        if column == "i_class":
            flat = np.array([c for name in CATEGORIES
                             for c in CLASSES[name]])
            start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            return flat[start[cat] + pick], None
        raise KeyError(f"item.{column}")

    def _customer_demographics(self, column, rows):
        radix = [("cd_gender", GENDERS), ("cd_marital_status", MARITAL),
                 ("cd_education_status", EDUCATION),
                 ("cd_purchase_estimate", 20), ("cd_credit_rating", CREDIT),
                 ("cd_dep_count", 7), ("cd_dep_employed_count", 7),
                 ("cd_dep_college_count", 7)]
        if column == "cd_demo_sk":
            return rows + 1, None
        rest = rows.copy()
        for name, domain in radix:
            size = domain if isinstance(domain, int) else len(domain)
            digit = rest % size
            rest //= size
            if name != column:
                continue
            if name == "cd_purchase_estimate":
                return ((digit + 1) * 500).astype(np.int32), None
            if isinstance(domain, int):
                return digit.astype(np.int32), None
            return np.array(domain)[digit], None
        raise KeyError(f"customer_demographics.{column}")

    def _store(self, column, rows):
        sk = rows + 1
        if column == "s_store_sk":
            return sk, None
        if column == "s_store_id":
            return bkey(sk), None
        if column == "s_store_name":
            return syllable_names(sk), None
        if column == "s_state":
            return np.array(STORE_STATES)[rows % len(STORE_STATES)], None
        raise KeyError(f"store.{column}")

    def _reason(self, column, rows):
        sk = rows + 1
        if column == "r_reason_sk":
            return sk, None
        if column == "r_reason_id":
            return bkey(sk), None
        if column == "r_reason_desc":
            return np.array(REASONS)[rows % len(REASONS)], None
        raise KeyError(f"reason.{column}")

    # ---------------------------------------------------------- facts

    @lru_cache(maxsize=1)
    def tickets(self) -> Tuple[np.ndarray, np.ndarray]:
        """Each store_sales line's ticket (from 0) and its place on it."""
        n = self.num_rows("store_sales")
        lo, hi = LINES_PER_TICKET
        sizes = ints("ss.lines", np.arange(n // lo + 1), lo,
                     min(hi, self.num_rows("item")))
        ends = np.cumsum(sizes)
        count = int(np.searchsorted(ends, n)) + 1
        ticket = np.repeat(np.arange(count), sizes[:count])[:n]
        starts = np.concatenate([[0], ends[:count - 1]])
        return ticket, np.arange(n) - starts[ticket]

    def _fk(self, stream: str, at: np.ndarray, rows: np.ndarray, lo: int,
            hi: int):
        """A foreign key drawn for each entry of ``at`` (a ticket or a
        line), NULL in a row at ``NULL_RATE``."""
        return ints(stream, at, lo, hi), ~nulls(stream, rows)

    def _store_sales(self, column, rows):
        ticket, line = self.tickets()
        if column == "ss_ticket_number":
            return ticket + 1, None
        if column == "ss_item_sk":
            items = self.num_rows("item")
            strides = np.array([p for p in _PRIMES if gcd(p, items) == 1])
            base = ints("ss.item", ticket, 0, items - 1)
            stride = strides[ints("ss.stride", ticket, 0, len(strides) - 1)]
            return (base + line * stride) % items + 1, None
        if column == "ss_sold_date_sk":
            return self._fk("ss.date", ticket, rows, SALES_SK_LO,
                            SALES_SK_HI)
        if column == "ss_customer_sk":
            return self._fk("ss.customer", ticket, rows, 1,
                            self.num_rows("customer"))
        if column == "ss_cdemo_sk":
            return self._fk("ss.cdemo", ticket, rows, 1,
                            self.num_rows("customer_demographics"))
        if column == "ss_store_sk":
            return self._fk("ss.store", ticket, rows, 1,
                            self.num_rows("store"))
        if column == "ss_quantity":
            return ints("ss.quantity", rows, 1, 100).astype(np.int32), None
        price = self._prices(rows)
        if column in price:
            return price[column], None
        raise KeyError(f"store_sales.{column}")

    def _prices(self, rows) -> dict:
        """dsdgen's pricing of a line, in cents: a wholesale cost of 1.00
        to 100.00, a list price 0-200 % above it, a sales price 0-100 %
        below that, times the quantity, and a coupon on one line in five."""
        wholesale = ints("ss.wholesale", rows, 100, 10_000)
        listed = wholesale * (100 + ints("ss.markup", rows, 0, 200)) // 100
        sales = listed * (100 - ints("ss.discount", rows, 0, 100)) // 100
        ext = sales * ints("ss.quantity", rows, 1, 100)
        coupon = np.where(ints("ss.coupon", rows, 0, 4) == 0,
                          ext * ints("ss.coupon_pct", rows, 0, 100) // 100, 0)
        return {"ss_wholesale_cost": wholesale, "ss_list_price": listed,
                "ss_sales_price": sales, "ss_ext_sales_price": ext,
                "ss_coupon_amt": coupon}

    @lru_cache(maxsize=1)
    def returned_lines(self) -> np.ndarray:
        """The store_sales lines that came back, in sales order: the
        ``store_returns`` rows smallest on a hash of the line."""
        n = self.num_rows("store_sales")
        k = min(self.num_rows("store_returns"), n)
        h = u64("sr.line", np.arange(n))
        return np.sort(np.argpartition(h, k - 1)[:k])

    def _store_returns(self, column, rows):
        lines = self.returned_lines()
        sales = np.arange(self.num_rows("store_sales"))
        sold = {"sr_item_sk": "ss_item_sk",
                "sr_ticket_number": "ss_ticket_number",
                "sr_customer_sk": "ss_customer_sk"}
        if column in sold:
            values, valid = self._store_sales(sold[column], sales)
            return values[lines], None if valid is None else valid[lines]
        qty = ints("ss.quantity", lines, 1, 100)
        ret_qty = (u64("sr.quantity", rows) % qty.astype(np.uint64)) \
            .astype(np.int64) + 1
        if column == "sr_return_quantity":
            return ret_qty.astype(np.int32), None
        if column == "sr_return_amt":
            return ret_qty * self._prices(lines)["ss_sales_price"], None
        if column == "sr_reason_sk":
            return self._fk("sr.reason", rows, rows, 1,
                            self.num_rows("reason"))
        if column == "sr_returned_date_sk":
            date, valid = self._store_sales("ss_sold_date_sk", sales)
            later = date[lines] + ints("sr.date", rows, 1, 90)
            return later, valid[lines] & ~nulls("sr.date", rows)
        raise KeyError(f"store_returns.{column}")
