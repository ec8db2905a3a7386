"""Frozen copy of presto1_tpu_torch/tpch/dbgen.py (its native text fast path left out),
kept here so that the benchmark's data does not move with the program.

Deterministic vectorized TPC-H data generator.

Architecture mirrors classic dbgen (and the reference's external
``io.trino.tpch`` library, used via
``plugin/trino-tpch/.../TpchRecordSetProvider.java:25``): every column has
its own Lehmer LCG stream (seed' = seed * 16807 mod 2^31-1) with a fixed
number of draws per row, so any row range can be generated independently by
jumping the stream ahead — here the jump-ahead is *vectorized* with
square-and-multiply over numpy arrays, generating millions of rows per
second with no row loop.

Exactness policy (documented deviation): the per-stream *seed constants* of
TPC's dbgen are not reproduced (the library holding them is not available
in this environment and the reference repo does not vendor it), so the data
is spec-shaped — same schemas, distributions, value formulas, sparse
orderkeys, customer mortality, text grammar — but not byte-identical to
dbgen's.  Correctness of the engine is validated row-exactly against an
independent oracle (pandas) over this generator's output; swapping in
dbgen's seed table later only means replacing ``_seed_of``.
"""

from __future__ import annotations

import zlib
from functools import lru_cache
from typing import Dict, Optional

import numpy as np

from . import tpch_words as W

M = np.uint64(2147483647)  # 2^31 - 1
A = np.uint64(16807)

EPOCH = np.datetime64("1970-01-01", "D")


def _days(iso: str) -> int:
    return int((np.datetime64(iso, "D") - EPOCH) / np.timedelta64(1, "D"))


START_DATE = _days("1992-01-01")
END_DATE = _days("1998-12-31")
CURRENT_DATE = _days("1995-06-17")
ORDER_DATE_SPAN = END_DATE - 151 - START_DATE + 1  # last orderdate 1998-08-02


def _pow_mod(base: int, exp: int) -> int:
    return pow(int(base), int(exp), int(M))


def _pow_mod_vec(base: int, exps: np.ndarray) -> np.ndarray:
    """base**exps mod M, elementwise (square-and-multiply, ~63 vector ops)."""
    result = np.ones(exps.shape, dtype=np.uint64)
    b = np.uint64(base % int(M))
    e = exps.astype(np.uint64).copy()
    while True:
        odd = (e & np.uint64(1)).astype(bool)
        if odd.any():
            result[odd] = (result[odd] * b) % M
        e >>= np.uint64(1)
        if not e.any():
            break
        b = (b * b) % M
    return result


def _seed_of(name: str) -> int:
    s = (zlib.crc32(name.encode()) % (int(M) - 2)) + 1
    return s


class Stream:
    """A per-column random stream: row i's k-th draw is
    seed0 * A**(i*usage + k) mod M."""

    def __init__(self, name: str, usage: int):
        self.seed0 = np.uint64(_seed_of(name))
        self.usage = usage

    def seeds(self, start: int, n: int, k: int = 0) -> np.ndarray:
        exps = (np.arange(start, start + n, dtype=np.uint64) * np.uint64(self.usage)
                + np.uint64(k + 1))
        return (self.seed0 * _pow_mod_vec(int(A), exps)) % M

    def ints(self, start: int, n: int, lo: int, hi: int, k: int = 0) -> np.ndarray:
        s = self.seeds(start, n, k)
        return (s % np.uint64(hi - lo + 1)).astype(np.int64) + lo


# ------------------------------------------------------------------ text


@lru_cache(maxsize=1)
def text_pool(size: int = 8 * 1024 * 1024) -> str:
    """Grammar-generated text pool (spec §4.2.2.13 sentence grammar).

    Sized down from the spec's 300MB for generation speed; substring
    comments keep the same vocabulary and phrase shapes (the properties
    the TPC-H LIKE predicates test).
    """
    rng = Stream("textpool", 1)
    # draw in big blocks; assemble sentences until pool is large enough
    out = []
    total = 0
    block = 200_000
    start = 0
    while total < size:
        d = rng.seeds(start, block * 12).astype(np.int64)
        start += block * 12
        i = 0

        def draw(n):
            nonlocal i
            v = d[i:i + n]
            i += n
            return v

        tmpl = draw(block) % 5
        np_kind = draw(block) % 4  # noun-phrase shape
        vp_kind = draw(block) % 4  # verb-phrase shape
        nouns = np.array(W.NOUNS)[draw(block) % len(W.NOUNS)]
        verbs = np.array(W.VERBS)[draw(block) % len(W.VERBS)]
        adjs = np.array(W.ADJECTIVES)[draw(block) % len(W.ADJECTIVES)]
        advs = np.array(W.ADVERBS)[draw(block) % len(W.ADVERBS)]
        preps = np.array(W.PREPOSITIONS)[draw(block) % len(W.PREPOSITIONS)]
        auxs = np.array(W.AUXILIARIES)[draw(block) % len(W.AUXILIARIES)]
        terms = np.array(W.TERMINATORS)[draw(block) % len(W.TERMINATORS)]
        nouns2 = np.array(W.NOUNS)[draw(block) % len(W.NOUNS)]

        for j in range(block):
            nph = _noun_phrase(int(np_kind[j]), nouns[j], adjs[j], advs[j])
            vph = _verb_phrase(int(vp_kind[j]), verbs[j], auxs[j], advs[j])
            pph = f"{preps[j]} the {nouns2[j]}"
            t = int(tmpl[j])
            if t == 0:
                s = f"{nph} {vph}{terms[j]}"
            elif t == 1:
                s = f"{nph} {vph} {pph}{terms[j]}"
            elif t == 2:
                s = f"{nph} {vph} {nouns2[j]}{terms[j]}"
            elif t == 3:
                s = f"{nph} {pph} {vph} {nouns2[j]}{terms[j]}"
            else:
                s = f"{nph} {pph} {vph} {pph}{terms[j]}"
            out.append(s)
            total += len(s) + 1
            if total >= size:
                break
    return " ".join(out)


def _noun_phrase(kind, noun, adj, adv):
    if kind == 0:
        return noun
    if kind == 1:
        return f"{adj} {noun}"
    if kind == 2:
        return f"{adj}, {adj} {noun}"
    return f"{adv} {adj} {noun}"


def _verb_phrase(kind, verb, aux, adv):
    if kind == 0:
        return verb
    if kind == 1:
        return f"{aux} {verb}"
    if kind == 2:
        return f"{verb} {adv}"
    return f"{aux} {verb} {adv}"


def _text_column(stream: Stream, start: int, n: int, lo: int, hi: int,
                 k: int = 0) -> np.ndarray:
    pool = text_pool()
    lengths = stream.ints(start, n, lo, hi, k)
    offsets = stream.ints(start, n, 0, len(pool) - hi - 1, k + 1)
    return np.array([pool[o:o + l] for o, l in zip(offsets, lengths)], dtype=object)


# comment columns generated via the plain text grammar;
# supplier comments are excluded (they get phrases spliced in — see
# _supplier_comment)
TEXT_SPECS = {
    ("part", "p_comment"): ("part.comment", 5, 22),
    ("customer", "c_comment"): ("customer.comment", 29, 116),
    ("orders", "o_comment"): ("orders.comment", 19, 78),
    ("lineitem", "l_comment"): ("lineitem.comment", 10, 43),
    ("partsupp", "ps_comment"): ("partsupp.comment", 49, 198),
    ("nation", "n_comment"): ("nation.comment", 31, 114),
    ("region", "r_comment"): ("region.comment", 31, 115),
}


_VCHARS = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789, ",
    dtype=np.uint8,
)


def _vstring_column(stream: Stream, start: int, n: int, lo: int, hi: int,
                    k: int = 0) -> np.ndarray:
    """Random alphanumeric string, length in [lo, hi] (dbgen v-strings).
    Each 31-bit draw yields five base-64 characters."""
    lengths = stream.ints(start, n, lo, hi, k)
    ndraw = (hi + 4) // 5
    chars = np.empty((n, ndraw * 5), dtype=np.uint8)
    for d in range(ndraw):
        s = stream.seeds(start, n, k + 1 + d).astype(np.int64)
        for c in range(5):
            chars[:, d * 5 + c] = _VCHARS[(s % 64)]
            s //= 64
    flat = chars.view("S1").reshape(n, -1)
    return np.array(
        [flat[i, :lengths[i]].tobytes().decode() for i in range(n)], dtype=object
    )


def _phone_column(stream: Stream, nationkey: np.ndarray, start: int, n: int,
                  k: int = 0) -> np.ndarray:
    cc = (10 + nationkey).astype(np.int64)
    l1 = stream.ints(start, n, 100, 999, k)
    l2 = stream.ints(start, n, 100, 999, k + 1)
    l3 = stream.ints(start, n, 1000, 9999, k + 2)
    a = np.char.zfill(cc.astype("U2"), 2)
    return (
        np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
            np.char.add(a, "-"), l1.astype("U3")), "-"), l2.astype("U3")), "-"),
            l3.astype("U4"))
    ).astype(object)


def _numbered_name(prefix: str, keys: np.ndarray) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(keys.astype("U9"), 9)).astype(object)


# ------------------------------------------------------------------ tables

BASE_ROWS = {
    "supplier": 10_000,
    "part": 200_000,
    "partsupp": 800_000,
    "customer": 150_000,
    "orders": 1_500_000,
    "region": 5,
    "nation": 25,
}


class TpchGenerator:
    """Generate any column for any row range of any TPC-H table at scale
    factor ``sf`` (floats allowed: tiny = 0.01, matching the reference's
    ``tiny`` schema row counts)."""

    def __init__(self, sf: float = 1.0):
        self.sf = sf
        self._streams: Dict[str, Stream] = {}
        self._line_counts: Optional[np.ndarray] = None

    def _s(self, name: str, usage: int = 8) -> Stream:
        if name not in self._streams:
            self._streams[name] = Stream(name, usage)
        return self._streams[name]

    def scale(self, base: int) -> int:
        return max(1, int(round(base * self.sf)))

    def num_rows(self, table: str) -> int:
        if table == "lineitem":
            return int(self.line_counts().sum())
        if table in ("region", "nation"):
            return BASE_ROWS[table]
        return self.scale(BASE_ROWS[table])

    # ---- orders/lineitem correlation

    def line_counts(self) -> np.ndarray:
        if self._line_counts is None:
            n = self.scale(BASE_ROWS["orders"])
            self._line_counts = self._s("order.lines").ints(0, n, 1, 7).astype(np.int8)
        return self._line_counts

    def line_offsets(self) -> np.ndarray:
        counts = self.line_counts().astype(np.int64)
        off = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        return off

    # ---- public API

    def column(self, table: str, column: str, start: int = 0,
               stop: Optional[int] = None) -> np.ndarray:
        n_total = self.num_rows(table)
        stop = n_total if stop is None else min(stop, n_total)
        n = stop - start
        suffix = column.split("_", 1)[1]
        fn = getattr(self, f"_{table}_{suffix}", None)
        if fn is None:
            raise KeyError(f"{table}.{column}")
        return fn(start, n)

    # ---- part

    def _part_partkey(self, start, n):
        return np.arange(start + 1, start + n + 1, dtype=np.int64)

    def _part_name(self, start, n):
        st = self._s("part.name")
        ncolors = len(W.COLORS)
        picks = np.empty((n, 5), dtype=np.int64)
        for k in range(5):
            raw = st.ints(start, n, 0, ncolors - 1 - k, k)
            prior = np.sort(picks[:, :k], axis=1)
            for j in range(k):
                raw = raw + (raw >= prior[:, j])
            picks[:, k] = raw
        colors = np.array(W.COLORS)
        out = colors[picks[:, 0]]
        for k in range(1, 5):
            out = np.char.add(np.char.add(out, " "), colors[picks[:, k]])
        return out.astype(object)

    def _part_mfgr(self, start, n):
        m = self._s("part.mfgr").ints(start, n, 1, 5)
        return np.char.add("Manufacturer#", m.astype("U1")).astype(object)

    def _part_brand(self, start, n):
        m = self._s("part.mfgr").ints(start, n, 1, 5)
        b = self._s("part.brand").ints(start, n, 1, 5)
        return np.char.add("Brand#", (m * 10 + b).astype("U2")).astype(object)

    def _part_type(self, start, n):
        t = self._s("part.type").ints(start, n, 0, 149)
        t1 = np.array(W.TYPES_1)[t // 25]
        t2 = np.array(W.TYPES_2)[(t // 5) % 5]
        t3 = np.array(W.TYPES_3)[t % 5]
        return np.char.add(np.char.add(np.char.add(np.char.add(t1, " "), t2), " "),
                           t3).astype(object)

    def _part_size(self, start, n):
        return self._s("part.size").ints(start, n, 1, 50)

    def _part_container(self, start, n):
        c = self._s("part.container").ints(start, n, 0, 39)
        c1 = np.array(W.CONTAINERS_1)[c // 8]
        c2 = np.array(W.CONTAINERS_2)[c % 8]
        return np.char.add(np.char.add(c1, " "), c2).astype(object)

    def _part_retailprice(self, start, n):
        pk = np.arange(start + 1, start + n + 1, dtype=np.int64)
        return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)  # cents

    def _part_comment(self, start, n):
        return _text_column(self._s("part.comment"), start, n, 5, 22)

    # ---- supplier

    def _supplier_suppkey(self, start, n):
        return np.arange(start + 1, start + n + 1, dtype=np.int64)

    def _supplier_name(self, start, n):
        return _numbered_name("Supplier#", self._supplier_suppkey(start, n))

    def _supplier_address(self, start, n):
        return _vstring_column(self._s("supplier.address", usage=16), start, n, 10, 40)

    def _supplier_nationkey(self, start, n):
        return self._s("supplier.nationkey").ints(start, n, 0, 24)

    def _supplier_phone(self, start, n):
        return _phone_column(self._s("supplier.phone"),
                             self._supplier_nationkey(start, n), start, n)

    def _supplier_acctbal(self, start, n):
        return self._s("supplier.acctbal").ints(start, n, -99999, 999999)

    def _supplier_comment(self, start, n):
        out = _text_column(self._s("supplier.comment"), start, n, 25, 100)
        # spec: 5 rows per SF contain Customer...Complaints, 5 Recommends
        total = self.num_rows("supplier")
        planted = max(1, int(round(5 * self.sf)))
        bad = np.unique(self._s("supplier.bmc").ints(0, planted, 0, total - 1))
        good = np.unique(self._s("supplier.gmc").ints(0, planted, 0, total - 1))
        for rows, phrase in ((bad, "Customer Complaints"), (good, "Customer Recommends")):
            for r in rows:
                if start <= r < start + n:
                    s = out[r - start]
                    mid = len(s) // 2
                    out[r - start] = s[:mid] + phrase + s[mid:]
        return out

    # ---- customer

    def _customer_custkey(self, start, n):
        return np.arange(start + 1, start + n + 1, dtype=np.int64)

    def _customer_name(self, start, n):
        return _numbered_name("Customer#", self._customer_custkey(start, n))

    def _customer_address(self, start, n):
        return _vstring_column(self._s("customer.address", usage=16), start, n, 10, 40)

    def _customer_nationkey(self, start, n):
        return self._s("customer.nationkey").ints(start, n, 0, 24)

    def _customer_phone(self, start, n):
        return _phone_column(self._s("customer.phone"),
                             self._customer_nationkey(start, n), start, n)

    def _customer_acctbal(self, start, n):
        return self._s("customer.acctbal").ints(start, n, -99999, 999999)

    def _customer_mktsegment(self, start, n):
        s = self._s("customer.mktsegment").ints(start, n, 0, 4)
        return np.array(W.SEGMENTS, dtype=object)[s]

    def _customer_comment(self, start, n):
        return _text_column(self._s("customer.comment"), start, n, 29, 116)

    # ---- orders

    @staticmethod
    def sparse_orderkey(i: np.ndarray) -> np.ndarray:
        """8 keys used out of every 32 (spec 4.2.3: sparse orderkeys)."""
        return (i // 8) * 32 + (i % 8) + 1

    def _orders_orderkey(self, start, n):
        i = np.arange(start, start + n, dtype=np.int64)
        return self.sparse_orderkey(i)

    def _orders_custkey(self, start, n):
        cmax = self.num_rows("customer")
        c = self._s("orders.custkey").ints(start, n, 1, cmax)
        # customer mortality: skip custkeys divisible by 3 (spec 4.2.3)
        c = np.where(c % 3 == 0, np.where(c + 1 <= cmax, c + 1, c - 1), c)
        return c

    def _orders_orderdate(self, start, n):
        d = self._s("orders.orderdate").ints(start, n, 0, ORDER_DATE_SPAN - 1)
        return (START_DATE + d).astype(np.int32)

    def _orders_orderpriority(self, start, n):
        p = self._s("orders.orderpriority").ints(start, n, 0, 4)
        return np.array(W.PRIORITIES, dtype=object)[p]

    def _orders_clerk(self, start, n):
        c = self._s("orders.clerk").ints(start, n, 1, self.scale(1000))
        return _numbered_name("Clerk#", c)

    def _orders_shippriority(self, start, n):
        return np.zeros(n, dtype=np.int64)

    def _orders_comment(self, start, n):
        return _text_column(self._s("orders.comment"), start, n, 19, 78)

    def _orders_totalprice(self, start, n):
        return self._order_parts(start, n)[0]

    def _orders_orderstatus(self, start, n):
        return self._order_parts(start, n)[1]

    def _order_parts(self, start, n):
        """Derived O_TOTALPRICE / O_ORDERSTATUS from this order range's lines."""
        eps = self._line_matrix("extendedprice", start, n)
        disc = self._line_matrix("discount", start, n)
        tax = self._line_matrix("tax", start, n)
        counts = self.line_counts()[start:start + n].astype(np.int64)
        slot = np.arange(7)[None, :]
        live = slot < counts[:, None]
        # per-line: extprice*(1-disc)*(1+tax), rounded to cents at each step
        dp = (eps * (100 - disc) + 50) // 100
        chg = (dp * (100 + tax) + 50) // 100
        total = (chg * live).sum(axis=1)
        ship = self._line_matrix("shipdate", start, n)
        lstat_f = (ship <= CURRENT_DATE) & live
        nf = lstat_f.sum(axis=1)
        status = np.where(nf == counts, "F", np.where(nf == 0, "O", "P"))
        return total, status.astype(object)

    # ---- lineitem (generated per (order, slot) then compacted)

    def _line_matrix(self, col: str, ostart: int, on: int) -> np.ndarray:
        """(on, 7) matrix of per-slot values for orders [ostart, ostart+on).

        Stream exponent = order_index * 56 + slot * 8 + draw: translation-
        invariant, so any order chunk reproduces identical values."""
        st = self._s(f"lineitem.{col}", usage=56)
        if col == "partkey":
            pmax = self.num_rows("part")
            out = np.empty((on, 7), dtype=np.int64)
            for j in range(7):
                out[:, j] = st.ints(ostart, on, 1, pmax, k=j * 8)
            return out
        if col == "suppkey":
            pk = self._line_matrix("partkey", ostart, on)
            smax = self.num_rows("supplier")
            i = np.empty((on, 7), dtype=np.int64)
            for j in range(7):
                i[:, j] = st.ints(ostart, on, 0, 3, k=j * 8)
            return (pk + i * (smax // 4 + (pk - 1) // smax)) % smax + 1
        if col == "quantity":
            return self._slot_ints(st, ostart, on, 1, 50)
        if col == "extendedprice":
            pk = self._line_matrix("partkey", ostart, on)
            qty = self._line_matrix("quantity", ostart, on)
            retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
            return qty * retail
        if col == "discount":
            return self._slot_ints(st, ostart, on, 0, 10)
        if col == "tax":
            return self._slot_ints(st, ostart, on, 0, 8)
        if col == "shipdate":
            od = self._orders_orderdate(ostart, on).astype(np.int64)
            return od[:, None] + self._slot_ints(st, ostart, on, 1, 121)
        if col == "commitdate":
            od = self._orders_orderdate(ostart, on).astype(np.int64)
            return od[:, None] + self._slot_ints(st, ostart, on, 30, 90)
        if col == "receiptdate":
            ship = self._line_matrix("shipdate", ostart, on)
            return ship + self._slot_ints(st, ostart, on, 1, 30)
        raise KeyError(col)

    def _slot_ints(self, st: Stream, ostart: int, on: int, lo: int, hi: int):
        out = np.empty((on, 7), dtype=np.int64)
        for j in range(7):
            out[:, j] = st.ints(ostart, on, lo, hi, k=j * 8)
        return out

    def _line_order_range(self, start: int, stop: int):
        """Map a lineitem row range to the covering order range."""
        off = self.line_offsets()
        o0 = int(np.searchsorted(off, start, side="right") - 1)
        o1 = int(np.searchsorted(off, stop, side="left"))
        return o0, max(o1, o0 + 1), off

    def _line_flat(self, col: str, start: int, n: int) -> np.ndarray:
        o0, o1, off = self._line_order_range(start, start + n)
        counts = self.line_counts()[o0:o1].astype(np.int64)
        live = np.arange(7)[None, :] < counts[:, None]
        if col == "orderkey":
            i = np.arange(o0, o1, dtype=np.int64)
            mat = np.broadcast_to(self.sparse_orderkey(i)[:, None], (o1 - o0, 7))
        elif col == "linenumber":
            mat = np.broadcast_to(np.arange(1, 8, dtype=np.int64)[None, :],
                                  (o1 - o0, 7))
        else:
            mat = self._line_matrix(col, o0, o1 - o0)
        flat = mat[live]
        lo = start - off[o0]
        return flat[lo:lo + n]

    def _lineitem_orderkey(self, start, n):
        return self._line_flat("orderkey", start, n)

    def _lineitem_partkey(self, start, n):
        return self._line_flat("partkey", start, n)

    def _lineitem_suppkey(self, start, n):
        return self._line_flat("suppkey", start, n)

    def _lineitem_linenumber(self, start, n):
        return self._line_flat("linenumber", start, n)

    def _lineitem_quantity(self, start, n):
        return self._line_flat("quantity", start, n) * 100  # decimal(12,2)

    def _lineitem_extendedprice(self, start, n):
        return self._line_flat("extendedprice", start, n)

    def _lineitem_discount(self, start, n):
        return self._line_flat("discount", start, n)  # cents, 0.00-0.10

    def _lineitem_tax(self, start, n):
        return self._line_flat("tax", start, n)

    def _lineitem_shipdate(self, start, n):
        return self._line_flat("shipdate", start, n).astype(np.int32)

    def _lineitem_commitdate(self, start, n):
        return self._line_flat("commitdate", start, n).astype(np.int32)

    def _lineitem_receiptdate(self, start, n):
        return self._line_flat("receiptdate", start, n).astype(np.int32)

    def _lineitem_returnflag(self, start, n):
        receipt = self._line_flat("receiptdate", start, n)
        ra = self._s("lineitem.returnflag").ints(start, n, 0, 1)
        return np.where(receipt <= CURRENT_DATE,
                        np.where(ra == 0, "R", "A"), "N").astype(object)

    def _lineitem_linestatus(self, start, n):
        ship = self._line_flat("shipdate", start, n)
        return np.where(ship > CURRENT_DATE, "O", "F").astype(object)

    def _lineitem_shipinstruct(self, start, n):
        s = self._s("lineitem.shipinstruct").ints(start, n, 0, 3)
        return np.array(W.INSTRUCTIONS, dtype=object)[s]

    def _lineitem_shipmode(self, start, n):
        s = self._s("lineitem.shipmode").ints(start, n, 0, 6)
        return np.array(W.MODES, dtype=object)[s]

    def _lineitem_comment(self, start, n):
        return _text_column(self._s("lineitem.comment"), start, n, 10, 43)

    # ---- partsupp (4 suppliers per part)

    def _partsupp_partkey(self, start, n):
        i = np.arange(start, start + n, dtype=np.int64)
        return i // 4 + 1

    def _partsupp_suppkey(self, start, n):
        i = np.arange(start, start + n, dtype=np.int64)
        pk = i // 4 + 1
        j = i % 4
        smax = self.num_rows("supplier")
        return (pk + j * (smax // 4 + (pk - 1) // smax)) % smax + 1

    def _partsupp_availqty(self, start, n):
        return self._s("partsupp.availqty").ints(start, n, 1, 9999)

    def _partsupp_supplycost(self, start, n):
        return self._s("partsupp.supplycost").ints(start, n, 100, 100000)

    def _partsupp_comment(self, start, n):
        return _text_column(self._s("partsupp.comment"), start, n, 49, 198)

    # ---- nation / region

    def _nation_nationkey(self, start, n):
        return np.arange(start, start + n, dtype=np.int64)

    def _nation_name(self, start, n):
        return np.array([nm for nm, _ in W.NATIONS], dtype=object)[start:start + n]

    def _nation_regionkey(self, start, n):
        return np.array([r for _, r in W.NATIONS], dtype=np.int64)[start:start + n]

    def _nation_comment(self, start, n):
        return _text_column(self._s("nation.comment"), start, n, 31, 114)

    def _region_regionkey(self, start, n):
        return np.arange(start, start + n, dtype=np.int64)

    def _region_name(self, start, n):
        return np.array(W.REGIONS, dtype=object)[start:start + n]

    def _region_comment(self, start, n):
        return _text_column(self._s("region.comment"), start, n, 31, 115)
