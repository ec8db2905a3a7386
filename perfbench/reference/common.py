"""Shared arithmetic of the references and the comparison that decides
``correct``."""

from __future__ import annotations

import datetime
import math
from typing import List, Sequence

import numpy as np

EPOCH = np.datetime64("1970-01-01", "D")


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int((np.datetime64(iso, "D") - EPOCH).astype(np.int64))


def iso(days: int) -> str:
    return str(EPOCH + np.timedelta64(int(days), "D"))


def lookup(keys, values, at, valid=None):
    """``values[k]`` for each k in ``at`` where ``keys`` (unique) holds k,
    and a mask of where it does (and ``valid`` is true)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    pos = np.clip(np.searchsorted(ks, at), 0, max(len(ks) - 1, 0))
    hit = (ks[pos] == at) if len(ks) else np.zeros(len(at), bool)
    if valid is not None:
        hit = hit & valid
    return values[order][pos], hit


def group_sums(keys: np.ndarray, values: Sequence[np.ndarray]):
    """(distinct keys ascending, each value's sum per key, counts): exact
    for integer values (sorted segments, ``np.add.reduceat``)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    uniq, starts = np.unique(ks, return_index=True)
    sums = [np.add.reduceat(v[order], starts) if len(uniq) else v[:0]
            for v in values]
    counts = np.diff(np.append(starts, len(ks)))
    return uniq, sums, counts


def dec(unscaled, scale: int, lower: bool):
    """A decimal column's values: unscaled int64 exactly, or (``lower``)
    float64 numbers."""
    if lower:
        return np.asarray(unscaled, np.float64) / 10 ** scale
    return np.asarray(unscaled, np.int64)


def one(scale: int, lower: bool):
    """The number 1 at a decimal scale."""
    return 1.0 if lower else 10 ** scale


def dec_out(value, scale: int, lower: bool):
    """A decimal result as the program's answer rows carry it: the
    unscaled value as a float64 over 10^scale (beyond 2^53, as Q1's
    sum_charge at scale 6 is at SF 1, the float holds the unscaled value
    to its nearest double, on both sides alike)."""
    if value is None:
        return None
    if lower:
        return float(value)
    return float(np.float64(np.int64(value)) / np.float64(10 ** scale))


def avg_out(total, count: int, scale: int, lower: bool):
    """avg() of a column as a double: the sum over count x 10^scale, or
    (``lower``) in float32."""
    if count == 0:
        return None
    if lower:
        return float(np.float32(total) / np.float32(count))
    return float(total) / (count * 10 ** scale)


def limited(order: np.ndarray, keys: List[np.ndarray], limit) -> np.ndarray:
    """The rows ``order`` puts first, ``limit`` of them, and after them
    every row that ties with the last on ``keys``: ORDER BY ... LIMIT may
    return any of the tied rows."""
    if limit is None or len(order) <= limit:
        return order
    last = order[limit - 1]
    tail = order[limit:]
    same = np.ones(len(tail), bool)
    for k in keys:
        same &= k[tail] == k[last]
    stop = limit + (int(np.argmin(same)) if not same.all() else len(tail))
    return order[:stop]


def normal(v):
    """An answer value as a plain Python value: None, int, float, str, or a
    date as days since 1970-01-01."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (str, np.str_)):
        return str(v)
    if isinstance(v, np.datetime64):
        return int((v.astype("datetime64[D]") - EPOCH).astype(np.int64))
    if isinstance(v, datetime.datetime):
        raise TypeError(f"unexpected timestamp {v!r} in an answer")
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    raise TypeError(f"unexpected {type(v).__name__} in an answer")


def _rel(got, want) -> float:
    """Relative error of a double; 1 (all of it) where one side is NULL or
    NaN and the other is not."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else 1.0
    if got == want:
        return 0.0
    if math.isnan(got) or math.isnan(want):
        return 1.0
    return min(abs(got - want) / max(abs(want), 1e-300), 1.0)


def judge(got: list, want: list, output: Sequence[str],
          order_key: Sequence[int], limit) -> tuple:
    """Compare one answer with the reference's.

    ``want`` holds the reference's rows in order, the rows tied with its
    last on ``order_key`` included (``limited``).  Returns (exact, worst):
    ``exact`` is whether the row count, every exact value and the order of
    the ORDER BY key agree, ``worst`` the largest relative error of a
    double, each row held against the reference's row with the same exact
    values (or, where there is none, the one in its place).  Rows that tie
    on the key may come in any order, and at the LIMIT any of the tied
    rows may come."""
    got = [tuple(normal(v) for v in row) for row in got]
    n = len(want) if limit is None else min(limit, len(want))
    if len(got) != n or any(len(r) != len(output) for r in got):
        return False, 0.0
    exact_cols = [j for j, k in enumerate(output) if k == "exact"]
    double_cols = [j for j, k in enumerate(output) if k == "double"]

    def key(r):
        return tuple(r[j] for j in order_key)

    def exact(r):
        return tuple(r[j] for j in exact_cols)

    ok, worst, i = True, 0.0, 0
    while i < n:
        k = key(want[i])
        j = i
        while j < n and key(want[j]) == k:
            j += 1
        pool = [w for w in want[i:] if key(w) == k]
        for pos in range(i, j):
            g = got[pos]
            hit = next((w for w in pool if key(g) == k
                        and exact(w) == exact(g)), None)
            if hit is None:
                ok, hit = False, want[pos]
            else:
                pool.remove(hit)
            for c in double_cols:
                worst = max(worst, _rel(g[c], hit[c]))
        i = j
    return ok, worst
