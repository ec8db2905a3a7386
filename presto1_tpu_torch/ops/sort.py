"""ORDER BY / TopN / LIMIT.

The reference sorts via PagesIndex + a bytecode-compiled comparator
quicksort (``operator/PagesIndexOrdering.java:37``, adapted from fastutil).
Here every sort key is transformed into a monotone word and the batch is
ordered by one multi-key sort of a row permutation
(``common.sort_permutation``);
every column -- nested ones included -- then moves through the permutation
in one call of the gather kernel.  Comparator logic disappears: DESC is
negation, null ordering is a sentinel, row liveness is a leading key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..batch import Column, RecordBatch
from .common import iota, sort_permutation


@dataclass
class SortKey:
    column: Column  # evaluated key
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Trino default (last if asc)


def _sortable(key: SortKey, n: int):
    c = key.column
    data = c.data
    if data.dtype.is_floating_point:
        word = data.to(torch.float64)
        big = np.inf
    else:
        word = data.to(torch.int64)
        big = int(np.iinfo(np.int64).max // 2)
    nulls_first = (not key.ascending) if key.nulls_first is None \
        else key.nulls_first
    if c.validity is not None:
        null_word = -big if (nulls_first == key.ascending) else big
        word = torch.where(c.validity, word, torch.full(
            (), null_word, dtype=word.dtype, device=word.device))
    if not key.ascending:
        word = -word
    return word


def sort_batch(batch: RecordBatch, keys: List[SortKey],
               limit: Optional[int] = None) -> RecordBatch:
    n = batch.capacity()
    device = next(iter(batch.columns.values())).data.device
    dead = (iota(n, device) >= batch.num_rows).to(torch.int8)
    key_ops = [dead] + [_sortable(k, n) for k in keys]
    res = batch.gather(sort_permutation(key_ops), batch.num_rows)
    if limit is not None:
        res = limit_batch(res, limit)
    return res


def limit_batch(batch: RecordBatch, limit: int) -> RecordBatch:
    """First ``limit`` rows."""
    cap = min(limit, batch.capacity())
    cols = {
        name: c.with_data(c.data[:cap],
                          c.validity[:cap] if c.validity is not None else None)
        for name, c in batch.columns.items()
    }
    nr = batch.num_rows
    nr = min(nr, limit) if isinstance(nr, int) else torch.clamp(nr, max=limit)
    return RecordBatch(cols, nr)
