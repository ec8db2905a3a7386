"""K-way merge of per-task sorted outputs (distributed sort consumer).

The reference merges the sorted pages of N remote tasks with a streaming
binary merge tree (``operator/MergeOperator.java:44,177``,
``util/MergeSortedPages.java``; ``docs/.../admin/dist-sort.rst:1-17``):
each task sorts its partition, the coordinator only merges.  Here the
merge is vectorized instead of streamed: every sort key is normalised to
the SAME monotone word ``ops/sort._sortable`` uses (so merge order is
exactly per-task sort order), the words pack into one fixed-width
big-endian byte composite that compares with memcmp, and runs merge
pairwise with two ``np.searchsorted`` calls per pair -- O(n log k)
comparisons, never a re-sort of the full output.  The merge runs on the
host, where the pages of the tasks arrive (``exec/pages.py``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..batch import Column, RecordBatch
from .pages import _np, _tensor, _to_device, concat_batches

_SIGN = np.uint64(1) << np.uint64(63)


def _sortable_words(batch: RecordBatch, keys) -> List[np.ndarray]:
    """Evaluate each (expr, asc, nulls_first) key over a HOST batch into a
    uint64 word whose unsigned order equals the engine's sort order
    (mirrors ``ops/sort._sortable``: same null sentinels, DESC by
    negation, floats in IEEE total order)."""
    from ..expr import ir
    from ..expr.eval import bind_string_ops, eval_expr

    n = batch.num_rows
    dicts = {nm: c.dictionary for nm, c in batch.columns.items()
             if c.dictionary is not None}
    out = []
    for e, asc, nulls_first in keys:
        if isinstance(e, ir.ColumnRef):
            c = batch[e.name]
        else:
            c = eval_expr(bind_string_ops(e, dicts), batch)
        data = _np(c.data)[:n]
        if data.dtype.kind == "f":
            word = data.astype(np.float64)
            big = np.float64(np.inf)
        else:
            word = data.astype(np.int64)
            big = np.int64(np.iinfo(np.int64).max // 2)
        nf = (not asc) if nulls_first is None else nulls_first
        if c.validity is not None:
            null_word = -big if (nf == asc) else big
            word = np.where(_np(c.validity)[:n], word, null_word)
        if not asc:
            word = -word
        if word.dtype.kind == "f":
            u = word.view(np.uint64)
            mask = np.where(u >> np.uint64(63) == 1,
                            np.uint64(0xFFFFFFFFFFFFFFFF), _SIGN)
            out.append(u ^ mask)
        else:
            out.append(word.view(np.uint64) ^ _SIGN)
    return out


def _composite(words: List[np.ndarray]) -> np.ndarray:
    """uint64 word list -> one S(8k) big-endian byte key per row; numpy
    S-dtype comparison is memcmp, so byte order == word-list order."""
    k = len(words)
    stacked = np.stack(words, axis=1).astype(">u8")
    return np.ascontiguousarray(stacked).view(f"S{8 * k}").ravel()


def _merge_two(ka: np.ndarray, ia: np.ndarray,
               kb: np.ndarray, ib: np.ndarray):
    """Merge two sorted (keys, row-index) runs: positions via two
    searchsorted calls (ties: all A rows before all B rows)."""
    pos_b = np.searchsorted(ka, kb, side="right") + np.arange(len(kb))
    pos_a = np.searchsorted(kb, ka, side="left") + np.arange(len(ka))
    nk = np.empty(len(ka) + len(kb), dtype=ka.dtype)
    ni = np.empty(len(ia) + len(ib), dtype=ia.dtype)
    nk[pos_a] = ka
    nk[pos_b] = kb
    ni[pos_a] = ia
    ni[pos_b] = ib
    return nk, ni


def merge_sorted_batches(task_batches, keys,
                         device="cuda") -> Optional[RecordBatch]:
    """Per-task sorted batches -> one globally ordered batch, placed on
    ``device`` (padded to ``round_capacity``), or left on the host when
    ``device`` is None.

    Dictionary codes are first re-encoded against the union dictionary by
    ``concat_batches`` (order-preserving: both dictionaries are sorted),
    so string keys merge as plain code comparisons."""
    task_batches = [b for b in task_batches if b is not None]
    if not task_batches:
        return None
    merged = concat_batches(task_batches)
    if len(task_batches) == 1 or not keys:
        return _to_device(merged, device) if device is not None else merged
    comp = _composite(_sortable_words(merged, keys))
    runs = []
    off = 0
    for b in task_batches:
        n = int(b.num_rows)
        runs.append((comp[off:off + n],
                     np.arange(off, off + n, dtype=np.int64)))
        off += n
    while len(runs) > 1:  # balanced binary merge tree
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_merge_two(*runs[i], *runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    perm = runs[0][1]
    n = int(merged.num_rows)

    def permuted(t):
        return None if t is None else _tensor(_np(t)[:n][perm])

    cols = {name: Column(permuted(c.data), c.type,
                         validity=permuted(c.validity),
                         dictionary=c.dictionary,
                         lengths=permuted(c.lengths),
                         map_values=permuted(c.map_values))
            for name, c in merged.columns.items()}
    out = RecordBatch(cols, n)
    return _to_device(out, device) if device is not None else out
