"""The plain-PyTorch arithmetic of the TPC-DS references, on the CPU.

Columns come in as ``torch.from_numpy`` of the host columns; decimals stay
unscaled int64.  NumPy serves only to find a string's code in a column's
sorted dictionary and to decode codes back to strings.
"""

from __future__ import annotations

import numpy as np
import torch


def col(c) -> torch.Tensor:
    """A host column's values as an int64 tensor (strings: their codes)."""
    return torch.from_numpy(np.ascontiguousarray(c.data)).to(torch.int64)


def valid(c) -> torch.Tensor:
    """Where a host column is not NULL."""
    return torch.from_numpy(np.ascontiguousarray(c.valid()))


def code(c, value: str) -> int:
    """The code of ``value`` in a string column's sorted dictionary, -1
    where the column never holds it."""
    i = int(np.searchsorted(c.dictionary, value))
    return i if i < len(c.dictionary) and c.dictionary[i] == value else -1


def decode(c, codes: torch.Tensor) -> list:
    return [str(s) for s in c.dictionary[codes.numpy()]]


def lookup(keys: torch.Tensor, at: torch.Tensor, at_valid: torch.Tensor):
    """For each entry of ``at``, the row of ``keys`` (unique) that holds
    it, and whether one does; a NULL (``at_valid`` false) matches no row,
    as an equi-join's NULL key matches none."""
    order = torch.argsort(keys)
    ks = keys[order]
    pos = torch.searchsorted(ks, at).clamp(max=max(len(ks) - 1, 0))
    hit = (ks[pos] == at) & at_valid if len(ks) else torch.zeros_like(
        at_valid)
    return order[pos], hit


def group_sums(key: torch.Tensor, values: list):
    """(distinct keys ascending, each value's sum per key, counts), in
    int64 for whole numbers and float for floats."""
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = [torch.zeros(len(uniq), dtype=v.dtype).index_add_(0, inv, v)
            for v in values]
    counts = torch.bincount(inv, minlength=len(uniq))
    return uniq, sums, counts

