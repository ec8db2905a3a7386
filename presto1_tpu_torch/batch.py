"""Columnar data model: the device-side replacement for Trino Page/Block.

A :class:`Column` is a fixed-width device tensor plus an optional validity
mask; strings are dictionary-encoded (int32 codes into a host-side sorted
dictionary, so code order == string order and range predicates work directly
on codes).  A :class:`RecordBatch` is an ordered dict of columns with a
row count.

Reference parity notes:
* ``spi/Page.java:18`` (Block[] + positionCount)  -> RecordBatch
* ``spi/block/LongArrayBlock.java`` etc.          -> plain device tensors
* ``spi/block/DictionaryBlock.java``              -> Column.dictionary
* ``spi/block/LazyBlock.java``                    -> lazy column loading is
  handled one level up, in the table scan (exec/catalog.py), which only
  materialises referenced columns.

Operators whose output cardinality is data-dependent (filter, join) compute
into padded capacity buffers plus a device count, and the executor
re-bucketizes (`round_capacity`) between operators so a compiled query's
shapes are static after discovery.  ``num_rows`` is a Python int in eager
execution and may be a 0-d device tensor inside a compiled fragment; nothing
in this module forces it to the host.

Every constructor that places data takes an explicit ``device``
(default ``"cuda"``); nothing here looks for a GPU and carries on without.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from .trace import enter, host_read
from .types import SqlType


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _host(t) -> np.ndarray:
    """Device tensor -> host numpy (the only readback in this module)."""
    return host_read(t, _numpy)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy array -> contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
    np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(t: SqlType) -> torch.dtype:
    """The tensor dtype that stores values of SQL type ``t``."""
    return _TORCH_DTYPES[np.dtype(t.np_dtype)]


def _gather(sources, indices: torch.Tensor):
    """Every tensor of ``sources`` at ``indices`` along axis 0, clamped,
    through the gather kernel (``ops/kernels/gather.py``): one launch for
    all of them on a CUDA device."""
    # imported here: the ops package imports this module
    from .ops.kernels.gather import gather_rows

    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    return gather_rows([s.contiguous() for s in sources],
                       indices.contiguous())


def take_clamped(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``data[indices]`` along axis 0 with out-of-range indices clamped to
    the ends (CUDA indexing does not clamp; the engine's padded index
    vectors rely on it)."""
    return _gather([data], indices)[0]


def round_capacity(n: int) -> int:
    """Bucket a row count to limit distinct compiled shapes.

    Powers of two above 1024, multiples of 128 below; minimum 128.
    """
    if n <= 128:
        return 128
    if n <= 1024:
        return ((n + 127) // 128) * 128
    p = 1
    while p < n:
        p <<= 1
    # allow 1.5x steps between powers of two to limit over-padding
    if p // 2 + p // 4 >= n and p > 2048:
        return p // 2 + p // 4
    return p


@dataclass
class Column:
    """One column: device data + optional validity + host dictionary."""

    data: torch.Tensor
    type: SqlType
    validity: Optional[torch.Tensor] = None  # bool, True = non-null
    dictionary: Optional[np.ndarray] = None  # sorted np array of str (varchar only)
    # nested types (array/map): data is a [n, W] padded element matrix,
    # lengths the per-row element count, map_values the aligned value
    # matrix for maps (the ArrayBlock/MapBlock analog with pad+length
    # instead of offsets -- static shapes)
    lengths: Optional[torch.Tensor] = None   # int32 [n]
    map_values: Optional[torch.Tensor] = None  # [n, W] (maps only)

    @property
    def is_nested(self) -> bool:
        return self.lengths is not None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def with_data(self, data, validity="keep") -> "Column":
        if isinstance(validity, str) and validity == "keep":
            validity = self.validity
        return replace(self, data=data, validity=validity)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "Column":
        """Column at ``indices`` (clamped); rows where ``valid`` is False
        become NULL."""
        return gather_columns({"c": self}, indices, valid)["c"]

    def decode(self, n: Optional[int] = None) -> np.ndarray:
        """Materialise to host numpy values (strings decoded, nulls -> object None)."""
        n = len(self) if n is None else n
        data = _host(self.data[:n])
        if self.lengths is not None:
            lens = _host(self.lengths[:n])
            dic = self.dictionary
            out = np.empty(n, dtype=object)
            if self.type.kind == "map":
                vdata = _host(self.map_values[:n])
                for i in range(n):
                    k = _flat_values(data[i, :lens[i]], self.type.key, dic)
                    v = _flat_values(vdata[i, :lens[i]], self.type.value, dic)
                    out[i] = dict(zip(k.tolist(), v.tolist()))
            else:
                for i in range(n):
                    out[i] = _flat_values(data[i, :lens[i]],
                                          self.type.element, dic).tolist()
        else:
            out = _flat_values(data, self.type, self.dictionary)
        if self.validity is not None:
            mask = _host(self.validity[:n])
            out = np.asarray(out, dtype=object)
            out[~mask] = None
        return out


def _flat_values(data: np.ndarray, t: SqlType, dictionary) -> np.ndarray:
    """Host values of a column of type ``t`` (no lengths) from its data on
    the host, nulls not applied."""
    n = len(data)
    if t.is_string:
        assert dictionary is not None
        codes = np.clip(data, 0, len(dictionary) - 1) \
            if len(dictionary) else data
        out = dictionary[codes] if len(dictionary) \
            else np.array([""] * n, dtype=object)
        if t.kind == "varbinary":
            # physical latin-1 image -> real bytes at the boundary
            out = np.array([s.encode("latin-1") for s in out],
                           dtype=object)
    elif t.kind == "decimal":
        out = data / (10 ** t.scale)  # type: ignore[attr-defined]
    elif t.kind == "date":
        out = np.array(["1970-01-01"], dtype="datetime64[D]")[0] + data
    elif t.kind == "timestamp":
        out = (np.array(["1970-01-01"], dtype="datetime64[us]")[0]
               + data.astype("timedelta64[us]"))
    elif t.kind == "timestamptz":
        # render the civil time in the column's zone + offset suffix
        off_min = t.offset_minutes
        local = (np.array(["1970-01-01"], dtype="datetime64[us]")[0]
                 + (data + t.offset_micros).astype("timedelta64[us]"))
        sign = "+" if off_min >= 0 else "-"
        suffix = f" {sign}{abs(off_min) // 60:02d}:{abs(off_min) % 60:02d}"
        out = np.array(
            [str(v).replace("T", " ") + suffix for v in local],
            dtype=object)
    elif t.kind == "interval_ds":
        # render like the reference's SqlIntervalDayTime: 'D HH:MM:SS.mmm'
        def _ds(us):
            sign = "-" if us < 0 else ""
            us = abs(int(us))
            d, rem = divmod(us, 86_400_000_000)
            h, rem = divmod(rem, 3_600_000_000)
            m, rem = divmod(rem, 60_000_000)
            s, rem = divmod(rem, 1_000_000)
            return f"{sign}{d} {h:02d}:{m:02d}:{s:02d}.{rem // 1000:03d}"

        out = np.array([_ds(v) for v in data], dtype=object)
    elif t.kind == "interval_ym":
        def _ym(months):
            sign = "-" if months < 0 else ""
            y, m = divmod(abs(int(months)), 12)
            return f"{sign}{y}-{m}"

        out = np.array([_ym(v) for v in data], dtype=object)
    else:
        out = data
    return out


# id(dictionary) -> (a weak reference to it, {nullable: (values, made)}):
# each string dictionary's entries as ``to_pylist`` gives them, made when a
# code first asks for them and dropped with the dictionary (dictionaries
# are never written in place; a compiled statement returns the same ones
# on every call).  Keyed by the dictionary, so shared by every engine of
# the process; ``_DICTIONARY_LOCK`` guards its look-ups and fills.
_DICTIONARY_VALUES: Dict[int, tuple] = {}
_DICTIONARY_LOCK = threading.Lock()


def _forget_dictionary(key: int, ref) -> None:
    entry = _DICTIONARY_VALUES.get(key)
    if entry is not None and entry[0] is ref:
        _DICTIONARY_VALUES.pop(key, None)


def _string_values(dictionary, data: np.ndarray, nullable: bool):
    """``_flat_values`` of a VARCHAR / CHAR column as an object array
    whose elements are ``decode``'s: ``dictionary[codes]``'s own (``np.str_``
    of a 'U' dictionary) in a column without validity, their object cast
    (``str``) in a nullable one; no 'U' array of the rows is built."""
    assert dictionary is not None
    if not len(dictionary):
        return np.array([""] * len(data), dtype=object)
    codes = np.clip(data, 0, len(dictionary) - 1)
    key = id(dictionary)
    with _DICTIONARY_LOCK:
        entry = _DICTIONARY_VALUES.get(key)
        if entry is None or entry[0]() is not dictionary:
            ref = weakref.ref(dictionary,
                              lambda r, key=key: _forget_dictionary(key, r))
            entry = _DICTIONARY_VALUES[key] = (ref, {})
        form = entry[1].get(nullable)
        if form is None:
            form = entry[1][nullable] = (
                np.empty(len(dictionary), dtype=object),
                np.zeros(len(dictionary), dtype=bool))
        values, made = form
        missing = codes[~made[codes]]
        if missing.size:
            new = np.unique(missing)
            entries = dictionary[new]
            values[new] = (
                np.asarray(entries, dtype=object) if nullable else
                np.fromiter(entries, dtype=object, count=len(new)))
            made[new] = True
        return values[codes]


def _string_list(col: Column, n) -> list:
    """``list(col.decode(n))`` of a VARCHAR / CHAR column: the same
    elements and host reads, its values taken from ``_string_values``."""
    data = _host(col.data[:n])
    nullable = col.validity is not None
    out = _string_values(col.dictionary, data, nullable)
    if not nullable:
        return list(out)
    mask = _host(col.validity[:n])
    if not mask.all():
        out[~mask] = None
    return out.tolist()


@dataclass
class RecordBatch:
    """An ordered set of equal-length columns with a row count."""

    columns: Dict[str, Column]
    num_rows: int
    # the QueryTrace of the traced statement that returned this batch (an
    # instance attribute set by ``Engine.sql``; not a field)
    trace = None

    @property
    def names(self):
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def capacity(self) -> int:
        for c in self.columns.values():
            return len(c)
        return 0

    def select(self, names) -> "RecordBatch":
        return RecordBatch({n: self.columns[n] for n in names}, self.num_rows)

    def gather(self, indices: torch.Tensor, num_rows: int,
               valid: Optional[torch.Tensor] = None) -> "RecordBatch":
        return RecordBatch(gather_columns(self.columns, indices, valid),
                           num_rows)

    def to_pylist(self):
        """The first ``num_rows`` rows as tuples, in column order.

        Elements are those of ``Column.decode``: a column without validity
        gives numpy scalars (``np.int64``, ``np.float64`` for a DECIMAL,
        ``np.str_``, ``np.datetime64``, ...), a nullable column the Python
        objects of an object cast (``int``, ``float``, ``str``,
        ``datetime.date``, ...), NULL is ``None``; nested, ``timestamptz``,
        interval and ``varbinary`` columns give the Python objects
        ``decode`` builds.  Each column becomes one list (a VARCHAR / CHAR
        column through ``_string_list``, any other through ``decode``) and
        the rows are zipped from the lists.  Traced, the ``to_host`` span's
        detail counts the rows, the columns and, as ``bulk``, the columns
        read through ``_string_list``."""
        n, cols = self.num_rows, list(self.columns.values())
        detail = None if self.trace is None else {
            "rows": n, "columns": len(cols), "bulk": 0}
        with enter(self.trace, "to_host", detail):
            lists = []
            for c in cols:
                if c.is_nested or c.type.kind not in ("varchar", "char"):
                    lists.append(list(c.decode(n)))
                    continue
                lists.append(_string_list(c, n))
                if detail is not None:
                    detail["bulk"] += 1
            if not lists:
                return [() for _ in range(n)]
            return list(zip(*lists))

    def to_pandas(self):
        import pandas as pd

        with enter(self.trace, "to_host"):
            return pd.DataFrame({n: c.decode(self.num_rows)
                                 for n, c in self.columns.items()})


def from_numpy(arrays: Dict[str, np.ndarray], types: Dict[str, SqlType],
               dictionaries: Optional[Dict[str, np.ndarray]] = None,
               device="cuda") -> RecordBatch:
    """Build a RecordBatch on ``device`` from host arrays (test/ingest
    helper)."""
    dictionaries = dictionaries or {}
    cols = {}
    n = None
    for name, arr in arrays.items():
        t = types[name]
        n = len(arr) if n is None else n
        if t.is_string and name not in dictionaries and arr.dtype.kind in ("U", "O", "S"):
            dictionary, codes = encode_dictionary(arr)
            cols[name] = Column(to_device(codes, device), t,
                                dictionary=dictionary)
        elif t.kind == "timestamp" and arr.dtype.kind == "M":
            micros = arr.astype("datetime64[us]").astype(np.int64)
            cols[name] = Column(to_device(micros, device), t)
        elif t.kind == "date" and arr.dtype.kind == "M":
            days = arr.astype("datetime64[D]").astype(np.int32)
            cols[name] = Column(to_device(days, device), t)
        else:
            cols[name] = Column(
                to_device(arr.astype(t.np_dtype, copy=False), device), t,
                dictionary=dictionaries.get(name),
            )
    return RecordBatch(cols, n or 0)


def hash_strings_host(strings) -> "np.ndarray":
    """Vectorized, width-independent uint64 hash of a numpy 'U' array.

    numpy 'U' storage is fixed-width UTF-32, so ``view(uint32)`` exposes a
    [n, W] codepoint matrix (W = longest entry, zero-padded).  The hash is
    a positional polynomial Σ cp[i]·M^(i+1) ⊕ len·C — padding codepoints
    are zero and contribute nothing, so two hosts with different local
    dictionary widths produce identical hashes for equal values.  Replaces
    a per-entry Python md5 loop (hostile at SF100 dictionary sizes)."""
    import numpy as np

    d = np.asarray(strings, dtype="U")
    nd = len(d)
    if nd == 0:
        return np.zeros(0, np.uint64)
    w = max(d.dtype.itemsize // 4, 1)
    cps = np.frombuffer(d.tobytes(), dtype=np.uint32).reshape(
        nd, w).astype(np.uint64)
    m = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        powers = np.empty(w, np.uint64)
        acc = m
        for i in range(w):  # W is small (longest string), not dict size
            powers[i] = acc
            acc = acc * m
        h = (cps * powers[None, :]).sum(axis=1, dtype=np.uint64)
        lengths = (cps != 0).sum(axis=1).astype(np.uint64)
        h ^= lengths * np.uint64(0xFF51AFD7ED558CCD)
    return h



def encode_dictionary(values: np.ndarray):
    """Sort-dictionary-encode a host string array → (dictionary, int32 codes).

    The dictionary is sorted, so code comparisons implement string
    comparisons (reference DictionaryBlock gives no such ordering guarantee;
    we add it because every device-side string comparison rides on it).
    """
    dictionary, codes = np.unique(np.asarray(values), return_inverse=True)
    return dictionary, codes.astype(np.int32)


def merge_dictionaries(dicts, device):
    """Several string columns' dictionaries as one: (the sorted union of
    their entries, for each column the int32 table on ``device`` that maps
    its codes to the union's).  A column without entries (``None``, or a
    NULL column's empty dictionary) has no table: its codes are left as
    they are.  A Union's parts and the lanes of one array go through
    here."""
    dictionary = np.unique(np.concatenate(
        [d if d is not None and len(d) else np.empty(0, "U1")
         for d in dicts]))
    remaps = [None if d is None or not len(d) else
              to_device(np.searchsorted(dictionary, d).astype(np.int32),
                        device)
              for d in dicts]
    return dictionary, remaps


_PARTS = ("data", "validity", "lengths", "map_values")


def gather_columns(cols: Dict[str, Column], indices: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> Dict[str, Column]:
    """Gather many columns at the same (clamped) indices: data, validity
    and nested parts of every column go through the gather kernel together,
    in one launch; rows where ``valid`` is False become NULL."""
    slots = [(name, part) for name, c in cols.items() for part in _PARTS
             if getattr(c, part) is not None]
    moved = dict(zip(slots, _gather(
        [getattr(cols[name], part) for name, part in slots], indices)))
    out: Dict[str, Column] = {}
    for name, c in cols.items():
        parts = {part: moved[(name, part)] for part in _PARTS
                 if (name, part) in moved}
        if valid is not None:
            v = parts.get("validity")
            parts["validity"] = valid if v is None else (v & valid)
        out[name] = replace(c, **parts)
    return out


def device_counts(counts, device) -> torch.Tensor:
    """Row counts (Python ints or 0-d device tensors) as one int64 tensor
    on ``device``, made without a host sync."""
    return torch.stack([
        c.reshape(()).to(torch.int64) if isinstance(c, torch.Tensor)
        else torch.full((), int(c), dtype=torch.int64, device=device)
        for c in counts])


def concat_batches(a: "RecordBatch", b: "RecordBatch",
                   capacity: int) -> "RecordBatch":
    """Concatenate two batches with identical column sets: the rows of
    ``b`` follow the live rows of ``a`` (``concat_many`` of the two)."""
    return concat_many([a, b], capacity)


def concat_many(batches, capacity: int) -> "RecordBatch":
    """The live rows of every batch of ``batches`` (at most
    ``dyncopy.MAX_PARTS``, identical column sets, the first's order) one
    after the other in ``[capacity]``.  Every part of every column moves
    in the dynamic-copy kernel (``ops/kernels/dyncopy.py``; one launch),
    with the row counts on the device.  Nested ``[n, W]`` parts of
    different widths are padded with zeros to the widest; a validity mask
    that only some batches carry counts as all-valid on the others.  Rows
    past the total are zeros (the JAX package repeats the last batch's
    last row there; both are garbage by contract)."""
    from .ops.kernels.dyncopy import concat_rows

    batches = list(batches)
    first = batches[0]
    device = next(iter(first.columns.values())).data.device
    columns, slots = [], []
    for name in first.columns:
        cs = [b.columns[name] for b in batches]
        for part in _PARTS:
            ts = [getattr(c, part) for c in cs]
            if all(t is None for t in ts):
                continue
            columns.append([None if t is None else t.contiguous()
                            for t in ts])
            slots.append((name, part))
    moved = dict(zip(slots, concat_rows(
        columns, device_counts([b.num_rows for b in batches], device),
        capacity)))
    cols = {}
    for name, c in first.columns.items():
        parts = {part: moved.get((name, part)) for part in _PARTS}
        cols[name] = replace(c, **parts)
    total = first.num_rows
    for b in batches[1:]:
        total = total + b.num_rows
    return RecordBatch(cols, total)
