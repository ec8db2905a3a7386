"""Writable in-memory tables.

The analog of the reference's trino-memory plugin
(``plugin/trino-memory``, MemoryPagesStore): CREATE TABLE / INSERT targets
used heavily in tests, plus the blackhole-style sink.  Rows accumulate as
host numpy columns in their storage form -- unscaled int64 decimals, int32
days, int64 microseconds, int32 dictionary codes with the sorted dictionary
of the values present, a validity mask where a written value was NULL --
and device columns materialise lazily on the table's device and are
invalidated on a write (the same lazy-scan contract as the TPC-H catalog).

A decimal is carried as its unscaled integer from the source column to the
stored one (rescaled exactly when the scales differ), never through a
float64: the JAX package's ``MemoryTable.append`` stores
``round(float64(value) * 10**scale)``, which loses digits beyond 2**53
(ROADMAP C9).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..batch import Column, RecordBatch, encode_dictionary, to_device
from ..types import SqlType
from .catalog import Table


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rescale_host(v: np.ndarray, from_scale: int, to_scale: int):
    """Unscaled int64 decimals from one scale to another; a narrower scale
    rounds half away from zero, as the evaluator's rescale does."""
    if to_scale >= from_scale:
        return v * (10 ** (to_scale - from_scale))
    f = 10 ** (from_scale - to_scale)
    return (v + np.sign(v) * (f // 2)) // f


def _dictionary_column(codes: np.ndarray, dictionary: np.ndarray,
                       valid: Optional[np.ndarray]):
    """(codes into the sorted dictionary of the values present, that
    dictionary): unused entries dropped, NULL rows at code 0."""
    dictionary = np.asarray(dictionary)
    if len(codes) == 0 or len(dictionary) == 0:
        return np.zeros(len(codes), np.int32), dictionary[:0]
    codes = np.clip(codes.astype(np.int64), 0, len(dictionary) - 1)
    live = codes if valid is None else codes[valid]
    used = np.bincount(live, minlength=len(dictionary)) > 0
    remap = np.cumsum(used) - 1
    out = remap[codes].astype(np.int32)
    if valid is not None:
        out[~valid] = 0
    return out, dictionary[used]


def _merge_dictionaries(old: Tuple[np.ndarray, np.ndarray],
                        new: Tuple[np.ndarray, np.ndarray]):
    """Codes of two dictionary-coded runs against their merged sorted
    dictionary."""
    (oc, od), (nc, nd) = old, new
    if len(od) == 0:
        return oc, nc, nd
    if len(nd) == 0:
        return oc, nc, od
    merged = np.union1d(od.astype(str), nd.astype(str))
    o = np.searchsorted(merged, od.astype(str)).astype(np.int32)
    n = np.searchsorted(merged, nd.astype(str)).astype(np.int32)
    return (o[oc] if len(oc) else oc), (n[nc] if len(nc) else nc), merged


class MemoryTable(Table):
    def __init__(self, name: str, schema: List[Tuple[str, SqlType]],
                 device="cuda"):
        super().__init__(name, schema, device=device)
        self._data: Dict[str, np.ndarray] = {
            c: np.empty(0, dtype=np.int32 if t.is_string else t.np_dtype)
            for c, t in schema
        }
        self._valid: Dict[str, Optional[np.ndarray]] = {
            c: None for c, _ in schema}
        self._dict: Dict[str, np.ndarray] = {
            c: np.empty(0, dtype="U1") for c, t in schema if t.is_string}
        self._rows = 0

    @property
    def num_rows(self) -> int:
        return self._rows

    def _stored(self, t: SqlType, src: Column, n: int):
        """(storage array, validity or None, dictionary or None) of the
        first ``n`` rows of ``src`` as a column of type ``t``."""
        if src.is_nested:
            raise ValueError(f"an {src.type} column cannot be stored in a "
                             f"memory table")
        valid = None if src.validity is None else _host(src.validity[:n])
        if valid is not None and valid.all():
            valid = None
        st = src.type
        if t.is_string:
            if st.is_string and src.dictionary is not None:
                codes, d = _dictionary_column(_host(src.data[:n]),
                                              src.dictionary, valid)
                return codes, valid, d
            vals = src.decode(n)
            strs = np.array(["" if v is None else str(v) for v in vals],
                            dtype=object)
            d, codes = encode_dictionary(strs.astype("U") if n
                                         else np.empty(0, "U1"))
            codes, d = _dictionary_column(codes, d, valid)
            return codes, valid, d
        raw = _host(src.data[:n])
        if t.kind == "decimal":
            if st.kind == "decimal":
                vals = _rescale_host(raw.astype(np.int64), st.scale, t.scale)
            elif st.kind in ("bigint", "integer", "smallint", "tinyint"):
                vals = raw.astype(np.int64) * (10 ** t.scale)
            else:
                vals = np.round(raw.astype(np.float64) * 10 ** t.scale
                                ).astype(np.int64)
        elif t.kind == "date" and st.kind in ("timestamp", "timestamptz"):
            vals = np.floor_divide(raw.astype(np.int64), 86_400_000_000)
        elif st.kind == "decimal":
            vals = raw / (10 ** st.scale)  # to an integer or double column
        else:
            vals = raw
        vals = np.asarray(vals).astype(t.np_dtype)
        if valid is not None:
            vals = np.where(valid, vals, np.zeros((), vals.dtype))
        return vals, valid, None

    def append(self, batch: RecordBatch) -> int:
        n = batch.num_rows if isinstance(batch.num_rows, int) \
            else int(batch.num_rows)
        cols = list(batch.columns.values())
        if len(cols) != len(self.schema):
            raise ValueError(f"{len(cols)} columns written to {self.name}, "
                             f"which has {len(self.schema)}")
        stored = [self._stored(t, src, n)
                  for t, src in zip(self.schema.values(), cols)]
        old_rows = self._rows
        for (cname, t), (vals, valid, d) in zip(self.schema.items(), stored):
            old = self._data[cname]
            if t.is_string:
                old, vals, self._dict[cname] = _merge_dictionaries(
                    (old, self._dict[cname]), (vals, d))
            self._data[cname] = np.concatenate([old, vals])
            ov = self._valid[cname]
            if ov is not None or valid is not None:
                self._valid[cname] = np.concatenate([
                    np.ones(old_rows, bool) if ov is None else ov,
                    np.ones(n, bool) if valid is None else valid])
        self._rows += n
        self._cache.clear()  # invalidate lazily-materialised device columns
        self._ranges.clear()
        return n

    def page_sink(self):
        """Writable half of the connector SPI
        (``spi/connector/ConnectorPageSink.java``): pages buffer
        invisibly; ``finish()`` commits them in one append each (readers
        never observe a partial write -- the TableFinishOperator
        contract)."""
        table = self

        from ..spi.connector import ConnectorPageSink

        class _Sink(ConnectorPageSink):
            def __init__(self):
                self._pages: list = []
                self._done = False

            def append(self, batch: RecordBatch) -> int:
                assert not self._done, "sink already finished/aborted"
                n = batch.num_rows if isinstance(batch.num_rows, int) \
                    else int(batch.num_rows)
                self._pages.append(batch)
                return n

            def finish(self) -> int:
                self._done = True
                total = 0
                for b in self._pages:
                    total += table.append(b)
                self._pages.clear()
                return total

            def abort(self) -> None:
                self._done = True
                self._pages.clear()

        return _Sink()

    def host_column(self, column: str) -> Column:
        """The stored host column (no device round trip)."""
        t = self.schema[column]
        return Column(self._data[column], t, validity=self._valid[column],
                      dictionary=self._dict.get(column))

    def _load(self, column: str, device) -> Column:
        c = self.host_column(column)
        data, valid = c.data, c.validity
        if len(data) == 0:  # one dead row: a batch keeps a capacity
            data = np.zeros(1, dtype=data.dtype)
            valid = None
        return Column(to_device(data, device), c.type,
                      validity=None if valid is None
                      else to_device(valid, device),
                      dictionary=c.dictionary)

