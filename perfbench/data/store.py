"""Host columns of one configuration, generated once and kept on disk.

A column is generated by its suite's frozen generator the first time a run
in a checkout needs it and written under ``perfbench/.cache/<config>/``
(ignored by git); every later run reads it back.  A file is written under a
temporary name and renamed into place, the dictionary and the validity
before the data, so a reader sees a whole column or none.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, Optional

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache")


class HostColumn:
    """A column as numpy arrays: the values in the type's host dtype
    (strings as int32 codes into a sorted dictionary), and a validity mask
    where the column has NULLs."""

    def __init__(self, data: np.ndarray, type_, validity=None,
                 dictionary=None):
        self.data, self.type = data, type_
        self.validity, self.dictionary = validity, dictionary

    @classmethod
    def strings(cls, values, type_, validity=None) -> "HostColumn":
        dictionary, codes = np.unique(np.asarray(values, dtype="U"),
                                      return_inverse=True)
        return cls(codes.astype(np.int32), type_, validity, dictionary)

    def decoded(self) -> np.ndarray:
        """The values themselves (strings looked up in the dictionary)."""
        if self.dictionary is None:
            return self.data
        return self.dictionary[self.data]

    def valid(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.data), bool)
        return self.validity


def suite(name: str, sf: float):
    """The data suite ``perfbench/data/<name>.py`` at scale factor ``sf``."""
    return importlib.import_module(f"{__package__}.{name}").Suite(sf)


class Store:
    """The columns of one configuration: ``column(table, name)``."""

    def __init__(self, config: dict, cache: Optional[str] = CACHE):
        self.config = config
        self.suite = suite(config["suite"], config["scale_factor"])
        self.dir = None if cache is None else os.path.join(
            cache, config["name"])
        self._columns: Dict[tuple, HostColumn] = {}
        self.generated = 0  # columns generated (not read back) by this run

    def num_rows(self, table: str) -> int:
        return self.suite.num_rows(table)

    def type(self, table: str, column: str):
        return self.suite.tables[table][column]

    def column(self, table: str, column: str) -> HostColumn:
        key = (table, column)
        if key not in self._columns:
            self._columns[key] = self._read(table, column) or self._make(
                table, column)
        return self._columns[key]

    def _path(self, table: str, column: str, part: str) -> Optional[str]:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"{table}.{column}.{part}.npy")

    def _read(self, table: str, column: str) -> Optional[HostColumn]:
        path = self._path(table, column, "data")
        if path is None or not os.path.exists(path):
            return None
        parts = {}
        for part in ("validity", "dictionary"):
            p = self._path(table, column, part)
            parts[part] = np.load(p) if os.path.exists(p) else None
        return HostColumn(np.load(path), self.type(table, column), **parts)

    def _make(self, table: str, column: str) -> HostColumn:
        col = self.suite.generate(table, column)
        self.generated += 1
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            for part in ("validity", "dictionary"):
                if getattr(col, part) is not None:
                    _save(self._path(table, column, part),
                          getattr(col, part))
            _save(self._path(table, column, "data"), col.data)
        return col


def _save(path: str, array: np.ndarray) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, np.ascontiguousarray(array))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
