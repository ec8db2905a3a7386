"""The SQL types of the frozen schemas, by name only.

The benchmark's data and its reference need a column's kind, its decimal
scale and its host dtype; the program's own type objects are made from
``str(t)`` where the tables are handed to it (``perfbench/port_catalog.py``),
so nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

_NP = {"bigint": np.int64, "integer": np.int32, "double": np.float64,
       "date": np.int32, "decimal": np.int64, "varchar": np.int32}


class SqlType:
    def __init__(self, kind: str, precision: int = 0, scale: int = 0):
        self.kind, self.precision, self.scale = kind, precision, scale

    @property
    def np_dtype(self):
        return np.dtype(_NP[self.kind])

    @property
    def is_string(self) -> bool:
        return self.kind == "varchar"

    def __str__(self):
        if self.kind == "decimal":
            return f"decimal({self.precision},{self.scale})"
        return self.kind

    __repr__ = __str__


def DecimalType(precision: int, scale: int) -> SqlType:
    return SqlType("decimal", precision, scale)


BIGINT = SqlType("bigint")
INTEGER = SqlType("integer")
DOUBLE = SqlType("double")
DATE = SqlType("date")
VARCHAR = SqlType("varchar")
