"""TPC-DS catalog: lazy-column tables over the deterministic generator
(the plugin/trino-tpcds connector analog; same Table/Catalog SPI as the
TPC-H connector in exec/catalog.py).  Columns are placed on a device once
and cached, as ``exec/catalog.py`` places TPC-H's."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..batch import Column, encode_dictionary, to_device
from ..exec.catalog import Catalog, Table
from .dbgen import TpcdsGenerator
from .schema import PRIMARY_KEYS, TABLES


class TpcdsTable(Table):
    def __init__(self, name: str, gen: TpcdsGenerator, device="cuda"):
        super().__init__(name, TABLES[name], device=device)
        self.unique_keys = PRIMARY_KEYS.get(name, [])
        self.gen = gen

    @property
    def num_rows(self) -> int:
        return self.gen.num_rows(self.name)

    def host_column(self, column: str) -> Column:
        t = self.schema[column]
        values, validity = self.gen.column(self.name, column)
        if t.is_string:
            dictionary, codes = encode_dictionary(
                np.asarray(values, dtype="U"))
            return Column(codes, t, validity=validity, dictionary=dictionary)
        dt = np.int64 if t.kind == "decimal" else t.np_dtype
        return Column(np.asarray(values).astype(dt, copy=False), t,
                      validity=validity)

    def _load(self, column: str, device) -> Column:
        c = self.host_column(column)
        return Column(to_device(c.data, device), c.type,
                      validity=None if c.validity is None
                      else to_device(c.validity, device),
                      dictionary=c.dictionary)

    def column_stats(self, name: str):
        """Column statistics derived from the generator's own structure
        (PK ranges, FK targets, date SK windows) -- the
        plugin/trino-tpcds stats analog, with no per-query hardcoding.
        The planner's join order and build sides come from these, so they
        are the reference's exactly."""
        from ..sql.stats import ColStats
        from .dbgen import D_SK_EPOCH, FK_TARGETS, SALES_SK_LO, SALES_SK_HI

        n = self.num_rows
        if (name,) in [tuple(k) for k in self.unique_keys]:
            if name == "d_date_sk":
                return ColStats(float(n), float(D_SK_EPOCH),
                                float(D_SK_EPOCH + n - 1))
            return ColStats(float(n), 1.0, float(n))
        if name == "d_year":
            years = max(n // 365, 1)
            return ColStats(float(years), 1900.0, 1900.0 + n / 365.0)
        if name == "d_moy":
            return ColStats(12.0, 1.0, 12.0)
        if name == "d_qoy":
            return ColStats(4.0, 1.0, 4.0)
        if name == "d_dom":
            return ColStats(31.0, 1.0, 31.0)
        if name.endswith("date_sk"):
            width = SALES_SK_HI - SALES_SK_LO + 1
            return ColStats(float(width), float(SALES_SK_LO),
                            float(SALES_SK_HI))
        if name.endswith("time_sk"):
            return ColStats(86400.0, 0.0, 86399.0)
        for suffix, target in FK_TARGETS.items():
            if name.endswith(suffix) and self.name != target:
                t = float(self.gen.num_rows(target))
                return ColStats(t, 1.0, t)
        return None


class TpcdsCatalog(Catalog):
    """schema 'tiny' = SF0.01 (like the reference's tpch tiny)."""

    def __init__(self, schema: str = "tiny", sf: Optional[float] = None,
                 device="cuda"):
        super().__init__()
        if sf is None:
            sf = 0.01 if schema == "tiny" else float(
                schema.replace("sf", ""))
        self.sf = sf
        self.device = torch.device(device)
        gen = TpcdsGenerator(sf)
        for name in TABLES:
            self.tables[name] = TpcdsTable(name, gen, device=self.device)
