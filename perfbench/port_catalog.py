"""The benchmark's tables handed to the program through its connector
interface (``presto1_tpu_torch.exec.catalog``): the same host arrays that
the reference reads, uploaded once per column, with the primary keys, sort
order and statistics that the port's own TPC-H connector declares.
"""

from __future__ import annotations

import numpy as np
import torch

from presto1_tpu_torch.batch import Column
from presto1_tpu_torch.exec.catalog import Catalog, Table
from presto1_tpu_torch.sql.stats import ColStats
from presto1_tpu_torch.types import parse_type_str


class BenchTable(Table):
    def __init__(self, store, name: str, device):
        schema = [(c, parse_type_str(str(t)))
                  for c, t in store.suite.tables[name].items()]
        super().__init__(name, schema, device=device)
        self.store = store
        self.unique_keys = store.suite.unique_keys(name)
        self.sort_columns = store.suite.sort_columns(name)

    @property
    def num_rows(self) -> int:
        return self.store.num_rows(self.name)

    def host_column(self, name: str) -> Column:
        c = self.store.column(self.name, name)
        return Column(c.data, self.schema[name], validity=c.validity,
                      dictionary=c.dictionary)

    def _load(self, name: str, device) -> Column:
        c = self.store.column(self.name, name)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return Column(up(c.data), self.schema[name],
                      validity=None if c.validity is None else up(c.validity),
                      dictionary=c.dictionary)

    def column_stats(self, name: str):
        s = self.store.suite.column_stats(self.name, name)
        return None if s is None else ColStats(*s)


class BenchCatalog(Catalog):
    def __init__(self, store, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        for name in store.suite.tables:
            self.tables[name] = BenchTable(store, name, self.device)
