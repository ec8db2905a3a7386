"""A catalog built from the benchmark's arrays plans every template
instance as the port's own TPC-H catalog does: the same keys, sort order
and statistics reach the optimizer."""

import pytest

from .helpers import CELLS, SEEDS, SF, store, traffic


def catalogs(config: str):
    from presto1_tpu_torch.exec.catalog import TpchCatalog
    from presto1_tpu_torch.exec.engine import Engine

    from perfbench.port_catalog import BenchCatalog

    own = TpchCatalog(sf=SF, device="cpu")
    return (Engine(BenchCatalog(store(config), device="cpu"), device="cpu"),
            Engine(own, device="cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_same_plans_as_the_ports_catalog(cell):
    bench, own = catalogs(cell.split(".")[0])
    for seed in (None,) + SEEDS:
        for inst in traffic(cell, seed).instances:
            assert bench.explain(inst.text) == own.explain(inst.text), \
                inst.text


@pytest.mark.parametrize("config", ["tpch-sf1"])
def test_same_tables_and_metadata(config):
    bench, own = catalogs(config)
    for name, table in own.catalog.tables.items():
        if name not in store(config).suite.tables:
            continue  # the system tables every Engine attaches
        mine = bench.catalog.table(name)
        assert mine.num_rows == table.num_rows, name
        assert mine.unique_keys == [tuple(k) for k in table.unique_keys]
        assert mine.sort_columns == table.sort_columns, name
        for col in table.column_order:
            assert str(mine.schema[col]) == str(table.schema[col])
            assert mine.column_stats(col) == table.column_stats(col), col
