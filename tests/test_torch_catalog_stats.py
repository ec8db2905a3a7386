"""Catalog-driven uniqueness in the port's planner: the cases of
``tests/test_catalog_stats.py`` retargeted to ``presto1_tpu_torch``.  Each
plan's joins are held against the JAX package's plan of the same statement
over the same catalog: the same joins, each with the same ``build_unique``
(the optimizer's N:1 detection from ``Table.unique_keys``).
"""

import pytest
import torch

from presto1_tpu.exec.catalog import TpchCatalog as JTpchCatalog
from presto1_tpu.exec.engine import Engine as JEngine
from presto1_tpu.tpcds.catalog import TpcdsCatalog as JTpcdsCatalog
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog

torch.set_num_threads(1)


def _joins(plan):
    out = []

    def walk(n):
        if type(n).__name__ == "Join":
            out.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    return out


@pytest.fixture(scope="module")
def tpch():
    return (Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu"),
            JEngine(JTpchCatalog(sf=0.001)))


@pytest.fixture(scope="module")
def tpcds():
    return (Engine(TpcdsCatalog(sf=1, device="cpu"), device="cpu"),
            JEngine(JTpcdsCatalog(sf=1)))


def both_joins(engines, sql):
    """The port's plan's joins, each with the kind, keys and build_unique
    of the JAX package's plan."""
    engine, reference = engines
    got, want = _joins(engine.plan(sql)), _joins(reference.plan(sql))
    assert [(j.kind, str(j.equis), j.build_unique) for j in got] == \
        [(j.kind, str(j.equis), j.build_unique) for j in want]
    return got


def test_tpch_pk_still_detected(tpch):
    js = both_joins(tpch, "select o_orderkey from lineitem join orders "
                          "on l_orderkey = o_orderkey")
    assert js and all(j.build_unique for j in js)


def test_tpcds_dimension_pk_detected(tpcds):
    js = both_joins(tpcds, "select d_year from store_sales join date_dim "
                           "on ss_sold_date_sk = d_date_sk")
    assert js and all(j.build_unique for j in js)


def test_tpcds_composite_fact_pk_detected(tpcds):
    js = both_joins(tpcds,
                    "select sr.sr_return_amt from store_sales ss join "
                    "store_returns sr on ss.ss_item_sk = sr.sr_item_sk "
                    "and ss.ss_ticket_number = sr.sr_ticket_number")
    assert js and all(j.build_unique for j in js)


def test_non_key_join_not_marked_unique(tpch):
    js = both_joins(tpch, "select 1 x from lineitem l1 join lineitem l2 "
                          "on l1.l_partkey = l2.l_partkey")
    assert js and not any(j.build_unique for j in js)
