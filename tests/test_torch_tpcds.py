"""TPC-DS in the port: the copied generator and schema, the catalog's
column statistics (they decide join order and build sides), and all 21
queries of ``tpcds/queries.py`` -- Q27 (ROLLUP: joins and a Union), Q93 (a
LEFT join on two columns), Q12 / Q89 / Q98 (window functions) and the rest --
through the port's engine on the CPU, eager and compiled, against the JAX
package's ``Engine(TpcdsCatalog(sf=0.01)).sql`` and ``Engine.explain``.

Host columns bit-equal; integers, decimals, dictionary values, validity and
row order exact; doubles to 1e-6 relative (summation order differs).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import presto1_tpu.exec.engine as j_engine
import presto1_tpu.ops.join as j_join
import presto1_tpu.tpcds.catalog as j_tpcds
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
import presto1_tpu_torch.ops.join as t_join
import presto1_tpu_torch.tpcds.catalog as t_tpcds
from presto1_tpu_torch.tpcds.queries import QUERIES
from presto1_tpu_torch.tpcds.schema import TABLES

from torch_parity import assert_batches_equal, no_host_sync

torch.set_num_threads(1)

# every table TPC-DS Q27 and Q93 read
READ_TABLES = ("store_sales", "customer_demographics", "date_dim", "item",
               "store", "store_returns")
MODES = ["sql", "compiled_call", "block_run"]
# rows each query returns at SF 0.01 (equal in both packages)
ROWS = {3: 55, 6: 24, 7: 48, 12: 32, 13: 1, 15: 18, 19: 5, 25: 0, 26: 29,
        27: 7, 37: 10, 42: 4, 43: 1, 52: 7, 55: 8, 65: 0, 73: 100, 89: 100,
        93: 100, 96: 1, 98: 46}


@pytest.fixture(scope="module")
def catalogs():
    return j_tpcds.TpcdsCatalog(sf=0.01), \
        t_tpcds.TpcdsCatalog("tiny", device="cpu")


@pytest.fixture(scope="module")
def engines(catalogs):
    jc, tc = catalogs
    return j_engine.Engine(jc), t_engine.Engine(tc, device="cpu")


@pytest.fixture(scope="module")
def references(engines):
    """The reference's result of a query, computed on first use: once per
    worker process, so xdist spreads the queries over its workers."""
    je, _ = engines
    done = {}

    def get(q):
        if q not in done:
            done[q] = je.sql(QUERIES[q])
        return done[q]
    return get


@pytest.mark.parametrize("table,column", [
    (t, c) for t in READ_TABLES for c, _ in TABLES[t]])
def test_host_columns_bit_equal_reference(catalogs, table, column):
    """The data is this system's weights: the port's generator gives the
    reference's bits, validity and dictionary."""
    jc, tc = catalogs
    jt, tt = jc.table(table), tc.table(table)
    assert jt.num_rows == tt.num_rows
    a, b = jt.host_column(column), tt.host_column(column)
    assert str(a.type) == str(b.type)
    assert np.asarray(a.data).dtype == np.asarray(b.data).dtype
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        np.testing.assert_array_equal(np.asarray(a.validity),
                                      np.asarray(b.validity))
    if a.dictionary is not None or b.dictionary is not None:
        np.testing.assert_array_equal(a.dictionary, b.dictionary)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_column_stats_equal_reference(catalogs, table):
    jc, tc = catalogs
    jt, tt = jc.table(table), tc.table(table)
    assert jt.unique_keys == tt.unique_keys
    for column, _ in TABLES[table]:
        a, b = jt.column_stats(column), tt.column_stats(column)
        assert (a is None) == (b is None), column
        if a is not None:
            assert (a.ndv, a.lo, a.hi) == (b.ndv, b.lo, b.hi), column


def test_device_columns_are_cached_on_the_catalog_device(catalogs):
    _, tc = catalogs
    t = tc.table("store_sales")
    c = t.column("ss_customer_sk")
    assert c.data.device.type == "cpu" and c.validity is not None
    assert t.column("ss_customer_sk") is c


def _run(te, sql, mode):
    if mode == "sql":
        return te.sql(sql)
    cq = te.compile(sql)
    if mode == "block_run":
        assert cq.block_run(reps=2) == cq().num_rows
    return cq()


def test_every_query_is_tested():
    assert sorted(ROWS) == sorted(QUERIES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_query_matches_reference(engines, references, q, mode):
    _, te = engines
    got = _run(te, QUERIES[q], mode)
    assert_batches_equal(references(q), got, f"q{q} {mode}")
    assert got.num_rows == ROWS[q]


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plan_matches_reference(engines, q):
    je, te = engines
    assert te.explain(QUERIES[q]) == je.explain(QUERIES[q])


@pytest.mark.parametrize("q,route", [(27, ["merge_join"] * 12),
                                     (93, ["_probe_ranges"])])
def test_join_route_matches_reference(engines, monkeypatch, q, route):
    """Q27 takes ``merge_join`` twelve times, Q93 ``_probe_ranges`` once
    (the N:1 LEFT lookup), in the port as in the reference."""
    je, te = engines
    calls = []
    for mod in (t_join, j_join):
        for name in ("merge_join", "_probe_ranges", "cross_join"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, _mod=mod, **k):
                calls.append((_mod.__name__.split(".")[0], _name))
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, spy)
    te.sql(QUERIES[q])
    je.sql(QUERIES[q])
    assert [c for m, c in calls if m == "presto1_tpu_torch"] == route
    assert [c for m, c in calls if m == "presto1_tpu"] == route


def test_q27_union_goes_through_dyncopy_in_every_run(engines, monkeypatch):
    _, te = engines
    calls = []
    real = t_executor.concat_rows

    def spy(columns, counts, capacity):
        calls.append((len(columns), counts.tolist()))
        return real(columns, counts, capacity)

    monkeypatch.setattr(t_executor, "concat_rows", spy)
    cq = te.compile(QUERIES[27])
    cq.block_run(reps=3)
    assert len(calls) == 4  # discovery + three runs
    # three ROLLUP levels; both varchar keys and four averages, with
    # validity for each of the six
    assert all(n == 12 and len(c) == 3 for n, c in calls)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_compiled_run_never_waits_for_the_host(engines, monkeypatch, q):
    _, te = engines
    cq = te.compile(QUERIES[q])
    no_host_sync(monkeypatch)
    _, _, num_rows, _ = cq._run()
    monkeypatch.undo()
    assert int(num_rows) == ROWS[q]


def test_import_with_jax_blocked():
    """The port, its TPC-DS connector, joins, Union, windows, the
    dynamic-copy kernel, memory accounting, spilling, grouped execution,
    sampled discovery, the file catalog and the roofline harness import and
    run with jax and the reference package unimportable; the file catalog
    and the roofline import no pyarrow."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'presto1_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import presto1_tpu_torch.ops.join\n"
        "import presto1_tpu_torch.ops.kernels.dyncopy\n"
        "import presto1_tpu_torch.exec.dist_engine\n"
        "from presto1_tpu_torch.tpcds.catalog import TpcdsCatalog\n"
        "from presto1_tpu_torch.tpcds.queries import QUERIES\n"
        "from presto1_tpu_torch.exec.engine import Engine\n"
        "e = Engine(TpcdsCatalog('tiny', device='cpu'), device='cpu')\n"
        "assert e.sql(QUERIES[27]).num_rows == 7\n"
        "assert e.compile(QUERIES[93])().num_rows == 100\n"
        "assert e.compile(QUERIES[98])().num_rows == 46\n"
        "import presto1_tpu_torch.exec.memory\n"
        "import presto1_tpu_torch.exec.spill\n"
        "import presto1_tpu_torch.exec.grouped\n"
        "import presto1_tpu_torch.exec.sampling\n"
        "from presto1_tpu_torch.exec.catalog import TpchCatalog\n"
        "from presto1_tpu_torch.exec.session import Session\n"
        "from presto1_tpu_torch.tpch.queries import QUERIES as H\n"
        "s = Session()\n"
        "s.set('spill_threshold', 4096)\n"
        "s.set('query_max_memory', 1 << 30)\n"
        "h = Engine(TpchCatalog(sf=0.001, device='cpu'), session=s,\n"
        "           device='cpu')\n"
        "assert h.sql(H[3]).num_rows == 10\n"
        "assert h.compile_grouped(H[1], n_groups=2)().num_rows == 4\n"
        "assert h.compile(H[3], sample={'lineitem': 4})().num_rows == 10\n"
        "import presto1_tpu_torch.exec.file_catalog as fc\n"
        "import presto1_tpu_torch.testing.roofline as rl\n"
        "assert not any(m.split('.')[0] == 'pyarrow' for m in sys.modules)\n"
        "assert rl.busy_time([(0, 2), (1, 3)]) == 3\n"
        "import tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "open(d + '/t.csv', 'w').write('k,v\\n1,2.5\\n1,0.5\\n')\n"
        "f = Engine(fc.FileCatalog(d, device='cpu'), device='cpu')\n"
        "assert f.sql('select sum(v) s from t').to_pylist() == [(3.0,)]\n"
        "print('clean')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
