"""All 22 TPC-H queries through the port's engine on the CPU, eager and
compiled, against the pandas oracle of ``tests/tpch_oracle.py`` on identical
generated data at SF 0.01 (the gate of ``tests/test_tpch.py``).

Row order exact; floats and decimals to 1e-6 (``compare_frames``).
"""

import pytest
import torch

import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
from presto1_tpu_torch.testing.verifier import compare_frames
from presto1_tpu_torch.tpch.queries import QUERIES
from presto1_tpu_torch.tpch.schema import TABLES

from tpch_oracle import ORACLE

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def env():
    catalog = t_catalog.TpchCatalog("tiny", device="cpu")
    frames = {t: catalog.table(t).batch().to_pandas() for t in TABLES}
    return t_engine.Engine(catalog, device="cpu"), frames


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_query_matches_oracle(env, qid, mode):
    engine, frames = env
    sql = QUERIES[qid]
    got = engine.sql(sql) if mode == "sql" else engine.compile(sql)()
    assert compare_frames(got.to_pandas(), ORACLE[qid](frames)) is None
