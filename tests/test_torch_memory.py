"""Device-memory accounting in the port (``exec/memory.py``) against the JAX
package's (``presto1_tpu/exec/memory.py``): the per-query limit an engine
enforces, the peak an executor records, the shared pool's low-memory
killer, and ``batch_bytes`` on the same batches.

Also the regression for a fault of the port: ``Engine.sql`` read none of
the session's memory properties, so ``select count(*) from lineitem``
under ``query_max_memory = 1024`` answered 6190 where the JAX package
raises ``ExceededMemoryLimitError`` (ROADMAP C5).
"""

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.exec.executor as j_executor
import presto1_tpu.exec.memory as j_memory
import presto1_tpu.exec.session as j_session
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.exec.executor as t_executor
import presto1_tpu_torch.exec.memory as t_memory
import presto1_tpu_torch.exec.session as t_session

from torch_parity import both_batches

torch.set_num_threads(1)

COUNT_SQL = "select count(*) from lineitem"
PEAK_SQL = ("select sum(l_quantity) from lineitem "
            "where l_shipdate < date '1995-01-01'")
# (reference module set, port module set): the tests run each scenario on
# both and compare what they report
SIDES = {
    "reference": (j_catalog, j_engine, j_executor, j_memory, j_session, {}),
    "port": (t_catalog, t_engine, t_executor, t_memory, t_session,
             {"device": "cpu"}),
}


def _engine(side, session=None, **kw):
    cat, eng, _, _, _, dev = SIDES[side]
    return eng.Engine(cat.TpchCatalog(sf=0.001, **dev), session=session,
                      **kw, **dev)


def _limited_session(side, limit):
    s = SIDES[side][4].Session()
    s.set("query_max_memory", limit)
    return s


@pytest.fixture(scope="module")
def limit_errors():
    """The message each package raises for ``COUNT_SQL`` at 1 KB."""
    out = {}
    for side in SIDES:
        mem = SIDES[side][3]
        with pytest.raises(mem.ExceededMemoryLimitError) as err:
            _engine(side, _limited_session(side, 1024)).sql(COUNT_SQL)
        out[side] = str(err.value)
    return out


def test_query_max_memory_enforced_c5(limit_errors):
    """C5: the port raises where the reference raises, with the same
    byte count (6190 rows x 8 bytes of the scanned key)."""
    assert limit_errors["port"] == limit_errors["reference"]
    assert "49520 > 1024" in limit_errors["port"]


@pytest.mark.parametrize("limit", [49_520, 1 << 30])
def test_limit_at_or_above_the_working_set_answers(limit):
    e = _engine("port", _limited_session("port", limit))
    assert e.sql(COUNT_SQL).to_pylist() == [(6190,)]


def test_within_limit_tracks_the_reference_peak():
    peaks = {}
    for side in SIDES:
        _, _, ex_mod, mem, _, dev = SIDES[side]
        engine = _engine(side)
        plan = engine.plan(PEAK_SQL)
        ctx = mem.QueryMemoryContext("q1", max_bytes=1 << 30)
        ex_mod.Executor(engine.catalog, memory=ctx, **dev).execute(plan)
        assert ctx.peak > 0
        peaks[side] = ctx.peak
        ctx.release_all()
        assert ctx.current == 0
    assert peaks["port"] == peaks["reference"]


def test_engine_releases_its_pool_reservation_c8():
    """C8: after each statement the port's pool holds nothing; the JAX
    package's keeps every consumed child's bytes reserved (49,520 of the
    scan a statement), so a long-lived pool fills up and its killer ends
    queries that fit."""
    reserved = {}
    for side in SIDES:
        pool = SIDES[side][3].MemoryPool(capacity_bytes=1 << 30)
        e = _engine(side, memory_pool=pool)
        reserved[side] = []
        for _ in range(3):
            assert e.sql(COUNT_SQL).to_pylist() == [(6190,)]
            assert pool.info()["queries"] == {}
            reserved[side].append(pool.info()["reserved"])
    assert reserved == {"port": [0, 0, 0],
                        "reference": [49_528, 99_056, 148_584]}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_pool_low_memory_killer(side):
    mem = SIDES[side][3]
    pool = mem.MemoryPool(capacity_bytes=1000)
    big = mem.QueryMemoryContext("big", pool=pool)
    small = mem.QueryMemoryContext("small", pool=pool)
    pool.register(big)
    pool.register(small)
    big.set_bytes((0,), 700)
    small.set_bytes((0,), 200)
    # small asks for more than remains: the killer targets the LARGEST query
    small.set_bytes((1,), 300)
    assert big.killed is not None
    assert small.killed is None
    with pytest.raises(mem.QueryKilledError):
        big.set_bytes((1,), 1)
    # a single query larger than the pool is its own victim
    pool2 = mem.MemoryPool(capacity_bytes=100)
    solo = mem.QueryMemoryContext("solo", pool=pool2)
    pool2.register(solo)
    with pytest.raises(mem.ExceededMemoryLimitError):
        solo.set_bytes((0,), 500)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_children_freed_on_parent_materialise(side):
    mem = SIDES[side][3]
    ctx = mem.QueryMemoryContext("q")
    ctx.set_bytes((0, 0, 0), 100)
    ctx.set_bytes((0, 0, 1), 50)
    assert ctx.current == 150
    ctx.set_bytes((0, 0), 80)  # parent consumes both children
    assert (ctx.current, ctx.peak) == (80, 150)


def _spec(rows, seed):
    rng = np.random.default_rng(seed)
    return {
        "k": (rng.integers(0, 50, rows), None, "bigint"),
        "i": (rng.integers(0, 9, rows).astype(np.int32),
              rng.random(rows) < 0.8, "integer"),
        "d": (rng.random(rows), None, "double"),
        "p": (rng.integers(-10**6, 10**6, rows), rng.random(rows) < 0.5,
              "decimal(12,2)"),
        "b": (rng.random(rows) < 0.5, None, "boolean"),
        "s": (rng.integers(0, 3, rows).astype(np.int32), None, "varchar",
              np.array(["a", "b", "c"])),
    }


@pytest.mark.parametrize("rows", [1, 128, 1000, 4096])
def test_batch_bytes_equals_the_reference(rows):
    jb, tb = both_batches(_spec(rows, rows))
    assert t_memory.batch_bytes(tb) == j_memory.batch_bytes(jb)
    # data bytes of every column, plus a byte a row for each validity
    assert t_memory.batch_bytes(tb) == rows * (8 + 4 + 8 + 8 + 1 + 4) \
        + 2 * rows
