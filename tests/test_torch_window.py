"""The port's window functions against the JAX package's, on the CPU.

* every statement of ``tests/test_window.py`` through both engines on
  ``TpchCatalog(sf=0.001)``, the port eager and compiled, and a compiled
  window run that never waits for the host;
* ``ops/window.py::window`` against ``presto1_tpu.ops.window.window`` on
  seeded numpy batches, for each function and each frame kind ('up', 'p',
  'c', 'f', 'uf' under ROWS and RANGE): NULL inputs, ties in the order
  keys, one-row partitions, empty frames and dead rows past ``num_rows``;
* the doubling table's level at every power of two, and the rule that the
  port's window takes no running-max scan.

Integers, decimals, dates, dictionary codes and validity are exact;
doubles to 1e-6 relative.
"""

import inspect

import numpy as np
import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.ops.sort as j_sort
import presto1_tpu.ops.window as j_window
import presto1_tpu.types as j_types
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.ops.sort as t_sort
import presto1_tpu_torch.ops.window as t_window
import presto1_tpu_torch.types as t_types

from torch_parity import assert_batches_equal, both_batches, no_host_sync

torch.set_num_threads(1)

# the statements of tests/test_window.py
STATEMENTS = {
    "row_number_and_rank":
        "select n_regionkey r, n_name, "
        "row_number() over (partition by n_regionkey order by n_name) rn, "
        "rank() over (partition by n_regionkey order by n_name) rk "
        "from nation order by r, rn",
    "running_sum":
        "select o_custkey, o_orderdate, "
        "sum(o_totalprice) over (partition by o_custkey order by o_orderdate) "
        "rs, o_totalprice from orders",
    "partition_total_no_order":
        "select c_nationkey, c_acctbal, "
        "sum(c_acctbal) over (partition by c_nationkey) tot, "
        "count(*) over (partition by c_nationkey) cnt from customer",
    "min_max":
        "select n_regionkey r, n_nationkey k, "
        "min(n_nationkey) over (partition by n_regionkey order by "
        "n_nationkey) mn, "
        "max(n_nationkey) over (partition by n_regionkey) mx from nation",
    "lag_lead":
        "select o_orderkey, o_custkey, o_orderdate, "
        "lag(o_totalprice) over (partition by o_custkey order by o_orderkey) "
        "lg, lead(o_totalprice, 2) over (partition by o_custkey order by "
        "o_orderkey) ld, lag(o_totalprice, 1, -1.0) over (partition by "
        "o_custkey order by o_orderkey) lgd from orders",
    "first_last_nth_value":
        "select o_custkey, o_orderkey, "
        "first_value(o_totalprice) over (partition by o_custkey order by "
        "o_orderkey) fv, "
        "last_value(o_totalprice) over (partition by o_custkey order by "
        "o_orderkey rows between unbounded preceding and unbounded "
        "following) lv, "
        "nth_value(o_totalprice, 2) over (partition by o_custkey order by "
        "o_orderkey rows between unbounded preceding and unbounded "
        "following) nv from orders",
    "ntile":
        "select o_orderkey, ntile(4) over (order by o_orderkey) nt "
        "from orders",
    "rows_frame_sliding_sum_and_min":
        "select o_custkey, o_orderkey, "
        "sum(o_totalprice) over (partition by o_custkey order by o_orderkey "
        "rows between 2 preceding and current row) ms, "
        "min(o_totalprice) over (partition by o_custkey order by o_orderkey "
        "rows between 1 preceding and 1 following) mn, "
        "max(o_totalprice) over (partition by o_custkey order by o_orderkey "
        "rows 3 preceding) mx from orders",
    "empty_frame_is_null":
        "select o_orderkey, "
        "sum(o_totalprice) over (order by o_orderkey "
        "rows between 3 following and 2 following) s, "
        "count(*) over (order by o_orderkey "
        "rows between 3 following and 2 following) c from orders limit 5",
    "dense_rank_and_frame_defaults":
        "select l_orderkey, l_quantity, "
        "dense_rank() over (order by l_quantity) dr from lineitem",
    "percent_rank_and_cume_dist":
        "select o_custkey k, o_totalprice p, "
        "percent_rank() over (partition by o_custkey order by o_totalprice) "
        "pr, cume_dist() over (partition by o_custkey order by o_totalprice) "
        "cd from orders where o_custkey < 50",
    "percent_rank_single_row_partition":
        "select n_nationkey, "
        "percent_rank() over (partition by n_nationkey) pr, "
        "cume_dist() over (partition by n_nationkey) cd from nation",
}


@pytest.fixture(scope="module")
def engines():
    return (j_engine.Engine(j_catalog.TpchCatalog(sf=0.001)),
            t_engine.Engine(t_catalog.TpchCatalog(sf=0.001, device="cpu"),
                            device="cpu"))


@pytest.mark.parametrize("mode", ["sql", "compiled"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_reference(engines, name, mode):
    je, te = engines
    sql = STATEMENTS[name]
    got = te.sql(sql) if mode == "sql" else te.compile(sql)()
    assert_batches_equal(je.sql(sql), got, name)


@pytest.mark.parametrize("name", ["row_number_and_rank",
                                  "rows_frame_sliding_sum_and_min",
                                  "lag_lead", "dense_rank_and_frame_defaults"])
def test_compiled_window_never_waits_for_the_host(engines, monkeypatch, name):
    _, te = engines
    sql = STATEMENTS[name]
    want = te.sql(sql).num_rows
    cq = te.compile(sql)
    no_host_sync(monkeypatch)
    _, _, num_rows, _ = cq._run()
    monkeypatch.undo()
    assert int(num_rows) == want


# ------------------------------------------------------------ op level

CAPACITY, LIVE = 320, 301  # 19 dead rows past num_rows


def _spec(seed=0):
    """Partition keys with one-row partitions and a large one, order keys
    with ties and NULLs, and inputs with NULLs of every width."""
    rng = np.random.RandomState(seed)
    n = CAPACITY
    g = rng.randint(0, 40, n).astype(np.int64)
    g[:12] = np.arange(100, 112)          # twelve one-row partitions
    g[12:80] = 7                          # one large partition
    o = rng.randint(0, 25, n).astype(np.int64)   # many ties
    o2 = rng.randint(-5, 5, n).astype(np.int32)
    v = rng.randn(n) * 100
    w = rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int64)
    d = rng.randint(8000, 11000, n).astype(np.int32)
    dic = np.array(["apple", "fig", "kiwi", "pear", "plum"])
    s = rng.randint(0, len(dic), n).astype(np.int32)
    return {
        "g": (g, None, "bigint"),
        "g2": (rng.randint(0, 3, n).astype(np.int32), rng.rand(n) > 0.2,
               "integer"),
        "o": (o, None, "bigint"),
        "o2": (o2, rng.rand(n) > 0.15, "integer"),
        "v": (v, rng.rand(n) > 0.2, "double"),
        "vn": (v.copy(), None, "double"),
        "w": (w, rng.rand(n) > 0.2, "decimal(12,2)"),
        "d": (d, rng.rand(n) > 0.2, "date"),
        "s": (s, rng.rand(n) > 0.2, "varchar", dic),
    }


@pytest.fixture(scope="module")
def batches():
    return both_batches(_spec(), num_rows=LIVE)


def _ranges(cols, spec):
    out = []
    for name in cols:
        data, valid = spec[name][0][:LIVE], spec[name][1]
        if valid is not None:
            data = data[valid[:LIVE]]
        out.append((int(data.min()), int(data.max())))
    return out


SPEC = _spec()
ORDERINGS = {
    "none": [],
    "o": [("o", True, None)],
    "o_desc_o2": [("o", False, None), ("o2", True, None)],
    "o2_nulls_first": [("o2", True, True), ("o", True, None)],
}
PARTITIONINGS = {"g": ["g"], "g_g2": ["g", "g2"], "none": []}


def _run(batches, calls, part="g", order="o"):
    """``calls``: [(fn, input name or None, frame, default name, param)].
    The same window through both packages; asserts equal outputs."""
    jb, tb = batches
    pcols = PARTITIONINGS[part]
    ranges = _ranges(pcols, SPEC)
    out = []
    for b, sort_mod, win_mod, types in ((jb, j_sort, j_window, j_types),
                                        (tb, t_sort, t_window, t_types)):
        wcalls = []
        for i, (fn, arg, frame, default, param) in enumerate(calls):
            if fn in ("percent_rank", "cume_dist", "avg"):
                t = types.DOUBLE
            elif fn in ("sum", "min", "max", "lag", "lead", "first_value",
                        "last_value", "nth_value"):
                t = b[arg].type
            else:
                t = types.BIGINT
            wcalls.append(win_mod.WindowCall(
                fn, None if arg is None else b[arg], f"out{i}", t,
                frame=frame, default=None if default is None else b[default],
                param=param))
        keys = [sort_mod.SortKey(b[c], asc, nf)
                for c, asc, nf in ORDERINGS[order]]
        out.append(win_mod.window(b, [b[c] for c in pcols], ranges, keys,
                                  wcalls))
    assert_batches_equal(*map(_null_lanes_zero, out),
                         f"{calls} {part} {order}")
    return out[1]


def _null_lanes_zero(batch):
    """``batch`` with the data under NULL set to zero.  What lies there is
    no result: the port writes zero, the JAX package leaves the rounding
    residue of a double prefix sum over a frame of NULLs."""
    cols = {}
    for name, c in batch.columns.items():
        if c.validity is not None:
            data = np.asarray(c.data)
            data = np.where(np.asarray(c.validity), data,
                            np.zeros((), data.dtype))
            c = c.with_data(torch.from_numpy(data)
                            if isinstance(c.data, torch.Tensor) else data)
        cols[name] = c
    return type(batch)(cols, batch.num_rows)


RANKING = [("row_number", None), ("rank", None), ("dense_rank", None),
           ("percent_rank", None), ("cume_dist", None), ("ntile", 1),
           ("ntile", 3), ("ntile", 50)]


@pytest.mark.parametrize("order", sorted(ORDERINGS))
@pytest.mark.parametrize("part", sorted(PARTITIONINGS))
@pytest.mark.parametrize("fn,param", RANKING)
def test_ranking_matches_reference(batches, fn, param, part, order):
    _run(batches, [(fn, None, None, None, param)], part, order)


@pytest.mark.parametrize("arg", ["v", "vn", "w", "d", "s"])
@pytest.mark.parametrize("fn,param,default", [
    ("lag", None, None), ("lead", None, None), ("lag", 2, None),
    ("lead", 3, None), ("lag", 1, "same"), ("lead", 2, "same")])
def test_lag_lead_match_reference(batches, fn, param, default, arg):
    _run(batches, [(fn, arg, None, None if default is None else arg,
                    param)])


FRAMES = {
    "default": None,
    "rows_up_c": ("rows", "up", None, "c", None),
    "rows_up_uf": ("rows", "up", None, "uf", None),
    "rows_p2_c": ("rows", "p", 2, "c", None),
    "rows_p1_f1": ("rows", "p", 1, "f", 1),
    "rows_p3_p1": ("rows", "p", 3, "p", 1),
    "rows_c_uf": ("rows", "c", None, "uf", None),
    "rows_f1_uf": ("rows", "f", 1, "uf", None),
    "rows_up_p1": ("rows", "up", None, "p", 1),
    "rows_f1_f4": ("rows", "f", 1, "f", 4),
    "rows_f3_f2_empty": ("rows", "f", 3, "f", 2),
    "range_up_c": ("range", "up", None, "c", None),
    "range_c_uf": ("range", "c", None, "uf", None),
    "range_c_c": ("range", "c", None, "c", None),
    "range_up_uf": ("range", "up", None, "uf", None),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("arg", ["v", "w", "d"])
@pytest.mark.parametrize("fn", ["min", "max"])
def test_framed_min_max_match_reference(batches, fn, arg, frame):
    _run(batches, [(fn, arg, FRAMES[frame], None, None)])


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("arg", ["v", "vn", "w"])
@pytest.mark.parametrize("fn", ["sum", "avg", "count"])
def test_framed_sum_avg_count_match_reference(batches, fn, arg, frame):
    _run(batches, [(fn, arg, FRAMES[frame], None, None)])


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_framed_count_star_matches_reference(batches, frame):
    _run(batches, [("count", None, FRAMES[frame], None, None)])


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("fn,param", [("first_value", None),
                                      ("last_value", None),
                                      ("nth_value", 2), ("nth_value", 4)])
def test_value_functions_match_reference(batches, fn, param, frame):
    _run(batches, [(fn, "v", FRAMES[frame], None, param)])


@pytest.mark.parametrize("order", sorted(ORDERINGS))
@pytest.mark.parametrize("part", sorted(PARTITIONINGS))
def test_many_calls_in_one_window_match_reference(batches, part, order):
    """Thirteen calls, more than one scatter launch takes (eight columns)."""
    calls = [("row_number", None, None, None, None),
             ("rank", None, None, None, None),
             ("sum", "w", None, None, None),
             ("min", "v", FRAMES["rows_p2_c"], None, None),
             ("max", "d", FRAMES["rows_p1_f1"], None, None),
             ("lag", "s", None, None, 1),
             ("lead", "v", None, "vn", 1),
             ("avg", "v", FRAMES["rows_up_uf"], None, None),
             ("count", None, None, None, None),
             ("first_value", "w", None, None, None),
             ("dense_rank", None, None, None, None),
             ("cume_dist", None, None, None, None),
             ("ntile", None, None, None, 4)]
    out = _run(batches, calls, part, order)
    assert len(out.columns) == len(SPEC) + len(calls)


# ------------------------------------------------------------ the table

@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 64, 100, 257])
def test_sparse_table_matches_brute_force(n):
    """Every range [fs, fe) of an n-row column, min and max, including the
    lengths at and beside each power of two."""
    rng = np.random.RandomState(n)
    vals = torch.from_numpy(rng.randint(-1000, 1000, n).astype(np.int64))
    fs, fe = np.triu_indices(n + 1, 1)
    fs, fe = torch.from_numpy(fs), torch.from_numpy(fe)
    for op, red in ((torch.minimum, np.min), (torch.maximum, np.max)):
        sent = np.iinfo(np.int64).max if red is np.min \
            else -np.iinfo(np.int64).max
        tab = t_window.sparse_table(vals, op, sent)
        assert tab.shape[0] == t_window._levels(n)
        got = t_window.sparse_table_query(tab, fs, fe, op)
        want = [red(vals.numpy()[a:b]) for a, b in zip(fs.tolist(),
                                                       fe.tolist())]
        assert got.tolist() == want


def test_levels_depend_on_the_capacity_only():
    assert [t_window._levels(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 3, 3, 4, 4, 5]
    # lineitem at SF1: 6,002,010 rows need 24 levels of 2^0 .. 2^23
    assert t_window._levels(6_002_010) == 24


def test_no_running_max_scan():
    src = inspect.getsource(t_window)
    assert "cummax" not in src and "cummin" not in src
