"""The port's ORDER BY / LIMIT against the JAX package's, on the same numpy
inputs, on the CPU.  Values, validity and row order exact (sort keys here
have no ties beyond the ones the stable order decides the same way in both:
both sort a leading liveness key and are stable).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.ops.sort as j_sort
import presto1_tpu_torch.ops.sort as t_sort
import presto1_tpu_torch.exec.executor as t_executor
from presto1_tpu.batch import Column as JColumn, RecordBatch as JBatch
from presto1_tpu.types import parse_type_str as j_type
from presto1_tpu_torch.batch import Column as TColumn, RecordBatch as TBatch
from presto1_tpu_torch.types import parse_type_str as t_type

from torch_parity import assert_batches_equal, both_batches

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)

N = 256
_RNG = np.random.RandomState(9)
SPEC = {
    "k": (_RNG.randint(-20, 20, N), None, "bigint"),
    "kn": (_RNG.randint(-5, 5, N), _RNG.rand(N) > 0.25, "bigint"),
    "x": (_RNG.uniform(-10, 10, N).round(1), None, "double"),
    "xn": (_RNG.uniform(-10, 10, N), _RNG.rand(N) > 0.3, "double"),
    "d": (_RNG.randint(9000, 9050, N).astype(np.int32), None, "date"),
    "p": (_RNG.randint(0, 10 ** 7, N), _RNG.rand(N) > 0.1, "decimal(12,2)"),
    "s": (_RNG.randint(0, 3, N).astype(np.int32), None, "varchar",
          np.array(["AIR", "MAIL", "SHIP"])),
    "id": (np.arange(N), None, "bigint"),
}

# (column, ascending, nulls_first)
ORDERINGS = {
    "asc": [("k", True, None)],
    "desc": [("k", False, None)],
    "nullable_default_asc": [("kn", True, None)],
    "nullable_default_desc": [("kn", False, None)],
    "nulls_first_asc": [("kn", True, True)],
    "nulls_last_desc": [("kn", False, False)],
    "nulls_first_desc": [("xn", False, True)],
    "double_then_int": [("x", True, None), ("k", False, None)],
    "string_date_desc": [("s", True, None), ("d", False, None),
                         ("kn", True, True)],
    "decimal_nullable": [("p", False, None), ("id", True, None)],
}


def _keys(mod, batch, ordering):
    return [mod.SortKey(batch[c], asc, nf) for c, asc, nf in ordering]


@pytest.mark.parametrize("limit", [None, 10, 1000])
@pytest.mark.parametrize("num_rows", [N, 100, 0])
@pytest.mark.parametrize("ordering", sorted(ORDERINGS))
def test_sort_batch(ordering, num_rows, limit):
    jb, tb = both_batches(SPEC, num_rows)
    jo = j_sort.sort_batch(jb, _keys(j_sort, jb, ORDERINGS[ordering]), limit)
    to = t_sort.sort_batch(tb, _keys(t_sort, tb, ORDERINGS[ordering]), limit)
    assert jo.capacity() == to.capacity() == \
        (N if limit is None else min(limit, N))
    assert_batches_equal(jo, to, ordering)
    assert jo.to_pylist() == to.to_pylist() or "x" in ordering


@pytest.mark.parametrize("ordering", sorted(ORDERINGS))
def test_sortable_words(ordering):
    jb, tb = both_batches(SPEC)
    for jk, tk in zip(_keys(j_sort, jb, ORDERINGS[ordering]),
                      _keys(t_sort, tb, ORDERINGS[ordering])):
        a = np.asarray(j_sort._sortable(jk, N))
        b = t_sort._sortable(tk, N).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sort_with_device_row_count():
    """Inside a compiled fragment ``num_rows`` is a 0-d tensor: dead rows
    still sort last and the count passes through, clamped by the limit."""
    _, tb = both_batches(SPEC, 100)
    want = t_sort.sort_batch(tb, _keys(t_sort, tb, ORDERINGS["desc"]), 7)
    dev = TBatch(tb.columns, torch.tensor(100))
    got = t_sort.sort_batch(dev, _keys(t_sort, dev, ORDERINGS["desc"]), 7)
    assert not isinstance(got.num_rows, int) and int(got.num_rows) == 7
    assert TBatch(got.columns, 7).to_pylist() == want.to_pylist()


def test_nested_columns_move_with_their_rows():
    n = 128
    elems = _RNG.randint(0, 100, (n, 4))
    lens = _RNG.randint(0, 5, n).astype(np.int32)
    key = _RNG.permutation(n)
    jb = JBatch({"k": JColumn(jnp.asarray(key), j_type("bigint")),
                 "a": JColumn(jnp.asarray(elems), j_type("array(bigint)"),
                              lengths=jnp.asarray(lens))}, n)
    tb = TBatch({"k": TColumn(torch.from_numpy(key), t_type("bigint")),
                 "a": TColumn(torch.from_numpy(elems),
                              t_type("array(bigint)"),
                              lengths=torch.from_numpy(lens))}, n)
    jo = j_sort.sort_batch(jb, [j_sort.SortKey(jb["k"])])
    to = t_sort.sort_batch(tb, [t_sort.SortKey(tb["k"])])
    np.testing.assert_array_equal(np.asarray(jo["a"].data),
                                  to["a"].data.numpy())
    np.testing.assert_array_equal(np.asarray(jo["a"].lengths),
                                  to["a"].lengths.numpy())
    assert list(jo["a"].decode(n)) == list(to["a"].decode(n))


@pytest.mark.parametrize("limit", [0, 5, 256, 1000])
def test_limit_batch(limit):
    jb, tb = both_batches(SPEC, 100)
    assert_batches_equal(j_sort.limit_batch(jb, limit),
                         t_sort.limit_batch(tb, limit), f"limit {limit}")
    dev = t_sort.limit_batch(TBatch(tb.columns, torch.tensor(100)), limit)
    assert int(dev.num_rows) == min(100, limit)
    # the executor re-exports the function it used to hold
    assert t_executor.limit_batch is t_sort.limit_batch
