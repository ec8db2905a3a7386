"""The port's filter / compaction / projection / global aggregation against
the JAX package's, on the same numpy inputs, on the CPU.

Integers, decimals, counts and validity exact; doubles to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto1_tpu.ops.filter as j_filter
import presto1_tpu.ops.hashagg as j_agg
import presto1_tpu.ops.segments as j_seg
import presto1_tpu.types as j_types
import presto1_tpu_torch.ops.filter as t_filter
import presto1_tpu_torch.ops.hashagg as t_agg
import presto1_tpu_torch.ops.segments as t_seg
import presto1_tpu_torch.types as t_types
from presto1_tpu.ops.common import key_ranges as j_key_ranges
from presto1_tpu_torch.ops.common import iota, key_ranges as t_key_ranges

from torch_parity import (
    J, T, assert_batches_equal, assert_columns_equal, both_batches,
)

# the tests are tiny; one thread keeps torch's pool from competing with the
# other test workers' 8-device CPU meshes for the same cores
torch.set_num_threads(1)

N = 300
_RNG = np.random.RandomState(12)
SPEC = {
    "k": (_RNG.randint(-50, 50, N), None, "bigint"),
    "v": (_RNG.randint(-10 ** 6, 10 ** 6, N), _RNG.rand(N) > 0.2, "bigint"),
    "p": (_RNG.randint(0, 10 ** 7, N), None, "decimal(12,2)"),
    "pn": (_RNG.randint(-10 ** 7, 10 ** 7, N), _RNG.rand(N) > 0.5,
           "decimal(12,2)"),
    "w": (_RNG.randint(-10 ** 17, 10 ** 17, N), None, "decimal(18,2)"),
    "x": (_RNG.uniform(-100, 100, N), None, "double"),
    "xn": (_RNG.uniform(-100, 100, N), _RNG.rand(N) > 0.3, "double"),
    "i": (_RNG.randint(-1000, 1000, N).astype(np.int32), None, "integer"),
    "d": (_RNG.randint(8000, 10000, N).astype(np.int32), None, "date"),
    "z": (np.zeros(N, np.int64), np.zeros(N, bool), "bigint"),
    "s": (_RNG.randint(0, 3, N).astype(np.int32), None, "varchar",
          np.array(["AIR", "MAIL", "SHIP"])),
}


def _pred(I):
    return I.call("and", I.call(">", I.col("k", I.BIGINT), I.lit(0)),
                  I.call("<", I.col("v", I.BIGINT), I.lit(500_000)))


@pytest.mark.parametrize("num_rows", [N, 211, 0])
def test_filter_mask(num_rows):
    jb, tb = both_batches(SPEC, num_rows)
    jm = j_filter.filter_mask(_pred(J), jb)
    tm = t_filter.filter_mask(_pred(T), tb)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("capacity", [None, 512, N, 128, 40, 1])
@pytest.mark.parametrize("num_rows", [N, 150])
def test_compact(capacity, num_rows):
    """Capacity larger than, equal to and smaller than the input (smaller
    truncates to the first ``capacity`` survivors, the count does not)."""
    jb, tb = both_batches(SPEC, num_rows)
    mask = (np.asarray(SPEC["k"][0]) > 0) & (np.arange(N) < num_rows)
    jo = j_filter.compact(jb, jnp.asarray(mask), capacity)
    to = t_filter.compact(tb, torch.from_numpy(mask), capacity)
    cap = N if capacity is None else capacity
    assert to.capacity() == jo.capacity() == cap
    assert int(to.num_rows) == int(jo.num_rows) == int(mask.sum())
    live = min(cap, int(mask.sum()))
    for name in SPEC:
        assert_columns_equal(jo[name], to[name], rows=live, what=name)


@pytest.mark.parametrize("capacity", [1, 7, 64, 300, 400])
def test_compact_indices(capacity):
    mask = _RNG.rand(N) > 0.6
    ji, jc = j_seg.compact_indices(jnp.asarray(mask), capacity)
    ti, tc = t_seg.compact_indices(torch.from_numpy(mask), capacity)
    assert int(jc) == int(tc) == int(mask.sum())
    assert ti.shape == (capacity,) and ti.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    none = torch.zeros(N, dtype=torch.bool)
    ti, tc = t_seg.compact_indices(none, 16)
    assert int(tc) == 0 and ti.tolist() == [0] * 16


def test_filter_batch_and_project():
    jb, tb = both_batches(SPEC, 250)
    jo = j_filter.filter_batch(_pred(J), jb, capacity=256)
    to = t_filter.filter_batch(_pred(T), tb, capacity=256)
    assert_batches_equal(jo, to, "filter_batch")

    def exprs(I):
        dec = I.DecimalType(12, 2)
        return {
            "rev": I.call("*", I.col("p", dec),
                          I.call("-", I.lit(100, dec), I.col("pn", dec))),
            "half": I.call("/", I.col("x", I.DOUBLE), I.lit(2.0)),
            "k": I.col("k", I.BIGINT),
            "flag": I.call("<", I.col("d", I.DATE), I.lit(9000, I.DATE)),
            "one": I.lit(1),
        }

    jp = j_filter.project(jb, exprs(J))
    tp = t_filter.project(tb, exprs(T))
    assert_batches_equal(jp, tp, "project")


def test_key_ranges_and_iota():
    jb, tb = both_batches(SPEC, 200)
    names = ["k", "v", "i", "d", "z"]
    assert t_key_ranges([tb[n] for n in names], 200) == \
        j_key_ranges([jb[n] for n in names], 200)
    assert iota(5, "cpu").tolist() == [0, 1, 2, 3, 4]
    assert iota(5, "cpu").dtype == torch.int64


def _aggs(mod, batch, which):
    return [mod.AggSpec(fn, None if col is None else batch[col], name)
            for fn, col, name in which]


AGG_SETS = {
    "decimal": [("sum", "p", "s"), ("avg", "p", "a"), ("count", "p", "c"),
                ("count_star", None, "n"), ("min", "p", "mn"),
                ("max", "p", "mx")],
    "decimal_nullable": [("sum", "pn", "s"), ("avg", "pn", "a"),
                         ("count", "pn", "c"), ("min", "pn", "mn"),
                         ("max", "pn", "mx")],
    "bigint": [("sum", "k", "s"), ("avg", "k", "a"), ("min", "k", "mn"),
               ("max", "k", "mx"), ("sum", "v", "sv"), ("count", "v", "cv")],
    "integer_date": [("sum", "i", "s"), ("min", "i", "mn"),
                     ("max", "d", "mx"), ("min", "d", "md"),
                     ("avg", "i", "a")],
    "double": [("sum", "x", "s"), ("avg", "x", "a"), ("min", "x", "mn"),
               ("max", "x", "mx"), ("sum", "xn", "sn"), ("avg", "xn", "an"),
               ("min", "xn", "mnn"), ("count", "xn", "cn")],
    "all_null": [("sum", "z", "s"), ("avg", "z", "a"), ("min", "z", "mn"),
                 ("max", "z", "mx"), ("count", "z", "c"),
                 ("count_star", None, "n")],
    "dictionary": [("min", "s", "mn"), ("max", "s", "mx"),
                   ("count", "s", "c")],
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_rows", [N, 123, 0])
@pytest.mark.parametrize("which", sorted(AGG_SETS))
def test_global_aggregate(which, num_rows, masked):
    jb, tb = both_batches(SPEC, num_rows)
    mask = _RNG.rand(N) > 0.4 if masked else None
    jchecks, tchecks = [], []
    jo = j_agg.global_aggregate(
        _aggs(j_agg, jb, AGG_SETS[which]), num_rows, N,
        mask=None if mask is None else jnp.asarray(mask), checks=jchecks)
    to = t_agg.global_aggregate(
        _aggs(t_agg, tb, AGG_SETS[which]), num_rows, N,
        mask=None if mask is None else torch.from_numpy(mask),
        checks=tchecks, device="cpu")
    assert_batches_equal(jo, to, which)
    assert jo.to_pylist() == to.to_pylist() or which == "double"
    assert [bool(c) for c in jchecks] == [bool(c) for c in tchecks]


@pytest.mark.parametrize("overflow", [False, True])
def test_guarded_limb_sum(overflow):
    """decimal(18,2) sums cannot be proven safe: the limb path appends one
    device-side guard, true while the total fits and false once the
    mathematical total leaves the device decimal."""
    n = 256
    vals = np.full(n, 9 * 10 ** 16 if overflow else 10 ** 15, np.int64)
    spec = {"w": (vals, None, "decimal(18,2)")}
    jb, tb = both_batches(spec)
    jchecks, tchecks = [], []
    jo = j_agg.global_aggregate([j_agg.AggSpec("sum", jb["w"], "s")], n, n,
                                checks=jchecks)
    to = t_agg.global_aggregate([t_agg.AggSpec("sum", tb["w"], "s")], n, n,
                                checks=tchecks)
    assert len(jchecks) == len(tchecks) == 1
    assert bool(jchecks[0]) == bool(tchecks[0]) == (not overflow)
    assert_batches_equal(jo, to, "guarded")
    assert str(to["s"].type) == "decimal(38,2)"


def test_num_rows_as_device_scalar():
    """Inside a compiled fragment ``num_rows`` is a 0-d tensor."""
    _, tb = both_batches(SPEC, N)
    a = t_agg.global_aggregate([t_agg.AggSpec("sum", tb["p"], "s"),
                                t_agg.AggSpec("count_star", None, "n")],
                               torch.tensor(100), N)
    b = t_agg.global_aggregate([t_agg.AggSpec("sum", tb["p"], "s"),
                                t_agg.AggSpec("count_star", None, "n")],
                               100, N, device="cpu")
    assert a.to_pylist() == b.to_pylist()


def test_agg_output_types_and_safety_bound():
    for tstr in ("decimal(12,2)", "bigint", "integer", "double", "real",
                 "date"):
        for fn in ("sum", "avg", "min", "max", "count"):
            jt = j_agg.AggSpec(fn, type("C", (), {
                "type": j_types.parse_type_str(tstr)})(), "o").output_type()
            tt = t_agg.AggSpec(fn, type("C", (), {
                "type": t_types.parse_type_str(tstr)})(), "o").output_type()
            assert str(jt) == str(tt), (tstr, fn)
    for prec, rows in ((12, 8_400_000), (12, 60_000_000), (18, 1), (18, 10),
                       (38, 1)):
        assert t_agg._sum_provably_safe(t_types.DecimalType(prec, 2), rows) \
            == j_agg._sum_provably_safe(j_types.DecimalType(prec, 2), rows)


def test_later_slices_raise():
    """What the operators still leave to later slices: join keys wider than
    one word, and aggregate functions nobody ported."""
    from presto1_tpu_torch.ops.common import pack_keys

    _, tb = both_batches(SPEC, N)
    wide = [(-2 ** 40, 2 ** 40)] * 2
    with pytest.raises(NotImplementedError, match="63 bits"):
        pack_keys([tb["k"], tb["v"]], wide, N)
    with pytest.raises(NotImplementedError, match="stddev"):
        t_agg.global_aggregate(
            [t_agg.AggSpec("stddev", tb["x"], "m")], N, N)
