"""Joins: every path of ``ops/join.py`` in the port against the JAX
package's function of the same name on the same numpy inputs, the route each
takes, and TPC-H Q3 through the port's engine against the JAX package's
``Engine.sql`` and the pandas oracle at SF 0.01.

Integers, decimals, dates, dictionary values and validity exact; doubles to
1e-6 relative (the tolerance of ``tests/torch_parity.py``).  The join output
is compared row for row wherever its order is part of the contract
(``merge_join``: join-key order, probe order within a key; every other path:
probe order) and as a multiset of rows where two matches of one probe row
meet the build side in the order of an unstable sort in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
import presto1_tpu.ops.join as j_join
import presto1_tpu_torch.exec.catalog as t_catalog
import presto1_tpu_torch.exec.engine as t_engine
import presto1_tpu_torch.ops.join as t_join
from presto1_tpu_torch.ops.kernels import gather as G, scatter as S
from presto1_tpu_torch.testing.verifier import compare_frames
from presto1_tpu_torch.tpch.queries import QUERIES

from torch_parity import J, T, assert_batches_equal, both_batches, no_host_sync
from tpch_oracle import ORACLE

torch.set_num_threads(1)


def _pad(values, cap, dtype=np.int64):
    out = np.zeros(cap, dtype)
    out[:len(values)] = values
    return out


def _batches(cap=None, valid=None, **cols):
    """Both implementations' batches of BIGINT columns, padded to a
    capacity; ``valid`` maps a column name to its (unpadded) validity."""
    n = len(next(iter(cols.values())))
    cap = cap or max(128, n)
    spec = {}
    for name, v in cols.items():
        va = None
        if valid and name in valid:
            va = _pad(np.asarray(valid[name], bool), cap, bool)
        spec[name] = (_pad(np.asarray(v, np.int64), cap), va, "bigint")
    return both_batches(spec, num_rows=n)


def _ranges(*arrays):
    lo = min(int(np.min(a)) for a in arrays if len(a))
    hi = max(int(np.max(a)) for a in arrays if len(a))
    return [(lo, hi)]


def _mask(m, cap):
    m = _pad(np.asarray(m, bool), cap, bool)
    return jnp.asarray(m), torch.from_numpy(m)


def _rows(batch, names=None):
    """Live rows as tuples (None for NULL), from either implementation."""
    n = int(batch.num_rows)
    names = names or list(batch.columns)
    cols = []
    for name in names:
        c = batch[name]
        d = np.asarray(c.data) if not isinstance(c.data, torch.Tensor) \
            else c.data.numpy()
        v = None if c.validity is None else (
            np.asarray(c.validity) if not isinstance(c.validity, torch.Tensor)
            else c.validity.numpy())
        cols.append([None if v is not None and not v[i] else int(d[i])
                     for i in range(n)])
    return list(zip(*cols))


def _same(jb, tb, ordered: bool, what=""):
    if ordered:
        assert_batches_equal(jb, tb, what)
    else:
        assert list(jb.columns) == list(tb.columns), what
        assert int(jb.num_rows) == int(tb.num_rows), what
        key = lambda r: tuple((x is None, x or 0) for x in r)  # noqa: E731
        assert sorted(_rows(jb), key=key) == sorted(_rows(tb), key=key), what


# ------------------------------------------------------------------ routes


ROUTE_CASES = [
    ("inner", [(0, 100)], None, True), ("inner", [(0, 100)], None, False),
    ("semi", [(0, 100)], None, False), ("anti", [(0, 100)], None, True),
    ("left", [(0, 100)], None, True), ("full", [(0, 100)], None, True),
    ("inner", [(0, 1 << 40), (0, 1 << 40)], None, True),
    ("semi", [(0, 1 << 40), (0, 1 << 40)], None, False),
    ("inner", [(-5, 1 << 30)], None, True), ("anti", [(0, 1 << 62)], None,
                                             False),
    ("semi", [(0, 100)], "residual", False),
    ("inner", [(3, 3), (0, 7), (-1, 1 << 20)], None, True),
]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_matches_reference(case):
    """The merge-join decision (and the key width behind it) is the
    reference's: if it differed, a plan would take another path silently."""
    kind, ranges, residual, unique = case
    assert t_join._key_widths(ranges) == j_join._key_widths(ranges)
    assert t_join.merge_join_applicable(kind, ranges, residual, unique) == \
        j_join.merge_join_applicable(kind, ranges, residual, unique)


# -------------------------------------------------------------- merge_join


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_join_inner_unique(seed):
    rng = np.random.RandomState(seed)
    bk = rng.permutation(200)[:120]
    bv = rng.randint(0, 1000, 120)
    pk = rng.randint(0, 220, 500)
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(500)), \
        _batches(bk=bk, bv=bv)
    ranges = _ranges(pk, bk)
    cap = jp.capacity()
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], "inner", ranges, cap)
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], "inner", ranges, cap)
    _same(want, got, ordered=True)
    keys = [r[0] for r in _rows(got)]
    assert keys == sorted(keys)


@pytest.mark.parametrize("kind", ["semi", "anti"])
def test_merge_join_semi_anti_duplicate_build(kind):
    rng = np.random.RandomState(3)
    bk = rng.randint(0, 50, 300)
    pk = rng.randint(0, 80, 400)
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(400)), _batches(bk=bk)
    ranges = _ranges(pk, bk)
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], kind, ranges,
                             jp.capacity())
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], kind, ranges,
                            tp.capacity())
    _same(want, got, ordered=True)


@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
def test_merge_join_fused_probe_mask(kind):
    rng = np.random.RandomState(5)
    bk = rng.permutation(100)[:60]
    pk = rng.randint(0, 110, 300)
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(300)), _batches(bk=bk)
    cap = jp.capacity()
    jm, tm = _mask(rng.rand(300) < 0.4, cap)
    ranges = _ranges(pk, bk)
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], kind, ranges, cap,
                             probe_mask=jm)
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], kind, ranges, cap,
                            probe_mask=tm)
    _same(want, got, ordered=True)


@pytest.mark.parametrize("kind", ["inner", "anti", "semi"])
def test_merge_join_null_keys_never_match(kind):
    (jp, tp) = _batches(k=[1, 2, 3, 4], pv=np.arange(4),
                        valid={"k": [True, False, True, False]})
    (jb, tb) = _batches(bk=[1, 2, 3], valid={"bk": [True, True, False]})
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], kind, [(1, 4)], 128)
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], kind, [(1, 4)], 128)
    _same(want, got, ordered=True)


@pytest.mark.parametrize("kind", ["inner", "anti"])
@pytest.mark.parametrize("empty", [False, True])
def test_merge_join_composite_keys_and_empty_build(kind, empty):
    (jp, tp) = _batches(a=[1, 1, 2, 2, 3], b=[7, 8, 7, 9, 7],
                        pv=np.arange(5))
    n = 0 if empty else 2
    (jb, tb) = _batches(x=[1, 2][:n], y=[8, 7][:n], bv=[10, 20][:n])
    ranges = [(1, 3), (7, 9)]
    want = j_join.merge_join(jp, jb, ["a", "b"], ["x", "y"], kind, ranges,
                             128)
    got = t_join.merge_join(tp, tb, ["a", "b"], ["x", "y"], kind, ranges,
                            128)
    _same(want, got, ordered=True)


def test_merge_join_capacity_past_both_inputs():
    """A capacity larger than probe + build (the reference pads its sorted
    bookkeeping with zeros): the live rows and the count agree."""
    rng = np.random.RandomState(9)
    bk = rng.permutation(40)[:30]
    pk = rng.randint(0, 45, 90)
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(90)), \
        _batches(bk=bk, bv=bk * 3)
    want = j_join.merge_join(jp, jb, ["k"], ["bk"], "inner", _ranges(pk, bk),
                             1024)
    got = t_join.merge_join(tp, tb, ["k"], ["bk"], "inner", _ranges(pk, bk),
                            1024)
    _same(want, got, ordered=True)


def test_merge_join_wide_key_stays_int64():
    """A key wider than 30 bits is not narrowed: the int64 sentinel path."""
    rng = np.random.RandomState(4)
    bk = np.unique(rng.randint(0, 1 << 40, 80))
    pk = np.concatenate([bk[:50], rng.randint(0, 1 << 40, 70)])
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(120)), \
        _batches(bk=bk, bv=np.arange(len(bk)))
    ranges = _ranges(pk, bk)
    assert t_join._key_widths(ranges) > 30
    for kind in ("inner", "semi", "anti"):
        want = j_join.merge_join(jp, jb, ["k"], ["bk"], kind, ranges, 128)
        got = t_join.merge_join(tp, tb, ["k"], ["bk"], kind, ranges, 128)
        _same(want, got, ordered=True, what=kind)


# ------------------------------------------------------------ _probe_ranges


@pytest.mark.parametrize("build_sorted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_probe_ranges(build_sorted, masked):
    rng = np.random.RandomState(7)
    bk = np.sort(rng.randint(0, 60, 150)) if build_sorted \
        else rng.randint(0, 60, 150)
    pk = rng.randint(-5, 70, 300)
    (jp, tp), (jb, tb) = _batches(k=pk), _batches(bk=bk)
    jm = tm = None
    if masked:
        jm, tm = _mask(rng.rand(300) < 0.6, jp.capacity())
    ranges = _ranges(pk, bk)
    jl, jc, jperm, jlive, jv = j_join._probe_ranges(
        jp, jb, ["k"], ["bk"], ranges, build_sorted=build_sorted,
        probe_mask=jm)
    tl, tc, tperm, tlive, tv = t_join._probe_ranges(
        tp, tb, ["k"], ["bk"], ranges, build_sorted=build_sorted,
        probe_mask=tm)
    assert jv == tv is False
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jlive), tlive.numpy())
    # within a run of equal keys the JAX sort is not stable: hold the keys
    # the permutations point at, not the permutations
    bpad = _pad(bk, jb.capacity())
    np.testing.assert_array_equal(bpad[np.asarray(jperm)],
                                  bpad[tperm.numpy()])
    assert tc.dtype == torch.int64 and tl.dtype == torch.int32


def test_probe_ranges_wide_keys_need_verify():
    rng = np.random.RandomState(8)
    a = rng.randint(0, 1 << 40, 50)
    b = rng.randint(0, 1 << 40, 50)
    (jp, tp) = _batches(a=np.concatenate([a, a[:10]]),
                        b=np.concatenate([b, b[:10] + 1]))
    (jb, tb) = _batches(x=a, y=b)
    ranges = [(0, 1 << 40), (0, (1 << 40) + 1)]
    jl, jc, _, jlive, jv = j_join._probe_ranges(jp, jb, ["a", "b"],
                                                ["x", "y"], ranges)
    tl, tc, _, tlive, tv = t_join._probe_ranges(tp, tb, ["a", "b"],
                                                ["x", "y"], ranges)
    assert jv is True and tv is True
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jlive), tlive.numpy())


# --------------------------------------------------------------- hash_join


def _one_to_many(seed, nulls=False):
    rng = np.random.RandomState(seed)
    bk = rng.randint(0, 40, 120)
    pk = rng.randint(-3, 45, 200)
    valid = None
    if nulls:
        valid = {"k": rng.rand(200) > 0.1}
    return ((_batches(k=pk, pv=np.arange(200), valid=valid),
             _batches(bk=bk, bv=np.arange(120) * 7)), _ranges(pk, bk))


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("nulls", [False, True])
def test_hash_join_one_to_many(kind, nulls):
    ((jp, tp), (jb, tb)), ranges = _one_to_many(11, nulls)
    cap = 2048
    jstats, tstats = {}, {}
    want = j_join.hash_join(jp, jb, ["k"], ["bk"], kind, ranges, cap,
                            stats=jstats)
    got = t_join.hash_join(tp, tb, ["k"], ["bk"], kind, ranges, cap,
                           stats=tstats)
    _same(want, got, ordered=kind in ("semi", "anti"))
    if "pairs_total" in jstats:
        assert int(jstats["pairs_total"]) == int(tstats["pairs_total"])


@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
def test_hash_join_fused_mask_one_to_many(kind):
    ((jp, tp), (jb, tb)), ranges = _one_to_many(12)
    jm, tm = _mask(np.random.RandomState(1).rand(200) < 0.5, jp.capacity())
    want = j_join.hash_join(jp, jb, ["k"], ["bk"], kind, ranges, 2048,
                            probe_mask=jm)
    got = t_join.hash_join(tp, tb, ["k"], ["bk"], kind, ranges, 2048,
                           probe_mask=tm)
    _same(want, got, ordered=kind != "inner")


@pytest.mark.parametrize("build_sorted", [False, True])
def test_hash_join_left_unique_fast_path(build_sorted):
    """N:1 LEFT: every probe row in place, the build side looked up."""
    rng = np.random.RandomState(13)
    bk = np.arange(0, 160, 2)
    if not build_sorted:
        bk = rng.permutation(bk)
    pk = rng.randint(-4, 170, 300)
    (jp, tp), (jb, tb) = _batches(k=pk, pv=np.arange(300)), \
        _batches(bk=bk, bv=bk * 5)
    ranges = _ranges(pk, bk)
    want = j_join.hash_join(jp, jb, ["k"], ["bk"], "left", ranges, 512,
                            build_unique=True, build_sorted=build_sorted)
    got = t_join.hash_join(tp, tb, ["k"], ["bk"], "left", ranges, 512,
                           build_unique=True, build_sorted=build_sorted)
    assert int(got.num_rows) == 300
    _same(want, got, ordered=True)


def _residual(I, probe_col, build_col):
    return I.call(">", I.col(build_col, I.BIGINT), I.col(probe_col, I.BIGINT))


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_hash_join_residual(kind):
    ((jp, tp), (jb, tb)), ranges = _one_to_many(14)
    want = j_join.hash_join(jp, jb, ["k"], ["bk"], kind, ranges, 2048,
                            residual=_residual(J, "pv", "bv"))
    got = t_join.hash_join(tp, tb, ["k"], ["bk"], kind, ranges, 2048,
                           residual=_residual(T, "pv", "bv"))
    _same(want, got, ordered=kind in ("semi", "anti"))


def test_left_join_residual_reference_cases():
    """The two cases of ``tests/test_outer_residual.py`` through the port."""
    for pk, pv, bk, bv, rng_ in (([1, 2, 3], [10, 20, 30], [1, 2, 2],
                                  [5, 15, 25], [(1, 3)]),
                                 ([7, 7], [1, 2], [7, 7], [100, 200],
                                  [(7, 7)])):
        (jp, tp), (jb, tb) = _batches(pk=pk, pv=pv), _batches(bk=bk, bv=bv)
        want = j_join.hash_join(jp, jb, ["pk"], ["bk"], "left", rng_, 16,
                                residual=_residual(J, "pv", "bv"))
        got = t_join.hash_join(tp, tb, ["pk"], ["bk"], "left", rng_, 16,
                               residual=_residual(T, "pv", "bv"))
        _same(want, got, ordered=False)


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_hash_join_wide_keys_verify(kind):
    """Keys of more than 63 bits go through the 62-bit mix; candidates
    are verified against the real key columns."""
    rng = np.random.RandomState(15)
    a = rng.randint(0, 1 << 40, 60)
    b = rng.randint(0, 1 << 40, 60)
    pa = np.concatenate([a[:40], a[40:50], rng.randint(0, 1 << 40, 20)])
    pb = np.concatenate([b[:40], b[40:50] + 3, rng.randint(0, 1 << 40, 20)])
    (jp, tp) = _batches(a=pa, b=pb, pv=np.arange(70))
    (jb, tb) = _batches(x=np.concatenate([a, a[:5]]),
                        y=np.concatenate([b, b[:5]]),
                        bv=np.arange(65))
    ranges = [(0, 1 << 40), (0, (1 << 40) + 3)]
    assert t_join._key_widths(ranges) > 63
    want = j_join.hash_join(jp, jb, ["a", "b"], ["x", "y"], kind, ranges,
                            512)
    got = t_join.hash_join(tp, tb, ["a", "b"], ["x", "y"], kind, ranges,
                           512)
    _same(want, got, ordered=kind in ("semi", "anti"))


@pytest.mark.parametrize("nb_rows", [1, 3, 0])
def test_cross_join(nb_rows):
    (jp, tp) = _batches(pv=np.arange(5) * 10)
    (jb, tb) = _batches(bv=np.arange(nb_rows) + 100 if nb_rows else [],
                        cap=128)
    cap = 128
    want = j_join.cross_join(jp, jb, cap)
    got = t_join.cross_join(tp, tb, cap)
    assert int(got.num_rows) == 5 * nb_rows
    _same(want, got, ordered=True)


def test_cpu_join_launches_no_kernel():
    ((_, tp), (_, tb)), ranges = _one_to_many(16)
    before = (G.LAUNCHES, S.LAUNCHES)
    t_join.hash_join(tp, tb, ["k"], ["bk"], "inner", ranges, 2048)
    t_join.merge_join(tp, tb, ["k"], ["bk"], "semi", ranges, 256)
    assert (G.LAUNCHES, S.LAUNCHES) == before


# ---------------------------------------------------------- TPC-H Q3 slice


@pytest.fixture(scope="module")
def engines():
    jc = j_catalog.TpchCatalog("tiny")
    tc = t_catalog.TpchCatalog("tiny", device="cpu")
    return j_engine.Engine(jc), t_engine.Engine(tc, device="cpu")


@pytest.fixture(scope="module")
def q3_reference(engines):
    return engines[0].sql(QUERIES[3])


@pytest.mark.parametrize("mode", ["sql", "compiled_call", "block_run"])
def test_q3_matches_reference_and_oracle(engines, q3_reference, mode):
    _, te = engines
    if mode == "sql":
        got = te.sql(QUERIES[3])
    else:
        cq = te.compile(QUERIES[3])
        if mode == "block_run":
            assert cq.block_run(reps=2) == 10
        got = cq()
    assert_batches_equal(q3_reference, got, mode)
    frames = {t: te.catalog.table(t).batch().to_pandas()
              for t in ("customer", "orders", "lineitem")}
    assert compare_frames(got.to_pandas(), ORACLE[3](frames)) is None


def test_q3_plan_and_route_match_reference(engines, monkeypatch):
    """Same plan text, and the same join function twice (``merge_join``)."""
    je, te = engines
    assert te.explain(QUERIES[3]) == je.explain(QUERIES[3])
    calls = []
    for mod in (t_join, j_join):
        for name in ("merge_join", "_probe_ranges", "cross_join"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, _mod=mod, **k):
                calls.append((_mod.__name__.split(".")[0], _name))
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, spy)
    te.sql(QUERIES[3])
    je.sql(QUERIES[3])
    port = [c for m, c in calls if m == "presto1_tpu_torch"]
    ref = [c for m, c in calls if m == "presto1_tpu"]
    assert port == ref == ["merge_join", "merge_join"]


def test_join_order_chain_is_recorded(engines):
    """The merge join's output is in join-key order, so Q3's grouped
    aggregate on the key is clustered (no grouping sort)."""
    import presto1_tpu_torch.exec.executor as t_executor
    from presto1_tpu_torch.sql.logical import Aggregate, Join

    _, te = engines
    plan = te.plan(QUERIES[3])
    ex = t_executor.Executor(te.catalog, device="cpu")
    ex.execute(plan)
    joins = [p for p, r in ex.record.items()
             if isinstance(t_executor._node_at(plan, p), Join)]
    aggs = [p for p in ex.record
            if isinstance(t_executor._node_at(plan, p), Aggregate)]
    assert len(joins) == 2 and all(ex.record[p]["merge_join"] for p in joins)
    assert [ex.record[p]["clustered"] for p in aggs] == [True]


def test_q3_compiled_run_never_waits_for_the_host(engines, monkeypatch):
    """No readback and no upload inside a compiled Q3 run: its string
    predicate's lookup table is on the device from the discovery run on."""
    import presto1_tpu_torch.expr.eval as t_eval

    _, te = engines
    cq = te.compile(QUERIES[3])
    uploads = []
    real = t_eval.to_device
    monkeypatch.setattr(t_eval, "to_device",
                        lambda a, d: uploads.append(a) or real(a, d))
    no_host_sync(monkeypatch)
    _, _, num_rows, _ = cq._run()
    monkeypatch.undo()
    assert uploads == [] and int(num_rows) == 10
